"""Parameter bridge between the JAX package's flax trees and the port's
ResNet ``state_dict`` names.

The JAX ``ResNet18`` has two parameter trees for the same parameters: the
unfolded one and, by default on even inputs at width 64, the W-folded one
(``Conv_0`` stem, ``FoldedResidualBlock_i/{FoldedConv3x3_j,
FoldedGroupNorm_j}``, ``FoldedTransitionBlock_0/{conv1_kernel, Conv_0,
proj_kernel, GroupNorm_0..2}``, after which ``ResidualBlock_k`` counts from
0 again, i.e. shifted by ``n_folded + 1``). Both map onto the port's one
unfolded network; tests/test_folded_resnet.py ``_transplant`` is the JAX
side's own statement of the same mapping.

Besides transplanting (tests), the bridge gives the JAX tree's leaf order
(``jax.tree_util.tree_flatten``: depth first, dict keys sorted), which is
the order the stochastic-rounding salt advances in
(parallel/engine.py ``sr_to_bf16``). jax-free: trees are nested dicts of
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

_BLOCK = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "proj",
          "GroupNorm_0": "norm1", "GroupNorm_1": "norm2",
          "GroupNorm_2": "proj_norm"}
_FOLDED_BLOCK = {"FoldedConv3x3_0": "conv1", "FoldedConv3x3_1": "conv2",
                 "FoldedGroupNorm_0": "norm1", "FoldedGroupNorm_1": "norm2"}
_TRANSITION = {"conv1_kernel": "conv1", "Conv_0": "conv2",
               "proj_kernel": "proj", "GroupNorm_0": "norm1",
               "GroupNorm_1": "norm2", "GroupNorm_2": "proj_norm"}
_LEAF = {"kernel": "weight", "scale": "scale", "bias": "bias"}


def _invert(d):
    return {v: k for k, v in d.items()}


def torch_name(path: tuple[str, ...], n_folded: int) -> str:
    """JAX tree path -> state_dict name (``n_folded`` = folded stage-1
    blocks in the tree, 0 for the unfolded tree)."""
    top = path[0]
    if top == "Conv_0":
        return "stem.weight"
    if top == "GroupNorm_0":
        return f"stem_norm.{path[1]}"
    if top == "Dense_0":
        return f"head.{_LEAF[path[1]]}"
    kind, idx = top.rsplit("_", 1)
    if kind == "FoldedResidualBlock":
        block, module = int(idx), _FOLDED_BLOCK[path[1]]
    elif kind == "FoldedTransitionBlock":
        block, module = n_folded, _TRANSITION[path[1]]
    elif kind == "ResidualBlock":
        block = int(idx) + (n_folded + 1 if n_folded else 0)
        module = _BLOCK[path[1]]
    else:
        raise KeyError(f"unknown JAX ResNet parameter path {path}")
    leaf = "weight" if len(path) == 2 else _LEAF[path[2]]
    return f"blocks.{block}.{module}.{leaf}"


def jax_path(name: str, n_folded: int) -> tuple[str, ...]:
    """Inverse of :func:`torch_name`."""
    parts = name.split(".")
    leaf = _invert(_LEAF)[parts[-1]]
    if parts[0] == "stem":
        return ("Conv_0", "kernel")
    if parts[0] == "stem_norm":
        return ("GroupNorm_0", leaf)
    if parts[0] == "head":
        return ("Dense_0", leaf)
    block, module = int(parts[1]), parts[2]
    if block < n_folded:
        return (f"FoldedResidualBlock_{block}",
                _invert(_FOLDED_BLOCK)[module], leaf)
    if n_folded and block == n_folded:
        sub = _invert(_TRANSITION)[module]
        if sub.endswith("_kernel"):
            return ("FoldedTransitionBlock_0", sub)
        return ("FoldedTransitionBlock_0", sub, leaf)
    k = block - (n_folded + 1 if n_folded else 0)
    return (f"ResidualBlock_{k}", _invert(_BLOCK)[module], leaf)


def _flatten(tree, prefix=()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def n_folded_blocks(tree) -> int:
    return sum(1 for k in tree if k.startswith("FoldedResidualBlock"))


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX params (nested dicts of arrays, folded or unfolded tree) ->
    state_dict of f32 tensors. Conv kernels go HWIO -> OIHW, Dense kernels
    ``[in, out]`` -> ``[out, in]``."""
    n_folded = n_folded_blocks(tree)
    out = {}
    for path, value in _flatten(tree):
        a = np.asarray(value, dtype=np.float32)
        name = torch_name(path, n_folded)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def jax_leaf_order(model, input_hw: tuple[int, int]) -> list[str]:
    """The model's parameter names in the leaf order of the JAX tree that
    the JAX package builds for the same model and input size."""
    n_folded = model.stage_sizes[0] if model.folds_stage1(*input_hw) else 0
    names = [n for n, _ in model.named_parameters()]
    return sorted(names, key=lambda n: jax_path(n, n_folded))
