"""Parameter bridge between the JAX package's flax trees and the port's
``state_dict`` names, for every registered model.

The plain models (``MLP``, ``CifarCNN``, ``TpuCifarCNN``, ``LeNet5``) carry
flax's auto-named tree, ``{Conv_i, Dense_i}/{kernel, bias}``; the port names
the same modules ``conv{i}`` / ``dense{i}`` (models/cnn.py), with
``weight`` for ``kernel``.

The JAX ``ResNet18`` has two parameter trees for the same parameters: the
unfolded one and, by default on even inputs at width 64, the W-folded one
(``Conv_0`` stem, ``FoldedResidualBlock_i/{FoldedConv3x3_j,
FoldedGroupNorm_j}``, ``FoldedTransitionBlock_0/{conv1_kernel, Conv_0,
proj_kernel, GroupNorm_0..2}``, after which ``ResidualBlock_k`` counts from
0 again, i.e. shifted by ``n_folded + 1``). Both map onto the port's one
unfolded network; tests/test_folded_resnet.py ``_transplant`` is the JAX
side's own statement of the same mapping.

Besides transplanting (tests), the bridge gives each parameter's path in
the JAX tree, which names its flax init key (models/flax_init.py), and the
JAX tree's leaf order (``jax.tree_util.tree_flatten``: depth first, dict
keys sorted), which is the order the stochastic-rounding salt advances in
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
_PLAIN = {"Conv": "conv", "Dense": "dense"}
_RESNET_TOP = ("GroupNorm_", "ResidualBlock_", "FoldedResidualBlock_",
               "FoldedTransitionBlock_")


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


def plain_torch_name(path: tuple[str, ...]) -> str:
    """A plain model's JAX path (``("Conv_1", "kernel")``) -> state_dict
    name (``conv1.weight``)."""
    kind, idx = path[0].rsplit("_", 1)
    return f"{_PLAIN[kind]}{idx}.{_LEAF[path[1]]}"


def plain_jax_path(name: str) -> tuple[str, ...]:
    """Inverse of :func:`plain_torch_name`."""
    module, leaf = name.split(".")
    for kind, prefix in _PLAIN.items():
        if module.startswith(prefix) and module[len(prefix):].isdigit():
            return (f"{kind}_{module[len(prefix):]}", _invert(_LEAF)[leaf])
    raise KeyError(f"unknown parameter name {name!r}")


def is_resnet_tree(tree) -> bool:
    return any(k.startswith(_RESNET_TOP) for k in tree)


def _flatten(tree, prefix=()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def n_folded_blocks(tree) -> int:
    return sum(1 for k in tree if k.startswith("FoldedResidualBlock"))


def to_torch_layout(a: np.ndarray) -> np.ndarray:
    """A JAX leaf in the port's layout: conv kernels HWIO -> OIHW, dense
    kernels ``[in, out]`` -> ``[out, in]``."""
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:
        return a.T
    return a


def to_jax_layout(a: np.ndarray) -> np.ndarray:
    """Inverse of :func:`to_torch_layout`."""
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX params (nested dicts of arrays: a plain model's tree, or a
    ResNet's folded or unfolded tree) -> state_dict of f32 tensors."""
    resnet = is_resnet_tree(tree)
    n_folded = n_folded_blocks(tree)
    out = {}
    for path, value in _flatten(tree):
        a = to_torch_layout(np.asarray(value, dtype=np.float32))
        name = torch_name(path, n_folded) if resnet else plain_torch_name(path)
        out[name] = torch.tensor(a)
    return out


def jax_paths(model, input_hw: tuple[int, int]) -> dict[str, tuple[str, ...]]:
    """``{state_dict name: path in the JAX tree}`` of the tree the JAX
    package builds for the same model and input size (a ResNet's folded
    tree when its stage 1 folds on this input)."""
    names = [n for n, _ in model.named_parameters()]
    if hasattr(model, "folds_stage1"):
        n_folded = model.stage_sizes[0] if model.folds_stage1(*input_hw) else 0
        return {n: jax_path(n, n_folded) for n in names}
    return {n: plain_jax_path(n) for n in names}


def jax_leaf_order(model, input_hw: tuple[int, int]) -> list[str]:
    """The model's parameter names in the leaf order of the JAX tree that
    the JAX package builds for the same model and input size."""
    paths = jax_paths(model, input_hw)
    return sorted(paths, key=paths.__getitem__)


def params_to_jax(params: dict[str, torch.Tensor],
                  paths: dict[str, tuple[str, ...]]) -> dict:
    """A state_dict -> the JAX tree (nested dicts of f32 numpy arrays in the
    JAX layout) at ``paths`` (:func:`jax_paths`): the inverse of
    :func:`params_from_jax`, as checkpoints store the global model."""
    tree: dict = {}
    for name, path in paths.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_jax_layout(
            params[name].detach().float().cpu().numpy())
    return tree


def tree_paths(tree) -> list[tuple[str, ...]]:
    """The leaf paths of a nested-dict tree, in the JAX leaf order."""
    return [path for path, _ in _flatten(tree)]
