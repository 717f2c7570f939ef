"""The JAX package's initial parameters, replayed in numpy:
``model.init(jax.random.key(seed), x)["params"]`` of flax 0.12 (JAX
models/registry.py ``init_params``), for every registered model.

flax draws each parameter from its own key. A module scope derives a
parameter's key from the root key by ONE ``fold_in``: of the first 4 bytes
(big-endian) of the SHA-1 over the scope's path names and the scope's
``make_rng`` counter, concatenated with no separators (``LazyRng`` and
``_fold_in_static`` in flax/core/scope.py; ``flax_fix_rng_separator`` is
off by default). Every ``self.param`` bumps its scope's counter, zeros and
ones included, so a scope's first parameter takes counter 1 and its
second counter 2: ``kernel`` then ``bias`` in ``Conv``/``Dense``,
``scale`` then ``bias`` in a GroupNorm, ``conv1_kernel`` then
``proj_kernel`` in the folded ResNet's transition block. The path of each
parameter in the JAX tree, folded ResNet trees included, comes from
models/bridge.py.

Kernels take flax's ``lecun_normal``: ``variance_scaling(1, "fan_in",
"truncated_normal")``, i.e. ``truncated_normal(key, -2, 2, shape)`` times
``sqrt(1 / fan_in) / 0.87962566103423978`` in f32, with the fan-in of the
JAX shape (HWIO: ``kh * kw * cin``; Dense ``[in, out]``: ``in``). The
draw itself is ops/prng.py ``truncated_normal``, bitwise equal to
``jax.random``'s. Biases are zeros and GroupNorm scales ones.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_paths,
    to_jax_layout,
    to_torch_layout,
)
from distributed_learning_simulator_tpu_torch.ops import prng

#: A scope's make_rng counter at each parameter leaf (its creation order).
_COUNTER = {"kernel": 1, "scale": 1, "conv1_kernel": 1, "bias": 2,
            "proj_kernel": 2}
_STD_CORRECTION = np.float32(0.87962566103423978)


def scope_hash(*suffix) -> int:
    """flax's ``_fold_in_static`` digest of a scope path and counter."""
    m = hashlib.sha1()
    for x in suffix:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return int.from_bytes(m.digest()[:4], "big")


def param_key(seed: int, path: tuple[str, ...]) -> np.ndarray:
    """The key flax hands the initializer of the leaf at ``path``."""
    scope, leaf = path[:-1], path[-1]
    return prng.fold_in(prng.key(seed), scope_hash(*scope, _COUNTER[leaf]))


def lecun_normal(k, shape) -> np.ndarray:
    """``nn.initializers.lecun_normal()(k, shape, jnp.float32)``."""
    fan_in = int(np.prod(shape[:-1]))
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / _STD_CORRECTION
    return prng.truncated_normal(k, -2.0, 2.0, shape) * stddev


@functools.lru_cache(maxsize=4)
def _draw(leaves: tuple, seed: int) -> dict[str, np.ndarray]:
    out = {}
    for name, path, shape in leaves:
        leaf = path[-1]
        if leaf == "scale":
            a = np.ones(shape, np.float32)
        elif leaf == "bias":
            a = np.zeros(shape, np.float32)
        else:
            jshape = to_jax_layout(np.empty(shape, np.uint8)).shape
            a = to_torch_layout(lecun_normal(param_key(seed, path), jshape))
        out[name] = np.ascontiguousarray(a)
    return out


def init_params(model, input_hw: tuple[int, int],
                seed: int = 0) -> dict[str, torch.Tensor]:
    """f32 CPU tensors equal to the JAX package's init of the same model on
    inputs of spatial size ``input_hw`` (which picks the ResNet tree). The
    draws of the last few (tree, seed) pairs are kept: ResNet-18's 11.2M
    values take seconds of numpy."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    leaves = tuple((n, path, shapes[n])
                   for n, path in jax_paths(model, input_hw).items())
    return {n: torch.tensor(a) for n, a in _draw(leaves, int(seed)).items()}
