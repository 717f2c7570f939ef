"""In-step data augmentation (ops/augment.py of the JAX package).

``cifar_augment``: the standard CIFAR recipe, a random horizontal flip and
then a pad-4 random crop with zero fill, per sample. The draws are the JAX
package's: a step's key is split into a flip key and a crop key, the flips
are ``bernoulli(flip_key, 0.5, (b,))`` and the crop offsets ``randint(
crop_key, (b, 2), 0, 9)`` (rows, columns), replayed on the host
(ops/prng.py) and applied to the batch on its device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.cohort import to_device

_PAD = 4


def cifar_draws(key, batch: int):
    """``(flip [b] bool, offsets [b, 2] int32)`` of one step's key."""
    flip_key, crop_key = prng.split(key, 2)
    return (prng.bernoulli(flip_key, 0.5, (batch,)),
            prng.randint(crop_key, (batch, 2), 0, 2 * _PAD + 1))


def cifar_augment(x: torch.Tensor, key) -> torch.Tensor:
    """Random flip + pad-4 random crop of an NHWC batch; same shape and
    dtype out. ``x [B, H, W, C]`` with one key, or a chunk's ``[M, B, H, W,
    C]`` with a list of M keys (member m's batch draws from its key), in
    one pass either way."""
    if isinstance(key, (list, tuple)):
        m, b = x.shape[:2]
        draws = [cifar_draws(k, b) for k in key]
        flip = np.concatenate([f for f, _ in draws])
        offsets = np.concatenate([o for _, o in draws])
        out = _flip_crop(x.reshape((m * b,) + tuple(x.shape[2:])), flip,
                         offsets)
        return out.reshape(x.shape)
    flip, offsets = cifar_draws(key, x.shape[0])
    return _flip_crop(x, flip, offsets)


def _flip_crop(x: torch.Tensor, flip, offsets) -> torch.Tensor:
    b, h, w, _ = x.shape
    flip = to_device(flip, x.device)
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    pad = F.pad(x, (0, 0, _PAD, _PAD, _PAD, _PAD))
    off = to_device(offsets, x.device, torch.long)
    rows = off[:, 0, None] + torch.arange(h, device=x.device)
    cols = off[:, 1, None] + torch.arange(w, device=x.device)
    idx = torch.arange(b, device=x.device)[:, None, None]
    return pad[idx, rows[:, :, None], cols[:, None, :]]


_AUGMENTS = {"cifar": cifar_augment}


def get_augment(name: str | None):
    """Augment registry: name -> fn(batch, key) -> batch (or fn(chunk
    batch, keys), see :func:`cifar_augment`); 'none'/None -> None."""
    if not name or name.lower() in ("none", ""):
        return None
    key = name.lower()
    if key not in _AUGMENTS:
        raise ValueError(
            f"unknown augmentation {name!r}; known: none, {sorted(_AUGMENTS)}"
        )
    return _AUGMENTS[key]
