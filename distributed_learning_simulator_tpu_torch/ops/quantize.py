"""Quantization ops (ops/quantize.py of the JAX package): the dither hash
shared with bf16 stochastic rounding, stochastic payload quantization and
fake-quant (QAT).

Torch's uint32 arithmetic is partial, so the 32-bit unsigned math runs in
int64 masked to 32 bits. The multiplies are split into 16-bit halves so no
intermediate leaves int64's positive range: the low 32 bits of ``u * m`` are
``u * (m & 0xFFFF) + ((u * (m >> 16)) & 0xFFFF) << 16`` modulo 2**32.

The JAX package quantizes each leaf of a parameter tree on its own range.
The port keeps a model as one flat vector, so the functions here take the
vector with its :class:`Segments` (the leaves' sizes, in layout order) and
do one segmented pass: a min/max per leaf, then elementwise math with each
element's leaf's scale, zero point and salt. A tensor with no segments is
one leaf. The arithmetic is the JAX package's op for op in f32, so results
are bit-exact given the same inputs and salts.

A chunk's ``[M, P]`` stack of flat models is quantized row by row in one
pass (each row its own extrema and salts), as the JAX package's hooks do
under its client vmap; :func:`fake_quant` runs under ``torch.func.vmap``
(the QAT transform inside the vmapped loss), with the hashes, which view
the float bits as integers, kept outside it.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.ops.cohort import to_device

MASK32 = 0xFFFFFFFF


def _mul32(u: torch.Tensor, m: int) -> torch.Tensor:
    """``(u * m) mod 2**32`` for int64 ``u`` in [0, 2**32) and a constant
    ``m`` in [0, 2**32)."""
    lo, hi = m & 0xFFFF, m >> 16
    return (u * lo + ((u * hi) & 0xFFFF) * 65536) & MASK32


def hash_mix(u: torch.Tensor, salt) -> torch.Tensor:
    """Two-round multiplicative hash of 32-bit ``u`` mixed with ``salt``.

    ``u`` is an int64 tensor holding uint32 values; ``salt`` an int or an
    int64 tensor of uint32 values broadcastable against ``u``. Same function
    as the JAX package's ``h = u * 2654435761 ^ (u >> 13) ^ salt;
    h * 2246822519 ^ (h >> 16)`` (``*`` binds tighter than ``^``; the shifts
    are logical because every value is non-negative)."""
    h = _mul32(u, 2654435761) ^ (u >> 13) ^ salt
    return _mul32(h, 2246822519) ^ (h >> 16)


class Segments:
    """The leaves of a flat vector: their sizes in order, and each
    element's leaf index (for spreading per-leaf values over elements)."""

    def __init__(self, numels: Sequence[int], device=None):
        self.numels = tuple(int(n) for n in numels)
        self.device = device
        # Built at first use on each device a value arrives from (a mesh
        # trains on several): int64, one per element.
        self._ids: dict = {}

    def spread(self, per_leaf: torch.Tensor) -> torch.Tensor:
        """``[..., n_leaves]`` -> one value per element along the last
        dim (broadcastable), on ``per_leaf``'s device."""
        if len(self.numels) == 1:
            return per_leaf
        device = per_leaf.device
        ids = self._ids.get(device)
        if ids is None:
            ids = self._ids[device] = torch.repeat_interleave(
                torch.arange(len(self.numels), device=device),
                to_device(self.numels, device),
            )
        return per_leaf[..., ids]


class QuantizedTensor(NamedTuple):
    """Affine-quantized vector (or ``[M, P]`` stack of them): ``value ~=
    (codes - zero_point) * scale``, with one ``scale``/``zero_point`` per
    leaf (per row and leaf)."""

    codes: torch.Tensor  # f32 integer-valued codes in [0, levels-1]
    scale: torch.Tensor  # f32 [n_leaves] ([M, n_leaves])
    zero_point: torch.Tensor  # f32 like scale, in the quantized domain


def _segments(x: torch.Tensor, segments: Segments | None) -> Segments:
    return segments if segments is not None else Segments((x.numel(),))


def _affine_params(x: torch.Tensor, levels: int, segments: Segments,
                   rows: bool = False, eager: bool = False):
    """Per-leaf ``(scale, zero_point)`` f32 (``[n_leaves]``; with
    ``rows``, ``x`` is ``[M, P]`` and they are ``[M, n_leaves]``), from each
    leaf's min and max taken in the leaf's own dtype (exact: min/max never
    round).

    ``span / (levels - 1)`` is computed as XLA compiles it in the JAX round
    program: a multiply by the f32 reciprocal of the constant. With
    ``eager``, a true f32 division, as JAX computes it outside a jitted
    program (the JAX threaded oracle quantizes its uploads and broadcasts
    that way)."""
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16,
                       torch.float64):
        x = x.float()
    flat = x.detach().reshape(x.shape[0] if rows else 1, -1)
    if flat.numel() == 0 or 0 in segments.numels:
        raise ValueError("cannot quantize a zero-size tensor")
    leaves = flat.split(segments.numels, dim=1)
    xmin = torch.stack([leaf.amin(dim=1) for leaf in leaves], dim=1).float()
    xmax = torch.stack([leaf.amax(dim=1) for leaf in leaves], dim=1).float()
    if not rows:
        xmin, xmax = xmin[0], xmax[0]
    span = xmax - xmin
    if eager:
        step = span / float(levels - 1)
    else:
        step = span * float(np.float32(1.0) / np.float32(levels - 1))
    scale = torch.where(span > 0, step, torch.ones_like(span))
    zero_point = -xmin / scale
    return scale, zero_point


def _dither_u01(x32: torch.Tensor, salt) -> torch.Tensor:
    """Uniform [0, 1) dither from the hash of the value bits mixed with
    ``salt`` (the JAX package's ``_dither_u01``)."""
    u = x32.contiguous().view(torch.int32).to(torch.int64) & MASK32
    h = hash_mix(u, salt)
    return (h >> 8).to(torch.float32) * (2.0**-24)


def stochastic_quantize(x: torch.Tensor, levels: int, salts,
                        segments: Segments | None = None,
                        rows: bool = False,
                        eager: bool = False) -> QuantizedTensor:
    """Quantize ``x`` to ``levels`` levels per leaf with stochastic rounding
    (unbiased: ``P[up] = frac``). ``salts`` holds one 32-bit salt per leaf
    (the JAX package's ``_salt_from_key`` of the leaf's key); the codes are
    bit-exact against JAX given the same salts. With ``rows``, ``x`` is an
    ``[M, P]`` stack of flat vectors and ``salts`` is ``[M, n_leaves]``:
    each row is quantized on its own, as it would be alone. ``eager``: the
    scale as JAX computes it outside a jitted program (``_affine_params``).
    """
    seg = _segments(x[0] if rows else x, segments)
    scale, zero_point = _affine_params(x, levels, seg, rows, eager)
    salt = seg.spread(to_device(salts, x.device, torch.int64).reshape(
        (x.shape[0], -1) if rows else (-1,)))
    normalized = x.float().reshape((x.shape[0], -1) if rows else (-1,)) / (
        seg.spread(scale)) + seg.spread(zero_point)
    dither = _dither_u01(normalized, salt)
    codes = torch.clamp(torch.floor(normalized + dither), 0, levels - 1)
    return QuantizedTensor(codes.reshape(x.shape), scale, zero_point)


def dequantize(q: QuantizedTensor,
               segments: Segments | None = None) -> torch.Tensor:
    """Inverse affine map, f32."""
    rows = q.scale.dim() == 2  # an [M, P] stack (stochastic_quantize)
    seg = _segments(q.codes[0] if rows else q.codes, segments)
    codes = q.codes.reshape((q.codes.shape[0], -1) if rows else (-1,))
    out = (codes - seg.spread(q.zero_point)) * seg.spread(q.scale)
    return out.reshape(q.codes.shape)


def fake_quant(x: torch.Tensor, levels: int,
               segments: Segments | None = None) -> torch.Tensor:
    """Deterministic per-leaf quantize -> dequantize with a straight-through
    gradient (the gradient is the identity). Computed in f32 and cast back
    to ``x``'s dtype, as in the JAX package. Plain tensor ops: it vmaps
    over a stack of models, each with its own per-leaf extrema."""
    seg = _segments(x, segments)
    scale, zero_point = _affine_params(x, levels, seg)
    s, z = seg.spread(scale), seg.spread(zero_point)
    x32 = x.float().reshape(-1)
    codes = torch.clamp(torch.round(x32 / s + z), 0, levels - 1)
    dq = (codes - z) * s
    return (x32 + (dq - x32).detach()).to(x.dtype).reshape(x.shape)
