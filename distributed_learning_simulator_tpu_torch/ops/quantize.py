"""The dither hash shared by stochastic rounding (ops/quantize.py ``hash_mix``
in the JAX package).

Torch's uint32 arithmetic is partial, so the 32-bit unsigned math runs in
int64 masked to 32 bits. The multiplies are split into 16-bit halves so no
intermediate leaves int64's positive range: the low 32 bits of ``u * m`` are
``u * (m & 0xFFFF) + ((u * (m >> 16)) & 0xFFFF) << 16`` modulo 2**32.
"""

from __future__ import annotations

import torch

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
