"""Participation sampling (ops/sampling.py of the JAX package), on the host.

``config.participation_sampler`` picks how a ``participation_fraction < 1``
round draws its cohort of ``cohort_size()`` clients from the round key's
``part_key``:

* ``exact``: ``choice(part_key, N, k, replace=False)``, the first k of a
  full permutation (ops/prng.py replays ``jax.random.choice`` bit for bit);
* ``hashed``: the first k DISTINCT values of a Threefry-2x32 counter stream
  over the key's two words, values past the largest uint32 multiple of N
  rejected before the ``% N`` so the draw has no modulo bias. O(k) work
  for k << N.

The JAX package draws in its round program and replays the same draw on
the host; the port draws on the host only (:func:`draw_cohort_host`), so
the indices are the JAX program's by construction.

The Threefry math (:func:`threefry2x32`) is written over an array-module
argument ``xp``, as in the JAX package; the port calls it with numpy, whose
uint32 arithmetic wraps as the JAX package's does.
"""

from __future__ import annotations

import numpy as np

from distributed_learning_simulator_tpu_torch.config import (
    PARTICIPATION_SAMPLERS as SAMPLERS,
)

# Threefry-2x32 constants (Salmon et al., SC'11): 4-round rotation
# schedules and the key-schedule parity word.
_ROTS_A = (13, 15, 26, 6)
_ROTS_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def threefry2x32(xp, k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, written over the array module ``xp``.

    ``k0``/``k1`` are uint32 key words, ``x0``/``x1`` uint32 counter
    arrays (or scalars). Returns the two output words."""
    ks0 = xp.asarray(k0, xp.uint32)
    ks1 = xp.asarray(k1, xp.uint32)
    ks2 = ks0 ^ ks1 ^ xp.uint32(_PARITY)
    ks = (ks0, ks1, ks2)
    x0 = xp.asarray(x0, xp.uint32) + ks0
    x1 = xp.asarray(x1, xp.uint32) + ks1
    for i in range(5):
        for r in _ROTS_A if i % 2 == 0 else _ROTS_B:
            x0 = x0 + x1
            x1 = (x1 << xp.uint32(r)) | (x1 >> xp.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + xp.uint32(i + 1)
    return x0, x1


def overdraw_block(k: int, n: int) -> int:
    """Block size of the hashed draw's rejection buffer: k slots, a margin
    of 64, and four times the ~B^2/(2N) expected in-block collisions,
    capped at 4k+64. The selection does not depend on it ("first k
    distinct of the stream"); it only sets how often the loop iterates.
    The same formula as the JAX package's, so both draw the same blocks."""
    if k <= 0:
        return 64
    b = k + 64
    b = k + 64 + int(4.0 * b * b / (2 * max(n, 1)))
    return max(min(b, 4 * k + 64), 1)


def _mod_limit(n: int) -> int:
    """Largest multiple of ``n`` representable in uint32 counters: stream
    values at or above it are rejected before the ``% n``, so the kept
    indices are exactly uniform."""
    return (2**32 // n) * n


def _hashed_block_np(k0: np.uint32, k1: np.uint32, start: int, size: int,
                     n: int) -> np.ndarray:
    """``size`` stream positions from counter ``start``: uniform int64
    indices in [0, n), modulo-bias rejections marked -1."""
    ctr = np.arange(start, start + size, dtype=np.uint32)
    v0, _ = threefry2x32(np, k0, k1, ctr, np.zeros(size, np.uint32))
    vals = (v0 % np.uint32(n)).astype(np.int64)
    limit = _mod_limit(n)
    if limit < 2**32:  # n divides 2^32 exactly -> nothing to reject
        vals = np.where(v0 < np.uint32(limit), vals, -1)
    return vals


def _check_alive(alive, n: int, k: int):
    """Validate an alive mask for the masked hashed draw: bool[n] with at
    least k alive indices (fewer could never fill the cohort)."""
    alive = np.asarray(alive, dtype=bool)
    if alive.shape != (n,):
        raise ValueError(
            f"alive mask has shape {alive.shape}, expected ({n},)"
        )
    n_alive = int(alive.sum())
    if n_alive < k:
        raise ValueError(
            f"cannot draw a {k}-client cohort from {n_alive} alive "
            f"clients (population {n}); departures must leave at least "
            "the cohort size alive"
        )
    return alive


def hashed_cohort_np(key_words, n: int, k: int,
                     alive=None) -> np.ndarray:
    """The hashed draw: the first k distinct values of the counter stream
    keyed by ``key_words`` (the uint32 key data of ``part_key``), int64.
    ``alive`` (bool[n]) rejects departed indices like modulo-bias values."""
    if not 0 < k <= n:
        raise ValueError(f"need 0 < k <= n, got k={k}, n={n}")
    if alive is not None:
        alive = _check_alive(alive, n, k)
    kw = np.asarray(key_words).ravel()
    k0, k1 = np.uint32(kw[0]), np.uint32(kw[1])
    size = overdraw_block(k, n)
    out = np.empty(k, dtype=np.int64)
    count = 0
    start = 0
    while count < k:
        vals = _hashed_block_np(k0, k1, start, size, n)
        start += size
        if alive is not None:
            vals = np.where(
                (vals >= 0) & alive[np.where(vals >= 0, vals, 0)],
                vals, -1,
            )
        # First occurrence within the block, in stream order, minus
        # rejections (-1) and values selected in earlier blocks.
        _, first = np.unique(vals, return_index=True)
        keep = np.zeros(vals.size, dtype=bool)
        keep[first] = True
        keep &= vals >= 0
        keep &= ~np.isin(vals, out[:count])
        fresh = vals[keep][: k - count]
        out[count : count + fresh.size] = fresh
        count += fresh.size
    return out


def draw_cohort_host(part_key, n_clients: int, n_participants: int,
                     sampler: str = "exact", *, alive=None) -> np.ndarray:
    """The round's cohort: the true client ids, ``n_participants`` of them.

    ``exact`` is ``prng.choice(part_key, n, k)`` (int32, as the JAX
    program's ``jax.random.choice``); ``hashed`` is :func:`hashed_cohort_np`
    (int64) over ``part_key``'s words. ``alive`` is for the hashed sampler
    only."""
    from distributed_learning_simulator_tpu_torch.ops import prng

    if sampler == "exact":
        if alive is not None:
            raise ValueError(
                "participation_sampler='exact' cannot compose an alive "
                "mask: the permutation draw has no maskable stream; use "
                "'hashed' for dynamic populations"
            )
        return prng.choice(part_key, n_clients, n_participants,
                           replace=False).astype(np.int32)
    if sampler == "hashed":
        return hashed_cohort_np(prng.key_data(part_key), n_clients,
                                n_participants, alive=alive)
    raise ValueError(
        f"unknown participation_sampler {sampler!r}; known: "
        + ", ".join(SAMPLERS)
    )
