"""The parts of ``jax.random`` that the JAX package's key chain uses, on the
host in numpy uint32, so the port replays the reference's draws bit for
bit: round keys, the per-client training keys, batch orders, rounding and
quantization salts, and cohorts.

A key is what ``jax.random.key_data`` returns for a ``threefry2x32`` key:
a uint32 array of shape ``(2,)`` (or ``(..., 2)`` for a batch of keys).
The semantics are those of JAX 0.9 with ``jax_threefry_partitionable``
on (its default), the PRNG implementation ``threefry2x32`` and 64-bit
mode off:

* ``key(seed)`` is ``[0, seed mod 2**32]``;
* ``split(key, n)[i]`` is ``threefry(key, (0, i))``: the two output
  words of the counter pair (hi, lo) of the 64-bit index ``i``;
* ``fold_in(key, d)`` is ``threefry(key, (0, d))``;
* ``random_bits(key, shape)`` is the xor of the two output words over the
  counters of the flat index;
* ``permutation(key, n)`` sorts ``arange(n)`` by fresh random bits
  ``ceil(3 ln n / ln(2**32 - 1))`` times, each time with the second half
  of a 2-way split (a stable sort, as ``lax.sort_key_val``);
* ``choice(key, n, k, replace=False)`` is the first k of
  ``permutation(key, n)``.

The keys are a few words, so numpy on the host is the right place: the
draws cost microseconds and never touch the card.
"""

from __future__ import annotations

import numpy as np

from distributed_learning_simulator_tpu_torch.ops.sampling import threefry2x32

MASK32 = 0xFFFFFFFF
_UINT32_MAX = float(MASK32)


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))``."""
    return np.asarray([0, int(seed) & MASK32], dtype=np.uint32)


def key_data(k) -> np.ndarray:
    """The key's uint32 words, flattened (a copy)."""
    return np.array(k, dtype=np.uint32).reshape(-1)


def _words(k):
    kd = np.asarray(k, dtype=np.uint32).reshape(-1)
    if kd.shape != (2,):
        raise ValueError(f"expected one threefry key of 2 words, got {kd}")
    return kd[0], kd[1]


def _counters(size: int):
    """(hi, lo) uint32 words of a uint64 iota of ``size``."""
    idx = np.arange(size, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(MASK32)).astype(np.uint32))


def split(k, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)`` as key data: ``[num, 2]`` uint32."""
    k0, k1 = _words(k)
    hi, lo = _counters(int(num))
    b0, b1 = threefry2x32(np, k0, k1, hi, lo)
    return np.stack([b0, b1], axis=-1)


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)`` for ``0 <= data < 2**32``."""
    data = int(data)
    if not 0 <= data <= MASK32:
        raise OverflowError(f"fold_in data {data} out of bounds for uint32")
    k0, k1 = _words(k)
    b0, b1 = threefry2x32(np, k0, k1, np.zeros(1, np.uint32),
                          np.asarray([data], np.uint32))
    return np.asarray([b0[0], b1[0]], dtype=np.uint32)


def random_bits(k, shape) -> np.ndarray:
    """``jax.random.bits(k, shape)`` (32-bit, uint32)."""
    shape = (int(shape),) if np.ndim(shape) == 0 else tuple(shape)
    size = int(np.prod(shape, dtype=np.int64))
    k0, k1 = _words(k)
    hi, lo = _counters(size)
    b0, b1 = threefry2x32(np, k0, k1, hi, lo)
    return (b0 ^ b1).reshape(shape)


def shuffle_rounds(n: int) -> int:
    """Sort rounds of ``jax.random.permutation`` over ``n`` elements."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(_UINT32_MAX)))


def permutation(k, n: int) -> np.ndarray:
    """``jax.random.permutation(k, n)`` (int32, as JAX returns it)."""
    x = np.arange(int(n), dtype=np.int32)
    for _ in range(shuffle_rounds(n)):
        k, sub = split(k, 2)
        order = np.argsort(random_bits(sub, x.shape), kind="stable")
        x = x[order]
    return x


def choice(k, n: int, size: int, replace: bool = False) -> np.ndarray:
    """``jax.random.choice(k, n, (size,), replace=False)``."""
    if replace:
        raise NotImplementedError(
            "choice(replace=True) is not used by the key chain"
        )
    if n <= 0:
        raise ValueError("a must be greater than 0 unless no samples are taken")
    if size > n:
        raise ValueError(
            f"Cannot take a larger sample (size {size}) than population "
            f"(size {n}) when 'replace=False'"
        )
    return permutation(k, n)[:size]


def salt_from_key(k) -> int:
    """The 32-bit quantization salt of a key (``_salt_from_key`` in the JAX
    package's ops/quantize.py): ``kd[0] * 0x9E3779B9 ^ kd[-1]``."""
    kd = key_data(k)
    return ((int(kd[0]) * 0x9E3779B9) & MASK32) ^ int(kd[-1])


def leaf_salts(k, n_leaves: int) -> list[int]:
    """One salt per parameter leaf: ``split(k, n_leaves)``, each folded by
    :func:`salt_from_key` (``stochastic_quantize_tree``'s per-leaf keys)."""
    return [salt_from_key(sub) for sub in split(k, n_leaves)]


#: Known answers of ``jax.random`` (JAX 0.9.0, threefry2x32, partitionable
#: key derivation): ``(name, function of this module, its arguments,
#: expected value)``. tests/test_torch_prng.py holds them equal to the
#: installed jax and chip_smoke.py to this module on the card's host.
KNOWN_ANSWERS = (
    ("split(key(0), 2)", "split", (key(0), 2),
     [[1797259609, 2579123966], [928981903, 3453687069]]),
    ("fold_in(key(42), 7)", "fold_in", (key(42), 7),
     [2547012911, 1371500959]),
    ("random_bits(key(1), 4)", "random_bits", (key(1), (4,)),
     [1883912375, 2292451390, 1915204986, 1882898417]),
    ("permutation(key(2), 10)", "permutation", (key(2), 10),
     [2, 9, 4, 7, 1, 6, 3, 8, 5, 0]),
    ("choice(key(3), 100, 5)", "choice", (key(3), 100, 5),
     [38, 0, 99, 33, 65]),
)


def known_answer_mismatches() -> list[str]:
    """The names of the :data:`KNOWN_ANSWERS` this module does not
    reproduce (empty when all agree)."""
    return [
        name for name, fn, args, want in KNOWN_ANSWERS
        if np.asarray(globals()[fn](*args)).tolist() != want
    ]
