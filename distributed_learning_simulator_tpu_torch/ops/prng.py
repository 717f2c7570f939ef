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
  ``permutation(key, n)``;
* ``uniform(key, shape)`` (f32) puts the top 23 bits of ``random_bits``
  under the exponent of 1.0, subtracts 1 and scales into ``[minval,
  maxval)``; ``bernoulli(key, p, shape)`` is ``uniform < p``;
* ``randint(key, shape, lo, hi)`` (int32) draws two words per value, from
  the two halves of ``split(key)``, and reduces them modulo the span;
* ``normal(key, shape)`` (f32) is ``sqrt(2) * erf_inv(u)`` of a uniform in
  ``[nextafter(-1, 0), 1)``, ``erf_inv`` over its whole range;
* ``truncated_normal(key, lower, upper, shape)`` (f32) maps a uniform
  between ``erf(lower/√2)`` and ``erf(upper/√2)`` through ``√2 erf_inv``
  and clips. XLA computes ``erf_inv`` in f32 with Giles' polynomial over
  its own ``log1p`` (a rational form for small arguments, else a Cephes
  ``log`` of ``1 + x``); the functions below repeat those polynomials
  operation by operation, with their fused multiply-adds, so the draws
  are bitwise equal on the CPU (the flax initializers, models/
  flax_init.py, are these draws).

The keys are a few words, so numpy on the host is the right place: the
draws cost microseconds and never touch the card.
"""

from __future__ import annotations

import math

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


def uniform(k, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, jnp.float32, minval, maxval)``."""
    shape = (int(shape),) if np.ndim(shape) == 0 else tuple(shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, np.float32(hi - lo), lo))


def bernoulli(k, p=0.5, shape=()) -> np.ndarray:
    """``jax.random.bernoulli(k, p, shape)`` (bool; p an f32 probability)."""
    return uniform(k, shape) < np.float32(p)


def randint(k, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32), for
    ``minval < maxval`` within int32."""
    shape = (int(shape),) if np.ndim(shape) == 0 else tuple(shape)
    span = np.uint32(int(maxval) - int(minval))
    k1, k2 = split(k, 2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    multiplier = np.uint32(2**16) % span
    multiplier = np.uint32((int(multiplier) * int(multiplier)) & MASK32) % span
    offset = ((higher % span) * multiplier + lower % span) % span
    return (np.int32(minval) + offset.astype(np.int32)).astype(np.int32)


def _fma(a, b, c):
    """f32 fused multiply-add ``a * b + c``: the f32 product is exact in
    f64, and the f64 sum rounded to f32 is the fused result except in
    rare double-rounding ties (the tests' bitwise draws meet none)."""
    r = np.multiply(a, b, dtype=np.float64)
    r += c
    return r.astype(np.float32)


def _horner(x, coeffs):
    r = np.full_like(x, np.float32(coeffs[0]))
    for c in coeffs[1:]:
        r = _fma(r, x, np.float32(c))
    return r


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_ERF_INV_P = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_P_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682)


def _xla_log(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``log`` on the CPU, for positive normal ``x``: the
    exponent split off, the mantissa moved into [sqrt(1/2), sqrt(2)) - 1,
    and Cephes' degree-8 polynomial in three interleaved parts."""
    f32 = np.float32
    bits = x.astype(f32).view(np.uint32)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(f32)
    e = f32(1) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(f32)
    small = m < f32(0.707106781186547524)
    e = e - np.where(small, f32(1), f32(0))
    t = (m - f32(1)) + np.where(small, m, f32(0))
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(_fma(t, f32(p[0]), f32(p[1])), t, f32(p[2]))
    y1 = _fma(_fma(t, f32(p[3]), f32(p[4])), t, f32(p[5]))
    y2 = _fma(_fma(t, f32(p[6]), f32(p[7])), t, f32(p[8]))
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, f32(-2.12194440e-4) * e)
    t = _fma(f32(-0.5), x2, t) + y
    return _fma(f32(0.693359375), e, t)


def _xla_log1p(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``log1p`` on the CPU, for ``x > -1``: Cephes' rational
    form below ``|x| < sqrt(2) - 1``, else ``log(1 + x)``."""
    f32 = np.float32
    x = x.astype(f32)
    out = np.empty_like(x)
    small = np.abs(x) < f32(0.41421356237309504880)
    xs = x[small]
    x2 = xs * xs
    ratio = _horner(xs, _LOG1P_NUM) / _horner(xs, _LOG1P_DEN)
    out[small] = xs + _fma(f32(-0.5), x2, (xs * x2) * ratio)
    out[~small] = _xla_log(f32(1) + x[~small])
    return out


def _xla_erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv`` over ``-1 < x < 1``: Giles' polynomial in
    ``w - 2.5`` where ``w = -log1p(-x*x) < 5``, else in ``sqrt(w) - 3``
    with the tail coefficients."""
    f32 = np.float32
    x = x.astype(f32)
    w = -_xla_log1p(-(x * x))
    small = w < f32(5)
    out = np.empty_like(x)
    out[small] = _horner(w[small] - f32(2.5), _ERF_INV_P) * x[small]
    tail = ~small
    out[tail] = (_horner(np.sqrt(w[tail]) - f32(3), _ERF_INV_P_TAIL)
                 * x[tail])
    return out


def normal(k, shape, scale: float = 1.0) -> np.ndarray:
    """``scale * jax.random.normal(k, shape)`` (f32) as a jitted program
    computes it: ``(scale * sqrt(2)) * erf_inv(u)`` with ``u`` uniform in
    ``[nextafter(-1, 0), 1)``; XLA folds the two constants into one f32
    product first (``scale=1`` is ``jax.random.normal`` itself)."""
    f32 = np.float32
    lo = np.nextafter(f32(-1), f32(0))
    u = uniform(k, shape, lo, f32(1))
    return ((f32(scale) * f32(np.sqrt(2))) * _xla_erf_inv(u)).astype(
        f32)


def truncated_normal(k, lower: float, upper: float, shape) -> np.ndarray:
    """``jax.random.truncated_normal(k, lower, upper, shape)`` (f32) for
    ``-2 <= lower < upper <= 2``. The bounds' ``erf`` is f32-rounded from
    the exact value (XLA's f32 erf gives the same words at these points;
    tests/test_torch_prng.py holds the draws bitwise)."""
    if not -2.0 <= lower < upper <= 2.0:
        raise ValueError("truncated_normal replay covers -2 <= lower < "
                         "upper <= 2")
    f32 = np.float32
    sqrt2 = f32(np.sqrt(2))
    a = f32(math.erf(float(f32(lower) / sqrt2)))
    b = f32(math.erf(float(f32(upper) / sqrt2)))
    out = sqrt2 * _xla_erf_inv(uniform(k, shape, a, b))
    return np.clip(out, np.nextafter(f32(lower), f32(np.inf)),
                   np.nextafter(f32(upper), f32(-np.inf))).astype(f32)


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
    ("bernoulli(key(4), 0.5, (8,))", "bernoulli", (key(4), 0.5, (8,)),
     [False, False, True, False, False, False, True, False]),
    ("randint(key(5), (4,), 0, 9)", "randint", (key(5), (4,), 0, 9),
     [3, 0, 3, 0]),
    ("uniform(key(7), (3,))", "uniform", (key(7), (3,)),
     [0.6740899085998535, 0.9746168851852417, 0.3028435707092285]),
    ("truncated_normal(key(6), -2, 2, (3,))", "truncated_normal",
     (key(6), -2.0, 2.0, (3,)),
     [0.3680495321750641, -0.5420456528663635, -1.496392846107483]),
    ("normal(key(8), (3,))", "normal", (key(8), (3,)),
     [-0.5515055656433105, -1.3691120147705078, 2.7549402713775635]),
)


def known_answer_mismatches() -> list[str]:
    """The names of the :data:`KNOWN_ANSWERS` this module does not
    reproduce (empty when all agree)."""
    return [
        name for name, fn, args, want in KNOWN_ANSWERS
        if np.asarray(globals()[fn](*args)).tolist() != want
    ]
