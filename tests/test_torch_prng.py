"""The port's key chain (ops/prng.py) against the installed ``jax.random``,
bit for bit: key, split, fold_in, key_data and 32-bit random_bits over 200
seeded keys (seeds 0, 1 and 2**31 - 1 among them), permutation and
choice(replace=False) up to n = 70000 (two sort rounds), the quantization
salt, the engine's per-client draws, and the known-answer vectors that
chip_smoke.py also checks. Tolerance: none, every word equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_learning_simulator_tpu.ops import quantize as jq
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    client_draws,
)

SEEDS = [0, 1, 2**31 - 1] + [
    int(s) for s in np.random.default_rng(0).integers(0, 2**31 - 1, 197)
]
PERM_SIZES = (1, 2, 25, 50, 200, 1000, 70000)


def _kd(k):
    return np.asarray(jax.random.key_data(k))


def test_jax_uses_the_partitionable_threefry_chain():
    # The port replays this configuration; a JAX upgrade that changes it
    # must fail here, with this reason, rather than in a parity test.
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert not jax.config.jax_enable_x64


def test_key_split_fold_in_bits_bit_exact():
    rng = np.random.default_rng(1)
    # Batched over the 200 keys on the JAX side (one jitted call each).
    jkeys = jax.vmap(jax.random.key)(jnp.asarray(SEEDS, jnp.uint32))
    want_keys = _kd(jkeys)
    datas = rng.integers(0, 2**32, len(SEEDS), dtype=np.uint64)
    for n in (1, 2, 4, 5, 1000):
        want = _kd(jax.vmap(lambda k, n=n: jax.random.split(k, n))(jkeys))
        for i, seed in enumerate(SEEDS):
            np.testing.assert_array_equal(prng.split(prng.key(seed), n),
                                          want[i], err_msg=f"{seed} {n}")
    folded = _kd(jax.vmap(jax.random.fold_in)(
        jkeys, jnp.asarray(datas.astype(np.uint32))))
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (3, 5)))(jkeys))
    for i, seed in enumerate(SEEDS):
        k = prng.key(seed)
        np.testing.assert_array_equal(k, want_keys[i])
        np.testing.assert_array_equal(prng.key_data(k), want_keys[i])
        np.testing.assert_array_equal(prng.fold_in(k, int(datas[i])),
                                      folded[i])
        got = prng.random_bits(k, (3, 5))
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, bits[i])
    # Unbatched JAX calls agree with the batched ones, and the edge words.
    for seed in (0, 1, 2**31 - 1):
        np.testing.assert_array_equal(prng.key(seed),
                                      _kd(jax.random.key(seed)))
        for d in (0, 7, 2**32 - 1):
            np.testing.assert_array_equal(
                prng.fold_in(prng.key(seed), d),
                _kd(jax.random.fold_in(jax.random.key(seed), d)))
    with pytest.raises(OverflowError):
        prng.fold_in(prng.key(0), 2**32)


@pytest.mark.parametrize("n", PERM_SIZES)
def test_permutation_and_choice_bit_exact(n):
    seeds = SEEDS[:8] if n == 70000 else SEEDS[:40]
    if n == 70000:
        # More than one sort round: each round re-splits the key.
        rounds = int(np.ceil(3 * np.log(n) / np.log(np.iinfo(np.uint32).max)))
        assert rounds == prng.shuffle_rounds(n) == 2
    k_take = max(1, n // 3)
    for seed in seeds:
        jk = jax.random.key(seed)
        got = prng.permutation(prng.key(seed), n)
        np.testing.assert_array_equal(got, np.asarray(
            jax.random.permutation(jk, n)), err_msg=f"{seed}")
        np.testing.assert_array_equal(
            prng.choice(prng.key(seed), n, k_take),
            np.asarray(jax.random.choice(jk, n, (k_take,), replace=False)),
            err_msg=f"{seed}",
        )
    with pytest.raises(ValueError):
        prng.choice(prng.key(0), n, n + 1)


def test_salts_and_client_draws_match_the_jax_chain():
    for seed in SEEDS[:20]:
        jk = jax.random.key(seed)
        k = prng.key(seed)
        assert prng.salt_from_key(k) == int(jq._salt_from_key(jk))
        assert prng.leaf_salts(k, 7) == [
            int(jq._salt_from_key(s)) for s in jax.random.split(jk, 7)]
        # The engine's per-client draws, as the JAX local_train derives
        # them from the client's key.
        perms, salt = client_draws(k, 24, 3)
        assert salt == int(_kd(jax.random.fold_in(jk, 7))[0])
        for p, ek in zip(perms, jax.random.split(jk, 3)):
            np.testing.assert_array_equal(
                p.numpy(), np.asarray(jax.random.permutation(ek, 24)))


def test_known_answers_are_jax_values():
    jfn = {
        "split": lambda k, n: _kd(jax.random.split(jax.random.wrap_key_data(
            jnp.asarray(k)), n)),
        "fold_in": lambda k, d: _kd(jax.random.fold_in(
            jax.random.wrap_key_data(jnp.asarray(k)), d)),
        "random_bits": lambda k, s: np.asarray(jax.random.bits(
            jax.random.wrap_key_data(jnp.asarray(k)), s)),
        "permutation": lambda k, n: np.asarray(jax.random.permutation(
            jax.random.wrap_key_data(jnp.asarray(k)), n)),
        "choice": lambda k, n, m: np.asarray(jax.random.choice(
            jax.random.wrap_key_data(jnp.asarray(k)), n, (m,),
            replace=False)),
    }
    for name, fn, args, want in prng.KNOWN_ANSWERS:
        assert jfn[fn](*args).tolist() == want, name
    assert prng.known_answer_mismatches() == []
