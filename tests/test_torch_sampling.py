"""Participation sampling in the port (ops/sampling.py, ops/cohort.py,
``FedAvg.cohort_indices``, the ``participation_fraction < 1`` round) against
the JAX package.

Exact equality for every index: the hashed stream and draw_cohort_host
under both samplers, with and without an alive mask; the cohorts of 10
rounds x 3 seeds replayed from each package's key chain; cohort_take /
cohort_scatter. The error cases raise the JAX package's exception types.
End to end, a partial-participation ``fed`` run (f32 local state) under
each sampler trains the same cohorts (equal ``cohort_hash`` per round) to
per-round test losses within rtol 1e-4, the injected parity tests'
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.algorithms.fedavg import (
    FedAvg as JaxFedAvg,
)
from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.ops import cohort as jcohort
from distributed_learning_simulator_tpu.ops import sampling as jsampling
from distributed_learning_simulator_tpu_torch.algorithms.fedavg import FedAvg
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.ops import cohort, prng
from distributed_learning_simulator_tpu_torch.ops import sampling
from torch_runs import losses_of, run_both


def _kd(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("n,k", [(10, 1), (50, 25), (1000, 100), (7, 7),
                                 (2**16, 300)])
def test_hashed_cohort_equals_jax(n, k):
    rng = np.random.default_rng(n + k)
    for seed in range(5):
        words = prng.split(prng.key(seed), 4)[0]
        want = jsampling.hashed_cohort_np(words, n, k)
        got = sampling.hashed_cohort_np(words, n, k)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        assert len(set(got.tolist())) == k and got.min() >= 0 and got.max() < n
        alive = rng.random(n) < 0.7
        alive[rng.choice(n, k, replace=False)] = True
        np.testing.assert_array_equal(
            sampling.hashed_cohort_np(words, n, k, alive=alive),
            jsampling.hashed_cohort_np(words, n, k, alive=alive))
    assert sampling.overdraw_block(k, n) == jsampling.overdraw_block(k, n)
    assert sampling._mod_limit(n) == jsampling._mod_limit(n)


@pytest.mark.parametrize("sampler", ["exact", "hashed"])
def test_draw_cohort_host_equals_jax(sampler):
    for seed, (n, k) in enumerate([(10, 3), (100, 10), (1000, 500)]):
        jk = jax.random.fold_in(jax.random.key(seed), 3)
        want = jsampling.draw_cohort_host(jk, n, k, sampler)
        got = sampling.draw_cohort_host(_kd(jk), n, k, sampler)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        # ... and the in-program draw of the JAX round.
        np.testing.assert_array_equal(
            got, np.asarray(jsampling.draw_cohort(jk, n, k, sampler)))
    if sampler == "hashed":
        alive = np.ones(100, bool)
        alive[::3] = False
        jk = jax.random.key(9)
        np.testing.assert_array_equal(
            sampling.draw_cohort_host(_kd(jk), 100, 20, "hashed",
                                      alive=alive),
            jsampling.draw_cohort_host(jk, 100, 20, "hashed", alive=alive))


def test_sampling_errors_match_jax():
    words = prng.key(0)
    cases = [
        lambda m, w, jk: m.draw_cohort_host(jk, 10, 3, "exact",
                                            alive=np.ones(10, bool)),
        lambda m, w, jk: m.draw_cohort_host(jk, 10, 3, "bogus"),
        lambda m, w, jk: m.hashed_cohort_np(w, 10, 0),
        lambda m, w, jk: m.hashed_cohort_np(w, 10, 11),
        lambda m, w, jk: m.hashed_cohort_np(w, 10, 3,
                                            alive=np.ones(9, bool)),
        lambda m, w, jk: m.hashed_cohort_np(w, 10, 3,
                                            alive=np.eye(10, dtype=bool)[0]),
    ]
    for case in cases:
        with pytest.raises(Exception) as want:
            case(jsampling, words, jax.random.key(0))
        with pytest.raises(Exception) as got:
            case(sampling, words, words)
        assert type(got.value) is type(want.value)


@pytest.mark.parametrize("sampler", ["exact", "hashed"])
@pytest.mark.parametrize("fraction", [0.1, 0.5])
def test_cohort_indices_replay_jax_rounds(sampler, fraction):
    n = 40
    for seed in range(3):
        kw = dict(worker_number=n, participation_fraction=fraction,
                  participation_sampler=sampler, seed=seed)
        jalgo = JaxFedAvg(JaxConfig(**kw))
        algo = FedAvg(ExperimentConfig(device="cpu", **kw))
        jkey, key = jax.random.key(seed + 1), prng.key(seed + 1)
        for _ in range(10):
            jkey, jround = jax.random.split(jkey)
            key, round_key = prng.split(key)
            want = np.asarray(jalgo.cohort_indices(jround, n))
            got = algo.cohort_indices(round_key, n)
            np.testing.assert_array_equal(got, want)
            assert got.shape == (round(fraction * n),)
    full = FedAvg(ExperimentConfig(device="cpu", worker_number=n))
    assert full.cohort_indices(prng.key(0), n) is None


def test_cohort_take_and_scatter_equal_jax():
    rng = np.random.default_rng(3)
    stack = rng.normal(size=(9, 4, 3)).astype(np.float32)
    idx = np.asarray([7, 0, 4])
    update = rng.normal(size=(3, 4, 3)).astype(np.float32)
    t = torch.from_numpy(stack)
    np.testing.assert_array_equal(
        cohort.cohort_take(t, idx).numpy(),
        np.asarray(jcohort.cohort_take(jnp.asarray(stack), idx)))
    got = cohort.cohort_scatter(t, idx, torch.from_numpy(update))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcohort.cohort_scatter(
            jnp.asarray(stack), idx, jnp.asarray(update))))
    assert torch.equal(t, torch.from_numpy(stack))  # a new tensor
    assert cohort.cohort_take(None, idx) is None
    assert cohort.cohort_scatter(None, idx, None) is None


@pytest.mark.parametrize("sampler", ["exact", "hashed"])
def test_partial_participation_run_matches_jax(monkeypatch, sampler):
    jres, pres = run_both(monkeypatch, participation_fraction=0.5,
                          participation_sampler=sampler)
    hashes = [r["cohort_hash"] for r in pres["history"]]
    assert hashes == [r["cohort_hash"] for r in jres["history"]]
    assert len(set(hashes)) == len(hashes)  # a new cohort each round
    np.testing.assert_allclose(losses_of(pres), losses_of(jres), rtol=1e-4)
