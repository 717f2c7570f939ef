"""The port's aggregation rules and Shapley helpers (ops/aggregate.py)
against the JAX package's, on seeded client stacks with ties, an even
client count and zero weights, with and without weights.

Tolerances: coordinate median exact (both take ``(lo + hi) * 0.5`` of the
same sorted values); Krum selects the same client and returns its row
exactly; trimmed mean f32 rtol 1e-6 (a sum in another order); masks
exact; the Shapley helpers' values f32 rtol 1e-6 (atol 1e-6 of the values'
magnitude, for sums that cancel). End to end, a ``fed`` run under each
robust rule (the materializing path, f32 local state) gives per-round test
losses within rtol 1e-4 of the JAX package's, with no injected draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.ops import aggregate as jagg
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.ops import aggregate as agg
from torch_runs import losses_of, run_both


def _stack(n: int, p: int = 257, seed: int = 0, ties: bool = True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    if ties:
        # Repeated rows and repeated values inside columns.
        x[1] = x[0]
        x[:, :20] = np.round(x[:, :20])
    return x


def _weights(n: int, kind: str):
    if kind == "none":
        return None
    rng = np.random.default_rng(n)
    w = rng.integers(1, 50, size=n).astype(np.float32)
    if kind == "zeros":
        w[[0, n - 1]] = 0.0
    if kind == "all_zero":
        w[:] = 0.0
    return w


WEIGHTS = ["none", "positive", "zeros", "all_zero"]


@pytest.mark.parametrize("n", [5, 8])
@pytest.mark.parametrize("kind", WEIGHTS)
def test_coordinate_median_exact(n, kind):
    x = _stack(n)
    w = _weights(n, kind)
    want = np.asarray(jagg.coordinate_median(jnp.asarray(x), weights=w))
    got = agg.coordinate_median(torch.from_numpy(x), weights=w).numpy()
    np.testing.assert_array_equal(got, want)
    # A diverged client is ignored, as in the JAX package.
    x[2, 7] = np.nan
    want = np.asarray(jagg.coordinate_median(jnp.asarray(x), weights=w))
    got = agg.coordinate_median(torch.from_numpy(x), weights=w).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [5, 8, 12])
@pytest.mark.parametrize("kind", WEIGHTS)
@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.3])
def test_trimmed_mean(n, kind, ratio):
    x = _stack(n, seed=n)
    w = _weights(n, kind)
    want = np.asarray(jagg.trimmed_mean(jnp.asarray(x), ratio, weights=w))
    got = agg.trimmed_mean(torch.from_numpy(x), ratio, weights=w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for m in (1, 7, 10, 99):
        assert agg.trim_count(m, ratio) == jagg.trim_count(m, ratio)


@pytest.mark.parametrize("n", [5, 8, 12])
@pytest.mark.parametrize("kind", WEIGHTS)
def test_krum_same_client_exact_row(n, kind):
    x = _stack(n, seed=2 * n, ties=False)
    x[3] += 4.0  # an outlier
    w = _weights(n, kind)
    f = jagg.trim_count(n, 0.1)
    want = np.asarray(jagg.krum(jnp.asarray(x), f, weights=w))
    idx = agg.krum_select(torch.from_numpy(x), f, weights=w)
    np.testing.assert_array_equal(x[idx], want)
    got = agg.krum(torch.from_numpy(x), f, weights=w).numpy()
    np.testing.assert_array_equal(got, want)
    if kind in ("zeros",):
        assert idx not in (0, n - 1)  # zero-weight clients never win
    with pytest.raises(ValueError):
        agg.krum(torch.from_numpy(x[:4]), 1)


@pytest.mark.parametrize("rule", ["mean", "median", "trimmed_mean", "krum"])
def test_aggregate_dispatch(rule):
    x = _stack(8, seed=5)
    w = _weights(8, "zeros")
    want = np.asarray(jagg.aggregate(jnp.asarray(x), w, rule, 0.2))
    got = agg.aggregate(torch.from_numpy(x), w, rule, 0.2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        agg.aggregate(torch.from_numpy(x), w, "bogus")


@pytest.mark.parametrize("n", [1, 3, 5])
def test_subset_masks_all_exact(n):
    np.testing.assert_array_equal(agg.subset_masks_all(n),
                                  jagg.subset_masks_all(n))
    np.testing.assert_array_equal(agg.subset_masks_all(n, False),
                                  jagg.subset_masks_all(n, False))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_subset_weighted_mean(dtype):
    x = _stack(6, seed=9)
    w = _weights(6, "zeros")
    prev = np.random.default_rng(1).normal(size=x.shape[1]).astype(np.float32)
    masks = agg.subset_masks_all(6)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    # The port reads a bf16 stack as its bf16 values held in f32.
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).float()
    got = agg.subset_weighted_mean(tx, w, masks, torch.from_numpy(prev))
    for r, m in enumerate(masks):
        want = np.asarray(jagg.subset_weighted_mean(jx, w, m, jnp.asarray(prev)))
        np.testing.assert_allclose(got[r].numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(x).max())
        single = agg.subset_weighted_mean(tx, w, m, torch.from_numpy(prev))
        np.testing.assert_array_equal(single.numpy(), got[r].numpy())
    # Subsets of zero weight fall back to the previous model exactly.
    np.testing.assert_array_equal(got[0].numpy(), prev)
    np.testing.assert_array_equal(
        agg.subset_weighted_mean(tx, w, np.eye(6, dtype=np.float32)[0],
                                 torch.from_numpy(prev)).numpy(), prev)


def test_block_prefix_cumsum_and_prefix_means():
    x = _stack(7, seed=11)
    w = _weights(7, "zeros")
    prev = np.random.default_rng(2).normal(size=x.shape[1]).astype(np.float32)
    rng = np.random.default_rng(4)
    perms = np.stack([rng.permutation(7) for _ in range(3)]).astype(np.int32)
    tol = dict(rtol=1e-6, atol=1e-6 * np.abs(x).max() * w.sum())
    carry = jcarry = carry_t = jcarry_t = None
    for j0, j1 in ((0, 4), (4, 7)):
        block = perms[:, j0:j1]
        jcs, jtot = jagg.block_prefix_cumsum(jnp.asarray(x), w, block,
                                             jcarry, jcarry_t)
        cs, tot = agg.block_prefix_cumsum(torch.from_numpy(x), w,
                                          torch.from_numpy(block), carry,
                                          carry_t)
        np.testing.assert_allclose(cs.numpy(), np.asarray(jcs), **tol)
        np.testing.assert_allclose(tot.numpy(), np.asarray(jtot), rtol=1e-6)
        jm = jagg.prefix_means_from_cumsum(jcs, jtot, jnp.asarray(prev))
        m = agg.prefix_means_from_cumsum(cs, tot, torch.from_numpy(prev))
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6,
                                   atol=1e-6 * np.abs(x).max())
        jcarry, jcarry_t = jcs[:, -1], jtot[:, -1]
        carry, carry_t = cs[:, -1], tot[:, -1]


def test_config_checks_match_jax():
    for kw in (dict(aggregation="trimmed_mean", worker_number=4),
               dict(aggregation="krum", worker_number=4, trim_ratio=0.3),
               dict(client_eval=True,
                    distributed_algorithm="GTG_shapley_value"),
               dict(shapley_eval_chunk=0), dict(gtg_prefix_mode="bogus"),
               dict(shapley_eval_dtype="float16"),
               dict(gtg_max_permutations=0)):
        with pytest.raises(ValueError) as want:
            JaxConfig(**kw).validate()
        with pytest.raises(ValueError) as got:
            ExperimentConfig(device="cpu", **kw).validate()
        assert str(got.value) == str(want.value)
    for kw in (dict(aggregation="trimmed_mean", worker_number=10),
               dict(aggregation="krum", worker_number=5)):
        JaxConfig(**kw).validate()
        ExperimentConfig(device="cpu", **kw).validate()


@pytest.mark.parametrize("rule", ["median", "trimmed_mean", "krum"])
def test_robust_run_matches_jax(rule):
    jres, pres = run_both(aggregation=rule, trim_ratio=0.2)
    np.testing.assert_allclose(losses_of(pres), losses_of(jres), rtol=1e-4)
