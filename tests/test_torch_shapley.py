"""The port's Shapley algorithms (algorithms/shapley.py) against the JAX
package's.

* ``shapley_from_utilities`` equal on random utility tables (the same f64
  sums in the same order), and ``SubsetMemo``'s accounting equal.
* ``gtg_walk`` through each package's own subset evaluator, driven by the
  same stub eval function: the utility of a subset model is a function of
  its support (exact dyadic values, so both packages compute every utility
  exactly). Both prefix modes give the same SVs (1e-12), permutation
  counts, convergence flags and memo key sets as the JAX walk, and the
  same utilities.
* One round of each algorithm through ``run_simulation`` on the tiny
  ResNet with f32 subset evaluation and no injected draws: every subset
  utility within 2/n_eval of the JAX package's (one test sample's
  prediction) and so every SV within 4/n_eval, the efficiency identity
  sum SV = u(all) - u(empty) to 1e-6 for multiround, GTG's permutation
  and evaluation counts, equal ``metric_<round>.pkl`` key sets, and the
  ``shapley values`` log line.
"""

import glob
import logging
import math
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.algorithms import shapley as jshap
from distributed_learning_simulator_tpu_torch.algorithms import shapley
from distributed_learning_simulator_tpu_torch.utils.logging import get_logger
from torch_runs import run_both

N = 6
# Per-client utility weights: multiples of 1/64, so sums are exact in f32.
COEF = np.asarray([5, -3, 9, 2, 7, 1], np.float32) / 64.0


def test_shapley_from_utilities_equals_jax():
    rng = np.random.default_rng(0)
    for n in (1, 3, 5):
        masks = jshap.subset_masks_all(n)
        utilities = {frozenset(np.flatnonzero(m).tolist()): float(u)
                     for m, u in zip(masks, rng.random(len(masks)))}
        got = shapley.shapley_from_utilities(utilities, n)
        np.testing.assert_array_equal(
            got, jshap.shapley_from_utilities(utilities, n))
        assert math.isclose(got.sum(), utilities[frozenset(range(n))]
                            - utilities[frozenset()], abs_tol=1e-12)


def test_subset_memo_equals_jax():
    seed = {frozenset({0}): 0.5, frozenset({1, 2}): 0.25}
    memos = [shapley.SubsetMemo(dict(seed)), jshap.SubsetMemo(dict(seed))]
    for memo in memos:
        assert memo.hit_rate() is None
        assert frozenset({0}) in memo and frozenset({3}) not in memo
        memo[frozenset({3})] = 1.0
        memo[frozenset({3})] = 2.0  # a rewrite is no new evaluation
        memo[frozenset({0})] = 0.75
    a, b = memos
    assert dict(a) == dict(b)
    assert a.evaluated == b.evaluated == 1
    assert a.hit_rate() == b.hit_rate() == 0.5


def _stub_jax(params, xb, yb, mb):
    support = params > 0
    return {"accuracy": jnp.sum(jnp.where(support, COEF, 0.0))
            + 0.125 * jnp.sum(support) ** 2 / 8.0}


def _stub_torch(flat, xb, yb, mb):
    support = flat > 0
    coef = torch.from_numpy(COEF)
    return {"accuracy": torch.where(support, coef, 0.0).sum()
            + 0.125 * support.sum().float() ** 2 / 8.0}


@pytest.mark.parametrize("mode", ["cumsum", "masked"])
def test_gtg_walk_with_a_stub_evaluator_equals_jax(mode):
    # Client i's upload is (i + 1) on coordinate i: a subset model's
    # support is the subset.
    stack = np.diag(np.arange(1, N + 1)).astype(np.float32)
    sizes = np.asarray([3, 1, 4, 1, 5, 9], np.float32)
    prev = np.zeros(N, np.float32)
    batches = (np.zeros((1, 2, 1), np.float32),) * 3
    grand = float(_stub_torch(torch.ones(N), *batches)["accuracy"])
    kw = dict(eps=1e-3, cap=120, last_k=10, converge_criteria=0.05,
              trunc_ref=grand, prefix_mode=mode)
    jmemo, memo = {}, {}
    want = jshap.gtg_walk(
        jshap._SubsetEvaluator(_stub_jax, chunk=16), jnp.asarray(stack),
        sizes, jnp.asarray(prev), tuple(map(jnp.asarray, batches)), N,
        np.random.default_rng(7), memo=jmemo, **kw)
    got = shapley.gtg_walk(
        shapley._SubsetEvaluator(_stub_torch, chunk=16),
        torch.from_numpy(stack), sizes, torch.from_numpy(prev),
        tuple(map(torch.from_numpy, batches)), N,
        np.random.default_rng(7), memo=memo, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
    assert got[1:] == want[1:]
    assert set(memo) == set(jmemo)
    assert memo == jmemo
    assert got[1] > N  # more than one sampling iteration


def _pickles(root):
    out = {}
    for path in glob.glob(str(root / "**" / "metric_*.pkl"), recursive=True):
        with open(path, "rb") as f:
            out[path.rsplit("metric_", 1)[1]] = pickle.load(f)
    return out


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("algo", ["multiround_shapley_value",
                                  "GTG_shapley_value"])
def test_one_round_matches_jax(monkeypatch, tmp_path, algo):
    lines = _Lines()
    get_logger().addHandler(lines)
    try:
        jres, pres = run_both(
            monkeypatch, log_root=tmp_path, distributed_algorithm=algo,
            worker_number=4, round=1, shapley_eval_dtype="float32",
            # Enough training that the subset models differ: GTG walks
            # more than one iteration and evaluates every subset.
            learning_rate=0.1, epoch=2, log_level="INFO",
        )
    finally:
        get_logger().removeHandler(lines)
    n_eval = 32
    want, got = _pickles(tmp_path / "jax"), _pickles(tmp_path / "port")
    assert list(got) == list(want) == ["0.pkl"]
    want, got = want["0.pkl"], got["0.pkl"]
    assert set(got) == set(want)
    for subset, u in want.items():
        assert abs(got[subset] - u) <= 2 / n_eval, subset
    rec, jrec = pres["history"][0], jres["history"][0]
    sv = np.asarray([rec["shapley_values"][i] for i in range(4)])
    if algo == "multiround_shapley_value":
        assert len(got) == 16
        assert abs(sv.sum() - (got[(0, 1, 2, 3)] - got[()])) <= 1e-6
    else:
        for k in ("gtg_permutations", "gtg_subset_evals", "gtg_converged"):
            assert rec[k] == jrec[k], k
        assert rec["gtg_permutations"] > 4 and rec["gtg_subset_evals"] > 4
    # A weighted mean of marginals, each within twice the utilities' bound.
    jsv = np.asarray([jrec["shapley_values"][i] for i in range(4)])
    np.testing.assert_allclose(sv, jsv, atol=4 / n_eval)
    assert any("shapley values" in line for line in lines.lines)
