"""The port's client valuation (telemetry/valuation.py, the streaming scores
in algorithms/fedavg.py and the GTG audit) against the JAX package's.

* ``ValuationState``'s fold, top, bottom and summary, ``cohort_crc``,
  ``valuation_record`` and both correlations are exactly equal to JAX's on
  the same inputs; the streaming scores equal ``ClientValuation.scores``
  at rtol 1e-6 (a sum over the cohort in another order).
* One ``tiny_config``-sized run (MLP, 6 clients, 4 rounds, client stats and
  valuation on, an audit every 2 rounds) through both packages: the
  per-round ``valuation`` records at rtol 1e-4, the audit's replayed
  uploads at rtol 1e-4 of JAX's replay, and the audit's per-client Shapley
  values within 2/n_test of JAX's (the subset utilities are accuracies in
  steps of 1/n_test; the Shapley tests use the same bound). The
  reference's own Spearman floor (ROADMAP.md queue 3) is not asserted.
* ``client_valuation='off'`` keeps the pre-feature records; on, the
  training history is unchanged and the records are v7 and valid.
* Resume restores the vector bitwise; the refusal texts are JAX's; an
  audit whose replayed stack cannot fit the device budget is refused.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import jsonschema
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.algorithms import (
    shapley as jshapley,
)
from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run,
)
from distributed_learning_simulator_tpu.telemetry import (
    valuation as jval,
)
from distributed_learning_simulator_tpu_torch.algorithms import shapley
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.models.bridge import (
    params_from_jax,
)
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
from distributed_learning_simulator_tpu_torch.telemetry import valuation

SCHEMA = os.path.join(os.path.dirname(__file__), "data",
                      "metrics_record.schema.json")
TINY = dict(dataset_name="synthetic", model_name="mlp",
            distributed_algorithm="fed", worker_number=6, round=4, epoch=1,
            learning_rate=0.1, batch_size=32, n_train=512, n_test=256,
            log_level="WARNING", dataset_args={"difficulty": 0.5})
VAL = dict(client_stats="on", client_valuation="on",
           valuation_audit_every=2, valuation_audit_permutations=4)


def _port(**kw):
    return ExperimentConfig(device="cpu", **dict(TINY, **kw))


@pytest.fixture(scope="module")
def runs():
    """The audited configuration through both packages, with each side's
    replayed stack, Shapley values and the port's layout captured."""
    got = {"jax": {}, "port": {}}
    jrun, jwalk = jval.ValuationAuditor.run, jshapley.gtg_walk
    preplay, pwalk = valuation.ValuationAuditor.replay, shapley.gtg_walk

    def jax_audit(self, *args, **kw):
        stack_fn = self._stack_jit

        def keep(*a, **k):
            got["jax"]["stack"] = jax.device_get(stack_fn(*a, **k))
            return stack_fn(*a, **k)

        self._stack_jit = keep
        try:
            return jrun(self, *args, **kw)
        finally:
            self._stack_jit = stack_fn

    def port_replay(self, *args, **kw):
        got["port"]["stack"] = preplay(self, *args, **kw)
        got["port"]["layout"] = self._layout
        return got["port"]["stack"]

    def walk(side, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            got[side]["sv"] = np.asarray(out[0])
            return out
        return wrapped

    jval.ValuationAuditor.run = jax_audit
    jshapley.gtg_walk = walk("jax", jwalk)
    valuation.ValuationAuditor.replay = port_replay
    shapley.gtg_walk = walk("port", pwalk)
    try:
        got["jax"]["res"] = jax_run(JaxConfig(**dict(TINY, **VAL)),
                                    setup_logging=False)
        got["port"]["res"] = run_simulation(_port(**VAL),
                                            setup_logging=False)
    finally:
        jval.ValuationAuditor.run = jrun
        jshapley.gtg_walk = jwalk
        valuation.ValuationAuditor.replay = preplay
        shapley.gtg_walk = pwalk
    return got


# ---- host-side arithmetic ------------------------------------------------


def _inputs(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=12)
    b = a + rng.normal(scale=0.5, size=12)
    a[[2, 5]] = 0.0  # ties
    b[7] = np.nan
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_correlations_and_record_equal_jax(seed):
    a, b = _inputs(seed)
    assert valuation.spearman_corr(a, b) == jval.spearman_corr(a, b)
    assert valuation.pearson_corr(a, b) == jval.pearson_corr(a, b)
    assert valuation.pearson_corr(a[:1], b[:1]) is None
    ids = np.asarray([4, 0, 9])
    assert valuation.cohort_crc(ids, 12) == jval.cohort_crc(ids, 12)
    assert valuation.cohort_crc(None, 12) == jval.cohort_crc(None, 12)
    states = (valuation.ValuationState(12), jval.ValuationState(12))
    rng = np.random.default_rng(seed)
    for r in range(4):
        sampled = r % 2 == 1
        idx = rng.choice(12, 5, replace=False) if sampled else None
        scores = rng.normal(size=5 if sampled else 12)
        scores[0] = np.nan
        delta = float(rng.normal())
        for st in states:
            st.fold(idx, scores, delta, 0.9)
        recs = [valuation.valuation_record(states[0], idx, delta),
                jval.valuation_record(states[1], idx, delta)]
        assert recs[0] == recs[1]
    np.testing.assert_array_equal(states[0].values, states[1].values)
    assert states[0].top() == states[1].top()
    assert states[0].bottom(3) == states[1].bottom(3)
    assert states[0].summary({"round": 2}) == states[1].summary({"round": 2})
    # Under streamed residency the vector lives in the host shard store
    # and folds there, as in the JAX package.
    from distributed_learning_simulator_tpu.data.residency import (
        HostShardStore as JaxStore,
    )
    from distributed_learning_simulator_tpu_torch.data.residency import (
        HostShardStore,
    )

    arrays = (np.zeros((12, 2, 3), np.float32), np.zeros((12, 2), np.int32),
              np.ones((12, 2), np.float32), np.full(12, 2.0, np.float32))
    stores = (HostShardStore(*arrays), JaxStore(*arrays))
    homed = (valuation.ValuationState(12, store=stores[0]),
             jval.ValuationState(12, store=stores[1]))
    for st, store in zip(homed, stores):
        st.load(states[0].values.copy())
        st.fold(np.asarray([3, 1]), np.asarray([0.5, -1.0]), 0.25, 0.9)
        assert st.values is store.valuation
    np.testing.assert_array_equal(homed[0].values, homed[1].values)


def test_scores_match_jax():
    rng = np.random.default_rng(3)
    stats = rng.normal(size=(7, 6)).astype(np.float32)
    stats[2, 2] = np.nan  # a corrupt upload's norm scores 0
    cv = valuation.ClientValuation()
    got = cv.scores(torch.from_numpy(stats)).numpy()
    want = np.asarray(jval.ClientValuation().scores(jnp.asarray(stats)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[2] == 0.0
    for r, audits in ((0, False), (2, True), (3, False), (4, True)):
        cv2 = valuation.ClientValuation(audit_every=2)
        assert cv2.audit_round(r) == jval.ClientValuation(
            audit_every=2).audit_round(r) == audits


def test_grade_client_labels_equal_jax():
    y = np.random.default_rng(0).integers(0, 10, size=(5, 16))
    np.testing.assert_array_equal(valuation.grade_client_labels(y, 10, 3),
                                  jval.grade_client_labels(y, 10, 3))


# ---- runs ------------------------------------------------------------------


def test_valuation_records_match_jax(runs):
    jhist = runs["jax"]["res"]["history"]
    phist = runs["port"]["res"]["history"]
    with open(SCHEMA) as f:
        schema = json.load(f)
    for j, p in zip(jhist, phist, strict=True):
        jsonschema.validate(p, schema)
        assert p["schema_version"] == j["schema_version"] == 7
        jv, pv = j["valuation"], p["valuation"]
        assert pv["n_clients"] == jv["n_clients"]
        assert pv["updated"] == jv["updated"]
        np.testing.assert_allclose(pv["loss_delta"], jv["loss_delta"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(pv["per_client"]["value"],
                                   jv["per_client"]["value"],
                                   rtol=1e-4, atol=1e-7)
        assert ("audit" in pv) == ("audit" in jv) == (p["round"] == 2)
    np.testing.assert_allclose(
        runs["port"]["res"]["valuation_state"].values,
        runs["jax"]["res"]["valuation_state"].values, rtol=1e-4, atol=1e-7)


def test_audit_replay_matches_jax_replay(runs):
    """The replayed cohort uploads, flat in the port's layout."""
    layout = runs["port"]["layout"]
    jstack = runs["jax"]["stack"]
    n = runs["port"]["stack"].shape[0]
    want = torch.stack([
        layout.flatten(params_from_jax(jax.tree_util.tree_map(
            lambda a, i=i: np.asarray(a[i]), jstack)))
        for i in range(n)
    ])
    np.testing.assert_allclose(runs["port"]["stack"].numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-6)


def test_audit_shapley_values_match_jax(runs):
    n_test = TINY["n_test"]
    np.testing.assert_allclose(runs["port"]["sv"], runs["jax"]["sv"],
                               rtol=0, atol=2.0 / n_test)
    paudit = runs["port"]["res"]["history"][2]["valuation"]["audit"]
    jaudit = runs["jax"]["res"]["history"][2]["valuation"]["audit"]
    for key in ("audits", "permutations", "converged", "memo_hit_rate"):
        assert paudit[key] == jaudit[key], key


def test_valuation_on_keeps_the_training_and_off_keeps_the_records(runs):
    plain = run_simulation(_port(client_stats="on"), setup_logging=False)
    default = run_simulation(_port(), setup_logging=False)
    on = runs["port"]["res"]
    for p, o in zip(plain["history"], on["history"], strict=True):
        assert p["schema_version"] == 3 and "valuation" not in p
        strip = {k: v for k, v in o.items()
                 if k not in ("valuation", "schema_version", "round_seconds")}
        assert strip == {k: v for k, v in p.items()
                         if k not in ("schema_version", "round_seconds")}
    assert all("schema_version" not in r for r in default["history"])
    for k in on["global_params"]:
        assert torch.equal(on["global_params"][k], plain["global_params"][k])
    assert default["valuation"] is None and default["valuation_state"] is None


def test_resume_restores_the_vector(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    cfg = _port(client_stats="on", client_valuation="on",
                checkpoint_dir=ckpt, checkpoint_every=2)
    full = run_simulation(cfg, setup_logging=False)
    os.remove(os.path.join(ckpt, "round_3.ckpt"))
    resumed = run_simulation(dataclasses.replace(cfg, resume=True),
                             setup_logging=False)
    np.testing.assert_array_equal(full["valuation_state"].values,
                                  resumed["valuation_state"].values)
    assert full["history"][2:] == [
        dict(r, round_seconds=f["round_seconds"])
        for r, f in zip(resumed["history"], full["history"][2:])]


@pytest.mark.parametrize("changes", [
    dict(client_valuation="on"),
    dict(client_valuation="on", client_stats="on",
         distributed_algorithm="sign_SGD"),
    dict(client_valuation="on", client_stats="on",
         execution_mode="threaded"),
    dict(valuation_audit_every=2),
    dict(VAL, failure_mode="dropout", failure_prob=0.5),
    dict(VAL, distributed_algorithm="fed_quant"),
    dict(VAL, rounds_per_dispatch=2),
    dict(VAL, reset_client_optimizer=False),
    dict(VAL, aggregation="median"),
    dict(VAL, async_mode="on", arrival_model="bimodal"),
    dict(valuation_decay=1.0),
    dict(valuation_audit_permutations=0),
])
def test_refusals_match_jax(changes):
    with pytest.raises(ValueError) as port:
        _port(**changes).validate()
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(**dict(TINY, **changes)).validate()
    assert str(port.value) == str(jax_err.value)


def test_audit_refuses_a_stack_beyond_the_budget():
    from distributed_learning_simulator_tpu_torch.algorithms.fedavg import (
        FedAvg,
    )
    from distributed_learning_simulator_tpu_torch.models.registry import (
        ParamLayout,
    )

    layout = ParamLayout.from_params({"w": torch.zeros(1000, 1000)}, ["w"])
    cfg = _port(**VAL)
    with pytest.raises(ValueError, match=r"\[6, 1000000\] stack"):
        valuation.ValuationAuditor(
            cfg, valuation.ClientValuation.from_config(cfg), FedAvg(cfg),
            None, None, layout, None, None, (None, None, None), None, 6,
            "cpu", budget_bytes=1e6)
