"""The failure model and the quorum policy of the port against the JAX
package's (robustness/faults.py, algorithms/fedavg.py, algorithms/
sign_sgd.py).

* ``draw_failed``: the masks bitwise equal to JAX's across seeds,
  failure seeds and correlations 0, 0.5 and 1; ``corrupt_stack`` and
  ``freeze_failed_state`` equal in f32 and bf16.
* Round histories of the JAX tests' ``tiny_config`` (6 clients, 4 rounds)
  under each failure mode, run by both packages with nothing injected:
  ``survivor_count``, ``round_rejected`` and ``cohort_hash`` exact in
  every round, the rest in the band of tests/test_torch_band.py (accuracy
  within 1/256, test loss rtol 1e-4; fed_quant's test loss at rtol 5e-3,
  its band in tests/test_torch_keychain.py).
* The port alone: the mean and materializing paths agree, a rejected round
  keeps the previous global model exactly (FedAvgM, fed_quant's downlink),
  an inactive failure model changes nothing, sign_SGD refuses the corrupt
  modes and Shapley refuses any failure model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.robustness.faults import (
    FailureModel as JaxFailureModel,
)
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run_simulation,
)
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.robustness.faults import (
    FailureModel,
)
from distributed_learning_simulator_tpu_torch.simulator import run_simulation


def _port_config(jcfg, **changes):
    # cost_model_topology's JAX default is a TPU row the port lacks.
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name != "cost_model_topology"}
    return ExperimentConfig(device="cpu", **{**fields, **changes})


@pytest.mark.parametrize("correlation", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("seed,failure_seed", [(0, 0), (1, 3), (7, 11)])
def test_draw_failed_matches_jax(seed, failure_seed, correlation):
    jfm = JaxFailureModel("dropout", 0.3, correlation, failure_seed)
    pfm = FailureModel("dropout", 0.3, correlation, failure_seed)
    jkey = jax.random.key(seed)
    pkey = prng.key(seed)
    for _ in range(8):
        jkey, jround = jax.random.split(jkey)
        pkey, pround = prng.split(pkey)
        want = np.asarray(jfm.draw_failed(jround, 37))
        got = pfm.draw_failed(pround, 37)
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["corrupt_nan", "corrupt_scale", "dropout"])
def test_corrupt_and_freeze_match_jax(mode, dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(5)
    failed = np.array([True, False, True, False, False])
    stack = rng.normal(size=(5, 33)).astype(np.float32)
    jfm = JaxFailureModel(mode, 0.5)
    pfm = FailureModel(mode, 0.5)
    want = np.asarray(jfm.corrupt_stack(
        jnp.asarray(stack).astype(jdt), jnp.asarray(failed)
    ).astype(jnp.float32))
    got = pfm.corrupt_stack(torch.from_numpy(stack).to(tdt), failed)
    np.testing.assert_array_equal(got.float().numpy(), want)
    old = {"mu": rng.normal(size=(5, 4)).astype(np.float32),
           "count": np.arange(5, dtype=np.int32)}
    new = {"mu": rng.normal(size=(5, 4)).astype(np.float32),
           "count": np.arange(5, dtype=np.int32) + 1}
    jfrozen = jfm.freeze_failed_state(
        jnp.asarray(failed), jax.tree_util.tree_map(jnp.asarray, old),
        jax.tree_util.tree_map(jnp.asarray, new))
    pfrozen = pfm.freeze_failed_state(
        failed, {k: torch.from_numpy(v) for k, v in old.items()},
        {k: torch.from_numpy(v) for k, v in new.items()})
    for k in old:
        np.testing.assert_array_equal(pfrozen[k].numpy(),
                                      np.asarray(jfrozen[k]))
    assert pfm.freeze_failed_state(failed, None, None) is None


_FAULT_CASES = {
    "dropout": dict(failure_mode="dropout", failure_prob=0.3,
                    failure_correlation=0.5, min_survivors=4),
    "straggler": dict(failure_mode="straggler", failure_prob=0.3,
                      momentum=0.9, reset_client_optimizer=False),
    "corrupt_nan_median": dict(failure_mode="corrupt_nan", failure_prob=0.3,
                               aggregation="median"),
    "corrupt_nan_mean": dict(failure_mode="corrupt_nan", failure_prob=0.25),
    "corrupt_scale_trimmed": dict(failure_mode="corrupt_scale",
                                  failure_prob=0.3,
                                  aggregation="trimmed_mean",
                                  trim_ratio=0.34),
    "dropout_persistent_adam": dict(failure_mode="dropout",
                                    failure_prob=0.4, optimizer_name="adam",
                                    learning_rate=0.01,
                                    reset_client_optimizer=False),
    "dropout_hashed_cohort": dict(failure_mode="dropout", failure_prob=0.3,
                                  participation_fraction=0.5,
                                  participation_sampler="hashed",
                                  min_survivors=2),
    "fed_quant_straggler": dict(distributed_algorithm="fed_quant",
                                quant_levels=16, failure_mode="straggler",
                                failure_prob=0.3, min_survivors=5),
}


@pytest.mark.parametrize("case", sorted(_FAULT_CASES))
def test_fault_histories_match_jax(tiny_config, case):
    jcfg = dataclasses.replace(tiny_config, worker_number=6, round=4,
                               **_FAULT_CASES[case])
    jhist = jax_run_simulation(jcfg, setup_logging=False)["history"]
    pres = run_simulation(_port_config(jcfg), setup_logging=False)
    phist = pres["history"]
    assert len(phist) == len(jhist) == 4
    for p, j in zip(phist, jhist):
        assert p["survivor_count"] == j["survivor_count"]
        assert p["round_rejected"] == j["round_rejected"]
        assert p.get("cohort_hash") == j.get("cohort_hash")
        if case.startswith("fed_quant"):
            # fed_quant's band (tests/test_torch_keychain.py): a last-bit
            # difference can move a value across a quantization level.
            np.testing.assert_allclose(p["test_loss"], j["test_loss"],
                                       rtol=5e-3)
            continue
        assert abs(p["test_accuracy"] - j["test_accuracy"]) <= 1 / 256
        np.testing.assert_allclose(p["test_loss"], j["test_loss"],
                                   rtol=1e-4)
        if not np.isnan(j["mean_client_loss"]):
            np.testing.assert_allclose(p["mean_client_loss"],
                                       j["mean_client_loss"], rtol=1e-4)
    assert pres["rounds_rejected"] == sum(r["round_rejected"] for r in jhist)
    assert pres["mean_survivor_count"] == np.mean(
        [r["survivor_count"] for r in jhist])


def test_sign_sgd_dropout_matches_jax_and_refuses_corrupt_modes(tiny_config):
    jcfg = dataclasses.replace(
        tiny_config, distributed_algorithm="sign_SGD", learning_rate=0.01,
        momentum=0.9, worker_number=6, round=3, failure_mode="dropout",
        failure_prob=0.3, min_survivors=5)
    jhist = jax_run_simulation(jcfg, setup_logging=False)["history"]
    phist = run_simulation(_port_config(jcfg), setup_logging=False)["history"]
    for p, j in zip(phist, jhist):
        assert p["survivor_count"] == j["survivor_count"]
        assert p["round_rejected"] == j["round_rejected"]
        assert abs(p["test_accuracy"] - j["test_accuracy"]) <= 1 / 256
        np.testing.assert_allclose(p["test_loss"], j["test_loss"], rtol=1e-4)
    for mode in ("corrupt_nan", "corrupt_scale"):
        with pytest.raises(ValueError, match="dropout/straggler only"):
            run_simulation(_port_config(jcfg, failure_mode=mode),
                           setup_logging=False)


def test_shapley_refuses_a_failure_model(tiny_config):
    with pytest.raises(ValueError, match="refuses failure injection"):
        run_simulation(_port_config(
            tiny_config, distributed_algorithm="multiround_shapley_value",
            failure_mode="straggler", failure_prob=0.2), setup_logging=False)


def test_mean_and_materializing_paths_agree_under_dropout(tiny_config):
    """client_eval=True takes the materializing path; the weights, the
    survivors and the frozen state are the mean path's, and the aggregates
    differ only in summation order."""
    cfg = _port_config(tiny_config, worker_number=6, round=3,
                       failure_mode="dropout", failure_prob=0.4,
                       min_survivors=3, momentum=0.9,
                       reset_client_optimizer=False, client_chunk_size=4)
    mean = run_simulation(cfg, setup_logging=False)
    mat = run_simulation(dataclasses.replace(cfg, client_eval=True),
                         setup_logging=False)
    for a, b in zip(mean["history"], mat["history"]):
        assert (a["survivor_count"], a["round_rejected"]) == (
            b["survivor_count"], b["round_rejected"])
        np.testing.assert_allclose(a["test_loss"], b["test_loss"], rtol=1e-5)
    torch.testing.assert_close(mean["client_state"], mat["client_state"],
                               rtol=1e-5, atol=1e-6)


def _losses(result):
    return [r["test_loss"] for r in result["history"]]


@pytest.mark.parametrize("changes", [
    dict(server_optimizer_name="sgd", server_momentum=0.9),
    dict(distributed_algorithm="fed_quant", quant_levels=16),
])
def test_rejected_round_keeps_the_previous_model(tiny_config, changes):
    """corrupt_nan under the plain mean: every round with a corrupt client
    is rejected. A rejected round's test loss is the previous round's,
    bitwise: the global model (and under FedAvgM the server momentum, else
    the next accepted round would move) stayed as it was."""
    cfg = _port_config(tiny_config, worker_number=6, round=6,
                       failure_mode="corrupt_nan", failure_prob=0.15,
                       **changes)
    hist = run_simulation(cfg, setup_logging=False)["history"]
    rejected = [r["round_rejected"] for r in hist]
    assert any(rejected[1:]) and not all(rejected), rejected
    for prev, cur in zip(hist, hist[1:]):
        if cur["round_rejected"]:
            assert cur["test_loss"] == prev["test_loss"]
            assert cur["test_accuracy"] == prev["test_accuracy"]


def test_inactive_failure_model_changes_nothing(tiny_config):
    """failure_prob=0 builds no failure model: the 4-way key split and
    today's history exactly, with no quorum fields in the records."""
    cfg = _port_config(tiny_config, participation_fraction=0.5,
                       worker_number=6)
    plain = run_simulation(cfg, setup_logging=False)
    inactive = run_simulation(dataclasses.replace(
        cfg, failure_mode="dropout", failure_prob=0.0), setup_logging=False)
    assert plain["history"] and [
        {k: v for k, v in r.items() if k != "round_seconds"}
        for r in plain["history"]
    ] == [
        {k: v for k, v in r.items() if k != "round_seconds"}
        for r in inactive["history"]
    ]
    assert "survivor_count" not in plain["history"][0]
    assert plain["rounds_rejected"] == 0
    assert plain["mean_survivor_count"] is None


@pytest.mark.parametrize("changes", [
    dict(failure_mode="bogus"),
    dict(min_survivors=9),
    dict(failure_mode="dropout", failure_prob=0.2,
         execution_mode="threaded"),
    dict(server_optimizer_name="adam", server_momentum=0.5),
])
def test_config_refusals_match_jax(tiny_config, changes):
    """The JAX package's ValueErrors for the new fields, word for word."""
    with pytest.raises(ValueError) as want:
        dataclasses.replace(tiny_config, **changes).validate()
    with pytest.raises(ValueError) as got:
        _port_config(tiny_config, **changes).validate()
    assert str(got.value) == str(want.value)
