"""The port's round batching (``rounds_per_dispatch``:
``parallel/engine.make_batched_round_fn`` and the simulator's dispatch
loop) against its own K=1 loop and the JAX package's rules.

* ``fed``, ``fed_quant`` and ``sign_SGD`` at K=3 are bitwise the K=1 runs
  (records, timings aside, and the final model), also with a cosine
  ``lr_schedule``, a server optimizer, ``checkpoint_every`` splitting a
  dispatch, and async federation.
* A resumed batched run stitches into the straight K=1 history.
* Per-dispatch telemetry as in the JAX package: the telemetry sub-object
  on each dispatch's last record, ``dispatch_rounds``, first dispatches
  counted as warmup, 0 post-warmup compiles, client stats on their
  cadence, records valid against the schema; ``scripts/report_run.py``
  reads them per dispatch.
* The refusals (the Shapley algorithms, fed_quant's ``client_eval``,
  ``rounds_per_dispatch`` 0, the threaded oracle) carry JAX's texts.
"""

import dataclasses
import glob
import importlib.util
import json
import os

import jsonschema
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.simulator import (
    lr_factors as jax_lr_factors,
)
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run,
)
from distributed_learning_simulator_tpu_torch.factory import get_algorithm
from distributed_learning_simulator_tpu_torch.simulator import (
    lr_factors,
    run_simulation,
)
from torch_runs import port_config

REPO = os.path.join(os.path.dirname(__file__), "..")


def _run(jcfg, **changes):
    return run_simulation(port_config(jcfg, **changes), setup_logging=False)


def _plain(history):
    return [{k: v for k, v in r.items() if k != "round_seconds"}
            for r in history]


def _same(a, b):
    assert _plain(a["history"]) == _plain(b["history"])
    assert a["global_params"].keys() == b["global_params"].keys()
    for k in a["global_params"]:
        assert torch.equal(a["global_params"][k], b["global_params"][k]), k


@pytest.mark.parametrize("changes", [
    dict(),
    dict(lr_schedule="cosine", lr_min_factor=0.1, momentum=0.9,
         server_optimizer_name="sgd", server_momentum=0.9),
    dict(distributed_algorithm="fed_quant", client_eval=False),
    dict(distributed_algorithm="sign_SGD", learning_rate=0.01, momentum=0.9),
    dict(async_mode="on", arrival_model="bimodal",
         arrival_slow_fraction=0.4, round_deadline=1.5, async_buffer_size=3),
    dict(participation_fraction=0.5, failure_mode="dropout",
         failure_prob=0.3, min_survivors=1, client_stats="on",
         client_valuation="on"),
])
def test_k3_is_bitwise_k1(tiny_config, changes):
    cfg = dataclasses.replace(tiny_config, round=4, **changes)
    _same(_run(cfg), _run(cfg, rounds_per_dispatch=3))


def test_checkpoint_splits_a_dispatch_and_resume_stitches(tiny_config,
                                                          tmp_path):
    """checkpoint_every=3 with K=4: dispatches of 3 then 1 (the horizon),
    the checkpoint on round 2, and the resumed batched run equal to the
    straight K=1 run."""
    cfg = dataclasses.replace(tiny_config, round=6, momentum=0.9,
                              server_optimizer_name="sgd",
                              server_momentum=0.9)
    golden = _run(cfg)
    ckpt = str(tmp_path / "ckpt")
    first = _run(cfg, round=4, rounds_per_dispatch=4, checkpoint_dir=ckpt,
                 checkpoint_every=3)
    assert sorted(os.listdir(ckpt)) == ["round_2.ckpt"]
    resumed = _run(cfg, rounds_per_dispatch=4, checkpoint_dir=ckpt,
                   checkpoint_every=3, resume=True)
    assert [h["round"] for h in resumed["history"]] == [3, 4, 5]
    assert _plain(first["history"][:3] + resumed["history"]) == _plain(
        golden["history"])
    for k in golden["global_params"]:
        assert torch.equal(resumed["global_params"][k],
                           golden["global_params"][k])


def test_batched_telemetry_per_dispatch(tiny_config, tmp_path):
    cfg = port_config(tiny_config, round=4, rounds_per_dispatch=2,
                      telemetry_level="basic", client_stats="on",
                      client_stats_every=2, log_root=str(tmp_path / "log"))
    result = run_simulation(cfg)
    assert result["post_warmup_compiles"] == 0
    (path,) = glob.glob(os.path.join(cfg.log_root, "**", "metrics.jsonl"),
                        recursive=True)
    with open(path) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(os.path.dirname(__file__), "data",
                           "metrics_record.schema.json")) as f:
        schema = json.load(f)
    for r in records:
        jsonschema.validate(r, schema)
    assert [r["round"] for r in records] == [0, 1, 2, 3]
    assert [("telemetry" in r) for r in records] == [False, True, False,
                                                     True]
    assert [("client_stats" in r) for r in records] == [True, False, True,
                                                        False]
    for r in (records[1], records[3]):
        assert r["telemetry"]["dispatch_rounds"] == 2
        assert {"client_step", "host_sync", "post_round"} <= set(
            r["telemetry"]["phase_seconds"])
    assert records[1]["telemetry"]["compiles"] > 0
    assert records[1]["telemetry"]["warmup"] is True
    assert "batched" in records[1]["telemetry"]["compiled"]
    assert records[3]["telemetry"]["compiles"] == 0
    spec = importlib.util.spec_from_file_location(
        "report_run", os.path.join(REPO, "scripts", "report_run.py"))
    report_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report_run)
    summary = report_run.summarize_run(report_run.load_metrics(
        os.path.dirname(path)))
    assert summary["phase_unit"] == "dispatch"
    assert summary["compiles"]["post_warmup"] == 0
    rendered = "\n".join(report_run.render_summary(summary))
    assert "per-dispatch mean" in rendered
    assert "post-warmup recompiles: none" in rendered


def test_lr_factors_vector_matches_jax(tiny_config):
    cfg = dataclasses.replace(tiny_config, round=6, lr_schedule="cosine",
                              lr_min_factor=0.1)
    np.testing.assert_array_equal(lr_factors(port_config(cfg), 2, 3),
                                  jax_lr_factors(cfg, 2, 3))


@pytest.mark.parametrize("changes", [
    dict(distributed_algorithm="GTG_shapley_value"),
    dict(distributed_algorithm="multiround_shapley_value"),
    dict(distributed_algorithm="fed_quant"),  # client_eval auto-on
])
def test_refusals_match_jax(tiny_config, changes):
    cfg = dataclasses.replace(tiny_config, round=1, rounds_per_dispatch=2,
                              **changes)
    with pytest.raises(ValueError) as port_err:
        _run(cfg)
    with pytest.raises(ValueError) as jax_err:
        jax_run(cfg, setup_logging=False)
    assert str(port_err.value) == str(jax_err.value)
    assert "rounds_per_dispatch > 1" in str(port_err.value)
    opted_out = port_config(cfg, distributed_algorithm="fed_quant",
                            client_eval=False)
    assert get_algorithm("fed_quant", opted_out).supports_round_batching


@pytest.mark.parametrize("changes", [
    dict(rounds_per_dispatch=0),
    dict(rounds_per_dispatch=2, execution_mode="threaded"),
])
def test_config_refusals_match_jax(changes):
    with pytest.raises(ValueError) as port_err:
        port_config(JaxConfig(), **changes).validate()
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(**changes).validate()
    assert str(port_err.value) == str(jax_err.value)
