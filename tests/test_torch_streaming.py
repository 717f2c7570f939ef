"""The port's streamed client residency (``client_residency='streamed'``:
data/residency.py, parallel/streaming.py and the simulator's glue), the
twins of the JAX package's tests/test_streaming.py cases that need no mesh.

* The streamed run is **bitwise** the port's resident run (records apart
  from their ``stream`` sub-object and schema version, and the final model)
  for ``fed`` with sampling, dropout faults, the quorum and a cosine
  schedule, for ``rounds_per_dispatch=3``, for ``sign_SGD`` with momentum
  (the full cohort, one upload), for ``fed_quant`` and with persistent
  client state (gather and writeback), and a resumed streamed run stitches
  into the straight resident one.
* Against the JAX package's streamed run of the same configuration the
  cohort hashes, survivor counts and quorum verdicts are equal and the test
  losses agree at rtol 1e-4, the port's f32 ``fed`` parity tolerance
  (tests/test_torch_keychain.py).
* The host shard store's gather, scatter, range checks and byte accounting,
  and ``synthetic_stream_shards``, equal the JAX package's on the same
  numpy inputs (exact).
* Config validation and refusals carry the JAX texts; a mesh or multihost
  is still refused (NotImplementedError, ROADMAP item 17).
* The v5 stream records validate against the checked-in schema; the
  ``sample`` phase, the sampler fields and ``scripts/report_run.py``'s
  transfer row read them as they read the JAX package's.
"""

import collections
import dataclasses
import glob
import importlib.util
import json
import os

import jsonschema
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.data import residency as jres
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run,
)
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.data.residency import (
    HostShardStore,
    synthetic_stream_shards,
    tree_bytes,
    tree_map_np,
)
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
from torch_runs import port_config

REPO = os.path.join(os.path.dirname(__file__), "..")
SCHEMA = json.load(open(os.path.join(REPO, "tests", "data",
                                     "metrics_record.schema.json")))
BIT_KEYS = ("test_accuracy", "test_loss", "mean_client_loss",
            "cohort_hash", "survivor_count", "round_rejected")


def _run(jcfg, **changes):
    return run_simulation(port_config(jcfg, **changes), setup_logging=False)


def _plain(history):
    """Records without what only a streamed run has."""
    return [{k: v for k, v in r.items()
             if k not in ("round_seconds", "stream", "schema_version")}
            for r in history]


def _same(a, b):
    assert _plain(a["history"]) == _plain(b["history"])
    for k in a["global_params"]:
        assert torch.equal(a["global_params"][k], b["global_params"][k]), k


def _records(root):
    (path,) = glob.glob(os.path.join(str(root), "**", "metrics.jsonl"),
                        recursive=True)
    with open(path) as f:
        return [json.loads(line) for line in f]


# ---- validation ------------------------------------------------------------


def test_config_validation():
    with pytest.raises(ValueError, match="client_residency"):
        ExperimentConfig(client_residency="paged").validate()
    with pytest.raises(ValueError, match="vmap execution mode"):
        ExperimentConfig(client_residency="streamed",
                         execution_mode="threaded").validate()
    # A mesh and multihost are item 17's.
    for kw in (dict(mesh_devices=2), dict(multihost=True)):
        with pytest.raises(NotImplementedError, match="item 17"):
            ExperimentConfig(client_residency="streamed", **kw).validate()
    ExperimentConfig(client_residency="streamed").validate()
    assert ExperimentConfig().client_residency == "resident"


def test_shapley_refuses_streamed(tiny_config):
    with pytest.raises(ValueError, match="client_residency") as err:
        _run(tiny_config, distributed_algorithm="multiround_shapley_value",
             client_residency="streamed")
    with pytest.raises(ValueError) as jerr:
        jax_run(dataclasses.replace(
            tiny_config, distributed_algorithm="multiround_shapley_value",
            client_residency="streamed"), setup_logging=False)
    assert str(err.value) == str(jerr.value)


def test_streamed_batched_persistent_state_refused(tiny_config):
    with pytest.raises(ValueError, match="rounds_per_dispatch"):
        _run(tiny_config, worker_number=8, participation_fraction=0.5,
             reset_client_optimizer=False, client_residency="streamed",
             rounds_per_dispatch=2)


# ---- the host shard store --------------------------------------------------


def _arrays(n=6, shard=4, dim=3):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, shard, dim)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, shard)).astype(np.int32)
    mask = np.ones((n, shard), dtype=np.float32)
    sizes = np.full(n, float(shard), dtype=np.float32)
    state = {"mom": rng.normal(size=(n, dim)).astype(np.float32),
             "count": np.zeros(n, dtype=np.int32)}
    return (x, y, mask, sizes), state


def _stores():
    arrays, state = _arrays()
    copy = {k: v.copy() for k, v in state.items()}
    return (HostShardStore(*arrays, state=state),
            jres.HostShardStore(*arrays, state=copy))


def test_store_gather_scatter_equal_jax():
    store, jstore = _stores()
    idx = np.array([4, 1, 3])
    for got, want in zip(store.gather_data(idx), jstore.gather_data(idx)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(store.gather_data(idx)[0],
                                  store.x[idx])
    assert store.gather_data(None)[0] is store.x  # no copy
    for k in ("mom", "count"):
        np.testing.assert_array_equal(store.gather_state(idx)[k],
                                      jstore.gather_state(idx)[k])
    before = {k: v.copy() for k, v in store.state.items()}
    update = {"mom": np.full((3, 3), 7.0, np.float32),
              "count": np.array([1, 2, 3], np.int32)}
    for s in (store, jstore):
        s.scatter_state(np.array([0, 5, 2]), update)
    for k in ("mom", "count"):
        np.testing.assert_array_equal(store.state[k], jstore.state[k])
    untouched = np.setdiff1d(np.arange(6), [0, 5, 2])
    np.testing.assert_array_equal(store.state["mom"][untouched],
                                  before["mom"][untouched])


def test_store_stateless_and_range_checks():
    arrays, _ = _arrays()
    store = HostShardStore(*arrays)
    assert store.gather_state(None) is None
    store, _ = _stores()
    with pytest.raises(IndexError, match="out of range"):
        store.gather_data(np.array([0, 6]))
    with pytest.raises(IndexError, match="out of range"):
        store.scatter_state(np.array([-1]), store.gather_state(np.array([0])))
    x = np.zeros((4, 2, 3), np.float32)
    with pytest.raises(ValueError, match="length mismatch"):
        HostShardStore(x, np.zeros((3, 2), np.int32),
                       np.ones((4, 2), np.float32), np.ones(4, np.float32))
    with pytest.raises(ValueError, match="client-axis length"):
        HostShardStore(x, np.zeros((4, 2), np.int32),
                       np.ones((4, 2), np.float32), np.ones(4, np.float32),
                       state={"mom": np.zeros((5, 3), np.float32)})


def test_tree_map_np_and_bytes_accounting():
    Opt = collections.namedtuple("Opt", ["mu", "nu"])
    tree = {"o": Opt(np.ones(2), np.zeros(2)), "none": None,
            "l": [np.full(2, 3.0)]}
    doubled = tree_map_np(lambda a: a * 2, tree)
    assert isinstance(doubled["o"], Opt)
    np.testing.assert_array_equal(doubled["o"].mu, np.full(2, 2.0))
    assert doubled["none"] is None
    assert tree_bytes(tree) == jres.tree_bytes(tree) == 3 * 2 * 8
    store, jstore = _stores()
    assert store.data_bytes() == jstore.data_bytes() == (
        store.x.nbytes + store.y.nbytes + store.mask.nbytes
        + store.sizes.nbytes)
    assert store.cohort_data_bytes(2) * 3 == store.data_bytes()
    assert store.cohort_state_bytes(3) == jstore.cohort_state_bytes(3)


def test_synthetic_stream_shards_equal_jax():
    rng = np.random.default_rng(0)
    x_train = rng.uniform(size=(32, 2, 2, 1)).astype(np.float32)
    y_train = rng.integers(0, 10, size=32)
    cd = synthetic_stream_shards(x_train, y_train, 50, 8, seed=1)
    assert cd.x.shape == (50, 8, 4) and cd.x.dtype == np.uint8
    assert cd.y.shape == (50, 8) and cd.y.dtype == np.int32
    assert cd.mask.shape == (50, 8) and float(cd.mask.min()) == 1.0
    assert cd.sample_shape == (2, 2, 1)
    want = jres.synthetic_stream_shards(x_train, y_train, 50, 8, seed=1)
    for f in ("x", "y", "mask", "sizes"):
        np.testing.assert_array_equal(getattr(cd, f), getattr(want, f))
    # Out-of-[0, 1] pools stay float32 with their sample shape.
    gauss = rng.normal(size=(32, 2, 2, 1)).astype(np.float32)
    cd3 = synthetic_stream_shards(gauss, y_train, 10, 4, seed=1)
    assert cd3.x.dtype == np.float32 and cd3.x.shape == (10, 4, 2, 2, 1)


# ---- bitwise streamed == resident ------------------------------------------


@pytest.mark.parametrize("changes", [
    dict(participation_fraction=0.5, failure_mode="dropout",
         failure_prob=0.3, min_survivors=1, lr_schedule="cosine"),
    dict(distributed_algorithm="sign_SGD", learning_rate=0.01,
         momentum=0.9),
    dict(distributed_algorithm="fed_quant", participation_fraction=0.5),
    dict(round=4, participation_fraction=0.5, reset_client_optimizer=False,
         momentum=0.9),
])
def test_streamed_bitwise_resident(tiny_config, changes):
    cfg = dataclasses.replace(tiny_config, worker_number=8, round=3)
    cfg = dataclasses.replace(cfg, **changes)
    resident = _run(cfg)
    streamed = _run(cfg, client_residency="streamed")
    _same(resident, streamed)
    if cfg.participation_fraction < 1:
        assert None not in [h.get("cohort_hash")
                            for h in streamed["history"]]
    if not cfg.reset_client_optimizer:
        assert streamed["stream_d2h_bytes"] > 0  # the writeback ran
        # The population's state is the store's.
        assert isinstance(streamed["client_state"], np.ndarray)


def test_streamed_k3_bitwise_resident_k1(tiny_config):
    """rounds_per_dispatch=3 over 4 rounds (a remainder dispatch too): the
    stacked uploads of host-drawn cohorts give the resident K=1 run."""
    cfg = dataclasses.replace(
        tiny_config, worker_number=8, round=4, participation_fraction=0.5,
        server_optimizer_name="sgd", server_learning_rate=1.0,
        server_momentum=0.9)
    _same(_run(cfg), _run(cfg, client_residency="streamed",
                          rounds_per_dispatch=3))


def test_streamed_matches_jax_streamed(tiny_config):
    cfg = dataclasses.replace(
        tiny_config, worker_number=8, round=3, participation_fraction=0.5,
        failure_mode="dropout", failure_prob=0.3, min_survivors=1,
        lr_schedule="cosine", client_residency="streamed")
    port = _run(cfg)
    jax_res = jax_run(cfg, setup_logging=False)
    for key in ("cohort_hash", "survivor_count", "round_rejected"):
        assert ([h[key] for h in port["history"]]
                == [h[key] for h in jax_res["history"]]), key
    np.testing.assert_allclose(
        [h["test_loss"] for h in port["history"]],
        [h["test_loss"] for h in jax_res["history"]], rtol=1e-4)


def test_streamed_checkpoint_resume_mid_run(tiny_config, tmp_path):
    """Resume mid-run with persistent client state: the host store is what
    the checkpoint holds, and the stitched streamed history is the straight
    resident one."""
    cfg = dataclasses.replace(
        tiny_config, worker_number=8, round=5, participation_fraction=0.5,
        reset_client_optimizer=False, momentum=0.9)
    golden = [h["test_accuracy"] for h in _run(cfg)["history"]]
    ckpt = str(tmp_path / "ckpt")
    first = _run(cfg, round=3, client_residency="streamed",
                 checkpoint_dir=ckpt, checkpoint_every=2)
    resumed = _run(cfg, client_residency="streamed", checkpoint_dir=ckpt,
                   checkpoint_every=2, resume=True)
    assert [h["round"] for h in resumed["history"]] == [2, 3, 4]
    stitched = [h["test_accuracy"] for h in first["history"][:2]] + [
        h["test_accuracy"] for h in resumed["history"]]
    assert stitched == golden


# ---- records ---------------------------------------------------------------


def test_stream_records_and_result_fields(tiny_config, tmp_path):
    cfg = dataclasses.replace(
        tiny_config, worker_number=8, round=3, participation_fraction=0.5,
        reset_client_optimizer=False, momentum=0.9)
    res = run_simulation(port_config(
        cfg, client_residency="streamed", log_root=str(tmp_path / "s")))
    assert res["client_residency"] == "streamed"
    assert 0.0 <= res["stream_overlap_ratio"] <= 1.0
    assert res["stream_h2d_bytes"] > 0
    assert res["stream_d2h_bytes"] > 0
    records = _records(tmp_path / "s")
    assert len(records) == 3
    for rec in records:
        assert rec["schema_version"] == 5
        jsonschema.validate(rec, SCHEMA)
        assert rec["stream"]["h2d_bytes"] > 0
        assert rec["stream"]["d2h_bytes"] > 0
    resident = run_simulation(port_config(cfg, log_root=str(tmp_path / "r")))
    for key in ("stream_overlap_ratio", "stream_h2d_bytes",
                "stream_d2h_bytes", "stream_sample_seconds"):
        assert resident[key] is None
    for rec in _records(tmp_path / "r"):
        assert "stream" not in rec and "schema_version" not in rec


@pytest.mark.parametrize("sampler", ["exact", "hashed"])
def test_sample_phase_and_stream_sampler_fields(tiny_config, tmp_path,
                                                sampler):
    res = run_simulation(port_config(
        tiny_config, worker_number=8, round=3, participation_fraction=0.5,
        client_residency="streamed", participation_sampler=sampler,
        telemetry_level="basic", log_root=str(tmp_path / "s")))
    assert res["participation_sampler"] == sampler
    assert res["stream_sample_seconds"] > 0
    records = _records(tmp_path / "s")
    for rec in records:
        jsonschema.validate(rec, SCHEMA)
        assert rec["stream"]["sampler"] == sampler
        assert rec["stream"]["sample_ms"] >= 0
    # Every round with a prefetched next cohort has its `sample` phase.
    phases = [rec["telemetry"]["phase_seconds"] for rec in records]
    assert all("sample" in p for p in phases[:-1])
    assert all(v >= 0 for p in phases for v in p.values())
    # A full cohort draws nothing.
    full = run_simulation(port_config(
        tiny_config, worker_number=8, round=2, client_residency="streamed",
        participation_sampler=sampler, telemetry_level="basic",
        log_root=str(tmp_path / "f")))
    assert full["stream_sample_seconds"] == 0.0
    for rec in _records(tmp_path / "f"):
        assert "sampler" not in rec.get("stream", {})


def test_report_run_renders_transfer_row(tiny_config, tmp_path):
    run_simulation(port_config(
        tiny_config, worker_number=8, round=3, participation_fraction=0.5,
        reset_client_optimizer=False, momentum=0.9, telemetry_level="basic",
        log_root=str(tmp_path / "art"), client_residency="streamed"))
    records = _records(tmp_path / "art")
    spec = importlib.util.spec_from_file_location(
        "report_run", os.path.join(REPO, "scripts", "report_run.py"))
    report_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report_run)
    summary = report_run.summarize_run(records)
    s = summary["stream"]
    assert s["uploads"] == 3 and s["h2d_bytes"] > 0 and s["d2h_bytes"] > 0
    assert 0.0 <= s["overlap_ratio"] <= 1.0
    text = "\n".join(report_run.render_summary(summary))
    assert "h2d_stream" in text and "streamed transfers: 3 upload(s)" in text


def test_streamed_batched_stream_record_on_last_round(tiny_config,
                                                      tmp_path):
    run_simulation(port_config(
        tiny_config, worker_number=8, round=4, participation_fraction=0.5,
        rounds_per_dispatch=2, client_residency="streamed",
        log_root=str(tmp_path / "b")))
    records = _records(tmp_path / "b")
    assert [("stream" in r) for r in records] == [False, True, False, True]
    assert records[1]["stream"]["dispatch_rounds"] == 2
    for rec in records:
        jsonschema.validate(rec, SCHEMA)
