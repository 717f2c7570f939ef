"""Checkpoints and resume of the port (utils/checkpoint.py, simulator.py):
the JAX package's tests/test_checkpoint.py cases that fall inside the
single-file format, on the port, plus two checks across the packages: each
package's ``load_checkpoint`` reads the other's file, and a port
checkpoint's ``global_params`` after one round match the JAX run's leaf by
leaf (rtol 1e-4, the band of tests/test_torch_band.py)."""

import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run_simulation,
)
from distributed_learning_simulator_tpu.utils import checkpoint as jax_ckpt
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
from distributed_learning_simulator_tpu_torch.utils.checkpoint import (
    CheckpointCorruptError,
    gc_checkpoints,
    latest_checkpoint,
    load_checkpoint,
    load_latest_valid_checkpoint,
    save_checkpoint,
)


@pytest.fixture()
def port_config(tiny_config):
    fields = {f.name: getattr(tiny_config, f.name)
              for f in dataclasses.fields(tiny_config)
              if f.name != "cost_model_topology"}  # a TPU row in JAX
    return ExperimentConfig(device="cpu", **fields)


def _run(config, **changes):
    return run_simulation(dataclasses.replace(config, **changes),
                          setup_logging=False)


def _accs(result):
    return [h["test_accuracy"] for h in result["history"]]


def test_save_load_roundtrip(tmp_path):
    params = {"w": torch.arange(4.0)}
    state = {"m": torch.zeros(4)}
    path = save_checkpoint(str(tmp_path / "round_3.ckpt"), 3, params, state,
                           {"shapley_values": {0: {0: 1.0}}},
                           np.array([0, 5], dtype=np.uint32))
    ckpt = load_checkpoint(path)
    assert ckpt["round_idx"] == 3
    assert list(ckpt["global_params"]["w"]) == [0.0, 1.0, 2.0, 3.0]
    assert isinstance(ckpt["client_state"]["m"], np.ndarray)
    assert ckpt["algo_state"]["shapley_values"] == {0: {0: 1.0}}
    assert ckpt["rng_key"].dtype == np.uint32
    assert list(ckpt["rng_key"]) == [0, 5]


def test_latest_checkpoint_ordering(tmp_path):
    for r in (0, 2, 10):
        save_checkpoint(str(tmp_path / f"round_{r}.ckpt"), r,
                        {"w": torch.zeros(1)}, {})
    assert latest_checkpoint(str(tmp_path)).endswith("round_10.ckpt")
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_latest_checkpoint_skips_stray_files_and_resume_sweeps_tmps(tmp_path):
    save_checkpoint(str(tmp_path / "round_3.ckpt"), 3, {"w": torch.zeros(1)},
                    {})
    (tmp_path / "foo.ckpt").write_bytes(b"not a checkpoint")
    (tmp_path / "round_9.ckpt.tmp").write_bytes(b"torn write")
    assert latest_checkpoint(str(tmp_path)).endswith("round_3.ckpt")
    assert (tmp_path / "round_9.ckpt.tmp").exists()  # discovery: no sweep
    found, _ = load_latest_valid_checkpoint(str(tmp_path))
    assert found.endswith("round_3.ckpt")
    assert not (tmp_path / "round_9.ckpt.tmp").exists()  # resume: swept
    assert (tmp_path / "foo.ckpt").exists()  # ignored, never deleted


def test_truncated_checkpoint_detected_and_fallback(tmp_path):
    for r in (0, 1):
        save_checkpoint(str(tmp_path / f"round_{r}.ckpt"), r,
                        {"w": torch.full((8,), float(r))}, {})
    path1 = tmp_path / "round_1.ckpt"
    blob = path1.read_bytes()
    path1.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(str(path1))
    found, payload = load_latest_valid_checkpoint(str(tmp_path))
    assert found.endswith("round_0.ckpt")
    assert payload["round_idx"] == 0
    assert load_latest_valid_checkpoint(str(tmp_path / "none")) == (None, None)


def test_legacy_headerless_checkpoint_loads(tmp_path):
    legacy = {"round_idx": 7, "global_params": {"w": [1.0]},
              "client_state": None, "algo_state": {}, "rng_key": None}
    path = tmp_path / "round_7.ckpt"
    with open(path, "wb") as f:
        pickle.dump(legacy, f)
    assert load_checkpoint(str(path))["round_idx"] == 7
    path.write_bytes(path.read_bytes()[:10])
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(str(path))


def test_gc_checkpoints_keep_last(tmp_path):
    for r in range(5):
        save_checkpoint(str(tmp_path / f"round_{r}.ckpt"), r,
                        {"w": torch.zeros(1)}, {})
    removed = gc_checkpoints(str(tmp_path), keep_last=2)
    assert len(removed) == 3
    left = sorted(f for f in os.listdir(tmp_path) if f.endswith(".ckpt"))
    assert left == ["round_3.ckpt", "round_4.ckpt"]
    assert gc_checkpoints(str(tmp_path), keep_last=None) == []


def test_resume_falls_back_past_truncated_checkpoint(port_config, tmp_path):
    straight = _run(port_config, round=4)
    ckdir = tmp_path / "ck"
    _run(port_config, round=2, checkpoint_dir=str(ckdir), checkpoint_every=1)
    blob = (ckdir / "round_1.ckpt").read_bytes()
    (ckdir / "round_1.ckpt").write_bytes(blob[: len(blob) // 2])
    resumed = _run(port_config, round=4, checkpoint_dir=str(ckdir),
                   resume=True)
    assert [h["round"] for h in resumed["history"]] == [1, 2, 3]
    assert _accs(resumed) == _accs(straight)[1:]


def test_checkpoint_keep_last_retention_end_to_end(port_config, tmp_path):
    ckdir = tmp_path / "ck"
    _run(port_config, round=4, checkpoint_dir=str(ckdir), checkpoint_every=1,
         checkpoint_keep_last=2)
    left = sorted(f for f in os.listdir(ckdir) if f.endswith(".ckpt"))
    assert left == ["round_2.ckpt", "round_3.ckpt"]
    resumed = _run(port_config, round=6, checkpoint_dir=str(ckdir),
                   checkpoint_every=1, checkpoint_keep_last=2, resume=True)
    assert [h["round"] for h in resumed["history"]] == [4, 5]


@pytest.mark.parametrize("changes", [
    dict(),
    dict(server_optimizer_name="sgd", server_learning_rate=1.0,
         server_momentum=0.9),
    dict(server_optimizer_name="adam", server_learning_rate=0.05,
         optimizer_name="adam", learning_rate=0.01,
         reset_client_optimizer=False),
    dict(participation_fraction=0.5, worker_number=6, failure_mode="dropout",
         failure_prob=0.3, min_survivors=1, momentum=0.9,
         reset_client_optimizer=False),
])
def test_resume_matches_straight_run(port_config, tmp_path, changes):
    """4 rounds straight against 2 + checkpoint + resume 2, bitwise: the
    records (cohort hashes and survivors included), the final model, the
    per-client state and the server optimizer's state all survive."""
    cfg = dataclasses.replace(port_config, **changes)
    straight = _run(cfg, round=4)
    ckdir = str(tmp_path / "ck")
    _run(cfg, round=2, checkpoint_dir=ckdir, checkpoint_every=1)
    resumed = _run(cfg, round=4, checkpoint_dir=ckdir, resume=True)

    def strip(h):
        return [{k: v for k, v in r.items() if k != "round_seconds"}
                for r in h]

    assert strip(resumed["history"]) == strip(straight["history"])[2:]
    for name, value in straight["global_params"].items():
        assert torch.equal(resumed["global_params"][name], value), name
    if straight["client_state"] is not None:
        torch.testing.assert_close(resumed["client_state"],
                                   straight["client_state"], rtol=0, atol=0)


def test_server_opt_resume_config_mismatch_raises(port_config, tmp_path):
    ckdir = str(tmp_path / "ck")
    _run(port_config, round=1, checkpoint_dir=ckdir, checkpoint_every=1,
         server_optimizer_name="sgd", server_momentum=0.9)
    with pytest.raises(ValueError, match="server optimizer state"):
        _run(port_config, round=2, checkpoint_dir=ckdir, resume=True,
             server_optimizer_name="adam")
    with pytest.raises(ValueError, match="server_optimizer_name='none' now"):
        _run(port_config, round=2, checkpoint_dir=ckdir, resume=True)


def test_resume_client_state_and_model_mismatch_raise(port_config, tmp_path):
    ckdir = str(tmp_path / "ck")
    sign = dict(distributed_algorithm="sign_SGD", learning_rate=0.01)
    _run(port_config, round=2, checkpoint_dir=ckdir, checkpoint_every=1,
         momentum=0.0, **sign)
    with pytest.raises(ValueError, match="client_state") as err:
        _run(port_config, round=3, checkpoint_dir=ckdir, resume=True,
             momentum=0.9, **sign)
    assert "checkpoint has no per-client state" in str(err.value)
    assert "per-client state with 2 leaves" in str(err.value)
    with pytest.raises(ValueError, match="parameter structure"):
        _run(port_config, round=3, checkpoint_dir=ckdir, resume=True,
             model_name="lenet5", dataset_args={"difficulty": 0.5,
                                                "shape": (28, 28, 1)})


def test_checkpoints_cross_between_packages(tiny_config, port_config,
                                            tmp_path):
    """Each package loads the other's checkpoint without a CRC error, and
    the port's round-0 global model equals the JAX run's leaf by leaf."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jax_run_simulation(dataclasses.replace(
        tiny_config, round=1, checkpoint_dir=str(jdir), checkpoint_every=1),
        setup_logging=False)
    _run(port_config, round=1, checkpoint_dir=str(pdir), checkpoint_every=1)
    jfile, pfile = str(jdir / "round_0.ckpt"), str(pdir / "round_0.ckpt")
    from_port = jax_ckpt.load_checkpoint(pfile)
    from_jax = load_checkpoint(jfile)
    assert from_port["round_idx"] == from_jax["round_idx"] == 0
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(from_port["rng_key"])),
        from_jax["rng_key"])
    want = jax.tree_util.tree_leaves_with_path(from_jax["global_params"])
    got = jax.tree_util.tree_leaves_with_path(from_port["global_params"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32, path
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)
    assert set(from_port["algo_state"]["prev_metrics"]) == {"loss",
                                                            "accuracy"}


def test_cli_faults_and_checkpoints_write_valid_records(tmp_path):
    """The new flags through the port's CLI on the CPU: records carry the
    quorum fields and validate against the checked-in schema; the resumed
    run appends the rounds after the newest checkpoint."""
    import json

    import jsonschema

    from distributed_learning_simulator_tpu_torch.simulator import main

    argv = ["--dataset_name", "synthetic", "--model_name", "mlp",
            "--worker_number", "6", "--epoch", "1", "--learning_rate", "0.1",
            "--batch_size", "32", "--n_train", "384", "--n_test", "128",
            "--optimizer_name", "adamw", "--weight_decay", "0.01",
            "--server_optimizer_name", "sgd", "--server_momentum", "0.9",
            "--failure_mode", "dropout", "--failure_prob", "0.3",
            "--min_survivors", "4", "--checkpoint_dir",
            str(tmp_path / "ck"), "--checkpoint_every", "1",
            "--checkpoint_keep_last", "1", "--device", "cpu",
            "--log_level", "WARNING", "--log_root", str(tmp_path / "log")]
    first = main(argv + ["--round", "2"])
    resumed = main(argv + ["--round", "3", "--resume", "true"])
    assert [h["round"] for h in resumed["history"]] == [2]
    assert os.listdir(tmp_path / "ck") == ["round_2.ckpt"]
    with open(os.path.join(os.path.dirname(__file__), "data",
                           "metrics_record.schema.json")) as f:
        schema = json.load(f)
    records = [json.loads(line)
               for path in (tmp_path / "log").glob("**/metrics.jsonl")
               for line in path.read_text().splitlines()]
    assert len(records) == 3
    for rec in records + first["history"]:
        assert isinstance(rec["survivor_count"], int)
        assert isinstance(rec["round_rejected"], bool)
        jsonschema.validate(rec, schema)
