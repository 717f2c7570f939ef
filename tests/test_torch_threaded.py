"""The port's native runtime binding (runtime/native.py) and threaded
oracle (execution/threaded.py) against the JAX package's on the CPU.

* Queue and pool semantics of the native C++ runtime (the JAX package's
  cases): round trip, broadcast, blocking get, stop unblocks, the
  worker_fun barrier, error propagation; the library is built into the
  port's build directory, never into ``native/``.
* ``fed``, ``sign_SGD``, multiround and GTG histories of a ``tiny_config``
  run against the JAX oracle's in the band of tests/test_torch_band.py
  (accuracy within 1/256, test loss rtol 1e-4): both key their workers
  ``key(seed * 100003 + w)`` and aggregate in worker-id order. fed_quant's
  quantized exchange hashes the uploads' bits, and its QAT training
  agrees at rtol 1e-4 (tests/test_torch_fed_quant.py), so it is held to
  the fed_quant tolerance of tests/test_torch_keychain.py (test loss rtol
  5e-3, accuracy within 2/256).
* The threaded client-stats records and telemetry against JAX's; every
  refusal against JAX's text; two port runs bitwise equal; a worker or
  server failure raises instead of hanging.
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.execution import threaded as jthr
from distributed_learning_simulator_tpu_torch.execution import threaded as thr
from distributed_learning_simulator_tpu_torch.ops._build import build_dir
from distributed_learning_simulator_tpu_torch.runtime import native
from distributed_learning_simulator_tpu_torch.runtime.native import (
    NativeTaskQueue,
    NativeThreadPool,
    RepeatedResult,
    native_available,
)
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
from torch_runs import port_config, read_records

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_library_builds_into_the_build_directory():
    assert native_available()
    path = native.library_path()
    assert os.path.dirname(path) == build_dir() and os.path.exists(path)
    assert native.NATIVE_SOURCE == os.path.join(_REPO, "native",
                                                "dls_runtime.cc")


def test_queue_round_trip_and_broadcast():
    q = NativeTaskQueue()
    q.add_task({"worker": 1, "payload": np.arange(3, dtype=np.float32)})
    task = q.get_task()
    assert task["worker"] == 1 and task["payload"].tolist() == [0, 1, 2]
    q.put_result("params", copies=3)
    assert [q.get_result() for _ in range(3)] == ["params"] * 3
    q.stop()


def test_queue_blocking_get_result():
    q = NativeTaskQueue()
    got = []
    t = threading.Thread(target=lambda: got.append(q.get_result()))
    t.start()
    time.sleep(0.1)
    assert got == []  # still blocked
    q.put_result(42)
    t.join(timeout=5)
    assert got == [42]
    q.stop()


def test_queue_stop_unblocks_and_raises():
    q = NativeTaskQueue()
    errors = []

    def consumer():
        try:
            q.get_result()
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.05)
    q.stop()
    t.join(timeout=5)
    assert errors == ["queue is stopped"] and q.stopped
    with pytest.raises(RuntimeError):
        q.add_task(1)


def test_queue_worker_fun_barrier():
    """None until all N arrive, then a broadcast to all."""
    n, buffer = 4, []

    def worker_fun(task, extra):
        buffer.append(task)
        if len(buffer) < n:
            return None
        total = sum(buffer)
        buffer.clear()
        return RepeatedResult(total, n)

    q = NativeTaskQueue(worker_fun=worker_fun)
    for i in range(n):
        q.add_task(i + 1)
    assert [q.get_result() for _ in range(n)] == [10] * n
    q.stop()


def test_pool_runs_tasks_and_propagates_errors():
    pool = NativeThreadPool(4)
    seen, lock = [], threading.Lock()

    def work(i):
        with lock:
            seen.append(i)
        return i * i

    ids = [pool.exec(work, i) for i in range(20)]
    pool.join_pending()
    results = pool.results()
    assert sorted(seen) == list(range(20))
    assert all(results[tid] == i * i for tid, i in zip(ids, range(20)))
    assert pool.poll() == (20, 20, False)

    def boom():
        raise ValueError("client exploded")

    pool.exec(boom)
    pool.join_pending()
    assert pool.poll()[2]
    with pytest.raises(ValueError, match="client exploded"):
        pool.results()
    pool.stop()


def _cfg(tiny_config, algo, **changes):
    return dataclasses.replace(
        tiny_config, distributed_algorithm=algo, execution_mode="threaded",
        learning_rate=0.01 if algo == "sign_SGD" else 0.1, **changes)


@pytest.mark.parametrize("algo", [
    "fed", "fed_quant", "sign_SGD", "multiround_shapley_value",
    "GTG_shapley_value",
])
def test_history_matches_jax_oracle(tiny_config, algo):
    cfg = _cfg(tiny_config, algo)
    jres = jthr.run_threaded_simulation(cfg, setup_logging=False)
    pres = run_simulation(port_config(cfg), setup_logging=False)
    acc_tol, loss_rtol = ((2 / 256, 5e-3) if algo == "fed_quant"
                          else (1 / 256, 1e-4))
    assert len(pres["history"]) == len(jres["history"]) == cfg.round
    for p, j in zip(pres["history"], jres["history"]):
        assert set(p) == set(j)
        assert abs(p["test_accuracy"] - j["test_accuracy"]) <= acc_tol
        np.testing.assert_allclose(p["test_loss"], j["test_loss"],
                                   rtol=loss_rtol)
        for k in ("uplink_compression_ratio", "downlink_compression_ratio",
                  "sync_steps", "gtg_subset_evals"):
            if k in j:
                assert p[k] == pytest.approx(j[k])
        if "shapley_values" in j and algo == "multiround_shapley_value":
            np.testing.assert_allclose(
                [p["shapley_values"][i] for i in range(cfg.worker_number)],
                [j["shapley_values"][i] for i in range(cfg.worker_number)],
                atol=2 / 256)
    assert set(pres) == set(jres) | {"device"}
    assert pres["xla_compiles"] is None and pres["clients_flagged"] is None


def test_client_stats_and_telemetry_match_jax(tiny_config, tmp_path):
    """Schema-v3 records off the rendezvous stack (update norm, cosine,
    non-finite count against JAX's; loss columns null), the server's phase
    keys, and a run-level compile count."""
    cfg = _cfg(tiny_config, "fed", client_stats="on",
               telemetry_level="basic", compilation_cache_dir=None)
    jres = jthr.run_threaded_simulation(
        dataclasses.replace(cfg, log_root=str(tmp_path / "jax")))
    pres = run_simulation(port_config(cfg, log_root=str(tmp_path / "port")))
    assert pres["clients_flagged"] == jres["clients_flagged"] == 0
    assert pres["xla_compiles"] > 0 and jres["xla_compiles"] > 0
    precs = read_records(tmp_path / "port")
    assert precs == pres["history"]
    for p, j in zip(precs, read_records(tmp_path / "jax")):
        assert p["schema_version"] == j["schema_version"] == 3
        assert set(p["telemetry"]["phase_seconds"]) == set(
            j["telemetry"]["phase_seconds"]) == {"aggregate", "eval",
                                                 "post_round"}
        pc, jc = p["client_stats"]["per_client"], j["client_stats"][
            "per_client"]
        assert pc["loss_after"] == jc["loss_after"] == [None] * 4
        assert pc["nonfinite_count"] == jc["nonfinite_count"]
        for field in ("update_norm", "agg_cosine"):
            np.testing.assert_allclose(pc[field], jc[field], rtol=1e-4,
                                       atol=2e-6)


def _refusal(tiny_config, name):
    cfg = _cfg(tiny_config, "fed")
    changes = {
        "unknown_algorithm": dict(distributed_algorithm="bogus"),
        "server_optimizer": dict(server_optimizer_name="sgd"),
        "participation": dict(participation_fraction=0.5),
        "checkpoint": dict(checkpoint_dir="ckpt", checkpoint_every=1),
        "resume": dict(resume=True),
        "bf16": dict(local_compute_dtype="bfloat16"),
        "lr_schedule": dict(lr_schedule="cosine"),
        "client_eval": dict(client_eval=True),
        "failure_model": dict(failure_mode="dropout", failure_prob=0.2),
        "sign_sgd_adam": dict(distributed_algorithm="sign_SGD",
                              optimizer_name="adam"),
        "exact_shapley_n17": dict(
            distributed_algorithm="multiround_shapley_value",
            worker_number=17),
    }[name]
    return dataclasses.replace(cfg, **changes)


@pytest.mark.parametrize("name", [
    "unknown_algorithm", "server_optimizer", "participation", "checkpoint",
    "resume", "bf16", "lr_schedule", "client_eval", "failure_model",
    "sign_sgd_adam", "exact_shapley_n17",
])
def test_refusals_match_jax_text(tiny_config, name):
    cfg = _refusal(tiny_config, name)
    with pytest.raises(ValueError) as jerr:
        jthr.run_threaded_simulation(cfg, setup_logging=False)
    with pytest.raises(ValueError) as perr:
        thr.run_threaded_simulation(port_config(cfg), setup_logging=False)
    assert str(perr.value) == str(jerr.value)


def test_unported_options_stay_refused_under_threaded(tiny_config):
    cfg = port_config(_cfg(tiny_config, "fed"), multihost=True)
    with pytest.raises(NotImplementedError, match="item 17"):
        run_simulation(cfg, setup_logging=False)


def test_two_runs_bitwise_equal(tiny_config):
    cfg = port_config(_cfg(tiny_config, "fed", round=2, worker_number=3))
    a = run_simulation(cfg, setup_logging=False)
    b = run_simulation(dataclasses.replace(cfg), setup_logging=False)
    assert [(h["test_accuracy"], h["test_loss"]) for h in a["history"]] == [
        (h["test_accuracy"], h["test_loss"]) for h in b["history"]]
    for k, v in a["global_params"].items():
        assert torch.equal(v, b["global_params"][k]), k


@pytest.mark.parametrize("where", ["worker", "server", "final_server"])
def test_failures_raise_instead_of_hanging(tiny_config, monkeypatch, where):
    """A dead worker, a failing server callback, or a failing last-round
    callback (after every worker has exited) re-raises the original error
    promptly."""
    cfg = port_config(_cfg(tiny_config, "fed", round=2))
    if where == "worker":
        original = thr.ThreadedWorker.train

        def sabotaged(self):
            if self.worker_id == 2:
                raise RuntimeError("client exploded mid-round")
            return original(self)

        monkeypatch.setattr(thr.ThreadedWorker, "train", sabotaged)
        match = "client exploded"
    else:
        original = thr.ThreadedServer._process_worker_data
        fail_at = 3 if where == "server" else cfg.round * cfg.worker_number
        calls = {"n": 0}

        def sabotaged(self, data, extra_args):
            calls["n"] += 1
            if calls["n"] == fail_at:
                raise RuntimeError("server eval exploded")
            return original(self, data, extra_args)

        monkeypatch.setattr(thr.ThreadedServer, "_process_worker_data",
                            sabotaged)
        match = "server eval exploded"
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=match):
        thr.run_threaded_simulation(cfg, setup_logging=False)
    assert time.perf_counter() - t0 < 60
