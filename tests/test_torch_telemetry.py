"""The port's run telemetry (telemetry/phases.py, recompile.py, memory.py,
utils/reporting.py's v2 records) against the JAX package's on the CPU.

* The recompile counter: a shape-unstable port function is flagged by name,
  a cached shape counts 0, and the monitor leaves no process-global state
  behind; the log lines keep the JAX package's levels.
* A stable 3-round ``tiny_config`` run with ``telemetry_level='basic'``
  gives ``post_warmup_compiles`` 0 in both packages, ``round_fn`` in round
  0's ``compiled`` list, the JAX package's phase keys, the JAX accuracy band
  (1/256, test loss rtol 1e-4), and an artifacts directory that
  ``scripts/report_run.py`` reads ("post-warmup recompiles: none").
* ``telemetry_level='off'`` keeps the v1 records: the JAX package's v1 key
  set, and the same training as the telemetry run.
* ``peak_hbm_bytes`` is None on the CPU in both packages; the record
  builder stamps the JAX package's versions.
"""

import dataclasses
import importlib.util
import json
import logging
import os

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run_simulation,
)
from distributed_learning_simulator_tpu.telemetry import (
    peak_hbm_bytes as jax_peak_hbm_bytes,
)
from distributed_learning_simulator_tpu.utils import reporting as jreporting
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
from distributed_learning_simulator_tpu_torch.telemetry import (
    NullPhaseTimer,
    PhaseTimer,
    RecompileMonitor,
    device_memory_stats,
    hbm_limit_bytes,
    log_round_compiles,
    make_phase_timer,
    peak_hbm_bytes,
    recompile,
    tracked,
)
from distributed_learning_simulator_tpu_torch.utils import reporting
from torch_runs import port_config, read_records

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V1_KEYS = {"round", "test_accuracy", "test_loss", "mean_client_loss",
           "round_seconds"}


def test_recompile_monitor_flags_shape_unstable_function():
    """A tracked port function called with a new shape after warmup is an
    event with its name; a cached shape is none."""
    wobbly_step = tracked("wobbly_step", lambda x: x * 2.0)
    with RecompileMonitor() as mon:
        wobbly_step(torch.ones(8))
        mon.attribute(0)  # warmup: the first signature
        wobbly_step(torch.ones(8))
        mon.attribute(1)  # cached
        wobbly_step(torch.ones(9))  # a new shape
        mon.attribute(2)
    warmup, stable, unstable = mon.take(0), mon.take(1), mon.take(2)
    assert [name for name, _ in warmup] == ["wobbly_step"]
    assert stable == []
    assert [name for name, _ in unstable] == ["wobbly_step"]
    assert mon.take(2) == []  # take pops
    # A dtype, a static string or a dict's structure is a new signature
    # too; a Python scalar's value and a host hook are not.
    fn = tracked("f", lambda x, mode=None, hook=None: x)
    with RecompileMonitor() as mon:
        for args, kw in (((torch.ones(2),), {}),
                         ((torch.ones(2, dtype=torch.float64),), {}),
                         ((torch.ones(2),), {"mode": "a"}),
                         ((torch.ones(2),), {"mode": "a", "hook": print}),
                         ((torch.ones(2),), {"mode": "a", "hook": len}),
                         ((torch.ones(2), ), {"mode": 1.0}),
                         ((torch.ones(2), ), {"mode": 2.0}),
                         (({"w": torch.ones(2)},), {})):
            fn(*args, **kw)
    assert len(mon.drain()) == 6


def test_recompile_monitor_restores_global_state():
    """The started monitors are the only process-global state: stop()
    takes the monitor out again, and an event reaches only started
    monitors."""
    before = list(recompile._ACTIVE)
    mon = RecompileMonitor().start()
    assert recompile._ACTIVE == before + [mon]
    recompile.notify("nvcc gn", 1.5)
    mon.stop()
    assert recompile._ACTIVE == before
    recompile.notify("nvcc wgrad", 2.0)
    assert mon.drain() == [("nvcc gn", 1.5)]
    mon.stop()  # idempotent


@pytest.mark.parametrize("warmup", [True, False])
def test_log_round_compiles_levels_and_names(warmup):
    """Warmup events are INFO; a later round's are a WARNING naming the
    function, as in the JAX package."""
    logger = logging.getLogger(f"test_torch_telemetry_{warmup}")
    records = []

    class _Cap(logging.Handler):
        def emit(self, r):
            records.append(r)

    h = _Cap()
    logger.addHandler(h)
    logger.setLevel(logging.INFO)
    try:
        n = log_round_compiles(logger, 7, [("round_fn", 12.5)],
                               warmup=warmup)
        assert n == 1
        (rec,) = records
        msg = rec.getMessage()
        assert "round_fn" in msg and "round 7" in msg
        if warmup:
            assert rec.levelno == logging.INFO and "during warmup" in msg
        else:
            assert rec.levelno == logging.WARNING and "AFTER warmup" in msg
        assert log_round_compiles(logger, 3, [], warmup=warmup) == 0
    finally:
        logger.removeHandler(h)


def test_phase_timer_accumulates_pops_and_levels():
    t = PhaseTimer(fence=False)
    for r, name in ((0, "client_step"), (0, "client_step"), (0, "eval"),
                    (1, "client_step")):
        with t.phase(r, name):
            pass
    r0 = t.take(0)
    assert set(r0) == {"client_step", "eval"}
    assert all(v >= 0.0 for v in r0.values())
    assert t.take(0) == {}
    assert set(t.take(1)) == {"client_step"}
    fenced = make_phase_timer("detailed")
    assert isinstance(fenced, PhaseTimer) and fenced._fence
    with fenced.phase(0, "client_step") as ph:
        out = torch.ones(64, 64) * 3.0
        ph.fence((out, {"aux": [out]}))  # nested containers, CPU tensors
    assert fenced.take(0)["client_step"] > 0.0
    assert not make_phase_timer("basic")._fence
    null = make_phase_timer("off")
    assert isinstance(null, NullPhaseTimer) and not null.enabled
    with null.phase(0, "x") as ph:
        ph.fence(torch.ones(2))
    assert null.take(0) is None


def test_memory_probe_is_none_on_the_cpu_in_both_packages():
    assert jax_peak_hbm_bytes() is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    assert device_memory_stats() is None
    assert peak_hbm_bytes() is None
    assert hbm_limit_bytes() is None
    assert peak_hbm_bytes(torch.device("cpu")) is None


@pytest.mark.parametrize("subs", [
    (None, None), ({"phase_seconds": {"eval": 0.1}, "compiles": 0}, None),
    ({"phase_seconds": {}, "compiles": 2, "compiled": ["round_fn"]},
     {"n_clients": 4}),
    (None, {"n_clients": 4, "vote_agreement": 0.7}),
])
def test_round_record_matches_jax_builder(subs):
    base = {"round": 3, "test_accuracy": 0.5, "round_seconds": 1.0}
    want = jreporting.build_round_record(dict(base), *subs)
    got = reporting.build_round_record(dict(base), *subs)
    assert json.dumps(got) == json.dumps(want)


def _run_pair(tiny_config, tmp_path, **changes):
    jcfg = dataclasses.replace(tiny_config, log_root=str(tmp_path / "jax"),
                               compilation_cache_dir=None, **changes)
    jres = jax_run_simulation(jcfg)
    pres = run_simulation(port_config(jcfg,
                                      log_root=str(tmp_path / "port")))
    return jres, pres


def test_stable_run_matches_jax_and_reports(tiny_config, tmp_path):
    """telemetry_level='basic' over 3 rounds: 0 post-warmup compiles in
    both packages, round_fn named in round 0, the JAX phase keys, the
    accuracy band, and a port artifacts directory report_run.py reads."""
    jres, pres = _run_pair(tiny_config, tmp_path, round=3,
                           telemetry_level="basic")
    assert jres["post_warmup_compiles"] == pres["post_warmup_compiles"] == 0
    assert pres["telemetry_level"] == "basic"
    jrecs, precs = read_records(tmp_path / "jax"), read_records(
        tmp_path / "port")
    assert precs == pres["history"] and len(precs) == 3
    for rec in (jrecs[0], precs[0]):
        assert rec["telemetry"]["compiles"] > 0
        assert any("round_fn" in n for n in rec["telemetry"]["compiled"])
    for j, p in zip(jrecs, precs):
        assert p["schema_version"] == j["schema_version"] == 2
        assert set(p["telemetry"]["phase_seconds"]) == set(
            j["telemetry"]["phase_seconds"])
        assert all(v >= 0.0 for v in p["telemetry"]["phase_seconds"].values())
        assert "peak_hbm_bytes" not in p["telemetry"]  # the CPU
        assert abs(p["test_accuracy"] - j["test_accuracy"]) <= 1 / 256
        np.testing.assert_allclose(p["test_loss"], j["test_loss"], rtol=1e-4)
    for p in precs[1:]:
        assert p["telemetry"]["compiles"] == 0
        assert "compiled" not in p["telemetry"]

    spec = importlib.util.spec_from_file_location(
        "report_run", os.path.join(_REPO, "scripts", "report_run.py"))
    report_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report_run)
    (artifacts,) = {os.path.dirname(p) for p in _metrics_files(
        tmp_path / "port")}
    summary = report_run.summarize_run(report_run.load_metrics(artifacts))
    assert summary["rounds"] == 3
    assert summary["compiles"]["post_warmup"] == 0
    assert summary["compiles"]["warmup"] > 0
    assert summary["final_accuracy"] == precs[-1]["test_accuracy"]
    rendered = "\n".join(report_run.render_summary(summary))
    assert "post-warmup recompiles: none" in rendered
    assert "client_step" in rendered


def _metrics_files(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f == "metrics.jsonl"]


def test_telemetry_off_keeps_v1_records(tiny_config, tmp_path):
    """'off' (the default): the v1 record of the JAX package and of the
    port before telemetry, and the same training as a 'detailed' run, whose
    phases sum to no more than the round's seconds. Pipelined (the
    default), a round is recorded after the next one's dispatch, so its
    record's seconds, from the record before, hold that dispatch and not
    its own: there the phases of all rounds sum to no more than the
    rounds' seconds, and each round's to no more than its own with
    ``pipeline_rounds`` off."""
    jres, pres = _run_pair(tiny_config, tmp_path)
    assert pres["post_warmup_compiles"] is None
    assert jres["post_warmup_compiles"] is None
    for j, p in zip(read_records(tmp_path / "jax"),
                    read_records(tmp_path / "port")):
        assert set(p) == set(j) == V1_KEYS
    on = run_simulation(port_config(
        tiny_config, telemetry_level="detailed"), setup_logging=False)
    sync = run_simulation(port_config(
        tiny_config, telemetry_level="detailed", pipeline_rounds=False),
        setup_logging=False)
    for p, q, r in zip(pres["history"], on["history"], sync["history"],
                       strict=True):
        assert {k: p[k] for k in V1_KEYS - {"round_seconds"}} == {
            k: q[k] for k in V1_KEYS - {"round_seconds"}} == {
            k: r[k] for k in V1_KEYS - {"round_seconds"}}
        assert sum(r["telemetry"]["phase_seconds"].values()) <= (
            r["round_seconds"])
    assert sum(sum(q["telemetry"]["phase_seconds"].values())
               for q in on["history"]) <= sum(
        q["round_seconds"] for q in on["history"])


def test_shared_state_survives_many_threads():
    """32 threads at once, the interpreter's switch interval shortened: a
    tracked function's new signature is one event, a ``locked_once``
    loader runs once, and ``count_launch`` loses no increment (the
    threaded oracle's workers share all three)."""
    import sys
    import threading
    import time

    from distributed_learning_simulator_tpu_torch.ops._build import (
        count_launch,
        locked_once,
    )

    calls = []

    @locked_once
    def load():
        calls.append(1)
        time.sleep(0.01)
        return object()

    def kernel():
        pass

    kernel.launches = 0
    fn = tracked("shared", lambda x: x + 1)
    n_threads, n_counts = 32, 200
    barrier = threading.Barrier(n_threads)
    loaded = []

    def work():
        barrier.wait()
        loaded.append(load())
        fn(torch.ones(3))
        for _ in range(n_counts):
            count_launch(kernel)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with RecompileMonitor() as mon:
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(calls) == 1 and len({id(x) for x in loaded}) == 1
    assert [name for name, _ in mon.drain()] == ["shared"]
    assert kernel.launches == n_threads * n_counts
