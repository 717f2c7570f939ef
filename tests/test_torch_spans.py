"""The port's span journals (telemetry/spans.py) against the JAX package's.

* The same begin/end/event/skew sequence under one injected clock gives
  journals whose lines equal the JAX recorder's, and the same round and
  run summaries (the JAX recorder is jax-free, so both run here).
* A port run with ``span_trace='on'`` writes a journal that the unchanged
  ``scripts/trace_timeline.py`` summarizes, records at schema v12 that
  validate against the checked-in schema, and a SIGKILLed child run
  leaves its eager ``open`` line on disk for the stitcher's postmortem.
* The span fields' validation texts are the JAX package's.
"""

import importlib.util
import itertools
import json
import os
import subprocess
import sys

import jsonschema
import pytest

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.telemetry import spans as jspans
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
from distributed_learning_simulator_tpu_torch.telemetry import (
    phases,
    spans,
)

REPO = os.path.join(os.path.dirname(__file__), "..")
SCHEMA = os.path.join(os.path.dirname(__file__), "data",
                      "metrics_record.schema.json")
TINY = dict(dataset_name="synthetic", model_name="mlp", worker_number=4,
            round=2, epoch=1, learning_rate=0.1, batch_size=32, n_train=512,
            n_test=256, log_level="WARNING",
            dataset_args={"difficulty": 0.5})


@pytest.fixture(scope="module")
def tt():
    spec = importlib.util.spec_from_file_location(
        "trace_timeline", os.path.join(REPO, "scripts", "trace_timeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_clock(monkeypatch):
    """Both recorders' clocks replaced by one counter each (the same
    sequence of stamps)."""
    for mod in (jspans, spans):
        ticks = itertools.count(100)
        monkeypatch.setattr(mod.clock, "monotonic",
                            lambda t=ticks: next(t) * 0.25)
        monkeypatch.setattr(mod.clock, "wall",
                            lambda: 1.7e9)


def _basic(rec):
    with rec.span("client_step", "phase", round_idx=7) as extra:
        extra["bytes"] = 123
    rec.event("round_fn", "compile", round_idx=7, seconds=0.5)
    rec.note_skew(7, "spill_skew_ms", 12.5)
    rec.note_skew(7, "spill_skew_ms", 8.0)
    rec.note_pending_skew("ckpt_skew_ms", 3.25)
    rec.flush()
    return [rec.round_summary(7), rec.round_summary(8)]


def _flight(rec):
    for i in range(5):
        rec.end(rec.begin(f"done_{i}", "phase", round_idx=0))
    rec.begin("finalize", "round", round_idx=0, eager=True, k=1)
    return [rec.flush_inflight("quorum_rejected"), rec.round_summary(0)]


def _drops(rec):
    for r in range(3):
        for _ in range(4):
            rec.end(rec.begin("s", "phase", round_idx=r))
        rec.event("dispatch", "dispatch", round_idx=r)
    out = [rec.round_summary(r) for r in range(3)]
    rec.flush()
    return out


def _error(rec):
    with pytest.raises(KeyError):
        with rec.span("eval", "phase", round_idx=2):
            raise KeyError("x")
    return [rec.flush_inflight("KeyError")]


@pytest.mark.parametrize("seq, kw", [
    (_basic, dict(host_id=3, n_hosts=4)),
    (_flight, dict(flush_last_k=2)),
    (_drops, dict(capacity=5)),
    (_error, {}),
])
def test_journal_equals_jax_under_one_clock(tmp_path, monkeypatch, seq, kw):
    """The same sequence under the same injected clock: every journal line,
    the round summaries and the run summary equal the JAX recorder's."""
    _fake_clock(monkeypatch)
    out = {}
    for name, mod in (("jax", jspans), ("port", spans)):
        rec = mod.SpanRecorder(**kw)
        path = rec.attach(str(tmp_path / name), clock_offset_s=0.25,
                          clock_uncertainty_s=0.001)
        results = seq(rec)
        run = rec.run_summary()
        rec.close()
        with open(path) as f:
            lines = [json.loads(line) for line in f]
        run.pop("journal_path")
        out[name] = (lines, results, run)
    assert out["port"] == out["jax"]
    assert os.path.basename(path) == spans.journal_filename(kw.get(
        "host_id", 0))


def test_recorder_bounds_and_unattached_flushes():
    for kw in (dict(capacity=0), dict(flush_last_k=0)):
        with pytest.raises(ValueError) as port:
            spans.SpanRecorder(**kw)
        with pytest.raises(ValueError) as jax_err:
            jspans.SpanRecorder(**kw)
        assert str(port.value) == str(jax_err.value)
    rec = spans.SpanRecorder()
    rec.end(rec.begin("s", "phase"))
    assert rec.flush() == 0 and rec.flush_inflight("sigterm") == 0


def test_span_phase_timer_keeps_the_phase_accounting():
    rec = spans.SpanRecorder()
    timer = spans.SpanPhaseTimer(phases.make_phase_timer("basic"), rec)
    with timer.phase(0, "client_step") as box:
        box.fence(None)
    with timer.phase(0, "eval"):
        pass
    assert timer.enabled and set(timer.take(0)) == {"client_step", "eval"}
    summary = rec.round_summary(0)
    assert summary["count"] == 3  # two phase spans and the dispatch event
    off = spans.SpanPhaseTimer(phases.make_phase_timer("off"), rec)
    with off.phase(1, "eval"):
        pass
    assert not off.enabled and off.take(1) is None
    assert rec.round_summary(1)["count"] == 1


def test_port_run_journal_reads_with_trace_timeline(tmp_path, tt):
    """A port run writes spans_0.jsonl beside metrics.jsonl: the stitcher
    reads it (phase and round spans, one finalize per round, checkpoint
    writes as io spans); the records are v12 and valid; span_trace='off'
    keeps the pre-feature records."""
    cfg = ExperimentConfig(device="cpu", span_trace="on",
                           log_root=str(tmp_path / "log"),
                           checkpoint_dir=str(tmp_path / "ck"),
                           checkpoint_every=1, **TINY)
    res = run_simulation(cfg)
    plain = run_simulation(ExperimentConfig(device="cpu", **TINY),
                           setup_logging=False)
    journal = res["span_summary"]["journal_path"]
    assert os.path.basename(journal) == "spans_0.jsonl"
    artifacts = os.path.dirname(journal)
    with open(os.path.join(artifacts, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(SCHEMA) as f:
        schema = json.load(f)
    for rec, ref in zip(records, plain["history"]):
        jsonschema.validate(rec, schema)
        assert rec["schema_version"] == 12
        assert rec["spans"]["count"] > 0
        strip = {k: v for k, v in rec.items()
                 if k not in ("spans", "schema_version", "round_seconds")}
        assert strip == {k: v for k, v in ref.items()
                         if k != "round_seconds"}
    assert "spans" not in plain["history"][0]
    summary = tt.summarize([tt.load_journal(journal)])
    by_cat = summary["totals"]["0"]["by_cat"]
    assert by_cat["phase"] > 0 and by_cat["round"] > 0 and by_cat["io"] > 0
    with open(journal) as f:
        lines = [json.loads(line) for line in f]
    finals = [ln for ln in lines
              if ln["kind"] == "span" and ln["name"] == "finalize"]
    assert [ln["round"] for ln in finals] == [0, 1]
    ckpt = [ln for ln in lines if ln.get("name") == "ckpt_write"
            and ln["kind"] == "span"]
    assert len(ckpt) == 2 and all(ln["attrs"]["bytes"] > 0 for ln in ckpt)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "trace_timeline.py"),
         artifacts, "--json"], capture_output=True, text=True, check=True)
    assert json.loads(out.stdout)["hosts"][0]["spans"] == len(
        [ln for ln in lines if ln["kind"] == "span"])


def test_sigkilled_run_leaves_its_open_line(tmp_path, tt):
    """A child run killed with SIGKILL right after round 0's record (the
    chaos hook, inside the eager ``finalize`` span) leaves that span's
    open line: the stitcher's postmortem says it died inside finalize."""
    code = (
        "from distributed_learning_simulator_tpu_torch.config import "
        "ExperimentConfig\n"
        "from distributed_learning_simulator_tpu_torch.simulator import "
        "run_simulation\n"
        f"run_simulation(ExperimentConfig(device='cpu', span_trace='on', "
        f"span_dir={str(tmp_path)!r}, **{TINY!r}), setup_logging=False)\n"
    )
    env = dict(os.environ, DLS_CRASH_AT_ROUND="0", DLS_CRASH_KIND="sigkill",
               PYTHONPATH=os.path.abspath(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -9, proc.stderr[-2000:]
    journal = tt.load_journal(str(tmp_path / "spans_0.jsonl"))
    assert [(o["name"], o["round"]) for o in journal["unmatched_opens"]] == [
        ("finalize", 0)]
    dead = [p for p in tt.summarize([journal])["postmortem"]
            if p["kind"] == "died_inside"]
    assert [p["name"] for p in dead] == ["finalize"]


@pytest.mark.parametrize("field, value", [
    ("span_trace", "banana"),
    ("span_buffer_size", 0),
    ("span_flush_last_k", 0),
])
def test_span_config_validation_matches_jax(field, value):
    with pytest.raises(ValueError) as port:
        ExperimentConfig(device="cpu", **{field: value}).validate()
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(**{field: value}).validate()
    assert str(port.value) == str(jax_err.value)
