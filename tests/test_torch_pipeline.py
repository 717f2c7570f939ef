"""Pipelined rounds (``pipeline_rounds``, on by default in both packages):
round r's metric fetch, record, post_round and checkpoint run after round
r+1 is dispatched, and only the fetch's timing moves.

* With the field on and off the records are equal, timing fields apart,
  and the final parameters bitwise, for plain ``fed``, FedAdam, async
  federation, a stateless streamed run and a sweep point in the
  scheduler's lean loop; with it on, each round's fetch comes after the
  next round's server eval (the deferred fetch), with it off right after
  its own (JAX ``tests/test_end_to_end.py::test_pipelined_rounds_match_sync``).
* Both packages at their defaults (pipelined) agree at the f32 parity
  tolerance of the port's end-to-end tests (rtol 1e-4).
* Where the JAX package turns pipelining off, the port logs the JAX text,
  one case per reason (JAX ``tests/test_degradation_logs.py``).
* An exception in round r+1's dispatch still leaves round r recorded in
  both packages (the crash-flush of the pending round).
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run,
)
import distributed_learning_simulator_tpu.simulator as jsim
from distributed_learning_simulator_tpu_torch import simulator as psim
from distributed_learning_simulator_tpu_torch.sweep import SweepSpec, run_sweep
from distributed_learning_simulator_tpu_torch.sweep import engine as sweep_engine
from torch_runs import port_config, read_records

TINY = dict(dataset_name="synthetic", model_name="mlp", worker_number=4,
            round=3, epoch=1, learning_rate=0.1, batch_size=32, n_train=512,
            n_test=256, log_level="WARNING",
            dataset_args={"difficulty": 0.5})
ASYNC_ON = dict(async_mode="on", arrival_model="bimodal",
                arrival_slow_fraction=0.4, arrival_slow_factor=8.0,
                round_deadline=1.5, async_buffer_size=3,
                staleness_alpha=0.5, worker_number=6)
STREAMED = dict(worker_number=8, participation_fraction=0.5,
                participation_sampler="hashed", client_residency="streamed")
CASES = {
    "fed": {},
    "fedadam": dict(server_optimizer_name="adam", server_learning_rate=0.01),
    "async": ASYNC_ON,
    "streamed": STREAMED,
}
TIMING_KEYS = ("overlap_ratio",)


def _untimed(rec):
    """A record without its clock readings (``*_seconds``, ``*_ms``, the
    overlap ratio)."""
    if isinstance(rec, dict):
        return {k: _untimed(v) for k, v in rec.items()
                if not (k.endswith("_seconds") or k.endswith("_ms")
                        or k in TIMING_KEYS)}
    return rec


def _config(**changes):
    return port_config(JaxConfig(**dict(TINY, **changes)))


class _Order:
    """The order of the port's server evals and the waits of its metric
    fetches (``finish_fetch``)."""

    def __init__(self, monkeypatch):
        self.events = []
        finish, make_eval = psim.finish_fetch, psim.make_eval_fn

        def finish_fetch(started):
            self.events.append("fetch")
            return finish(started)

        def make_eval_fn(*args, **kwargs):
            evaluate = make_eval(*args, **kwargs)

            def counted(*a, **k):
                self.events.append("eval")
                return evaluate(*a, **k)

            return counted

        monkeypatch.setattr(psim, "finish_fetch", finish_fetch)
        # The sweep's programs import it at their module's top.
        for module in (psim, sweep_engine):
            monkeypatch.setattr(module, "make_eval_fn", make_eval_fn)


def _deferred(rounds: int) -> list[str]:
    """Each round's fetch after the next round's eval, the last one's
    after the loop."""
    return ["eval"] + ["eval", "fetch"] * (rounds - 1) + ["fetch"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_records_equal_synchronous(case, monkeypatch):
    cfg = _config(**CASES[case])
    runs = {}
    for pipelined in (True, False):
        order = _Order(monkeypatch)
        runs[pipelined] = psim.run_simulation(
            dataclasses.replace(cfg, pipeline_rounds=pipelined),
            setup_logging=False)
        # Only the server evals and the round fetches: the streamed and
        # async rounds fetch nothing else through this function.
        assert order.events == (_deferred(cfg.round) if pipelined
                                else ["eval", "fetch"] * cfg.round), case
    on, off = runs[True], runs[False]
    assert len(on["history"]) == cfg.round
    assert [_untimed(h) for h in on["history"]] == [
        _untimed(h) for h in off["history"]]
    for name, value in on["global_params"].items():
        assert torch.equal(value, off["global_params"][name]), name


def test_lean_sweep_point_pipelined_equals_synchronous(monkeypatch):
    """A point of the scheduled strategy runs the lean warm-program loop;
    pipelined, each fetch follows the next round's eval."""
    histories = {}
    for pipelined in (True, False):
        order = _Order(monkeypatch)
        base = _config(pipeline_rounds=pipelined)
        out = run_sweep(SweepSpec(base, [{"seed": 0}], strategy="scheduled"))
        (point,) = out["points"]
        histories[pipelined] = point["history"]
        assert order.events == (_deferred(base.round) if pipelined
                                else ["eval", "fetch"] * base.round)
    assert [_untimed(h) for h in histories[True]] == [
        _untimed(h) for h in histories[False]]


def test_defaults_agree_with_jax():
    """Both packages at their defaults (pipelined rounds, f32): test
    losses at the port's f32 parity tolerance, accuracies equal."""
    jcfg = JaxConfig(**TINY)
    assert jcfg.pipeline_rounds and port_config(jcfg).pipeline_rounds
    jres = jax_run(jcfg, setup_logging=False)
    pres = psim.run_simulation(port_config(jcfg), setup_logging=False)
    np.testing.assert_allclose(
        [h["test_loss"] for h in pres["history"]],
        [h["test_loss"] for h in jres["history"]], rtol=1e-4)
    assert ([h["test_accuracy"] for h in pres["history"]]
            == [h["test_accuracy"] for h in jres["history"]])


class _Kept(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append((record.name, record.getMessage()))


DISABLED = {
    "dispatch": dict(rounds_per_dispatch=2, round=2),
    "population": dict(STREAMED, population="dynamic", join_rate=2.0,
                       depart_rate=0.1, round=1),
    "stream_state": dict(STREAMED, reset_client_optimizer=False,
                         momentum=0.9, round=1),
    "shapley": dict(distributed_algorithm="multiround_shapley_value",
                    round=1),
    "client_state": dict(reset_client_optimizer=False, momentum=0.9,
                         checkpoint_every=1, round=1),
    "server_state": dict(server_optimizer_name="sgd", server_momentum=0.9,
                         checkpoint_every=1, round=1),
    "empty_client_state": dict(reset_client_optimizer=False,
                               checkpoint_every=1, round=1),
    "empty_stream_state": dict(STREAMED, reset_client_optimizer=False,
                               round=1),
}


@pytest.mark.parametrize("case", sorted(DISABLED))
def test_disabled_reason_is_the_jax_text(case, tmp_path):
    changes = dict(DISABLED[case], log_level="INFO")
    if "checkpoint_every" in changes:
        changes["checkpoint_dir"] = str(tmp_path / "ckpt")
    jcfg = JaxConfig(**dict(TINY, **changes))
    kept = _Kept()
    loggers = [logging.getLogger(n) for n in ("dls_torch", "dls_tpu")]
    for lg in loggers:
        lg.addHandler(kept)
    try:
        psim.run_simulation(port_config(jcfg), setup_logging=False)
        if "checkpoint_every" in changes:
            jcfg = dataclasses.replace(
                jcfg, checkpoint_dir=str(tmp_path / "jax_ckpt"))
        jax_run(jcfg, setup_logging=False)
    finally:
        for lg in loggers:
            lg.removeHandler(kept)
    said = {name: [msg for n, msg in kept.lines
                   if n == name and msg.startswith("pipeline_rounds")]
            for name in ("dls_torch", "dls_tpu")}
    assert len(said["dls_tpu"]) == 1, said
    assert said["dls_torch"] == said["dls_tpu"]


@pytest.mark.parametrize("pipelined", [True, False])
def test_failed_dispatch_keeps_the_round_before(pipelined, monkeypatch,
                                                tmp_path):
    """Round 2's dispatch raises (at its server eval): rounds 0 and 1 are
    recorded in metrics.jsonl by both packages, pipelined or not."""
    cfg = JaxConfig(**dict(TINY, pipeline_rounds=pipelined))

    def failing_at(real, calls):
        def annotate(name):
            if name == "server_eval":
                calls.append(name)
                if len(calls) == 3:
                    raise RuntimeError("injected failure in round 2")
            return real(name)

        return annotate

    monkeypatch.setattr(psim, "annotate", failing_at(psim.annotate, []))
    monkeypatch.setattr(jsim, "annotate", failing_at(jsim.annotate, []))
    runs = {"port": lambda c: psim.run_simulation(port_config(c)),
            "jax": jax_run}
    for name, run in runs.items():
        log_root = tmp_path / name
        with pytest.raises(RuntimeError, match="injected failure"):
            run(dataclasses.replace(cfg, log_root=str(log_root)))
        assert [r["round"] for r in read_records(log_root)] == [0, 1], name
