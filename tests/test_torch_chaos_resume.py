"""The port's chaos harness (robustness/chaos_resume.py): crash at a chosen
round, resume, and the stitched history must be BIT-identical to the
uninterrupted run's, cohort sampling and failure draws after the resume
included (the checkpointed key chain is what makes this hold). The cases of
the JAX package's tests/test_chaos_resume.py that fall inside this slice,
on the CPU."""

import dataclasses
import json
import os
import signal

import pytest

from distributed_learning_simulator_tpu_torch.robustness import (
    chaos_resume as chaos,
)
from distributed_learning_simulator_tpu_torch.robustness.chaos import (
    InjectedCrash,
)
from distributed_learning_simulator_tpu_torch.simulator import run_simulation


def _config(tmp_path, leg, rounds=5, **overrides):
    return chaos.chaos_config(str(tmp_path), leg, rounds, device="cpu",
                              log_level="WARNING", **overrides)


def _straight(tmp_path):
    return chaos.run_straight(_config(tmp_path, "straight"))


def test_inprocess_crash_resume_bit_identical(tmp_path, monkeypatch):
    straight = _straight(tmp_path)
    cfg = _config(tmp_path, "crash",
                  checkpoint_dir=str(tmp_path / "crash" / "ckpt"),
                  checkpoint_every=1)
    monkeypatch.setenv("DLS_CRASH_AT_ROUND", "2")
    monkeypatch.setenv("DLS_CRASH_KIND", "raise")
    with pytest.raises(InjectedCrash):
        run_simulation(cfg)
    monkeypatch.delenv("DLS_CRASH_AT_ROUND")
    crashed = chaos.read_metrics_jsonl(cfg.log_root)
    assert crashed, "crashed run flushed no metrics records"
    verdict = chaos.stitch_and_compare(straight, crashed,
                                       chaos.run_resumed(cfg))
    assert verdict["bit_identical"], verdict
    # The records carry the resume-sensitive fields, so the comparison
    # covered the sampling and failure draws.
    assert all("cohort_hash" in r and "survivor_count" in r
               for r in straight)


@pytest.mark.parametrize("kind", ["sigkill", "sigterm"])
def test_subprocess_crash_resume_bit_identical(tmp_path, kind):
    """sigkill with checkpoint_every=2 and the kill at round 2: resume also
    replays a round past the newest checkpoint. sigterm with
    checkpoint_every=0: the run finishes its round, writes the forced final
    checkpoint (the only one), logs 'preempted at round N' and exits 0.
    Rounds are pipelined (the default, as in the JAX package): round 2's
    signal lands in its finalize, after round 3's dispatch, so round 3 is
    the round in flight that the run finishes and records."""
    straight = _straight(tmp_path)
    ckpt_dir = tmp_path / kind / "ckpt"
    cfg = _config(tmp_path, kind, checkpoint_dir=str(ckpt_dir),
                  checkpoint_every=2 if kind == "sigkill" else 0)
    proc = chaos.run_crashed_subprocess(cfg, 2, kind, timeout=420)
    if kind == "sigkill":
        assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                    proc.stderr[-800:])
    else:
        assert proc.returncode == 0, (proc.returncode, proc.stderr[-800:])
        assert "preempted at round" in proc.stderr
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        assert child["preempted_at"] == 3
        ckpts = [f for f in os.listdir(ckpt_dir) if f.endswith(".ckpt")]
        assert ckpts == ["round_3.ckpt"]
    crashed = chaos.read_metrics_jsonl(cfg.log_root)
    assert crashed, "the crashed run flushed no metrics records"
    verdict = chaos.stitch_and_compare(straight, crashed,
                                       chaos.run_resumed(cfg))
    assert verdict["bit_identical"], verdict


def test_harness_cli_reports_every_variant(tmp_path, capsys):
    assert chaos.main(["--device", "cpu", "--rounds", "4", "--crash-round",
                       "1", "--variants", "inprocess",
                       "--workdir", str(tmp_path)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["variants"]["inprocess"]["bit_identical"]


def test_cohort_sampling_resume_determinism(tmp_path):
    """With participation_fraction < 1 and no failure model, the cohorts
    after resume are the uninterrupted run's."""
    base = _config(tmp_path, "cohort", failure_mode="none",
                   failure_prob=0.0, min_survivors=0)
    straight = run_simulation(dataclasses.replace(base, round=4),
                              setup_logging=False)
    ckdir = str(tmp_path / "ck")
    run_simulation(dataclasses.replace(base, round=2, checkpoint_dir=ckdir,
                                       checkpoint_every=1),
                   setup_logging=False)
    resumed = run_simulation(dataclasses.replace(
        base, round=4, checkpoint_dir=ckdir, resume=True),
        setup_logging=False)
    assert [h["cohort_hash"] for h in resumed["history"]] == [
        h["cohort_hash"] for h in straight["history"][2:]]
    assert [h["test_accuracy"] for h in resumed["history"]] == [
        h["test_accuracy"] for h in straight["history"][2:]]
    assert "survivor_count" not in straight["history"][0]
