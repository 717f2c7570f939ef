"""Chaos harness: prove bit-exact crash resume of the port
(scripts/chaos_resume.py of the JAX package, on the port).

Runs a reference simulation to completion, then re-runs it killing the
run at a chosen round: an in-process injected crash
(``robustness.chaos.InjectedCrash``) and a subprocess ``SIGKILL`` (no
cleanup at all: the torn-state variant a real preemption produces). Each
crashed run is resumed with ``config.resume``, and the stitched
``history`` must be bit-identical to the uninterrupted run's. The workload
exercises both resume-sensitive streams of the key chain: cohort sampling
(``participation_fraction < 1``) and a dropout failure model. A third
variant sends ``SIGTERM`` (a preemption notice): the run must finish its
round, write a final checkpoint, log ``preempted at round N`` and exit
cleanly, and the resumed tail must again match bit for bit.

Usage::

    python -m distributed_learning_simulator_tpu_torch.robustness.chaos_resume
    python -m ... --rounds 8 --crash-round 3 --variants inprocess,sigkill
    python -m ... --device cpu

Runs on the card unless ``--device cpu``. Internal: ``--child --config
'<json>'`` runs one crashed leg in a fresh interpreter (the parent sets
``DLS_CRASH_AT_ROUND`` / ``DLS_CRASH_KIND``). Prints a JSON verdict; exit
status 0 when every requested variant is bit-identical, 1 otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import tempfile

# Wall-clock fields differ between runs; everything else in a record must
# match bit for bit.
VOLATILE_KEYS = ("round_seconds",)

# The timings inside a streamed run's ``stream`` record; its byte counts
# and sampler still match bit for bit.
STREAM_VOLATILE_KEYS = (
    "h2d_seconds", "hidden_seconds", "overlap_ratio", "sample_ms",
    "d2h_seconds",
)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def strip_volatile(records: list[dict]) -> list[dict]:
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in VOLATILE_KEYS}
        if isinstance(r.get("stream"), dict):
            r["stream"] = {k: v for k, v in r["stream"].items()
                           if k not in STREAM_VOLATILE_KEYS}
        out.append(r)
    return out


def normalize(records: list[dict]) -> list[dict]:
    """JSON round trip of in-memory records, so that they compare exactly
    with records read back from metrics.jsonl."""
    return json.loads(json.dumps(strip_volatile(records)))


def read_metrics_jsonl(log_root: str) -> list[dict]:
    """The per-round records a (possibly killed) run managed to write."""
    paths = sorted(glob.glob(os.path.join(log_root, "**", "metrics.jsonl"),
                             recursive=True))
    records = []
    for path in paths:
        with open(path) as f:
            records.extend(json.loads(line) for line in f if line.strip())
    return strip_volatile(records)


def chaos_config(workdir: str, leg: str, rounds: int, device: str = "cuda",
                 **overrides):
    """The harness workload: small enough for a CPU, adversarial enough to
    cover every resume-sensitive stream (client sampling, a dropout
    failure model, quorum fields in every record)."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )

    kw = dict(
        dataset_name="synthetic",
        model_name="mlp",
        distributed_algorithm="fed",
        worker_number=6,
        round=rounds,
        epoch=1,
        learning_rate=0.1,
        batch_size=32,
        n_train=384,
        n_test=128,
        log_level="INFO",
        dataset_args={"difficulty": 0.5},
        participation_fraction=0.5,
        failure_mode="dropout",
        failure_prob=0.3,
        failure_correlation=0.5,
        min_survivors=1,
        log_root=os.path.join(workdir, leg, "log"),
        device=device,
    )
    kw.update(overrides)
    return ExperimentConfig(**kw)


def run_straight(config) -> list[dict]:
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    return normalize(run_simulation(config)["history"])


def run_crashed_inprocess(config, crash_round: int) -> list[dict]:
    """Crashed leg in this interpreter: InjectedCrash unwinds
    run_simulation; the records it wrote come back from metrics.jsonl."""
    from distributed_learning_simulator_tpu_torch.robustness.chaos import (
        ENV_CRASH_KIND,
        ENV_CRASH_ROUND,
        InjectedCrash,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    os.environ[ENV_CRASH_ROUND] = str(crash_round)
    os.environ[ENV_CRASH_KIND] = "raise"
    try:
        run_simulation(config)
    except InjectedCrash:
        pass
    else:
        raise AssertionError("injected crash did not fire")
    finally:
        os.environ.pop(ENV_CRASH_ROUND, None)
        os.environ.pop(ENV_CRASH_KIND, None)
    return read_metrics_jsonl(config.log_root)


def run_crashed_subprocess(config, crash_round: int, kind: str,
                           env: dict | None = None, timeout: float = 600):
    """Crashed leg in a fresh interpreter; returns the CompletedProcess
    (the caller checks the exit), and the leg's records are read from its
    metrics.jsonl afterwards."""
    env = dict(os.environ if env is None else env)
    env["DLS_CRASH_AT_ROUND"] = str(crash_round)
    env["DLS_CRASH_KIND"] = kind
    return subprocess.run(
        [sys.executable, "-m",
         "distributed_learning_simulator_tpu_torch.robustness.chaos_resume",
         "--child", "--config", json.dumps(vars(config))],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=_REPO,
    )


def run_resumed(config) -> list[dict]:
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    return normalize(run_simulation(
        dataclasses.replace(config, resume=True))["history"])


def stitch_and_compare(straight, crashed, resumed) -> dict:
    """The crashed run's records before the resumed run's first round, then
    the resumed run's, against the straight run. A crash between
    checkpoints replays the rounds after the newest valid checkpoint, and
    those must reproduce bit for bit too."""
    if not resumed:
        return {"bit_identical": False, "error": "resumed run has no rounds"}
    start = resumed[0]["round"]
    stitched = [r for r in crashed if r["round"] < start] + resumed
    mismatches = [
        {"round": a.get("round"), "straight": a, "stitched": b}
        for a, b in zip(straight, stitched) if a != b
    ]
    if len(straight) != len(stitched):
        mismatches.append({
            "error": f"length {len(stitched)} != straight {len(straight)}"
        })
    return {
        "bit_identical": not mismatches,
        "resume_start_round": start,
        "rounds": len(straight),
        "mismatches": mismatches[:3],
    }


def run_variant(variant: str, workdir: str, rounds: int, crash_round: int,
                straight, device: str) -> dict:
    cfg = chaos_config(
        workdir, variant, rounds, device=device,
        checkpoint_dir=os.path.join(workdir, variant, "ckpt"),
        # sigkill off the crash round's cadence on purpose: resume must also
        # replay the rounds between the newest checkpoint and the crash.
        # sigterm with none at all: its forced checkpoint is the only one.
        checkpoint_every={"sigkill": 2, "sigterm": 0}.get(variant, 1),
    )
    if variant == "inprocess":
        crashed = run_crashed_inprocess(cfg, crash_round)
    elif variant in ("sigkill", "sigterm"):
        proc = run_crashed_subprocess(cfg, crash_round, variant)
        want = -signal.SIGKILL if variant == "sigkill" else 0
        if proc.returncode != want:
            return {
                "bit_identical": False,
                "error": f"child exited {proc.returncode}, expected {want}; "
                         f"stderr tail: {proc.stderr[-500:]}",
            }
        if variant == "sigterm" and "preempted at round" not in proc.stderr:
            return {
                "bit_identical": False,
                "error": "child log lacks the 'preempted at round N' line",
            }
        crashed = read_metrics_jsonl(cfg.log_root)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    verdict = stitch_and_compare(straight, crashed, run_resumed(cfg))
    verdict["crashed_rounds_flushed"] = len(crashed)
    return verdict


def child_main(config_json: str) -> None:
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    result = run_simulation(ExperimentConfig(**json.loads(config_json)))
    print(json.dumps({
        "preempted_at": result["preempted_at"],
        "rounds": len(result["history"]),
    }))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--crash-round", type=int, default=3)
    parser.add_argument("--variants", default="inprocess,sigkill,sigterm")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    parser.add_argument("--workdir", default=None,
                        help="scratch dir (default: a fresh temp dir)")
    parser.add_argument("--child", action="store_true")
    parser.add_argument("--config", default=None)
    args = parser.parse_args(argv)
    if args.child:
        child_main(args.config)
        return 0
    if not 0 <= args.crash_round < args.rounds - 1:
        parser.error("--crash-round must leave at least one round to resume")
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_resume_")
    straight = run_straight(chaos_config(workdir, "straight", args.rounds,
                                         device=args.device))
    report = {"workdir": workdir, "rounds": args.rounds,
              "crash_round": args.crash_round, "device": args.device,
              "variants": {}}
    ok = True
    for variant in args.variants.split(","):
        verdict = run_variant(variant.strip(), workdir, args.rounds,
                              args.crash_round, straight, args.device)
        report["variants"][variant.strip()] = verdict
        ok = ok and verdict.get("bit_identical", False)
    report["ok"] = ok
    print(json.dumps(report, indent=2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
