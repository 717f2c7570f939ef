#!/usr/bin/env python3
"""Diagnostic sweep of the GroupNorm normalize kernel on one NVIDIA GPU.

    python3 chip_gn_sweep.py [--out DIR] [--rounds N]

Not a gate: it measures what the normalize planner and the programmatic
dependent launch (PDL) of ``group_norm`` rest on, at chip_smoke.py's
GroupNorm shapes (ResNet-18's four stage shapes at batch 25 and the eval
batch), bf16 x with bf16 scale/bias:

* the normalize kernel alone (CUDA-graph replay, ordinary launches) at
  slice counts 1 to 32 and the planned one, each clipped and spread by
  ``gn_cuda.normalize_plan`` as the wrapper would, keyed by the CTAs it
  gives;
* the stats -> normalize pair in one graph with the normalize launch made
  with and without the PDL attribute, the two graphs replayed in
  alternation ``--rounds`` times (ABAB..., then BABA...), so each round
  gives a paired difference; per shape and per training forward (each
  stage shape x its 5 GroupNorms). The two must give bitwise equal outputs.

Prints one line per shape, the card's name and power limit, and writes the
numbers to ``DIR/chip_gn_sweep.json`` (default ``build/chip_gn_sweep``,
which .gitignore lists). Exits non-zero without a GPU. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

SLICES = (1, 2, 4, 8, 16, 32)


def replay_ms(torch, graph, iters: int, repeats: int = 7) -> float:
    """Median per-call device time of ``repeats`` replays of ``graph``,
    which holds ``iters`` calls."""
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join("build", "chip_gn_sweep"),
                        help="directory for chip_gn_sweep.json")
    parser.add_argument("--rounds", type=int, default=10,
                        help="alternations of the with/without PDL graphs")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_gn_sweep: FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from chip_smoke import (EPS, EVAL_BATCH, GROUPS, STAGES, TRAIN_BATCH,
                                capture, time_ms)
        from distributed_learning_simulator_tpu_torch.ops import _build
        from distributed_learning_simulator_tpu_torch.ops import gn_cuda as gn
    except ImportError as e:
        print(f"chip_gn_sweep: FAIL: the repo is not beside this script: {e}",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}, "
          f"{sms} SMs", flush=True)
    gn._lib()
    print(_build.BUILD_LOGS.get("gn", "").strip(), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(TRAIN_BATCH, hw, c, n) for hw, c, n in STAGES]
    shapes.append((EVAL_BATCH, STAGES[0][0], STAGES[0][1], 0))
    rows = []
    ok = True
    for b, hw, c, per_forward in shapes:
        x = (torch.randn(b, hw, c, device="cuda", generator=gen) * 2 + 1.5
             ).to(torch.bfloat16)
        scale = torch.randn(c, device="cuda", generator=gen).to(torch.bfloat16)
        bias = torch.randn(c, device="cuda", generator=gen).to(torch.bfloat16)
        mean, rstd = gn.gn_stats(x, GROUPS, EPS)
        plan = gn.normalize_plan(b, hw, c, x.element_size(), sms)
        by_ctas = {}
        for s in sorted(set(SLICES) | {plan.slices}):
            ctas = gn.normalize_plan(b, hw, c, x.element_size(), sms, s).grid
            by_ctas.setdefault(ctas, time_ms(torch, lambda s=s: gn._normalize(
                x, mean, rstd, scale, bias, torch.bfloat16,
                after_stats=False, slices=s)))

        def pair(after_stats):
            m, r = gn.gn_stats(x, GROUPS, EPS)
            return m, r, gn._normalize(x, m, r, scale, bias, torch.bfloat16,
                                       after_stats=after_stats)

        iters = 20
        graphs = {}
        outs = {}
        for name, flag in (("pdl", True), ("ordinary", False)):
            graphs[name], outs[name] = capture(
                torch, lambda flag=flag: pair(flag), iters)
            graphs[name].replay()
        torch.cuda.synchronize()
        same = all(torch.equal(p, q) for p, q in zip(outs["pdl"],
                                                     outs["ordinary"]))
        ok = ok and same
        times = {"pdl": [], "ordinary": []}
        for k in range(args.rounds):
            order = ("pdl", "ordinary") if k % 2 == 0 else ("ordinary", "pdl")
            for name in order:
                times[name].append(replay_ms(torch, graphs[name], iters))
        gain = [o - p for p, o in zip(times["pdl"], times["ordinary"])]
        row = {
            "shape": [b, hw, c], "per_forward": per_forward,
            "planned_ctas": plan.grid, "normalize_ms_by_ctas": by_ctas,
            "pair_ms": times, "pdl_gain_ms": gain,
            "pdl_equal_to_ordinary": same,
        }
        rows.append(row)
        print(
            f"B={b} HW={hw} C={c}: normalize by CTAs (planned {plan.grid}): "
            + ", ".join(f"{k}: {v:.5f}" for k, v in by_ctas.items())
            + f" ms; pair with PDL median {statistics.median(times['pdl']):.5f}"
            f" ms, without {statistics.median(times['ordinary']):.5f}; "
            f"paired gain median {statistics.median(gain):.5f} ms, range "
            f"[{min(gain):.5f}, {max(gain):.5f}] over {args.rounds} rounds; "
            f"outputs equal: {same}", flush=True)
    train = [r for r in rows if r["per_forward"]]
    fwd = {
        name: [sum(r["per_forward"] * r["pair_ms"][name][k] for r in train)
               for k in range(args.rounds)]
        for name in ("pdl", "ordinary")
    }
    fwd_gain = [o - p for p, o in zip(fwd["pdl"], fwd["ordinary"])]
    sd = statistics.stdev(fwd_gain) if len(fwd_gain) > 1 else math.nan
    print(f"pair per training forward: with PDL median "
          f"{statistics.median(fwd['pdl']):.5f} ms, without "
          f"{statistics.median(fwd['ordinary']):.5f}; paired gain median "
          f"{statistics.median(fwd_gain):.5f} ms, mean "
          f"{statistics.fmean(fwd_gain):.5f}, sd {sd:.5f}, range "
          f"[{min(fwd_gain):.5f}, {max(fwd_gain):.5f}] over {args.rounds} "
          "rounds", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_gn_sweep.json"), "w") as f:
        json.dump({"card": card, "sms": sms, "torch": torch.__version__,
                   "rows": rows, "per_forward_ms": fwd,
                   "per_forward_gain_ms": fwd_gain}, f, indent=1)
    print(card)
    if not ok:
        print("chip_gn_sweep: FAIL: the pair with and without PDL differ",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
