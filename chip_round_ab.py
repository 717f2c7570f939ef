#!/usr/bin/env python3
"""Round times of one main path from two checkouts of the port, on one
NVIDIA GPU, in alternation.

    python3 chip_round_ab.py OTHER_CHECKOUT [--algorithm fed] [--repeats 2]

Runs ``run_simulation`` for the flagship configuration of chip_smoke.py
(ResNet-18, 100 clients, 2 rounds; ``--algorithm`` picks fed, sign_SGD or
fed_quant) from this checkout (B) and from ``OTHER_CHECKOUT`` (A), each in
a fresh process, in the order A B B A (``--repeats`` times), so that the
two versions meet the same card and host in turn. Prints each run's round
seconds and, per checkout, the median of its last rounds (round 0 carries
the warm-up); ``--out`` keeps the numbers as JSON. Exits 1 without a GPU.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from chip_smoke import path_configs
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
config = path_configs(100, 10000, 2000, "WARNING")[sys.argv[2]]
result = run_simulation(config, setup_logging=False)
print(json.dumps([r["round_seconds"] for r in result["history"]]))
"""


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="the other checkout (A)")
    parser.add_argument("--algorithm", default="fed",
                        choices=("fed", "sign_SGD", "fed_quant"))
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--out", default=None, help="JSON output file")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_round_ab: no GPU", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    trees = {"A": os.path.abspath(args.other),
             "B": os.path.dirname(os.path.abspath(__file__))}
    runs = []
    for _ in range(args.repeats):
        for label in "ABBA":
            proc = subprocess.run(
                [sys.executable, "-c", _CHILD, trees[label], args.algorithm],
                capture_output=True, text=True, cwd=trees[label],
            )
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                sys.exit(1)
            seconds = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append({"tree": label, "round_seconds": seconds})
            print(f"{label} {args.algorithm}: round seconds {seconds}",
                  flush=True)
    medians = {
        label: statistics.median(
            s for r in runs if r["tree"] == label
            for s in r["round_seconds"][1:])
        for label in trees
    }
    print(f"median round seconds after round 0: A {medians['A']:.3f}, "
          f"B {medians['B']:.3f} ({card})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "trees": trees, "runs": runs,
                       "medians": medians}, f, indent=1)


if __name__ == "__main__":
    main()
