"""A/B of ResNet-18's training step and round between two checkouts of the
port, on one NVIDIA GPU.

    python3 chip_step_ab.py --trees OLD NEW [--out DIR]

OLD and NEW are directories that each hold a checkout of the repository
(for example the parent commit unpacked with ``git archive`` into an
ignored directory, and ``.``). Each arm is a process of its own that
imports the port from its tree and builds that tree's kernels there; the
arms run in the order OLD NEW NEW OLD, one at a time. An arm measures:

* one training step of ``make_chunk_train_fn`` (ResNet-18 at full width,
  batch 25, SGD with momentum 0.9, the replayed init of seed 0) for each
  of ``STEP_CASES`` (dtype, models a program): the median synchronized
  wall ms of ``STEP_REPEATS`` steps after two warm-up steps, and the
  device ms of one step (the sum of its kernels' times, torch.profiler);
* the ``fed`` path through ``run_simulation`` for each of
  ``ROUND_CASES`` (bf16 at 40 clients in one chunk of 40; f32 at 20
  clients in one chunk of 20, the f32 sweep fleet's program of one
  seed), ``ROUNDS`` rounds: the median round seconds after round 0.

Writes ``DIR/step_ab.json`` and prints each arm's numbers, the card's name
and power limit, and one JSON line of the whole. Fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

STEP_CASES = (("bfloat16", 40), ("float32", 20), ("float32", 40))
STEP_REPEATS = 7
ROUND_CASES = (("bfloat16", 40), ("float32", 20))
ROUNDS = 4
TRAIN_BATCH = 25


def step_case(torch, dtype_name: str, m: int) -> dict:
    """One ResNet-18 training step of ``m`` models in ``dtype_name``."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_learning_simulator_tpu_torch.models.bridge import (
        jax_leaf_order,
    )
    from distributed_learning_simulator_tpu_torch.models.registry import (
        ParamLayout,
        get_model,
        init_params,
    )
    from distributed_learning_simulator_tpu_torch.ops import wgrad_cuda
    from distributed_learning_simulator_tpu_torch.parallel import engine

    dtype = getattr(torch, dtype_name)
    model = get_model("resnet18", dtype=dtype).cuda()
    params = init_params(model, (32, 32), seed=0)
    layout = ParamLayout.from_params(params, jax_leaf_order(model, (32, 32)))
    flat = layout.flatten(params).cuda()

    def apply_fn(views, x):
        return torch.func.functional_call(model, views, (x,))

    train = engine.make_chunk_train_fn(
        apply_fn, engine.make_optimizer("sgd", 0.02, 0.9), layout, 1,
        TRAIN_BATCH, compute_dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs = torch.rand(m, TRAIN_BATCH, 32, 32, 3, device="cuda", generator=gen)
    ys = torch.randint(0, 10, (m, TRAIN_BATCH), device="cuda", generator=gen)
    mask = torch.ones(m, TRAIN_BATCH, device="cuda")
    perms = torch.arange(TRAIN_BATCH).expand(m, 1, TRAIN_BATCH)

    def step():
        return train(flat, xs, ys, mask, perms, list(range(m)))

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(STEP_REPEATS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wgrad_cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    device_ms = sum(
        e.self_device_time_total / 1e3 for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False))
    return {"dtype": dtype_name, "models": m,
            "wall_ms": statistics.median(walls), "wall_ms_all": walls,
            "device_ms": device_ms,
            "wgrad_launches": wgrad_cuda.conv3x3_wgrad.launches}


def round_case(dtype_name: str, clients: int) -> dict:
    """``ROUNDS`` rounds of ResNet-18 ``fed`` at ``clients`` clients in
    one chunk, on the flagship's partition."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    config = ExperimentConfig(
        dataset_name="cifar10", model_name="resnet18",
        distributed_algorithm="fed", worker_number=clients, round=ROUNDS,
        epoch=1, batch_size=TRAIN_BATCH, partition="dirichlet",
        dirichlet_alpha=0.1, max_shard_size=100, client_chunk_size=clients,
        n_train=100 * clients, n_test=1000, eval_batch_size=1000,
        learning_rate=0.02, momentum=0.9, local_compute_dtype=dtype_name,
        model_args={"dtype": dtype_name}, pipeline_rounds=False,
        log_level="WARNING", device="cuda")
    result = run_simulation(config, setup_logging=False)
    secs = [r["round_seconds"] for r in result["history"]]
    return {"dtype": dtype_name, "clients": clients, "round_seconds": secs,
            "median_round_seconds": statistics.median(secs[1:]),
            "test_loss": [r["test_loss"] for r in result["history"]]}


def worker(tree: str, out_path: str, data_dir: str) -> None:
    """One arm: the port of ``tree``, its kernels built there."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    os.environ["DLS_DATA_DIR"] = data_dir
    import torch

    from distributed_learning_simulator_tpu_torch.ops import gn_cuda
    from distributed_learning_simulator_tpu_torch.ops import wgrad_cuda

    gn_cuda._lib()
    wgrad_cuda._lib()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {"tree": tree,
           "steps": [step_case(torch, d, m) for d, m in STEP_CASES],
           "rounds": [round_case(d, n) for d, n in ROUND_CASES]}
    with open(out_path, "w") as f:
        json.dump(out, f)


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:5])
        return
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs=2, required=True,
                        metavar=("OLD", "NEW"))
    parser.add_argument("--out", default=os.path.join("build", "step_ab"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_step_ab.py needs a GPU: torch.cuda.is_available() "
                 "is False")
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    arms = []
    for i, (label, tree) in enumerate(
            [("old", args.trees[0]), ("new", args.trees[1]),
             ("new", args.trees[1]), ("old", args.trees[0])]):
        path = os.path.join(out, f"arm{i}_{label}.json")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", tree, path, os.path.join(out, "data")],
                       check=True, timeout=900)
        with open(path) as f:
            arm = json.load(f)
        arm.update(label=label, seconds=time.perf_counter() - t0)
        arms.append(arm)
        print(f"arm {i} {label} ({arm['seconds']:.1f} s): steps "
              + "; ".join(f"{s['dtype']} x{s['models']} wall "
                          f"{s['wall_ms']:.2f} ms device "
                          f"{s['device_ms']:.2f} ms"
                          for s in arm["steps"])
              + "; median round seconds "
              + "; ".join(f"{r['dtype']} x{r['clients']} "
                          f"{r['median_round_seconds']:.4f}"
                          for r in arm["rounds"]), flush=True)
    summary = {"card": card[0] if card else None, "arms": arms}
    with open(os.path.join(out, "step_ab.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(card[0] if card else "nvidia-smi gave nothing")
    print(json.dumps({"arms": [
        {"label": a["label"],
         "step_wall_ms": [s["wall_ms"] for s in a["steps"]],
         "step_device_ms": [s["device_ms"] for s in a["steps"]],
         "median_round_seconds": [r["median_round_seconds"]
                                  for r in a["rounds"]]} for a in arms]}))


if __name__ == "__main__":
    main()
