"""A/B of ResNet-18's training step and round between checkouts of the
port, on one NVIDIA GPU.

    python3 chip_step_ab.py --trees OLD NEW [NEW ...] [--out DIR]

OLD and each NEW are directories that each hold a checkout of the
repository (for example the parent commit unpacked with ``git archive``
into an ignored directory, and ``.``). Each arm is a process of its own
that imports the port from its tree and builds that tree's kernels there;
the arms run in the order of the trees and then back (OLD NEW NEW OLD for
two trees), one at a time. An arm measures:

* the wgrad kernel alone in f32 (``conv3x3_wgrad`` on seeded
  ``[N, 25, 32, 32, 64]`` inputs, the same in every arm) at each N of
  ``KERNEL_CASES``: the median device ms of a CUDA-graph replay
  (chip_smoke.py's ``time_ms``), cuDNN's
  f32 grouped weight gradient (TF32 off) beside it, and the sha256 of its
  output's bytes; the run fails unless every arm's outputs are bitwise
  equal;
* one training step of ``make_chunk_train_fn`` (ResNet-18 at full width,
  batch 25, SGD with momentum 0.9, the replayed init of seed 0) for each
  of ``STEP_CASES`` (dtype, models a program): the median synchronized
  wall ms of ``STEP_REPEATS`` steps after two warm-up steps, their peak
  device memory, and the median device ms of ``STEP_PROFILES`` steps
  (each the sum of its kernels' times in a torch.profiler window of its
  own);
* the GroupNorm stats kernel (``gn_stats``, each tree's own) on seeded
  inputs, the same in every arm (``gn_cases``): ResNet-18's 20 statistics
  of a training forward at one client (25 samples) and at the chunk of 40
  folded into its batch (1000 samples), bf16 and f32, and the eval's
  1000 samples of M models side by side on the channel axis at each
  stage where M*C fits a kernel row, M in ``GN_EVAL_MODELS``: at the
  planned split, at the split the tree's training forward takes, and at
  every split;
* one vmapped eval forward of ``EVAL_MODELS`` bf16 ResNet-18 models on
  1000 samples (the Shapley subset evals' form): median wall ms and
  subset evals a second;
* the ``fed`` path through ``run_simulation`` for each of
  ``ROUND_CASES`` (bf16 at 40 clients in one chunk of 40; f32 at 20
  clients in one chunk of 20, the f32 sweep fleet's program of one
  seed), ``ROUNDS`` rounds: the median round seconds after round 0.

``--kernel-only`` measures the kernels alone, ``--no-rounds`` the kernels,
the steps and the eval. Writes ``DIR/step_ab.json``
and prints each arm's numbers, the card's name and power limit, and one
JSON line of the whole. Fails without a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

# Beside this script; imported before an arm puts its tree first on the
# path, so every arm times with this tree's helpers.
import chip_smoke

KERNEL_CASES = (1, 20, 40)
STEP_CASES = (("bfloat16", 1), ("bfloat16", 10), ("bfloat16", 40),
              ("float32", 20), ("float32", 40))
STEP_REPEATS = 7
STEP_PROFILES = 5
ROUND_CASES = (("bfloat16", 40), ("float32", 20))
#: ResNet-18's GroupNorm shapes: (HW, C, GroupNorms a forward at it).
GN_STAGES = ((1024, 64, 5), (256, 128, 5), (64, 256, 5), (16, 512, 5))
GN_EVAL_MODELS = (2, 4, 16, 32)
GN_GROUPS, GN_EPS, EVAL_BATCH = 32, 1e-6, 1000
#: Models of one vmapped eval forward: the Shapley subset evals' chunk.
EVAL_MODELS = (16,)
ROUNDS = 4
TRAIN_BATCH = 25


def kernel_case(torch, n: int) -> dict:
    """The f32 wgrad kernel at ``n`` clients: device ms, cuDNN's f32
    grouped weight gradient with TF32 off, and the output's digest (timed
    as chip_smoke.py times them)."""
    from distributed_learning_simulator_tpu_torch.ops import wgrad_cuda

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((n,) + chip_smoke.WGRAD_SHAPE, device="cuda",
                    generator=gen)
    g = torch.randn((n,) + chip_smoke.WGRAD_SHAPE, device="cuda",
                    generator=gen)
    out = wgrad_cuda.conv3x3_wgrad(x, g)
    torch.cuda.synchronize()
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    with chip_smoke.f32_cudnn(torch):
        cudnn_ms = chip_smoke.time_ms(
            torch, chip_smoke.grouped_wgrad(torch, x, g), iters=5)
    return {"n": n, "ms": chip_smoke.time_ms(
                torch, lambda: wgrad_cuda.conv3x3_wgrad(x, g), iters=5),
            "cudnn_ms": cudnn_ms, "sha256": digest}


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
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(STEP_REPEATS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    wgrad_cuda.reset_launch_counts()
    device_ms = []
    for _ in range(STEP_PROFILES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        device_ms.append(sum(
            e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)))
    return {"dtype": dtype_name, "models": m,
            "wall_ms": statistics.median(walls), "wall_ms_all": walls,
            "peak_memory_bytes": peak,
            "device_ms": statistics.median(device_ms),
            "device_ms_all": device_ms,
            "wgrad_launches": wgrad_cuda.conv3x3_wgrad.launches
            // STEP_PROFILES}


def gn_cases(torch) -> dict:
    """The stats kernel's device ms (chip_smoke.py's ``time_ms``) at each
    shape of ``GN_STAGES`` (one client's samples and the chunk of 40's) and
    at the eval's channel-side shapes: at the planned split, at the split
    the tree's training forward takes, and at every split; with the sums
    per training forward."""
    from distributed_learning_simulator_tpu_torch.ops import gn_cuda

    # A tree whose training forward took a split of its own names it.
    training_split = getattr(gn_cuda, "training_split", None)

    def case(b, hw, c, g, dtype, **row):
        gen = torch.Generator(device="cuda").manual_seed(b + hw + c)
        x = (torch.randn(b, hw, c, device="cuda", generator=gen) * 2
             + 1.5).to(dtype)

        def ms(split=None):
            return chip_smoke.time_ms(
                torch, lambda: gn_cuda.gn_stats(x, g, GN_EPS, split=split))

        elem = x.element_size()
        row.update(dtype=str(dtype).split(".")[-1], samples=b, hw=hw, c=c,
                   split=gn_cuda.stats_split(b, hw, c, elem), ms=ms(),
                   by_split={s: ms(s) for s in (1, 2, 4, 8) if s <= hw})
        row["training_ms"] = (ms(training_split(hw, c, elem))
                              if training_split else row["ms"])
        return row

    out = {"training": [], "stages": [], "eval": []}
    for dtype in (torch.bfloat16, torch.float32):
        elem = torch.tensor([], dtype=dtype).element_size()
        for b in (TRAIN_BATCH, 40 * TRAIN_BATCH):
            rows = [case(b, hw, c, GN_GROUPS, dtype, per_forward=n)
                    for hw, c, n in GN_STAGES]
            out["stages"] += rows
            out["training"].append({
                "dtype": rows[0]["dtype"], "samples": b,
                "planned_ms": sum(r["per_forward"] * r["ms"] for r in rows),
                "training_ms": sum(r["per_forward"] * r["training_ms"]
                                   for r in rows)})
        for m in GN_EVAL_MODELS:
            for hw, c, _ in GN_STAGES:
                if m * c * elem <= 256 * 16:
                    out["eval"].append(case(EVAL_BATCH, hw, m * c,
                                            m * GN_GROUPS, dtype, models=m))
    return out


def eval_case(torch, m: int) -> dict:
    """One vmapped eval forward of ``m`` bf16 ResNet-18 models on one
    1000-sample batch (``make_models_eval_fn``: the Shapley subset evals'
    form): the median synchronized wall ms of ``STEP_REPEATS`` after two
    warm-up calls, as subset evals a second."""
    from distributed_learning_simulator_tpu_torch.models.bridge import (
        jax_leaf_order,
    )
    from distributed_learning_simulator_tpu_torch.models.registry import (
        ParamLayout,
        get_model,
        init_params,
    )
    from distributed_learning_simulator_tpu_torch.parallel import engine

    model = get_model("resnet18", dtype=torch.bfloat16).cuda()
    params = init_params(model, (32, 32), seed=0)
    layout = ParamLayout.from_params(params, jax_leaf_order(model, (32, 32)))
    flat = layout.flatten(params).cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    models = flat + 1e-3 * torch.randn((m,) + tuple(flat.shape),
                                       device="cuda", generator=gen)
    xb = torch.rand(1, EVAL_BATCH, 32, 32, 3, device="cuda", generator=gen)
    yb = torch.randint(0, 10, (1, EVAL_BATCH), device="cuda", generator=gen)
    mb = torch.ones(1, EVAL_BATCH, device="cuda")
    evaluate = engine.make_models_eval_fn(engine.make_eval_fn(
        lambda views, x: torch.func.functional_call(model, views, (x,))),
        layout)
    for _ in range(2):
        evaluate(models, xb, yb, mb)
    torch.cuda.synchronize()
    walls = []
    for _ in range(STEP_REPEATS):
        t0 = time.perf_counter()
        evaluate(models, xb, yb, mb)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = statistics.median(walls)
    return {"models": m, "wall_ms": wall, "wall_ms_all": walls,
            "evals_per_s": 1e3 * m / wall}


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


def worker(tree: str, out_path: str, data_dir: str,
           kernel_only: bool = False, rounds: bool = True) -> None:
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
           "kernel": [kernel_case(torch, n) for n in KERNEL_CASES],
           "gn_stats": gn_cases(torch),
           "evals": [] if kernel_only else [eval_case(torch, m)
                                            for m in EVAL_MODELS],
           "steps": [] if kernel_only else [step_case(torch, d, m)
                                            for d, m in STEP_CASES],
           "rounds": [round_case(d, n) for d, n in ROUND_CASES]
           if rounds and not kernel_only else []}
    with open(out_path, "w") as f:
        json.dump(out, f)


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:5], kernel_only="--kernel-only" in sys.argv[5:],
               rounds="--no-rounds" not in sys.argv[5:])
        return
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", required=True,
                        metavar="TREE", help="OLD NEW [NEW ...]")
    parser.add_argument("--out", default=os.path.join("build", "step_ab"))
    parser.add_argument("--kernel-only", action="store_true",
                        help="measure the f32 wgrad kernel alone")
    parser.add_argument("--no-rounds", action="store_true",
                        help="measure the kernel and the steps, no rounds")
    args = parser.parse_args()
    if len(args.trees) < 2:
        parser.error("--trees needs OLD and at least one NEW")
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
    labels = ["old", "new"] + [f"new{k}" for k in
                               range(2, len(args.trees))]
    order = list(zip(labels, args.trees))
    arms = []
    for i, (label, tree) in enumerate(order + order[::-1]):
        path = os.path.join(out, f"arm{i}_{label}.json")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", tree, path, os.path.join(out, "data")]
                       + (["--kernel-only"] if args.kernel_only else [])
                       + (["--no-rounds"] if args.no_rounds else []),
                       check=True, timeout=900)
        with open(path) as f:
            arm = json.load(f)
        arm.update(label=label, seconds=time.perf_counter() - t0)
        arms.append(arm)
        print(f"arm {i} {label} ({arm['seconds']:.1f} s): f32 wgrad "
              + "; ".join(f"N={k['n']} {k['ms']:.4f} ms (cuDNN f32 "
                          f"{k['cudnn_ms']:.4f})" for k in arm["kernel"])
              + "; steps "
              + "; ".join(f"{s['dtype']} x{s['models']} wall "
                          f"{s['wall_ms']:.2f} ms device "
                          f"{s['device_ms']:.2f} ms (of "
                          f"{[round(d, 2) for d in s['device_ms_all']]}) "
                          f"peak {s['peak_memory_bytes'] / 2**30:.2f} GiB"
                          for s in arm["steps"])
              + "; gn_stats per training forward "
              + "; ".join(f"{g['dtype']} x{g['samples'] // TRAIN_BATCH} "
                          f"{g['training_ms']:.4f} ms (planned "
                          f"{g['planned_ms']:.4f})"
                          for g in arm["gn_stats"]["training"])
              + "; gn_stats by stage (dtype, B, HW: planned S, ms, ms by S) "
              + ", ".join(f"{g['dtype']} {g['samples']} {g['hw']}: "
                          f"{g['split']} {g['ms']:.4f} "
                          + "/".join(f"{v:.4f}" for v in
                                     g["by_split"].values())
                          for g in arm["gn_stats"]["stages"])
              + "; gn_stats eval (dtype, M, HW: planned S, ms, ms by S) "
              + ", ".join(f"{g['dtype']} {g['models']} {g['hw']}: "
                          f"{g['split']} {g['ms']:.4f} "
                          + "/".join(f"{v:.4f}" for v in
                                     g["by_split"].values())
                          for g in arm["gn_stats"]["eval"])
              + "; vmapped eval "
              + "; ".join(f"{e['models']} models {e['wall_ms']:.2f} ms, "
                          f"{e['evals_per_s']:.1f} evals/s"
                          for e in arm["evals"])
              + "; median round seconds "
              + "; ".join(f"{r['dtype']} x{r['clients']} "
                          f"{r['median_round_seconds']:.4f}"
                          for r in arm["rounds"]), flush=True)
    digests = {(k["n"], k["sha256"]) for a in arms for k in a["kernel"]}
    bitwise = len(digests) == len(KERNEL_CASES)
    print(f"f32 wgrad outputs bitwise equal in every arm at N = "
          f"{KERNEL_CASES}: {bitwise}")
    summary = {"card": card[0] if card else None, "arms": arms,
               "kernel_bitwise": bitwise}
    with open(os.path.join(out, "step_ab.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(card[0] if card else "nvidia-smi gave nothing")
    print(json.dumps({"kernel_bitwise": bitwise, "arms": [
        {"label": a["label"], "tree": a["tree"],
         "wgrad_f32_ms": [k["ms"] for k in a["kernel"]],
         "gn_stats_training_ms": [g["training_ms"]
                                  for g in a["gn_stats"]["training"]],
         "gn_stats_eval_ms": [g["ms"] for g in a["gn_stats"]["eval"]],
         "evals_per_s": [e["evals_per_s"] for e in a["evals"]],
         "step_wall_ms": [s["wall_ms"] for s in a["steps"]],
         "step_device_ms": [s["device_ms"] for s in a["steps"]],
         "step_peak_bytes": [s["peak_memory_bytes"] for s in a["steps"]],
         "median_round_seconds": [r["median_round_seconds"]
                                  for r in a["rounds"]]} for a in arms]}))
    if not bitwise:
        sys.exit("chip_step_ab.py: the f32 wgrad outputs differ between arms")


if __name__ == "__main__":
    main()
