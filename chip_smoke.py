#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from csrc/, then runs three phases and exits
non-zero if any of them fails:

1. Kernels against their plain PyTorch versions, on the card, at the shapes
   the main path gives them: the GroupNorm stats and normalize kernels at
   B=25 for each of ResNet-18's four stage shapes and at an eval-sized
   batch. mean/rstd must agree at rtol 1e-5 and y within one bf16 ulp
   (of the largest term that sums to y; see ``ulps``).
   Times each kernel (CUDA events, median) beside its bound, its plain
   version and torch.nn.functional.group_norm as a yardstick; and checks a
   small f32 ResNet-18 forward on the card against the same forward on the
   CPU.
2. The main path: ``run_simulation`` with ``device="cuda"`` at the flagship
   settings (ResNet-18 at full width, cifar10-shaped data, Dirichlet(0.1),
   shard cap 100, batch 25, chunk 40, momentum 0.9, lr 0.02, bf16 local
   state) cut to 100 clients and 2 rounds. Every test loss must be finite,
   and each GroupNorm kernel must have launched exactly 20 times per model
   forward that ran (ResNet-18 has 20 GroupNorms).
3. Prints the kernels' JSON line, the card's name and power limit, and as
   its last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Writes its full numbers to
``DIR/chip_smoke.json`` (default ``build/chip_smoke``, which .gitignore
lists).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
EPS = 1e-6
GROUPS = 32
# (HW, C) of ResNet-18's four stages on 32x32 inputs, and how many of the
# model's 20 GroupNorms run at each per forward.
STAGES = ((1024, 64, 5), (256, 128, 5), (64, 256, 5), (16, 512, 5))
TRAIN_BATCH = 25
EVAL_BATCH = 1000
GN_PER_FORWARD = 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 20, repeats: int = 7) -> float:
    """Median per-call DEVICE time of ``fn``: ``iters`` calls captured in a
    CUDA graph, the graph replayed ``repeats`` times between CUDA events.
    Replays issue no host work, so this is the kernels' own time (at
    B=25 the eager calls are bound by the Python wrapper instead, see
    ``eager_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
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


def eager_ms(torch, fn, iters: int = 20, repeats: int = 7) -> float:
    """Median per-call time of ``fn`` called back to back from Python,
    by CUDA events: the larger of the host's issue time and the device
    time, i.e. what one call costs the main path."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def ulps(torch, x, y_k, y_p, mean, rstd, scale, bias):
    """Largest |y_k - y_p| in bf16 ulps of the largest term that sums to y:
    ``y = x*a - mean*a + bias`` with ``a = rstd * scale``. Where the terms
    cancel, y is tiny and a 1e-7 relative difference in mean is many ulps
    of y itself, so the ulp is taken at ``max(|y|, (|x| + |mean|) * |a|,
    |bias|)`` (tests/test_torch_gn.py uses the same measure on the CPU)."""
    cpg = x.shape[2] // mean.shape[1]
    a = (rstd.repeat_interleave(cpg, dim=1) * scale)[:, None, :]
    m = mean.repeat_interleave(cpg, dim=1)[:, None, :]
    mag = torch.maximum(
        torch.maximum(y_p.float().abs(), (x.float().abs() + m.abs()) * a.abs()),
        bias.abs(),
    ).clamp(min=2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((y_k.float() - y_p.float()).abs() / ulp).max().item()


def check_kernels(torch, gn):
    """Phase 1a: each kernel vs its plain version; returns per-shape rows."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(TRAIN_BATCH, hw, c, n) for hw, c, n in STAGES]
    shapes.append((EVAL_BATCH, STAGES[0][0], STAGES[0][1], 0))
    rows = []
    for b, hw, c, per_forward in shapes:
        x = (torch.randn(b, hw, c, device="cuda", generator=gen) * 2 + 1.5
             ).to(torch.bfloat16)
        scale = torch.randn(c, device="cuda", generator=gen)
        bias = torch.randn(c, device="cuda", generator=gen)
        mean_k, rstd_k = gn.gn_stats(x, GROUPS, EPS)
        y_k = gn.gn_normalize(x, mean_k, rstd_k, scale, bias, torch.bfloat16)
        mean_p, rstd_p = gn.gn_stats_plain(x, GROUPS, EPS)
        y_p = gn.gn_normalize_plain(x, mean_p, rstd_p, scale, bias,
                                    torch.bfloat16)
        # The normalize kernel alone, on the plain version's statistics.
        y_k_alone = gn.gn_normalize(x, mean_p, rstd_p, scale, bias,
                                    torch.bfloat16)
        torch.cuda.synchronize()
        for name, k, p in (("mean", mean_k, mean_p), ("rstd", rstd_k, rstd_p)):
            rel = ((k - p).abs() / p.abs().clamp(min=1e-30)).max().item()
            if not math.isfinite(rel) or rel > 1e-5:
                fail(f"gn_stats {name} at {(b, hw, c)}: max rel err {rel:.3e}"
                     " > 1e-5")
        y_ulps = ulps(torch, x, y_k, y_p, mean_p, rstd_p, scale, bias)
        alone_ulps = ulps(torch, x, y_k_alone, y_p, mean_p, rstd_p, scale,
                          bias)
        if not (y_ulps <= 1.0 and alone_ulps <= 1.0):
            fail(f"group_norm y at {(b, hw, c)}: {y_ulps:.2f} bf16 ulps "
                 f"({alone_ulps:.2f} for the normalize kernel alone)")
        stats_err = max((mean_k - mean_p).abs().max().item(),
                        (rstd_k - rstd_p).abs().max().item())
        norm_err = (y_k_alone.float() - y_p.float()).abs().max().item()

        xr4 = x.view(b, int(math.isqrt(hw)), -1, c).permute(0, 3, 1, 2)
        scale16, bias16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        x_bytes = b * hw * c * 2
        stat_bytes = 2 * b * GROUPS * 4
        elems = b * hw * c
        row = {
            "shape": [b, hw, c], "per_forward": per_forward,
            "stats": {
                "ms": time_ms(torch, lambda: gn.gn_stats(x, GROUPS, EPS)),
                "eager_ms": eager_ms(
                    torch, lambda: gn.gn_stats(x, GROUPS, EPS)),
                "plain_ms": time_ms(
                    torch, lambda: gn.gn_stats_plain(x, GROUPS, EPS)),
                "bytes": x_bytes + stat_bytes, "ops": 3 * elems,
                "max_abs_err": stats_err,
            },
            "normalize": {
                "ms": time_ms(torch, lambda: gn.gn_normalize(
                    x, mean_k, rstd_k, scale, bias, torch.bfloat16)),
                "eager_ms": eager_ms(torch, lambda: gn.gn_normalize(
                    x, mean_k, rstd_k, scale, bias, torch.bfloat16)),
                "plain_ms": time_ms(torch, lambda: gn.gn_normalize_plain(
                    x, mean_k, rstd_k, scale, bias, torch.bfloat16)),
                "bytes": 2 * x_bytes + stat_bytes + 2 * c * 4,
                "ops": 4 * elems,
                "max_abs_err": norm_err,
            },
            # One PyTorch call computing the whole GroupNorm forward on the
            # same input (stats and normalize together): the yardstick.
            "library_ms": time_ms(torch, lambda: F.group_norm(
                xr4, GROUPS, scale16, bias16, EPS)),
        }
        for k in ("stats", "normalize"):
            r = row[k]
            r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                      r["ops"] / F32_OPS_PER_S)
            r["bound_by"] = (
                "bytes" if r["bytes"] / HBM_BYTES_PER_S
                >= r["ops"] / F32_OPS_PER_S else "operations"
            )
        log(
            f"kernels B={b} HW={hw} C={c}: "
            f"stats {row['stats']['ms']:.4f} ms (eager "
            f"{row['stats']['eager_ms']:.4f}, bound "
            f"{row['stats']['bound_ms']:.4f}, plain "
            f"{row['stats']['plain_ms']:.4f}); normalize "
            f"{row['normalize']['ms']:.4f} ms (eager "
            f"{row['normalize']['eager_ms']:.4f}, bound "
            f"{row['normalize']['bound_ms']:.4f}, plain "
            f"{row['normalize']['plain_ms']:.4f}); F.group_norm "
            f"{row['library_ms']:.4f} ms; y within {y_ulps:.2f} ulp"
        )
        rows.append(row)
    return rows


def check_model_forward(torch):
    """Phase 1b: a small f32 ResNet-18 forward and backward on the card
    (GroupNorm kernels) against the same on the CPU (plain versions), with
    TF32 off as run_simulation sets it. Logits rtol/atol 1e-3 (other conv
    algorithms); gradients by relative L2 <= 1e-2 (a ulp-level forward
    difference on a ReLU threshold flips that element's backward mask)."""
    import torch.nn.functional as F

    from distributed_learning_simulator_tpu_torch.models.registry import (
        get_model,
        init_params,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        resolve_device,
    )

    resolve_device("cuda")
    params = init_params(get_model("resnet18"), seed=3)
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(4, 32, 32, 3, generator=gen)
    y = torch.randint(0, 10, (4,), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        m = get_model("resnet18", dtype="float32").to(dev)
        m.load_state_dict({k: v.to(dev) for k, v in params.items()})
        logits = m(x.to(dev))
        F.cross_entropy(logits, y.to(dev)).backward()
        out[dev] = (logits.detach().cpu(),
                    {n: p.grad.detach().cpu() for n, p in m.named_parameters()})
    a, b = out["cuda"][0], out["cpu"][0]
    if a.shape != b.shape or not torch.isfinite(a).all():
        fail("ResNet-18 logits on the card: bad shape or non-finite")
    if not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
        fail("ResNet-18 f32 logits: card vs CPU max abs diff "
             f"{(a - b).abs().max().item():.3e} > 1e-3")
    worst = max(
        ((g - out["cpu"][1][n]).norm() / out["cpu"][1][n].norm().clamp(
            min=1e-12)).item()
        for n, g in out["cuda"][1].items()
    )
    if not worst <= 1e-2:
        fail(f"ResNet-18 f32 gradients: card vs CPU relative L2 {worst:.3e}")
    log("model: f32 ResNet-18 on the card matches the CPU (max logit diff "
        f"{(a - b).abs().max().item():.2e}, worst gradient relative L2 "
        f"{worst:.2e})")


def run_main_path(torch, gn):
    """Phase 2: the flagship FedAvg path through run_simulation."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )
    from distributed_learning_simulator_tpu_torch.models.resnet import ResNet18
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    config = ExperimentConfig(
        dataset_name="cifar10", model_name="resnet18",
        distributed_algorithm="fed", worker_number=100, round=2, epoch=1,
        learning_rate=0.02, momentum=0.9, batch_size=25,
        partition="dirichlet", dirichlet_alpha=0.1, max_shard_size=100,
        client_chunk_size=40, local_compute_dtype="bfloat16",
        n_train=10000, n_test=2000, eval_batch_size=1000,
        log_level="INFO", device="cuda",
    )
    forwards = 0

    def count(module, args, output):
        nonlocal forwards
        if isinstance(module, ResNet18):
            forwards += 1

    gn.reset_launch_counts()
    hook = torch.nn.modules.module.register_module_forward_hook(count)
    try:
        result = run_simulation(config, setup_logging=False)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    launches = {"gn_stats": gn.gn_stats.launches,
                "gn_normalize": gn.gn_normalize.launches}
    history = result["history"]
    if len(history) != config.round:
        fail(f"main path ran {len(history)} of {config.round} rounds")
    for rec in history:
        if not math.isfinite(rec["test_loss"]):
            fail(f"round {rec['round']}: non-finite test_loss")
    if forwards == 0:
        fail("main path ran no model forward")
    for name, n in launches.items():
        if n != GN_PER_FORWARD * forwards:
            fail(f"{name} launched {n} times for {forwards} forwards "
                 f"(expected {GN_PER_FORWARD} per forward)")
    seconds = [rec["round_seconds"] for rec in history]
    log(f"main path: {forwards} forwards, launches {launches}, round "
        f"seconds {seconds}, {result['client_rounds_per_sec']:.2f} "
        "client-rounds/s, test_loss "
        f"{[rec['test_loss'] for rec in history]}")
    return {
        "forwards": forwards, "launches": launches, "round_seconds": seconds,
        "client_rounds_per_sec": result["client_rounds_per_sec"],
        "history": history,
    }


def profile_rounds(torch):
    """Where a round's time goes (informational, not a check): the same
    flagship settings cut to 20 clients, 2 rounds, under torch.profiler.
    Reports the device's busy time (sum of kernel times; one stream, so
    kernels do not overlap) against the round loop's wall time, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    config = ExperimentConfig(
        dataset_name="cifar10", model_name="resnet18", worker_number=20,
        round=2, epoch=1, learning_rate=0.02, momentum=0.9, batch_size=25,
        partition="dirichlet", dirichlet_alpha=0.1, max_shard_size=100,
        client_chunk_size=40, local_compute_dtype="bfloat16",
        n_train=2000, n_test=1000, eval_batch_size=1000,
        log_level="WARNING", device="cuda",
    )
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = run_simulation(config, setup_logging=False)
        torch.cuda.synchronize()
    # Kernel events only: the aten ops that launched them carry the same
    # device time again.
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    wall_ms = 1e3 * result["total_seconds"]
    out = {
        "clients": config.worker_number, "rounds": config.round,
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "top_kernels": [
            {"name": k[:120], "device_ms": t, "calls": c} for k, t, c in rows[:12]
        ],
    }
    if busy_ms:
        log(f"profile: {config.worker_number} clients x {config.round} rounds,"
            f" wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle "
            f"share {out['idle_share']:.3f}")
        for r in out["top_kernels"][:8]:
            log(f"  {r['device_ms']:9.2f} ms {r['calls']:7d}x {r['name']}")
    else:
        log("profile: torch.profiler saw no device time")
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join("build", "chip_smoke"),
                        help="directory for chip_smoke.json")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from distributed_learning_simulator_tpu_torch.ops import _build
        from distributed_learning_simulator_tpu_torch.ops import gn_cuda as gn
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    t0 = time.perf_counter()
    gn._lib()
    log(f"built csrc/gn.cu in {time.perf_counter() - t0:.1f}s:\n"
        + _build.BUILD_LOGS.get("gn", "").strip())

    rows = check_kernels(torch, gn)
    check_model_forward(torch)
    main_path = run_main_path(torch, gn)
    profile = profile_rounds(torch)

    train_rows = [r for r in rows if r["per_forward"]]
    kernels = []
    for name, key, replaces in (
        ("gn_stats", "stats",
         "distributed_learning_simulator_tpu/ops/gn_pallas.py:63"),
        ("gn_normalize", "normalize",
         "distributed_learning_simulator_tpu/ops/gn_pallas.py:75"),
    ):
        # Per training forward at B=25: each stage shape times the number
        # of GroupNorms that run at it.
        per_fwd = {
            f: sum(r["per_forward"] * r[key][f] for r in train_rows)
            for f in ("ms", "plain_ms", "bytes", "ops")
        }
        t_bytes = per_fwd["bytes"] / HBM_BYTES_PER_S
        t_ops = per_fwd["ops"] / F32_OPS_PER_S
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distributed_learning_simulator_tpu_torch/csrc/gn.cu",
            "replaces": replaces,
            "launches": main_path["launches"][name],
            "max_abs_err": max(r[key]["max_abs_err"] for r in rows),
            "ms": per_fwd["ms"], "plain_ms": per_fwd["plain_ms"],
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sum(r["per_forward"] * r["library_ms"]
                              for r in train_rows),
        })
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "kernel_rows": rows, "kernels": kernels,
                   "main_path": main_path, "profile": profile}, f,
                  indent=1)
    if "jax" in sys.modules:
        fail("the port imported jax")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
