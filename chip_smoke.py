#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from csrc/ (one nvcc per source, started
together), then runs these phases and exits non-zero if any of them fails:

1. Kernels against their plain PyTorch versions, on the card, at the shapes
   the main path gives them:
   * the GroupNorm stats and normalize kernels at B=25 for each of
     ResNet-18's four stage shapes and at an eval-sized batch. mean/rstd
     must agree at rtol 1e-5 and y within one bf16 ulp (of the largest term
     that sums to y; see ``ulps``); the normalize kernel alone, on the plain
     statistics, must be bit-equal to its plain version with f32 and with
     bf16 scale/bias, also when it runs straight after the PyTorch kernels
     that wrote its x, scale and bias; the stats -> normalize pair
     (``group_norm``, a
     programmatic dependent launch) replayed from a CUDA graph must be
     bitwise equal to the eager pair;
   * the stage-1 weight-gradient kernel at (B, H, W, C) = (25, 32, 32, 64)
     in bf16 and f32, and at (4, 28, 28, 64) in bf16 (a 28-wide image: the
     ragged K slab and the zero-fill path): |kernel - plain| <= 1e-4 *
     max|plain| in f32, and within one bf16 ulp (of the element's term
     magnitude, see ``wgrad_ulps``) after the cast;
   * the SASS of the bf16 wgrad kernel (cuobjdump) must hold tensor-core
     instructions (HMMA or HGMMA).
   Times each kernel (CUDA-graph replay, median) beside its bound, its
   plain version and one PyTorch call computing the same function as a
   yardstick (F.group_norm; cuDNN's weight-only convolution_backward), the
   normalize kernel with f32 (eval) and bf16 (bf16 training) scale/bias,
   the pair in one graph beside the sum of its two kernels alone, the
   GroupNorm stats kernel at every cluster size S (chip_gn_sweep.py sweeps
   the normalize kernel's slice count), and a one-kernel fill as the
   per-launch floor of a graph replay; prints the three kernels redesigned
   for Hopper beside their times before the redesign (constants from
   PERF.md; normalize like for like, with f32 scale/bias as the earlier
   kernel took them); and checks a small f32 ResNet-18
   forward and backward on the card against the same on the CPU, and the
   forward of each plain model (MLP, LeNet5, both CIFAR CNNs in bf16,
   TpuCifarCNN in f32) from the replayed JAX init (``PLAIN_MODELS``).
2. The main paths: ``run_simulation`` with ``device="cuda"``, ResNet-18 at
   full width on cifar10-shaped data, 50 clients x 2 rounds each (PRs
   before the headline path ran 100; cut to keep the whole run near five
   minutes):
   * ``fed`` at the flagship settings (Dirichlet(0.1), shard cap 100, batch
     25, chunk 40, momentum 0.9, lr 0.02, bf16 local state);
   * ``sign_SGD`` at examples/sign_sgd.sh's lr 0.001 with momentum 0.9, f32
     local state, the flagship's partition and batch;
   * ``fed_quant`` at the flagship settings with 256 levels and QAT.
   Each path runs with every launch count set to 0 just before it and read
   just after. Every test loss must be finite; each GroupNorm kernel must
   have launched exactly 20 times per model forward (ResNet-18 has 20
   GroupNorms) and the wgrad kernel exactly 4 times per training step
   (stage 0's four 3x3 convolutions) and never in eval; the records carry
   the algorithm's fields (compression ratios ~32 for sign, ~4 for 8-bit).
   Then the paths of the key chain, partial participation, the robust
   rules and the Shapley algorithms (``extra_path_configs``), each with
   its counts set to 0 just before it and read just after, to the same
   launch gates: the flagship at 100 clients with a hashed 10% cohort (each
   round's cohort is 10 distinct ids equal to the host replay of the key
   chain, its CRC the record's ``cohort_hash``); ``fed`` at 20 clients
   under ``median``, ``trimmed_mean`` and ``krum`` (finite losses, the
   record's fields); exact multi-round Shapley at N=4 (16 subsets a round,
   sum SV = u(all) - u(empty) to 1e-6, ``metric_<round>.pkl`` with 16
   subsets); GTG-Shapley at N=10 (finite SVs, a permutation count). In
   the Shapley rounds every subset-evaluation forward launches exactly 20
   of each GroupNorm kernel. The key chain's known-answer vectors of
   ``jax.random`` are checked too.
   Then the headline workload (``headline_cnn_tpu``: TpuCifarCNN, 1000
   IID clients on the 50000-sample cifar10 surrogate, batch 25, chunk
   250, f32 local state, lr 0.1, momentum 0.9, 2 rounds): finite losses,
   0 launches of every hand-written kernel (the CNN has no GroupNorm and
   no stage-1 ResNet convolution), every metrics.jsonl record valid
   against tests/data/metrics_record.schema.json, and every result-dict
   key of the JAX package's; it prints round seconds, client-rounds/s and
   the final test loss.
3. A profiler pass per algorithm (5 clients, 2 rounds) and one of the
   headline (10 clients, 2 rounds): device busy time, idle share, and the
   host operators with the most self time. Each phase's wall seconds are
   logged and kept.
4. Prints the kernels' JSON line, the card's name and power limit, and as
   its last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Points ``$DLS_DATA_DIR``
into DIR, so every path trains on the deterministic dataset surrogates and
nothing outside the checkout is read. Writes its full numbers to
``DIR/chip_smoke.json`` (default ``build/chip_smoke``, which .gitignore
lists).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
TF32_OPS_PER_S = 495e12       # H100 SXM dense TF32 tensor cores (f32 inputs)
EPS = 1e-6
GROUPS = 32
# (HW, C) of ResNet-18's four stages on 32x32 inputs, and how many of the
# model's 20 GroupNorms run at each per forward.
STAGES = ((1024, 64, 5), (256, 128, 5), (64, 256, 5), (16, 512, 5))
TRAIN_BATCH = 25
EVAL_BATCH = 1000
GN_PER_FORWARD = 20
WGRAD_SHAPE = (TRAIN_BATCH, 32, 32, 64)  # ResNet-18 stage 1, training batch
WGRAD_RAGGED_SHAPE = (4, 28, 28, 64)  # W not a multiple of the 16-deep slab
WGRAD_PER_STEP = 4  # 2 x stage_sizes[0]
# The headline workload (bench.py's default leg): TpuCifarCNN, 1000 IID
# clients on the cifar10-shaped surrogate (50000 train / 10000 test),
# batch 25, chunk 250, f32 local state, lr 0.1, momentum 0.9, the whole
# test set as one eval batch.
HEADLINE_CLIENTS = 1000
SCHEMA = os.path.join("tests", "data", "metrics_record.schema.json")
# Device ms of the kernels before their Hopper redesign, as PERF.md section
# 6 records them (H100 80GB HBM3 at 700.00 W): constants for the comparison
# lines, not measured here. The earlier normalize kernel took f32 scale/bias
# only; its times are compared with the new kernel's f32 scale/bias times.
EARLIER_MS = {
    "conv3x3_wgrad bf16 (25, 32, 32, 64), f32 CUDA-core kernel": 0.0860,
    "gn_stats per training forward (B=25), one CTA per sample": 0.1181,
    "gn_stats (1000, 1024, 64), one CTA per sample": 0.05638,
    "gn_normalize per training forward (B=25), f32 scale/bias, flat "
    "grid-stride kernel": 0.07444,
    "gn_normalize (1000, 1024, 64), f32 scale/bias, flat grid-stride "
    "kernel": 0.1083,
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def capture(torch, fn, iters: int = 1):
    """``fn`` warmed up on a side stream, then ``iters`` calls of it
    captured in a CUDA graph; returns the graph and the last call's
    output (which each replay rewrites)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            out = fn()
    return graph, out


def time_ms(torch, fn, iters: int = 20, repeats: int = 7) -> float:
    """Median per-call DEVICE time of ``fn``: ``iters`` calls captured in a
    CUDA graph, the graph replayed ``repeats`` times between CUDA events.
    Replays issue no host work, so this is the kernels' own time (at
    B=25 the eager calls are bound by the Python wrapper instead, see
    ``eager_ms``)."""
    graph, _ = capture(torch, fn, iters)
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


def graph_replay_equal(torch, fn, want) -> bool:
    """Whether ``fn()`` captured in a CUDA graph and replayed twice gives
    tensors bitwise equal to ``want``."""
    graph, got = capture(torch, fn)
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(p, q) for p, q in zip(got, want))
    return same


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
        # bf16 scale/bias: what bf16 local training hands the kernel.
        scale16, bias16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        mean_k, rstd_k = gn.gn_stats(x, GROUPS, EPS)
        y_k = gn.gn_normalize(x, mean_k, rstd_k, scale, bias, torch.bfloat16)
        mean_p, rstd_p = gn.gn_stats_plain(x, GROUPS, EPS)
        y_p = gn.gn_normalize_plain(x, mean_p, rstd_p, scale, bias,
                                    torch.bfloat16)
        # The normalize kernel alone, on the plain version's statistics.
        y_k_alone = gn.gn_normalize(x, mean_p, rstd_p, scale, bias,
                                    torch.bfloat16)
        y16_p = gn.gn_normalize_plain(x, mean_p, rstd_p, scale16, bias16,
                                      torch.bfloat16)
        y16_k = gn.gn_normalize(x, mean_p, rstd_p, scale16, bias16,
                                torch.bfloat16)
        # Straight after the kernels that write its x, scale and bias: an
        # ordinary launch reads what they wrote.
        y16_after = gn.gn_normalize(torch.mul(x, 1), mean_p, rstd_p,
                                    torch.mul(scale16, 1),
                                    torch.mul(bias16, 1), torch.bfloat16)
        torch.cuda.synchronize()
        same = {"f32 scale/bias": torch.equal(y_k_alone, y_p),
                "bf16": torch.equal(y16_k, y16_p),
                "bf16 after the writes": torch.equal(y16_after, y16_p)}
        if not all(same.values()):
            fail(f"gn_normalize at {(b, hw, c)} is not bit-equal to its plain "
                 f"version on the same statistics: {same}")
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
        norm_err = {
            key: (k.float() - p.float()).abs().max().item()
            for key, k, p in (("normalize", y_k_alone, y_p),
                              ("normalize_bf16", y16_k, y16_p))
        }
        # The pair as the model calls it: group_norm on the NHWC view with
        # bf16 scale/bias; eager twice, then replayed from a graph.
        x4 = x.view(b, int(math.isqrt(hw)), -1, c)

        def pair():
            return gn.group_norm(x4, scale16, bias16, GROUPS, EPS,
                                 torch.bfloat16)

        eager_pair = pair()
        if not all(torch.equal(p, q) for p, q in zip(eager_pair, pair())):
            fail(f"group_norm at {(b, hw, c)}: an eager rerun differs")
        if not graph_replay_equal(torch, pair, eager_pair):
            fail(f"group_norm at {(b, hw, c)}: the graph-replayed pair "
                 "differs from the eager pair")

        xr4 = x4.permute(0, 3, 1, 2)
        x_bytes = b * hw * c * 2
        stat_bytes = 2 * b * GROUPS * 4
        elems = b * hw * c
        # The stats kernel at every cluster size S, beside the planner's
        # pick (ops/gn_cuda.py stats_split): the evidence for its cost model.
        split_ms = {
            s: time_ms(torch,
                       lambda s=s: gn.gn_stats(x, GROUPS, EPS, split=s))
            for s in (1, 2, 4, 8) if b < EVAL_BATCH
        }
        row = {
            "shape": [b, hw, c], "per_forward": per_forward,
            # The smallest kernel a replay can hold: a fill of [B, G] f32.
            "launch_floor_ms": time_ms(torch, torch.empty_like(mean_k).zero_),
            "split": gn.stats_split(b, hw, c, x.element_size()),
            "split_ms": split_ms,
            "normalize_ctas": gn.normalize_plan(
                b, hw, c, x.element_size(),
                torch.cuda.get_device_properties(0).multi_processor_count
            ).grid,
            "stats": {
                "ms": time_ms(torch, lambda: gn.gn_stats(x, GROUPS, EPS)),
                "eager_ms": eager_ms(
                    torch, lambda: gn.gn_stats(x, GROUPS, EPS)),
                "plain_ms": time_ms(
                    torch, lambda: gn.gn_stats_plain(x, GROUPS, EPS)),
                "bytes": x_bytes + stat_bytes, "ops": 3 * elems,
                "max_abs_err": stats_err,
            },
            # f32 scale/bias (the eval model), then bf16 (bf16 training).
            **{key: {
                "ms": time_ms(torch, lambda: gn.gn_normalize(
                    x, mean_k, rstd_k, s_, b_, torch.bfloat16)),
                "eager_ms": eager_ms(torch, lambda: gn.gn_normalize(
                    x, mean_k, rstd_k, s_, b_, torch.bfloat16)),
                "plain_ms": time_ms(torch, lambda: gn.gn_normalize_plain(
                    x, mean_k, rstd_k, s_, b_, torch.bfloat16)),
                "bytes": 2 * x_bytes + stat_bytes + 2 * c * s_.element_size(),
                "ops": 4 * elems,
                "max_abs_err": norm_err[key],
            } for key, s_, b_ in (("normalize", scale, bias),
                                  ("normalize_bf16", scale16, bias16))},
            # bf16 scale/bias as the wrapper took them before they reached
            # the kernel in their own dtype: two conversions, then the
            # kernel on f32 copies.
            "normalize_bf16_converted_eager_ms": eager_ms(
                torch, lambda: gn.gn_normalize(
                    x, mean_k, rstd_k, scale16.to(torch.float32).contiguous(),
                    bias16.to(torch.float32).contiguous(), torch.bfloat16)),
            # The pair in one graph: the normalize launch overlaps the stats
            # kernel (programmatic dependent launch).
            "pair_ms": time_ms(torch, pair),
            "pair_eager_ms": eager_ms(torch, pair),
            # One PyTorch call computing the whole GroupNorm forward on the
            # same input (stats and normalize together): the yardstick.
            "library_ms": time_ms(torch, lambda: F.group_norm(
                xr4, GROUPS, scale16, bias16, EPS)),
        }
        row["kernels_alone_ms"] = (row["stats"]["ms"]
                                   + row["normalize_bf16"]["ms"])
        for k in ("stats", "normalize", "normalize_bf16"):
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
            f"{row['normalize']['plain_ms']:.4f}), with bf16 scale/bias "
            f"{row['normalize_bf16']['ms']:.4f} ms (eager "
            f"{row['normalize_bf16']['eager_ms']:.4f}; converted first "
            f"{row['normalize_bf16_converted_eager_ms']:.4f}); pair "
            f"{row['pair_ms']:.4f} ms (eager {row['pair_eager_ms']:.4f}) "
            f"against {row['kernels_alone_ms']:.4f} alone; F.group_norm "
            f"{row['library_ms']:.4f} ms; y within {y_ulps:.2f} ulp; "
            f"launch floor {row['launch_floor_ms']:.4f} ms; "
            f"stats at S = {row['split']} (planned), by S: "
            + ", ".join(f"{k}: {v:.4f}" for k, v in split_ms.items())
            + f"; normalize on {row['normalize_ctas']} CTAs (planned)"
        )
        rows.append(row)
    return rows


def wgrad_ulps(torch, wg, x, g, k, p):
    """Largest |k - p| after a bf16 cast, in bf16 ulps of the element's
    term magnitude ``sum |x_pad * g|``: where the terms cancel, |dW| is far
    below the rounding of the terms that sum to it."""
    mag = wg.conv3x3_wgrad_plain(x.abs(), g.abs()).clamp(min=2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((k.bfloat16().float() - p.bfloat16().float()).abs() / ulp
            ).max().item()


def check_wgrad(torch, wg):
    """Phase 1b: the wgrad kernel vs its plain version in bf16 and f32 at
    the main path's shape, and in bf16 at a ragged shape; returns one row
    per case."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for name, shape, dtype in (
        ("bf16", WGRAD_SHAPE, torch.bfloat16),
        ("f32", WGRAD_SHAPE, torch.float32),
        ("bf16_ragged", WGRAD_RAGGED_SHAPE, torch.bfloat16),
    ):
        b, h, w, c = shape
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        k = wg.conv3x3_wgrad(x, g)
        p = wg.conv3x3_wgrad_plain(x, g)
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        scale = p.abs().max().item()
        ulp = wgrad_ulps(torch, wg, x, g, k, p)
        if not (math.isfinite(err) and err <= 1e-4 * scale):
            fail(f"wgrad {name} {shape}: max abs err {err:.3e} > 1e-4 * "
                 f"{scale:.3e}")
        if not ulp <= 1.0:
            fail(f"wgrad {name} {shape}: {ulp:.2f} bf16 ulps after the cast")
        # cuDNN's weight gradient of the same convolution, alone: the
        # yardstick (channels-last NCHW views of the same tensors).
        weight = torch.zeros(c, c, 3, 3, dtype=dtype, device="cuda").to(
            memory_format=torch.channels_last)
        x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)

        def cudnn():
            return torch.ops.aten.convolution_backward(
                g_nchw, x_nchw, weight, None, [1, 1], [1, 1], [1, 1], False,
                [0, 0], 1, [False, True, False])[1]

        elem = x.element_size()
        row = {
            "shape": list(shape), "dtype": name,
            "ms": time_ms(torch, lambda: wg.conv3x3_wgrad(x, g)),
            "eager_ms": eager_ms(torch, lambda: wg.conv3x3_wgrad(x, g)),
            "plain_ms": time_ms(torch, lambda: wg.conv3x3_wgrad_plain(x, g)),
            "library_ms": time_ms(torch, cudnn),
            "bytes": 2 * b * h * w * c * elem + 9 * c * c * 4,
            "ops": 2 * 9 * c * c * b * h * w,
            "max_abs_err": err, "bf16_ulps": ulp,
        }
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32_OPS_PER_S
        t_bytes = row["bytes"] / HBM_BYTES_PER_S
        t_ops = row["ops"] / peak
        row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"wgrad {name} {shape}: {row['ms']:.4f} ms (eager "
            f"{row['eager_ms']:.4f}, bound {row['bound_ms']:.4f} by "
            f"{row['bound_by']}, plain {row['plain_ms']:.4f}, cuDNN wgrad "
            f"{row['library_ms']:.4f}); max abs err {err:.2e} "
            f"({err / scale:.2e} of max), {ulp:.2f} bf16 ulp")
        rows[name] = row
    return rows


def check_wgrad_sass(_build):
    """Phase 1c: the bf16 wgrad kernel must run on the tensor cores. Counts
    HMMA/HGMMA instructions per partial kernel in the built library's SASS
    (cuobjdump) and fails if the bf16 one has none."""
    proc = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass", _build.LIB_PATHS["wgrad"]],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        fail(f"cuobjdump -sass failed: {proc.stderr.strip()[:500]}")
    counts = {}
    for section in proc.stdout.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        for kernel in ("wgrad_tc_partial_kernel", "wgrad_f32_partial_kernel"):
            if kernel in name:
                counts[kernel] = len(re.findall(r"\bHG?MMA\b", section))
    if not counts.get("wgrad_tc_partial_kernel"):
        fail(f"no tensor-core instruction (HMMA/HGMMA) in the bf16 wgrad "
             f"kernel's SASS: {counts}")
    log(f"SASS tensor-core instructions per kernel: {counts}")
    return counts


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
    params = init_params(get_model("resnet18"), (32, 32), seed=3)
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
    return check_plain_models(torch, get_model, init_params)


# (registry name, input shape, model_args, tolerance relative to the largest
# CPU logit): f32 models at 1e-4 (TF32 off, other conv algorithms); the bf16
# CNNs at 2**-6, a few bf16 ulps (each bf16 conv output is rounded once, and
# a card and a CPU accumulation can round an element to neighbouring bf16
# values).
PLAIN_MODELS = (
    ("mlp", (32, 32, 3), {}, 1e-4),
    ("lenet5", (28, 28, 1), {}, 1e-4),
    ("cnn", (32, 32, 3), {}, 2.0**-6),
    ("cnn_tpu", (32, 32, 3), {}, 2.0**-6),
    ("cnn_tpu", (32, 32, 3), {"dtype": "float32"}, 1e-4),
)


def check_plain_models(torch, get_model, init_params):
    """Phase 1b: each plain model's forward on the card against the same
    on the CPU: the replayed JAX init (seed 5) and one batch of 25."""
    out = []
    for name, shape, args, tol in PLAIN_MODELS:
        params = init_params(get_model(name, input_shape=shape, **args),
                             shape[:2], seed=5)
        gen = torch.Generator().manual_seed(6)
        x = torch.rand((TRAIN_BATCH,) + shape, generator=gen)
        logits = {}
        with torch.no_grad():
            for dev in ("cpu", "cuda"):
                m = get_model(name, input_shape=shape, **args).to(dev)
                m.load_state_dict({k: v.to(dev) for k, v in params.items()})
                logits[dev] = m(x.to(dev)).float().cpu()
        a, b = logits["cuda"], logits["cpu"]
        if a.shape != (TRAIN_BATCH, 10) or not torch.isfinite(a).all():
            fail(f"{name} {args}: bad logits on the card")
        diff = (a - b).abs().max().item()
        bound = tol * b.abs().max().item()
        if not diff <= bound:
            fail(f"{name} {args}: card vs CPU max logit diff {diff:.3e} > "
                 f"{bound:.3e}")
        out.append({"model": name, "args": args, "max_abs_diff": diff,
                    "bound": bound})
        log(f"model: {name} {args or ''} on the card matches the CPU (max "
            f"logit diff {diff:.2e}, bound {bound:.2e})")
    return out


def path_configs(n_clients: int, n_train: int, n_test: int, log_level):
    """The three main paths' configurations at ``n_clients``."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )

    common = dict(
        dataset_name="cifar10", model_name="resnet18",
        worker_number=n_clients, round=2, epoch=1, batch_size=25,
        partition="dirichlet", dirichlet_alpha=0.1, max_shard_size=100,
        client_chunk_size=40, n_train=n_train, n_test=n_test,
        eval_batch_size=1000, log_level=log_level, device="cuda",
    )
    flagship = dict(learning_rate=0.02, momentum=0.9,
                    local_compute_dtype="bfloat16")
    return {
        "fed": ExperimentConfig(distributed_algorithm="fed", **flagship,
                                **common),
        "sign_SGD": ExperimentConfig(
            distributed_algorithm="sign_SGD", learning_rate=0.001,
            momentum=0.9, local_compute_dtype="float32", **common),
        "fed_quant": ExperimentConfig(
            distributed_algorithm="fed_quant", quant_levels=256, qat=True,
            **flagship, **common),
    }


# Record fields each algorithm must report, with the expected value of the
# compression ratio (analytic: 32 bits -> 1 or 8 bits plus metadata).
RECORD_CHECKS = {
    "fed": {},
    "sign_SGD": {"uplink_compression_ratio": 32.0},
    "fed_quant": {"uplink_compression_ratio": 4.0,
                  "downlink_compression_ratio": 4.0},
}


def run_path(torch, gn, wg, name, config, post_round_probe=None,
             gn_per_forward=GN_PER_FORWARD, wgrad_per_step=WGRAD_PER_STEP,
             setup_logging=False):
    """Phase 2: one main path through run_simulation, with every launch
    count set to 0 just before it and read just after; each GroupNorm
    kernel must launch ``gn_per_forward`` times per model forward and the
    wgrad kernel ``wgrad_per_step`` times per training step (ResNet-18's
    20 and 4; 0 and 0 for a model without GroupNorm). With
    ``post_round_probe`` (a list), each round's post_round is wrapped and
    appends its forwards, GroupNorm launches and seconds to it (the
    Shapley subset evaluations); such a run, or one with
    ``setup_logging``, writes its artifacts under ``config.log_root``."""
    from distributed_learning_simulator_tpu_torch import factory
    from distributed_learning_simulator_tpu_torch.models import registry
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    forwards = {"train": 0, "eval": 0}
    model_classes = tuple({m for m in registry._MODELS.values()
                           if isinstance(m, type)})

    def count(module, args, output):
        if isinstance(module, model_classes):
            forwards["train" if torch.is_grad_enabled() else "eval"] += 1

    cls = factory._ALGORITHMS[config.distributed_algorithm]
    original = cls.post_round
    if post_round_probe is not None:
        def probed(self, ctx):
            torch.cuda.synchronize()
            before = (forwards["eval"], gn.gn_stats.launches,
                      gn.gn_normalize.launches, time.perf_counter())
            out = original(self, ctx)
            torch.cuda.synchronize()
            post_round_probe.append({
                "forwards": forwards["eval"] - before[0],
                "gn_stats": gn.gn_stats.launches - before[1],
                "gn_normalize": gn.gn_normalize.launches - before[2],
                "seconds": time.perf_counter() - before[3],
            })
            return out

        cls.post_round = probed
    gn.reset_launch_counts()
    wg.reset_launch_counts()
    hook = torch.nn.modules.module.register_module_forward_hook(count)
    try:
        result = run_simulation(
            config,
            setup_logging=setup_logging or post_round_probe is not None)
    finally:
        hook.remove()
        cls.post_round = original
    torch.cuda.synchronize()
    launches = {"gn_stats": gn.gn_stats.launches,
                "gn_normalize": gn.gn_normalize.launches,
                "conv3x3_wgrad": wg.conv3x3_wgrad.launches}
    history = result["history"]
    if len(history) != config.round:
        fail(f"{name}: ran {len(history)} of {config.round} rounds")
    for rec in history:
        if not (math.isfinite(rec["test_loss"])
                and math.isfinite(rec["mean_client_loss"])):
            fail(f"{name} round {rec['round']}: non-finite loss")
        for field, want in RECORD_CHECKS.get(name, {}).items():
            if not abs(rec.get(field, math.nan) - want) <= 0.01 * want:
                fail(f"{name} round {rec['round']}: {field}="
                     f"{rec.get(field)} (expected ~{want})")
    if forwards["train"] == 0:
        fail(f"{name}: no training forward ran")
    total_fwd = forwards["train"] + forwards["eval"]
    for kernel in ("gn_stats", "gn_normalize"):
        if launches[kernel] != gn_per_forward * total_fwd:
            fail(f"{name}: {kernel} launched {launches[kernel]} times for "
                 f"{total_fwd} forwards (expected {gn_per_forward} each)")
    if launches["conv3x3_wgrad"] != wgrad_per_step * forwards["train"]:
        fail(f"{name}: conv3x3_wgrad launched "
             f"{launches['conv3x3_wgrad']} times for {forwards['train']} "
             f"training steps (expected {wgrad_per_step} each)")
    seconds = [rec["round_seconds"] for rec in history]
    log(f"{name}: {forwards} forwards, launches {launches}, round seconds "
        f"{seconds}, {result['client_rounds_per_sec']:.2f} client-rounds/s, "
        f"test_loss {[rec['test_loss'] for rec in history]}")
    return {
        "forwards": forwards, "launches": launches, "round_seconds": seconds,
        "client_rounds_per_sec": result["client_rounds_per_sec"],
        "history": history, "result_keys": sorted(result),
    }


def headline_config(n_clients: int, n_train, n_test, eval_batch: int,
                    log_level="INFO", log_root=None):
    """The headline workload (bench.py's default leg) at ``n_clients``."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )

    kw = {} if log_root is None else {"log_root": log_root}
    return ExperimentConfig(
        dataset_name="cifar10", model_name="cnn_tpu",
        distributed_algorithm="fed", worker_number=n_clients, round=2,
        epoch=1, learning_rate=0.1, momentum=0.9, batch_size=25,
        client_chunk_size=250, local_compute_dtype="float32",
        partition="iid", n_train=n_train, n_test=n_test,
        eval_batch_size=eval_batch, log_level=log_level, device="cuda",
        **kw)


def schema_errors(instance, schema, root=None, path="$"):
    """The draft-07 keywords the metrics-record schema uses ($ref, type,
    enum, const, properties, required, additionalProperties, items,
    minimum, maximum, exclusiveMinimum, allOf, anyOf, oneOf, not), checked
    with the standard library (the card's machine may lack jsonschema);
    returns the violations, empty when the record is valid.
    tests/test_torch_chip_smoke.py holds it to jsonschema's verdicts."""
    root = schema if root is None else root
    if isinstance(schema, bool):
        return [] if schema else [f"{path}: false schema"]
    if "$ref" in schema:
        target = root
        for part in schema["$ref"].lstrip("#/").split("/"):
            target = target[part]
        return schema_errors(instance, target, root, path)
    errs = []
    types = {"object": dict, "array": list, "string": str, "null": type(None),
             "boolean": bool, "integer": int, "number": (int, float)}
    if "type" in schema:
        allowed = schema["type"]
        allowed = [allowed] if isinstance(allowed, str) else allowed
        ok = any(isinstance(instance, types[t])
                 and not (t in ("integer", "number")
                          and isinstance(instance, bool))
                 and not (t == "integer" and isinstance(instance, float)
                          and not instance.is_integer())
                 for t in allowed)
        if not ok:
            return [f"{path}: {instance!r} is not of type {allowed}"]
    if "enum" in schema and instance not in schema["enum"]:
        errs.append(f"{path}: {instance!r} not in {schema['enum']}")
    if "const" in schema and instance != schema["const"]:
        errs.append(f"{path}: {instance!r} != {schema['const']!r}")
    if isinstance(instance, (int, float)) and not isinstance(instance, bool):
        if "minimum" in schema and instance < schema["minimum"]:
            errs.append(f"{path}: {instance} < {schema['minimum']}")
        if "maximum" in schema and instance > schema["maximum"]:
            errs.append(f"{path}: {instance} > {schema['maximum']}")
        if ("exclusiveMinimum" in schema
                and instance <= schema["exclusiveMinimum"]):
            errs.append(f"{path}: {instance} <= {schema['exclusiveMinimum']}")
    if isinstance(instance, dict):
        props = schema.get("properties", {})
        for k in schema.get("required", []):
            if k not in instance:
                errs.append(f"{path}: missing {k!r}")
        for k, v in instance.items():
            if k in props:
                errs += schema_errors(v, props[k], root, f"{path}.{k}")
            elif "additionalProperties" in schema:
                errs += schema_errors(v, schema["additionalProperties"],
                                      root, f"{path}.{k}")
    if isinstance(instance, list) and "items" in schema:
        for i, v in enumerate(instance):
            errs += schema_errors(v, schema["items"], root, f"{path}[{i}]")
    for sub in schema.get("allOf", []):
        errs += schema_errors(instance, sub, root, path)
    if "anyOf" in schema and not any(
            not schema_errors(instance, sub, root, path)
            for sub in schema["anyOf"]):
        errs.append(f"{path}: matches none of anyOf")
    if "oneOf" in schema and sum(
            not schema_errors(instance, sub, root, path)
            for sub in schema["oneOf"]) != 1:
        errs.append(f"{path}: does not match exactly one of oneOf")
    if "not" in schema and not schema_errors(instance, schema["not"], root,
                                             path):
        errs.append(f"{path}: matches a 'not' schema")
    return errs


def run_headline(torch, gn, wg, log_root: str):
    """Phase 2c: the headline workload at full width and population
    (``headline_config`` at 1000 clients, 2 rounds) through run_path, with
    its own gates: 0 GroupNorm and 0 wgrad launches (the CNN has neither),
    finite losses, every metrics.jsonl record valid against the checked-in
    schema and equal to the run's history, and the result dict holding
    every key of the JAX package's (``simulator.RESULT_KEYS``)."""
    from distributed_learning_simulator_tpu_torch.simulator import (
        RESULT_KEYS,
    )

    config = headline_config(HEADLINE_CLIENTS, None, None, 10000,
                             log_root=log_root)
    res = run_path(torch, gn, wg, "headline_cnn_tpu", config,
                   gn_per_forward=0, wgrad_per_step=0, setup_logging=True)
    if res["result_keys"] != sorted(RESULT_KEYS):
        fail("headline_cnn_tpu: result keys "
             f"{sorted(set(res['result_keys']) ^ set(RESULT_KEYS))} differ "
             "from the JAX package's plus device")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           SCHEMA)) as f:
        schema = json.load(f)
    with open(os.path.join(_newest_artifacts(config), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if records != res["history"]:
        fail("headline_cnn_tpu: metrics.jsonl differs from the history")
    for rec in records:
        errs = schema_errors(rec, schema)
        if errs:
            fail(f"headline_cnn_tpu round {rec['round']}: record invalid "
                 f"against {SCHEMA}: {errs[:3]}")
    seconds = res["round_seconds"]
    log(f"headline_cnn_tpu: {HEADLINE_CLIENTS} clients, round seconds "
        f"{seconds}, {HEADLINE_CLIENTS / statistics.median(seconds):.1f} "
        f"client-rounds/s per median round "
        f"({res['client_rounds_per_sec']:.1f} over the run), final test "
        f"loss {records[-1]['test_loss']:.4f}, {len(records)} records "
        "valid against the schema")
    return res


def extra_path_configs(log_root: str):
    """The paths of the key chain, partial participation, the robust rules
    and the Shapley algorithms, at full ResNet-18 width on the same
    cifar10-shaped data: the flagship at 100 clients with a hashed 10%
    cohort; ``fed`` under each robust rule at 20 clients (f32 local
    state); exact multi-round Shapley at N=4 (the reference's canonical
    run) with 1000 evaluation samples; GTG-Shapley at N=10 with its
    default bf16 subset evaluation and cumsum prefixes. The Shapley runs
    write their artifacts under ``log_root``."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )

    common = dict(
        dataset_name="cifar10", model_name="resnet18", epoch=1,
        batch_size=25, partition="dirichlet", dirichlet_alpha=0.1,
        max_shard_size=100, client_chunk_size=40, eval_batch_size=1000,
        device="cuda", log_level="INFO", log_root=log_root,
    )
    flagship = dict(learning_rate=0.02, momentum=0.9,
                    local_compute_dtype="bfloat16")
    out = {
        "fed_partial": ExperimentConfig(
            distributed_algorithm="fed", worker_number=100, round=2,
            participation_fraction=0.1, participation_sampler="hashed",
            n_train=10000, n_test=2000, **flagship, **common),
    }
    for rule in ROBUST_RULES:
        out[f"robust_{rule}"] = ExperimentConfig(
            distributed_algorithm="fed", worker_number=20, round=1,
            aggregation=rule, learning_rate=0.02, momentum=0.9,
            local_compute_dtype="float32", n_train=2000, n_test=2000,
            **common)
    out["multiround_shapley_value"] = ExperimentConfig(
        distributed_algorithm="multiround_shapley_value", worker_number=4,
        round=2, shapley_eval_samples=1000, n_train=400, n_test=1000,
        **flagship, **common)
    out["GTG_shapley_value"] = ExperimentConfig(
        distributed_algorithm="GTG_shapley_value", worker_number=10,
        round=2, n_train=1000, n_test=1000, **flagship, **common)
    return out


ROBUST_RULES = ("median", "trimmed_mean", "krum")
BASE_RECORD_FIELDS = ("round", "test_accuracy", "test_loss",
                      "mean_client_loss", "round_seconds")


def _newest_artifacts(config) -> str:
    """The artifacts directory of the newest run of ``config``."""
    import glob

    dirs = glob.glob(os.path.join(
        config.log_root, config.distributed_algorithm, config.dataset_name,
        config.model_name, "*_artifacts"))
    if not dirs:
        fail(f"{config.distributed_algorithm}: no artifacts directory under "
             f"{config.log_root}")
    return max(dirs, key=os.path.getmtime)


def run_extra_paths(torch, gn, wg, log_root: str):
    """Phase 2b: the paths of ``extra_path_configs``, each
    through run_path (counts from 0, 20 GroupNorm launches per forward, 4
    wgrad launches per training step), with their own gates:

    * ``fed_partial``: each round's cohort, replayed on the host from the
      key chain (``FedAvg.cohort_indices``), is 10 distinct ids in range
      and its CRC is the record's ``cohort_hash``;
    * ``robust_*``: finite losses and the record's fields;
    * the Shapley paths: each round's post_round launched exactly 20 of
      each GroupNorm kernel per subset-evaluation forward; multiround
      evaluated 16 subsets a round, sum SV = u(all) - u(empty) to 1e-6
      and ``metric_<round>.pkl`` holds 16 subsets; GTG records finite SVs
      and its permutation count.

    Also checks the key chain's known-answer vectors (ops/prng.py)."""
    import pickle

    from distributed_learning_simulator_tpu_torch.algorithms.fedavg import (
        FedAvg,
    )
    from distributed_learning_simulator_tpu_torch.ops import prng
    from distributed_learning_simulator_tpu_torch.utils.reporting import (
        cohort_crc,
    )

    bad = prng.known_answer_mismatches()
    if bad:
        fail(f"key chain known answers differ from jax.random: {bad}")
    log(f"key chain: {len(prng.KNOWN_ANSWERS)} known answers of jax.random "
        "reproduced")
    results = {}
    for name, config in extra_path_configs(log_root).items():
        shapley = name.endswith("shapley_value")
        probes = [] if shapley else None
        res = run_path(torch, gn, wg, name, config, post_round_probe=probes)
        history = res["history"]
        for rec in history:
            missing = [f for f in BASE_RECORD_FIELDS if f not in rec]
            if missing:
                fail(f"{name} round {rec['round']}: record lacks {missing}")
        if name == "fed_partial":
            key = prng.key(config.seed + 1)
            algo = FedAvg(config)
            cohorts = []
            for rec in history:
                key, round_key = prng.split(key)
                ids = algo.cohort_indices(round_key, config.worker_number)
                if (len(ids) != 10 or len(set(ids.tolist())) != 10
                        or ids.min() < 0
                        or ids.max() >= config.worker_number):
                    fail(f"{name} round {rec['round']}: cohort {ids}")
                if rec.get("cohort_hash") != cohort_crc(
                        ids, config.worker_number):
                    fail(f"{name} round {rec['round']}: cohort_hash "
                         f"{rec.get('cohort_hash')} is not the replayed "
                         f"cohort's {cohort_crc(ids, config.worker_number)}")
                cohorts.append(ids.tolist())
            res["cohorts"] = cohorts
            log(f"{name}: cohorts {cohorts} equal the host replay")
        if shapley:
            res["post_round"] = probes
            for rec, probe in zip(history, probes):
                for k in ("gn_stats", "gn_normalize"):
                    if probe[k] != GN_PER_FORWARD * probe["forwards"]:
                        fail(f"{name} round {rec['round']}: {k} launched "
                             f"{probe[k]} times for {probe['forwards']} "
                             "subset-evaluation forwards")
                sv = [rec["shapley_values"][i]
                      for i in range(config.worker_number)]
                if not all(math.isfinite(v) for v in sv):
                    fail(f"{name} round {rec['round']}: SVs {sv}")
                probe["evals_per_s"] = (probe["forwards"] / probe["seconds"]
                                        if probe["seconds"] else None)
            artifacts = _newest_artifacts(config)
            if name == "multiround_shapley_value":
                for rec, probe in zip(history, probes):
                    with open(os.path.join(
                            artifacts, f"metric_{rec['round']}.pkl"),
                            "rb") as f:
                        utilities = pickle.load(f)
                    if probe["forwards"] != 16 or len(utilities) != 16:
                        fail(f"{name} round {rec['round']}: "
                             f"{probe['forwards']} subset forwards, "
                             f"{len(utilities)} utilities (expected 16)")
                    sv = sum(rec["shapley_values"].values())
                    gap = abs(sv - (utilities[(0, 1, 2, 3)] - utilities[()]))
                    if not gap <= 1e-6:
                        fail(f"{name} round {rec['round']}: sum SV "
                             f"{sv} vs u(all) - u(empty), gap {gap:.3e}")
            else:
                for rec in history:
                    if not isinstance(rec.get("gtg_permutations"), int):
                        fail(f"{name} round {rec['round']}: no permutation "
                             "count")
                if not history[0]["gtg_permutations"]:
                    fail(f"{name}: round 0 walked no permutation")
            log(f"{name}: post_round {probes}; shapley values "
                f"{[rec['shapley_values'] for rec in history]}")
        results[name] = res
    return results


def profile_rounds(torch, name, config):
    """Phase 3, where a round's time goes (informational, not a check): one
    algorithm at 10 clients, 2 rounds, under torch.profiler (whose trace
    processing, not the rounds, takes most of this phase's time). Reports the
    device's busy time (sum of kernel times; one stream, so kernels do not
    overlap) against the round loop's wall time, the kernels that take
    the most device time, and the host operators that take the most self
    CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = run_simulation(config, setup_logging=False)
        torch.cuda.synchronize()
    # Kernel events only: the aten ops that launched them carry the same
    # device time again.
    averages = prof.key_averages()
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in averages
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    wall_ms = 1e3 * result["total_seconds"]
    # Where the host's time goes (the profiler's own overhead included):
    # the operators with the most self CPU time.
    host = sorted(
        ((e.key, e.self_cpu_time_total / 1e3, e.count)
         for e in averages
         if e.device_type == torch.autograd.DeviceType.CPU),
        key=lambda r: -r[1])
    out = {
        "algorithm": name, "clients": config.worker_number,
        "rounds": config.round, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "round_seconds": [rec["round_seconds"] for rec in result["history"]],
        "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "top_kernels": [
            {"name": k[:120], "device_ms": t, "calls": c} for k, t, c in rows[:12]
        ],
        "host_self_ms": sum(r[1] for r in host),
        "top_host_ops": [
            {"name": k[:120], "self_cpu_ms": t, "calls": c}
            for k, t, c in host[:12]
        ],
    }
    if busy_ms:
        log(f"profile {name}: {config.worker_number} clients x "
            f"{config.round} rounds, wall {wall_ms:.1f} ms, device busy "
            f"{busy_ms:.1f} ms, idle share {out['idle_share']:.3f}")
        for r in out["top_kernels"][:8]:
            log(f"  {r['device_ms']:9.2f} ms {r['calls']:7d}x {r['name']}")
        log(f"  host: {out['host_self_ms']:.1f} ms of operator self time; "
            "most:")
        for r in out["top_host_ops"][:6]:
            log(f"  {r['self_cpu_ms']:9.2f} ms {r['calls']:7d}x {r['name']}")
    else:
        log(f"profile {name}: torch.profiler saw no device time")
    return out


def redesign_lines(kernels, rows, wgrad_rows):
    """Prints the kernels redesigned for Hopper beside their yardsticks,
    bounds and earlier times (EARLIER_MS: PERF.md constants, not this
    run); returns the same numbers."""
    by_name = {k["name"]: k for k in kernels}
    w = wgrad_rows["bf16"]
    stats = by_name["gn_stats"]
    norm = by_name["gn_normalize"]
    eval_row = next(r for r in rows if r["shape"][0] == EVAL_BATCH)
    train_rows = [r for r in rows if r["per_forward"]]
    pair, alone = (sum(r["per_forward"] * r[k] for r in train_rows)
                   for k in ("pair_ms", "kernels_alone_ms"))
    out = {
        "conv3x3_wgrad_bf16": {"ms": w["ms"], "cudnn_ms": w["library_ms"],
                               "bound_ms": w["bound_ms"]},
        "gn_stats_per_training_forward": {
            "ms": stats["ms"], "bound_ms": stats["bound_ms"],
            "f_group_norm_ms": stats["library_ms"]},
        "gn_stats_eval": {"ms": eval_row["stats"]["ms"],
                          "bound_ms": eval_row["stats"]["bound_ms"]},
        "gn_normalize_per_training_forward": {
            "ms": norm["ms"], "bound_ms": norm["bound_ms"],
            "f32_params_ms": sum(r["per_forward"] * r["normalize"]["ms"]
                                 for r in train_rows)},
        "gn_normalize_eval": {"ms": eval_row["normalize"]["ms"],
                              "bound_ms": eval_row["normalize"]["bound_ms"]},
        "group_norm_pair_per_training_forward": {
            "ms": pair, "kernels_alone_ms": alone,
            "f_group_norm_ms": stats["library_ms"]},
    }
    before = [f"before: {k} (PERF.md constant): {v:.4f} ms"
              for k, v in EARLIER_MS.items()]
    log(f"redesigned conv3x3_wgrad bf16 {WGRAD_SHAPE}: {w['ms']:.4f} ms "
        f"against cuDNN wgrad {w['library_ms']:.4f} ms (bound "
        f"{w['bound_ms']:.4f}); {before[0]}")
    log(f"redesigned gn_stats per training forward: {stats['ms']:.4f} ms "
        f"(bound {stats['bound_ms']:.4f}; F.group_norm, stats and normalize "
        f"together, {stats['library_ms']:.4f}); {before[1]}")
    log(f"redesigned gn_stats {tuple(eval_row['shape'])}: "
        f"{eval_row['stats']['ms']:.4f} ms (bound "
        f"{eval_row['stats']['bound_ms']:.4f}); {before[2]}")
    n = out["gn_normalize_per_training_forward"]
    log(f"redesigned gn_normalize per training forward, f32 scale/bias as "
        f"before: {n['f32_params_ms']:.4f} ms (bf16 scale/bias, as bf16 "
        f"training calls it: {n['ms']:.4f}; bound {n['bound_ms']:.4f}); "
        f"{before[3]}")
    log(f"redesigned gn_normalize {tuple(eval_row['shape'])}, f32 scale/bias "
        f"as before: {eval_row['normalize']['ms']:.4f} ms (bound "
        f"{eval_row['normalize']['bound_ms']:.4f}); {before[4]}")
    log(f"group_norm pair per training forward in one graph: {pair:.4f} ms "
        f"against {alone:.4f} ms for its two kernels alone (programmatic "
        f"dependent launch saves {alone - pair:.4f}); F.group_norm "
        f"{stats['library_ms']:.4f}")
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
    # The datasets' directory inside this run's output directory, which
    # holds no archive: every path trains on the deterministic surrogate,
    # and the run reads nothing outside the checkout.
    os.environ["DLS_DATA_DIR"] = os.path.join(os.path.abspath(args.out),
                                              "data")
    try:
        from distributed_learning_simulator_tpu_torch.ops import _build
        from distributed_learning_simulator_tpu_torch.ops import gn_cuda as gn
        from distributed_learning_simulator_tpu_torch.ops import (
            wgrad_cuda as wg,
        )
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    # One nvcc per source, all started together (nvcc runs in a
    # subprocess, so the threads overlap).
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for fut in [pool.submit(m._lib) for m in (gn, wg)]:
            fut.result()
    log(f"built csrc/gn.cu and csrc/wgrad.cu in "
        f"{time.perf_counter() - t0:.1f}s:\n"
        + "\n".join(_build.BUILD_LOGS.get(n, "").strip()
                    for n in ("gn", "wgrad")))

    phase_seconds = {"build": time.perf_counter() - t0}

    def phase(name, fn, *fn_args):
        """``fn(*fn_args)``, its wall seconds logged and kept."""
        start = time.perf_counter()
        out = fn(*fn_args)
        phase_seconds[name] = time.perf_counter() - start
        log(f"phase {name}: {phase_seconds[name]:.1f}s")
        return out

    rows = phase("gn_kernels", check_kernels, torch, gn)
    wgrad_rows = phase("wgrad_kernel", check_wgrad, torch, wg)
    sass = check_wgrad_sass(_build)
    plain_models = phase("models", check_model_forward, torch)
    paths = phase("main_paths", lambda: {
        name: run_path(torch, gn, wg, name, config)
        for name, config in path_configs(50, 5000, 2000, "INFO").items()
    })
    paths.update(phase("extra_paths", run_extra_paths, torch, gn, wg,
                       os.path.join(args.out, "log")))
    paths["headline_cnn_tpu"] = phase(
        "headline", run_headline, torch, gn, wg,
        os.path.join(args.out, "log"))
    # The ResNet paths at 5 clients (10 before the headline path: the
    # profiler's trace processing took most of the run), the headline at
    # 10 (50 samples each, as at 1000) with a 1000-sample eval.
    profile_configs = dict(path_configs(5, 500, 1000, "WARNING"))
    profile_configs["headline_cnn_tpu"] = headline_config(
        10, 500, 1000, 1000, log_level="WARNING")
    profiles = phase("profiles", lambda: [
        profile_rounds(torch, name, config)
        for name, config in profile_configs.items()])
    # Launches over every main path (each counted from 0).
    launches = {
        k: sum(p["launches"][k] for p in paths.values())
        for k in ("gn_stats", "gn_normalize", "conv3x3_wgrad")
    }

    train_rows = [r for r in rows if r["per_forward"]]
    kernels = []
    # The training forward's normalize calls take bf16 scale/bias (bf16
    # local state, as on the fed and fed_quant paths).
    for name, key, replaces in (
        ("gn_stats", "stats",
         "distributed_learning_simulator_tpu/ops/gn_pallas.py:63"),
        ("gn_normalize", "normalize_bf16",
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
            "launches": launches[name],
            "max_abs_err": max(r[key]["max_abs_err"] for r in rows),
            "ms": per_fwd["ms"], "plain_ms": per_fwd["plain_ms"],
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sum(r["per_forward"] * r["library_ms"]
                              for r in train_rows),
        })
    # The main path runs the bf16 model: its wgrad calls are the bf16 row.
    w = wgrad_rows["bf16"]
    kernels.append({
        "name": "conv3x3_wgrad", "route": "cuda",
        "source": "distributed_learning_simulator_tpu_torch/csrc/wgrad.cu",
        "replaces": "scripts/exp_pallas_wgrad.py:63",
        "launches": launches["conv3x3_wgrad"],
        "max_abs_err": w["max_abs_err"], "ms": w["ms"],
        "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"], "library_ms": w["library_ms"],
    })
    redesigned = redesign_lines(kernels, rows, wgrad_rows)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "kernel_rows": rows, "wgrad_rows": wgrad_rows,
                   "wgrad_sass_mma": sass, "redesigned": redesigned,
                   "earlier_ms": EARLIER_MS,
                   "kernels": kernels, "main_paths": paths,
                   "plain_models": plain_models,
                   "profiles": profiles, "phase_seconds": phase_seconds},
                  f, indent=1)
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
