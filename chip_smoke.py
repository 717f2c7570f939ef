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
   * the SASS of the bf16 wgrad kernel (cuobjdump) must hold wgmma
     (HGMMA) in every layout it is built for;
   * the batched shapes the main path gives the kernels at the flagship's
     chunk of 40 clients (``check_batched``): the wgrad kernel at
     (40, 25, 32, 32, 64) bf16 must be bitwise equal to 40 one-client calls
     and within the tolerance above of its plain version; at every N of
     ``WGRAD_CLIENT_COUNTS`` (1 to 80), bf16 in each of its layouts and
     f32, each client's dW must be bitwise its one-client call's (timed by
     N and layout beside cuDNN's grouped weight gradient, and the f32 kernel
     at the sweep fleet's chunk of 20 beside cuDNN's f32 one with TF32
     off); the normalize kernel at 40 x 25 samples of each
     stage shape with a per-model ``[40, C]`` bf16 affine must be bitwise
     equal to 40 calls with ``[C]`` affines and to its plain version; the
     stats kernel at those 1000 samples within rtol 1e-5 of its plain
     version. Timed beside their bounds, their plain versions, cuDNN's
     weight-only convolution_backward of the grouped convolution (wgrad),
     the 40 one-client calls (wgrad, the one-client path) and one
     F.group_norm of the 40 models side by side on the channel axis (GN);
   * the GroupNorm kernels with the models on the channel side
     (``check_channel_side``), as ``group_norm``'s vmap rule reads the
     grouped convolutions' output while M*C fits a kernel row: M = 10, 16,
     32 at every stage where that holds, B = 25 and 1000, bf16 and f32,
     against the plain versions and M per-model calls.
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
   minutes), each client chunk trained as one vmapped program:
   * ``fed`` at the flagship settings (Dirichlet(0.1), shard cap 100, batch
     25, chunk 40, momentum 0.9, lr 0.02, bf16 local state);
   * ``sign_SGD`` at examples/sign_sgd.sh's lr 0.001 with momentum 0.9, f32
     local state, the flagship's partition and batch;
   * ``fed_quant`` at the flagship settings with 256 levels and QAT.
   Each path runs with every launch count set to 0 just before it and read
   just after. Every test loss must be finite; each GroupNorm kernel must
   have launched exactly 20 times per model forward (ResNet-18 has 20
   GroupNorms; a forward is a whole chunk's) and the wgrad kernel exactly
   4 times per training step (stage 0's four 3x3 convolutions; a step is a
   whole chunk's) and never in eval; the training forwards must be at most
   rounds x steps x chunks (one per chunk-step, never one per client); the
   records carry the algorithm's fields (compression ratios ~32 for sign,
   ~4 for 8-bit). Each path's peak device memory is kept.
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
   the Shapley rounds the subset models are evaluated a batch of up to
   ``shapley_eval_chunk`` at a time, one vmapped forward per eval batch
   (never one per model), and every such forward launches exactly 20 of
   each GroupNorm kernel. The key chain's known-answer vectors of
   ``jax.random`` are checked too.
   Then the headline workload (``headline_cnn_tpu``: TpuCifarCNN, 1000
   IID clients on the 50000-sample cifar10 surrogate, batch 25, chunk
   250, f32 local state, lr 0.1, momentum 0.9, 2 rounds): finite losses,
   0 launches of every hand-written kernel (the CNN has no GroupNorm and
   no stage-1 ResNet convolution), every metrics.jsonl record valid
   against tests/data/metrics_record.schema.json, and every result-dict
   key of the JAX package's; it prints round seconds, client-rounds/s and
   the final test loss.
   Then one ``fed`` round of ResNet-18 (f32 model and local state, 8
   clients of one step each, no size-aware schedule) at chunk 1 and at
   chunk 4
   (``compare_chunks``): the two global models must agree at rtol 1e-4 /
   atol 1e-5 and the test losses at rtol 1e-4.
   Then the robustness phases (``robustness_configs``: ResNet-18 at full
   width, cut like the main paths, 3 rounds): ``fedopt_dropout`` (50
   clients, chunk 40, bf16, client adamw and FedAdam, dropout at 0.2
   with correlation 0.5, a quorum of 30, a checkpoint every round, the
   last 2 kept) through run_path's gates, printing survivors, checkpoint
   seconds and bytes; ``fedavgm_reject`` (20 clients, f32, FedAvgM,
   corrupt_nan at 0.3 under the plain mean): a round must be rejected,
   and every rejected round must leave the global params and the server
   momentum bitwise as they were; ``crash_resume`` (``fedopt_dropout`` at
   20 clients, chunk 10, quorum 12): two straight runs, a child process
   killed with SIGKILL after round 1 and resumed here (bitwise equal to
   the straight runs when they are bitwise equal to each other, else
   within twice their spread), and a child that gets SIGTERM after round
   1 (exit 0, ``preempted_at`` the round in flight, round 2 under pipelined
   rounds, its final checkpoint on disk);
   ``gn_autodiff``: a chunk-40 bf16 training step with
   ``gn_custom_backward`` False and True, the forward bitwise equal, the
   gradients within 2**-8 of the largest element, the launch counts
   equal, each step's ms.
   Then the telemetry and the threaded oracle, cut like the main paths:
   ``telemetry_fed`` (the ``fed`` main path for 3 rounds with
   ``telemetry_level='basic'`` and ``client_stats='on'``: no compile
   after round 0, ``round_fn`` among round 0's, schema-v3 records with the
   four phases and a positive ``peak_hbm_bytes``, round seconds beside the
   plain path's; then one round at 'detailed' whose phases sum to at most
   its seconds); ``client_stats_detect`` (20 clients, f32, median, 2
   rounds under ``corrupt_scale`` and ``corrupt_nan`` at 0.2: the flagged
   ids are the injected ids every round, with reasons ``update_norm`` and
   ``non_finite``); ``threaded_fed`` (the oracle on ResNet-18, f32, 4
   client threads, 2 rounds, telemetry and client stats on: the GroupNorm
   and wgrad kernels launched, schema-v3 records, and a second run bitwise
   equal; the queue's bytes, pickling, training and rendezvous seconds);
   ``threaded_algos`` (sign_SGD, fed_quant and both Shapley algorithms
   through the oracle on ``cnn_tpu``, 4 clients, 1 round: finite
   accuracies, one record a round, sign_SGD's vote rendezvous time).
   Then valuation, spans, profiling, round batching and async federation,
   cut like the main paths (ResNet-18 at full width, Dirichlet(0.1), shard
   cap 100, batch 25, chunk 40, bf16 local state), each through run_path's
   launch gates: ``valuation_fed`` (``fed``, 50 clients, 3 rounds, client
   stats and valuation on, a GTG audit in round 2 with 4 permutations,
   without the size-aware schedule: schema-v7 records, finite audit
   correlations, GN and wgrad launches inside the audit, the replayed
   uploads' update norms at rtol 1e-4 of the round's client stats; the
   audit's seconds and subset evals/s); ``spans_fed`` (``fed``, 50
   clients, 2 rounds, ``span_trace='on'``: the journal written,
   ``scripts/trace_timeline.py`` summarizing its round and phase spans,
   schema-v12 records); ``profile_costmodel`` (``fed`` at 10 clients,
   rounds 1-2 profiled into ``profile_dir``, one profiler window per
   training step, then a run with ``cost_model_trace`` on it, the two
   runs' peak device memory printed side by side: ``dls::group_norm`` and
   ``dls::conv3x3_wgrad`` kernels with bytes in the trace, FLOPs in the
   convolution category, a finite positive predicted round on
   ``h100-sxm-1`` in the v6 record; the ledger, the predicted-to-measured
   ratio and the fitted efficiencies printed); ``pipeline_ab`` (the
   headline and ResNet-18 ``fed`` at 10 clients, chunk 10, bf16, 3
   rounds, ``telemetry_level='basic'``, each with ``pipeline_rounds``
   false and true in the order A B A B: every arm's records equal to the
   first's field by field apart from the timings, its final params
   bitwise; each arm's median round seconds over rounds 1 and later and
   its ``host_sync`` seconds printed); ``round_batch`` (``fed``
   and ``sign_SGD`` at 20 clients in one chunk, 3 rounds at
   ``rounds_per_dispatch`` 1 and 3: bitwise equal histories and params,
   no synchronizing CUDA call
   inside a dispatch; the headline's round seconds at K=3 and K=1);
   ``async_fed`` (``fed``, 50 clients, 3 rounds, bimodal arrivals,
   deadline 1.5, buffer 8: schema-v4 records, a buffer apply, and
   ``round_deadline=inf`` bitwise equal to the synchronous run).
   Then the memory refusals and streamed residency, each path with its
   counts set to 0 just before it and read just after: ``oom_hint``
   (``fed`` at the flagship settings, 1000 clients as one chunk: the JAX
   package's hint text with a ``client_chunk_size=`` below 1000, chained
   from a ``torch.OutOfMemoryError``, and the card's allocated memory
   back within 64 MiB once the exception is dropped; GTG at N=1000
   refused by ``_assert_client_stack_feasible`` before any allocation);
   ``stream_flagship`` (``fed`` at the flagship settings, 400 clients, a
   hashed 10% cohort, 3 rounds, resident and ``client_residency=
   'streamed'`` in turns (A B; A B B A until the multihost phase came),
   and ``sign_SGD`` as its main path in the same turns, through
   run_path's gates: params and history
   bitwise equal, valid v5 records; round seconds, overlap ratio, H2D MiB
   and both peaks printed; then for ``fed`` one profiled round resident
   and one streamed (one a residency since the ``multihost_stream`` phase
   came), their device busy ms beside their wall seconds);
   ``stream_population`` (bench.py's ``stream`` leg: an MLP on
   ``synthetic_stream_shards`` populations of 16-sample shards, a cohort
   of 256, 8 rounds, hashed at N = 1e5 and 1e6 and exact at 1e5: cohort
   rate, ``sample_ms``, overlap, host store MiB, and a device peak at
   most 1.05x the hashed 1e5 run's plus 64 MiB); ``churn_headline``
   (bench.py's ``churn`` leg: the headline streamed + hashed with a 25%
   cohort, 4 rounds plus the first, static then dynamic toward 10x
   growth: finite losses, a grown population, valid v9 records;
   ``churn_overhead_ratio`` and ``population_summary`` printed).
   Then the sweep engine, each fleet through ``run_sweep`` with its counts
   set to 0 just before it and read just after: ``sweep_fleet`` (ResNet-18
   at full width on the flagship's partition, 20 clients, 2 rounds; (a) f32
   model and local state, seeds {0, 1}, chunk 20, and (b) bf16 local
   state, seeds {0, 1} x lr {0.02, 0.01}, chunk 10: each chunk position of
   every experiment one program of 40 models, so each GroupNorm kernel
   launches 20 times per forward and the wgrad kernel 4 times per step as
   on the solo path, and the fleet makes one solo run's training forwards
   and one eval forward per round; each point against its solo run on the
   shared data: (a) ``cohort_hash`` exact and test losses at rtol 1e-4,
   two solo runs of a point bitwise equal, bitwise equality to the fleet
   printed, and round 0's trained rows (the first chunk, before the
   aggregate) bitwise the solo run's, or the first differing leaf named
   in the failure (``FirstTraining``, ``round0_leaves_gate``), (b) the
   ``vmapped`` strategy with one program, the lr-0.02 points at rtol
   2e-3, the lr-0.01 points different; round seconds per experiment beside the solo runs' and the
   peaks printed); ``sweep_scheduled`` (bench.py's ``_sweep_leg``: the MLP,
   32 clients, 6 rounds; an 8-seed fleet against 8 serial solo runs,
   ``sweep_amortization_ratio`` and ``bit_identical`` printed with no
   gate on speed; the 2-hash 8-point scheduled sweep at
   ``compile_reuse_fraction`` 0.875, every history bitwise its solo run's;
   a 4-point sweep crashed after 2 points and resumed from its
   ``sweep_dir``, stitched bitwise, with valid v8 records).
   Then the client-axis mesh across processes (``multihost_fed``):
   ``sweep_fleet``'s ResNet-18 ``fed`` at 20 clients, chunk 10, bf16
   local state, 2 rounds, ``span_trace='on'``, no size-aware schedule, launched as two ranks on
   ``cuda:0`` through the CLI's ``main`` (``--multihost true
   --coordinator_address 127.0.0.1:<port> --num_processes 2 --process_id
   r --mesh_devices 2``: one solo chunk a rank, a gloo group) and, after
   them, once as one process without a mesh. Both ranks must exit 0
   within their
   timeout (else both are killed), report CUDA params and the backend
   gloo, hold bitwise equal global params after every round, launch the
   GroupNorm and wgrad kernels, with their training launches summing to
   the solo run's and each rank's eval launches equal to the solo run's
   (every rank evaluates the global model); round 0's params must equal
   the solo run's bitwise or at rtol 1e-6 and the later test losses be
   within rtol 2e-3; process 1's clock offset must be within its
   uncertainty + 5 ms; a one-process ``mesh_devices=2`` on the one card
   must raise the shortfall ValueError. Prints each rank's round seconds
   beside the solo run's, the bytes and seconds of the gathers per round
   and each rank's peak memory.
   Then streamed residency across processes (``multihost_stream``, the
   distributed shard store): ResNet-18 ``fed`` at full width on the
   flagship's partition, 40 clients, a hashed half cohort, momentum 0.9
   with ``reset_client_optimizer=False`` (persistent state: both exchange
   directions), seed 1, chunk 10, f32 local state (the config refuses
   persistent state beside bf16 compute), 2 rounds, a checkpoint every
   round and span journals on, launched as two ranks on ``cuda:0``
   (``--client_residency streamed --multihost true ... --mesh_devices 2``:
   each rank owns 20 clients and trains its 10 cohort rows as one chunk)
   and, after them and one at a time, once as one streamed process
   without a mesh at the ranks' chunk size (both checkpointing every
   round) and as the witness: one streamed process handed each cohort in the ranks'
   owner-grouped rows, ``draw_pos`` keeping every
   client's keys (``--owner-order=2``), which moves only the row order, so
   the aggregate's summation order, against the one-process run. Both
   ranks must exit 0 within their
   timeout (else both are killed), hold bitwise equal global params and
   test metrics after every round and report the cohort hashes of the
   one-process run; in round 0 (every client trains from the same model,
   so only the aggregate's summation order may move) their params must be
   within 1e-6 of the largest of the one-process run's, their test loss
   and accuracy within rtol 1e-4, and each rank's shard must hold the
   one-process run's state rows of its clients bitwise; every row of
   round 1's per-client state, as each rank's forward exchange hands it to
   the round, must be bitwise the one-process run's round-0 checkpoint
   row of that client (one exchanged row at least, of a client that
   trained in round 0); their params and test metrics must equal the
   witness's bit for bit every round; in round 1 the test loss within
   rtol 1e-3 of the one-process run and the accuracy within two test
   samples (f32 ResNet training at this lr amplifies the rounding of the
   summation order: the witness's spread, printed beside the ranks');
   each rank's training
   launches of both GroupNorm kernels and the wgrad kernel must be the
   count its block predicts (rounds x steps x chunks of its 10 rows x 20
   or 4), its eval launches the one-process run's; every round must leave
   a manifest and one shard a rank. Prints
   the spill rows and exchanged bytes each round, each rank's
   ``dcn_wait`` and ``dcn`` seconds and barrier skew, each rank's round
   seconds beside the one-process run's and each rank's peak memory.
   While ``multihost_stream``'s witness runs (nothing reads its round
   seconds), SIGTERM under multi-process runs (``multihost_preempt``, the
   JAX package's preemption block; the mechanism is on the host, so the
   tiny MLP on ``cuda:0``): two gloo ranks of the CLI, streamed over the
   distributed shard store (a hashed half cohort, momentum state, a
   checkpoint every 2 rounds) and resident (``fed``, pipelined, a cadence
   of 5), all runs at once, with robustness/chaos.py's SIGTERM hook
   after round 0: streamed on both ranks and on rank 0 alone, resident on
   rank 0 alone (the CPU tests hold every case). Every signalled rank
   must exit 0 within 150 s and log the JAX package's text once:
   streamed, the sharded text with nothing written off the cadence (no
   ``round_0.manifest.json``, no shard); resident, process 0's forced
   ``round_N.ckpt`` (the directory's only file) and process 1's "no
   checkpoint_dir configured" text. Once a run's signalled ranks are out,
   its other rank (waiting in a collective) is killed.
3. A profiler pass per algorithm (5 clients, 1 round; 2 before the
   ``multihost_preempt`` phase) and one of the headline (10 clients, 1
   round): device busy time, idle share, and the
   host operators with the most self time. Then the batched layers alone
   (``vmap_layers``): a training step at chunks of 1, 8 and 40, and the
   Shapley eval forward of M = 1, 4, 10, 16 subset models vmapped against
   M one-model forwards (at M = 16 also under cuDNN's autotuner), with
   device time and the layout copies' (``aten::copy_``) share at chunk 40
   and M = 16. Then an end-to-end A/B
   of the batched layouts (``layout_ab``): ``fed`` and multi-round Shapley
   with the port's vmap rules, with GroupNorm always folding the models
   into its batch, and with functorch's own convolution rule in place of
   ops/conv.py's, each once in the order A B C after a run of ``fed``
   that is not kept. Each phase's wall seconds are logged and kept.
4. Prints the kernels' JSON line, the card's name and power limit, and as
   its last line ``{"ok": true, "device": {...}}``.

Every phase runs with functorch's per-example fallback disabled
(``engine.no_vmap_fallback``): an op without a batching rule under
``torch.func.vmap`` raises instead of looping over the chunk.

Imports nothing of JAX or of the JAX package. Points ``$DLS_DATA_DIR``
into DIR, so every path trains on the deterministic dataset surrogates and
nothing outside the checkout is read; each surrogate is built once a run
and handed to every run that asks for it (``shared_datasets``). Writes
its full numbers to
``DIR/chip_smoke.json`` (default ``build/chip_smoke``, which .gitignore
lists).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
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
FLAGSHIP_CHUNK = 40  # examples/resnet18_noniid_1000.sh's client_chunk_size
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
    "conv3x3_wgrad bf16 (25, 32, 32, 64), mma.sync kernel": 0.0136,
    "conv3x3_wgrad bf16 (40, 25, 32, 32, 64), mma.sync kernel": 0.2740,
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


def grouped_wgrad(torch, x, g):
    """cuDNN's weight-only convolution_backward of the grouped convolution
    the vmapped model runs on ``x, g [n, B, H, W, C]`` (the clients as n
    groups of C channels, channels-last): a yardstick, never the port's
    path. Returns the call."""
    n, b, h, w, c = x.shape
    xg = x.permute(1, 2, 3, 0, 4).reshape(b, h, w, n * c).permute(0, 3, 1, 2)
    gg = g.permute(1, 2, 3, 0, 4).reshape(b, h, w, n * c).permute(0, 3, 1, 2)
    weight = torch.zeros(n * c, c, 3, 3, dtype=x.dtype, device=x.device).to(
        memory_format=torch.channels_last)
    return lambda: torch.ops.aten.convolution_backward(
        gg, xg, weight, None, [1, 1], [1, 1], [1, 1], False, [0, 0], n,
        [False, True, False])[1]


def wgrad_bound(row, ops_per_s):
    """``row`` with its bound: the larger of its bytes over the card's
    memory rate and its operations over ``ops_per_s``, and which."""
    t_bytes = row["bytes"] / HBM_BYTES_PER_S
    t_ops = row["ops"] / ops_per_s
    row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


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
        # yardstick (one group).
        elem = x.element_size()
        row = wgrad_bound({
            "shape": list(shape), "dtype": name,
            "ms": time_ms(torch, lambda: wg.conv3x3_wgrad(x, g)),
            "eager_ms": eager_ms(torch, lambda: wg.conv3x3_wgrad(x, g)),
            "plain_ms": time_ms(torch, lambda: wg.conv3x3_wgrad_plain(x, g)),
            "library_ms": time_ms(torch, grouped_wgrad(torch, x[None],
                                                       g[None])),
            "bytes": 2 * b * h * w * c * elem + 9 * c * c * 4,
            "ops": 2 * 9 * c * c * b * h * w,
            "max_abs_err": err, "bf16_ulps": ulp,
        }, BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32_OPS_PER_S)
        log(f"wgrad {name} {shape}: {row['ms']:.4f} ms (eager "
            f"{row['eager_ms']:.4f}, bound {row['bound_ms']:.4f} by "
            f"{row['bound_by']}, plain {row['plain_ms']:.4f}, cuDNN wgrad "
            f"{row['library_ms']:.4f}); max abs err {err:.2e} "
            f"({err / scale:.2e} of max), {ulp:.2f} bf16 ulp")
        rows[name] = row
    return rows


def check_wgrad_sass(_build):
    """Phase 1c: the bf16 wgrad kernel must run on Hopper's warpgroup
    tensor-core products. Counts HGMMA (wgmma) and HMMA (mma.sync)
    instructions in each partial kernel's SASS (cuobjdump; the bf16
    kernel once per layout it is built for) and fails unless every bf16
    instantiation has HGMMA."""
    proc = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass", _build.LIB_PATHS["wgrad"]],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        fail(f"cuobjdump -sass failed: {proc.stderr.strip()[:500]}")
    counts = {}
    for section in proc.stdout.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        for kernel in ("wgrad_tc_kernel", "wgrad_f32_partial_kernel"):
            if kernel in name:
                # wgrad_tc_kernel<kStages, kWalk>: ILi<stages>ELb<walk>E
                args = re.search(r"ILi(\d+)ELb([01])E", name)
                layout = args and ("walk" if args[2] == "1" else "few")
                key = kernel + (f"<{args[1]}, {layout}>" if args else "")
                counts[key] = {
                    op: len(re.findall(rf"\b{op}\b", section))
                    for op in ("HGMMA", "HMMA")}
    tc = {k: v for k, v in counts.items() if k.startswith("wgrad_tc_kernel")}
    if not tc or not all(v["HGMMA"] for v in tc.values()):
        fail(f"no wgmma (HGMMA) in a bf16 wgrad kernel's SASS: {counts}")
    log(f"SASS tensor-core instructions per kernel: {counts}")
    return counts


#: Client counts of phase 1d's wgrad invariance check: one client, the
#: few-client layout's range, the f32 sweep fleet's 20 models a seed, the
#: flagship's chunk of 40 and the 4-seed f32 fleet's 80.
WGRAD_CLIENT_COUNTS = (1, 4, 10, 20, 40, 80)
WGRAD_F32_CHUNK = 20  # sweep_fleet f32's models a program for one seed


def check_wgrad_invariance(torch, wg, gen):
    """Phase 1d: the wgrad kernel at every N of ``WGRAD_CLIENT_COUNTS``, bf16
    in each of its layouts and f32: each client's dW must be bitwise its
    one-client call's (so its row at every other N), and the one-client
    calls within the tolerance of the plain version. Times each bf16
    layout at each N beside cuDNN's grouped weight gradient, and the f32
    kernel at the sweep fleet's chunk of ``WGRAD_F32_CHUNK`` beside cuDNN's
    f32 grouped weight gradient with TF32 off; returns the rows."""
    layouts = {"few": wg.FEW, "walk": wg.WALK}
    n_max = max(WGRAD_CLIENT_COUNTS)
    out = {"layout_ms": {}, "cudnn_ms": {}}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        x = torch.randn((n_max,) + WGRAD_SHAPE, device="cuda",
                        generator=gen).to(dtype)
        g = torch.randn((n_max,) + WGRAD_SHAPE, device="cuda",
                        generator=gen).to(dtype)
        ones = torch.stack([wg.conv3x3_wgrad(x[i], g[i])
                            for i in range(n_max)])
        for n in WGRAD_CLIENT_COUNTS:
            xn, gn_ = x[:n].contiguous(), g[:n].contiguous()
            runs = {"plan": wg.conv3x3_wgrad(xn, gn_)}
            if dtype == torch.bfloat16:
                runs.update({k: wg._launch(xn, gn_, layout=v)
                             for k, v in layouts.items()})
            for layout, k in runs.items():
                if not torch.equal(k, ones[:n]):
                    bad = [i for i in range(n) if not torch.equal(k[i],
                                                                  ones[i])]
                    fail(f"wgrad {name} at N = {n} ({layout} layout): "
                         f"clients {bad[:8]} differ from their one-client "
                         "calls")
        p = wg.conv3x3_wgrad_plain(x, g)
        err = (ones - p).abs().max().item()
        scale = p.abs().max().item()
        ulp = wgrad_ulps(torch, wg, x, g, ones, p)
        if not (math.isfinite(err) and err <= 1e-4 * scale and ulp <= 1.0):
            fail(f"wgrad {name} one-client calls of {n_max} clients: max abs "
                 f"err {err:.3e} (1e-4 * max {1e-4 * scale:.3e}), {ulp:.2f} "
                 "bf16 ulps")
        out[f"{name}_max_abs_err"] = err
        if dtype == torch.bfloat16:
            for n in WGRAD_CLIENT_COUNTS:
                xn, gn_ = x[:n].contiguous(), g[:n].contiguous()
                out["layout_ms"][n] = {
                    k: time_ms(torch, lambda v=v: wg._launch(xn, gn_,
                                                             layout=v),
                               iters=5)
                    for k, v in layouts.items()}
                out["cudnn_ms"][n] = time_ms(torch,
                                             grouped_wgrad(torch, xn, gn_),
                                             iters=5)
        else:
            n = WGRAD_F32_CHUNK
            xn, gn_ = x[:n].contiguous(), g[:n].contiguous()
            b, h, w, c = WGRAD_SHAPE
            cudnn = torch.backends.cudnn
            with cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                             deterministic=cudnn.deterministic,
                             allow_tf32=False):
                library_ms = time_ms(torch, grouped_wgrad(torch, xn, gn_),
                                     iters=3)
            out["f32_chunk"] = wgrad_bound({
                "shape": [n, b, h, w, c], "dtype": "f32",
                "ms": time_ms(torch, lambda: wg.conv3x3_wgrad(xn, gn_),
                              iters=3),
                "plain_ms": time_ms(
                    torch, lambda: wg.conv3x3_wgrad_plain(xn, gn_), iters=3),
                "library_ms": library_ms,
                "bytes": 2 * n * b * h * w * c * 4 + n * 9 * c * c * 4,
                "ops": 2 * 9 * c * c * n * b * h * w,
            }, F32_OPS_PER_S)
        del x, g, ones, p
    f = out["f32_chunk"]
    log(f"wgrad: every client's dW bitwise its one-client call's at N = "
        f"{WGRAD_CLIENT_COUNTS}, bf16 in every layout and f32; max abs err "
        f"of the one-client calls against plain bf16 "
        f"{out['bf16_max_abs_err']:.2e}, f32 {out['f32_max_abs_err']:.2e}")
    log("wgrad bf16 ms by N and layout (planned: "
        + ", ".join(f"{n} {wg.chunking(*WGRAD_SHAPE, n).layout}"
                    for n in WGRAD_CLIENT_COUNTS) + "): "
        + "; ".join(f"N={n} " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in row.items())
                    + f", cuDNN grouped {out['cudnn_ms'][n]:.4f}"
                    for n, row in out["layout_ms"].items()))
    log(f"wgrad f32 {tuple(f['shape'])}: {f['ms']:.4f} ms (bound "
        f"{f['bound_ms']:.4f} by {f['bound_by']} at the 67 TFLOP/s f32 "
        f"rate, plain {f['plain_ms']:.4f}, cuDNN f32 grouped wgrad with "
        f"TF32 off {f['library_ms']:.4f})")
    return out


def check_batched(torch, gn, wg):
    """Phase 1d: the kernels at the batched shapes of the main path, the
    flagship's chunk of 40 clients (module docstring), and the wgrad
    kernel's invariance to the client count; returns the rows."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    n = FLAGSHIP_CHUNK
    b, h, w, c = WGRAD_SHAPE
    x = torch.randn((n,) + WGRAD_SHAPE, device="cuda",
                    generator=gen).bfloat16()
    g = torch.randn((n,) + WGRAD_SHAPE, device="cuda",
                    generator=gen).bfloat16()
    k = wg.conv3x3_wgrad(x, g)
    plan = wg.chunking(b, h, w, c, n)
    torch.cuda.synchronize()
    if not all(torch.equal(k[i], wg.conv3x3_wgrad(x[i], g[i]))
               for i in range(n)):
        fail(f"batched wgrad {tuple(x.shape)} is not bitwise equal to {n} "
             "one-client calls")
    p = wg.conv3x3_wgrad_plain(x, g)
    err = (k - p).abs().max().item()
    scale = p.abs().max().item()
    ulp = wgrad_ulps(torch, wg, x, g, k, p)
    if not (math.isfinite(err) and err <= 1e-4 * scale and ulp <= 1.0):
        fail(f"batched wgrad {tuple(x.shape)}: max abs err {err:.3e} "
             f"(1e-4 * max {1e-4 * scale:.3e}), {ulp:.2f} bf16 ulps")
    cudnn = grouped_wgrad(torch, x, g)
    # [n*co, ci, dy, dx] -> [n, dy, dx, ci, co]
    lib = cudnn().float().reshape(n, c, c, 3, 3).permute(0, 3, 4, 2, 1)
    grid = plan.tc_grid(plan.layout)
    wrow = wgrad_bound({
        "shape": [n, b, h, w, c], "dtype": "bf16", "n_runs": plan.n_runs,
        "layout": plan.layout, "ctas": grid[0] * grid[1] * grid[2],
        "ms": time_ms(torch, lambda: wg.conv3x3_wgrad(x, g)),
        "eager_ms": eager_ms(torch, lambda: wg.conv3x3_wgrad(x, g)),
        "plain_ms": time_ms(torch, lambda: wg.conv3x3_wgrad_plain(x, g),
                            iters=3),
        "library_ms": time_ms(torch, cudnn, iters=5),
        "library_max_abs_diff": (lib - p).abs().max().item(),
        # The one-client path: n calls of one client each.
        "one_client_calls_ms": time_ms(
            torch, lambda: [wg.conv3x3_wgrad(x[i], g[i]) for i in range(n)],
            iters=3),
        "bytes": 2 * n * b * h * w * c * 2 + n * 9 * c * c * 4,
        "ops": 2 * 9 * c * c * n * b * h * w,
        "max_abs_err": err, "bf16_ulps": ulp,
    }, BF16_OPS_PER_S)
    log(f"batched wgrad {tuple(x.shape)} bf16 (layout {plan.layout}, "
        f"{plan.n_runs} runs a client, {wrow['ctas']} CTAs): "
        f"{wrow['ms']:.4f} ms (eager {wrow['eager_ms']:.4f}, bound "
        f"{wrow['bound_ms']:.4f} by {wrow['bound_by']}, "
        f"{wrow['bound_ms'] / wrow['ms']:.3f} of it; plain "
        f"{wrow['plain_ms']:.4f}, cuDNN grouped wgrad "
        f"{wrow['library_ms']:.4f}, {n} one-client calls "
        f"{wrow['one_client_calls_ms']:.4f}); bitwise equal to the "
        f"one-client calls; max abs err {err:.2e}, {ulp:.2f} bf16 ulp")
    invariance = check_wgrad_invariance(torch, wg, gen)

    m, rows_per = n, TRAIN_BATCH
    norm_rows = []
    for hw, c, per_forward in STAGES:
        rows = m * rows_per
        x = (torch.randn(rows, hw, c, device="cuda", generator=gen) * 2
             + 1.5).bfloat16()
        scale = torch.randn(m, c, device="cuda", generator=gen).bfloat16()
        bias = torch.randn(m, c, device="cuda", generator=gen).bfloat16()
        mean_p, rstd_p = gn.gn_stats_plain(x, GROUPS, EPS)
        y_k = gn.gn_normalize(x, mean_p, rstd_p, scale, bias, torch.bfloat16)
        y_p = gn.gn_normalize_plain(x, mean_p, rstd_p, scale, bias,
                                    torch.bfloat16)
        per_model = all(
            torch.equal(y_k[i * rows_per:(i + 1) * rows_per], gn.gn_normalize(
                x[i * rows_per:(i + 1) * rows_per],
                mean_p[i * rows_per:(i + 1) * rows_per],
                rstd_p[i * rows_per:(i + 1) * rows_per],
                scale[i], bias[i], torch.bfloat16))
            for i in range(m))
        if not (per_model and torch.equal(y_k, y_p)):
            fail(f"gn_normalize at {(rows, hw, c)} with a [{m}, {c}] affine:"
                 f" bitwise per-model {per_model}, plain "
                 f"{torch.equal(y_k, y_p)}")
        mean_k, rstd_k = gn.gn_stats(x, GROUPS, EPS)
        stats_err = 0.0
        for name, kk, pp in (("mean", mean_k, mean_p),
                             ("rstd", rstd_k, rstd_p)):
            rel = ((kk - pp).abs() / pp.abs().clamp(min=1e-30)).max().item()
            if not rel <= 1e-5:
                fail(f"gn_stats {name} at {(rows, hw, c)}: max rel err "
                     f"{rel:.3e} > 1e-5")
            stats_err = max(stats_err, (kk - pp).abs().max().item())
        side = int(math.isqrt(hw))
        x4 = x.view(rows, side, side, c)
        # The yardstick: each model's GroupNorm in one F.group_norm call,
        # the models on the channel side ([B, M*C, H, W] channels-last,
        # M*G groups, the M affines flattened to [M*C]).
        x_wide = (x.view(m, rows_per, hw, c).permute(1, 2, 0, 3)
                  .reshape(rows_per, side, side, m * c).permute(0, 3, 1, 2))
        library_ms = time_ms(torch, lambda: torch.nn.functional.group_norm(
            x_wide, m * GROUPS, scale.reshape(-1), bias.reshape(-1), EPS))
        x_bytes = rows * hw * c * 2
        stat_bytes = 2 * rows * GROUPS * 4
        row = {
            "shape": [rows, hw, c], "models": m, "per_forward": per_forward,
            "stats": {
                "ms": time_ms(torch, lambda: gn.gn_stats(x, GROUPS, EPS)),
                "plain_ms": time_ms(
                    torch, lambda: gn.gn_stats_plain(x, GROUPS, EPS)),
                "bytes": x_bytes + stat_bytes, "ops": 3 * rows * hw * c,
                "max_abs_err": stats_err, "library_ms": library_ms,
            },
            "normalize": {
                "ms": time_ms(torch, lambda: gn.gn_normalize(
                    x, mean_k, rstd_k, scale, bias, torch.bfloat16)),
                "plain_ms": time_ms(torch, lambda: gn.gn_normalize_plain(
                    x, mean_k, rstd_k, scale, bias, torch.bfloat16)),
                "bytes": 2 * x_bytes + stat_bytes + 2 * m * c * 2,
                "ops": 4 * rows * hw * c, "max_abs_err": 0.0,
                "library_ms": library_ms,
            },
            "pair_ms": time_ms(torch, lambda: gn.group_norm(
                x4, scale, bias, GROUPS, EPS, torch.bfloat16)),
        }
        for key in ("stats", "normalize"):
            r = row[key]
            t_bytes = r["bytes"] / HBM_BYTES_PER_S
            t_ops = r["ops"] / F32_OPS_PER_S
            r["bound_ms"] = 1e3 * max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"batched GN {(rows, hw, c)} with a [{m}, {c}] bf16 affine: "
            f"stats {row['stats']['ms']:.4f} ms (bound "
            f"{row['stats']['bound_ms']:.4f}, plain "
            f"{row['stats']['plain_ms']:.4f}); normalize "
            f"{row['normalize']['ms']:.4f} ms (bound "
            f"{row['normalize']['bound_ms']:.4f}, plain "
            f"{row['normalize']['plain_ms']:.4f}); pair {row['pair_ms']:.4f}"
            f" ms; F.group_norm over the models on the channel side "
            f"{library_ms:.4f} ms; normalize bitwise equal to the per-model "
            "calls and the plain version")
        norm_rows.append(row)
    return {"wgrad": wrow, "wgrad_invariance": invariance, "gn": norm_rows,
            "channel_side": check_channel_side(torch, gn, gen)}


#: Models on the channel side that the paths give the GroupNorm: the
#: Shapley batches of 10 and 16 subset models, a chunk of up to 32 clients
#: (the remainder of a cohort, a bucketed group, a client_eval chunk).
CHANNEL_SIDE_MODELS = (10, 16, 32)


def check_channel_side(torch, gn, gen):
    """Phase 1d, continued: the GroupNorm kernels where ``group_norm``'s
    vmap rule reads the models on the channel side (ops/gn_cuda.py
    ``channel_side``): x ``[B, HW, M*C]`` with M*G groups and the M
    affines flattened to ``[M*C]``, for M in ``CHANNEL_SIDE_MODELS`` at
    every stage where M*C fits a kernel row, at B=25 and B=1000, in bf16
    and f32 (C or G not a power of two takes the stats kernel's general
    branch). Stats within rtol 1e-5 of the plain version, and of M
    per-model calls; normalize bitwise equal to its plain version and, on
    the same statistics, to M per-model calls with ``[C]`` affines;
    ``group_norm`` bitwise equal to the two kernels called alone."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        width = gn._THREADS * (16 // torch.tensor([], dtype=dtype)
                               .element_size())
        for hw, c, _ in STAGES:
            for m, b in ((m, b) for m in CHANNEL_SIDE_MODELS
                         for b in (TRAIN_BATCH, EVAL_BATCH)):
                if m * c > width:
                    continue
                shape, g = (b, hw, m * c), m * GROUPS
                side = int(math.isqrt(hw))
                x = (torch.randn(shape, device="cuda", generator=gen) * 2
                     + 1.5).to(dtype)
                scale = torch.randn(m, c, device="cuda",
                                    generator=gen).to(dtype)
                bias = torch.randn(m, c, device="cuda",
                                   generator=gen).to(dtype)
                sf, bf = scale.reshape(-1), bias.reshape(-1)
                mean_k, rstd_k = gn.gn_stats(x, g, EPS)
                mean_p, rstd_p = gn.gn_stats_plain(x, g, EPS)
                y_k = gn.gn_normalize(x, mean_k, rstd_k, sf, bf, dtype)
                y_p = gn.gn_normalize_plain(x, mean_k, rstd_k, sf, bf, dtype)
                y_pair, mean_pair, rstd_pair = gn.group_norm(
                    x.view(b, side, side, m * c), sf, bf, g, EPS, dtype)
                stats_err = 0.0
                for name, kk, pp in (("mean", mean_k, mean_p),
                                     ("rstd", rstd_k, rstd_p)):
                    rel = ((kk - pp).abs() / pp.abs().clamp(min=1e-30)
                           ).max().item()
                    if not rel <= 1e-5:
                        fail(f"gn_stats {name} at {shape} {dtype}, {g} "
                             f"groups: max rel err {rel:.3e} > 1e-5")
                    stats_err = max(stats_err, (kk - pp).abs().max().item())
                model_rel = 0.0
                for k in range(m):
                    cols, grp = slice(k * c, (k + 1) * c), slice(
                        k * GROUPS, (k + 1) * GROUPS)
                    xk = x[:, :, cols].contiguous()
                    mk, rk = gn.gn_stats(xk, GROUPS, EPS)
                    for kk, wide in ((mk, mean_k), (rk, rstd_k)):
                        model_rel = max(model_rel, (
                            (kk - wide[:, grp]).abs()
                            / kk.abs().clamp(min=1e-30)).max().item())
                    yk = gn.gn_normalize(
                        xk, mean_k[:, grp].contiguous(),
                        rstd_k[:, grp].contiguous(), scale[k], bias[k],
                        dtype)
                    if not torch.equal(yk, y_k[:, :, cols]):
                        fail(f"gn_normalize at {shape} {dtype}: model {k} "
                             "differs from its own call with a [C] affine")
                if not model_rel <= 1e-5:
                    fail(f"gn_stats at {shape} {dtype}: per-model calls off "
                         f"by rtol {model_rel:.3e} > 1e-5")
                pair_equal = (torch.equal(y_pair.view(shape), y_k)
                              and torch.equal(mean_pair, mean_k)
                              and torch.equal(rstd_pair, rstd_k))
                if not (torch.equal(y_k, y_p) and pair_equal):
                    fail(f"GroupNorm at {shape} {dtype}, {g} groups: "
                         f"normalize vs plain {torch.equal(y_k, y_p)}, "
                         f"group_norm vs its kernels {pair_equal}")
                rows.append({"shape": list(shape), "models": m,
                             "dtype": str(dtype).split(".")[-1],
                             "stats_max_abs_err": stats_err,
                             "per_model_stats_rel": model_rel})
                del x, y_k, y_p, y_pair
                torch.cuda.empty_cache()
    log(f"GroupNorm with the models on the channel side: {len(rows)} shapes "
        "(M in " + ", ".join(map(str, CHANNEL_SIDE_MODELS)) + ", B = 25 and "
        "1000, bf16 and f32): stats within rtol 1e-5 of plain and of the "
        "per-model calls (worst "
        f"{max(r['per_model_stats_rel'] for r in rows):.2e}); normalize and "
        "group_norm bitwise equal to plain, to the per-model calls and to "
        "the two kernels alone")
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


def chunk_steps(config, n_train: int) -> int:
    """The most chunk-steps (vmapped training forwards) ``config`` can
    run: rounds x epochs x steps of the largest shard x chunks of the
    cohort. A client-by-client loop would run about chunk times more."""
    slots = config.max_shard_size or -(-n_train // config.worker_number)
    cohort = config.cohort_size()
    chunk = config.client_chunk_size or cohort
    return (config.round * config.epoch * -(-slots // config.batch_size)
            * -(-cohort // chunk))


@contextlib.contextmanager
def shared_datasets():
    """Inside the block, a ``get_dataset`` call of the port (run_simulation's,
    the threaded oracle's, the sweep engine's, this script's) with arguments
    it has had before returns the arrays of the first build, in a new
    ``Dataset``: the 50000-sample cifar10 surrogate takes seconds of numpy
    a build, and many runs ask for the same one. The arrays are made
    read-only, so a run that wrote to them would raise instead of handing
    the next run other data. Yields the builds by their arguments."""
    import threading

    from distributed_learning_simulator_tpu_torch import (
        simulator,
        simulator_heterogeneous,
    )
    from distributed_learning_simulator_tpu_torch.data import registry
    from distributed_learning_simulator_tpu_torch.execution import threaded
    from distributed_learning_simulator_tpu_torch.sweep import engine

    build = registry.get_dataset
    built = {}
    lock = threading.Lock()

    def get_dataset(name, data_dir=None, seed=0, n_train=None, n_test=None,
                    to_grayscale=False, **synthetic_kwargs):
        key = (name, data_dir, seed, n_train, n_test, to_grayscale,
               repr(sorted(synthetic_kwargs.items())))
        with lock:
            if key not in built:
                ds = build(name, data_dir=data_dir, seed=seed,
                           n_train=n_train, n_test=n_test,
                           to_grayscale=to_grayscale, **synthetic_kwargs)
                for f in ("x_train", "y_train", "x_test", "y_test"):
                    getattr(ds, f).flags.writeable = False
                built[key] = ds
            return dataclasses.replace(built[key])

    modules = (registry, simulator, simulator_heterogeneous, threaded,
               engine)
    for m in modules:
        m.get_dataset = get_dataset
    try:
        yield built
    finally:
        for m in modules:
            m.get_dataset = build


def run_path(torch, gn, wg, name, config, post_round_probe=None,
             gn_per_forward=GN_PER_FORWARD, wgrad_per_step=WGRAD_PER_STEP,
             setup_logging=False, n_train=None, keep_params=False,
             extra_rounds=0, dataset=None, client_data=None):
    """Phase 2: one main path through run_simulation, with every launch
    count set to 0 just before it and read just after; each GroupNorm
    kernel must launch ``gn_per_forward`` times per model forward and the
    wgrad kernel ``wgrad_per_step`` times per training step (ResNet-18's
    20 and 4; 0 and 0 for a model without GroupNorm). With
    ``post_round_probe`` (a list), each round's post_round is wrapped and
    appends its forwards, GroupNorm launches and seconds to it (the
    Shapley subset evaluations); such a run, or one with
    ``setup_logging``, writes its artifacts under ``config.log_root``.
    The training forwards must be at most :func:`chunk_steps` (``n_train``
    defaults to ``config.n_train``; ``extra_rounds`` rounds of training
    more, such as the valuation audit's replay). Keeps the run's peak
    device memory; ``keep_params`` returns the final global model too.
    ``dataset`` and ``client_data`` are run_simulation's injection points
    (a sweep point's solo run on the sweep's shared data)."""
    from distributed_learning_simulator_tpu_torch import factory
    from distributed_learning_simulator_tpu_torch.algorithms import shapley
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
    evaluator = shapley._SubsetEvaluator
    original_accuracies = evaluator._accuracies
    batches = []  # models per vmapped subset evaluation, this round
    if post_round_probe is not None:
        def probed(self, ctx):
            torch.cuda.synchronize()
            before = (forwards["eval"], gn.gn_stats.launches,
                      gn.gn_normalize.launches, time.perf_counter())
            batches.clear()
            out = original(self, ctx)
            torch.cuda.synchronize()
            post_round_probe.append({
                "forwards": forwards["eval"] - before[0],
                "gn_stats": gn.gn_stats.launches - before[1],
                "gn_normalize": gn.gn_normalize.launches - before[2],
                "seconds": time.perf_counter() - before[3],
                "models": sum(batches), "model_batches": len(batches),
                "most_models_per_batch": max(batches, default=0),
            })
            return out

        def counted(self, models, eval_batches):
            batches.append(int(models.shape[0]))
            return original_accuracies(self, models, eval_batches)

        cls.post_round = probed
        evaluator._accuracies = counted
    gn.reset_launch_counts()
    wg.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hook = torch.nn.modules.module.register_module_forward_hook(count)
    try:
        result = run_simulation(
            config, dataset=dataset, client_data=client_data,
            setup_logging=setup_logging or post_round_probe is not None)
    finally:
        hook.remove()
        cls.post_round = original
        evaluator._accuracies = original_accuracies
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated()
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
    bound = chunk_steps(config, n_train or config.n_train) * (
        config.round + extra_rounds) // config.round
    if forwards["train"] > bound:
        fail(f"{name}: {forwards['train']} training forwards, more than the "
             f"{bound} chunk-steps of chunk {config.client_chunk_size}: the "
             "clients did not train a chunk at a time")
    seconds = [rec["round_seconds"] for rec in history]
    log(f"{name}: {forwards} forwards (at most {bound} chunk-steps), "
        f"launches {launches}, round seconds {seconds}, "
        f"{result['client_rounds_per_sec']:.2f} client-rounds/s, test_loss "
        f"{[rec['test_loss'] for rec in history]}, peak device memory "
        f"{peak_bytes / 2**30:.2f} GiB")
    out = {
        "forwards": forwards, "launches": launches, "round_seconds": seconds,
        "client_rounds_per_sec": result["client_rounds_per_sec"],
        "history": history, "result_keys": sorted(result),
        "chunk_steps_bound": bound, "peak_memory_bytes": peak_bytes,
        "telemetry": {k: result[k] for k in (
            "telemetry_level", "post_warmup_compiles", "clients_flagged")},
    }
    if result["client_residency"] == "streamed":
        out["stream"] = {k: result[k] for k in STREAM_KEYS}
    if result["population_summary"] is not None:
        out["population_summary"] = result["population_summary"]
    if keep_params:
        out["global_params"] = result["global_params"]
    return out


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
                   gn_per_forward=0, wgrad_per_step=0, setup_logging=True,
                   n_train=50000)
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


def compare_chunks(torch, gn, wg):
    """Phase 2d: one ``fed`` round of ResNet-18 at full width, f32 model
    and local state, 8 clients with no size-aware schedule (so the chunk
    size changes nothing but how many clients train at once), at chunk 1
    and at chunk 4, each through run_path's gates; the global models must
    agree at rtol 1e-4 / atol 1e-5 and the test losses at rtol 1e-4. Each
    client takes one step (25 samples): over several steps training
    amplifies f32 noise (on the CPU a 1e-7 relative change of a narrow
    ResNet's start grew to 4.5% of its update in 4 steps at lr 0.02), and
    the comparison is of the batched gradients, not of that growth."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )

    runs = {}
    for chunk in (1, 4):
        config = ExperimentConfig(
            dataset_name="cifar10", model_name="resnet18",
            distributed_algorithm="fed", worker_number=8, round=1, epoch=1,
            batch_size=25, partition="dirichlet", dirichlet_alpha=0.1,
            max_shard_size=25, bucket_client_work=False,
            client_chunk_size=chunk, learning_rate=0.02, momentum=0.9,
            local_compute_dtype="float32", model_args={"dtype": "float32"},
            n_train=800, n_test=1000, eval_batch_size=1000,
            log_level="WARNING", device="cuda")
        runs[chunk] = run_path(torch, gn, wg, f"fed_f32_chunk{chunk}",
                               config, keep_params=True)
    flat = {k: torch.cat([v.float().reshape(-1) for _, v in
                          sorted(r.pop("global_params").items())])
            for k, r in runs.items()}
    diff = (flat[4] - flat[1]).abs()
    worst = (diff / (1e-5 + 1e-4 * flat[1].abs())).max().item()
    losses = [runs[k]["history"][0]["test_loss"] for k in (1, 4)]
    if not (worst <= 1.0 and abs(losses[1] - losses[0])
            <= 1e-4 * abs(losses[0])):
        fail(f"fed at chunk 4 vs chunk 1: global model off by {worst:.2f} x "
             f"(1e-5 + 1e-4 |p|), test losses {losses}")
    log(f"fed f32 at chunk 4 vs chunk 1: global model max abs diff "
        f"{diff.max().item():.3e} ({worst:.3f} of the tolerance), test "
        f"losses {losses}; round seconds {runs[1]['round_seconds']} at "
        f"chunk 1, {runs[4]['round_seconds']} at chunk 4")
    return {"runs": runs, "max_abs_diff": diff.max().item(),
            "tolerance_share": worst, "test_losses": losses}


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
    * the Shapley paths: each round's post_round ran one vmapped forward
      per eval batch for each batch of subset models (at most
      ``shapley_eval_chunk``, or GTG's 16-prefix block), and launched
      exactly 20 of each GroupNorm kernel per such forward; multiround
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
                # One vmapped forward per eval batch for each batch of
                # subset models, never one per model.
                n_batches = -(-min(config.shapley_eval_samples
                                   or config.n_test, config.n_test)
                              // config.eval_batch_size)
                most = max(config.shapley_eval_chunk, 16)
                if (probe["forwards"] != n_batches * probe["model_batches"]
                        or probe["most_models_per_batch"] > most):
                    fail(f"{name} round {rec['round']}: {probe['forwards']} "
                         f"subset forwards for {probe['model_batches']} "
                         f"batches of models ({n_batches} eval batches), at "
                         f"most {probe['most_models_per_batch']} models a "
                         "batch")
                probe["evals_per_s"] = (probe["models"] / probe["seconds"]
                                        if probe["seconds"] else None)
            artifacts = _newest_artifacts(config)
            if name == "multiround_shapley_value":
                for rec, probe in zip(history, probes):
                    with open(os.path.join(
                            artifacts, f"metric_{rec['round']}.pkl"),
                            "rb") as f:
                        utilities = pickle.load(f)
                    if probe["models"] != 16 or len(utilities) != 16:
                        fail(f"{name} round {rec['round']}: "
                             f"{probe['models']} subset models, "
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


def robustness_configs(work: str):
    """The configurations of the robustness phases (ResNet-18 at full width
    on the cifar10 surrogate, cut like the main paths: Dirichlet(0.1),
    shard cap 100, batch 25, 5000 train and 2000 test samples):

    * ``fedopt_dropout``: 50 clients, chunk 40, bf16 local state, 3 rounds,
      client adamw (lr 1e-3, weight decay 1e-4) and FedAdam (server adam,
      lr 1e-2), dropout at 0.2 with correlation 0.5 and a quorum of 30,
      a checkpoint every round, the last 2 kept;
    * ``fedavgm_reject``: 20 clients, f32 local state, SGD momentum 0.9,
      FedAvgM (server sgd, lr 1.0, momentum 0.9), corrupt_nan at 0.3 under
      the plain mean, 3 rounds;
    * ``crash_resume``: ``fedopt_dropout`` cut to 20 clients, chunk 10 and
      a quorum of 12."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )

    common = dict(
        dataset_name="cifar10", model_name="resnet18",
        distributed_algorithm="fed", epoch=1, batch_size=25,
        partition="dirichlet", dirichlet_alpha=0.1, max_shard_size=100,
        n_train=5000, n_test=2000, eval_batch_size=1000, round=3,
        log_level="WARNING", device="cuda")
    fedopt = dict(
        common, worker_number=50, client_chunk_size=40,
        local_compute_dtype="bfloat16", optimizer_name="adamw",
        learning_rate=1e-3, weight_decay=1e-4, server_optimizer_name="adam",
        server_learning_rate=1e-2, failure_mode="dropout",
        failure_prob=0.2, failure_correlation=0.5, min_survivors=30,
        checkpoint_dir=os.path.join(work, "fedopt_dropout_ckpt"),
        checkpoint_every=1, checkpoint_keep_last=2)
    crash = dict(fedopt, worker_number=20, client_chunk_size=10,
                 min_survivors=12, checkpoint_dir=None, checkpoint_every=0,
                 checkpoint_keep_last=None)
    return {
        "fedopt_dropout": ExperimentConfig(**fedopt),
        "fedavgm_reject": ExperimentConfig(
            **common, worker_number=20, client_chunk_size=40,
            local_compute_dtype="float32", learning_rate=0.02,
            momentum=0.9, server_optimizer_name="sgd",
            server_learning_rate=1.0, server_momentum=0.9,
            failure_mode="corrupt_nan", failure_prob=0.3,
            aggregation="mean"),
        "crash_resume": ExperimentConfig(**crash),
    }


def run_fedopt_dropout(torch, gn, wg, config):
    """Phase 2e: ``fedopt_dropout`` through run_path (counts from 0, 20
    GroupNorm launches per forward, 4 wgrad launches per training step, so
    neither is 0), with its own gates: every record reports its survivors
    and the quorum verdict, and the run leaves exactly its last 2
    checkpoints on disk. Prints round seconds, peak memory, survivors per
    round, and each checkpoint's write seconds and bytes."""
    from distributed_learning_simulator_tpu_torch import simulator

    saves = []
    original = simulator.save_checkpoint

    def timed(path, *args, **kwargs):
        start = time.perf_counter()
        out = original(path, *args, **kwargs)
        saves.append({"path": os.path.basename(path),
                      "seconds": time.perf_counter() - start,
                      "bytes": os.path.getsize(path)})
        return out

    simulator.save_checkpoint = timed
    try:
        res = run_path(torch, gn, wg, "fedopt_dropout", config)
    finally:
        simulator.save_checkpoint = original
    history = res["history"]
    survivors = [rec.get("survivor_count") for rec in history]
    if None in survivors or any("round_rejected" not in r for r in history):
        fail(f"fedopt_dropout: records lack the quorum fields {survivors}")
    left = sorted(f for f in os.listdir(config.checkpoint_dir)
                  if f.endswith(".ckpt"))
    if len(saves) != config.round or left != [
            f"round_{r}.ckpt" for r in range(config.round - 2, config.round)]:
        fail(f"fedopt_dropout: {len(saves)} checkpoint writes, {left} kept")
    if not all(res["launches"].values()):
        fail(f"fedopt_dropout: a kernel never launched {res['launches']}")
    res.update(survivors=survivors,
               rejected=[rec["round_rejected"] for rec in history],
               checkpoints=saves)
    log(f"fedopt_dropout: round seconds {res['round_seconds']}, peak "
        f"device memory {res['peak_memory_bytes'] / 2**30:.2f} GiB, "
        f"survivors {survivors} (quorum {config.min_survivors}), rejected "
        f"{res['rejected']}, checkpoint seconds "
        f"{[round(c['seconds'], 3) for c in saves]} of "
        f"{saves[-1]['bytes'] / 2**20:.1f} MiB each, launches "
        f"{res['launches']}")
    return res


def _same_tree(a, b) -> bool:
    """Bitwise equality of two tensors or dicts of tensors (None allowed)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_tree(a[k], b[k]) for k in a)
    if a is None or b is None:
        return a is b
    return bool(a.shape == b.shape and a.dtype == b.dtype
                and (a.view(-1) == b.view(-1)).all())


def _clone_tree(t):
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    return None if t is None else t.clone()


def run_fedavgm_reject(torch, gn, wg, config):
    """Phase 2f: ``fedavgm_reject`` through run_path. The server update is
    wrapped to keep, every round, the global params and the server momentum
    before and after it; the phase fails unless a round was rejected and,
    for every rejected round, both after equal both before, bitwise."""
    from distributed_learning_simulator_tpu_torch.algorithms.fedavg import (
        FedAvg,
    )

    events = []
    original = FedAvg.make_server_update

    def watched(self):
        init, update = original(self)

        def update_watched(prev, aggregate, state, rejected=None):
            before = (prev.clone(), _clone_tree(state))
            new, new_state = update(prev, aggregate, state, rejected)
            events.append({
                "rejected": bool(rejected),
                "params_unchanged": _same_tree(new, before[0]),
                "momentum_unchanged": _same_tree(new_state, before[1]),
            })
            return new, new_state

        return init, update_watched

    FedAvg.make_server_update = watched
    try:
        res = run_path(torch, gn, wg, "fedavgm_reject", config)
    finally:
        FedAvg.make_server_update = original
    rejected = [rec.get("round_rejected") for rec in res["history"]]
    if rejected != [e["rejected"] for e in events] or not any(rejected):
        fail(f"fedavgm_reject: rejected rounds {rejected}, server updates "
             f"{events}")
    for rec, event in zip(res["history"], events):
        if event["rejected"] and not (event["params_unchanged"]
                                      and event["momentum_unchanged"]):
            fail(f"fedavgm_reject round {rec['round']}: rejected, but "
                 f"{event}")
    res["server_updates"] = events
    log(f"fedavgm_reject: survivors "
        f"{[rec['survivor_count'] for rec in res['history']]}, rejected "
        f"{rejected}; every rejected round kept the global params and the "
        "server momentum bitwise; round seconds "
        f"{res['round_seconds']}")
    return res


def _flat_params(torch, params) -> "torch.Tensor":
    return torch.cat([v.float().reshape(-1) for _, v in
                      sorted(params.items())])


def _nondeterministic_ops(torch, config) -> list[str]:
    """The ops PyTorch names as nondeterministic while one training round
    of ``config`` runs with ``use_deterministic_algorithms(warn_only)``
    (a diagnostic run whose numbers are not kept)."""
    import dataclasses
    import warnings

    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_simulation(dataclasses.replace(config, round=1),
                           setup_logging=False)
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have a deterministic")[0]
                   for w in caught if "deterministic" in str(w.message)})


def crash_resume(torch, gn, wg, config, work: str):
    """Phase 2g: ``crash_resume``. The configuration runs straight twice in
    this process while a child process runs it with a checkpoint every
    round and is killed with SIGKILL right after round 1; it is then
    resumed here, and the stitched history and final params are compared
    with the straight runs. If the
    two straight runs are bitwise equal, the stitched run must be too;
    if not, the stitched run must differ from the first straight run by
    no more than twice what the second does, and the phase prints the
    largest difference and the ops PyTorch names as nondeterministic. A
    second child, at the same time, gets SIGTERM after round 1's record (no
    checkpoint cadence): it must exit 0 with ``preempted_at`` the round in
    flight and that round's final checkpoint on disk. Without a cadence the
    child's rounds are pipelined, so round 1 is recorded after round 2's
    dispatch, and round 2 is the one in flight."""
    import dataclasses

    from distributed_learning_simulator_tpu_torch.robustness import (
        chaos_resume as chaos,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    cfg = dataclasses.replace(
        config, log_root=os.path.join(work, "crash_resume", "log"),
        checkpoint_dir=os.path.join(work, "crash_resume", "ckpt"),
        checkpoint_every=1)
    term = dataclasses.replace(
        cfg, log_root=os.path.join(work, "crash_sigterm", "log"),
        checkpoint_dir=os.path.join(work, "crash_sigterm", "ckpt"),
        checkpoint_every=0)
    # The two children (each pays its own start-up and the init replay) run
    # while this process runs the straight ones.
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        kill_leg = pool.submit(chaos.run_crashed_subprocess, cfg, 1,
                               "sigkill", timeout=600)
        term_leg = pool.submit(chaos.run_crashed_subprocess, term, 1,
                               "sigterm", timeout=600)
        gn.reset_launch_counts()
        wg.reset_launch_counts()
        straight = []
        for _ in range(2):
            res = run_simulation(config, setup_logging=False)
            straight.append((chaos.normalize(res["history"]),
                             _flat_params(torch, res["global_params"])))
        launches = {"gn_stats": gn.gn_stats.launches,
                    "gn_normalize": gn.gn_normalize.launches,
                    "conv3x3_wgrad": wg.conv3x3_wgrad.launches}
        proc, term_proc = kill_leg.result(), term_leg.result()
    child_seconds = time.perf_counter() - start
    if not all(launches.values()):
        fail(f"crash_resume: a kernel never launched {launches}")
    if proc.returncode != -9:
        fail(f"crash_resume: the SIGKILL child exited {proc.returncode}: "
             f"{proc.stderr[-1500:]}")
    crashed = chaos.read_metrics_jsonl(cfg.log_root)
    resumed = run_simulation(dataclasses.replace(cfg, resume=True),
                             setup_logging=False)
    stitched_params = _flat_params(torch, resumed["global_params"])
    verdict = chaos.stitch_and_compare(straight[0][0], crashed,
                                       chaos.normalize(resumed["history"]))
    if verdict.get("resume_start_round") != 2:
        fail(f"crash_resume: resumed at {verdict}")
    (hist_a, params_a), (hist_b, params_b) = straight
    straight_equal = hist_a == hist_b and torch.equal(params_a, params_b)
    stitched = [r for r in crashed if r["round"] < 2] + chaos.normalize(
        resumed["history"])

    def loss_gap(h):
        return max(abs(x["test_loss"] - y["test_loss"])
                   for x, y in zip(hist_a, h))

    gaps = {
        "straight_params": (params_b - params_a).abs().max().item(),
        "straight_test_loss": loss_gap(hist_b),
        "stitched_params": (stitched_params - params_a).abs().max().item(),
        "stitched_test_loss": loss_gap(stitched),
    }
    out = {"straight_bitwise_equal": straight_equal, "verdict": verdict,
           "gaps": gaps, "children_and_straight_seconds": child_seconds,
           "launches_two_straight_runs": launches}
    if straight_equal:
        if not (verdict["bit_identical"]
                and torch.equal(stitched_params, params_a)):
            fail(f"crash_resume: the straight runs are bitwise equal but "
                 f"the stitched run is not: {verdict}, {gaps}")
    else:
        ops = _nondeterministic_ops(torch, config)
        out["nondeterministic_ops"] = ops
        for what in ("params", "test_loss"):
            if gaps[f"stitched_{what}"] > 2 * gaps[f"straight_{what}"]:
                fail(f"crash_resume: stitched {what} off by "
                     f"{gaps[f'stitched_{what}']:.3e}, beyond twice the "
                     f"straight runs' {gaps[f'straight_{what}']:.3e}")
        log(f"crash_resume: the two straight runs differ (largest params "
            f"difference {gaps['straight_params']:.3e}, test loss "
            f"{gaps['straight_test_loss']:.3e}); ops named nondeterministic: "
            f"{ops}")
    # The SIGTERM leg: finish the round, write the final checkpoint, exit 0.
    proc = term_proc
    child = (json.loads(proc.stdout.strip().splitlines()[-1])
             if proc.returncode == 0 and proc.stdout.strip() else {})
    left = (sorted(os.listdir(term.checkpoint_dir))
            if os.path.isdir(term.checkpoint_dir) else [])
    in_flight = 1 + int(term.pipeline_rounds)
    if (proc.returncode != 0 or child.get("preempted_at") != in_flight
            or f"preempted at round {in_flight}" not in proc.stderr
            or left != [f"round_{in_flight}.ckpt"]):
        fail(f"crash_resume: SIGTERM child exited {proc.returncode}, "
             f"result {child}, checkpoints {left}: {proc.stderr[-1500:]}")
    out["sigterm"] = {"preempted_at": child["preempted_at"],
                      "checkpoints": left}
    log(f"crash_resume: straight runs bitwise equal: {straight_equal}; "
        f"SIGKILL after round 1 then resume: stitched history "
        f"bit-identical {verdict['bit_identical']}, largest params "
        f"difference {gaps['stitched_params']:.3e}; SIGTERM child exited 0, "
        f"preempted_at {child['preempted_at']}, checkpoints {left}")
    return out


def gn_autodiff(torch, gn, wg):
    """Phase 2h: one chunk-40 training step of ResNet-18 at full width in
    bf16 (25 samples a client, the models a seeded perturbation of the
    replayed init), with ``gn_custom_backward`` False and True, after one
    warm-up step each. The losses (the forward) must be bitwise equal, the
    gradients within 2**-8 of the largest gradient element (bf16 keeps 8
    significant bits, so two roundings of one gradient differ by up to a
    step of that size, 3.9e-3 relative), and the launch counts of every
    kernel equal in both; prints the largest difference (also as a share
    of the largest element, against 1e-3), the relative L2 difference and
    each step's ms (median of 3)."""
    from distributed_learning_simulator_tpu_torch.models.bridge import (
        jax_leaf_order,
    )
    from distributed_learning_simulator_tpu_torch.models.registry import (
        ParamLayout,
        get_model,
        init_params,
    )
    from distributed_learning_simulator_tpu_torch.parallel.engine import (
        make_loss_fn,
    )

    m, b, hw = FLAGSHIP_CHUNK, TRAIN_BATCH, (32, 32)
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.rand((m, b) + hw + (3,), device="cuda", generator=gen)
    y = torch.randint(0, 10, (m, b), device="cuda", generator=gen)
    mask = torch.ones(m, b, device="cuda")
    stack = None
    out = {}
    for custom in (True, False):
        model = get_model("resnet18", num_classes=10, input_shape=hw + (3,),
                          gn_custom_backward=custom).cuda()
        params = init_params(model, hw, seed=0)
        layout = ParamLayout.from_params(params,
                                         jax_leaf_order(model, hw))
        if stack is None:
            flat = layout.flatten(params).cuda()
            stack = (flat + 0.01 * torch.randn(
                (m,) + flat.shape, device="cuda", generator=gen)
                     ).to(torch.bfloat16)
        loss = make_loss_fn(lambda f, xx, model=model, layout=layout:
                            torch.func.functional_call(
                                model, layout.unflatten(f), (xx,)))
        step = torch.func.vmap(torch.func.grad_and_value(loss,
                                                         has_aux=True))
        step(stack, x, y, mask)
        torch.cuda.synchronize()
        gn.reset_launch_counts()
        wg.reset_launch_counts()
        grads, (losses, _) = step(stack, x, y, mask)
        torch.cuda.synchronize()
        launches = {"gn_stats": gn.gn_stats.launches,
                    "gn_normalize": gn.gn_normalize.launches,
                    "conv3x3_wgrad": wg.conv3x3_wgrad.launches}
        times = []
        for _ in range(3):
            start = time.perf_counter()
            step(stack, x, y, mask)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - start))
        out[custom] = {"grads": grads.float(), "losses": losses,
                       "launches": launches,
                       "step_ms": statistics.median(times)}
        del model, step
    want, got = out[True]["grads"], out[False]["grads"]
    largest = want.abs().max().item()
    max_diff = (got - want).abs().max().item()
    rel_l2 = ((got - want).norm() / want.norm()).item()
    forward_equal = torch.equal(out[True]["losses"], out[False]["losses"])
    if not forward_equal:
        fail("gn_autodiff: the losses of the two backward choices differ")
    if not max_diff <= 2.0 ** -8 * largest:
        fail(f"gn_autodiff: gradients differ by {max_diff:.3e}, beyond "
             f"2**-8 of the largest element {largest:.3e}")
    if out[True]["launches"] != out[False]["launches"] or not all(
            out[False]["launches"].values()):
        fail(f"gn_autodiff: launches {out[True]['launches']} with the "
             f"closed form, {out[False]['launches']} with autodiff")
    res = {"forward_bitwise_equal": forward_equal,
           "grad_max_abs_diff": max_diff, "grad_largest": largest,
           "grad_rel_l2": rel_l2,
           "launches": out[False]["launches"],
           "step_ms": {"custom_backward": out[True]["step_ms"],
                       "autodiff": out[False]["step_ms"]}}
    side = "within" if max_diff <= 1e-3 * largest else "beyond"
    log(f"gn_autodiff: chunk-40 bf16 step, forward bitwise equal; gradients "
        f"max abs diff {max_diff:.3e} ({max_diff / largest:.2e} of the "
        f"largest {largest:.3e}: {side} 1e-3, within 2**-8; relative L2 "
        f"{rel_l2:.2e}); launches per step "
        f"{res['launches']} in both; step ms {res['step_ms']}")
    return res


def _schema():
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           SCHEMA)) as f:
        return json.load(f)


def _check_records(name, records, schema, version):
    """Every record valid against the checked-in schema at ``version``."""
    for rec in records:
        errs = schema_errors(rec, schema)
        if errs or rec.get("schema_version") != version:
            fail(f"{name} round {rec['round']}: schema_version "
                 f"{rec.get('schema_version')} (expected {version}), "
                 f"invalid against {SCHEMA}: {errs[:3]}")


TELEMETRY_PHASES = {"client_step", "eval", "host_sync", "post_round"}


def telemetry_fed(torch, gn, wg, log_root, plain):
    """Phase 2i: the ``fed`` main path (ResNet-18 at full width, 50 clients,
    chunk 40, bf16 local state, cut like the main paths) for 3 rounds with
    ``telemetry_level='basic'`` and ``client_stats='on'``, through run_path.
    Fails unless no round after the first counts a compile
    (``post_warmup_compiles`` 0), round 0's ``compiled`` names
    ``round_fn``, every metrics.jsonl record validates at schema_version 3
    with ``phase_seconds`` holding client_step, eval, host_sync and
    post_round and a positive ``peak_hbm_bytes``. Prints its round seconds
    beside ``plain``'s (the same path without telemetry in this call).
    Then one round at ``telemetry_level='detailed'``: prints the per-phase
    split and fails unless the phases sum to no more than the round's
    seconds."""
    import dataclasses

    base = dataclasses.replace(
        path_configs(50, 5000, 2000, "INFO")["fed"], round=3,
        telemetry_level="basic", client_stats="on", log_root=log_root)
    res = run_path(torch, gn, wg, "telemetry_fed", base, setup_logging=True)
    with open(os.path.join(_newest_artifacts(base), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if records != res["history"]:
        fail("telemetry_fed: metrics.jsonl differs from the history")
    _check_records("telemetry_fed", records, _schema(), 3)
    if res["telemetry"]["post_warmup_compiles"] != 0:
        fail(f"telemetry_fed: post_warmup_compiles "
             f"{res['telemetry']['post_warmup_compiles']}")
    if "round_fn" not in records[0]["telemetry"].get("compiled", []):
        fail(f"telemetry_fed: round 0 compiled "
             f"{records[0]['telemetry'].get('compiled')}, no round_fn")
    for rec in records:
        tel = rec["telemetry"]
        if not TELEMETRY_PHASES <= set(tel["phase_seconds"]):
            fail(f"telemetry_fed round {rec['round']}: phases "
                 f"{sorted(tel['phase_seconds'])}")
        if not tel.get("peak_hbm_bytes", 0) > 0:
            fail(f"telemetry_fed round {rec['round']}: peak_hbm_bytes "
                 f"{tel.get('peak_hbm_bytes')}")
    detailed = run_path(
        torch, gn, wg, "telemetry_fed_detailed", dataclasses.replace(
            base, round=1, telemetry_level="detailed", client_stats="off"))
    (rec,) = detailed["history"]
    split = rec["telemetry"]["phase_seconds"]
    if sum(split.values()) > rec["round_seconds"]:
        fail(f"telemetry_fed_detailed: phases {split} sum beyond the "
             f"round's {rec['round_seconds']} s")
    res["detailed"] = {"phase_seconds": split,
                       "round_seconds": rec["round_seconds"]}
    res["plain_round_seconds"] = plain["round_seconds"]
    res["phase_seconds"] = [r["telemetry"]["phase_seconds"]
                            for r in records]
    res["compiled_round0"] = records[0]["telemetry"]["compiled"]
    log(f"telemetry_fed: round seconds {res['round_seconds']} with basic "
        f"telemetry and client stats, {plain['round_seconds']} for the "
        f"plain fed path (main_paths, this call); compiled in round 0: "
        f"{res['compiled_round0']}; post-warmup compiles 0; phases "
        f"{res['phase_seconds']}; peak_hbm_bytes "
        f"{[r['telemetry']['peak_hbm_bytes'] for r in records]}; "
        f"clients flagged {res['telemetry']['clients_flagged']}")
    log(f"telemetry_fed_detailed: round {rec['round_seconds']:.3f} s, "
        f"phases {split}")
    return res


def client_stats_detect(torch, gn, wg):
    """Phase 2j: the detector against the failure model on the card:
    ResNet-18 at full width, 20 clients (chunk 20), f32 local state, lr
    0.02, momentum 0.9, 2 rounds, median aggregation, cut like the main
    paths, once under ``corrupt_scale`` and once under ``corrupt_nan`` at
    ``failure_prob`` 0.2. Each round's flagged ids must equal the ids the
    failure model corrupted (replayed here from the key chain), every
    reason ``update_norm`` (respectively ``non_finite``)."""
    import dataclasses

    import numpy as np

    from distributed_learning_simulator_tpu_torch.algorithms.fedavg import (
        round_key_splits,
    )
    from distributed_learning_simulator_tpu_torch.ops import prng
    from distributed_learning_simulator_tpu_torch.robustness.faults import (
        FailureModel,
    )

    base = dataclasses.replace(
        path_configs(20, 5000, 2000, "WARNING")["fed"], round=2,
        client_chunk_size=20, local_compute_dtype="float32",
        aggregation="median", failure_prob=0.2, client_stats="on")
    out = {}
    for mode, reason in (("corrupt_scale", "update_norm"),
                         ("corrupt_nan", "non_finite")):
        config = dataclasses.replace(base, failure_mode=mode)
        res = run_path(torch, gn, wg, f"client_stats_{mode}", config)
        fm = FailureModel.from_config(config)
        key = prng.key(config.seed + 1)
        rounds = []
        for rec in res["history"]:
            key, round_key = prng.split(key)
            injected = np.flatnonzero(fm.draw_failed(
                round_key_splits(round_key, True)[4],
                config.worker_number)).tolist()
            cs = rec["client_stats"]
            if cs["flagged_clients"] != injected or any(
                    r != reason for r in cs["flag_reason"].values()):
                fail(f"client_stats_{mode} round {rec['round']}: flagged "
                     f"{cs['flag_reason']}, injected {injected}")
            rounds.append({"injected": injected,
                           "flag_reason": cs["flag_reason"]})
        out[mode] = {"rounds": rounds, "round_seconds": res["round_seconds"],
                     "launches": res["launches"]}
        log(f"client_stats_{mode}: flagged = injected in every round "
            f"{[r['injected'] for r in rounds]} ({reason}); round seconds "
            f"{res['round_seconds']}")
    return out


def threaded_config(algo: str, n_clients: int, model: str, **changes):
    """An oracle run's configuration, cut like the main paths."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )

    kw = dict(
        dataset_name="cifar10", model_name=model, distributed_algorithm=algo,
        worker_number=n_clients, round=2, epoch=1, batch_size=25,
        partition="dirichlet", dirichlet_alpha=0.1, max_shard_size=100,
        n_train=5000, n_test=2000, eval_batch_size=1000,
        learning_rate=0.02, momentum=0.9, local_compute_dtype="float32",
        execution_mode="threaded", log_level="WARNING", device="cuda")
    kw.update(changes)
    return ExperimentConfig(**kw)


@contextlib.contextmanager
def queue_probe():
    """Times the native queue's traffic while the oracle runs: each
    upload's pickling and enqueue (its bytes too), each worker's wait in
    ``get_result`` (the rendezvous), and the time a worker spent between
    receiving a model and uploading (its training, the device-to-host copy
    of the upload included). Yields the dict of lists it fills."""
    import pickle
    import threading

    from distributed_learning_simulator_tpu_torch.runtime.native import (
        NativeTaskQueue,
    )

    stats = {"pickle_s": [], "enqueue_s": [], "bytes": [], "wait_s": [],
             "train_s": []}
    lock = threading.Lock()
    mark = threading.local()
    original_add, original_get = (NativeTaskQueue.add_task,
                                  NativeTaskQueue.get_result)

    def add_task(self, obj):
        t0 = time.perf_counter()
        payload = pickle.dumps(obj)
        t1 = time.perf_counter()
        if self._lib.dlsq_add_task(self._q, payload, len(payload)) != 0:
            raise RuntimeError("queue is stopped")
        t2 = time.perf_counter()
        with lock:
            stats["pickle_s"].append(t1 - t0)
            stats["enqueue_s"].append(t2 - t1)
            stats["bytes"].append(len(payload))
            if getattr(mark, "got", None) is not None:
                stats["train_s"].append(t0 - mark.got)

    def get_result(self):
        t0 = time.perf_counter()
        out = original_get(self)
        mark.got = time.perf_counter()
        with lock:
            stats["wait_s"].append(mark.got - t0)
        return out

    NativeTaskQueue.add_task, NativeTaskQueue.get_result = add_task, get_result
    try:
        yield stats
    finally:
        NativeTaskQueue.add_task = original_add
        NativeTaskQueue.get_result = original_get


def _median(xs):
    return statistics.median(xs) if xs else None


def run_threaded(torch, gn, wg, name, config):
    """One oracle run with every launch count set to 0 just before it and
    read just after, under :func:`queue_probe`; returns the result, its
    launches, the queue's numbers and the run's peak device memory."""
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    gn.reset_launch_counts()
    wg.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with queue_probe() as queue:
        result = run_simulation(config, setup_logging=True)
    torch.cuda.synchronize()
    launches = {"gn_stats": gn.gn_stats.launches,
                "gn_normalize": gn.gn_normalize.launches,
                "conv3x3_wgrad": wg.conv3x3_wgrad.launches}
    history = result["history"]
    if len(history) != config.round or not all(
            math.isfinite(r["test_accuracy"]) for r in history):
        fail(f"{name}: {len(history)} records of {config.round}, "
             f"accuracies {[r['test_accuracy'] for r in history]}")
    return {"result": result, "launches": launches, "queue": queue,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "round_seconds": [r["round_seconds"] for r in history],
            "history": history}


#: ``threaded_fed``'s clients, a thread each. The oracle's rounds are
#: host-bound: every client adds seconds to a run that must end within
#: its time limit.
THREADED_FED_CLIENTS = 4


def threaded_fed(torch, gn, wg, log_root):
    """Phase 2k: the threaded oracle on ResNet-18 at full width, f32,
    ``THREADED_FED_CLIENTS`` clients (a thread each), 2 rounds,
    ``telemetry_level='basic'``, ``client_stats='on'``. Fails unless both GroupNorm kernels and the
    wgrad kernel launched during the run, every record validates at
    schema_version 3, and a second identical run gives bitwise-equal
    final params and the same history. Prints round seconds, the upload's
    pickled bytes and pickling / enqueue seconds, each worker's training
    and rendezvous-wait seconds, and peak memory."""
    import dataclasses

    config = threaded_config("fed", THREADED_FED_CLIENTS, "resnet18",
                             telemetry_level="basic",
                             client_stats="on", log_root=log_root)
    runs = [run_threaded(torch, gn, wg, "threaded_fed", config)]
    if not all(runs[0]["launches"].values()):
        fail(f"threaded_fed: launches {runs[0]['launches']}")
    with open(os.path.join(_newest_artifacts(config), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if records != runs[0]["history"]:
        fail("threaded_fed: metrics.jsonl differs from the history")
    _check_records("threaded_fed", records, _schema(), 3)
    runs.append(run_threaded(torch, gn, wg, "threaded_fed (again)",
                             dataclasses.replace(config)))
    same_params = _same_tree(runs[0]["result"]["global_params"],
                             runs[1]["result"]["global_params"])

    def kept(h):
        return [{k: v for k, v in r.items()
                 if k not in ("round_seconds", "telemetry")} for r in h]

    if not (same_params and kept(runs[0]["history"])
            == kept(runs[1]["history"])):
        fail("threaded_fed: two identical runs differ (params bitwise "
             f"equal: {same_params})")
    q = runs[0]["queue"]
    res = {k: runs[0][k] for k in ("launches", "peak_memory_bytes",
                                   "round_seconds", "history")}
    res.update({
        "second_round_seconds": runs[1]["round_seconds"],
        "xla_compiles": runs[0]["result"]["xla_compiles"],
        "upload_bytes": _median(q["bytes"]),
        "pickle_s_median": _median(q["pickle_s"]),
        "enqueue_s_median": _median(q["enqueue_s"]),
        "train_s_median": _median(q["train_s"]),
        "wait_s_median": _median(q["wait_s"]),
        "queue": q, "bitwise_equal_runs": True,
    })
    log(f"threaded_fed: {THREADED_FED_CLIENTS} clients on threads, round "
        f"seconds "
        f"{res['round_seconds']} (again: {res['second_round_seconds']}), "
        f"launches {res['launches']}, upload {res['upload_bytes']} bytes "
        f"pickled in {res['pickle_s_median']:.4f} s and enqueued in "
        f"{res['enqueue_s_median']:.4f} s (medians), a worker's training "
        f"{res['train_s_median']:.3f} s and rendezvous wait "
        f"{res['wait_s_median']:.3f} s (medians), peak device memory "
        f"{res['peak_memory_bytes'] / 2**30:.2f} GiB; two runs bitwise "
        "equal")
    return res


THREADED_ALGOS = {
    "sign_SGD": dict(learning_rate=0.001),
    "fed_quant": dict(quant_levels=256),
    "multiround_shapley_value": {},
    "GTG_shapley_value": {},
}


def threaded_algos(torch, gn, wg, log_root):
    """Phase 2l: sign_SGD, fed_quant and both Shapley algorithms (N=4)
    through the oracle on ``cnn_tpu``, 4 clients, 1 round each, cut like the
    main paths: each must finish with a finite accuracy and one record a
    round. Prints sign_SGD's per-step vote rendezvous time (a worker's wait
    for the vote)."""
    out = {}
    for algo, changes in THREADED_ALGOS.items():
        config = threaded_config(algo, 4, "cnn_tpu", round=1,
                                 log_root=log_root, **changes)
        res = run_threaded(torch, gn, wg, f"threaded_{algo}", config)
        q = res["queue"]
        out[algo] = {
            "round_seconds": res["round_seconds"],
            "test_accuracy": [r["test_accuracy"] for r in res["history"]],
            "messages": len(q["bytes"]), "upload_bytes": _median(q["bytes"]),
            "wait_s_median": _median(q["wait_s"]),
        }
        log(f"threaded_{algo}: round seconds {res['round_seconds']}, test "
            f"accuracy {out[algo]['test_accuracy']}, {len(q['bytes'])} "
            f"uploads of {out[algo]['upload_bytes']} bytes, median wait in "
            f"get_result {out[algo]['wait_s_median']:.4f} s"
            + (" (the per-step vote rendezvous)" if algo == "sign_SGD"
               else ""))
    return out


def _plain_record(rec: dict) -> dict:
    """A record without its timings: what two runs of one configuration
    must agree on bitwise."""
    return {k: v for k, v in rec.items()
            if k not in ("round_seconds", "telemetry", "spans")}


def valuation_fed(torch, gn, wg, log_root):
    """Phase 2m: ``valuation_fed``. The ``fed`` main path (50 clients, cut
    like the main paths, without the size-aware schedule: the audit replays
    a round on whole shards, as the JAX package's does) for 3 rounds with
    ``client_stats='on'``, ``client_valuation='on'``,
    ``valuation_audit_every=2`` and ``valuation_audit_permutations=4``,
    through run_path's launch gates (the audit's replay and subset
    evaluations are model forwards too). Fails unless every record
    validates at schema_version 7, round 2 carries an ``audit`` with
    finite Spearman and Pearson correlations, the GroupNorm and wgrad
    kernels launched inside the audit, and the replayed uploads' update
    norms match round 2's client-stats ``update_norm`` at rtol 1e-4.
    Prints the audit's wall seconds and subset evals/s beside the round
    seconds."""
    import dataclasses

    import numpy as np

    from distributed_learning_simulator_tpu_torch import simulator
    from distributed_learning_simulator_tpu_torch.telemetry import (
        valuation,
    )

    cfg = dataclasses.replace(
        path_configs(50, 5000, 2000, "INFO")["fed"], round=3,
        client_stats="on", client_valuation="on", valuation_audit_every=2,
        valuation_audit_permutations=4, bucket_client_work=False,
        log_root=log_root)
    stats = {}
    audits = []
    run_audit = valuation.ValuationAuditor.run
    replay = valuation.ValuationAuditor.replay
    detect = simulator.detect_and_record
    norms = []

    def keep_stats(matrix, cs, round_idx, **kw):
        stats[round_idx] = np.asarray(matrix)
        return detect(matrix, cs, round_idx, **kw)

    def replayed(self, round_key, prev_global, *args, **kw):
        stack = replay(self, round_key, prev_global, *args, **kw)
        norms.append(torch.linalg.vector_norm(
            stack - prev_global.float(), dim=1).cpu().numpy())
        return stack

    def probed(self, round_idx, round_key, prev_global, *args, **kw):
        torch.cuda.synchronize()
        before = (gn.gn_stats.launches, gn.gn_normalize.launches,
                  wg.conv3x3_wgrad.launches, time.perf_counter())
        out = run_audit(self, round_idx, round_key, prev_global, *args,
                        **kw)
        torch.cuda.synchronize()
        audits.append({
            "round": round_idx, "record": out,
            "gn_stats": gn.gn_stats.launches - before[0],
            "gn_normalize": gn.gn_normalize.launches - before[1],
            "conv3x3_wgrad": wg.conv3x3_wgrad.launches - before[2],
            "seconds": time.perf_counter() - before[3],
        })
        return out

    simulator.detect_and_record = keep_stats
    valuation.ValuationAuditor.run = probed
    valuation.ValuationAuditor.replay = replayed
    try:
        res = run_path(torch, gn, wg, "valuation_fed", cfg,
                       setup_logging=True, extra_rounds=1)
    finally:
        simulator.detect_and_record = detect
        valuation.ValuationAuditor.run = run_audit
        valuation.ValuationAuditor.replay = replay
    records = res["history"]
    _check_records("valuation_fed", records, _schema(), 7)
    if len(audits) != 1 or audits[0]["round"] != 2:
        fail(f"valuation_fed: audits in rounds "
             f"{[a['round'] for a in audits]} (expected [2])")
    audit = audits[0]
    rec = records[2]["valuation"].get("audit")
    if rec is None or any(
            rec.get(k) is None or not math.isfinite(rec[k])
            for k in ("spearman", "pearson")):
        fail(f"valuation_fed: round 2's audit {rec}")
    if min(audit[k] for k in ("gn_stats", "gn_normalize",
                              "conv3x3_wgrad")) <= 0:
        fail(f"valuation_fed: launches inside the audit {audit}")
    want = stats[2][:, 2]  # the update_norm column
    got = norms[0]
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                       1e-30)))
    if not rel <= 1e-4:
        fail(f"valuation_fed: replayed update norms differ from round 2's "
             f"client stats by {rel:.3e} (rtol 1e-4)")
    res["audit"] = dict(audit)
    res["audit"]["update_norm_rel_err"] = rel
    res["audit"]["subset_evals_per_s"] = (
        rec["subset_evals"] / max(audit["seconds"], 1e-9))
    log(f"valuation_fed: audit {audit['seconds']:.2f} s wall "
        f"({rec['subset_evals']} subset evals, "
        f"{res['audit']['subset_evals_per_s']:.1f} evals/s, "
        f"{rec['permutations']} permutations, spearman {rec['spearman']}, "
        f"pearson {rec['pearson']}) against round seconds "
        f"{res['round_seconds']}; launches inside it: gn_stats "
        f"{audit['gn_stats']}, gn_normalize {audit['gn_normalize']}, "
        f"wgrad {audit['conv3x3_wgrad']}; replayed update norms within "
        f"{rel:.2e} of the round's")
    return res


def spans_fed(torch, gn, wg, log_root):
    """Phase 2n: ``spans_fed``. The ``fed`` main path (50 clients) for 2
    rounds with ``span_trace='on'`` through run_path. Fails unless the
    journal ``spans_0.jsonl`` is written beside metrics.jsonl,
    ``scripts/trace_timeline.py --json`` (a subprocess) summarizes it with
    the round and phase spans, and every record validates at
    schema_version 12."""
    import dataclasses

    cfg = dataclasses.replace(
        path_configs(50, 5000, 2000, "INFO")["fed"], span_trace="on",
        log_root=log_root)
    res = run_path(torch, gn, wg, "spans_fed", cfg, setup_logging=True)
    _check_records("spans_fed", res["history"], _schema(), 12)
    artifacts = _newest_artifacts(cfg)
    journal = os.path.join(artifacts, "spans_0.jsonl")
    if not os.path.exists(journal):
        fail(f"spans_fed: no journal at {journal}")
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "scripts", "trace_timeline.py"),
         artifacts, "--json"], capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        fail(f"spans_fed: trace_timeline.py exited {proc.returncode}: "
             f"{proc.stderr[-500:]}")
    summary = json.loads(proc.stdout)
    by_cat = summary["totals"]["0"]["by_cat"]
    spans = summary["hosts"][0]["spans"]
    if not (by_cat.get("phase", 0) > 0 and by_cat.get("round", 0) > 0
            and spans >= 5 * cfg.round):
        fail(f"spans_fed: trace_timeline.py read {spans} spans, by "
             f"category {by_cat}")
    res["timeline"] = {"spans": spans, "by_cat": by_cat}
    log(f"spans_fed: journal of {spans} spans, by category {by_cat}; "
        f"round seconds {res['round_seconds']}")
    return res


def fitted_efficiency(ledger: dict) -> dict:
    """Fractions of the H100 row's datasheet peaks that a ledger's device
    time reaches: the convolution category's FLOPs over its device time
    against the tensor cores' peak, and every other category's bytes over
    their device time against HBM's (the cost model's
    ``DEFAULT_EFFICIENCY``)."""
    mm = ledger.get("matmul_conv", {})
    rest = [e for c, e in ledger.items() if c != "matmul_conv"]
    rest_s = sum(e["device_ms"] for e in rest) / 1e3
    rest_bytes = sum(e["bytes_gb"] for e in rest) * 2**30
    return {
        "mxu": (mm.get("flops_g", 0.0) * 1e9
                / max(mm.get("device_ms", 0.0) / 1e3, 1e-12)
                / BF16_OPS_PER_S),
        "hbm": rest_bytes / max(rest_s, 1e-12) / HBM_BYTES_PER_S,
    }


def profile_costmodel(torch, gn, wg, work):
    """Phase 2o: ``profile_costmodel``. The ``fed`` main path at 10 clients
    for 3 rounds with ``profile_dir`` set and ``profile_from_round=1`` (a
    2-round window, one profiler window per training step:
    utils/tracing.py), then the same configuration with
    ``cost_model_trace`` reading that directory
    (``cost_model_trace_rounds=2``); prints the profiled run's peak device
    memory beside this unprofiled run's. Fails unless the trace holds
    ``dls::group_norm`` and ``dls::conv3x3_wgrad`` kernels with nonzero
    bytes, the ``matmul_conv`` category has nonzero FLOPs, and the last
    record's v6 ``costmodel`` predicts a finite positive round on
    ``h100-sxm-1``. Prints the ledger's categories (device ms, GB,
    GFLOP), the predicted-to-measured ratio and the fitted
    efficiencies."""
    import dataclasses

    from distributed_learning_simulator_tpu_torch.utils import tracing

    trace_dir = os.path.join(work, "profile")
    shutil.rmtree(trace_dir, ignore_errors=True)
    cfg = dataclasses.replace(
        path_configs(10, 1000, 1000, "WARNING")["fed"], round=3,
        profile_dir=trace_dir, profile_from_round=1)
    t0 = time.perf_counter()
    prof = run_path(torch, gn, wg, "profile_fed", cfg)
    traced_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops = list(tracing.iter_device_ops(trace_dir))
    ledger = tracing.categorize_ops(trace_dir)
    parse_s = time.perf_counter() - t0
    own = {}
    for name in ("dls::group_norm", "dls::conv3x3_wgrad"):
        mine = [o for o in ops if name in o["ops"]]
        own[name] = {"kernels": len(mine),
                     "bytes": sum(o["bytes"] for o in mine),
                     "device_ms": sum(o["dur"] for o in mine) / 1e3}
        if not mine or own[name]["bytes"] <= 0:
            fail(f"profile_costmodel: {name} kernels in the trace: "
                 f"{own[name]}")
    # Each hand-written kernel by name, tied to a launching operator: the
    # normalize kernel is a programmatic dependent launch
    # (cudaLaunchKernelExC), correlated like any other launch.
    by_kernel = {
        k: sum(1 for o in ops if k in o["name"] and o["ops"])
        for k in ("gn_stats_kernel", "gn_normalize_kernel",
                  "wgrad_tc_kernel")
    }
    if min(by_kernel.values()) == 0:
        fail(f"profile_costmodel: kernels tied to an operator {by_kernel}")
    own["kernels_by_name"] = by_kernel
    if not ledger.get("matmul_conv", {}).get("flops_g", 0) > 0:
        fail(f"profile_costmodel: no FLOPs in the convolution category: "
             f"{ledger.get('matmul_conv')}")
    res = run_path(torch, gn, wg, "costmodel_fed", dataclasses.replace(
        cfg, profile_dir=None, cost_model_trace=trace_dir,
        cost_model_trace_rounds=2))
    cm = res["history"][-1].get("costmodel")
    if cm is None or not (math.isfinite(cm["predicted_ms"])
                          and cm["predicted_ms"] > 0
                          and cm["anchor_topology"] == "h100-sxm-1"):
        fail(f"profile_costmodel: last record's costmodel {cm}")
    _check_records("costmodel_fed", res["history"][-1:], _schema(), 6)
    fit = fitted_efficiency(ledger)
    per_round = {c: {k: round(e[k], 4) for k in
                     ("device_ms", "bytes_gb", "flops_g")} | {
                         "op_count": e["op_count"]}
                 for c, e in sorted(ledger.items())}
    out = {"ledger_per_round": per_round, "own_kernels": own,
           "costmodel": cm, "fitted_efficiency": fit,
           "profiled_run_seconds": traced_s, "trace_parse_seconds": parse_s,
           "profiled_round_seconds": prof["round_seconds"],
           "round_seconds": res["round_seconds"],
           "trace_files": len(tracing.trace_files(trace_dir)),
           "profiled_peak_bytes": prof["peak_memory_bytes"],
           "unprofiled_peak_bytes": res["peak_memory_bytes"]}
    log(f"profile_costmodel: peak device memory "
        f"{prof['peak_memory_bytes'] / 2**30:.2f} GiB profiled (2-round "
        f"window, {out['trace_files']} trace files) against "
        f"{res['peak_memory_bytes'] / 2**30:.2f} GiB unprofiled (ratio "
        f"{prof['peak_memory_bytes'] / res['peak_memory_bytes']:.2f})")
    log(f"profile_costmodel: ledger per round {per_round}; own kernels "
        f"{own}; predicted {cm['predicted_ms']} ms against measured "
        f"{cm['measured_ms']} ms (ratio {cm['model_error_ratio']}), "
        f"bottleneck {cm['bottleneck']}; fitted efficiency {fit}; trace "
        f"read in {parse_s:.1f} s")
    return out


def _sync_points(torch, batched):
    """``batched`` (a dispatch of K rounds) under CUDA's synchronization
    check: ``torch.cuda.set_sync_debug_mode`` warns at every synchronizing
    call inside it, and each warning's Python stack is kept in
    ``wrapper.syncs``."""
    import traceback
    import warnings

    def wrapper(*args, **kwargs):
        def keep(message, category, filename, lineno, file=None,
                 line=None):
            # (Enabling the mode warns once that it is a prototype: not a
            # synchronizing call.)
            if "called a synchronizing CUDA operation" in str(message):
                wrapper.syncs.append(
                    f"{message}\n" + "".join(traceback.format_stack(
                        limit=12)[:-1]))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = keep
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return batched(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)

    wrapper.syncs = []
    return wrapper


#: ``round_batch``'s ResNet paths: 20 clients, one chunk of the flagship's
#: 40 (50 clients until the sweep phases came).
ROUND_BATCH_CLIENTS = 20
#: ``round_batch``'s rounds, all in one dispatch (4 until ``pipeline_ab``
#: came).
ROUND_BATCH_ROUNDS = 3


def round_batch(torch, gn, wg, log_root):
    """Phase 2p: ``round_batch``. ``fed`` and ``sign_SGD`` (20 clients in
    one chunk, cut like the main paths) for ``ROUND_BATCH_ROUNDS`` (3)
    rounds at ``rounds_per_dispatch`` 1 and 3:
    the histories (timings aside) and final params must be bitwise equal,
    and no synchronizing CUDA call may run inside the dispatch of 3 rounds
    (the dispatch runs under ``torch.cuda.set_sync_debug_mode``; its one
    metric fetch follows it). Then the headline workload (``cnn_tpu``,
    1000 clients, chunk 250, f32) for 3 rounds at K=3 and K=1 (the
    headline and ``pipeline_ab`` phases paid its first calls): round
    seconds for each, no gate on speed."""
    import dataclasses

    from distributed_learning_simulator_tpu_torch import simulator

    make_batched = simulator.make_batched_round_fn
    dispatches = []

    def checked(*args, **kwargs):
        fn = _sync_points(torch, make_batched(*args, **kwargs))
        dispatches.append(fn)
        return fn

    out = {}
    simulator.make_batched_round_fn = checked
    try:
        paths = path_configs(ROUND_BATCH_CLIENTS, 2000, 2000, "WARNING")
        for name in ("fed", "sign_SGD"):
            cfg = dataclasses.replace(paths[name], round=ROUND_BATCH_ROUNDS)
            one = run_path(torch, gn, wg, f"{name}_k1", cfg,
                           keep_params=True)
            dispatches.clear()
            four = run_path(torch, gn, wg, f"{name}_k4", dataclasses.replace(
                cfg, rounds_per_dispatch=ROUND_BATCH_ROUNDS),
                keep_params=True)
            same_hist = ([_plain_record(r) for r in one["history"]]
                         == [_plain_record(r) for r in four["history"]])
            same_params = _same_tree(one["global_params"],
                                     four["global_params"])
            syncs = [s for d in dispatches for s in d.syncs]
            if not (same_hist and same_params):
                fail(f"round_batch {name}: K={ROUND_BATCH_ROUNDS} differs "
                     f"from K=1 (history "
                     f"equal {same_hist}, params equal {same_params})")
            if syncs:
                fail(f"round_batch {name}: {len(syncs)} synchronizing "
                     f"calls inside a dispatch; the first:\n{syncs[0]}"
                     + "".join(f"\nalso:\n{s}" for s in syncs[1:4]))
            out[name] = {"k1_round_seconds": one["round_seconds"],
                         "batched_round_seconds": four["round_seconds"]}
            log(f"round_batch {name}: K={ROUND_BATCH_ROUNDS} bitwise equal "
                f"to K=1, no "
                f"synchronizing call inside the dispatch; round seconds "
                f"K=1 {one['round_seconds']}, K={ROUND_BATCH_ROUNDS} "
                f"{four['round_seconds']}")
        head = dataclasses.replace(
            headline_config(HEADLINE_CLIENTS, None, None, 10000,
                            log_level="WARNING"), round=ROUND_BATCH_ROUNDS)
        dispatches.clear()
        four = run_path(torch, gn, wg, "headline_k4", dataclasses.replace(
            head, rounds_per_dispatch=ROUND_BATCH_ROUNDS), gn_per_forward=0,
            wgrad_per_step=0, n_train=50000, keep_params=True)
        one = run_path(torch, gn, wg, "headline_k1", head,
                       gn_per_forward=0, wgrad_per_step=0, n_train=50000,
                       keep_params=True)
        out["headline_cnn_tpu"] = {
            "k1_round_seconds": one["round_seconds"],
            "batched_round_seconds": four["round_seconds"],
            "k1_seconds": sum(one["round_seconds"]),
            "batched_seconds": sum(four["round_seconds"]),
            "bitwise_equal": _same_tree(one["global_params"],
                                        four["global_params"]),
            "syncs_in_dispatch": len([s for d in dispatches
                                      for s in d.syncs]),
        }
        log(f"round_batch headline_cnn_tpu: {ROUND_BATCH_ROUNDS} rounds in "
            f"{out['headline_cnn_tpu']['k1_seconds']:.3f} s at K=1 "
            f"({one['round_seconds']}), "
            f"{out['headline_cnn_tpu']['batched_seconds']:.3f} s at "
            f"K={ROUND_BATCH_ROUNDS} "
            f"({four['round_seconds']}); bitwise equal "
            f"{out['headline_cnn_tpu']['bitwise_equal']}, synchronizing "
            f"calls in the dispatch "
            f"{out['headline_cnn_tpu']['syncs_in_dispatch']}")
    finally:
        simulator.make_batched_round_fn = make_batched
    return out


#: ``pipeline_ab``'s rounds: round 0 carries the first calls, so two
#: steady rounds an arm.
PIPELINE_ROUNDS = 3
#: ``pipeline_ab``'s ResNet-18 clients: one chunk of 10 a round. The
#: rounds are host-bound: every chunk-step adds seconds to each of the
#: four arms, in a run that must end within its time limit.
PIPELINE_FED_CLIENTS = 10


def pipeline_ab_configs():
    """``pipeline_ab``'s two paths, ``basic`` telemetry on (the phase
    clocks, no fence): the headline workload and ResNet-18 ``fed`` on
    ``sweep_fleet``'s data (2000 samples, Dirichlet(0.1), shard cap 100)
    at ``PIPELINE_FED_CLIENTS`` clients, chunk 10, bf16."""
    import dataclasses

    fed = path_configs(PIPELINE_FED_CLIENTS, 2000, 1000, "WARNING")["fed"]
    return {
        "headline_cnn_tpu": (dataclasses.replace(
            headline_config(HEADLINE_CLIENTS, None, None, 10000,
                            log_level="WARNING"),
            round=PIPELINE_ROUNDS, telemetry_level="basic"),
            {"gn_per_forward": 0, "wgrad_per_step": 0, "n_train": 50000}),
        "fed": (dataclasses.replace(
            fed, client_chunk_size=10, round=PIPELINE_ROUNDS,
            telemetry_level="basic"), {}),
    }


def pipeline_ab(torch, gn, wg):
    """Phase 2pa: ``pipeline_ab``. Each of :func:`pipeline_ab_configs`'
    paths with ``pipeline_rounds`` false (A) and true (B) in the order
    A B A B, each run through run_path's gates: every arm's records equal
    to the first arm's field by field, timings aside (``_plain_record``),
    and its final params bitwise (their SHA-256 digests printed). Prints
    each arm's median round seconds over rounds 1 and later, its rounds'
    wall (the sum) and its ``host_sync`` phase seconds (the wait for the
    round's one metric fetch). A record's round seconds run from the
    previous record to its own; pipelined, a round is recorded after the
    next one's dispatch, so the last record holds its fetch alone and is
    left out of that arm's median."""
    import dataclasses
    import hashlib

    from distributed_learning_simulator_tpu_torch.data.registry import (
        get_dataset,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        build_client_data,
    )

    out = {}
    for name, (config, gates) in pipeline_ab_configs().items():
        # One dataset and partition for the four arms (set-up, not rounds).
        ds = get_dataset(config.dataset_name, data_dir=config.data_dir,
                         seed=config.seed, n_train=config.n_train,
                         n_test=config.n_test, **config.dataset_args)
        cd = build_client_data(config, ds)
        arms = []
        for pipelined in (False, True, False, True):
            run = run_path(
                torch, gn, wg, f"pipeline_ab {name} "
                f"{'B' if pipelined else 'A'}",
                dataclasses.replace(config, pipeline_rounds=pipelined),
                keep_params=True, dataset=ds, client_data=cd, **gates)
            flat = torch.cat([v.detach().float().reshape(-1).cpu()
                              for _, v in sorted(
                                  run["global_params"].items())])
            arms.append({
                "pipeline_rounds": pipelined,
                "records": [_plain_record(r) for r in run["history"]],
                "params": run.pop("global_params"),
                "digest": hashlib.sha256(flat.numpy().tobytes()).hexdigest(),
                "round_seconds": run["round_seconds"],
                "median_round_seconds": statistics.median(
                    run["round_seconds"][1:-1] if pipelined
                    else run["round_seconds"][1:]),
                "wall_seconds": sum(run["round_seconds"]),
                "host_sync_seconds": [
                    r["telemetry"]["phase_seconds"]["host_sync"]
                    for r in run["history"]],
            })
        first = arms[0]
        for i, arm in enumerate(arms[1:], 1):
            if arm["records"] != first["records"]:
                fail(f"pipeline_ab {name}: arm {i} "
                     f"(pipeline_rounds={arm['pipeline_rounds']}) records "
                     "differ from arm 0's beyond their timings")
            if not _same_tree(arm["params"], first["params"]):
                fail(f"pipeline_ab {name}: arm {i}'s final params differ "
                     f"from arm 0's (digests {arm['digest']} against "
                     f"{first['digest']})")
        for arm in arms:
            del arm["params"], arm["records"]
        out[name] = arms
        log(f"pipeline_ab {name}: A B A B records equal, params bitwise "
            f"(sha256 {first['digest'][:16]}); median round seconds "
            f"(rounds 1+) "
            + ", ".join(f"{'B' if a['pipeline_rounds'] else 'A'} "
                        f"{a['median_round_seconds']:.4f}" for a in arms)
            + "; rounds' wall "
            + ", ".join(f"{'B' if a['pipeline_rounds'] else 'A'} "
                        f"{a['wall_seconds']:.4f}" for a in arms)
            + "; host_sync seconds by round "
            + ", ".join(f"{'B' if a['pipeline_rounds'] else 'A'} "
                        f"{a['host_sync_seconds']}" for a in arms))
    return out


def async_fed(torch, gn, wg, log_root):
    """Phase 2q: ``async_fed``. The ``fed`` main path (50 clients) for 3
    rounds with ``async_mode='on'``, ``arrival_model='bimodal'``,
    ``round_deadline=1.5`` and ``async_buffer_size=8``. Fails unless every
    record validates at schema_version 4 and the buffer applied at least
    once; then the same run at ``round_deadline=inf`` must be bitwise
    equal (history and params) to the plain ``fed`` run of these
    settings."""
    import dataclasses

    base = dataclasses.replace(path_configs(50, 5000, 2000, "WARNING")["fed"],
                               round=3)
    cfg = dataclasses.replace(base, async_mode="on", arrival_model="bimodal",
                              round_deadline=1.5, async_buffer_size=8)
    res = run_path(torch, gn, wg, "async_fed", cfg)
    _check_records("async_fed", res["history"], _schema(), 4)
    applied = [r["async"]["applied"] for r in res["history"]]
    if not any(applied):
        fail(f"async_fed: the buffer never applied "
             f"({[r['async'] for r in res['history']]})")
    inf = run_path(torch, gn, wg, "async_fed_inf", dataclasses.replace(
        cfg, round_deadline=float("inf")), keep_params=True)
    plain = run_path(torch, gn, wg, "async_fed_sync", base, keep_params=True)
    strip = [{k: v for k, v in _plain_record(r).items()
              if k not in ("async", "schema_version")}
             for r in inf["history"]]
    if not (strip == [_plain_record(r) for r in plain["history"]]
            and _same_tree(inf["global_params"], plain["global_params"])):
        fail("async_fed: round_deadline=inf differs from the synchronous "
             "run")
    res["async"] = [r["async"] for r in res["history"]]
    log(f"async_fed: {res['async']}; round_deadline=inf bitwise equal to "
        f"sync fed; round seconds async {res['round_seconds']}, sync "
        f"{plain['round_seconds']}")
    return res


STREAM_KEYS = ("stream_overlap_ratio", "stream_h2d_bytes",
               "stream_d2h_bytes", "stream_sample_seconds")
OOM_CLIENTS = 1000
STREAM_FLAGSHIP_CLIENTS = 400
STREAM_COHORT, STREAM_SHARD, STREAM_ROUNDS = 256, 16, 8
STREAM_POPULATIONS = ((100_000, "hashed"), (100_000, "exact"),
                      (1_000_000, "hashed"))
CHURN_CLIENTS, CHURN_ROUNDS, CHURN_GROWTH = 1000, 4, 10.0


def oom_config():
    """``oom_hint``'s round: ``fed`` at the flagship settings, 1000
    clients, the whole population as one chunk (more than the card
    holds), one round."""
    import dataclasses

    return dataclasses.replace(
        path_configs(OOM_CLIENTS, 50000, 2000, "WARNING")["fed"], round=1,
        client_chunk_size=OOM_CLIENTS)


def model_param_count(config) -> int:
    """The parameters of ``config``'s model on cifar10 (the flat layout's
    length), counted from the module: nothing is initialized or placed."""
    from distributed_learning_simulator_tpu_torch.models.registry import (
        get_model,
    )

    model = get_model(config.model_name, num_classes=10,
                      input_shape=(32, 32, 3), **config.model_args)
    return sum(p.numel() for p in model.parameters())


def oom_hint(torch, gn, wg):
    """Phase 2t: ``oom_hint``. The round of :func:`oom_config` must
    raise the JAX package's ``_oom_hint`` text for its config and
    parameter count (a ``client_chunk_size=`` below 1000), chained from a
    ``torch.OutOfMemoryError``; once the exception is dropped, the card's
    allocated memory must be back within 64 MiB of its level before the
    phase. Then ``_assert_client_stack_feasible`` for GTG at N=1000 with
    ResNet-18 must refuse before anything is allocated."""
    import dataclasses
    import gc

    from distributed_learning_simulator_tpu_torch import simulator

    device = torch.device("cuda")
    config = oom_config()
    n_params = model_param_count(config)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gn.reset_launch_counts()
    wg.reset_launch_counts()
    text = cause = None
    t0 = time.perf_counter()
    try:
        simulator.run_simulation(config, setup_logging=False)
    except RuntimeError as e:
        text, cause = str(e), type(e.__cause__).__name__
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    after_drop = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.synchronize()
    after_gc = torch.cuda.memory_allocated()
    if text is None:
        fail(f"oom_hint: a {OOM_CLIENTS}-client chunk fit the card")
    try:
        with simulator._oom_hint(config, n_params, OOM_CLIENTS, device):
            raise torch.OutOfMemoryError("CUDA out of memory")
    except RuntimeError as e:
        want = str(e)
    m = re.search(r"Try client_chunk_size=(\d+)\.", text)
    if text != want or cause != "OutOfMemoryError" or not m or not (
            int(m.group(1)) < OOM_CLIENTS):
        fail(f"oom_hint: {text!r} chained from {cause}; expected {want!r} "
             "chained from OutOfMemoryError")
    if after_drop - before > 64 * 2**20:
        fail(f"oom_hint: {(after_drop - before) / 2**20:.1f} MiB still "
             "allocated after the exception was dropped")
    gtg = dataclasses.replace(config, distributed_algorithm="GTG_shapley_value")
    refused = None
    start = torch.cuda.memory_allocated()
    try:
        simulator._assert_client_stack_feasible(gtg, n_params, OOM_CLIENTS,
                                                device)
    except ValueError as e:
        refused = str(e)
    if refused is None or "parameter stack" not in refused or (
            torch.cuda.memory_allocated() != start):
        fail(f"oom_hint: GTG at N={OOM_CLIENTS} not refused before any "
             f"allocation: {refused!r}")
    out = {"text": text, "suggested_chunk": int(m.group(1)),
           "seconds": seconds, "allocated_before": before,
           "allocated_after_drop": after_drop,
           "allocated_after_gc": after_gc, "stack_refusal": refused,
           "launches": {"gn_stats": gn.gn_stats.launches,
                        "conv3x3_wgrad": wg.conv3x3_wgrad.launches}}
    log(f"oom_hint: {text!r} after {seconds:.1f} s; allocated "
        f"{before / 2**20:.1f} MiB before, {after_drop / 2**20:.1f} MiB "
        f"once dropped, {after_gc / 2**20:.1f} MiB after gc; GTG refused: "
        f"{refused!r}")
    return out


def stream_flagship_configs():
    """``stream_flagship``'s resident configurations (each also runs with
    ``client_residency='streamed'``): ``fed`` at the flagship settings
    with 400 clients and a hashed 10% cohort (40 clients, one chunk), 3
    rounds; ``sign_SGD`` as its main path (50 clients, momentum 0.9, f32,
    the full cohort: one upload, persistent state)."""
    import dataclasses

    fed = dataclasses.replace(
        path_configs(STREAM_FLAGSHIP_CLIENTS, 40000, 2000, "WARNING")["fed"],
        round=3, participation_fraction=0.1, participation_sampler="hashed")
    sign = path_configs(50, 5000, 2000, "WARNING")["sign_SGD"]
    return {"fed": fed, "sign_SGD": sign}


def _without_stream(history):
    return [{k: v for k, v in r.items()
             if k not in ("round_seconds", "stream", "schema_version")}
            for r in history]


def stream_flagship(torch, gn, wg, work):
    """Phase 2u: ``stream_flagship``. Each configuration of
    :func:`stream_flagship_configs` resident and streamed, in the order
    resident, streamed, each run through run_path's
    launch gates: the streamed run's global parameters and history must be
    bitwise the resident run's, and the streamed records valid v5
    records (a full cohort's one upload on its first record only). Prints
    round seconds, the median round after round 0 of each residency, the
    overlap ratio, H2D MiB and both peaks. Then :func:`trace_residency`
    for ``fed`` (one profiled round a residency). A configuration's runs
    share one dataset and partition (set-up, not rounds). Returns
    ``({name: {label: run}}, {"fed": trace})``."""
    import dataclasses

    from distributed_learning_simulator_tpu_torch.data.registry import (
        get_dataset,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        build_client_data,
    )

    schema = _schema()
    out = {}
    data = {}
    for name, config in stream_flagship_configs().items():
        ds = get_dataset(config.dataset_name, data_dir=config.data_dir,
                         seed=config.seed, n_train=config.n_train,
                         n_test=config.n_test, **config.dataset_args)
        data[name] = (ds, build_client_data(config, ds))
        # Resident, then streamed (A B: the second pair of A B B A went to
        # pay for the multihost_fed phase).
        order = ("resident", "streamed")
        runs = {}
        for residency in order:
            label = residency if residency not in runs else f"{residency}_2"
            runs[label] = run_path(
                torch, gn, wg, f"stream_{name}_{label}",
                dataclasses.replace(config, client_residency=residency),
                keep_params=True, dataset=data[name][0],
                client_data=data[name][1])
        res, st = runs["resident"], runs["streamed"]
        for label, run in runs.items():
            if _without_stream(res["history"]) != _without_stream(
                    run["history"]):
                fail(f"stream_flagship {name}: {label} history differs "
                     "from resident")
            for k, v in res["global_params"].items():
                if not torch.equal(v, run["global_params"][k]):
                    fail(f"stream_flagship {name}: {label} parameter {k} "
                         "differs")
        # A sampled cohort uploads every round; a full cohort once, on the
        # first record (the later ones are the resident run's v1 records).
        uploads = (st["history"] if config.cohort_size()
                   < config.worker_number else st["history"][:1])
        _check_records(f"stream_{name}", uploads, schema, 5)
        for rec in st["history"][len(uploads):]:
            if schema_errors(rec, schema) or "schema_version" in rec:
                fail(f"stream_{name} round {rec['round']}: not a plain v1 "
                     "record")
        for r in runs.values():
            r.pop("global_params")
        out[name] = runs
        steady = {
            residency: statistics.median(
                x for label, r in runs.items() if label.startswith(residency)
                for x in r["round_seconds"][1:])
            for residency in ("resident", "streamed")}
        s = st["stream"]
        log(f"stream_flagship {name}: bitwise resident; round seconds "
            + "; ".join(f"{label} {r['round_seconds']}"
                        for label, r in runs.items())
            + f" (median after round 0: resident {steady['resident']:.4f}, "
            f"streamed {steady['streamed']:.4f}); overlap "
            f"{s['stream_overlap_ratio']:.4f}, H2D "
            f"{s['stream_h2d_bytes'] / 2**20:.1f} MiB, D2H "
            f"{s['stream_d2h_bytes'] / 2**20:.1f} MiB; peak "
            f"{res['peak_memory_bytes'] / 2**30:.2f} GiB resident, "
            f"{st['peak_memory_bytes'] / 2**30:.2f} GiB streamed")
    # One profiled round per arm (resident, streamed), on ``fed``: the
    # four traces of both paths took most of this phase.
    config = stream_flagship_configs()["fed"]
    traces = {"fed": trace_residency(torch, gn, wg, config, os.path.join(
        work, "residency_trace", "fed"), *data["fed"])}
    return out, traces


def trace_residency(torch, gn, wg, config, trace_root, dataset=None,
                    client_data=None):
    """One profiled round (round 1 of 2, ``profile_dir`` with
    ``profile_from_round=1``) of ``config`` resident and then streamed,
    each through run_path's gates: the round's device busy milliseconds
    (utils/tracing.parse_device_trace, the sum of its device ops) beside
    its wall seconds, so that a gap between the two residencies shows as
    device work or as host time. The profiler synchronizes at each
    training step (utils/tracing.profile_step), so these wall seconds are
    the profiled round's, not the plain round's. ``dataset`` and
    ``client_data`` are run_simulation's injection points."""
    import dataclasses

    from distributed_learning_simulator_tpu_torch.utils import tracing

    out = {}
    for residency in ("resident", "streamed"):
        trace_dir = os.path.join(trace_root, residency)
        shutil.rmtree(trace_dir, ignore_errors=True)
        run = run_path(
            torch, gn, wg, f"trace_{config.distributed_algorithm}_"
            f"{residency}", dataclasses.replace(
                config, client_residency=residency, round=2,
                profile_dir=trace_dir, profile_from_round=1),
            dataset=dataset, client_data=client_data)
        dev = tracing.parse_device_trace(trace_dir)
        out[residency] = {"round_seconds": run["round_seconds"],
                          "device_ms": dev["device_ms"],
                          "op_count": dev["op_count"],
                          "peak_memory_bytes": run["peak_memory_bytes"]}
        shutil.rmtree(trace_dir, ignore_errors=True)
    r, s = out["resident"], out["streamed"]
    log(f"trace {config.distributed_algorithm}: profiled round 1 device "
        f"busy {r['device_ms']:.1f} ms in {r['op_count']} ops, wall "
        f"{r['round_seconds'][1]:.4f} s resident; {s['device_ms']:.1f} ms "
        f"in {s['op_count']} ops, wall {s['round_seconds'][1]:.4f} s "
        "streamed")
    return out


def stream_population_config(n_clients: int, sampler: str):
    """bench.py's ``stream`` leg: an MLP on the synthetic dataset, shards
    of 16, a cohort of 256, 8 rounds, streamed."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )

    return ExperimentConfig(
        dataset_name="synthetic", model_name="mlp",
        distributed_algorithm="fed", worker_number=n_clients,
        round=STREAM_ROUNDS, epoch=1, learning_rate=0.1,
        batch_size=STREAM_SHARD, eval_batch_size=512,
        participation_fraction=STREAM_COHORT / n_clients,
        participation_sampler=sampler, client_residency="streamed",
        log_level="WARNING", device="cuda")


def stream_population(torch, gn, wg):
    """Phase 2v: ``stream_population``, bench.py's ``stream`` leg: the
    synthetic pool min-max scaled into the uint8-compact layout, a
    population of shards from ``synthetic_stream_shards``, hashed at
    N = 1e5 and 1e6 and exact at 1e5. Prints the cohort rate, the steady
    ``sample_ms``, the overlap ratio, the host store's MiB and the device
    peak; the peak of every run must be at most 1.05x the hashed 1e5
    run's plus 64 MiB (the device holds the cohort, not the
    population)."""
    import numpy as np

    from distributed_learning_simulator_tpu_torch.data.registry import (
        Dataset,
        get_dataset,
    )
    from distributed_learning_simulator_tpu_torch.data.residency import (
        synthetic_stream_shards,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    ds = get_dataset("synthetic", n_train=4096, n_test=512, seed=0)
    lo, hi = float(ds.x_train.min()), float(ds.x_train.max())

    def scale(x):
        return ((x - lo) / (hi - lo)).astype(np.float32)

    ds = Dataset(ds.name, scale(ds.x_train), ds.y_train, scale(ds.x_test),
                 ds.y_test, ds.num_classes)
    rows = []
    shards = {}
    for n, sampler in STREAM_POPULATIONS:
        if n not in shards:
            shards.clear()
            t0 = time.perf_counter()
            shards[n] = synthetic_stream_shards(
                ds.x_train, ds.y_train, n, STREAM_SHARD, seed=0)
            build_s = time.perf_counter() - t0
        cd = shards[n]
        config = stream_population_config(n, sampler)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        result = run_simulation(config, dataset=ds, client_data=cd,
                                setup_logging=False)
        torch.cuda.synchronize()
        hist = result["history"]
        if len(hist) != config.round or not all(
                math.isfinite(h["test_loss"]) for h in hist):
            fail(f"stream_population N={n} {sampler}: {hist}")
        steady = [h["round_seconds"] for h in hist[1:]]
        sample_ms = [h["stream"]["sample_ms"] for h in hist[1:]
                     if "sample_ms" in h.get("stream", {})]
        rows.append({
            "n_clients": n, "sampler": sampler,
            "cohort_rate": STREAM_COHORT * len(steady) / sum(steady),
            "round_ms": 1e3 * statistics.median(steady),
            "sample_ms": statistics.median(sample_ms) if sample_ms else None,
            "overlap_ratio": result["stream_overlap_ratio"],
            "h2d_mib": result["stream_h2d_bytes"] / 2**20,
            "host_store_mib": (cd.x.nbytes + cd.y.nbytes + cd.mask.nbytes
                               + cd.sizes.nbytes) / 2**20,
            "shards_build_s": build_s,
            "peak_bytes": torch.cuda.max_memory_allocated(),
        })
        log(f"stream_population: {rows[-1]}")
    base = rows[0]["peak_bytes"]
    for r in rows:
        if r["peak_bytes"] > 1.05 * base + 64 * 2**20:
            fail(f"stream_population: peak {r['peak_bytes']} at N="
                 f"{r['n_clients']} {r['sampler']} against {base} at "
                 f"N={rows[0]['n_clients']} {rows[0]['sampler']}")
    return rows


def churn_configs():
    """bench.py's ``churn`` leg on the headline: 1000 IID clients, chunk
    250, streamed + hashed, a 25% cohort (one chunk), 4 rounds plus the
    first; static, then dynamic growing toward 10x (``join_rate =
    round(9 * 1000 / 5)``), departures 0.01, drift 0.02 at factor 0.5."""
    import dataclasses

    static = dataclasses.replace(
        headline_config(CHURN_CLIENTS, None, None, 10000, "WARNING"),
        round=CHURN_ROUNDS + 1, client_residency="streamed",
        participation_sampler="hashed", participation_fraction=0.25)
    join_rate = round((CHURN_GROWTH - 1.0) * CHURN_CLIENTS
                      / (CHURN_ROUNDS + 1))
    dynamic = dataclasses.replace(
        static, population="dynamic", join_rate=float(join_rate),
        depart_rate=0.01, drift_fraction=0.02, drift_factor=0.5)
    return {"static": static, "dynamic": dynamic}


def churn_headline(torch, gn, wg):
    """Phase 2w: ``churn_headline``: each of :func:`churn_configs` through
    run_path (no GroupNorm, no wgrad: the CNN has neither); finite losses,
    a population that grew, and valid v9 records. Prints
    ``churn_overhead_ratio`` (the dynamic run's median steady round over
    the static run's, minus one; not gated) and ``population_summary``."""
    runs = {name: run_path(torch, gn, wg, f"churn_{name}", config,
                           gn_per_forward=0, wgrad_per_step=0,
                           n_train=50000)
            for name, config in churn_configs().items()}
    dyn = runs["dynamic"]
    summary = dyn["population_summary"]
    if not summary or summary["n_registered"] <= CHURN_CLIENTS:
        fail(f"churn_headline: the population did not grow: {summary}")
    _check_records("churn_dynamic", dyn["history"], _schema(), 9)
    med = {name: statistics.median(r["round_seconds"][1:])
           for name, r in runs.items()}
    ratio = med["dynamic"] / med["static"] - 1.0
    log(f"churn_headline: median steady round {med['static']:.4f} s "
        f"static, {med['dynamic']:.4f} s dynamic, churn_overhead_ratio "
        f"{ratio:.4f}; population_summary {summary}")
    return {"runs": runs, "median_round_s": med,
            "churn_overhead_ratio": ratio}


SWEEP_CLIENTS = 20  # sweep_fleet's flagship partition, 2 rounds
#: sweep_fleet (b)'s lr axis; the first is the flagship's, the fleet's base.
SWEEP_LRS = (0.02, 0.01)
#: bench.py's ``_sweep_leg`` shape: MLP, 32 clients, 6 rounds, 8 seeds.
SWEEP_MLP_CLIENTS, SWEEP_MLP_ROUNDS, SWEEP_MLP_POINTS = 32, 6, 8
#: The fields a fleet point's history holds to its solo run's.
SWEEP_KEYS = ("test_accuracy", "test_loss", "mean_client_loss",
              "cohort_hash")


def sweep_fleet_configs():
    """``sweep_fleet``'s two fleets, each a config with its sweep knobs set
    (what ``run_sweep`` takes from a user): ResNet-18 at full width on the
    flagship's partition (Dirichlet(0.1), shard cap 100, batch 25,
    momentum 0.9) at 20 clients, 2 rounds, one 1000-sample eval batch.
    ``f32``: f32 model and local state, seeds {0, 1}, chunk 20 (40 models
    a program); ``bf16``: the flagship's bf16 local state, seeds {0, 1} x
    lr {0.02, 0.01}, chunk 10 (4 x 10 = 40 models a program)."""
    import dataclasses

    base = path_configs(SWEEP_CLIENTS, 2000, 1000, "WARNING")["fed"]
    return {
        "f32": dataclasses.replace(
            base, local_compute_dtype="float32",
            model_args={"dtype": "float32"}, client_chunk_size=20,
            sweep_seeds="0,1", sweep_strategy="vmapped"),
        "bf16": dataclasses.replace(
            base, client_chunk_size=10, sweep_seeds="0,1",
            sweep_points=json.dumps([{"learning_rate": lr}
                                     for lr in SWEEP_LRS])),
    }


def run_sweep_path(torch, gn, wg, name, config, dataset, client_data):
    """One sweep through ``run_sweep`` with every launch count set to 0
    just before it and read just after: each GroupNorm kernel must launch
    20 times per model forward (a forward is every experiment's chunk) and
    the wgrad kernel 4 times per training step, with finite losses; keeps
    the forwards, the launches and the peak device memory."""
    from distributed_learning_simulator_tpu_torch.models.resnet import (
        ResNet18,
    )
    from distributed_learning_simulator_tpu_torch.simulator import run_sweep

    forwards = {"train": 0, "eval": 0}

    def count(module, args, output):
        if isinstance(module, ResNet18):
            forwards["train" if torch.is_grad_enabled() else "eval"] += 1

    gn.reset_launch_counts()
    wg.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hook = torch.nn.modules.module.register_module_forward_hook(count)
    t0 = time.perf_counter()
    try:
        out = run_sweep(config, dataset=dataset, client_data=client_data)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gn_stats": gn.gn_stats.launches,
                "gn_normalize": gn.gn_normalize.launches,
                "conv3x3_wgrad": wg.conv3x3_wgrad.launches}
    total_fwd = forwards["train"] + forwards["eval"]
    for kernel in ("gn_stats", "gn_normalize"):
        if launches[kernel] != GN_PER_FORWARD * total_fwd:
            fail(f"{name}: {kernel} launched {launches[kernel]} times for "
                 f"{total_fwd} forwards (expected {GN_PER_FORWARD} each)")
    if launches["conv3x3_wgrad"] != WGRAD_PER_STEP * forwards["train"]:
        fail(f"{name}: conv3x3_wgrad launched "
             f"{launches['conv3x3_wgrad']} times for {forwards['train']} "
             f"training steps (expected {WGRAD_PER_STEP} each)")
    for p in out["points"]:
        if not all(math.isfinite(r["test_loss"]) for r in p["history"]):
            fail(f"{name} point {p['index']}: non-finite test loss")
    return {"result": out, "forwards": forwards, "launches": launches,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "wall_seconds": wall}


class FirstTraining:
    """Inside ``with``: the first ``train_chunk`` call of the run keeps its
    trained parameters ``[rows, P]`` (round 0's first chunk; in a fleet
    every experiment's first members, experiment-major) in ``trained``,
    with the layout that names their leaves, and a fleet's first round its
    new global parameters ``[E, P]`` in ``globals``."""

    def __init__(self):
        self.trained = self.layout = self.globals = None

    def __enter__(self):
        from distributed_learning_simulator_tpu_torch.algorithms.fedavg import (
            FedAvg,
        )

        self._made = FedAvg._chunk_train_fn, FedAvg.make_fleet_round_fn
        make_train, make_fleet = self._made
        me = self

        def train_fn(algo, apply_fn, optimizer, layout, *args, **kwargs):
            train_chunk = make_train(algo, apply_fn, optimizer, layout,
                                     *args, **kwargs)

            def kept(*a, **k):
                if me.trained is not None:
                    return train_chunk(*a, **k)
                out = train_chunk(*a, **k)
                me.layout, me.trained = layout, out[0].detach().clone()
                return out

            return kept

        def fleet_fn(algo, *args, **kwargs):
            fleet_round = make_fleet(algo, *args, **kwargs)

            def kept(*a, **k):
                out = fleet_round(*a, **k)
                if me.globals is None:
                    me.globals = out[0].detach().clone()
                return out

            return kept

        FedAvg._chunk_train_fn, FedAvg.make_fleet_round_fn = train_fn, fleet_fn
        return self

    def __exit__(self, *exc):
        from distributed_learning_simulator_tpu_torch.algorithms.fedavg import (
            FedAvg,
        )

        FedAvg._chunk_train_fn, FedAvg.make_fleet_round_fn = self._made


def leaf_differences(torch, layout, a, b) -> dict:
    """The leaves (in the layout's order) where the parameter rows ``a``
    and ``b`` (``[rows, P]`` of one shape) are not bitwise equal: the
    first, its max abs difference, and how many of all."""
    if a.shape != b.shape:
        fail(f"leaf_differences: rows {tuple(a.shape)} against "
             f"{tuple(b.shape)}")
    first, worst, differing, off = None, 0.0, 0, 0
    for name, numel in zip(layout.names, layout.numels):
        sa, sb = a[:, off:off + numel], b[:, off:off + numel]
        off += numel
        if torch.equal(sa, sb):
            continue
        differing += 1
        gap = (sa.double() - sb.double()).abs().max().item()
        worst = max(worst, gap)
        if first is None:
            first = {"leaf": name, "max_abs_diff": gap}
    return {"first": first, "differing_leaves": differing,
            "leaves": len(layout.names), "max_abs_diff": worst}


def round0_leaves_gate(leaves: dict) -> None:
    """``sweep_fleet`` f32's gate on round 0's trained rows: ``leaves``
    maps each point to :func:`leaf_differences` of the fleet's rows against
    its solo run's, and every point must be bitwise (a client's training
    must not depend on how many models share its program). Prints the
    reading; a point that differs fails with its first differing leaf."""
    log("sweep_fleet f32 after round 0's training (first chunk), the "
        "fleet's rows against each solo run's: " + "; ".join(
            f"point {i}: " + (
                "bitwise equal" if d["first"] is None else
                f"first differing leaf {d['first']['leaf']} (max abs diff "
                f"{d['first']['max_abs_diff']:.3e}), "
                f"{d['differing_leaves']} of {d['leaves']} leaves differ, "
                f"largest {d['max_abs_diff']:.3e}")
            for i, d in leaves.items()))
    bad = {i: d["first"] for i, d in leaves.items() if d["first"]}
    if bad:
        fail(f"sweep_fleet f32: round 0's trained rows differ from the solo "
             f"runs' (point: first differing leaf) {bad}")


def sweep_fleet(torch, gn, wg):
    """Phase 2x: ``sweep_fleet``. Each fleet of
    :func:`sweep_fleet_configs` through ``run_sweep`` on the base config's
    data (``run_sweep_path``'s gates), then each needed point alone through
    run_path on the same data. Both: the fleet's training forwards equal
    one solo run's (every experiment's chunk j is one forward), one eval
    forward per round (the E models in one vmapped forward of the one eval
    batch). ``f32``: each point's ``cohort_hash`` equal to its solo run's
    and its test losses at rtol 1e-4 (``compare_chunks``' tolerance), and
    two solo runs of each point bitwise equal (the run takes only cuDNN's
    deterministic algorithms: without them, two f32 runs of one seed
    drifted up to 1e-3 apart in test loss after two rounds on an H100);
    round 0's first trained chunk bitwise its solo runs'
    (``round0_leaves_gate``); whether the fleet's histories are bitwise
    its solo runs' is printed.
    ``bf16``: the
    ``vmapped`` strategy with one program; the lr-0.02 points' first-round
    test losses within rtol 2e-3 of their solo runs (the dither hashes the
    f32 bits, so the reassociated sums of 40-model convolutions redraw
    coordinates, and the second round of these diverging runs drifts
    further: up to 2.9e-3 on an H100, printed), and in every round each
    lr-0.02 point nearer its solo run than the same seed's lr-0.01 point
    is (the lr factor moves a run further than the batching does). Prints
    the fleet's round seconds per
    experiment (the round's wall over E) beside the solo runs' round
    seconds, and the peak memories."""
    from distributed_learning_simulator_tpu_torch.data.registry import (
        get_dataset,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        build_client_data,
    )
    from distributed_learning_simulator_tpu_torch.sweep import SweepSpec

    out = {}
    for name, config in sweep_fleet_configs().items():
        ds = get_dataset(config.dataset_name, data_dir=config.data_dir,
                         seed=config.seed, n_train=config.n_train,
                         n_test=config.n_test, **config.dataset_args)
        cd = build_client_data(config, ds)
        with FirstTraining() as fleet_first:
            fleet = run_sweep_path(torch, gn, wg, f"sweep_fleet {name}",
                                   config, ds, cd)
        res = fleet["result"]
        if res["strategy"] != "vmapped" or res["programs_compiled"] != 1:
            fail(f"sweep_fleet {name}: strategy {res['strategy']}, "
                 f"{res['programs_compiled']} programs (expected vmapped, "
                 "1)")
        points = SweepSpec.from_config(config).points
        solos, spreads, solo_first = {}, {}, {}
        for point in points:
            lr = point.config.learning_rate
            if name == "bf16" and lr != SWEEP_LRS[0]:
                continue
            runs = []
            for _ in range(2 if name == "f32" else 1):
                with FirstTraining() as first:
                    runs.append(run_path(
                        torch, gn, wg, f"sweep_fleet {name} solo seed "
                        f"{point.config.seed} lr {lr}", point.config,
                        dataset=ds, client_data=cd))
                solo_first.setdefault(point.index, first)
            solos[point.index] = runs[0]
            spreads[point.index] = [
                max(abs(a["test_loss"] - b["test_loss"])
                    for b in (r["history"][i] for r in runs))
                for i, a in enumerate(runs[0]["history"])]
            if any(a.get(k) != b.get(k) for r in runs[1:]
                   for a, b in zip(runs[0]["history"], r["history"])
                   for k in SWEEP_KEYS):
                fail(f"sweep_fleet {name} seed {point.config.seed}: two "
                     f"solo runs differ (test losses apart by "
                     f"{spreads[point.index]}): a seeded run must "
                     "reproduce bitwise")
        solo_fwd = {s["forwards"]["train"] for s in solos.values()}
        n_eval = config.round * -(-config.n_test // config.eval_batch_size)
        if solo_fwd != {fleet["forwards"]["train"]} or (
                fleet["forwards"]["eval"] != n_eval):
            fail(f"sweep_fleet {name}: forwards {fleet['forwards']}, solo "
                 f"runs' training forwards {sorted(solo_fwd)}, expected "
                 f"{n_eval} eval forwards: the fleet did not train its "
                 "experiments together")
        bitwise = {}
        for p in res["points"]:
            solo = solos.get(p["index"])
            if solo is None:
                continue
            hs, hf = solo["history"], p["history"]
            bitwise[p["index"]] = all(
                a.get(k) == b.get(k) for a, b in zip(hs, hf)
                for k in SWEEP_KEYS)
            rtol = 1e-4 if name == "f32" else 2e-3
            gated = hs if name == "f32" else hs[:1]
            for a, b in zip(gated, hf):
                if a.get("cohort_hash") != b.get("cohort_hash") or not (
                        abs(a["test_loss"] - b["test_loss"])
                        <= rtol * abs(a["test_loss"])):
                    fail(f"sweep_fleet {name} point {p['index']} round "
                         f"{a['round']}: cohort {b.get('cohort_hash')} / "
                         f"{a.get('cohort_hash')}, test loss "
                         f"{b['test_loss']} against the solo run's "
                         f"{a['test_loss']} (rtol {rtol})")
        gaps = {}
        if name == "bf16":
            losses = {(p["seed"], p["learning_rate"]):
                      [r["test_loss"] for r in p["history"]]
                      for p in res["points"]}
            for p in res["points"]:
                if p["index"] in solos:
                    solo_losses = [r["test_loss"] for r in
                                   solos[p["index"]]["history"]]
                    gaps[p["seed"]] = [
                        (abs(f - s0), abs(g - s0)) for f, g, s0 in zip(
                            losses[(p["seed"], SWEEP_LRS[0])],
                            losses[(p["seed"], SWEEP_LRS[1])], solo_losses)]
            for seed, rounds in gaps.items():
                if not all(near < far for near, far in rounds):
                    fail(f"sweep_fleet bf16 seed {seed}: test-loss gaps to "
                         f"the lr-{SWEEP_LRS[0]} solo run {rounds} (lr "
                         f"{SWEEP_LRS[0]}, lr {SWEEP_LRS[1]}): the lr factor "
                         "did not move the run further than the batching")
        # Round 0's first chunk after training, before the aggregate: each
        # experiment's rows of the fleet's program against its solo run's.
        leaves = {}
        if name == "f32":
            for i, p in enumerate(res["points"]):
                solo_rows = solo_first[p["index"]].trained
                m = solo_rows.shape[0]
                leaves[p["index"]] = leaf_differences(
                    torch, fleet_first.layout,
                    fleet_first.trained[i * m:(i + 1) * m], solo_rows)
            round0_leaves_gate(leaves)
        del fleet_first, solo_first
        fleet_secs = [[r["round_seconds"] for r in p["history"]]
                      for p in res["points"]]
        solo_secs = {i: s["round_seconds"] for i, s in solos.items()}
        out[name] = {
            "forwards": fleet["forwards"], "launches": fleet["launches"],
            "solo_train_forwards": sorted(solo_fwd),
            "round_seconds_per_experiment": fleet_secs,
            "solo_round_seconds": solo_secs,
            "wall_seconds": fleet["wall_seconds"],
            "peak_memory_bytes": fleet["peak_memory_bytes"],
            "solo_peak_memory_bytes": {
                i: s["peak_memory_bytes"] for i, s in solos.items()},
            "bitwise_equal_to_solo": bitwise,
            "solo_test_loss_spread": spreads,
            "lr_gaps_to_solo": gaps,
            "round0_trained_leaves": leaves,
            "test_losses": [[r["test_loss"] for r in p["history"]]
                            for p in res["points"]],
        }
        log(f"sweep_fleet {name}: {len(res['points'])} experiments, "
            f"forwards {fleet['forwards']} (each solo run "
            f"{sorted(solo_fwd)} training), launches {fleet['launches']}; "
            f"round seconds per experiment {fleet_secs} against solo "
            f"{solo_secs}; peak {fleet['peak_memory_bytes'] / 2**30:.2f} "
            f"GiB (solo {[round(s['peak_memory_bytes'] / 2**30, 2) for s in solos.values()]}); "
            f"bitwise equal to solo {bitwise}; two solo runs' test losses "
            f"apart by {spreads}; test losses {out[name]['test_losses']}, "
            f"solo {[[r['test_loss'] for r in s['history']] for s in solos.values()]}"
            + (f"; gaps to the lr-{SWEEP_LRS[0]} solo runs (lr "
               f"{SWEEP_LRS[0]}, lr {SWEEP_LRS[1]}) {gaps}" if gaps else ""))
    return out


def sweep_mlp_config():
    """bench.py's ``_sweep_leg`` base: the MLP on the synthetic set, 32
    clients of 32 samples, 6 rounds, batch 16, lr 0.1."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )

    return ExperimentConfig(
        dataset_name="synthetic", model_name="mlp",
        distributed_algorithm="fed", worker_number=SWEEP_MLP_CLIENTS,
        round=SWEEP_MLP_ROUNDS, epoch=1, learning_rate=0.1, batch_size=16,
        n_train=SWEEP_MLP_CLIENTS * 32, n_test=512, log_level="WARNING",
        dataset_args={"difficulty": 0.5}, compilation_cache_dir=None,
        device="cuda")


def sweep_scheduled(torch, work):
    """Phase 2y: ``sweep_scheduled``, bench.py's ``_sweep_leg`` on the
    card (:func:`sweep_mlp_config`). An 8-seed fleet against the 8 solo
    runs one after another on the shared data: ``sweep_amortization_ratio``
    (serial wall over the fleet's) and ``bit_identical`` printed, no gate
    on speed. The 2-hash 8-point scheduled sweep (seeds {0, 1} x 6-9
    rounds): ``compile_reuse_fraction`` 0.875 and every point's history
    bitwise its solo run's. A 4-point scheduled sweep into a ``sweep_dir``
    under ``work`` crashed after 2 points (``DLS_SWEEP_CRASH_AFTER``) and
    resumed: 2 points loaded, 2 run, the histories bitwise the
    uninterrupted sweep's, every persisted record a valid v8 record."""
    import dataclasses

    from distributed_learning_simulator_tpu_torch.data.registry import (
        get_dataset,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        build_client_data,
        run_simulation,
        run_sweep,
    )
    from distributed_learning_simulator_tpu_torch.sweep import SweepSpec

    base = sweep_mlp_config()
    ds = get_dataset("synthetic", n_train=base.n_train, n_test=base.n_test,
                     seed=base.seed, difficulty=0.5)
    cd = build_client_data(base, ds)

    def solo(**changes):
        return run_simulation(dataclasses.replace(base, **changes),
                              dataset=ds, client_data=cd,
                              setup_logging=False)["history"]

    def same(a, b):
        return len(a) == len(b) and all(
            x.get(k) == y.get(k) for x, y in zip(a, b) for k in SWEEP_KEYS)

    seeds = list(range(SWEEP_MLP_POINTS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solos = [solo(seed=s) for s in seeds]
    torch.cuda.synchronize()
    serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = run_sweep(SweepSpec(base, [{"seed": s} for s in seeds],
                                strategy="vmapped"),
                      dataset=ds, client_data=cd)
    torch.cuda.synchronize()
    fleet_wall = time.perf_counter() - t0
    bit_identical = all(same(h, p["history"])
                        for h, p in zip(solos, fleet["points"]))
    ratio = serial / fleet_wall
    sched_points = [{"seed": s, "round": r} for s in (0, 1)
                    for r in range(SWEEP_MLP_ROUNDS, SWEEP_MLP_ROUNDS + 4)]
    sched = run_sweep(SweepSpec(base, sched_points, strategy="scheduled"),
                      dataset=ds, client_data=cd)
    hashes = {p["config_hash"] for p in sched["points"]}
    if (sched["compile_reuse_fraction"] != 0.875
            or sched["programs_compiled"] != 1 or len(hashes) != 2):
        fail(f"sweep_scheduled: compile_reuse_fraction "
             f"{sched['compile_reuse_fraction']}, programs "
             f"{sched['programs_compiled']}, {len(hashes)} config hashes "
             "(expected 0.875, 1, 2)")
    for p in sched["points"]:
        if not same(solo(seed=p["seed"], round=p["rounds"]), p["history"]):
            fail(f"sweep_scheduled point {p['index']}: history differs "
                 "from its solo run")
    sweep_dir = os.path.join(work, "sweep_resume")
    shutil.rmtree(sweep_dir, ignore_errors=True)
    points = [{"seed": s} for s in range(4)]
    os.environ["DLS_SWEEP_CRASH_AFTER"] = "2"
    try:
        run_sweep(SweepSpec(base, points, strategy="scheduled",
                            sweep_dir=sweep_dir), dataset=ds,
                  client_data=cd)
        fail("sweep_scheduled: the chaos crash did not fire")
    except RuntimeError as e:
        if "chaos" not in str(e):
            raise
    finally:
        del os.environ["DLS_SWEEP_CRASH_AFTER"]
    resumed = run_sweep(SweepSpec(base, points, strategy="scheduled",
                                  sweep_dir=sweep_dir, resume=True),
                        dataset=ds, client_data=cd)
    straight = run_sweep(SweepSpec(base, points, strategy="scheduled"),
                         dataset=ds, client_data=cd)
    if (resumed["resumed_points"], resumed["executed_points"]) != (2, 2):
        fail(f"sweep_scheduled resume: {resumed['resumed_points']} loaded, "
             f"{resumed['executed_points']} run (expected 2 and 2)")
    for pr, ps in zip(resumed["points"], straight["points"]):
        if not same(pr["history"], ps["history"]):
            fail(f"sweep_scheduled resume: point {pr['index']} differs "
                 "from the uninterrupted sweep's")
    with open(os.path.join(sweep_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if len(records) != 4 * base.round:
        fail(f"sweep_scheduled resume: {len(records)} records (expected "
             f"{4 * base.round})")
    _check_records("sweep_scheduled resume", records, _schema(), 8)
    log(f"sweep_scheduled: {SWEEP_MLP_POINTS}-seed fleet {fleet_wall:.3f} "
        f"s against {serial:.3f} s serial (sweep_amortization_ratio "
        f"{ratio:.4f}), bit_identical {bit_identical}; 2-hash scheduled "
        f"sweep compile_reuse_fraction {sched['compile_reuse_fraction']}, "
        f"bitwise to solo; resume stitched bitwise, {len(records)} v8 "
        "records")
    return {"serial_wall_s": serial, "fleet_wall_s": fleet_wall,
            "sweep_amortization_ratio": ratio,
            "bit_identical": bit_identical,
            "compile_reuse_fraction": sched["compile_reuse_fraction"],
            "programs_compiled": sched["programs_compiled"],
            "experiments_per_hour": fleet["experiments_per_hour"],
            "resume": {"resumed": resumed["resumed_points"],
                       "executed": resumed["executed_points"]}}


MULTIHOST_TIMEOUT_S = 480  # both ranks' whole run, the kernels loaded
MULTIHOST_LOSS_RTOL = 2e-3  # sweep_fleet's bf16 band for later rounds
CLOCK_SLACK_S = 5e-3


def cli_flags(config) -> list[str]:
    """The CLI flags that give ``config``: every field that differs from
    its default."""
    import dataclasses

    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )

    defaults = ExperimentConfig()
    flags = []
    for f in dataclasses.fields(config):
        value = getattr(config, f.name)
        if f.name == "dataset_args" or value == getattr(defaults, f.name):
            continue
        flags += [f"--{f.name}",
                  json.dumps(value) if isinstance(value, dict)
                  else str(value)]
    return flags


def rank_worker(out_path: str, argv: list[str],
                owner_order: int = 0) -> None:
    """One process of ``multihost_fed``: the CLI's ``main(argv)`` with
    each round's global params digested (and round 0's saved beside
    ``out_path``), the kernels' launches split into training and server
    eval (and by card), then this process's clock offset; writes
    ``out_path``. ``owner_order`` (a rank count): a one-process streamed
    run is handed each cohort in the rows that so many ranks of the
    distributed store would train it in (:func:`_owner_ordered`)."""
    import hashlib

    import torch

    from distributed_learning_simulator_tpu_torch import factory, simulator
    from distributed_learning_simulator_tpu_torch.config import get_config
    from distributed_learning_simulator_tpu_torch.ops import gn_cuda as gn
    from distributed_learning_simulator_tpu_torch.ops import wgrad_cuda as wg
    from distributed_learning_simulator_tpu_torch.parallel import (
        mesh as mesh_mod,
    )
    from distributed_learning_simulator_tpu_torch.parallel import multihost

    def counts():
        return {"gn_stats": gn.gn_stats.launches,
                "gn_normalize": gn.gn_normalize.launches,
                "conv3x3_wgrad": wg.conv3x3_wgrad.launches}

    def counts_by_device():
        return {w.__name__: dict(w.launches_by_device)
                for w in (gn.gn_stats, gn.gn_normalize, wg.conv3x3_wgrad)}

    cls = factory._ALGORITHMS[get_config(argv).distributed_algorithm]
    original = cls.post_round
    digests = []
    # The launches of post_round (the Shapley algorithms' subset
    # evaluations, which may call the eval function), by kernel and card.
    post_round_launches = {}
    in_post_round = False

    def probed(self, ctx):
        nonlocal in_post_round
        flat = ctx.global_params.detach().float().cpu()
        digests.append(hashlib.sha256(flat.numpy().tobytes()).hexdigest())
        if ctx.round_idx == 0:
            torch.save(flat, out_path + ".round0.pt")
        before = counts_by_device()
        in_post_round = True
        try:
            out = original(self, ctx)
        finally:
            in_post_round = False
        for name, by_device in counts_by_device().items():
            mine = post_round_launches.setdefault(name, {})
            for dev, n in by_device.items():
                if n != before[name].get(dev, 0):
                    mine[dev] = (mine.get(dev, 0) + n
                                 - before[name].get(dev, 0))
        return out

    eval_launches = dict.fromkeys(counts(), 0)
    make_eval = simulator.make_eval_fn

    def counted_eval_fn(*args, **kwargs):
        evaluate = make_eval(*args, **kwargs)

        def counted(*a, **k):
            before = counts()
            out = evaluate(*a, **k)
            if not in_post_round:  # the Shapley evaluators' own
                for name, n in counts().items():
                    eval_launches[name] += n - before[name]
            return out

        return counted

    # The distributed store's per-client state as each round receives it:
    # its rows' ids, which rows came by the exchange, and, from round 1 on
    # (when clients hold state of their own), the rows themselves (the
    # round trains from copies, so these stay as they were sent).
    from distributed_learning_simulator_tpu_torch.parallel import streaming

    received = []
    dist_gather = streaming.DistributedCohortStreamer.gather_state

    def probed_gather(self, ex, like):
        state = dist_gather(self, ex, like)
        if state is not None:
            received.append((
                self.span_round, ex.plan.idx_perm[ex.blo:ex.bhi],
                ex.in_rows_rel,
                next(p for p in state.parts if p is not None)
                if self.span_round else None))
        return state

    cls.post_round = probed
    streaming.DistributedCohortStreamer.gather_state = probed_gather
    if owner_order:
        _owner_ordered(streaming, get_config(argv), owner_order)
    simulator.make_eval_fn = counted_eval_fn
    gn.reset_launch_counts()
    wg.reset_launch_counts()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    result = simulator.main(argv)
    if cuda:
        torch.cuda.synchronize()
    launches = counts()
    offset, uncertainty = multihost.estimate_clock_alignment()
    mesh = result["mesh"]
    with open(out_path, "w") as f:
        json.dump({
            "device": result["device"],
            "params_device": {str(v.device)
                              for v in result["global_params"].values()
                              }.pop(),
            "mesh": None if mesh is None else mesh.describe(),
            "rank": multihost.process_index(),
            "digests": digests,
            "test_loss": [h["test_loss"] for h in result["history"]],
            "test_accuracy": [h["test_accuracy"]
                              for h in result["history"]],
            "cohort_hash": [h.get("cohort_hash") for h in result["history"]],
            # The Shapley algorithms' values a round, client by client, and
            # GTG's walk.
            "shapley_values": [
                [float(v) for _, v in sorted(sv.items())]
                for _, sv in sorted(getattr(result["algorithm"],
                                            "shapley_values", {}).items())],
            "gtg": [{k: h.get(k) for k in ("gtg_permutations",
                                            "gtg_subset_evals",
                                            "gtg_converged")}
                    for h in result["history"]],
            # The distributed shard store's round records and totals.
            "multihost": [h.get("multihost") for h in result["history"]],
            "spans": [h.get("spans") for h in result["history"]],
            "multihost_summary": result["multihost_summary"],
            "stream_dcn_bytes": result["stream_dcn_bytes"],
            "round_seconds": [h["round_seconds"]
                              for h in result["history"]],
            "launches": launches,
            "launches_by_device": counts_by_device(),
            "eval_launches": eval_launches,
            "post_round_launches_by_device": post_round_launches,
            "train_launches": {k: launches[k] - eval_launches[k]
                               for k in launches},
            "gathers": mesh_mod.gather_stats(),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated() if cuda
                                  else None),
            "peak_memory_by_device": {
                f"cuda:{i}": torch.cuda.max_memory_allocated(i)
                for i in range(torch.cuda.device_count() if cuda else 0)},
            "clock": {"offset_s": offset, "uncertainty_s": uncertainty},
            "received_state": [
                {"round": rnd, "ids": ids.tolist(),
                 "exchanged_rows": rows.tolist(),
                 "digests": None if tree is None else _row_digests(
                     [t.detach().cpu().numpy() for t in _key_leaves(tree)])}
                for rnd, ids, rows, tree in received],
        }, f)


def rank_worker_args(argv: list[str]) -> tuple[str, list[str], int]:
    """:func:`rank_worker`'s arguments from ``... --rank-worker OUT
    [--owner-order=N] -- FLAGS``."""
    at, end = argv.index("--rank-worker"), argv.index("--")
    owner_order = 0
    for option in argv[at + 2:end]:
        if option.startswith("--owner-order="):
            owner_order = int(option.split("=", 1)[1])
    return argv[at + 1], argv[end + 1:], owner_order


def _owner_ordered(streaming, config, n_ranks: int) -> None:
    """The one-process streamer (``CohortStreamer``) hands each round its
    cohort in the rows of ``n_ranks`` ranks of the distributed store:
    owner-grouped rows (data/residency.plan_owner_assembly over equal
    owner slices and cohort blocks), each row's keys and failure flag taken
    from its draw position through ``draw_pos``, its state gathered and
    written back by client id. Only the row order moves against the
    draw-order run."""
    import numpy as np

    from distributed_learning_simulator_tpu_torch.data.residency import (
        host_axis_bounds,
        plan_owner_assembly,
    )

    owners = host_axis_bounds(config.worker_number, [1] * n_ranks)
    cohort = config.cohort_size()
    blocks = np.arange(n_ranks + 1, dtype=np.int64) * (cohort // n_ranks)
    plans = {}
    base = streaming.CohortStreamer
    acquire = base.acquire_plan

    def plan(self, idx):
        p = plan_owner_assembly(np.asarray(idx, np.int64), owners, blocks)
        plans[p.idx_perm.tobytes()] = p
        return p.idx_perm

    def acquire_plan(self, rows):
        (x, y, m, s, idx, _), stats, rows = acquire(self, rows)
        return ((x, y, m, s, idx, plans[rows.tobytes()].draw_pos), stats,
                rows)

    base.plan = plan
    base.acquire_plan = acquire_plan
    base.cohort_ids = lambda self, rows: plans[rows.tobytes()].idx


def _key_leaves(tree) -> list:
    """A state tree's leaves in key order (a bare array is one leaf)."""
    return ([tree[k] for k in sorted(tree)] if isinstance(tree, dict)
            else [tree])


def _row_digests(leaves) -> list[str]:
    """One sha256 a row over the bytes of that row of every leaf (numpy
    leaves in key order)."""
    import hashlib

    import numpy as np

    out = []
    for i in range(leaves[0].shape[0]):
        h = hashlib.sha256()
        for leaf in leaves:
            h.update(np.ascontiguousarray(leaf[i]).tobytes())
        out.append(h.hexdigest())
    return out


#: Every process the launchers below started, so that a failure in one
#: of several arms run at once (chip_multicard.py) can stop the others'.
CHILDREN: list = []


def kill_children() -> None:
    for p in CHILDREN:
        if p.poll() is None:
            p.kill()


def launch_ranks(work: str, runs: dict, timeout: float,
                 phase: str = "multihost_fed",
                 worker_options: tuple = (), script: str | None = None,
                 envs: dict | None = None, worker: str = "--rank-worker"
                 ) -> dict:
    """Start every ``runs[name]`` (CLI flags) as a :func:`rank_worker`
    process at once (``worker_options``, e.g. ``("--owner-order=2",)``,
    passed to each worker; ``script`` runs the workers, this one by
    default, as its ``worker`` mode; ``envs[name]`` joins that process's
    environment); wait for all within ``timeout``,
    killing every one of them when the time runs out or one fails.
    Returns ``{name: its output}``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = {}
    for name, flags in runs.items():
        out = os.path.join(work, f"{name}.json")
        log_path = os.path.join(work, f"{name}.log")
        with open(log_path, "w") as log_f:
            procs[name] = (subprocess.Popen(
                [sys.executable, script or os.path.abspath(__file__),
                 worker, out, *worker_options, "--", *flags],
                cwd=repo, env=dict(env, **(envs or {}).get(name, {})),
                stdout=log_f, stderr=subprocess.STDOUT),
                out, log_path)
        CHILDREN.append(procs[name][0])
    deadline = time.monotonic() + timeout
    failed = None
    while failed is None and any(p.poll() is None
                                 for p, _, _ in procs.values()):
        for name, (p, _, _) in procs.items():
            if p.poll() not in (None, 0):
                failed = f"{name} exited {p.returncode}"
        if time.monotonic() > deadline:
            failed = f"timed out after {timeout:.0f}s"
        time.sleep(0.2)
    for name, (p, _, _) in procs.items():
        if failed is None and p.returncode != 0:
            failed = f"{name} exited {p.returncode}"
    if failed is not None:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        tails = "\n".join(
            f"--- {name}:\n" + open(log_path).read()[-3000:]
            for name, (_, _, log_path) in procs.items())
        fail(f"{phase}: {failed}; every process stopped\n{tails}")
    out = {}
    for name, (_, path, _) in procs.items():
        with open(path) as f:
            out[name] = json.load(f)
        out[name]["round0_path"] = path + ".round0.pt"
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_config(work: str):
    """``multihost_fed``'s configuration: ``sweep_fleet``'s ResNet-18
    ``fed`` (module docstring) at chunk 10 with span journals, logging
    under ``work``; without the size-aware schedule, which a mesh withholds,
    so that the solo run trains the same chunks."""
    import dataclasses

    return dataclasses.replace(
        path_configs(SWEEP_CLIENTS, 2000, 1000, "INFO")["fed"],
        client_chunk_size=10, span_trace="on", bucket_client_work=False,
        log_root=os.path.join(work, "log"))


def multihost_fed(torch, work: str) -> dict:
    """Phase 2z: ``multihost_fed`` (module docstring): two ranks of the
    client-axis mesh on the one card, against the same run in one process
    without a mesh, and the one-process shortfall refusal."""
    import dataclasses

    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    import gc

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # The ranks share the card with this process: hand its cached blocks
    # back first (the residency traces alone reserve ~55 GiB).
    gc.collect()
    torch.cuda.empty_cache()
    log(f"multihost_fed: this process holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    config = multihost_config(work)
    flags = cli_flags(dataclasses.replace(
        config, span_dir=os.path.join(work, "spans")))
    address = f"127.0.0.1:{free_port()}"
    ranks = launch_ranks(work, {
        f"rank{r}": flags + [
            "--multihost", "true", "--coordinator_address", address,
            "--num_processes", "2", "--process_id", str(r),
            "--mesh_devices", "2"]
        for r in range(2)}, MULTIHOST_TIMEOUT_S)
    # The one-process run after the ranks, so that neither shares the
    # card or the host with the other's round seconds.
    solo = launch_ranks(work, {"solo": cli_flags(dataclasses.replace(
        config, span_dir=os.path.join(work, "spans_solo")))},
        MULTIHOST_TIMEOUT_S)["solo"]
    r0, r1 = ranks["rank0"], ranks["rank1"]
    for name, r in ranks.items():
        if (r["device"] != "cuda:0" or r["params_device"] != "cuda:0"
                or r["mesh"] is None or r["mesh"]["backend"] != "gloo"
                or r["mesh"]["devices"] != ["cuda:0", "cuda:0"]):
            fail(f"multihost_fed {name}: device {r['device']}, params on "
                 f"{r['params_device']}, mesh {r['mesh']}")
        if min(r["launches"].values()) <= 0:
            fail(f"multihost_fed {name}: a kernel never launched "
                 f"{r['launches']}")
        if r["eval_launches"] != solo["eval_launches"]:
            fail(f"multihost_fed {name}: eval launches {r['eval_launches']}"
                 f", the solo run's {solo['eval_launches']}")
    summed = {k: r0["train_launches"][k] + r1["train_launches"][k]
              for k in r0["train_launches"]}
    if summed != solo["train_launches"]:
        fail(f"multihost_fed: the ranks' training launches sum to {summed}, "
             f"the solo run's are {solo['train_launches']}")
    if r0["digests"] != r1["digests"] or len(r0["digests"]) != config.round:
        fail("multihost_fed: the ranks' global params differ after a round")
    p_rank = torch.load(r0["round0_path"])
    p_solo = torch.load(solo["round0_path"])
    for r in (r0, r1, solo):  # 45 MB each
        os.remove(r["round0_path"])
    max_diff = float((p_rank - p_solo).abs().max())
    bitwise = bool(torch.equal(p_rank, p_solo))
    if not (bitwise or torch.allclose(p_rank, p_solo, rtol=1e-6, atol=0)):
        fail(f"multihost_fed: round 0 params differ from the solo run's by "
             f"up to {max_diff:.3e} (beyond rtol 1e-6)")
    for rnd, (a, b) in enumerate(zip(r0["test_loss"], solo["test_loss"])):
        if not math.isclose(a, b, rel_tol=MULTIHOST_LOSS_RTOL):
            fail(f"multihost_fed round {rnd}: test loss {a} against the "
                 f"solo run's {b} (beyond rtol {MULTIHOST_LOSS_RTOL})")
    clock = r1["clock"]
    if abs(clock["offset_s"]) > clock["uncertainty_s"] + CLOCK_SLACK_S:
        fail(f"multihost_fed: process 1's clock offset {clock}")
    try:
        run_simulation(dataclasses.replace(
            config, mesh_devices=2, span_trace="off", span_dir=None,
            round=1), setup_logging=False)
    except ValueError as e:
        if "requested 2 mesh devices but only 1 visible" not in str(e):
            raise
        shortfall = str(e)
    else:
        fail("multihost_fed: a one-process mesh_devices=2 ran on one card")
    rounds = config.round
    log(f"multihost_fed: two ranks on {r0['mesh']['devices']}, backend "
        f"{r0['mesh']['backend']} (the layout's choice); ranks bitwise "
        f"equal every round; round 0 "
        f"{'bitwise' if bitwise else 'not bitwise'} the solo run's (max "
        f"|diff| {max_diff:.3e}); test loss ranks {r0['test_loss']} solo "
        f"{solo['test_loss']}; round seconds rank0 {r0['round_seconds']} "
        f"rank1 {r1['round_seconds']} solo {solo['round_seconds']}; "
        f"gathers a round rank0 "
        f"{r0['gathers']['bytes'] / rounds / 2**20:.1f} MiB in "
        f"{r0['gathers']['seconds'] / rounds:.4f}s "
        f"({r0['gathers']['calls']} calls in all); peak memory rank0 "
        f"{r0['peak_memory_bytes'] / 2**30:.2f} GiB rank1 "
        f"{r1['peak_memory_bytes'] / 2**30:.2f} GiB solo "
        f"{solo['peak_memory_bytes'] / 2**30:.2f} GiB; launches rank0 "
        f"{r0['launches']} rank1 {r1['launches']} solo {solo['launches']}; "
        f"clock offset {clock}; shortfall refused: {shortfall}")
    return {"ranks": ranks, "solo": solo, "round0_bitwise": bitwise,
            "round0_max_abs_diff": max_diff, "shortfall": shortfall}


MULTIHOST_STREAM_CLIENTS = 40
MULTIHOST_STREAM_RTOL = 1e-4  # round 0: only the summation order moves
# Later rounds: f32 training from params a rounding apart (the witness).
MULTIHOST_STREAM_LATER_RTOL = 1e-3


def multihost_stream_config(work: str):
    """``multihost_stream``'s configuration: the flagship ``fed`` (module
    docstring) at 40 clients, a hashed half cohort, persistent momentum,
    chunk 10, a checkpoint every round, span journals, streamed; logging
    under ``work``; without the size-aware schedule, which a mesh
    withholds, so that the one-process run trains as many steps. The local
    state is f32: persistent optimizer state with bf16 local compute is
    refused (the JAX package's rule, config.py)."""
    import dataclasses

    return dataclasses.replace(
        path_configs(MULTIHOST_STREAM_CLIENTS, 4000, 1000, "INFO")["fed"],
        # Seed 1: round 1 spills client 6, which trained in round 0, so
        # the forward exchange carries momentum of its own.
        seed=1, local_compute_dtype="float32",
        client_chunk_size=10, participation_fraction=0.5,
        participation_sampler="hashed", reset_client_optimizer=False,
        client_residency="streamed", bucket_client_work=False,
        span_trace="on", log_root=os.path.join(work, "log"))


def _gib(n) -> str:
    return "n/a" if n is None else f"{n / 2**30:.2f} GiB"


def _state_rows(path: str, lo: int, hi: int):
    """Rows ``lo:hi`` of the per-client state a checkpoint (a whole one or
    a rank's shard, utils/checkpoint.py) holds, as numpy leaves in key
    order."""
    from distributed_learning_simulator_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    state = load_checkpoint(path)["client_state"]
    return [leaf[lo:hi] for leaf in _key_leaves(state)]


def rank_devices(config, n_ranks: int, torch) -> list[str]:
    """Each rank's device of a run of ``n_ranks`` processes on this
    machine (parallel/multihost.rank_device: ``cuda`` takes the cards in
    turn)."""
    from distributed_learning_simulator_tpu_torch.parallel import multihost

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [str(multihost.rank_device(config.device, r, cards))
            for r in range(n_ranks)]


def multihost_stream(torch, work: str, config=None, n_ranks: int = 2,
                     phase: str = "multihost_stream",
                     script: str | None = None,
                     solo_cards: tuple | None = None,
                     beside=None) -> dict:
    """Phase 2zb: ``multihost_stream`` (module docstring): ``n_ranks``
    ranks of the distributed shard store, on the one card here (a gloo
    group), each on its own card in chip_multicard.py (NCCL), against one
    streamed process without a mesh. ``config`` replaces the phase's (the
    CPU tests' tiny MLP); ``script`` starts the ranks (launch_ranks);
    ``solo_cards`` (two card indices) runs the one-process run and the
    witness at once, each alone on its card, instead of one after the
    other. ``beside`` (a function of no arguments; not with
    ``solo_cards``) runs on a thread while the witness runs, whose round
    seconds nothing reads; its value is returned as ``beside``."""
    import dataclasses
    import gc

    import numpy as np

    from distributed_learning_simulator_tpu_torch.parallel import multihost

    if beside is not None and solo_cards is not None:
        raise ValueError("beside runs with the witness alone, not beside "
                         "solo_cards' one-process run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if config is None:
        config = multihost_stream_config(work)
    devices = rank_devices(config, n_ranks, torch)
    backend = multihost.choose_backend(devices)
    ckpt, solo_ckpt = os.path.join(work, "shards"), os.path.join(work, "solo")
    address = f"127.0.0.1:{free_port()}"
    # The ranks, then the one-process run, then the witness, one after
    # another: neither the ranks' round seconds nor the one-process run's
    # share the card or the host with another run (``beside`` runs with
    # the witness, whose seconds nothing reads). The witness is the one-process streamed run handed the
    # ranks' owner-grouped rows (draw_pos keeps each client's keys): it
    # moves only the row order against the one-process run, so its spread
    # from it is what the summation order alone gives; the ranks must
    # match it bit for bit, which leaves nothing to the exchange. A rank
    # trains its block of the cohort in chunks of at most the block's
    # rows, and a chunk's size moves its clients' training (the
    # convolutions' batch): both one-process runs train chunks of that
    # size.
    block = config.cohort_size() // n_ranks
    single = dataclasses.replace(
        config, client_chunk_size=min(config.client_chunk_size, block))
    ranks = launch_ranks(work, {
        f"rank{r}": cli_flags(dataclasses.replace(
            config, span_dir=os.path.join(work, "spans"),
            checkpoint_dir=ckpt, checkpoint_every=1)) + [
            "--multihost", "true", "--coordinator_address", address,
            "--num_processes", str(n_ranks), "--process_id", str(r),
            "--mesh_devices", str(n_ranks)]
        for r in range(n_ranks)}, MULTIHOST_TIMEOUT_S, phase, script=script)

    def one_process(name, run_config, options=(), card=None):
        return launch_ranks(
            work, {name: cli_flags(run_config)}, MULTIHOST_TIMEOUT_S, phase,
            worker_options=options, script=script,
            envs=None if card is None else {
                name: {"CUDA_VISIBLE_DEVICES": str(card)}})[name]

    runs = (("solo", dataclasses.replace(
                single, span_dir=os.path.join(work, "spans_solo"),
                checkpoint_dir=solo_ckpt, checkpoint_every=1)),
            ("witness", dataclasses.replace(single, span_trace="off"),
             (f"--owner-order={n_ranks}",)))
    beside_out = None
    if solo_cards is None:
        solo = one_process(*runs[0])
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            side = None if beside is None else pool.submit(beside)
            witness = one_process(*runs[1])
            if side is not None:
                beside_out = side.result()
    else:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            solo, witness = [f.result() for f in [
                pool.submit(one_process, *run, card=card)
                for run, card in zip(runs, solo_cards)]]
    os.remove(witness["round0_path"])
    p_rank = torch.load(ranks["rank0"]["round0_path"])
    p_solo = torch.load(solo["round0_path"])
    round0_diff = float((p_rank - p_solo).abs().max())
    scale = float(p_solo.abs().max())
    for r in (*ranks.values(), solo):  # 45 MB each
        os.remove(r["round0_path"])
    r0 = ranks["rank0"]
    rounds = config.round
    cohort = config.cohort_size()
    steps = -(-config.max_shard_size // config.batch_size) * config.epoch
    chunks = -(-block // config.client_chunk_size)
    predicted = {"gn_stats": rounds * steps * chunks * GN_PER_FORWARD,
                 "gn_normalize": rounds * steps * chunks * GN_PER_FORWARD,
                 "conv3x3_wgrad": rounds * steps * chunks * WGRAD_PER_STEP}
    for r, (name, run) in enumerate(ranks.items()):
        if (run["device"] != devices[r] or run["mesh"] is None
                or run["mesh"]["backend"] != backend
                or run["mesh"]["devices"] != devices):
            fail(f"{phase} {name}: device {run['device']}, mesh "
                 f"{run['mesh']} (expected {devices}, backend {backend})")
        if run["train_launches"] != predicted:
            fail(f"{phase} {name}: training launches "
                 f"{run['train_launches']}, its block predicts {predicted}")
        if run["eval_launches"] != solo["eval_launches"]:
            fail(f"{phase} {name}: eval launches "
                 f"{run['eval_launches']}, the solo run's "
                 f"{solo['eval_launches']}")
        if run["cohort_hash"] != solo["cohort_hash"]:
            fail(f"{phase} {name}: cohorts {run['cohort_hash']}, the "
                 f"solo run's {solo['cohort_hash']}")
        summary = run["multihost_summary"]
        if (summary is None or summary["hosts"] != n_ranks
                or summary["owned_clients"]
                != config.worker_number // n_ranks):
            fail(f"{phase} {name}: store summary {summary}")
        if (run["digests"] != r0["digests"]
                or len(run["digests"]) != rounds):
            fail(f"{phase}: {name}'s global params differ from rank0's "
                 "after a round")
    for rnd in range(rounds):
        names = [f"round_{rnd}.manifest.json"] + [
            f"round_{rnd}.host{h}-of-{n_ranks}.ckptshard"
            for h in range(n_ranks)]
        missing = [n for n in names
                   if not os.path.exists(os.path.join(ckpt, n))]
        if missing:
            fail(f"{phase}: round {rnd} lacks {missing}")
    # Round 0 starts every client from the same model: each client's
    # training, upload and new momentum are the one-process run's bitwise
    # (its keys follow it through draw_pos), and only the aggregate's
    # summation order moves. So the params agree to rounding, the test
    # metrics at rtol 1e-4, and each rank's shard holds exactly the
    # one-process run's state rows of the clients it owns: the exchange
    # and the owners' writeback checked bit for bit.
    owned = config.worker_number // n_ranks
    solo_rows = _state_rows(os.path.join(solo_ckpt, "round_0.ckpt"), 0,
                            config.worker_number)
    state_equal = all(
        all(np.array_equal(a, b[h * owned:(h + 1) * owned]) for a, b in zip(
            _state_rows(os.path.join(
                ckpt, f"round_0.host{h}-of-{n_ranks}.ckptshard"), 0, owned),
            solo_rows))
        for h in range(n_ranks))
    # Round 1 is the first whose clients hold state of their own: every
    # row of each rank's block, as the forward exchange hands it to the
    # round, must be the one-process run's round-0 state of that client.
    solo_digests = _row_digests(solo_rows)
    del solo_rows
    trained = {i for r in ranks.values() for rec in r["received_state"]
               if rec["round"] == 0 for i in rec["ids"]}
    received = {"rows": 0, "exchanged": 0, "trained_rows": 0,
                "trained_exchanged": 0, "mismatched": []}
    for name, r in ranks.items():
        recs = [rec for rec in r["received_state"] if rec["round"] == 1]
        if len(recs) != 1:
            fail(f"{phase} {name}: {len(recs)} state gathers in round 1")
        rec = recs[0]
        exchanged = set(rec["exchanged_rows"])
        for row, (i, digest) in enumerate(zip(rec["ids"], rec["digests"])):
            received["rows"] += 1
            received["exchanged"] += row in exchanged
            received["trained_rows"] += i in trained
            received["trained_exchanged"] += row in exchanged and i in trained
            if digest != solo_digests[i]:
                received["mismatched"].append((name, row, i))
    shard_mib = os.path.getsize(os.path.join(
        ckpt, f"round_0.host0-of-{n_ranks}.ckptshard")) / 2**20
    shutil.rmtree(ckpt)  # ~0.9 GB a shard
    shutil.rmtree(solo_ckpt)
    # Later rounds train from params a rounding apart, which f32 ResNet
    # training at this lr amplifies: the witness, which moves nothing but
    # the row order, spreads as far from the one-process run as the ranks
    # do. Test loss at rtol 1e-3, accuracy within two test samples.
    n_test = config.n_test
    bands = {
        "test_loss": [(MULTIHOST_STREAM_RTOL if rnd == 0
                       else MULTIHOST_STREAM_LATER_RTOL) * abs(b)
                      for rnd, b in enumerate(solo["test_loss"])],
        "test_accuracy": [MULTIHOST_STREAM_RTOL * abs(b) if rnd == 0
                          else 2.0 / n_test
                          for rnd, b in enumerate(solo["test_accuracy"])],
    }
    spread = {
        who: [abs(a - b) / abs(b) for a, b in zip(r["test_loss"],
                                                  solo["test_loss"])]
        for who, r in (("ranks", r0), ("witness", witness))}
    witness_bitwise = (witness["digests"] == r0["digests"]
                       and witness["test_loss"] == r0["test_loss"]
                       and witness["test_accuracy"] == r0["test_accuracy"])
    log(f"{phase}: round 0 params max |rank - solo| "
        f"{round0_diff:.3e} (max |p| {scale:.3e}); round 0 state rows "
        f"{'bitwise' if state_equal else 'NOT bitwise'} the solo run's; "
        f"round 1 received state {received}; test loss ranks "
        f"{r0['test_loss']} solo {solo['test_loss']} witness (owner "
        f"order) {witness['test_loss']}, params and metrics "
        f"{'bitwise' if witness_bitwise else 'NOT bitwise'} the ranks'; "
        f"relative spread from solo {spread}; accuracy ranks "
        f"{r0['test_accuracy']} solo "
        f"{solo['test_accuracy']} witness {witness['test_accuracy']}; bands "
        f"{bands}")
    if round0_diff > 1e-6 * scale:
        fail(f"{phase}: round 0 params {round0_diff:.3e} from the "
             f"solo run's (beyond 1e-6 x {scale:.3e})")
    if not state_equal:
        fail(f"{phase}: a rank's round 0 shard holds state rows "
             "other than the solo run's")
    if not received["trained_exchanged"]:
        fail(f"{phase}: no row exchanged for round 1 held state "
             f"of its own ({received}): the check saw only initial state")
    if received["mismatched"] or received["rows"] != cohort:
        fail(f"{phase}: round 1's received state rows (rank, row, "
             f"client) {received['mismatched']} are not the solo run's "
             f"round-0 state of those clients ({received['rows']} rows "
             f"checked)")
    if not witness_bitwise:
        fail(f"{phase}: the ranks' params or test metrics differ "
             f"from the one-process run on the same owner-grouped rows "
             f"(test loss {r0['test_loss']} against "
             f"{witness['test_loss']})")
    if witness["cohort_hash"] != solo["cohort_hash"]:
        fail(f"{phase}: the witness drew cohorts "
             f"{witness['cohort_hash']}, the solo run {solo['cohort_hash']}")
    for key in ("test_loss", "test_accuracy"):
        for rnd, (a, b, band) in enumerate(zip(r0[key], solo[key],
                                               bands[key])):
            if abs(a - b) > band:
                fail(f"{phase} round {rnd}: {key} {a} against the "
                     f"solo run's {b} (band {band:.3e})")
    for name, run in ranks.items():
        if (run["test_loss"], run["test_accuracy"]) != (
                r0["test_loss"], r0["test_accuracy"]):
            fail(f"{phase}: {name}'s test metrics differ from rank0's")
    runs = list(ranks.values())
    exchange = [
        {"spill_rows": r0["multihost"][i]["spill_rows"],
         "dcn_mib": r0["multihost"][i]["dcn_bytes"] / 2**20,
         "dcn_wait_s": [r["spans"][i]["dcn_wait_s"] for r in runs],
         "dcn_s": [r["spans"][i]["dcn_transfer_s"] for r in runs],
         "skew_ms": [r["spans"][i].get("spill_skew_ms") for r in runs]}
        for i in range(rounds)]
    log(f"{phase}: {n_ranks} ranks on {devices} (backend {backend}) "
        f"bitwise equal every round; cohorts the solo run's; exchange by "
        f"round {exchange}; round seconds "
        + "; ".join(f"{n} {r['round_seconds']}" for n, r in ranks.items())
        + f"; solo {solo['round_seconds']}; gathers "
        + "; ".join(f"{n} {r['gathers']}" for n, r in ranks.items())
        + "; peak memory "
        + "; ".join(f"{n} {_gib(r['peak_memory_bytes'])}"
                    for n, r in ranks.items())
        + f"; solo {_gib(solo['peak_memory_bytes'])}; launches "
        + "; ".join(f"{n} {r['launches']}" for n, r in ranks.items())
        + f" (training predicted {predicted}) solo {solo['launches']}; a "
        f"shard {shard_mib:.1f} MiB")
    return {"ranks": ranks, "solo": solo, "witness": witness,
            "devices": devices, "backend": backend,
            "witness_bitwise": witness_bitwise,
            "exchange": exchange, "bands": bands, "spread": spread,
            "round0_max_abs_diff": round0_diff,
            "round0_state_bitwise": state_equal,
            "round1_received_state": received,
            "predicted_train_launches": predicted, "shard_mib": shard_mib,
            "beside": beside_out}


#: A signalled rank's whole run, start-up included (the process group's
#: own timeout is 300 s: a rank that waited in a collective would pass
#: this limit first).
PREEMPT_EXIT_S = 150
#: The SIGTERM hook of robustness/chaos.py, fired after round 0's finalize.
SIGTERM_AFTER_ROUND_0 = {"DLS_CRASH_AT_ROUND": "0",
                         "DLS_CRASH_KIND": "sigterm"}
#: ``multihost_preempt``'s cases: (configuration, ranks signalled). A
#: collective on the signal path hangs a lone signalled rank; both
#: signalled, the streamed store must still write nothing off the cadence.
PREEMPT_CASES = (("streamed", "all"), ("streamed", "rank0"),
                 ("resident", "rank0"))
#: The JAX package's preemption texts (its simulator.py): the distributed
#: shard store's, process 0's forced write, and another process's.
PREEMPT_SHARDED = (
    "preempted at round {} (SIGTERM): sharded checkpoints persist on the "
    "checkpoint_every cadence only (last committed manifest is the resume "
    "point); exiting cleanly")
PREEMPT_WRITTEN = (
    "preempted at round {} (SIGTERM): final checkpoint {} written; exiting "
    "cleanly — resume with config.resume=True")
PREEMPT_NO_DIR = (
    "preempted at round {} (SIGTERM): no checkpoint_dir configured, "
    "exiting cleanly without persisting")


def preempt_configs(work: str, device: str = "cuda") -> dict:
    """``multihost_preempt``'s two configurations, the tiny MLP of the CPU
    tests (the mechanism is on the host): streamed over the distributed
    shard store (a hashed half cohort, momentum state, a checkpoint every
    2 of 2 rounds, so round 0 is off the cadence) and resident ``fed``
    (3 rounds, pipelined, a cadence of 5: every write is off it)."""
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )

    base = ExperimentConfig(
        dataset_name="synthetic", model_name="mlp",
        distributed_algorithm="fed", worker_number=8, round=2, epoch=1,
        learning_rate=0.1, n_train=256, n_test=128, log_level="INFO",
        device=device, log_root=os.path.join(work, "log"))
    return {
        "streamed": dataclasses.replace(
            base, momentum=0.9, reset_client_optimizer=False,
            client_residency="streamed", participation_fraction=0.5,
            participation_sampler="hashed", seed=6, checkpoint_every=2),
        "resident": dataclasses.replace(base, round=3, checkpoint_every=5),
    }


def _preempt_lines(path: str) -> list[str]:
    with open(path) as f:
        return [ln[ln.index("preempted at round"):].rstrip()
                for ln in f if "preempted at round" in ln]


def multihost_preempt(torch, work: str, configs: dict | None = None,
                      n_ranks: int = 2, phase: str = "multihost_preempt",
                      backend: str = "gloo") -> dict:
    """Phase 2zc: SIGTERM under multi-process runs (module docstring).
    Each case of ``PREEMPT_CASES`` whose configuration ``configs``
    holds (default :func:`preempt_configs`) runs as ``n_ranks`` ranks
    through the CLI, all at once: the SIGTERM hook on every rank
    (``all``) or on rank 0 alone (``rank0``). A signalled rank must exit 0
    within ``PREEMPT_EXIT_S`` and log the JAX package's text, once: under
    the distributed shard store the sharded one, with nothing written off
    the cadence; resident, process 0's forced ``round_N.ckpt`` (the only
    file) and the others' "no checkpoint_dir" text. Once a run's signalled
    ranks have exited, its other ranks (waiting in a collective the
    signalled rank left) are killed. Every rank must log ``backend``
    as its device group's."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if configs is None:
        configs = preempt_configs(work)
    repo = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    t0 = time.monotonic()
    for name, who in PREEMPT_CASES:
        if name in configs:
            config = configs[name]
            run = f"{name}_{who}"
            ckpt = os.path.join(work, run, "ckpt")
            os.makedirs(ckpt)
            flags = cli_flags(dataclasses.replace(
                config, checkpoint_dir=ckpt,
                log_root=os.path.join(work, run, "log"),
                span_dir=(os.path.join(work, run, "spans")
                          if config.span_trace == "on" else None)))
            address = f"127.0.0.1:{free_port()}"
            signalled = list(range(n_ranks)) if who == "all" else [0]
            procs = []
            for r in range(n_ranks):
                env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
                           **(SIGTERM_AFTER_ROUND_0 if r in signalled
                              else {}))
                log_path = os.path.join(work, run, f"rank{r}.log")
                with open(log_path, "w") as log_f:
                    procs.append((subprocess.Popen(
                        [sys.executable, "-m",
                         "distributed_learning_simulator_tpu_torch.simulator",
                         *flags, "--multihost", "true",
                         "--coordinator_address", address,
                         "--num_processes", str(n_ranks), "--process_id",
                         str(r), "--mesh_devices", str(n_ranks)],
                        cwd=repo, env=env, stdout=log_f,
                        stderr=subprocess.STDOUT), log_path))
                CHILDREN.append(procs[-1][0])
            runs[run] = {"config": name, "ckpt": ckpt, "procs": procs,
                         "signalled": signalled, "exit_s": {}}
    # Wait for the signalled ranks; kill a run's others once they are out.
    deadline = t0 + PREEMPT_EXIT_S
    pending = set(runs)
    while pending:
        for run in sorted(pending):
            info = runs[run]
            for r in info["signalled"]:
                p = info["procs"][r][0]
                if r not in info["exit_s"] and p.poll() is not None:
                    info["exit_s"][r] = time.monotonic() - t0
            if len(info["exit_s"]) == len(info["signalled"]):
                for r, (p, _) in enumerate(info["procs"]):
                    if r not in info["signalled"] and p.poll() is None:
                        p.kill()
                    p.wait()
                pending.discard(run)
        if pending and time.monotonic() > deadline:
            for info in runs.values():
                for p, _ in info["procs"]:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
            tails = "\n".join(
                f"--- {run} rank{r}:\n" + open(path).read()[-2000:]
                for run in sorted(pending)
                for r, (_, path) in enumerate(runs[run]["procs"]))
            fail(f"{phase}: signalled ranks of {sorted(pending)} still ran "
                 f"after {PREEMPT_EXIT_S}s; every process stopped\n{tails}")
        time.sleep(0.1)
    out = {}
    for run, info in runs.items():
        config = configs[info["config"]]
        streamed = config.client_residency == "streamed"
        ranks = []
        for r, (p, path) in enumerate(info["procs"]):
            ranks.append({"rc": p.returncode, "lines": _preempt_lines(path),
                          "exit_s": info["exit_s"].get(r)})
        files = sorted(os.listdir(info["ckpt"]))
        for r in info["signalled"]:
            rank = ranks[r]
            tail = open(info["procs"][r][1]).read()[-3000:]
            if rank["rc"] != 0:
                fail(f"{phase} {run}: signalled rank {r} exited "
                     f"{rank['rc']}\n{tail}")
            if len(rank["lines"]) != 1:
                fail(f"{phase} {run}: rank {r} logged {rank['lines']}, not "
                     f"one preemption line\n{tail}")
            if f"backend {backend}" not in open(info["procs"][r][1]).read():
                fail(f"{phase} {run}: rank {r}'s device group is not "
                     f"{backend}\n{tail}")
        done = int(ranks[0]["lines"][0].split()[3])
        for r in info["signalled"]:
            if streamed:
                want = PREEMPT_SHARDED.format(done)
            elif r == 0:
                want = PREEMPT_WRITTEN.format(done, os.path.join(
                    info["ckpt"], f"round_{done}.ckpt"))
            else:
                want = PREEMPT_NO_DIR.format(done)
            if ranks[r]["lines"] != [want]:
                fail(f"{phase} {run}: rank {r} logged {ranks[r]['lines']}, "
                     f"the JAX package's text is {want!r}")
        # Off the cadence: nothing sharded; resident, process 0's file.
        want_files = [] if streamed else [f"round_{done}.ckpt"]
        if (done + 1) % config.checkpoint_every == 0 or files != want_files:
            fail(f"{phase} {run}: preempted at round {done}, checkpoint "
                 f"directory {files} (expected {want_files}, off the "
                 f"cadence of {config.checkpoint_every})")
        out[run] = {"preempted_at": done, "files": files, "ranks": ranks,
                    "peers": [ranks[r]["rc"] for r in range(n_ranks)
                              if r not in info["signalled"]]}
    log(f"{phase}: " + "; ".join(
        f"{run} preempted at round {o['preempted_at']}, signalled ranks "
        f"out after "
        f"{[round(r['exit_s'], 1) for r in o['ranks'] if r['exit_s']]} s "
        f"(limit {PREEMPT_EXIT_S}), files {o['files']}, peers "
        f"{o['peers']}" for run, o in out.items())
        + f"; texts {[o['ranks'][0]['lines'][0] for o in out.values()]}")
    return out


def profile_rounds(torch, name, config):
    """Phase 3, where a round's time goes (informational, not a check): a
    configuration's whole run (main(): the ResNet paths at 5 clients, the
    headline at 10, one round each) under torch.profiler (whose trace
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
    # device time again, and so do the device spans of the round loop's
    # named regions (user annotations).
    averages = prof.key_averages()
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in averages
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
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


def wall_ms(torch, fn, repeats: int = 3) -> float:
    """Median synchronized wall ms of ``fn`` after one warm-up call: what
    a call costs the main path, host included."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append(1e3 * (time.perf_counter() - start))
    return statistics.median(samples)


def device_ops(torch, fn, top: int = 8) -> dict:
    """Device ms of one call of ``fn`` by operator (torch.profiler), and
    the share of the layout copies (``aten::copy_``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted(((e.key, e.self_device_time_total / 1e3)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda r: -r[1])
    total = sum(t for _, t in ops)
    copy = sum(t for k, t in ops if k == "aten::copy_")
    return {"device_ms": total, "copy_ms": copy,
            "copy_share": copy / total if total else None,
            "top": [{"op": k, "device_ms": t} for k, t in ops[:top]]}


def vmap_layers(torch):
    """Phase 3b (informational): the batched layers alone at the main
    paths' shapes, ResNet-18 at full width, bf16, the replayed init of seed
    0. One training step of ``make_chunk_train_fn`` (batch 25, bf16 local
    state, momentum 0.9) at chunks of 1, 8 and 40; one Shapley eval
    forward (``make_models_eval_fn``, B=1000, f32 subset models as the
    evaluator holds them) of M = 1, 4, 10, 16 models, vmapped and as M
    one-model forwards; device time by operator at chunk 40 and M = 16."""
    from distributed_learning_simulator_tpu_torch.models.bridge import (
        jax_leaf_order,
    )
    from distributed_learning_simulator_tpu_torch.models.registry import (
        ParamLayout,
        get_model,
        init_params,
    )
    from distributed_learning_simulator_tpu_torch.parallel import engine

    model = get_model("resnet18").cuda()
    params = init_params(model, (32, 32), seed=0)
    layout = ParamLayout.from_params(params, jax_leaf_order(model, (32, 32)))
    flat = layout.flatten(params).cuda()

    def apply_fn(views, x):
        return torch.func.functional_call(model, views, (x,))

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {"eval": [], "train": []}
    evaluate = engine.make_eval_fn(apply_fn)
    evaluate_models = engine.make_models_eval_fn(evaluate, layout)
    xb = torch.rand(1, EVAL_BATCH, 32, 32, 3, device="cuda", generator=gen)
    yb = torch.randint(0, 10, (1, EVAL_BATCH), device="cuda", generator=gen)
    mb = torch.ones(1, EVAL_BATCH, device="cuda")
    for m in (1, 4, 10, 16):
        models = flat + 1e-3 * torch.randn(m, flat.numel(), device="cuda",
                                           generator=gen)
        row = {
            "models": m,
            "vmapped_ms": wall_ms(torch, lambda: evaluate_models(
                models, xb, yb, mb)),
            "one_at_a_time_ms": wall_ms(torch, lambda: [
                evaluate(layout.unflatten(models[i]), xb, yb, mb)
                for i in range(m)]),
        }
        if m == 16:
            row["profile"] = device_ops(
                torch, lambda: evaluate_models(models, xb, yb, mb))
            # Whether cuDNN's autotuner (off in the port: it may pick
            # another algorithm in each run) finds faster grouped
            # convolutions: the next slice's question, not a setting.
            with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                            deterministic=False,
                                            allow_tf32=False):
                row["cudnn_benchmark"] = {
                    "vmapped_ms": wall_ms(torch, lambda: evaluate_models(
                        models, xb, yb, mb)),
                    "one_at_a_time_ms": wall_ms(torch, lambda: [
                        evaluate(layout.unflatten(models[i]), xb, yb, mb)
                        for i in range(m)])}
            log(f"eval forward of {m} models with cuDNN's autotuner: "
                f"vmapped {row['cudnn_benchmark']['vmapped_ms']:.1f} ms, one "
                f"at a time {row['cudnn_benchmark']['one_at_a_time_ms']:.1f}"
                " ms")
        out["eval"].append(row)
        log(f"eval forward of {m} models at B={EVAL_BATCH}: vmapped "
            f"{row['vmapped_ms']:.1f} ms, one at a time "
            f"{row['one_at_a_time_ms']:.1f} ms")
    for m in (1, 8, FLAGSHIP_CHUNK):
        train = engine.make_chunk_train_fn(
            apply_fn, engine.make_optimizer("sgd", 0.02, 0.9), layout, 1,
            TRAIN_BATCH, compute_dtype=torch.bfloat16, device="cuda")
        xs = torch.rand(m, TRAIN_BATCH, 32, 32, 3, device="cuda",
                        generator=gen)
        ys = torch.randint(0, 10, (m, TRAIN_BATCH), device="cuda",
                           generator=gen)
        ms = torch.ones(m, TRAIN_BATCH, device="cuda")
        perms = torch.arange(TRAIN_BATCH).expand(m, 1, TRAIN_BATCH)

        def step():
            return train(flat, xs, ys, ms, perms, list(range(m)))

        row = {"chunk": m, "step_ms": wall_ms(torch, step)}
        row["ms_a_client"] = row["step_ms"] / m
        if m == FLAGSHIP_CHUNK:
            row["profile"] = device_ops(torch, step)
        out["train"].append(row)
        log(f"training step at chunk {m}: {row['step_ms']:.1f} ms "
            f"({row['ms_a_client']:.2f} a client)")
    for name, rows in out.items():
        for row in rows:
            p = row.get("profile")
            if p:
                log(f"{name} profile: device {p['device_ms']:.1f} ms, "
                    f"aten::copy_ {p['copy_ms']:.1f} ms; most: " + ", ".join(
                        f"{r['op']} {r['device_ms']:.1f}"
                        for r in p["top"][:6]))
    return out


@contextlib.contextmanager
def layout_arm(torch, arm: str):
    """The batched layouts of one A/B arm (``layout_ab``): ``port`` as
    committed; ``gn_folded``, where ``dls::group_norm``'s vmap rule always
    folds the models into the batch (ops/gn_cuda.py ``_group_norm_folded``)
    and never reads them on the channel side; ``functorch_conv``, where
    ResNet's convolutions run the ``dls::conv_nhwc*`` ops' one-model bodies
    as plain PyTorch code, which functorch vmaps with its own convolution
    rules instead of ops/conv.py's grouped channels-last ones."""
    from distributed_learning_simulator_tpu_torch.models import resnet
    from distributed_learning_simulator_tpu_torch.ops import conv
    from distributed_learning_simulator_tpu_torch.ops import gn_cuda

    rules, names = {}, {}
    if arm == "gn_folded":
        rules["dls::group_norm"] = (gn_cuda._group_norm_folded,
                                    gn_cuda._group_norm_vmap)
    elif arm == "functorch_conv":
        body = conv.conv_nhwc_op._init_fn

        def conv_nhwc(x, w, stride=1, padding=0):
            padding = [padding] * 4 if isinstance(padding, int) else padding
            return body(x, w, stride, list(padding), 1)

        names = {"conv_nhwc": conv_nhwc, "conv_nhwc_op": body}
    elif arm != "port":
        raise ValueError(arm)
    saved = {name: getattr(resnet, name) for name in names}
    for name, (rule, _) in rules.items():
        torch.library.register_vmap(name, rule)
    for name, fn in names.items():
        setattr(resnet, name, fn)
    try:
        yield
    finally:
        for name, (_, rule) in rules.items():
            torch.library.register_vmap(name, rule)
        for name, fn in saved.items():
            setattr(resnet, name, fn)


LAYOUT_ARMS = ("port", "gn_folded", "functorch_conv")


def layout_ab(torch, gn, wg, log_root: str):
    """Phase 3c: an end-to-end A/B of the batched layouts (``layout_arm``)
    on ``fed`` (the main path's configuration: chunks of 40 and 10) and on
    multi-round Shapley (N=4: one batch of 16 subset models a round), each
    run through run_path's gates, each arm once in the order A B C after
    one run of ``fed`` that is not kept (without it, the arm run first
    was the slowest on ``fed`` in three calls, once while running the same
    training code as another arm; A B C C B A until the sweep phases
    came; Shapley's own warm-up run went with the ``multihost_stream``
    phase). Keeps each run's
    second-round seconds and its subset evaluations per second
    (informational: host variance moves round times between runs)."""
    configs = {
        "fed": path_configs(50, 5000, 2000, "WARNING")["fed"],
        "multiround_shapley_value":
            extra_path_configs(log_root)["multiround_shapley_value"],
    }
    run_path(torch, gn, wg, "fed [warm-up, not kept]", configs["fed"])
    runs = []
    for arm in LAYOUT_ARMS:
        for name, config in configs.items():
            probes = [] if "shapley" in name else None
            with layout_arm(torch, arm):
                res = run_path(torch, gn, wg, f"{name} [{arm}]", config,
                               post_round_probe=probes)
            run = {"arm": arm, "path": name,
                   "round_seconds": res["round_seconds"]}
            if probes:
                run["subset_evals_per_s"] = [
                    p["models"] / p["seconds"] for p in probes]
            runs.append(run)
    summary = {}
    for name in configs:
        for arm in LAYOUT_ARMS:
            mine = [r for r in runs if r["arm"] == arm and r["path"] == name]
            summary[f"{name} [{arm}]"] = {
                "second_round_seconds": [r["round_seconds"][1]
                                         for r in mine],
                "subset_evals_per_s": [r.get("subset_evals_per_s")
                                       for r in mine],
            }
            log(f"layout A/B {name} [{arm}]: second-round seconds "
                f"{summary[f'{name} [{arm}]']['second_round_seconds']}"
                + ("" if "shapley" not in name else
                   f", subset evals/s {[r['subset_evals_per_s'] for r in mine]}"))
    return {"runs": runs, "summary": summary}


def redesign_lines(rows, wgrad_rows, batched_wgrad):
    """Prints the kernels redesigned for Hopper beside their yardsticks,
    bounds and earlier times (EARLIER_MS: PERF.md constants, not this
    run), at one client's shapes (B=25) and the wgrad kernel also at the
    flagship's chunk; returns the same numbers."""
    w = wgrad_rows["bf16"]
    w40 = batched_wgrad
    eval_row = next(r for r in rows if r["shape"][0] == EVAL_BATCH)
    train_rows = [r for r in rows if r["per_forward"]]
    stats, norm = (
        {f: sum(r["per_forward"] * r[key][f] for r in train_rows)
         for f in ("ms", "bound_ms")}
        for key in ("stats", "normalize_bf16"))
    stats["library_ms"] = sum(r["per_forward"] * r["library_ms"]
                              for r in train_rows)
    pair, alone = (sum(r["per_forward"] * r[k] for r in train_rows)
                   for k in ("pair_ms", "kernels_alone_ms"))
    out = {
        "conv3x3_wgrad_bf16": {"ms": w["ms"], "cudnn_ms": w["library_ms"],
                               "bound_ms": w["bound_ms"]},
        "conv3x3_wgrad_bf16_chunk": {"ms": w40["ms"],
                                     "cudnn_ms": w40["library_ms"],
                                     "bound_ms": w40["bound_ms"]},
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
        f"{w['bound_ms']:.4f}); {before[0]}; {before[1]}")
    log(f"redesigned conv3x3_wgrad bf16 {tuple(w40['shape'])}: "
        f"{w40['ms']:.4f} ms against cuDNN grouped wgrad "
        f"{w40['library_ms']:.4f} ms (bound {w40['bound_ms']:.4f}, "
        f"{w40['bound_ms'] / w40['ms']:.3f} of it); {before[2]}")
    log(f"redesigned gn_stats per training forward: {stats['ms']:.4f} ms "
        f"(bound {stats['bound_ms']:.4f}; F.group_norm, stats and normalize "
        f"together, {stats['library_ms']:.4f}); {before[3]}")
    log(f"redesigned gn_stats {tuple(eval_row['shape'])}: "
        f"{eval_row['stats']['ms']:.4f} ms (bound "
        f"{eval_row['stats']['bound_ms']:.4f}); {before[4]}")
    n = out["gn_normalize_per_training_forward"]
    log(f"redesigned gn_normalize per training forward, f32 scale/bias as "
        f"before: {n['f32_params_ms']:.4f} ms (bf16 scale/bias, as bf16 "
        f"training calls it: {n['ms']:.4f}; bound {n['bound_ms']:.4f}); "
        f"{before[5]}")
    log(f"redesigned gn_normalize {tuple(eval_row['shape'])}, f32 scale/bias "
        f"as before: {eval_row['normalize']['ms']:.4f} ms (bound "
        f"{eval_row['normalize']['bound_ms']:.4f}); {before[6]}")
    log(f"group_norm pair per training forward in one graph: {pair:.4f} ms "
        f"against {alone:.4f} ms for its two kernels alone (programmatic "
        f"dependent launch saves {alone - pair:.4f}); F.group_norm "
        f"{stats['library_ms']:.4f}")
    return out


def main() -> None:
    if "--rank-worker" in sys.argv:
        # A multihost_fed process:
        # chip_smoke.py --rank-worker OUT [--owner-order=N] -- FLAGS
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        rank_worker(*rank_worker_args(sys.argv))
        return
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
        from distributed_learning_simulator_tpu_torch.parallel.engine import (
            no_vmap_fallback,
        )
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
    # Every phase: an op with no batching rule raises (module docstring),
    # and the runs share their datasets' builds (shared_datasets).
    phases_scope = contextlib.ExitStack()
    phases_scope.enter_context(no_vmap_fallback())
    phases_scope.enter_context(shared_datasets())

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
    batched = phase("batched_kernels", check_batched, torch, gn, wg)
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
    chunks = phase("chunk_compare", compare_chunks, torch, gn, wg)
    work = os.path.join(os.path.abspath(args.out), "robustness")
    shutil.rmtree(work, ignore_errors=True)
    robust = robustness_configs(work)
    paths["fedopt_dropout"] = phase(
        "fedopt_dropout", run_fedopt_dropout, torch, gn, wg,
        robust["fedopt_dropout"])
    paths["fedavgm_reject"] = phase(
        "fedavgm_reject", run_fedavgm_reject, torch, gn, wg,
        robust["fedavgm_reject"])
    resume = phase("crash_resume", crash_resume, torch, gn, wg,
                   robust["crash_resume"], work)
    autodiff = phase("gn_autodiff", gn_autodiff, torch, gn, wg)
    shutil.rmtree(work)  # the phases' checkpoints, ~128 MiB each
    log_root = os.path.join(args.out, "log")
    paths["telemetry_fed"] = phase("telemetry_fed", telemetry_fed, torch, gn,
                                   wg, log_root, paths["fed"])
    detect = phase("client_stats_detect", client_stats_detect, torch, gn, wg)
    paths["threaded_fed"] = phase("threaded_fed", threaded_fed, torch, gn,
                                  wg, log_root)
    oracle_algos = phase("threaded_algos", threaded_algos, torch, gn, wg,
                         log_root)
    paths["valuation_fed"] = phase("valuation_fed", valuation_fed, torch, gn,
                                   wg, log_root)
    paths["spans_fed"] = phase("spans_fed", spans_fed, torch, gn, wg,
                               log_root)
    costmodel = phase("profile_costmodel", profile_costmodel, torch, gn, wg,
                      os.path.abspath(args.out))
    pipelining = phase("pipeline_ab", pipeline_ab, torch, gn, wg)
    batching = phase("round_batch", round_batch, torch, gn, wg, log_root)
    paths["async_fed"] = phase("async_fed", async_fed, torch, gn, wg,
                               log_root)
    oom = phase("oom_hint", oom_hint, torch, gn, wg)
    streamed, residency_trace = phase("stream_flagship", stream_flagship,
                                      torch, gn, wg,
                                      os.path.abspath(args.out))
    for name, runs in streamed.items():
        for residency, run in runs.items():
            paths[f"stream_{name}_{residency}"] = run
    population = phase("stream_population", stream_population, torch, gn,
                       wg)
    churn = phase("churn_headline", churn_headline, torch, gn, wg)
    for name, run in churn["runs"].items():
        paths[f"churn_{name}"] = run
    fleets = phase("sweep_fleet", sweep_fleet, torch, gn, wg)
    for name, run in fleets.items():
        paths[f"sweep_fleet_{name}"] = run
    scheduled = phase("sweep_scheduled", sweep_scheduled, torch,
                      os.path.abspath(args.out))
    multihost = phase("multihost_fed", multihost_fed, torch,
                      os.path.join(os.path.abspath(args.out), "multihost"))
    for name, run in dict(multihost["ranks"],
                          solo=multihost["solo"]).items():
        paths[f"multihost_fed_{name}"] = run

    def preempt():
        """``multihost_preempt`` beside ``multihost_stream``'s witness: its
        one timed quantity is a signalled rank's exit within its limit."""
        start = time.perf_counter()
        out = multihost_preempt(torch, os.path.join(
            os.path.abspath(args.out), "multihost_preempt"))
        phase_seconds["multihost_preempt"] = time.perf_counter() - start
        log(f"phase multihost_preempt: "
            f"{phase_seconds['multihost_preempt']:.1f}s (beside "
            "multihost_stream's witness)")
        return out

    mh_stream = phase("multihost_stream", lambda: multihost_stream(
        torch, os.path.join(os.path.abspath(args.out), "multihost_stream"),
        beside=preempt))
    preempted = mh_stream.pop("beside")
    for name, run in dict(mh_stream["ranks"], solo=mh_stream["solo"],
                          witness=mh_stream["witness"]).items():
        paths[f"multihost_stream_{name}"] = run
    # The ResNet paths at 5 clients (10 before the headline path: the
    # profiler's trace processing took most of the run), the headline at
    # 10 (50 samples each, as at 1000) with a 1000-sample eval; one round
    # each, which pays for the multihost_preempt phase.
    profile_configs = dict(path_configs(5, 500, 1000, "WARNING"))
    profile_configs["headline_cnn_tpu"] = headline_config(
        10, 500, 1000, 1000, log_level="WARNING")
    profile_configs = {name: dataclasses.replace(config, round=1)
                       for name, config in profile_configs.items()}
    profiles = phase("profiles", lambda: [
        profile_rounds(torch, name, config)
        for name, config in profile_configs.items()])
    layers = phase("vmap_layers", vmap_layers, torch)
    ab = phase("layout_ab", layout_ab, torch, gn, wg,
               os.path.join(args.out, "log"))
    # Launches over every main path (each counted from 0).
    launches = {
        k: sum(p["launches"][k] for p in paths.values())
        for k in ("gn_stats", "gn_normalize", "conv3x3_wgrad")
    }

    # The kernels at the shapes the main path gives them: a chunk of 40
    # clients. GroupNorm per batched training forward (each stage shape
    # times the GroupNorms that run at it, 1000 samples each, bf16
    # [40, C] scale/bias as bf16 local training hands them); the wgrad
    # kernel per batched call.
    kernels = []
    for name, key, replaces in (
        ("gn_stats", "stats",
         "distributed_learning_simulator_tpu/ops/gn_pallas.py:63"),
        ("gn_normalize", "normalize",
         "distributed_learning_simulator_tpu/ops/gn_pallas.py:75"),
    ):
        per_fwd = {
            f: sum(r["per_forward"] * r[key][f] for r in batched["gn"])
            for f in ("ms", "plain_ms", "bytes", "ops")
        }
        t_bytes = per_fwd["bytes"] / HBM_BYTES_PER_S
        t_ops = per_fwd["ops"] / F32_OPS_PER_S
        library = [r[key]["library_ms"] for r in batched["gn"]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distributed_learning_simulator_tpu_torch/csrc/gn.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r[key]["max_abs_err"] for r in batched["gn"]),
            "ms": per_fwd["ms"], "plain_ms": per_fwd["plain_ms"],
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if None in library else sum(
                r["per_forward"] * r[key]["library_ms"]
                for r in batched["gn"]),
        })
    w = batched["wgrad"]
    kernels.append({
        "name": "conv3x3_wgrad", "route": "cuda",
        "source": "distributed_learning_simulator_tpu_torch/csrc/wgrad.cu",
        "replaces": "scripts/exp_pallas_wgrad.py:63",
        "launches": launches["conv3x3_wgrad"],
        "max_abs_err": w["max_abs_err"], "ms": w["ms"],
        "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"], "library_ms": w["library_ms"],
    })
    phases_scope.close()
    redesigned = redesign_lines(rows, wgrad_rows, batched["wgrad"])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "kernel_rows": rows, "wgrad_rows": wgrad_rows,
                   "wgrad_sass_mma": sass, "redesigned": redesigned,
                   "batched_kernels": batched, "chunk_compare": chunks,
                   "earlier_ms": EARLIER_MS,
                   "kernels": kernels, "main_paths": paths,
                   "plain_models": plain_models,
                   "profiles": profiles, "vmap_layers": layers,
                   "layout_ab": ab, "crash_resume": resume,
                   "gn_autodiff": autodiff, "client_stats_detect": detect,
                   "threaded_algos": oracle_algos,
                   "profile_costmodel": costmodel, "round_batch": batching,
                   "pipeline_ab": pipelining,
                   "oom_hint": oom, "stream_population": population,
                   "residency_trace": residency_trace,
                   "churn_overhead_ratio": churn["churn_overhead_ratio"],
                   "sweep_scheduled": scheduled,
                   "multihost_fed": {k: v for k, v in multihost.items()
                                     if k not in ("ranks", "solo")},
                   "multihost_stream": {
                       k: v for k, v in mh_stream.items()
                       if k not in ("ranks", "solo", "witness")},
                   "multihost_preempt": preempted,
                   "phase_seconds": phase_seconds},
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
