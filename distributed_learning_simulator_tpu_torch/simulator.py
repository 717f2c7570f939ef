"""Simulation entry point and CLI (simulator.py of the JAX package), main path:
data, client data, init, per-client state, rounds, one server eval per round.

    python -m distributed_learning_simulator_tpu_torch.simulator \\
        --dataset_name cifar10 --model_name resnet18 --distributed_algorithm fed \\
        --worker_number 100 --round 2 --epoch 1 --learning_rate 0.02 \\
        --momentum 0.9 --batch_size 25 --partition dirichlet \\
        --max_shard_size 100 --client_chunk_size 40 \\
        --local_compute_dtype bfloat16 --device cuda

Runs on the card by default (``--device cuda``); with no card it raises
rather than carry on on the CPU. ``--device cpu`` is for tests.

``--client_chunk_size C`` trains C clients at once, one vmapped forward and
backward per step for the whole chunk (``0``: the footprint model picks C;
unset: the whole cohort at once; ``1``: one client at a time), as the JAX
package does.

``--telemetry_level basic|detailed`` times each round's phases, counts the
round programs' first-seen call signatures after the warmup round and
records the device-memory watermark (schema-v2 records);
``--client_stats on`` adds the per-client statistics and the anomaly
detector (v3), ``--client_valuation on`` the streaming valuation and, with
``--valuation_audit_every``, its GTG audit (v7); ``--span_trace on`` writes
a span journal (v12); ``--profile_dir`` records a torch.profiler trace
from ``--profile_from_round`` on, and ``--cost_model_trace`` prices such a
trace on the last record (v6). ``--async_mode on`` runs deadline rounds
with the staleness buffer (v4). ``--rounds_per_dispatch K`` runs K rounds
back to back with one metric fetch (the same records and parameters as
K=1). ``--execution_mode threaded`` runs the threaded oracle
(execution/threaded.py) instead of the round loop.

``--mesh_devices k`` splits the client axis over k devices
(parallel/mesh.py: CPU slots, or one process's cards); ``--multihost true
--coordinator_address H:P --num_processes n --process_id r`` runs one
process of n over a gloo process group (parallel/multihost.py), the mesh
over every process's device and only process 0 writing artifacts. With
``--client_residency streamed`` as well, each process owns a slice of the
population (the distributed shard store, parallel/streaming.py
``DistributedCohortStreamer``) and writes its own checkpoint shard, with
a manifest from process 0 (utils/checkpoint.py).

``--sweep_seeds 0,1,2`` and/or ``--sweep_points '[{"learning_rate":
0.05}, ...]'`` run a sweep of experiments instead of one (sweep/engine.py;
``--sweep_strategy``, ``--sweep_dir``, ``--sweep_resume``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import signal
import threading
import time
import traceback
import zlib
from collections.abc import Mapping

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.algorithms.base import RoundContext
from distributed_learning_simulator_tpu_torch.config import (
    ExperimentConfig,
    get_config,
)
from distributed_learning_simulator_tpu_torch.data.partition import (
    ClientData,
    dirichlet_partition,
    iid_partition,
    pack_client_shards,
)
from distributed_learning_simulator_tpu_torch.data.registry import (
    Dataset,
    get_dataset,
)
from distributed_learning_simulator_tpu_torch.data.residency import (
    DistributedShardStore,
    HostShardStore,
    host_axis_bounds,
)
from distributed_learning_simulator_tpu_torch.factory import get_algorithm
from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_leaf_order,
    jax_paths,
    params_from_jax,
    params_to_jax,
    tree_paths,
)
from distributed_learning_simulator_tpu_torch.models.registry import (
    ParamLayout,
    get_model,
    init_params,
)
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    make_batched_round_fn,
    make_decoder,
    make_eval_fn,
    make_optimizer,
    pad_eval_set,
)
from distributed_learning_simulator_tpu_torch.parallel.mesh import (
    Blocks,
    make_mesh,
    shard_client_data,
)
from distributed_learning_simulator_tpu_torch.parallel.multihost import (
    allgather_int64,
    allgather_wall_stamps,
    estimate_clock_alignment,
    initialize_multihost,
    local_device,
    mesh_devices_per_host,
    process_count,
    process_index,
)
from distributed_learning_simulator_tpu_torch.parallel.streaming import (
    CohortStreamer,
    DistributedCohortStreamer,
    host_client_state,
    state_to_device,
)
from distributed_learning_simulator_tpu_torch.robustness.arrivals import (
    AsyncFederation,
)
from distributed_learning_simulator_tpu_torch.robustness.chaos import (
    maybe_crash,
)
from distributed_learning_simulator_tpu_torch.robustness.population import (
    PopulationModel,
    pop_key_words,
)
from distributed_learning_simulator_tpu_torch.telemetry import (
    ClientStats,
    RecompileMonitor,
    detect_and_record,
    hbm_limit_bytes,
    log_round_compiles,
    make_phase_timer,
    peak_hbm_bytes,
    tracked,
)
from distributed_learning_simulator_tpu_torch.telemetry import clock
from distributed_learning_simulator_tpu_torch.telemetry.costmodel import (
    costmodel_record,
    ledger_totals,
)
from distributed_learning_simulator_tpu_torch.telemetry.spans import (
    SpanPhaseTimer,
    SpanRecorder,
)
from distributed_learning_simulator_tpu_torch.telemetry.valuation import (
    ClientValuation,
    ValuationAuditor,
    ValuationState,
    valuation_record,
)
from distributed_learning_simulator_tpu_torch.utils.checkpoint import (
    gc_checkpoints,
    gc_sharded_checkpoints,
    latest_checkpoint,
    load_latest_valid_checkpoint,
    load_latest_valid_sharded_checkpoint,
    manifest_checkpoint_path,
    manifest_rounds,
    save_checkpoint,
    save_shard_checkpoint,
    shard_checkpoint_path,
    validate_manifest,
    write_manifest,
)
from distributed_learning_simulator_tpu_torch.utils.errors import is_device_oom
from distributed_learning_simulator_tpu_torch.utils.logging import (
    get_logger,
    set_level,
    set_run_artifacts,
)
from distributed_learning_simulator_tpu_torch.utils.reporting import (
    build_round_record,
    cohort_crc,
)
from distributed_learning_simulator_tpu_torch.utils.tracing import (
    annotate,
    categorize_ops,
    profile_session,
)


#: The keys of ``run_simulation``'s result: the JAX package's, always all
#: present, plus ``device``.
RESULT_KEYS = (
    "global_params", "client_state", "history", "algorithm",
    "final_accuracy", "total_seconds", "client_rounds_per_sec",
    "client_chunk_size", "mesh", "rounds_rejected", "telemetry_level",
    "post_warmup_compiles", "mean_survivor_count", "clients_flagged",
    "async_speedup_ratio", "sim_clock_seconds", "mean_buffer_occupancy",
    "client_residency", "stream_overlap_ratio", "stream_h2d_bytes",
    "stream_d2h_bytes", "participation_sampler", "stream_sample_seconds",
    "stream_dcn_bytes", "multihost_summary", "costmodel",
    "client_valuation", "valuation", "valuation_state", "gtg_memo_hit_rate",
    "population", "population_summary", "span_trace", "span_summary",
    "preempted_at", "device",
)


def resolve_device(name: str) -> torch.device:
    """The run's device. A CUDA device with no card raises: the port never
    falls back to the CPU by itself."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={name!r} but torch.cuda.is_available() is False; "
                "pass --device cpu to run on the CPU"
            )
        # f32 convolutions and matmuls in full f32: cuDNN would otherwise
        # run f32 convs in TF32 (about three decimal digits). The bf16 model
        # path is unaffected; this keeps f32 runs comparable with the JAX
        # package's f32 numerics.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # Only cuDNN's deterministic algorithms: some of its f32 grouped
        # convolution algorithms accumulate with float atomics, so two runs
        # of one seed drifted apart. A seeded run reproduces bitwise, as
        # the JAX package's runs do.
        torch.backends.cudnn.deterministic = True
    return device


def device_memory_bytes(device: torch.device) -> int | None:
    """The card's memory, or None on the CPU, where the JAX package's
    memory stats are missing too (telemetry/memory.py, the one probe)."""
    return hbm_limit_bytes(device)


def _device_budget_bytes(config, device) -> float:
    """Usable device memory for per-client state: 60% of the device's
    memory times the mesh size; 16 GB when the device reports none (JAX
    simulator.py ``_device_budget_bytes``)."""
    hbm = device_memory_bytes(device) or 16 * 1024**3
    return 0.6 * hbm * (config.mesh_devices or 1)


def _persistent_state_factor(config) -> int:
    """Param-sized persistent per-client buffers: one per client for
    momentum sign_SGD or a persistent sgd optimizer, two for persistent
    adam."""
    if (
        config.distributed_algorithm == "sign_SGD"
        and config.momentum != 0.0
    ):
        return 1
    if not config.reset_client_optimizer:
        return 2 if config.optimizer_name.lower() in ("adam", "adamw") else 1
    return 0


def _resident_clients(config, n_clients: int) -> int:
    """Clients whose persistent arrays are on the device at once: the
    whole population when resident, the cohort when streamed."""
    if config.client_residency.lower() == "streamed":
        return config.cohort_size(n_clients)
    return n_clients


def _auto_chunk_size(config, n_params: int, n_clients: int,
                     device) -> int:
    """``client_chunk_size=0``: in-flight clients from the JAX package's
    footprint model (``_auto_chunk_size``): ~4x the f32 param bytes of
    transient state per in-flight client against the device budget, less
    the persistent per-client state, capped at the cohort. The chunk is
    what the round trains at once (parallel/engine.py
    ``make_chunk_train_fn``: the chunk's params, gradients, momenta and
    activations are in flight together), so the model sizes the port's
    memory as it does the JAX package's."""
    param_bytes = 4 * n_params
    budget = (
        _device_budget_bytes(config, device)
        - _persistent_state_factor(config)
        * _resident_clients(config, n_clients) * param_bytes
    )
    estimate = max(1, int(budget / (4 * param_bytes)))
    return min(estimate, config.cohort_size(n_clients))


def _f32_param_bytes(n_params: int) -> int:
    """Bytes of the model's parameters in f32."""
    return 4 * int(n_params)


def _assert_residency_feasible(config, n_params: int, n_clients: int,
                               data_bytes: int, device) -> None:
    """Refuse, with the JAX package's text, a run whose per-client arrays
    cannot fit the device (JAX simulator.py ``_assert_residency_feasible``).

    Resident: the packed shards and any persistent per-client state are
    ``[n_clients, ...]`` device stacks for the whole run. Streamed: the
    device holds the cohort's slice, twice when the next cohort is
    prefetched while one trains (once when the cohort is everyone: one
    upload at the start), plus the cohort's persistent state."""
    budget = _device_budget_bytes(config, device)
    param_bytes = _f32_param_bytes(n_params)
    factor = _persistent_state_factor(config)
    if config.client_residency.lower() == "streamed":
        cohort = config.cohort_size(n_clients)
        per_client_data = data_bytes / max(n_clients, 1)
        buffers = 2 if cohort < n_clients else 1
        total = buffers * cohort * per_client_data + (
            factor * cohort * param_bytes
        )
        if total > budget:
            buf_note = (
                f"{buffers} (double-buffered) x " if buffers > 1
                else "1 (full-cohort, one startup upload) x "
            )
            raise ValueError(
                "client_residency='streamed' cohort footprint does not "
                f"fit: {buf_note}{cohort} cohort clients x "
                f"{per_client_data / 2**20:.1f} MB data + {factor} "
                f"param-sized state buffer(s) x {param_bytes / 2**20:.0f} "
                f"MB = {total / 2**30:.1f} GB, over the "
                f"~{budget / 2**30:.1f} GB device budget. Lower "
                "participation_fraction (the cohort) or raise "
                "mesh_devices (streamed residency shards the cohort "
                "slice over the mesh)."
            )
        return
    total = data_bytes + factor * n_clients * param_bytes
    if total > budget:
        state_note = (
            f" + {factor} param-sized state buffer(s) x {n_clients} "
            f"clients x {param_bytes / 2**20:.0f} MB"
            if factor else ""
        )
        raise ValueError(
            "client_residency='resident' keeps every per-client array "
            f"device-resident: {data_bytes / 2**30:.1f} GB of packed "
            f"data shards{state_note} = {total / 2**30:.1f} GB, over "
            f"the ~{budget / 2**30:.1f} GB device budget "
            f"({config.mesh_devices or 1} device(s)). Set "
            "client_residency='streamed' to keep the population host-side "
            "and stream only the sampled cohort, or use more mesh_devices."
        )


def _assert_client_stack_feasible(config, n_params: int, n_clients: int,
                                  device) -> None:
    """Refuse, with the JAX package's text, a materializing round
    (``materializes_client_stack``) whose ``[cohort, P]`` f32 stack cannot
    fit the device budget; GTG's cumsum walk is budgeted at three stacks
    (JAX simulator.py ``_assert_client_stack_feasible``). Decided from the
    parameter count alone, before anything is allocated."""
    param_bytes = _f32_param_bytes(n_params)
    cohort = config.cohort_size(n_clients)
    stack_bytes = cohort * param_bytes
    carry_note = ""
    total_bytes = stack_bytes
    if (
        config.distributed_algorithm == "GTG_shapley_value"
        and config.gtg_prefix_mode == "cumsum"
    ):
        total_bytes = 3 * stack_bytes
        carry_note = (
            " plus up to 2 stack-sized cumsum-walk carry trees = "
            f"{total_bytes / 2**30:.1f} GB peak"
        )
    budget = _device_budget_bytes(config, device)
    if total_bytes > budget:
        raise ValueError(
            f"{config.distributed_algorithm!r} materializes the per-client "
            f"parameter stack: {cohort} clients x "
            f"{param_bytes / 2**20:.0f} MB = {stack_bytes / 2**30:.1f} GB"
            f"{carry_note}, "
            f"over the ~{budget / 2**30:.1f} GB device budget "
            f"({config.mesh_devices or 1} device(s)). Use fewer clients, a "
            "smaller model, or more mesh_devices."
        )


class _oom_hint:
    """Re-raise a device OOM with the JAX package's ``client_chunk_size``
    suggestion (JAX simulator.py ``_oom_hint``); at any site but
    ``"round"`` (``"eval"``, ``"deferred metric fetch"``) it also names
    ``eval_batch_size``. Wraps each place a round is dispatched,
    evaluated or fetched: ``with _oom_hint(config, n_params, n_clients,
    device): ...``.

    The OOM stays chained as the cause with the locals of its finished
    frames cleared, and the hint is raised from ``__exit__`` itself: a
    generator context manager would re-raise the OOM inside its own frame,
    whose finished frame object keeps its caller's, and so every frame up
    the stack, in a reference cycle with the OOM, holding the run's device
    memory until the next garbage collection."""

    def __init__(self, config, n_params: int, n_clients: int, device,
                 site: str = "round"):
        self._config = config
        self._n_params = n_params
        self._n_clients = n_clients
        self._device = device
        self._site = site

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is None or not is_device_oom(exc):
            return False
        traceback.clear_frames(tb)
        config, site = self._config, self._site
        cohort = config.cohort_size(self._n_clients)
        current = min(config.client_chunk_size or cohort, cohort)
        eval_note = (
            f" This OOM surfaced at {site}: if lowering client_chunk_size "
            f"doesn't help, also lower eval_batch_size "
            f"(currently {config.eval_batch_size})."
            if site != "round" else ""
        )
        param_bytes = _f32_param_bytes(self._n_params)
        estimate = _auto_chunk_size(config, self._n_params, self._n_clients,
                                    self._device)
        suggestion = min(estimate, max(1, current // 2))
        if suggestion >= current:
            raise RuntimeError(
                "device memory exceeded even with "
                f"client_chunk_size={current}; the model "
                f"(~{param_bytes / 2**20:.0f} MB of params) may not fit this "
                "device — use a smaller model or more mesh devices."
                + eval_note
            ) from exc
        raise RuntimeError(
            "device memory exceeded with "
            f"{current} clients in flight (per-client params/grads/momentum "
            "and activations scale with client_chunk_size). Try "
            f"client_chunk_size={suggestion}." + eval_note
        ) from exc


def build_client_data(config: ExperimentConfig, dataset: Dataset) -> ClientData:
    """Partition the training set into the packed client axis."""
    if config.partition == "iid":
        indices = iid_partition(
            len(dataset.x_train), config.worker_number, seed=config.seed
        )
    else:
        indices = dirichlet_partition(
            dataset.y_train, config.worker_number, config.dirichlet_alpha,
            seed=config.seed,
        )
    if config.max_shard_size:
        # Unbiased cap: partition index lists are dataset-ordered, so a
        # plain [:cap] would keep only low-index samples.
        rng = np.random.default_rng(config.seed + 17)
        indices = [
            rng.permutation(ix)[: config.max_shard_size] for ix in indices
        ]
    return pack_client_shards(
        dataset.x_train, dataset.y_train, indices,
        batch_size=config.batch_size,
        compact=config.compact_client_data,
    )


def _lr_factor(config, round_idx: int) -> float:
    """Per-round lr multiplier from config.lr_schedule."""
    s = config.lr_schedule.lower()
    if s == "constant":
        return 1.0
    horizon = config.lr_schedule_rounds or config.round
    if s == "cosine":
        progress = min(round_idx / max(horizon - 1, 1), 1.0)
        return config.lr_min_factor + (1.0 - config.lr_min_factor) * 0.5 * (
            1.0 + math.cos(math.pi * progress)
        )
    return config.lr_step_gamma ** (round_idx // config.lr_step_size)


def lr_factors(config, start: int, k: int) -> np.ndarray:
    """Schedule factors for rounds ``start .. start+k-1`` as f32."""
    return np.asarray(
        [_lr_factor(config, start + i) for i in range(k)], dtype=np.float32
    )


def build_base_round_record(config, round_idx: int, metrics: dict,
                            mean_client_loss: float, aux: dict, extra: dict,
                            round_seconds: float) -> dict:
    """The v1-layout base of one round's metrics record, fields and insert
    order as in the JAX package: the quorum fields and the sampled
    cohort's CRC come from the round's ``aux``."""
    record = {
        "round": round_idx,
        "test_accuracy": metrics["accuracy"],
        "test_loss": metrics["loss"],
        "mean_client_loss": float(mean_client_loss),
        "round_seconds": round_seconds,
        **{
            k: v for k, v in extra.items()
            if isinstance(v, (int, float, dict))
        },
    }
    if config.lr_schedule.lower() != "constant":
        record["lr_factor"] = _lr_factor(config, round_idx)
    if "survivor_count" in aux:
        record["survivor_count"] = int(aux["survivor_count"])
    if "round_rejected" in aux:
        record["round_rejected"] = bool(aux["round_rejected"])
    if "participants" in aux:
        # CRC of the sampled cohort, as the JAX package's records.
        record["cohort_hash"] = cohort_crc(aux["participants"],
                                           config.worker_number)
    return record


def start_fetch(tree: dict) -> tuple:
    """Start the device-to-host copies of ``tree`` (nested dicts of tensors
    and host values): one copy per dtype into pinned host memory, enqueued
    behind the work that computes the values and followed by an event, so
    that :func:`finish_fetch` waits for those values only, not for work
    enqueued after this call (a deferred fetch in the same stream would
    wait for the next round's training too). On the CPU the values are
    ready now."""
    leaves = []

    def collect(node):
        if isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, torch.Tensor):
            leaves.append(node)

    collect(tree)
    groups, events = [], []
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        group = [t for t in leaves if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(flat.device))
            events.append(event)
        else:
            host = flat
        groups.append((group, host))
    return tree, groups, events


def finish_fetch(started: tuple) -> dict:
    """The tree of :func:`start_fetch` with every tensor as a numpy array,
    once its copies have landed. Host values pass through."""
    tree, groups, events = started
    for event in events:
        event.synchronize()
    host = {}
    for group, flat in groups:
        flat = flat.numpy()
        offset = 0
        for t in group:
            host[id(t)] = flat[offset:offset + t.numel()].reshape(t.shape)
            offset += t.numel()

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return host[id(node)]
        return node

    return rebuild(tree)


def fetch_to_host(tree: dict) -> dict:
    """``tree`` (nested dicts of tensors and host values) with every tensor
    as a numpy array, fetched in one device-to-host copy per dtype: the
    round's one metric fetch. Host values pass through."""
    return finish_fetch(start_fetch(tree))


#: The async round's per-round scalars in aux (robustness/arrivals.py; the
#: carried ``async_state`` itself is popped before any record is built):
#: fetched with the round's metrics, rendered as the v4 ``async`` record.
ASYNC_AUX_KEYS = (
    "on_time_count", "late_count", "buffer_count", "buffer_applied",
    "mean_staleness", "sim_duration", "sim_duration_sync", "sim_clock",
)


class StackedAuxRow(Mapping):
    """Round i's view of a dispatch's stacked aux (``aux[name][i]``), sliced
    only where post_round reads it."""

    __slots__ = ("_aux_k", "_i")

    def __init__(self, aux_k: dict, i: int):
        self._aux_k = aux_k
        self._i = i

    def __getitem__(self, name):
        return self._aux_k[name][self._i]

    def __iter__(self):
        return iter(self._aux_k)

    def __len__(self):
        return len(self._aux_k)


def _algo_checkpoint_state(algorithm, metrics, server_state,
                           async_state=None, valuation=None,
                           population=None) -> dict:
    """The checkpoint's ``algo_state``: the last round's metrics, the
    Shapley values so far, the server optimizer's state when there is one,
    the staleness buffer (async_mode='on'), the valuation vector
    (client_valuation='on') and the registration stream's state
    (population='dynamic': cursor, alive mask, joined shards) (JAX
    simulator.py ``_algo_checkpoint_state``)."""
    algo_state = {"prev_metrics": metrics}
    if hasattr(algorithm, "shapley_values"):
        algo_state["shapley_values"] = algorithm.shapley_values
    if server_state is not None:
        algo_state["server_opt_state"] = server_state
    if async_state is not None:
        algo_state["async_state"] = async_state
    if valuation is not None:
        algo_state["valuation"] = np.asarray(valuation)
    if population is not None:
        algo_state["population"] = population
    return algo_state


def _local_client_state(client_state, device):
    """The whole per-client state for a checkpoint that process 0 writes
    alone (a preempted run's): blocks of a one-process mesh are copied
    together; blocks that other processes hold cannot be fetched without
    a collective, and the JAX package's ``device_get`` of such an array
    raises too."""
    if not isinstance(client_state, Blocks):
        return client_state
    if client_state.mesh.multiprocess:
        raise RuntimeError(
            "cannot write the preempted run's final checkpoint: the "
            "per-client state spans processes of the client-axis mesh "
            f"(ranks {sorted(set(client_state.mesh.ranks))}), and process 0 "
            "cannot fetch the other processes' blocks without a collective "
            "that a peer which never got the SIGTERM would not join; "
            "checkpoints on the checkpoint_every cadence hold it")
    return client_state.full(device)


def _structure(tree):
    """A tree's structure without its values (None, a leaf, or the dict of
    its keys' structures), for the resume checks."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None if tree is None else "leaf"


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 0 if tree is None else 1


def _restore_like(template, saved):
    """``saved`` (host arrays) as tensors on the devices and in the dtypes
    of ``template``'s leaves (Adam's step count stays on the host); a numpy
    leaf (the host shard store's state) stays a numpy array."""
    if isinstance(template, dict):
        return {k: _restore_like(template[k], saved[k]) for k in template}
    if template is None:
        return None
    if isinstance(template, np.ndarray):
        return np.array(saved, dtype=template.dtype)
    return torch.as_tensor(np.asarray(saved)).to(template.device,
                                                 template.dtype).clone()


def _load_resume_checkpoint(config, sharded: bool, n_clients: int,
                            owner_bounds=None):
    """The checkpoint a resume restores, as ``(path, payload)`` or
    ``(None, None)``: the newest valid single file, or, for a multihost
    streamed run (``sharded``), this rank's shard of the newest round
    whose manifest landed, checked against the live topology; its path is
    then the manifest's, the same on every rank. Each layout refuses a
    directory the other wrote, with the JAX package's texts."""
    directory = config.checkpoint_dir
    if not sharded:
        ckpt_path, ckpt = load_latest_valid_checkpoint(directory)
        if ckpt_path is None and manifest_rounds(directory):
            raise RuntimeError(
                f"checkpoint dir {directory!r} holds "
                "per-host sharded checkpoints (a multihost streamed "
                "run wrote them); resume under the multihost "
                "streamed topology they were written with — this "
                "run is "
                + ("multihost resident"
                   if config.multihost else "single-process")
            )
        return ckpt_path, ckpt
    n_procs = process_count()
    manifest, ckpt = load_latest_valid_sharded_checkpoint(
        directory, process_index(), n_procs)
    if manifest is None:
        if latest_checkpoint(directory):
            raise RuntimeError(
                "multihost streamed resume found only a "
                "single-file checkpoint in "
                f"{directory!r}: it was written by "
                "a single-process run and cannot be re-split "
                "into per-host shards; resume it on the "
                "topology it was written with"
            )
        return None, None
    validate_manifest(manifest, n_hosts=n_procs, n_clients=n_clients,
                      owner_bounds=owner_bounds)
    return manifest_checkpoint_path(directory, manifest["round"]), ckpt


def _resume(config, algorithm, model, sample_hw, layout, device,
            client_state, server_state, loaded):
    """Restore a run from ``loaded``, the ``(path, payload)`` of
    :func:`_load_resume_checkpoint`, with the JAX package's structure and
    configuration checks. Returns ``(start_round, global_flat or None,
    client_state, server_state, prev_metrics, key or None, algo_state or
    None, ckpt_path or None)``."""
    logger = get_logger()
    ckpt_path, ckpt = loaded
    if ckpt_path is None:
        return 0, None, client_state, server_state, None, None, None, None
    paths = jax_paths(model, sample_hw)
    if sorted(paths.values()) != tree_paths(ckpt["global_params"]):
        raise ValueError(
            "checkpoint global_params do not match this model's "
            f"parameter structure ({config.model_name!r}); the "
            "checkpoint was written with a different model or "
            "model version — resume with the configuration it was "
            "written with"
        )
    global_flat = layout.flatten(
        params_from_jax(ckpt["global_params"])).to(device)
    saved_cs = ckpt["client_state"]
    if _structure(client_state) != _structure(saved_cs):
        def describe(tree) -> str:
            n = _n_leaves(tree)
            return "no per-client state" if n == 0 else (
                f"per-client state with {n} leaves")

        raise ValueError(
            "checkpoint client_state does not match this "
            "configuration (e.g. momentum / reset_client_optimizer "
            "changed since the checkpoint was written): checkpoint "
            f"has {describe(saved_cs)}, config expects "
            f"{describe(client_state)}; resume with the configuration "
            "the checkpoint was written with"
        )
    client_state = _restore_like(client_state, saved_cs)
    algo_state = ckpt["algo_state"]
    saved_ss = algo_state.get("server_opt_state")
    if server_state is None and saved_ss is not None:
        raise ValueError(
            "checkpoint was written with a server optimizer but "
            "server_optimizer_name='none' now; resume with the "
            "configuration the checkpoint was written with"
        )
    if server_state is not None:
        if saved_ss is None:
            logger.warning(
                "checkpoint has no server optimizer state (written "
                "before the feature or with a different config); "
                "server optimizer restarts from fresh state"
            )
        elif _structure(server_state) != _structure(saved_ss):
            raise ValueError(
                "checkpoint server optimizer state does not match "
                f"server_optimizer_name="
                f"{config.server_optimizer_name!r}; resume with "
                "the configuration the checkpoint was written with"
            )
        else:
            server_state = _restore_like(server_state, saved_ss)
    if hasattr(algorithm, "shapley_values"):
        algorithm.shapley_values.update(algo_state.get("shapley_values", {}))
    start_round = ckpt["round_idx"] + 1
    logger.info("resumed from %s at round %d", ckpt_path, start_round)
    return (start_round, global_flat, client_state, server_state,
            algo_state.get("prev_metrics"), ckpt.get("rng_key"), algo_state,
            ckpt_path)


def _resume_population(pop, algo_state: dict):
    """The registration stream's state of a checkpoint, with the JAX
    package's checks: a dynamic run refuses a checkpoint without it, and a
    static run one with it."""
    saved = algo_state.get("population")
    if pop is not None and saved is None:
        raise ValueError(
            "population='dynamic' but the checkpoint has no "
            "registration-stream state (written with "
            "population='static'); resume with the configuration "
            "the checkpoint was written with"
        )
    if pop is None and saved is not None:
        raise ValueError(
            "checkpoint was written with population='dynamic' "
            "but population='static' now (the grown population "
            "and alive mask would be silently discarded); resume "
            "with the configuration the checkpoint was written "
            "with"
        )
    return saved


def _resume_async(async_ctl, async_state, algo_state: dict):
    """The staleness buffer of a checkpoint, with the JAX package's checks:
    a checkpoint written with async on refuses to resume with it off, and
    the other way round."""
    saved = algo_state.get("async_state")
    if async_ctl is None and saved is not None:
        raise ValueError(
            "checkpoint was written with async_mode='on' but "
            "async_mode='off' now (the staleness buffer would be "
            "silently discarded); resume with the configuration "
            "the checkpoint was written with"
        )
    if async_ctl is None:
        return async_state
    if saved is None:
        raise ValueError(
            "async_mode='on' but the checkpoint has no "
            "staleness-buffer state (written with "
            "async_mode='off'); resume with the configuration "
            "the checkpoint was written with"
        )
    return _restore_like(async_state, saved)


def run_simulation(
    config: ExperimentConfig,
    dataset: Dataset | None = None,
    client_data: ClientData | None = None,
    setup_logging: bool = True,
    client_rng_fn=None,
):
    """Run the federated simulation; returns a result dict.

    The round keys are the JAX package's: ``key = key(seed + 1)``, and each
    round ``key, round_key = split(key)`` (ops/prng.py), so a port run draws
    the reference's cohorts, batch orders and salts.
    ``client_rng_fn(round_idx)`` optionally returns the round's
    ``client_rng(client, n_slots) -> (epoch_perms, sr_salt)`` override.

    With ``checkpoint_dir`` and ``checkpoint_every`` a checkpoint is written
    every that many rounds (utils/checkpoint.py; ``checkpoint_keep_last``
    prunes older ones), and ``resume`` continues from the newest valid one.
    SIGTERM finishes the round in flight, writes a final checkpoint and
    returns with ``preempted_at`` set.
    """
    config.validate()
    if config.execution_mode.lower() == "threaded":
        # Honoured from every entry point, as in the JAX package; it
        # refuses multihost before any process group comes up.
        from distributed_learning_simulator_tpu_torch.execution.threaded import (  # noqa: E501
            run_threaded_simulation,
        )

        return run_threaded_simulation(
            config, dataset=dataset, client_data=client_data,
            setup_logging=setup_logging,
        )
    # Multihost: the process group comes up before any device query, then
    # the clock offset against process 0 for the span journals.
    span_on = config.span_trace.lower() == "on"
    clock_offset = clock_unc = 0.0
    if config.multihost:
        initialize_multihost(
            coordinator_address=config.coordinator_address,
            num_processes=config.num_processes,
            process_id=config.process_id,
            device=config.device,
        )
        if span_on:
            clock_offset, clock_unc = estimate_clock_alignment()
    device = resolve_device(str(local_device(config.device))
                            if config.multihost else config.device)
    logger = get_logger()
    set_level(config.log_level)
    # Only process 0 writes artifacts (the log file, metrics.jsonl,
    # checkpoints): every process runs the same rounds.
    is_primary = process_index() == 0
    if not is_primary:
        setup_logging = False
    log_dir = None
    if setup_logging:
        log_path, log_dir = set_run_artifacts(
            config.log_root, config.distributed_algorithm,
            config.dataset_name, config.model_name,
        )
        logger.info("log file: %s", log_path)

    # --- data ---------------------------------------------------------------
    if dataset is None:
        dataset = get_dataset(
            config.dataset_name, data_dir=config.data_dir, seed=config.seed,
            n_train=config.n_train, n_test=config.n_test,
            **config.dataset_args,
        )
    if client_data is None:
        client_data = build_client_data(config, dataset)
    n_clients = client_data.n_clients
    # Client residency (data/residency.py, parallel/streaming.py):
    # 'streamed' keeps the population's arrays in a host shard store and
    # uploads the sampled cohort a dispatch, the next one while the
    # current one trains; a full cohort (participation_fraction 1, e.g.
    # sign_SGD) is uploaded once and the round is the resident one.
    streamed = config.client_residency.lower() == "streamed"
    cohort_n = config.cohort_size(n_clients)
    stream_sampled = streamed and cohort_n < n_clients
    stream_full = streamed and not stream_sampled
    # The client-axis mesh (parallel/mesh.py): the device-resident client
    # axis splits into equal blocks, one a device: the population, or
    # under sampled streaming the cohort.
    mesh = None
    if config.mesh_devices and config.mesh_devices > 1:
        mesh = make_mesh(config.mesh_devices, device=device)
        shard_len = cohort_n if stream_sampled else n_clients
        if shard_len % config.mesh_devices != 0:
            what = ("cohort size (participation_fraction x worker_number)"
                    if stream_sampled else "worker_number")
            raise ValueError(
                f"{what} ({shard_len}) must be a multiple of "
                f"mesh_devices ({config.mesh_devices})"
            )
    # The distributed shard store (streamed x multihost): each process
    # owns a contiguous slice of the population, the mesh's per-process
    # device split sets the bounds, and each round's cohort is assembled
    # owner-sharded (parallel/streaming.DistributedCohortStreamer). One
    # process, multihost or not, runs the single-host streamed path.
    mh = streamed and config.multihost and process_count() > 1
    mh_owner_bounds = mh_block_bounds = None
    if mh:
        devs_per_host = mesh_devices_per_host(mesh)
        mh_owner_bounds = host_axis_bounds(n_clients, devs_per_host)
        # Full cohort: the upload axis is the client axis.
        mh_block_bounds = (host_axis_bounds(cohort_n, devs_per_host)
                           if stream_sampled else mh_owner_bounds)
    # The static size-aware regrouping is withheld under sharding, where
    # the blocks own the client axis's layout (as in the JAX package).
    sharded = config.multihost or mesh is not None
    xb, yb, mb = pad_eval_set(
        dataset.x_test, dataset.y_test, config.eval_batch_size
    )
    eval_batches = (
        torch.as_tensor(xb, device=device),
        torch.as_tensor(yb, dtype=torch.int64, device=device),
        torch.as_tensor(mb, device=device),
    )

    # --- model / optimizer / algorithm --------------------------------------
    sample_shape = dataset.x_train.shape[1:]
    model = get_model(
        config.model_name, num_classes=dataset.num_classes,
        input_shape=sample_shape, **config.model_args,
    ).to(device)
    params = init_params(model, sample_shape[:2], seed=config.seed)
    layout = ParamLayout.from_params(
        params, jax_leaf_order(model, sample_shape[:2])
    )
    global_flat = layout.flatten(params).to(device)
    if config.client_chunk_size == 0:  # auto
        # A local copy, as the JAX package resolves it: the caller's config
        # keeps auto for its next model.
        config = dataclasses.replace(
            config,
            client_chunk_size=_auto_chunk_size(
                config, global_flat.numel(), n_clients, device
            ),
        )
        logger.info(
            "auto client_chunk_size=%d (footprint model, %s params)",
            config.client_chunk_size, config.model_name,
        )

    def apply_fn(flat_views, x):
        return torch.func.functional_call(model, flat_views, (x,))

    # The algorithm first: sign_SGD refuses a non-SGD optimizer with the
    # JAX package's ValueError before the optimizer registry is asked.
    algorithm = get_algorithm(config.distributed_algorithm, config)
    optimizer = make_optimizer(
        config.optimizer_name, config.learning_rate,
        momentum=config.momentum, weight_decay=config.weight_decay,
    )
    K = config.rounds_per_dispatch
    if K > 1 and not algorithm.supports_round_batching:
        raise ValueError(
            f"algorithm {config.distributed_algorithm!r} does not support "
            "rounds_per_dispatch > 1: its post_round must observe every "
            "round (for the FedAvg family this includes client_eval=True "
            "and keep_client_params — their aux/post_round consume "
            "per-round parameter stacks); set rounds_per_dispatch=1"
        )
    # Asynchronous federation (robustness/arrivals.py): refused with the
    # cause where the round has no staleness buffer.
    async_ctl = AsyncFederation.from_config(config)
    if async_ctl is not None and not algorithm.supports_async:
        raise ValueError(
            f"algorithm {config.distributed_algorithm!r} does not support "
            "async_mode='on': its round program has no staleness buffer "
            "to hold late uploads; set async_mode='off'"
        )
    if streamed and not algorithm.supports_streamed_residency:
        raise ValueError(
            f"algorithm {config.distributed_algorithm!r} does not support "
            "client_residency='streamed': its round program assumes a "
            "device-resident per-client stack (the Shapley family's "
            "subset re-evaluation); set client_residency='resident'"
        )
    # Dynamic population (robustness/population.py): None when static.
    # The cohort stays at the startup population's size while N grows.
    pop = PopulationModel.from_config(config, n_clients, cohort_n,
                                      dataset=dataset)
    if pop is not None and not stream_sampled:
        raise ValueError(
            "population='dynamic' needs a sampled streamed cohort "
            f"(cohort {cohort_n} of {n_clients} clients is the whole "
            "population at this worker_number); raise worker_number or "
            "lower participation_fraction"
        )
    n_params = global_flat.numel()
    _assert_residency_feasible(
        config, n_params, n_clients,
        client_data.x.nbytes + client_data.y.nbytes
        + client_data.mask.nbytes + client_data.sizes.nbytes, device,
    )
    if algorithm.materializes_client_stack:
        _assert_client_stack_feasible(config, n_params, n_clients, device)
    if K > 1 and stream_sampled and _persistent_state_factor(config):
        # Cohorts inside one dispatch may overlap, and the host store
        # cannot take a round's state back mid-dispatch.
        raise ValueError(
            "client_residency='streamed' with rounds_per_dispatch > 1 "
            "does not compose with persistent per-client state "
            "(reset_client_optimizer=False / momentum sign_SGD under "
            "sampling): cohorts within one dispatch may overlap and the "
            "host store cannot be updated mid-dispatch; set "
            "rounds_per_dispatch=1 or client_residency='resident'"
        )
    evaluate = make_eval_fn(apply_fn)
    algorithm.prepare(apply_fn, evaluate, eval_batches)
    # The round programs count their first-seen call signatures for the
    # recompile counter (telemetry/recompile.py).
    server_eval = tracked("evaluate", evaluate)
    preprocess = (make_decoder(client_data.sample_shape)
                  if client_data.compact else None)
    round_fn = algorithm.make_round_fn(
        apply_fn, optimizer, layout, n_clients,
        preprocess=preprocess,
        client_sizes=None if sharded else client_data.sizes,
        device=device, mesh=mesh,
    )
    # A full streamed cohort gets the resident round function (the
    # algorithm builds the streamed convention only for a sampled cohort):
    # the population's arrays are uploaded once below and the round runs
    # as the resident one, so the two residency modes are bitwise equal.
    round_fn = tracked("round_fn", round_fn)
    # Optional server-side optimizer (FedAvgM / FedAdam) on the aggregate.
    server_state = server_update = None
    server = algorithm.make_server_update()
    if (
        server is None
        and config.server_optimizer_name.lower() not in ("none", "")
    ):
        raise ValueError(
            f"algorithm {config.distributed_algorithm!r} does not support a "
            "server optimizer; set server_optimizer_name='none'"
        )
    if server is not None:
        server_init, server_update = server
        server_update = tracked("server_update", server_update)
        server_state = server_init(global_flat)
    state_proto = None
    if streamed:
        # The population's state on the host: never a device stack. Under
        # the distributed store each process holds its own clients' rows
        # only (every client's initial state is the same).
        n_state = (int(mh_owner_bounds[process_index() + 1]
                       - mh_owner_bounds[process_index()])
                   if mh else n_clients)
        client_state, state_proto = host_client_state(
            algorithm, optimizer, global_flat, n_state)
    else:
        client_state = algorithm.init_client_state(optimizer, global_flat,
                                                   n_clients)
    # The staleness buffer (async_mode='on'): carried round to round,
    # checkpointed and restored, like the client state.
    async_state = (async_ctl.init_state(global_flat)
                   if async_ctl is not None else None)
    key = prng.key(config.seed + 1)
    start_round = 0
    prev_metrics = None
    resumed_valuation = None
    resumed_population = None
    if config.resume and config.checkpoint_dir:
        (start_round, resumed_global, client_state, server_state,
         prev_metrics, resumed_key, algo_state, ckpt_path) = _resume(
            config, algorithm, model, sample_shape[:2], layout, device,
            client_state, server_state,
            _load_resume_checkpoint(config, mh, n_clients, mh_owner_bounds))
        if config.multihost and process_count() > 1:
            # Every process restores from its own view of checkpoint_dir:
            # they must have restored the same checkpoint, or they would
            # run different rounds.
            basename = os.path.basename(ckpt_path) if ckpt_path else ""
            gathered = allgather_int64(
                [start_round, zlib.crc32(basename.encode())])
            if not (gathered == gathered[0]).all():
                raise RuntimeError(
                    "multihost resume mismatch: processes restored "
                    "different checkpoints (per-process [start_round, "
                    f"path_crc32] = {gathered.tolist()}); checkpoint_dir "
                    "must be a shared filesystem visible to every host "
                    "with an identical checkpoint set"
                )
        if resumed_global is not None:
            global_flat = resumed_global
        if resumed_key is not None:
            key = resumed_key
        if algo_state is not None:
            async_state = _resume_async(async_ctl, async_state, algo_state)
            resumed_valuation = algo_state.get("valuation")
            resumed_population = _resume_population(pop, algo_state)
    # Every process, not only process 0 as in the JAX package: a resident
    # multi-process run's checkpoint gathers the client-state blocks, a
    # collective that every process joins on the cadence.
    checkpointing = bool(config.checkpoint_dir and config.checkpoint_every)

    # --- placement ------------------------------------------------------------
    store = streamer = None
    stream_rec_startup = None  # the full cohort's one upload, on round 0
    if streamed:
        # A dynamic population relabels drifting clients in place: the
        # store takes its own copy of the labels.
        store_y = (np.array(client_data.y, copy=True) if pop is not None
                   else client_data.y)
        if mh:
            # This process keeps only its own slice of the population.
            store = DistributedShardStore(
                client_data.x, store_y, client_data.mask, client_data.sizes,
                state=client_state if stream_sampled else None,
                host_id=process_index(), owner_bounds=mh_owner_bounds,
            )
        else:
            store = HostShardStore(
                client_data.x, store_y, client_data.mask, client_data.sizes,
                state=(client_state if stream_sampled
                       and resumed_population is None else None),
            )
        if resumed_population is not None:
            # Resume mid-growth: the startup store grows by the
            # checkpoint's joined shards, then takes the (grown) state.
            pop.restore(resumed_population, store)
            if client_state is not None:
                store.attach_state(client_state)
            logger.info(
                "population resumed at cursor %d: %d registered, %d "
                "alive (%d joined, %d departed)",
                pop.cursor, pop.n_registered, int(pop.alive.sum()),
                pop.totals["joins"], pop.totals["departs"],
            )
        if mh:
            streamer = DistributedCohortStreamer(
                store, algorithm, n_clients, device, mesh, mh_block_bounds,
                client_data.sizes)
        else:
            streamer = CohortStreamer(store, algorithm, n_clients, device,
                                      mesh=mesh)
        if stream_full:
            # Under the distributed store every rank uploads its own slice
            # as its block (the config refuses persistent state there).
            (cx, cy, cmask, _, _), stream_rec_startup = streamer.upload_full()
            client_state = state_to_device(client_state, state_proto)
        else:
            cx = cy = cmask = None
            client_state = None
            if mh:
                logger.info(
                    "distributed shard store: host %d/%d owns %d of %d "
                    "clients (%.2f GB shard), cohort %d per dispatch",
                    store.host_id, store.n_hosts, store.n_owned,
                    n_clients, store.data_bytes() / 2**30, cohort_n,
                )
            else:
                logger.info(
                    "client_residency='streamed': %d clients host-resident "
                    "(%.2f GB), cohort %d per dispatch",
                    n_clients, store.data_bytes() / 2**30, cohort_n,
                )
    else:
        cx = torch.as_tensor(client_data.x, device=device)
        cy = torch.as_tensor(client_data.y, dtype=torch.int64, device=device)
        cmask = torch.as_tensor(client_data.mask, device=device)
    # The valuation audit replays cohorts from the unsharded arrays.
    audit_data = store if stream_sampled else (cx, cy, cmask)
    if mesh is not None:
        # Each block's rows and persistent state on its device; the global
        # model, the server state and the eval set stay on this process's.
        # A sampled streamed cohort lands in blocks a round; the
        # distributed store's full upload already did.
        if not mh:
            cx, cy, cmask = shard_client_data((cx, cy, cmask), mesh)
            client_state = shard_client_data(client_state, mesh)
        logger.info("client axis sharded over %d devices (%s, backend %s)",
                    mesh.size, ", ".join(str(d) for d in mesh.devices),
                    mesh.backend)
    # A joiner's state rows (stateful streamed runs): one client's initial
    # state, repeated per joiner.
    pop_state_proto = None
    if pop is not None and store.state is not None:
        pop_state_proto = host_client_state(
            algorithm, optimizer, global_flat, 1)[0]

    # --- telemetry ------------------------------------------------------------
    # Phase timing, the recompile counter and the memory watermark; span
    # journals; per-client statistics; client valuation; the cost model.
    # All off by default, and then the records are the v1 records.
    tel_level = config.telemetry_level.lower()
    phase_timer = make_phase_timer(tel_level)
    recompile = RecompileMonitor() if tel_level != "off" else None
    span_recorder = None
    if span_on:
        span_recorder = SpanRecorder(
            host_id=process_index(), n_hosts=process_count(),
            capacity=config.span_buffer_size,
            flush_last_k=config.span_flush_last_k,
        )
        span_journal_dir = config.span_dir or log_dir
        if span_journal_dir:
            logger.info(
                "span journal: %s (clock offset %+.6fs ± %.6fs vs host 0)",
                span_recorder.attach(span_journal_dir, clock_offset,
                                     clock_unc),
                clock_offset, clock_unc,
            )
        else:
            logger.warning(
                "span_trace='on' but this host has no artifacts dir and "
                "no span_dir; span journal disabled (in-memory flight "
                "recorder only) — set span_dir to a shared directory"
            )
        # Every phase boundary is also a span, at any telemetry_level.
        phase_timer = SpanPhaseTimer(phase_timer, span_recorder)
        if streamer is not None:
            streamer.span_recorder = span_recorder
            streamer.clock_offset_s = clock_offset
    client_stats_cfg = ClientStats.from_config(config)
    valuation_cfg = ClientValuation.from_config(config)
    vstate = auditor = None
    if valuation_cfg is not None:
        # Indexed by true client id: under streamed residency it lives in
        # the store and grows with a dynamic population.
        vstate = ValuationState(
            store.n_clients if store is not None else n_clients,
            store=store)
        if resumed_valuation is not None:
            vstate.load(resumed_valuation)
        elif start_round > 0:
            logger.warning(
                "checkpoint carries no valuation vector (written before "
                "the feature or with client_valuation='off'); valuation "
                "restarts from zero"
            )
        if valuation_cfg.audit_every > 0:
            auditor = ValuationAuditor(
                config, valuation_cfg, algorithm, apply_fn, optimizer,
                layout, preprocess, evaluate,
                audit_data, eval_batches,
                n_clients, device,
                budget_bytes=_device_budget_bytes(config, device),
            )
    # The cost model's ledger, read once from the reference trace.
    cost_ledger = None
    if config.cost_model_trace:
        cost_ledger = categorize_ops(config.cost_model_trace)
        if not cost_ledger or ledger_totals(cost_ledger)["bytes_gb"] <= 0:
            # A CPU trace has no device op: warn, never price nothing.
            logger.warning(
                "cost_model_trace %r holds no byte-annotated device-op "
                "events; cost model disabled for this run",
                config.cost_model_trace,
            )
            cost_ledger = None
    # Pipelined rounds (the JAX package's default): round r's metric fetch,
    # record, post_round and checkpoint run after round r+1 is dispatched,
    # so that they overlap its device work; the records and parameters
    # are those of the synchronous loop, only the fetch moves. Off where a
    # deferred finalize would read what the next dispatch changes: the
    # streamed per-client state (written back to the host store every
    # round), the population (its events mutate the store at the round
    # boundary), post_round's same-round metrics (Shapley), and the
    # client or server optimizer state a checkpoint would persist (the
    # next round updates the client state in place). ``checkpointing`` is
    # the same on every process (each one's ``save`` takes part in the
    # gathers), so every rank makes the same choice and the collectives
    # of a deferred finalize meet in one order. A sampled streamed cohort
    # keeps its state in the host store, the round loop none.
    keeps_state = algorithm.keeps_client_state()
    stream_stateful = stream_sampled and keeps_state
    pipelined = (
        config.pipeline_rounds
        and K == 1
        and not stream_stateful
        and pop is None
        and algorithm.supports_round_pipelining
        and not (checkpointing and ((keeps_state and not stream_sampled)
                                    or server_state is not None))
    )
    if config.pipeline_rounds and not pipelined:
        # Asked for and off: say why (the JAX package's texts).
        if K > 1:
            reason = ("rounds_per_dispatch > 1 already amortizes the fetch "
                      "(one device_get per dispatch)")
        elif pop is not None:
            reason = ("population='dynamic' registration events mutate "
                      "host population state at every round boundary; a "
                      "deferred finalize would checkpoint the wrong stream "
                      "cursor")
        elif stream_stateful:
            reason = ("streamed residency's per-round state writeback "
                      "already syncs with the dispatch (nothing left to "
                      "hide)")
        elif not algorithm.supports_round_pipelining:
            reason = "the algorithm's post_round must see each round's metrics"
        else:
            reason = ("checkpointing needs per-client/server-optimizer "
                      "state that round r+1's dispatch would donate away")
        logger.info("pipeline_rounds disabled: %s", reason)

    def save_sharded(round_idx: int, metrics, params, s_state, a_state,
                     rng_key) -> str:
        """This process's checkpoint shard (its clients' state rows and the
        replicated global state), then a barrier over the round, then
        process 0's manifest, which commits the round (the JAX package's
        ``_save_sharded_checkpoint``). A process that dies between its
        shard and the barrier leaves the round without a manifest, and a
        resume falls back one interval."""
        n_procs = process_count()
        save_shard_checkpoint(
            config.checkpoint_dir, round_idx, process_index(), n_procs,
            {
                "global_params": params_to_jax(
                    layout.unflatten(params),
                    jax_paths(model, sample_shape[:2])),
                "client_state": store.state if stream_sampled else None,
                "algo_state": _algo_checkpoint_state(
                    algorithm, metrics, s_state, a_state),
                "rng_key": np.asarray(rng_key, dtype=np.uint32),
            },
            span_recorder=span_recorder,
        )
        if span_recorder is not None:
            # The barrier's skew: a stamp gather ahead of the agreement
            # check, its length set by the slowest shard write; it rides
            # the next round's record.
            wid = span_recorder.begin("ckpt_barrier_wait", "dcn_wait",
                                      round_idx=round_idx, eager=True)
            stamps = allgather_wall_stamps(clock.wall() - clock_offset)
            skew_ms = float(stamps.max() - stamps.min()) * 1e3
            span_recorder.end(wid, skew_ms=round(skew_ms, 3))
            span_recorder.note_pending_skew("ckpt_skew_ms", skew_ms)
        agreed = allgather_int64([round_idx])
        if not (agreed == round_idx).all():
            raise RuntimeError(
                "sharded checkpoint barrier disagreement: processes "
                f"are checkpointing different rounds "
                f"({agreed.ravel().tolist()}) — SPMD round sequencing "
                "diverged"
            )
        if is_primary:
            write_manifest(
                config.checkpoint_dir, round_idx,
                {
                    "n_hosts": n_procs,
                    "n_clients": n_clients,
                    "owner_bounds": [int(b) for b in mh_owner_bounds],
                    "cohort": cohort_n,
                    "mesh_devices": int(config.mesh_devices),
                    "shards": [
                        os.path.basename(shard_checkpoint_path(
                            config.checkpoint_dir, round_idx, h, n_procs))
                        for h in range(n_procs)
                    ],
                },
                span_recorder=span_recorder,
            )
            gc_sharded_checkpoints(config.checkpoint_dir,
                                   config.checkpoint_keep_last)
        return manifest_checkpoint_path(config.checkpoint_dir, round_idx)

    def write_checkpoint(path: str, round_idx: int, metrics, params,
                         c_state, s_state, a_state, rng_key) -> None:
        """The one-file checkpoint, written by process 0 alone: no
        collective (the caller holds the whole client state)."""

        def write():
            save_checkpoint(
                path, round_idx,
                params_to_jax(layout.unflatten(params),
                              jax_paths(model, sample_shape[:2])),
                # Sampled streamed: the store, after the round's writeback.
                store.state if stream_sampled else c_state,
                _algo_checkpoint_state(
                    algorithm, metrics, s_state, a_state,
                    vstate.values if vstate is not None else None,
                    # The state the next round draws from: this round's
                    # events are applied before its checkpoint.
                    pop.checkpoint_state(store) if pop is not None
                    else None),
                rng_key,
            )

        if span_recorder is None:
            write()
        else:
            with span_recorder.span("ckpt_write", "io", round_idx=round_idx,
                                    eager=True) as sp:
                write()
                sp["bytes"] = os.path.getsize(path)
        gc_checkpoints(config.checkpoint_dir, config.checkpoint_keep_last)

    def save(round_idx: int, metrics, params, c_state, s_state, a_state,
             rng_key) -> str:
        """A checkpoint on the ``checkpoint_every`` cadence, which every
        process reaches in the same round."""
        if mh:
            return save_sharded(round_idx, metrics, params, s_state, a_state,
                                rng_key)
        path = os.path.join(config.checkpoint_dir, f"round_{round_idx}.ckpt")
        if isinstance(c_state, Blocks):
            # The whole state for the one file (a gather every process
            # makes).
            c_state = c_state.full(device)
        if is_primary:
            write_checkpoint(path, round_idx, metrics, params, c_state,
                             s_state, a_state, rng_key)
        return path

    # SIGTERM (a preemption notice): the handler only sets a flag; the loop
    # finishes the round (or dispatch) in flight, writes a final checkpoint
    # and returns. Installed in the main thread only, and the previous
    # handler restored.
    preempt = {"flag": False}
    installed = threading.current_thread() is threading.main_thread()
    if installed:
        def on_sigterm(signum, frame):
            preempt["flag"] = True

        prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)

    # --- round loop ---------------------------------------------------------
    history: list[dict] = []
    telemetry = {
        "rounds_rejected": 0, "survivor_counts": [], "clients_flagged": 0,
        "post_warmup_compiles": 0,
        # Async federation: the simulated clocks (async against the
        # wait-for-everyone counterfactual) and the buffer occupancy.
        "sim_async_s": 0.0, "sim_sync_s": 0.0, "buffer_occupancy": [],
        "valuation_last_audit": None, "costmodel": None,
        # Dynamic population: quorum-rejected rounds that also lost cohort
        # members to departures.
        "churn_rejected": 0,
    }
    metrics_path = os.path.join(log_dir, "metrics.jsonl") if log_dir else None
    completed_round = start_round - 1
    t_start = time.perf_counter()
    t_prev_done = t_start
    seen_dispatch_sizes: set[int] = set()

    def emit_record(round_idx, metrics, mean_client_loss, fetched, ctx,
                    tel_rec_fn, phase_round, audit_fn=None, stream_rec=None,
                    population_rec=None, multihost_rec=None):
        """One round's record from already-fetched host values: post_round,
        the record's sub-objects, the history and the metrics.jsonl line.
        Shared by the one-round loop and the dispatch flush, so that the
        record layout cannot differ between them."""
        nonlocal prev_metrics, t_prev_done
        with annotate("post_round"), phase_timer.phase(phase_round,
                                                       "post_round"):
            extra = algorithm.post_round(ctx) or {}
        # The split GTG walk's provenance is the v10 ``gtg`` sub-object.
        gtg_rec = extra.pop("gtg", None)
        now = time.perf_counter()
        # Within a dispatch its wall lands on its first round.
        record = build_base_round_record(
            config, round_idx, metrics, mean_client_loss, fetched, extra,
            round_seconds=now - t_prev_done,
        )
        if "survivor_count" in record:
            telemetry["survivor_counts"].append(record["survivor_count"])
        if record.get("round_rejected"):
            telemetry["rounds_rejected"] += 1
            logger.warning(
                "round %d REJECTED by quorum policy (survivors=%s, "
                "min_survivors=%d): previous global model retained",
                round_idx, record.get("survivor_count"),
                config.min_survivors,
            )
            if span_recorder is not None:
                # Flight recorder: a rejected round is a fault event.
                span_recorder.flush_inflight("quorum_rejected")
        t_prev_done = now
        cs_rec = None
        extras = {k: float(fetched[k])
                  for k in ("quant_mse", "vote_agreement") if k in fetched}
        if "client_stats" in fetched:
            cs_rec, n_flagged = detect_and_record(
                fetched["client_stats"], client_stats_cfg, round_idx,
                logger=logger, participants=fetched.get("participants"),
                extras=extras,
            )
            telemetry["clients_flagged"] += n_flagged
        elif extras:
            # No per-client deltas (sign_SGD): the round scalars only.
            cs_rec = {
                "n_clients": n_clients,
                **{k: (v if np.isfinite(v) else None)
                   for k, v in extras.items()},
            }
        async_rec = None
        if "sim_duration" in fetched:
            # The deadline round's outcome: the v4 ``async`` sub-object.
            n_late = int(fetched["late_count"])
            async_rec = {
                "on_time": int(fetched["on_time_count"]),
                "late": n_late,
                "buffer": int(fetched["buffer_count"]),
                "applied": bool(fetched["buffer_applied"]),
                "mean_staleness": (
                    round(float(fetched["mean_staleness"]), 4)
                    if n_late else None
                ),
                "sim_round_s": round(float(fetched["sim_duration"]), 6),
                "sim_round_sync_s": round(
                    float(fetched["sim_duration_sync"]), 6),
                "sim_clock_s": round(float(fetched["sim_clock"]), 6),
            }
            telemetry["sim_async_s"] += float(fetched["sim_duration"])
            telemetry["sim_sync_s"] += float(fetched["sim_duration_sync"])
            telemetry["buffer_occupancy"].append(
                int(fetched["buffer_count"]))
        val_rec = None
        if vstate is not None and "valuation_scores" in fetched:
            # The streaming fold: this round's scores times its loss delta
            # (prev_metrics is still the previous round's here); round 0
            # folds a delta of 0.
            v_ids = fetched.get("participants")
            if v_ids is not None:
                v_ids = np.asarray(v_ids)
            loss_delta = (
                float(prev_metrics["loss"]) - float(metrics["loss"])
                if prev_metrics else 0.0
            )
            vstate.fold(v_ids, np.asarray(fetched["valuation_scores"]),
                        loss_delta, valuation_cfg.decay)
            audit_rec = audit_fn(v_ids) if audit_fn is not None else None
            if audit_rec is not None:
                telemetry["valuation_last_audit"] = {
                    "round": round_idx, **audit_rec,
                }
                logger.info(
                    "round %d valuation audit: spearman=%s pearson=%s "
                    "(%d permutations, %d subset evals, converged=%s, "
                    "memo_hit_rate=%s, %.1fs)",
                    round_idx, audit_rec["spearman"],
                    audit_rec["pearson"], audit_rec["permutations"],
                    audit_rec["subset_evals"], audit_rec["converged"],
                    audit_rec["memo_hit_rate"], audit_rec["seconds"],
                )
            val_rec = valuation_record(vstate, v_ids, loss_delta,
                                       audit=audit_rec)
        cm_rec = None
        if cost_ledger is not None and round_idx == config.round - 1:
            # The measured round: the mean over the steady rounds (round 0
            # carries the first calls; a dispatch's wall lands on its first
            # round, so the mean is the unit in every dispatch shape).
            walls = [h["round_seconds"] for h in history] + [
                record["round_seconds"]]
            steady = walls[1:] or walls
            cm_rec = costmodel_record(
                cost_ledger,
                trace_rounds=config.cost_model_trace_rounds,
                anchor=config.cost_model_topology,
                measured_ms=1e3 * sum(steady) / len(steady),
                param_bytes=4 * global_flat.numel(),
                run_rounds=config.round,
            )
            telemetry["costmodel"] = cm_rec
        pop_rec = None
        if population_rec is not None:
            # Rejected by churn: the quorum rejected the round and cohort
            # members departed in it.
            pop_rec = dict(population_rec)
            pop_rec["rejected_by_churn"] = bool(
                record.get("round_rejected")
                and pop_rec.get("cohort_departs", 0) > 0
            )
            if pop_rec["rejected_by_churn"]:
                telemetry["churn_rejected"] += 1
        tel_rec = tel_rec_fn()
        spans_rec = None
        if span_recorder is not None:
            # The round's span summary (v12), then the once-a-round drain.
            spans_rec = span_recorder.round_summary(round_idx)
            span_recorder.flush()
        record = build_round_record(record, tel_rec, cs_rec, async_rec,
                                    stream_rec, cm_rec, val_rec,
                                    population=pop_rec, gtg=gtg_rec,
                                    multihost=multihost_rec,
                                    spans=spans_rec)
        history.append(record)
        if metrics_path:
            with open(metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        logger.info(
            "round %d: test_acc=%.4f test_loss=%.4f (%.2fs)",
            round_idx, metrics["accuracy"], metrics["loss"],
            record["round_seconds"],
        )
        prev_metrics = metrics

    def compile_events(last: int):
        """The recompile events of a round (or dispatch, filed under its
        last round), each also a ``compile`` span event."""
        recompile.attribute(last)
        events = recompile.take(last)
        if span_recorder is not None:
            for name, secs in events:
                span_recorder.event(name, "compile", round_idx=last,
                                    seconds=round(secs, 6))
        return events

    def tel_record(last: int, n_compiles: int) -> dict:
        tel_rec = {
            "phase_seconds": {
                k: round(v, 6)
                for k, v in sorted(phase_timer.take(last).items())
            },
            "compiles": n_compiles,
        }
        return tel_rec

    def fetch_keys(aux, fetch_stats: bool) -> list[str]:
        """The round's aux values that ride the one metric fetch."""
        keys = [k for k in ("survivor_count", "round_rejected",
                            "participants") if k in aux]
        if fetch_stats:
            keys += [k for k in ("client_stats", "quant_mse",
                                 "vote_agreement") if k in aux]
        if vstate is not None and "valuation_scores" in aux:
            keys.append("valuation_scores")
        return keys + [k for k in ASYNC_AUX_KEYS if k in aux]

    def start_round_fetch(round_idx: int, aux, metrics_dev) -> tuple:
        """Start the copies of a round's one metric fetch (start_fetch)."""
        keys = fetch_keys(aux, client_stats_cfg is not None
                          and client_stats_cfg.fetch_round(round_idx))
        return start_fetch({
            "metrics": metrics_dev,
            "mean_client_loss": aux["mean_client_loss"],
            "tel": {k: aux[k] for k in keys},
        })

    def finalize(p: dict) -> None:
        """Fetch, record and checkpoint one round (K=1): inside an eager
        ``finalize`` span when spans are on, so a process killed here
        leaves it in its journal."""
        if span_recorder is None:
            return _finalize(p)
        with span_recorder.span("finalize", "round", round_idx=p["round"],
                                eager=True):
            return _finalize(p)

    def _finalize(p: dict) -> None:
        round_idx, aux = p["round"], p["aux"]
        with phase_timer.phase(round_idx, "host_sync"), _oom_hint(
                config, n_params, n_clients, device,
                site="deferred metric fetch"):
            # The round's copies started after its eval.
            fetched = finish_fetch(p["fetch"])
        metrics = {k: float(v) for k, v in fetched["metrics"].items()}
        tel = fetched["tel"]
        ctx = RoundContext(
            round_idx=round_idx, global_params=p["new_global"],
            prev_global_params=p["prev_global"], sizes=client_data.sizes,
            aux=aux, metrics=metrics, prev_metrics=prev_metrics,
            eval_batches=eval_batches, log_dir=log_dir, layout=layout,
        )
        if "client_stats" in tel:
            # Post-round hooks (Shapley's cross-check) read the matrix
            # already fetched.
            ctx.extra["client_stats_np"] = tel["client_stats"]

        def tel_rec_fn():
            if not phase_timer.enabled:
                return None
            # The first executed round is the warmup; a first call in any
            # later round is the instability warning.
            events = compile_events(round_idx)
            n_compiles = log_round_compiles(
                logger, round_idx, events, warmup=round_idx == start_round)
            if round_idx > start_round:
                telemetry["post_warmup_compiles"] += n_compiles
            tel_rec = tel_record(round_idx, n_compiles)
            if events:
                tel_rec["compiled"] = [name for name, _ in events]
            peak = peak_hbm_bytes(device)
            if peak is not None:
                tel_rec["peak_hbm_bytes"] = peak
            return tel_rec

        def audit_fn(v_ids):
            """The sparse GTG audit: replays this round's cohort from its
            round key against the pre-round global model (a pure read)."""
            if auditor is None or not auditor.due(round_idx):
                return None
            with annotate("valuation_audit"):
                return auditor.run(
                    round_idx, p["round_key"], p["prev_global"], v_ids,
                    vstate.values, client_data.sizes,
                    lr_scale=float(lr_factors(config, round_idx, 1)[0]),
                )

        emit_record(round_idx, metrics, float(fetched["mean_client_loss"]),
                    tel, ctx, tel_rec_fn, round_idx, audit_fn=audit_fn,
                    stream_rec=p.get("stream"),
                    population_rec=p.get("population"),
                    multihost_rec=p.get("multihost"))
        if checkpointing and (round_idx + 1) % config.checkpoint_every == 0:
            save(round_idx, metrics, p["new_global"], p["client_state"],
                 p["server_state"], p["async_state"], p["key"])
        # Chaos-harness hook (robustness/chaos.py), after the round's
        # record and checkpoint are on disk.
        maybe_crash(round_idx)

    def flush_dispatch(d: dict) -> None:
        """Record a dispatch of K rounds: one fetch of the stacked metrics
        and aux, then one record per round. Phase times and compile events
        are per dispatch, on its last round's record (``dispatch_rounds``
        says so)."""
        first, k = d["round_start"], d["k"]
        last = first + k - 1
        rounds = range(first, last + 1)
        aux_k = d["aux"]
        fetch_rounds = {
            r for r in rounds
            if client_stats_cfg is not None and client_stats_cfg.fetch_round(r)
        }
        keys = fetch_keys(aux_k, bool(fetch_rounds))
        stat_keys = [k_ for k_ in ("client_stats", "quant_mse",
                                   "vote_agreement") if k_ in keys]
        with phase_timer.phase(last, "host_sync"), _oom_hint(
                config, n_params, n_clients, device,
                site="deferred metric fetch"):
            fetched = fetch_to_host({
                "metrics": d["metrics"],
                "mean_client_loss": aux_k["mean_client_loss"],
                "tel": {k_: aux_k[k_] for k_ in keys},
            })

        def tel_rec_fn():
            if not phase_timer.enabled:
                return None
            events = compile_events(last)
            warm = first == start_round or k not in seen_dispatch_sizes
            seen_dispatch_sizes.add(k)
            n_compiles = log_round_compiles(logger, last, events,
                                            warmup=warm)
            if not warm:
                telemetry["post_warmup_compiles"] += n_compiles
            tel_rec = tel_record(last, n_compiles)
            # The phase times and compiles cover this many rounds.
            tel_rec["dispatch_rounds"] = k
            if warm and n_compiles:
                tel_rec["warmup"] = True
            if events:
                tel_rec["compiled"] = [name for name, _ in events]
            peak = peak_hbm_bytes(device)
            if peak is not None:
                tel_rec["peak_hbm_bytes"] = peak
            return tel_rec

        for i, round_idx in enumerate(rounds):
            metrics = {name: float(v[i])
                       for name, v in fetched["metrics"].items()}
            row = {name: v[i] for name, v in fetched["tel"].items()
                   if name not in stat_keys or round_idx in fetch_rounds}
            ctx = RoundContext(
                # The dispatch's last model and its first round's previous
                # one (supports_round_batching's contract).
                round_idx=round_idx, global_params=d["new_global"],
                prev_global_params=d["prev_global"],
                sizes=client_data.sizes,
                aux=StackedAuxRow(aux_k, i), metrics=metrics,
                prev_metrics=prev_metrics, eval_batches=eval_batches,
                log_dir=log_dir, layout=layout,
            )
            if "client_stats" in row:
                ctx.extra["client_stats_np"] = row["client_stats"]
            emit_record(round_idx, metrics,
                        float(fetched["mean_client_loss"][i]), row, ctx,
                        tel_rec_fn if round_idx == last else (lambda: None),
                        last,
                        # The dispatch's transfer stats, on its last record
                        # as its phase times.
                        stream_rec=(d.get("stream") if round_idx == last
                                    else None))
        # Dispatches end at checkpoint boundaries, so the cadence fires on
        # a dispatch's last round only, where the carried state is that
        # round's.
        if checkpointing and (last + 1) % config.checkpoint_every == 0:
            save(last, prev_metrics, d["new_global"], d["client_state"],
                 d["server_state"], d["async_state"], d["key"])
        maybe_crash(last)

    def eval_flat(flat, *batches):
        return server_eval(layout.unflatten(flat), *batches)

    batched_fns: dict = {}

    def dispatch_len(start: int) -> int:
        """min(K, rounds left, rounds to the next checkpoint)."""
        k = min(K, config.round - start)
        if config.checkpoint_dir and config.checkpoint_every:
            k = min(k, config.checkpoint_every
                    - (start % config.checkpoint_every))
        return k

    profile_from = config.profile_from_round
    profile_stack = contextlib.ExitStack()

    def maybe_profile(round_idx: int) -> None:
        """Start the profiler session at ``profile_from_round`` (the first
        round carries the first calls and the kernel builds)."""
        nonlocal profile_from
        if (config.profile_dir and profile_from is not None
                and round_idx >= profile_from):
            profile_stack.enter_context(profile_session(config.profile_dir))
            profile_from = None

    def stream_plan(from_key, k: int):
        """The cohorts of a dispatch of ``k`` rounds, drawn on the host
        from the key chain (the dispatch's own ``key, round_key =
        split(key)`` steps), and the key after it: what lets the next
        dispatch's cohorts upload before this one returns."""
        hk = from_key
        idx_list = []
        for _ in range(k):
            hk, rk = prng.split(hk)
            idx_list.append(streamer.cohort_for(rk))
        return idx_list, hk

    def run_dispatch(round_idx: int, k: int, last: int, stream_next):
        """One dispatch of ``k > 1`` rounds; returns the next dispatch's
        prefetched cohort plan (sampled streamed runs) or None."""
        nonlocal global_flat, client_state, server_state, key, async_state
        nonlocal stream_rec_startup
        prev_global = global_flat
        round_kwargs = ([
            {"client_rng": client_rng_fn(r)}
            for r in range(round_idx, last + 1)
        ] if client_rng_fn else None)
        lr_vec = lr_factors(config, round_idx, k)
        stream_rec = None
        plan_next = None
        with annotate(f"fl_rounds_{round_idx}_{last}"), _oom_hint(
                config, n_params, n_clients, device):
            if stream_sampled:
                fn = batched_fns.get(("streamed", k))
                if fn is None:
                    fn = batched_fns[("streamed", k)] = tracked(
                        "batched", make_batched_round_fn(
                            round_fn, server_update, eval_flat, k,
                            async_mode=async_ctl is not None,
                            streamed=True))
                if stream_next is not None and stream_next[0] == round_idx:
                    idx_list, hk_after = stream_next[1:]
                else:
                    # The first dispatch (or a resume): its draws get their
                    # own `sample` window.
                    with phase_timer.phase(last, "sample"):
                        idx_list, hk_after = stream_plan(key, k)
                (sx, sy, sm, ssz, sidx), stream_rec = streamer.acquire(
                    idx_list, stack=True)
                if k > 1:
                    stream_rec["dispatch_rounds"] = k
                with phase_timer.phase(last, "client_step") as ph:
                    out = fn(global_flat, None, server_state, key, sx, sy,
                             sm, ssz, eval_batches, lr_vec,
                             async_state=async_state,
                             round_kwargs=round_kwargs, idx_k=sidx)
                    (global_flat, _, server_state, key, metrics_k,
                     aux_k) = out[:6]
                    if async_ctl is not None:
                        async_state = out[6]
                    # The next dispatch's cohorts upload while this one
                    # computes; their draws move from client_step to
                    # `sample`.
                    nxt = last + 1
                    if nxt < config.round and not preempt["flag"]:
                        k2 = dispatch_len(nxt)
                        t_s = time.perf_counter()
                        idx2, hk2 = stream_plan(hk_after, k2)
                        phase_timer.carve(last, "sample",
                                          time.perf_counter() - t_s,
                                          "client_step")
                        plan_next = (nxt, idx2, hk2)
                        streamer.prefetch(idx2, stack=True)
                    ph.fence((global_flat, metrics_k))
            else:
                if stream_rec_startup is not None:
                    # The full cohort's one upload, on the first record.
                    stream_rec, stream_rec_startup = stream_rec_startup, None
                    if k > 1:
                        stream_rec["dispatch_rounds"] = k
                fn = batched_fns.get(k)
                if fn is None:
                    fn = batched_fns[k] = tracked(
                        "batched", make_batched_round_fn(
                            round_fn, server_update, eval_flat, k,
                            async_mode=async_ctl is not None))
                with phase_timer.phase(last, "client_step") as ph:
                    out = fn(global_flat, client_state, server_state, key,
                             cx, cy, cmask, client_data.sizes, eval_batches,
                             lr_vec, async_state=async_state,
                             round_kwargs=round_kwargs)
                    (global_flat, client_state, server_state, key,
                     metrics_k, aux_k) = out[:6]
                    if async_ctl is not None:
                        async_state = out[6]
                    ph.fence((global_flat, metrics_k))
        if recompile is not None:
            recompile.attribute(last)
        flush_dispatch({
            "round_start": round_idx, "k": k,
            "metrics": metrics_k, "aux": aux_k,
            "new_global": global_flat, "prev_global": prev_global,
            "client_state": client_state,
            "server_state": server_state,
            "async_state": async_state, "key": key,
            "stream": stream_rec,
        })
        return plan_next

    def run_round(round_idx: int, next_idx):
        """Dispatch one round (K=1). Returns the next round's prefetched
        cohort (sampled streamed static runs) or None, and the round's
        entry for :func:`finalize`."""
        nonlocal global_flat, client_state, server_state, key, async_state
        nonlocal stream_rec_startup
        lr_scale = float(lr_factors(config, round_idx, 1)[0])
        key, round_key = prng.split(key)
        kw = {}
        if client_rng_fn:
            kw["client_rng"] = client_rng_fn(round_idx)
        if async_ctl is not None:
            kw["async_state"] = async_state
        stream_rec = pop_rec = mh_rec = None
        next_out = None
        if streamer is not None:
            streamer.span_round = round_idx
        with annotate(f"fl_round_{round_idx}"), _oom_hint(
                config, n_params, n_clients, device):
            if stream_sampled:
                pop_events = pop_words = dep_mask = None
                if pop is not None:
                    # The cohort comes from the registered index space
                    # before this round's events, the departed masked; the
                    # events apply after the round (a joiner is drawn from
                    # the next round; a departure in this cohort rides the
                    # departed operand). Drift first, so that a sampled
                    # drifting client trains on this round's labels.
                    pop_words = pop_key_words(round_key, pop.seed)
                    with phase_timer.phase(round_idx, "sample"):
                        idx_np = streamer.cohort_for(
                            round_key, n=pop.n_registered, alive=pop.alive,
                            k=cohort_n)
                    pop_events = pop.draw_events(pop_words, round_idx)
                    dep_mask = pop.cohort_departed_mask(pop_events, idx_np)
                    pop.apply_drift(store, round_idx, idx_np)
                    kw["departed"] = dep_mask
                    plan = streamer.plan(idx_np)
                elif next_idx is not None:
                    plan = next_idx
                else:
                    # The first round (or a resume): its draw is not hidden
                    # behind a previous round. Under the distributed store
                    # this window also holds the owner assembly and its
                    # exchange.
                    with phase_timer.phase(round_idx, "sample"):
                        plan = streamer.plan(streamer.cohort_for(round_key))
                (sx, sy, sm, ssz, sidx, draw_pos), stream_rec, plan = (
                    streamer.acquire_plan(plan))
                if draw_pos is not None:
                    # Owner-permuted rows (the distributed store): the
                    # round takes each row's keys from its draw position.
                    kw["draw_pos"] = draw_pos
                state_k = (streamer.gather_state(plan, state_proto)
                           if store.state is not None else None)
                with phase_timer.phase(round_idx, "client_step") as ph:
                    new_global, new_state_k, aux = round_fn(
                        global_flat, state_k, sx, sy, sm, ssz, sidx,
                        round_key, lr_scale=lr_scale, **kw)
                    # The next round's cohort uploads while this one
                    # computes; its draw (and, under the distributed store,
                    # its exchange: a collective, so on the main thread at
                    # this point on every rank) moves from client_step to
                    # `sample`. A dynamic population draws after its events
                    # instead.
                    if (pop is None and round_idx + 1 < config.round
                            and not preempt["flag"]):
                        _, next_key = prng.split(key)
                        t_s = clock.monotonic()
                        next_out = streamer.plan(streamer.cohort_for(next_key))
                        phase_timer.carve(round_idx, "sample",
                                          clock.monotonic() - t_s,
                                          "client_step")
                        streamer.prefetch_plan(next_out)
                    ph.fence((new_global, aux))
                # The store is the source of truth between rounds.
                streamer.writeback(plan, new_state_k, stream_rec)
                mh_rec = streamer.multihost_record(plan, stream_rec or {})
                # The record's cohort_hash from the draw-order cohort (the
                # rows may be owner-permuted), comparable across topologies.
                aux["participants"] = streamer.cohort_ids(plan)
                if pop is not None:
                    pop.apply(pop_events, store, state_proto=pop_state_proto,
                              words=pop_words)
                    pop_rec = pop.round_record(
                        pop_events, int(np.count_nonzero(dep_mask)))
            else:
                if stream_rec_startup is not None:
                    # The full cohort's one upload, on the first record.
                    stream_rec, stream_rec_startup = stream_rec_startup, None
                if streamer is not None:
                    # Under the distributed store every round's record
                    # names this rank's slice; nothing spills (the owner
                    # bounds are the blocks).
                    mh_rec = streamer.multihost_record(None,
                                                       stream_rec or {})
                with phase_timer.phase(round_idx, "client_step") as ph:
                    new_global, client_state, aux = round_fn(
                        global_flat, client_state, cx, cy, cmask,
                        client_data.sizes, round_key,
                        lr_scale=lr_scale, **kw,
                    )
                    ph.fence((new_global, aux))
            if async_ctl is not None:
                # The buffer rides to the next round.
                aux = dict(aux)
                async_state = aux.pop("async_state")
            if server_update is not None:
                # A rejected round leaves the params and the server
                # optimizer's state as they were.
                with phase_timer.phase(round_idx, "aggregate") as ph:
                    new_global, server_state = server_update(
                        global_flat, new_global, server_state,
                        aux.get("round_rejected"))
                    ph.fence(new_global)
        with annotate("server_eval"), _oom_hint(
                config, n_params, n_clients, device, site="eval"):
            with phase_timer.phase(round_idx, "eval") as ph:
                metrics_dev = server_eval(
                    layout.unflatten(new_global), *eval_batches)
                ph.fence(metrics_dev)
        # The fetch's copies go behind this round's work now, so that its
        # finalize (deferred when pipelined) waits for them alone.
        with _oom_hint(config, n_params, n_clients, device,
                       site="deferred metric fetch"):
            fetch = start_round_fetch(round_idx, aux, metrics_dev)
        if recompile is not None:
            recompile.attribute(round_idx)
        prev_global, global_flat = global_flat, new_global
        return next_out, {
            "round": round_idx, "round_key": round_key,
            "aux": aux, "fetch": fetch,
            "new_global": new_global, "prev_global": prev_global,
            # A deferred finalize checkpoints no client state (pipelining
            # is off then), and the next round updates it in place.
            "client_state": None if pipelined else client_state,
            "server_state": server_state,
            "async_state": async_state, "key": key,
            "stream": stream_rec, "population": pop_rec,
            "multihost": mh_rec,
        }

    if recompile is not None:
        recompile.start()
    # Pipelined: the dispatched round whose finalize waits for the next
    # round's dispatch.
    pending = None
    try:
        with profile_stack:
            round_idx = start_round
            # The next round's (or dispatch's) prefetched cohort.
            stream_next = None
            while round_idx < config.round:
                maybe_profile(round_idx)
                if K > 1:
                    k = dispatch_len(round_idx)
                    last = round_idx + k - 1
                    stream_next = run_dispatch(round_idx, k, last,
                                               stream_next)
                    completed_round = last
                    round_idx = last + 1
                else:
                    stream_next, entry = run_round(round_idx, stream_next)
                    if pipelined:
                        # This round is pending before the previous one
                        # finalizes: if that raises, the unwind below
                        # still records this one.
                        prev_pending, pending = pending, entry
                        if prev_pending is not None:
                            finalize(prev_pending)
                    else:
                        finalize(entry)
                    completed_round = round_idx
                    round_idx += 1
                if preempt["flag"]:
                    # The round (or dispatch) in flight finished (and was
                    # recorded, or is recorded by the unwind below); no
                    # new one starts.
                    break
    except BaseException as crash:
        # Flight recorder: an unhandled exception force-flushes the last
        # spans and every span still open.
        if span_recorder is not None:
            try:
                span_recorder.flush_inflight(type(crash).__name__)
            except Exception:
                pass
        raise
    finally:
        if installed:
            signal.signal(signal.SIGTERM, prev_sigterm)
        if streamer is not None:
            # No upload outlives the run; the store keeps its state.
            streamer.close()
        if pending is not None:
            # The last deferred round. Best effort: when a finalize in the
            # loop is what failed, a second failure here is logged and the
            # first exception propagates.
            try:
                finalize(pending)
            except Exception:
                logger.exception("failed to record round %d during unwind",
                                 pending["round"])
            finally:
                pending = None
        if recompile is not None:
            recompile.stop()

    preempted_at = None
    if preempt["flag"]:
        # The JAX package's graceful preemption: the round in flight
        # finished and was recorded above. Nothing below joins a
        # collective: SIGTERM reaches each process on its own, and a peer
        # that never got it would not join.
        preempted_at = completed_round
        if span_recorder is not None:
            span_recorder.flush_inflight("sigterm")
        if mh and config.checkpoint_dir:
            # The sharded commit needs every process (the gathers before
            # process 0's manifest): the checkpoint_every cadence, which
            # every process reaches, is the durability contract.
            logger.warning(
                "preempted at round %d (SIGTERM): sharded checkpoints "
                "persist on the checkpoint_every cadence only (last "
                "committed manifest is the resume point); exiting "
                "cleanly", completed_round,
            )
        elif (config.checkpoint_dir and is_primary
              and completed_round >= start_round):
            # Process 0 persists the finished round even off the cadence,
            # so that the resumed run loses nothing.
            forced_path = os.path.join(config.checkpoint_dir,
                                       f"round_{completed_round}.ckpt")
            if not os.path.exists(forced_path):
                write_checkpoint(
                    forced_path, completed_round, prev_metrics, global_flat,
                    _local_client_state(client_state, device),
                    server_state, async_state, key)
            logger.warning(
                "preempted at round %d (SIGTERM): final checkpoint %s "
                "written; exiting cleanly — resume with config.resume=True",
                completed_round, forced_path,
            )
        else:
            logger.warning(
                "preempted at round %d (SIGTERM): no checkpoint_dir "
                "configured, exiting cleanly without persisting",
                completed_round,
            )

    span_summary = None
    if span_recorder is not None:
        span_summary = span_recorder.run_summary()
        span_recorder.close()
    total = time.perf_counter() - t_start
    # This run's rounds (a resumed or preempted run runs fewer).
    n_rounds = len(history)
    logger.info(
        "finished %d rounds x %d clients in %.2fs (%.1f client-rounds/sec)",
        n_rounds, n_clients, total,
        n_rounds * n_clients / max(total, 1e-9),
    )
    survivor_counts = telemetry["survivor_counts"]
    return {
        "global_params": layout.unflatten(global_flat),
        # Sampled streamed: the population's state in the host store.
        "client_state": (
            store.state if stream_sampled
            # None on a preempted rank whose state spans processes: the
            # other blocks live on its peers, which may not join a gather.
            else None if (preempted_at is not None
                          and isinstance(client_state, Blocks)
                          and client_state.mesh.multiprocess)
            else client_state.full(device) if isinstance(client_state,
                                                         Blocks)
            else client_state),
        "history": history,
        "algorithm": algorithm,
        "final_accuracy": history[-1]["test_accuracy"] if history else None,
        "total_seconds": total,
        "client_rounds_per_sec": n_rounds * n_clients / max(total, 1e-9),
        "client_chunk_size": config.client_chunk_size,
        # The client-axis mesh (devices, owning ranks, backend) or None.
        "mesh": mesh,
        "rounds_rejected": telemetry["rounds_rejected"],
        "telemetry_level": tel_level,
        # 0 on a shape-stable run; None with telemetry off.
        "post_warmup_compiles": (
            telemetry["post_warmup_compiles"] if recompile is not None
            else None
        ),
        "mean_survivor_count": (
            float(np.mean(survivor_counts)) if survivor_counts else None
        ),
        # The detector's flags over the run; None with client stats off.
        "clients_flagged": (
            telemetry["clients_flagged"] if client_stats_cfg is not None
            else None
        ),
        # Async federation: the simulated speedup over the synchronous
        # counterfactual (this run's rounds), the buffer's clock (the whole
        # run's, across a resume) and its mean occupancy; None when off.
        "async_speedup_ratio": (
            telemetry["sim_sync_s"] / telemetry["sim_async_s"]
            if async_ctl is not None and telemetry["sim_async_s"] > 0
            else None
        ),
        "sim_clock_seconds": (
            float(async_state["clock"]) if async_ctl is not None else None
        ),
        "mean_buffer_occupancy": (
            float(np.mean(telemetry["buffer_occupancy"]))
            if telemetry["buffer_occupancy"] else None
        ),
        "client_residency": config.client_residency,
        # Streamed residency's transfer totals; None when resident.
        "stream_overlap_ratio": (
            streamer.overlap_ratio() if streamer is not None else None
        ),
        "stream_h2d_bytes": (
            streamer.totals["h2d_bytes"] if streamer is not None else None
        ),
        "stream_d2h_bytes": (
            streamer.totals["d2h_bytes"] if streamer is not None else None
        ),
        "participation_sampler": config.participation_sampler,
        "stream_sample_seconds": (
            streamer.totals["sample_seconds"] if streamer is not None
            else None
        ),
        # The distributed shard store: this rank's slice and the run's
        # exchange traffic; None on one process.
        "stream_dcn_bytes": streamer.totals["dcn_bytes"] if mh else None,
        "multihost_summary": (
            {
                "hosts": store.n_hosts,
                "host_id": store.host_id,
                "owned_clients": store.n_owned,
                "shard_bytes": int(
                    store.data_bytes()
                    + (store.state_bytes() if store.state is not None
                       else 0)),
                "spill_rows": int(streamer.totals["spill_rows"]),
                "dcn_bytes": int(streamer.totals["dcn_bytes"]),
            }
            if mh else None
        ),
        # The v6 costmodel sub-object of the run's last record.
        "costmodel": telemetry["costmodel"],
        "client_valuation": config.client_valuation,
        "valuation": (
            vstate.summary(telemetry["valuation_last_audit"])
            if vstate is not None else None
        ),
        "valuation_state": vstate,
        "gtg_memo_hit_rate": getattr(algorithm, "gtg_memo_hit_rate", None),
        "population": config.population,
        "population_summary": (
            pop.summary(telemetry["churn_rejected"]) if pop is not None
            else None
        ),
        "span_trace": config.span_trace,
        "span_summary": span_summary,
        "preempted_at": preempted_at,
        "device": str(device),
    }


def run_sweep(config_or_spec, dataset=None, client_data=None):
    """Multi-experiment front door (sweep/): run a fleet of experiments —
    trained together where the points allow, scheduled through
    config-hash-grouped warm programs where they don't. A re-export, so
    that ``simulator`` stays the one entry module; the engine lives in
    sweep/engine.py (imported when called)."""
    from distributed_learning_simulator_tpu_torch.sweep import (
        run_sweep as _run_sweep,
    )

    return _run_sweep(config_or_spec, dataset=dataset,
                      client_data=client_data)


def main(argv: list[str] | None = None):
    from distributed_learning_simulator_tpu_torch.sweep.spec import (
        SweepSpec,
    )

    config = get_config(argv)
    if SweepSpec.active(config):
        # Sweep knobs set (sweep_seeds / sweep_points): the process runs
        # a fleet of experiments instead of one (sweep/engine.py).
        return run_sweep(config)
    return run_simulation(config)


if __name__ == "__main__":
    main()
