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
detector (v3). ``--execution_mode threaded`` runs the threaded oracle
(execution/threaded.py) instead of the round loop.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import threading
import time

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
    make_decoder,
    make_eval_fn,
    make_optimizer,
    pad_eval_set,
)
from distributed_learning_simulator_tpu_torch.robustness.chaos import (
    maybe_crash,
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
from distributed_learning_simulator_tpu_torch.utils.checkpoint import (
    gc_checkpoints,
    load_latest_valid_checkpoint,
    save_checkpoint,
)
from distributed_learning_simulator_tpu_torch.utils.logging import (
    get_logger,
    set_level,
    set_run_artifacts,
)
from distributed_learning_simulator_tpu_torch.utils.reporting import (
    build_round_record,
    cohort_crc,
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


def fetch_to_host(tree: dict) -> dict:
    """``tree`` (nested dicts of tensors and host values) with every tensor
    as a numpy array, fetched in one device-to-host copy per dtype: the
    round's one metric fetch. Host values pass through."""
    leaves = []

    def collect(node):
        if isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, torch.Tensor):
            leaves.append(node)

    collect(tree)
    host = {}
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        group = [t for t in leaves if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        flat = flat.cpu().numpy()
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


def _algo_checkpoint_state(algorithm, metrics, server_state) -> dict:
    """The checkpoint's ``algo_state``: the last round's metrics, the
    Shapley values so far, and the server optimizer's state when there is
    one (JAX simulator.py ``_algo_checkpoint_state``)."""
    algo_state = {"prev_metrics": metrics}
    if hasattr(algorithm, "shapley_values"):
        algo_state["shapley_values"] = algorithm.shapley_values
    if server_state is not None:
        algo_state["server_opt_state"] = server_state
    return algo_state


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
    of ``template``'s leaves (Adam's step count stays on the host)."""
    if isinstance(template, dict):
        return {k: _restore_like(template[k], saved[k]) for k in template}
    if template is None:
        return None
    return torch.as_tensor(np.asarray(saved)).to(template.device,
                                                 template.dtype).clone()


def _resume(config, algorithm, model, sample_hw, layout, device,
            client_state, server_state):
    """Restore a run from the newest valid checkpoint in
    ``config.checkpoint_dir``, with the JAX package's structure and
    configuration checks. Returns ``(start_round, global_flat or None,
    client_state, server_state, prev_metrics, key or None)``."""
    logger = get_logger()
    ckpt_path, ckpt = load_latest_valid_checkpoint(config.checkpoint_dir)
    if ckpt_path is None:
        return 0, None, client_state, server_state, None, None
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
            algo_state.get("prev_metrics"), ckpt.get("rng_key"))


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
        # Honoured from every entry point, as in the JAX package.
        from distributed_learning_simulator_tpu_torch.execution.threaded import (  # noqa: E501
            run_threaded_simulation,
        )

        return run_threaded_simulation(
            config, dataset=dataset, client_data=client_data,
            setup_logging=setup_logging,
        )
    device = resolve_device(config.device)
    logger = get_logger()
    set_level(config.log_level)
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
    cx = torch.as_tensor(client_data.x, device=device)
    cy = torch.as_tensor(client_data.y, dtype=torch.int64, device=device)
    cmask = torch.as_tensor(client_data.mask, device=device)
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
    evaluate = make_eval_fn(apply_fn)
    algorithm.prepare(apply_fn, evaluate, eval_batches)
    # The round programs count their first-seen call signatures for the
    # recompile counter (telemetry/recompile.py).
    server_eval = tracked("evaluate", evaluate)
    round_fn = algorithm.make_round_fn(
        apply_fn, optimizer, layout, n_clients,
        preprocess=(
            make_decoder(client_data.sample_shape)
            if client_data.compact else None
        ),
        client_sizes=client_data.sizes,
        device=device,
    )
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
    client_state = algorithm.init_client_state(optimizer, global_flat,
                                               n_clients)
    key = prng.key(config.seed + 1)
    start_round = 0
    prev_metrics = None
    if config.resume and config.checkpoint_dir:
        (start_round, resumed_global, client_state, server_state,
         prev_metrics, resumed_key) = _resume(
            config, algorithm, model, sample_shape[:2], layout, device,
            client_state, server_state)
        if resumed_global is not None:
            global_flat = resumed_global
        if resumed_key is not None:
            key = resumed_key
    checkpointing = bool(config.checkpoint_dir and config.checkpoint_every)

    def save(round_idx: int, metrics) -> str:
        path = os.path.join(config.checkpoint_dir, f"round_{round_idx}.ckpt")
        save_checkpoint(
            path, round_idx,
            params_to_jax(layout.unflatten(global_flat),
                          jax_paths(model, sample_shape[:2])),
            client_state,
            _algo_checkpoint_state(algorithm, metrics, server_state), key,
        )
        gc_checkpoints(config.checkpoint_dir, config.checkpoint_keep_last)
        return path

    # SIGTERM (a preemption notice): the handler only sets a flag; the loop
    # finishes the round in flight, writes a final checkpoint and returns.
    # Installed in the main thread only, and the previous handler restored.
    preempt = {"flag": False}
    installed = threading.current_thread() is threading.main_thread()
    if installed:
        def on_sigterm(signum, frame):
            preempt["flag"] = True

        prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)

    # --- round loop ---------------------------------------------------------
    history: list[dict] = []
    rounds_rejected = 0
    survivor_counts: list[int] = []
    metrics_path = os.path.join(log_dir, "metrics.jsonl") if log_dir else None
    # Run telemetry (telemetry/): phase timing, the recompile counter and
    # the memory watermark; per-client statistics. All off by default, and
    # then the records are the v1 records.
    tel_level = config.telemetry_level.lower()
    phase_timer = make_phase_timer(tel_level)
    recompile = RecompileMonitor() if tel_level != "off" else None
    post_warmup_compiles = 0
    client_stats_cfg = ClientStats.from_config(config)
    clients_flagged = 0
    completed_round = start_round - 1
    t_start = time.perf_counter()
    t_prev_done = t_start
    if recompile is not None:
        recompile.start()
    try:
        for round_idx in range(start_round, config.round):
            lr_scale = float(lr_factors(config, round_idx, 1)[0])
            key, round_key = prng.split(key)
            with phase_timer.phase(round_idx, "client_step") as ph:
                new_global, client_state, aux = round_fn(
                    global_flat, client_state, cx, cy, cmask,
                    client_data.sizes, round_key,
                    lr_scale=lr_scale,
                    client_rng=client_rng_fn(round_idx) if client_rng_fn
                    else None,
                )
                ph.fence((new_global, aux))
            if server_update is not None:
                # A rejected round leaves the params and the server
                # optimizer's state as they were.
                with phase_timer.phase(round_idx, "aggregate") as ph:
                    new_global, server_state = server_update(
                        global_flat, new_global, server_state,
                        aux.get("round_rejected"))
                    ph.fence(new_global)
            with phase_timer.phase(round_idx, "eval") as ph:
                metrics_dev = server_eval(layout.unflatten(new_global),
                                          *eval_batches)
                ph.fence(metrics_dev)
            if recompile is not None:
                recompile.attribute(round_idx)
            # The client stats and their round scalars ride the round's one
            # metric fetch, on the client_stats_every cadence.
            cs_keys = [
                k for k in ("client_stats", "quant_mse", "vote_agreement")
                if k in aux
            ] if (client_stats_cfg is not None
                  and client_stats_cfg.fetch_round(round_idx)) else []
            with phase_timer.phase(round_idx, "host_sync"):
                fetched = fetch_to_host({
                    "metrics": metrics_dev,
                    "mean_client_loss": aux["mean_client_loss"],
                    **{k: aux[k] for k in cs_keys},
                })
            metrics = {k: float(v) for k, v in fetched["metrics"].items()}
            mean_client_loss = float(fetched["mean_client_loss"])
            ctx = RoundContext(
                round_idx=round_idx, global_params=new_global,
                prev_global_params=global_flat, sizes=client_data.sizes,
                aux=aux, metrics=metrics, prev_metrics=prev_metrics,
                eval_batches=eval_batches, log_dir=log_dir, layout=layout,
            )
            if "client_stats" in fetched:
                # Post-round hooks (Shapley's cross-check) read the
                # matrix already fetched.
                ctx.extra["client_stats_np"] = fetched["client_stats"]
            with phase_timer.phase(round_idx, "post_round"):
                extra = algorithm.post_round(ctx) or {}
            global_flat, prev_metrics = new_global, metrics
            now = time.perf_counter()
            record = build_base_round_record(
                config, round_idx, metrics, mean_client_loss, aux, extra,
                round_seconds=now - t_prev_done,
            )
            if "survivor_count" in record:
                survivor_counts.append(record["survivor_count"])
            if record.get("round_rejected"):
                rounds_rejected += 1
                logger.warning(
                    "round %d REJECTED by quorum policy (survivors=%s, "
                    "min_survivors=%d): previous global model retained",
                    round_idx, record.get("survivor_count"),
                    config.min_survivors,
                )
            t_prev_done = now
            cs_rec = None
            extras = {k: float(fetched[k])
                      for k in ("quant_mse", "vote_agreement")
                      if k in fetched}
            if "client_stats" in fetched:
                cs_rec, n_flagged = detect_and_record(
                    fetched["client_stats"], client_stats_cfg, round_idx,
                    logger=logger, participants=aux.get("participants"),
                    extras=extras,
                )
                clients_flagged += n_flagged
            elif extras:
                # No per-client deltas (sign_SGD): the round scalars only.
                cs_rec = {
                    "n_clients": n_clients,
                    **{k: (v if np.isfinite(v) else None)
                       for k, v in extras.items()},
                }
            tel_rec = None
            if phase_timer.enabled:
                # The first executed round is the warmup; a compile in any
                # later round is the instability warning.
                recompile.attribute(round_idx)
                events = recompile.take(round_idx)
                n_compiles = log_round_compiles(
                    logger, round_idx, events,
                    warmup=round_idx == start_round,
                )
                if round_idx > start_round:
                    post_warmup_compiles += n_compiles
                tel_rec = {
                    "phase_seconds": {
                        k: round(v, 6) for k, v in sorted(
                            phase_timer.take(round_idx).items())
                    },
                    "compiles": n_compiles,
                }
                if events:
                    tel_rec["compiled"] = [name for name, _ in events]
                peak = peak_hbm_bytes(device)
                if peak is not None:
                    tel_rec["peak_hbm_bytes"] = peak
            record = build_round_record(record, tel_rec, cs_rec)
            history.append(record)
            if metrics_path:
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            logger.info(
                "round %d: test_acc=%.4f test_loss=%.4f (%.2fs)",
                round_idx, metrics["accuracy"], metrics["loss"],
                record["round_seconds"],
            )
            if checkpointing and (
                    (round_idx + 1) % config.checkpoint_every == 0):
                save(round_idx, metrics)
            # Chaos-harness hook (robustness/chaos.py), after the round's
            # record and checkpoint are on disk.
            maybe_crash(round_idx)
            completed_round = round_idx
            if preempt["flag"]:
                break
    finally:
        if recompile is not None:
            recompile.stop()
        if installed:
            signal.signal(signal.SIGTERM, prev_sigterm)

    preempted_at = None
    if preempt["flag"]:
        # Persist the finished round even off the checkpoint_every cadence,
        # so that the resumed run loses nothing.
        preempted_at = completed_round
        if config.checkpoint_dir and completed_round >= start_round:
            forced_path = os.path.join(config.checkpoint_dir,
                                       f"round_{completed_round}.ckpt")
            if not os.path.exists(forced_path):
                save(completed_round, prev_metrics)
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

    total = time.perf_counter() - t_start
    # This run's rounds (a resumed or preempted run runs fewer).
    n_rounds = len(history)
    logger.info(
        "finished %d rounds x %d clients in %.2fs (%.1f client-rounds/sec)",
        n_rounds, n_clients, total,
        n_rounds * n_clients / max(total, 1e-9),
    )
    return {
        "global_params": layout.unflatten(global_flat),
        "client_state": client_state,
        "history": history,
        "algorithm": algorithm,
        "final_accuracy": history[-1]["test_accuracy"] if history else None,
        "total_seconds": total,
        "client_rounds_per_sec": n_rounds * n_clients / max(total, 1e-9),
        "client_chunk_size": config.client_chunk_size,
        # The JAX package's other keys, at the values its run gives them
        # with each feature off (the port does not have these yet).
        "mesh": None,
        "rounds_rejected": rounds_rejected,
        "telemetry_level": tel_level,
        # 0 on a shape-stable run; None with telemetry off.
        "post_warmup_compiles": (
            post_warmup_compiles if recompile is not None else None
        ),
        "mean_survivor_count": (
            float(np.mean(survivor_counts)) if survivor_counts else None
        ),
        # The detector's flags over the run; None with client stats off.
        "clients_flagged": (
            clients_flagged if client_stats_cfg is not None else None
        ),
        "async_speedup_ratio": None,
        "sim_clock_seconds": None,
        "mean_buffer_occupancy": None,
        "client_residency": config.client_residency,
        "stream_overlap_ratio": None,
        "stream_h2d_bytes": None,
        "stream_d2h_bytes": None,
        "participation_sampler": config.participation_sampler,
        "stream_sample_seconds": None,
        "stream_dcn_bytes": None,
        "multihost_summary": None,
        "costmodel": None,
        "client_valuation": config.client_valuation,
        "valuation": None,
        "valuation_state": None,
        "gtg_memo_hit_rate": getattr(algorithm, "gtg_memo_hit_rate", None),
        "population": config.population,
        "population_summary": None,
        "span_trace": config.span_trace,
        "span_summary": None,
        "preempted_at": preempted_at,
        "device": str(device),
    }


def main(argv: list[str] | None = None):
    return run_simulation(get_config(argv))


if __name__ == "__main__":
    main()
