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
"""

from __future__ import annotations

import json
import math
import os
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
from distributed_learning_simulator_tpu_torch.utils.logging import (
    get_logger,
    set_level,
    set_run_artifacts,
)
from distributed_learning_simulator_tpu_torch.utils.reporting import (
    build_round_record,
    cohort_crc,
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
                            mean_client_loss: float, extra: dict,
                            round_seconds: float) -> dict:
    """The v1-layout base of one round's metrics record, fields and insert
    order as in the JAX package."""
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
    return record


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
    """
    config.validate()
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
        in_channels=sample_shape[-1], **config.model_args,
    ).to(device)
    params = init_params(model, seed=config.seed)
    layout = ParamLayout.from_params(
        params, jax_leaf_order(model, sample_shape[:2])
    )
    global_flat = layout.flatten(params).to(device)

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
    round_fn = algorithm.make_round_fn(
        apply_fn, optimizer, layout, n_clients,
        preprocess=(
            make_decoder(client_data.sample_shape)
            if client_data.compact else None
        ),
        client_sizes=client_data.sizes,
        device=device,
    )
    client_state = algorithm.init_client_state(optimizer, global_flat,
                                               n_clients)
    key = prng.key(config.seed + 1)

    # --- round loop ---------------------------------------------------------
    history: list[dict] = []
    prev_metrics = None
    metrics_path = os.path.join(log_dir, "metrics.jsonl") if log_dir else None
    t_start = time.perf_counter()
    t_prev_done = t_start
    for round_idx in range(config.round):
        lr_scale = float(lr_factors(config, round_idx, 1)[0])
        key, round_key = prng.split(key)
        new_global, client_state, aux = round_fn(
            global_flat, client_state, cx, cy, cmask, client_data.sizes,
            round_key,
            lr_scale=lr_scale,
            client_rng=client_rng_fn(round_idx) if client_rng_fn else None,
        )
        metrics_dev = evaluate(layout.unflatten(new_global), *eval_batches)
        metrics = {k: float(v) for k, v in metrics_dev.items()}
        mean_client_loss = float(aux["mean_client_loss"])
        extra = algorithm.post_round(RoundContext(
            round_idx=round_idx, global_params=new_global,
            prev_global_params=global_flat, sizes=client_data.sizes,
            aux=aux, metrics=metrics, prev_metrics=prev_metrics,
            eval_batches=eval_batches, log_dir=log_dir, layout=layout,
        )) or {}
        global_flat, prev_metrics = new_global, metrics
        now = time.perf_counter()
        base = build_base_round_record(
            config, round_idx, metrics, mean_client_loss, extra,
            round_seconds=now - t_prev_done,
        )
        if "participants" in aux:
            # CRC of the sampled cohort, as the JAX package's records.
            base["cohort_hash"] = cohort_crc(aux["participants"], n_clients)
        record = build_round_record(base)
        t_prev_done = now
        history.append(record)
        if metrics_path:
            with open(metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        logger.info(
            "round %d: test_acc=%.4f test_loss=%.4f (%.2fs)",
            round_idx, metrics["accuracy"], metrics["loss"],
            record["round_seconds"],
        )

    total = time.perf_counter() - t_start
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
        "device": str(device),
    }


def main(argv: list[str] | None = None):
    return run_simulation(get_config(argv))


if __name__ == "__main__":
    main()
