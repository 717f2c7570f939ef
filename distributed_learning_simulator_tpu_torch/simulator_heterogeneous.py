"""Heterogeneous-data entry point: one client trains on a "bad" dataset
(simulator_heterogeneous.py of the JAX package).

Client ``bad_client_id`` (0 by default) gets a grayscale copy of another
dataset, cropped or padded to the packed array's spatial size and
channel-tiled to its channel count, in place of its shard; the other clients
keep their shards of the configured dataset.

    python -m distributed_learning_simulator_tpu_torch.simulator_heterogeneous \\
        --dataset_name cifar10 --model_name cnn --distributed_algorithm fed \\
        --worker_number 4 --round 5 --epoch 1 --learning_rate 0.1 \\
        --bad_dataset_name mnist --device cuda
"""

from __future__ import annotations

import numpy as np

from distributed_learning_simulator_tpu_torch.config import (
    ExperimentConfig,
    get_config,
)
from distributed_learning_simulator_tpu_torch.data.registry import get_dataset
from distributed_learning_simulator_tpu_torch.simulator import (
    build_client_data,
    run_simulation,
)
from distributed_learning_simulator_tpu_torch.utils.logging import get_logger


def heterogeneous_inputs(config: ExperimentConfig,
                         bad_dataset_name: str = "mnist",
                         bad_client_id: int = 0):
    """``(dataset, client_data)`` with ``bad_client_id``'s shard replaced
    by the grayscale "bad" dataset (``seed + 1``, ``shard_size`` samples)."""
    dataset = get_dataset(
        config.dataset_name, data_dir=config.data_dir, seed=config.seed,
        n_train=config.n_train, n_test=config.n_test, **config.dataset_args,
    )
    client_data = build_client_data(config, dataset)
    bad = get_dataset(
        bad_dataset_name, data_dir=config.data_dir, seed=config.seed + 1,
        n_train=client_data.shard_size, to_grayscale=True,
    )
    target_shape = client_data.sample_shape or client_data.x.shape[2:]
    bad_x = _fit_images(bad.x_train, target_shape)
    get_logger().info(
        "client %d gets %d samples of bad dataset %r (others keep %s shards)",
        bad_client_id, len(bad_x), bad_dataset_name, config.dataset_name,
    )
    client_data.override_client(bad_client_id, bad_x, bad.y_train)
    return dataset, client_data


def run_heterogeneous(config: ExperimentConfig,
                      bad_dataset_name: str = "mnist",
                      bad_client_id: int = 0):
    """Run the simulation with ``bad_client_id``'s shard swapped out."""
    config.validate()
    dataset, client_data = heterogeneous_inputs(config, bad_dataset_name,
                                                bad_client_id)
    return run_simulation(config, dataset=dataset, client_data=client_data)


def _fit_images(x: np.ndarray, shape) -> np.ndarray:
    """Crop/pad spatially and tile channels so ``x`` fits ``shape``."""
    h, w, c = shape
    out = np.zeros((x.shape[0], h, w, c), dtype=np.float32)
    hh, ww = min(h, x.shape[1]), min(w, x.shape[2])
    src = x[:, :hh, :ww, :]
    if src.shape[-1] == 1 and c > 1:
        src = np.repeat(src, c, axis=-1)
    out[:, :hh, :ww, : src.shape[-1]] = src[..., :c]
    return out


def main(argv: list[str] | None = None):
    import argparse

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--bad_dataset_name", type=str, default="mnist")
    pre.add_argument("--bad_client_id", type=int, default=0)
    known, rest = pre.parse_known_args(argv)
    return run_heterogeneous(
        get_config(rest), bad_dataset_name=known.bad_dataset_name,
        bad_client_id=known.bad_client_id,
    )


if __name__ == "__main__":
    main()
