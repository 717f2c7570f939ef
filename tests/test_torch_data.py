"""The port's data path (data/registry.py, data/partition.py,
simulator.build_client_data) is the JAX package's, array for array:
``np.array_equal`` over three seeds."""

import dataclasses

import numpy as np
import pytest

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.data import partition as jpart
from distributed_learning_simulator_tpu.data import registry as jreg
from distributed_learning_simulator_tpu.simulator import (
    build_client_data as jax_build_client_data,
)
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.data import partition, registry
from distributed_learning_simulator_tpu_torch.simulator import (
    build_client_data,
)

SEEDS = (0, 1, 2)


def _assert_datasets_equal(a, b):
    assert a.name == b.name and a.num_classes == b.num_classes
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


def _assert_client_data_equal(a, b):
    for f in ("x", "y", "mask", "sizes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.sample_shape == b.sample_shape


@pytest.mark.parametrize("seed", SEEDS)
def test_get_dataset_matches_jax(seed, tmp_path):
    cases = [
        ("synthetic", {"n_train": 300, "n_test": 50, "difficulty": 0.5}),
        ("synthetic", {"n_train": 64, "n_test": 16, "shape": (8, 8, 3),
                       "num_classes": 4}),
        # No cifar10.npz in data_dir: the synthetic surrogate (+ WARNING).
        ("cifar10", {"n_train": 200, "n_test": 40,
                     "data_dir": str(tmp_path)}),
        ("mnist", {"n_train": 100, "n_test": 20, "to_grayscale": True,
                   "data_dir": str(tmp_path)}),
    ]
    for name, kw in cases:
        _assert_datasets_equal(
            registry.get_dataset(name, seed=seed, **kw),
            jreg.get_dataset(name, seed=seed, **kw),
        )


def test_load_npz_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(
        tmp_path / "mnist.npz",
        x_train=rng.integers(0, 256, (20, 6, 6)).astype(np.uint8),
        y_train=rng.integers(0, 10, 20), x_test=rng.integers(0, 256, (5, 6, 6)),
        y_test=rng.integers(0, 10, 5),
    )
    _assert_datasets_equal(
        registry.get_dataset("mnist", data_dir=str(tmp_path)),
        jreg.get_dataset("mnist", data_dir=str(tmp_path)),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_partitions_and_packing_match_jax(seed):
    ds = jreg.get_dataset("synthetic", n_train=400, n_test=10, seed=seed,
                          shape=(4, 4, 3))
    parts = [
        (partition.iid_partition(400, 7, seed=seed),
         jpart.iid_partition(400, 7, seed=seed)),
        (partition.dirichlet_partition(ds.y_train, 9, 0.1, seed=seed),
         jpart.dirichlet_partition(ds.y_train, 9, 0.1, seed=seed)),
        (partition.dirichlet_partition(ds.y_train, 5, 1.0, seed=seed,
                                       min_size=5),
         jpart.dirichlet_partition(ds.y_train, 5, 1.0, seed=seed,
                                   min_size=5)),
    ]
    for got, want in parts:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for compact in (True, False):
            for shard, bsz in ((None, 8), (32, None)):
                _assert_client_data_equal(
                    partition.pack_client_shards(
                        ds.x_train, ds.y_train, got, shard_size=shard,
                        batch_size=bsz, compact=compact),
                    jpart.pack_client_shards(
                        ds.x_train, ds.y_train, want, shard_size=shard,
                        batch_size=bsz, compact=compact),
                )


@pytest.mark.parametrize("seed", SEEDS)
def test_build_client_data_with_shard_cap_matches_jax(seed):
    ds = jreg.get_dataset("synthetic", n_train=500, n_test=10, seed=seed,
                          shape=(4, 4, 1))
    base = dict(dataset_name="synthetic", worker_number=12, seed=seed,
                batch_size=5, partition="dirichlet", dirichlet_alpha=0.1,
                max_shard_size=30)
    for overrides in ({}, {"partition": "iid"},
                      {"compact_client_data": False, "max_shard_size": None}):
        cfg = dataclasses.replace(ExperimentConfig(**base), **overrides)
        jcfg = dataclasses.replace(JaxConfig(**base), **overrides)
        _assert_client_data_equal(build_client_data(cfg, ds),
                                  jax_build_client_data(jcfg, ds))
