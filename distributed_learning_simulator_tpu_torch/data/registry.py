"""Dataset registry: name -> train/test numpy arrays (data/registry.py of
the JAX package, copied so the port imports nothing of it).

``mnist`` / ``cifar10`` / ``cifar100`` load ``<data_dir>/<name>.npz`` (keys
x_train/y_train/x_test/y_test) when it exists and otherwise fall back to a
deterministic synthetic surrogate with identical shapes, with a WARNING
line; ``digits`` is scikit-learn's bundled real-pixel set; ``synthetic`` is
explicitly synthetic. The arrays are identical to the JAX package's for the
same arguments (tests/test_torch_data.py), and so is the directory: without
``data_dir``, ``$DLS_DATA_DIR`` or else :data:`DEFAULT_DATA_DIR`, where
scripts/fetch_datasets.py writes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from distributed_learning_simulator_tpu_torch.utils.logging import get_logger


@dataclass
class Dataset:
    name: str
    x_train: np.ndarray  # [N, H, W, C] float32 in [0, 1]
    y_train: np.ndarray  # [N] int32
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int

    @property
    def input_shape(self):
        return self.x_train.shape[1:]


#: The JAX package's default dataset directory (its data/registry.py).
DEFAULT_DATA_DIR = "/root/data"

_SHAPES = {
    "mnist": ((28, 28, 1), 10, 60000, 10000),
    "cifar10": ((32, 32, 3), 10, 50000, 10000),
    "cifar100": ((32, 32, 3), 100, 50000, 10000),
}


def _synthetic_classification(
    name: str,
    shape,
    num_classes: int,
    n_train: int,
    n_test: int,
    seed: int = 0,
    difficulty: float = 0.75,
) -> Dataset:
    """Deterministic learnable surrogate: per-class Gaussian prototypes.

    sample = clip(0.5 + 0.5*(prototype * (1-difficulty) + noise * difficulty)).
    Lower difficulty -> higher achievable accuracy.
    """
    rng = np.random.default_rng(seed)
    dim = int(np.prod(shape))
    prototypes = rng.normal(0.0, 1.0, size=(num_classes, dim)).astype(np.float32)

    def make(n, label_seed):
        lrng = np.random.default_rng(label_seed)
        y = lrng.integers(0, num_classes, size=n).astype(np.int32)
        noise = lrng.normal(0.0, 1.0, size=(n, dim)).astype(np.float32)
        x = prototypes[y] * (1.0 - difficulty) + noise * difficulty
        x = np.clip(0.5 + 0.5 * x, 0.0, 1.0).astype(np.float32)
        return x.reshape((n,) + tuple(shape)), y

    x_train, y_train = make(n_train, seed + 1)
    x_test, y_test = make(n_test, seed + 2)
    return Dataset(name, x_train, y_train, x_test, y_test, num_classes)


def _load_npz(path: str, name: str, num_classes: int) -> Dataset:
    with np.load(path) as z:
        x_train = z["x_train"].astype(np.float32)
        y_train = z["y_train"].astype(np.int32)
        x_test = z["x_test"].astype(np.float32)
        y_test = z["y_test"].astype(np.int32)
    if x_train.ndim == 3:  # [N, H, W] -> NHWC
        x_train = x_train[..., None]
        x_test = x_test[..., None]
    if x_train.max() > 1.5:  # raw uint8 range
        x_train = x_train / 255.0
        x_test = x_test / 255.0
    return Dataset(name, x_train, y_train, x_test, y_test, num_classes)


def _load_digits(name: str, seed: int) -> Dataset:
    """REAL pixels with no network: scikit-learn's bundled handwritten-digits
    set (1797 8x8 grayscale images, the UCI/NIST optdigits test subsample,
    shipped inside sklearn itself). This is the offline container's genuine
    real-data path — every other real dataset needs a download (see
    scripts/fetch_datasets.py and docs/ACCURACY.md). Deterministic seeded
    1500/297 train/test split; pixels rescaled from the 0-16 integer range
    to [0, 1]."""
    from sklearn.datasets import load_digits

    d = load_digits()
    x = (d.images / 16.0).astype(np.float32)[..., None]
    y = d.target.astype(np.int32)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(y))
    x, y = x[perm], y[perm]
    n_tr = 1500
    return Dataset(name, x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:], 10)


def _to_grayscale(ds: Dataset) -> Dataset:
    def gray(x):
        if x.shape[-1] == 1:
            return x
        w = np.array([0.299, 0.587, 0.114], dtype=np.float32)
        return (x @ w)[..., None]

    return Dataset(
        ds.name + "_gray", gray(ds.x_train), ds.y_train, gray(ds.x_test),
        ds.y_test, ds.num_classes,
    )


def get_dataset(
    name: str,
    data_dir: str | None = None,
    seed: int = 0,
    n_train: int | None = None,
    n_test: int | None = None,
    to_grayscale: bool = False,
    **synthetic_kwargs,
) -> Dataset:
    """Fetch a dataset by name.

    Names: ``mnist`` / ``cifar10`` / ``cifar100`` (local .npz or synthetic
    surrogate), ``digits`` (REAL handwritten-digit pixels bundled with
    scikit-learn — works fully offline), and ``synthetic`` (explicitly
    synthetic; accepts ``shape``, ``num_classes``, ``difficulty``).
    ``n_train``/``n_test`` subsample for fast tests. ``to_grayscale`` is the
    reference's ``dataset_args`` heterogeneity knob (simulator_backup.py:50).
    """
    key = name.lower()
    data_dir = data_dir or os.environ.get("DLS_DATA_DIR", DEFAULT_DATA_DIR)
    if key == "digits":
        ds = _load_digits(key, seed=seed)
    elif key == "synthetic":
        shape = tuple(synthetic_kwargs.pop("shape", (8, 8, 1)))
        num_classes = synthetic_kwargs.pop("num_classes", 10)
        ds = _synthetic_classification(
            key, shape, num_classes, n_train or 4096, n_test or 1024,
            seed=seed, **synthetic_kwargs,
        )
    elif key in _SHAPES:
        shape, num_classes, full_train, full_test = _SHAPES[key]
        npz = os.path.join(data_dir, f"{key}.npz")
        if os.path.exists(npz):
            ds = _load_npz(npz, key, num_classes)
        else:
            get_logger().warning(
                "dataset %r not found at %s (offline environment); using a "
                "deterministic synthetic surrogate with identical shapes",
                key, npz,
            )
            ds = _synthetic_classification(
                key, shape, num_classes, n_train or full_train,
                n_test or full_test, seed=seed, **synthetic_kwargs,
            )
    else:
        raise ValueError(
            f"unknown dataset {name!r}; known: "
            f"{sorted(_SHAPES) + ['digits', 'synthetic']}"
        )
    if n_train is not None:
        ds.x_train, ds.y_train = ds.x_train[:n_train], ds.y_train[:n_train]
    if n_test is not None:
        ds.x_test, ds.y_test = ds.x_test[:n_test], ds.y_test[:n_test]
    if to_grayscale:
        ds = _to_grayscale(ds)
    return ds
