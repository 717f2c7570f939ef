"""Parsers for the standard dataset archive formats, stdlib + numpy only
(data/formats.py of the JAX package, copied so the port imports nothing of
it; tests/test_torch_formats.py holds the outputs identical).

They convert the official MNIST (IDX) and CIFAR (python-pickle batch)
archives into the ``.npz`` layout the registry loads (data/registry.py
``_load_npz``: keys x_train/y_train/x_test/y_test).
"""

from __future__ import annotations

import gzip
import io
import pickle
import struct
import tarfile

import numpy as np

_IDX_DTYPES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def parse_idx(raw: bytes) -> np.ndarray:
    """Parse an IDX-format buffer (the MNIST container format).

    Layout: 2 zero bytes, dtype code, ndim, then ndim big-endian uint32
    dims, then row-major data.
    """
    if len(raw) < 4 or raw[0] != 0 or raw[1] != 0:
        raise ValueError("not an IDX buffer (bad magic)")
    dtype_code, ndim = raw[2], raw[3]
    if dtype_code not in _IDX_DTYPES:
        raise ValueError(f"unknown IDX dtype code 0x{dtype_code:02x}")
    dims = struct.unpack(f">{ndim}I", raw[4 : 4 + 4 * ndim])
    dtype = _IDX_DTYPES[dtype_code]
    data = np.frombuffer(raw, dtype=dtype, offset=4 + 4 * ndim)
    expected = int(np.prod(dims))
    if data.size != expected:
        raise ValueError(
            f"IDX size mismatch: header says {expected}, buffer has {data.size}"
        )
    return data.reshape(dims)


def mnist_arrays(
    train_images_gz: bytes, train_labels_gz: bytes,
    test_images_gz: bytes, test_labels_gz: bytes,
) -> dict[str, np.ndarray]:
    """Gzipped IDX archives -> registry npz dict ([N, 28, 28] uint8 images)."""
    return {
        "x_train": parse_idx(gzip.decompress(train_images_gz)),
        "y_train": parse_idx(gzip.decompress(train_labels_gz)).astype(np.int32),
        "x_test": parse_idx(gzip.decompress(test_images_gz)),
        "y_test": parse_idx(gzip.decompress(test_labels_gz)).astype(np.int32),
    }


def cifar10_arrays(tar_gz: bytes) -> dict[str, np.ndarray]:
    """cifar-10-python.tar.gz -> registry npz dict (NHWC uint8 images).

    The archive holds pickled batches with ``data`` [N, 3072] uint8 in CHW
    order and ``labels``; 5 train batches + 1 test batch.
    """
    train_x, train_y, test_x, test_y = [], [], None, None
    with tarfile.open(fileobj=io.BytesIO(tar_gz), mode="r:gz") as tf:
        for member in tf.getmembers():
            name = member.name.rsplit("/", 1)[-1]
            if not (name.startswith("data_batch") or name == "test_batch"):
                continue
            batch = pickle.loads(tf.extractfile(member).read(),
                                 encoding="bytes")
            x = np.asarray(batch[b"data"], dtype=np.uint8)
            x = x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # CHW -> HWC
            y = np.asarray(batch[b"labels"], dtype=np.int32)
            if name == "test_batch":
                test_x, test_y = x, y
            else:
                train_x.append((name, x))
                train_y.append((name, y))
    if not train_x or test_x is None:
        raise ValueError("archive holds no CIFAR batches")
    train_x.sort()
    train_y.sort()
    return {
        "x_train": np.concatenate([x for _, x in train_x]),
        "y_train": np.concatenate([y for _, y in train_y]),
        "x_test": test_x,
        "y_test": test_y,
    }
