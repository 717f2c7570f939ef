"""The port's archive parsers (data/formats.py) and its heterogeneous-data
entry point (simulator_heterogeneous.py) against the JAX package's.

* Parsers: on the same synthetic archive bytes (IDX for MNIST, pickled CHW
  batches in a tar.gz for CIFAR-10) the arrays are identical, dtypes
  included, and malformed buffers raise the same errors.
* Heterogeneous runs: client 0's packed shard is exactly the JAX package's
  (the grayscale "bad" dataset, cropped and channel-tiled), the other
  clients keep their own shards, and a 2-round f32 run gives the JAX test
  losses at rtol 1e-4 (the accuracy band of tests/test_torch_band.py).
"""

import gzip
import io
import pickle
import struct
import tarfile

import numpy as np
import pytest

from distributed_learning_simulator_tpu import (
    simulator_heterogeneous as jhetero,
)
from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.data import formats as jformats
from distributed_learning_simulator_tpu.data.registry import (
    get_dataset as jax_get_dataset,
)
from distributed_learning_simulator_tpu.simulator import (
    build_client_data as jax_build_client_data,
)
from distributed_learning_simulator_tpu_torch import simulator_heterogeneous
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.data import formats
from distributed_learning_simulator_tpu_torch.simulator import (
    build_client_data,
)


def _idx_bytes(arr: np.ndarray) -> bytes:
    codes = {np.dtype(np.uint8): 0x08, np.dtype(">i4"): 0x0C,
             np.dtype(">f4"): 0x0D}
    header = bytes([0, 0, codes[arr.dtype], arr.ndim])
    header += struct.pack(f">{arr.ndim}I", *arr.shape)
    return header + arr.tobytes()


def _cifar_targz(batches) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name, (x, labels) in batches.items():
            payload = pickle.dumps({b"data": x, b"labels": labels},
                                   protocol=2)
            info = tarfile.TarInfo(name=f"cifar-10-batches-py/{name}")
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
    return buf.getvalue()


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", [np.uint8, ">i4", ">f4"])
def test_parse_idx_matches_jax(dtype):
    rng = np.random.default_rng(0)
    arr = (rng.random((3, 5, 4)) * 200).astype(np.dtype(dtype))
    raw = _idx_bytes(arr)
    np.testing.assert_array_equal(formats.parse_idx(raw),
                                  jformats.parse_idx(raw))
    for bad, match in ((b"\x01\x00\x08\x01" + b"\x00" * 8, "magic"),
                       (raw[:-arr.dtype.itemsize], "mismatch")):
        for parse in (formats.parse_idx, jformats.parse_idx):
            with pytest.raises(ValueError, match=match):
                parse(bad)


def test_mnist_and_cifar_archives_match_jax():
    rng = np.random.default_rng(1)
    parts = [rng.integers(0, 256, s, dtype=np.uint8)
             for s in ((6, 28, 28), (6,), (3, 28, 28), (3,))]
    gz = [gzip.compress(_idx_bytes(a)) for a in parts]
    _same(formats.mnist_arrays(*gz), jformats.mnist_arrays(*gz))

    def batch(n):
        return (rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                rng.integers(0, 10, n).tolist())

    raw = _cifar_targz({"data_batch_2": batch(4), "test_batch": batch(3),
                        "data_batch_1": batch(5), "batches.meta": batch(1)})
    _same(formats.cifar10_arrays(raw), jformats.cifar10_arrays(raw))
    empty = _cifar_targz({"readme": batch(1)})
    for parse in (formats.cifar10_arrays, jformats.cifar10_arrays):
        with pytest.raises(ValueError, match="no CIFAR batches"):
            parse(empty)


HETERO = dict(
    dataset_name="cifar10", model_name="cnn", worker_number=4, round=2,
    epoch=1, learning_rate=0.1, batch_size=20, n_train=160, n_test=64,
    eval_batch_size=32, partition="iid", log_level="WARNING",
    model_args={"width": 8, "dtype": "float32"},
)


def test_heterogeneous_shard_and_run_match_jax(tmp_path):
    jcfg = JaxConfig(log_root=str(tmp_path / "jax"), **HETERO)
    pcfg = ExperimentConfig(device="cpu", log_root=str(tmp_path / "port"),
                            **HETERO)
    dataset, cd = simulator_heterogeneous.heterogeneous_inputs(pcfg)
    # The JAX package's override, spelled out (run_heterogeneous builds the
    # same arrays internally).
    jds = jax_get_dataset("cifar10", seed=0, n_train=160, n_test=64)
    want = jax_build_client_data(jcfg, jds)
    plain = build_client_data(pcfg, dataset)
    bad = jax_get_dataset("mnist", seed=1, n_train=want.shard_size,
                          to_grayscale=True)
    want.override_client(0, jhetero._fit_images(bad.x_train, (32, 32, 3)),
                         bad.y_train)
    for field in ("x", "y", "mask", "sizes"):
        np.testing.assert_array_equal(getattr(cd, field),
                                      getattr(want, field), err_msg=field)
    assert not np.array_equal(cd.x[0], plain.x[0])
    np.testing.assert_array_equal(cd.x[1:], plain.x[1:])

    jres = jhetero.run_heterogeneous(jcfg)
    pres = simulator_heterogeneous.run_heterogeneous(pcfg)
    np.testing.assert_allclose(
        [r["test_loss"] for r in pres["history"]],
        [r["test_loss"] for r in jres["history"]], rtol=1e-4)
    assert [r["test_accuracy"] for r in pres["history"]] == [
        r["test_accuracy"] for r in jres["history"]]


def test_heterogeneous_cli_takes_the_bad_dataset_flags(tmp_path):
    argv = ["--dataset_name", "synthetic", "--model_name", "mlp",
            "--worker_number", "3", "--round", "1", "--n_train", "96",
            "--n_test", "32", "--batch_size", "16", "--device", "cpu",
            "--log_level", "WARNING", "--log_root", str(tmp_path),
            "--bad_dataset_name", "digits", "--bad_client_id", "2"]
    result = simulator_heterogeneous.main(argv)
    assert np.isfinite(result["history"][0]["test_loss"])
