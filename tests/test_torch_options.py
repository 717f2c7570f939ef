"""The FedAvg-path options the port gained beside the models, and the two
run-level faults it repaired, each against the JAX package on the CPU:

* ``augment='cifar'`` (ops/augment.py): the augmented batch is BITWISE the
  JAX package's for the same key (the flip and crop draws replay
  ``jax.random.bernoulli``/``randint``), and a 2-round run with nothing
  injected gives the JAX test losses at rtol 1e-4 (f32 model);
* ``reset_client_optimizer=False``: each client's momentum trace after 2
  rounds equals the JAX package's at rtol 1e-4, atol 1e-6 (f32), under
  full participation (the size-aware schedule) and a hashed half cohort
  (clients outside the cohort keep their state);
* ``client_chunk_size=0``: with the device budget injected into both
  packages, the resolved chunk is the JAX package's, in the footprint
  model alone and in a run's result dict;
* the default data directory is the JAX package's (the same ``.npz``
  path is asked for), and an ``.npz`` under ``data_dir`` loads the same
  arrays;
* ``run_simulation``'s result has the JAX package's keys plus ``device``,
  with the same off values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import simulator as jsimulator
from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.data import registry as jdata
from distributed_learning_simulator_tpu.models.registry import (
    get_model as jax_get_model,
)
from distributed_learning_simulator_tpu.ops.augment import (
    cifar_augment as jax_cifar_augment,
)
from distributed_learning_simulator_tpu_torch import simulator
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.data import registry as pdata
from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_leaf_order,
    params_from_jax,
)
from distributed_learning_simulator_tpu_torch.models.registry import (
    get_model,
)
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.augment import (
    cifar_augment,
    get_augment,
)
from torch_runs import BASE, HW, losses_of, run_both


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cifar_augment_is_bitwise_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.random((25, 32, 32, 3), dtype=np.float32)
    k = prng.fold_in(prng.fold_in(prng.key(seed), 3), 1)
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 3), 1)
    want = np.asarray(jax.jit(jax_cifar_augment)(jnp.asarray(x), jk))
    got = cifar_augment(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and not np.array_equal(got, x)


def test_augment_registry_matches_jax():
    assert get_augment("none") is None and get_augment(None) is None
    assert get_augment("CIFAR") is cifar_augment
    with pytest.raises(ValueError, match="unknown augmentation"):
        get_augment("mixup")
    with pytest.raises(ValueError, match="unknown augmentation"):
        ExperimentConfig(augment="mixup", device="cpu").validate()


def test_augmented_run_matches_jax():
    jres, pres = run_both(augment="cifar")
    np.testing.assert_allclose(losses_of(pres), losses_of(jres), rtol=1e-4)
    # The un-augmented run draws other batch orders (the key is split
    # only when augmenting), so its losses differ.
    _, plain = run_both()
    assert not np.allclose(losses_of(plain), losses_of(pres), rtol=1e-4)


def _jax_traces(jres, names):
    """The JAX run's per-client momentum traces ``[n_clients, P]`` in the
    port's leaf order."""
    trace = jres["client_state"][0].trace
    n = jax.tree_util.tree_leaves(trace)[0].shape[0]
    rows = []
    for c in range(n):
        tree = jax.tree_util.tree_map(lambda a, c=c: np.asarray(a[c]), trace)
        leaves = params_from_jax(tree)
        rows.append(torch.cat([leaves[k].reshape(-1) for k in names]))
    return torch.stack(rows)


@pytest.mark.parametrize("changes", [
    {}, {"participation_fraction": 0.5, "participation_sampler": "hashed"},
])
def test_persistent_client_optimizer_state_matches_jax(changes):
    jres, pres = run_both(reset_client_optimizer=False, **changes)
    model = get_model("resnet18", input_shape=(HW, HW, 3),
                      **BASE["model_args"])
    names = jax_leaf_order(model, (HW, HW))
    want = _jax_traces(jres, names)
    got = pres["client_state"]
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    assert bool((want.abs().sum(1) > 0).any())
    if changes:
        # Two half cohorts: some clients trained in no round, and their
        # state is still the fresh zeros.
        assert bool((want.abs().sum(1) == 0).any())
    np.testing.assert_allclose(losses_of(pres), losses_of(jres), rtol=1e-4)


@pytest.mark.parametrize("memory", [None, 80 * 1024**3, 2 * 1024**3])
@pytest.mark.parametrize("model_name,cfg", [
    ("resnet18", {"worker_number": 1000}),
    ("resnet18", {"worker_number": 100, "reset_client_optimizer": False,
                  "momentum": 0.9}),
    ("resnet18", {"worker_number": 1000, "distributed_algorithm":
                  "sign_SGD", "momentum": 0.9}),
    ("cnn_tpu", {"worker_number": 1000, "participation_fraction": 0.1}),
    ("mlp", {"worker_number": 7}),
])
def test_auto_chunk_matches_jax(monkeypatch, memory, model_name, cfg):
    """The footprint model (``_auto_chunk_size``) with the device memory
    injected into both packages (None: neither reports any, 16 GB)."""
    monkeypatch.setattr(jsimulator, "hbm_limit_bytes", lambda: memory)
    monkeypatch.setattr(simulator, "device_memory_bytes", lambda d: memory)
    shape = (32, 32, 3)
    jparams = jax.eval_shape(
        jax_get_model(model_name).init, jax.random.key(0),
        jax.ShapeDtypeStruct((1,) + shape, jnp.float32))["params"]
    model = get_model(model_name, input_shape=shape)
    n_params = sum(p.numel() for p in model.parameters())
    kw = dict(model_name=model_name, client_chunk_size=0, **cfg)
    n = cfg["worker_number"]
    want = jsimulator._auto_chunk_size(JaxConfig(**kw), jparams, n)
    got = simulator._auto_chunk_size(ExperimentConfig(device="cpu", **kw),
                                     n_params, n, torch.device("cpu"))
    assert got == want


def test_auto_chunk_run_matches_jax(monkeypatch):
    """A run with ``client_chunk_size=0`` and an injected budget small
    enough that the chunk (3) is below the cohort: the result dict holds
    the resolved chunk, and the losses are the JAX run's."""
    model = get_model("resnet18", input_shape=(HW, HW, 3),
                      **BASE["model_args"])
    param_bytes = 4 * sum(p.numel() for p in model.parameters())
    memory = 3 * 4 * param_bytes / 0.6 + 1
    monkeypatch.setattr(jsimulator, "hbm_limit_bytes", lambda: memory)
    monkeypatch.setattr(simulator, "device_memory_bytes", lambda d: memory)
    jres, pres = run_both(client_chunk_size=0)
    assert jres["client_chunk_size"] == 3
    assert pres["client_chunk_size"] == 3
    np.testing.assert_allclose(losses_of(pres), losses_of(jres), rtol=1e-4)


def test_default_data_dir_is_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("DLS_DATA_DIR", raising=False)
    asked = []
    real_exists = pdata.os.path.exists

    def exists(path):
        if str(path).endswith(".npz"):
            asked.append(str(path))
            return False
        return real_exists(path)

    monkeypatch.setattr(pdata.os.path, "exists", exists)
    jdata.get_dataset("cifar10", n_train=8, n_test=8)
    pdata.get_dataset("cifar10", n_train=8, n_test=8)
    assert len(asked) == 2 and asked[0] == asked[1]
    assert asked[1].startswith(pdata.DEFAULT_DATA_DIR)
    monkeypatch.setattr(pdata.os.path, "exists", real_exists)

    rng = np.random.default_rng(0)
    np.savez(tmp_path / "mnist.npz",
             x_train=rng.integers(0, 256, (12, 28, 28), dtype=np.uint8),
             y_train=rng.integers(0, 10, 12),
             x_test=rng.integers(0, 256, (6, 28, 28), dtype=np.uint8),
             y_test=rng.integers(0, 10, 6))
    want = jdata.get_dataset("mnist", data_dir=str(tmp_path))
    got = pdata.get_dataset("mnist", data_dir=str(tmp_path))
    for field in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


#: Result-dict values that are objects or timings, not feature off values.
_RUN_VALUES = {"global_params", "client_state", "history", "algorithm",
               "final_accuracy", "total_seconds", "client_rounds_per_sec"}


def test_result_keys_and_off_values_match_jax():
    jres, pres = run_both(round=1)
    assert set(pres) == set(jres) | {"device"}
    assert tuple(pres) == simulator.RESULT_KEYS
    assert pres["device"] == "cpu"
    for k in set(jres) - _RUN_VALUES:
        assert pres[k] == jres[k], k
