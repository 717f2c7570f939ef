"""One FedAvg round of the port (algorithms/fedavg.py) against the JAX
package's round program, from the same transplanted init and with the JAX
package's batch orders injected into the port (the JAX key chain:
``train_key = round_key_splits(round_key)[1]``, ``client_key =
split(train_key, n)[i]``, each epoch ``permutation(split(client_key,
E)[e], n_slots)``).

Tolerance: rtol 1e-4 / atol 1e-5 on the aggregate (f32 training in another
op order, then an f32 weighted sum in another order).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.algorithms.fedavg import (
    FedAvg as JaxFedAvg,
    round_key_splits,
)
from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.models.resnet import (
    ResNet18 as JaxResNet18,
)
from distributed_learning_simulator_tpu.ops.aggregate import (
    weighted_mean as jax_weighted_mean,
)
from distributed_learning_simulator_tpu.parallel import engine as jengine
from distributed_learning_simulator_tpu_torch.algorithms.fedavg import FedAvg
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.data.registry import get_dataset
from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_leaf_order,
    params_from_jax,
)
from distributed_learning_simulator_tpu_torch.models.registry import (
    ParamLayout,
)
from distributed_learning_simulator_tpu_torch.models.resnet import ResNet18
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.aggregate import (
    weighted_mean,
)
from distributed_learning_simulator_tpu_torch.parallel import engine
from distributed_learning_simulator_tpu_torch.simulator import (
    build_client_data,
)

HW = 8

# (workers, data seed, max_shard_size, chunk, bucket): the split each case
# produces is asserted below.
CASES = {
    # 4 Dirichlet clients [8, 8, 0, 8] at chunk 2: the bucket plan has an
    # empty group and a 3-client group (one chunk + a remainder chunk).
    "bucketed_remainder": (4, 5, 8, 2, True),
    # Sizes [3, 0, 6, 2, 12]: groups of 3 and 1 steps, the second slicing
    # every member's shard to 4 of its 12 slots (shorter permutations).
    "bucketed_sliced": (5, 16, 12, 2, True),
    # Scheduling off: chunks [0, 1], [2, 3] in client order, the empty
    # client trained on fully masked slots at weight 0.
    "plain_chunks": (4, 5, 8, 2, False),
}


def _setup(workers, seed, cap, chunk, bucket):
    kw = dict(
        dataset_name="synthetic", model_name="resnet18", worker_number=workers,
        seed=seed, epoch=2, batch_size=4, learning_rate=0.05, momentum=0.9,
        weight_decay=1e-3, partition="dirichlet", dirichlet_alpha=0.1,
        max_shard_size=cap, client_chunk_size=chunk,
        bucket_client_work=bucket,
    )
    ds = get_dataset("synthetic", n_train=48 if workers == 5 else 64,
                     n_test=8, seed=seed, shape=(HW, HW, 3))
    cfg = ExperimentConfig(device="cpu", **kw)
    cd = build_client_data(cfg, ds)
    return cfg, JaxConfig(**kw), cd


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_matches_jax(case):
    cfg, jcfg, cd = _setup(*CASES[case])
    sizes = {"bucketed_remainder": [8, 8, 0, 8], "plain_chunks": [8, 8, 0, 8],
             "bucketed_sliced": [3, 0, 6, 2, 12]}[case]
    np.testing.assert_array_equal(cd.sizes, sizes)
    n = cd.n_clients
    sample_shape = cd.sample_shape

    jmodel = JaxResNet18(stage_sizes=(1,), width=8, dtype=jnp.float32)
    jparams = flax.core.unfreeze(jmodel.init(
        jax.random.key(1), jnp.zeros((1,) + sample_shape, jnp.float32)
    )["params"])
    tx = jengine.make_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    jround = JaxFedAvg(jcfg).make_round_fn(
        jmodel.apply, tx, n, preprocess=jengine.make_decoder(sample_shape),
        client_sizes=cd.sizes,
    )
    round_key = jax.random.key(2)
    j_new, _, j_aux = jax.jit(jround)(
        jparams, None, jnp.asarray(cd.x), jnp.asarray(cd.y),
        jnp.asarray(cd.mask), jnp.asarray(cd.sizes), round_key,
    )

    train_key = round_key_splits(round_key, False)[1]
    client_keys = jax.random.split(train_key, n)
    slots_seen = {}

    def client_rng(i, n_slots):
        slots_seen[i] = n_slots
        perms = [
            torch.from_numpy(np.asarray(jax.random.permutation(k, n_slots)))
            for k in jax.random.split(client_keys[i], cfg.epoch)
        ]
        salt = int(jax.random.key_data(
            jax.random.fold_in(client_keys[i], 7)
        ).reshape(-1)[0])
        return perms, salt

    model = ResNet18(stage_sizes=(1,), width=8, dtype=torch.float32)
    params = params_from_jax(jparams)
    layout = ParamLayout.from_params(params, jax_leaf_order(model, (HW, HW)))

    def apply_fn(views, x):
        return torch.func.functional_call(model, views, (x,))

    round_fn = FedAvg(cfg).make_round_fn(
        apply_fn, engine.make_optimizer("sgd", 0.05, 0.9, 1e-3), layout, n,
        preprocess=engine.make_decoder(sample_shape),
        client_sizes=cd.sizes, device="cpu",
    )
    new, state, aux = round_fn(
        layout.flatten(params), None, torch.from_numpy(cd.x),
        torch.from_numpy(cd.y.astype(np.int64)), torch.from_numpy(cd.mask),
        cd.sizes, np.asarray(jax.random.key_data(round_key)),
        client_rng=client_rng,
    )
    expected_slots = {
        "bucketed_remainder": {0: 8, 1: 8, 3: 8},
        "bucketed_sliced": {4: 12, 2: 12, 0: 4, 3: 4},
        "plain_chunks": {0: 8, 1: 8, 2: 8, 3: 8},
    }[case]
    assert slots_seen == expected_slots
    assert state is None
    want = params_from_jax(jax.device_get(j_new))
    for name, leaf in layout.unflatten(new).items():
        np.testing.assert_allclose(leaf.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(aux["client_loss"].numpy(),
                               np.asarray(j_aux["client_loss"]), rtol=1e-4)


def test_all_empty_round_keeps_previous_global():
    cfg, _, cd = _setup(*CASES["bucketed_remainder"])
    model = ResNet18(stage_sizes=(1,), width=8, dtype=torch.float32)
    params = {k: torch.randn(v.shape) for k, v in model.state_dict().items()}
    layout = ParamLayout.from_params(params, sorted(params))

    def apply_fn(views, x):
        return torch.func.functional_call(model, views, (x,))

    cfg = dataclasses.replace(cfg, bucket_client_work=False)
    round_fn = FedAvg(cfg).make_round_fn(
        apply_fn, engine.make_optimizer("sgd", 0.05), layout, cd.n_clients,
        preprocess=engine.make_decoder(cd.sample_shape), device="cpu",
    )
    flat = layout.flatten(params)
    new, _, _ = round_fn(
        flat, None, torch.from_numpy(cd.x),
        torch.from_numpy(cd.y.astype(np.int64)),
        torch.from_numpy(cd.mask), np.zeros(cd.n_clients, np.float32),
        prng.key(0),
    )
    assert torch.equal(new, flat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_mean_matches_jax(dtype):
    rng = np.random.default_rng(8)
    stack = rng.normal(size=(6, 33)).astype(np.float32)
    for weights in (rng.integers(0, 50, size=6).astype(np.float32),
                    np.zeros(6, np.float32)):
        want = jax_weighted_mean(
            jnp.asarray(stack).astype(getattr(jnp, dtype)), weights
        )
        got = weighted_mean(
            torch.from_numpy(stack).to(getattr(torch, dtype)), weights
        )
        # f32: reduction order only; bf16: the contraction rounds to bf16.
        tol = 1e-6 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
