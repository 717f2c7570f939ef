"""sign_SGD in the port (ops/sign.py, algorithms/sign_sgd.py) against the
JAX package: the leaf ops bit for bit (ties and sign(0) included), one
round of the JAX ``SignSGD`` round program with its per-epoch permutations
injected into the port, the constructor's refusals word for word, the
payload accounting on a ResNet-18 layout, and a CPU run through
``run_simulation``.

Round tolerance: the params update by exactly +-lr (plus weight decay) per
step, so where both sides vote the same sign they are bit-equal; a float-
noise difference in a near-zero gradient can flip a vote, so at least
99.9% of coordinates must be equal and every one within 2 * lr.
Momenta are f32 gradient sums: rtol 1e-5, atol 1e-5 of the largest.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.algorithms.sign_sgd import (
    SignSGD as JaxSignSGD,
)
from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.models.resnet import (
    ResNet18 as JaxResNet18,
)
from distributed_learning_simulator_tpu.ops import sign as jsign
from distributed_learning_simulator_tpu.parallel import engine as jengine
from distributed_learning_simulator_tpu_torch.algorithms.base import (
    RoundContext,
)
from distributed_learning_simulator_tpu_torch.algorithms.sign_sgd import (
    SignSGD,
)
from distributed_learning_simulator_tpu_torch.config import (
    ExperimentConfig,
    get_config,
)
from distributed_learning_simulator_tpu_torch.data.registry import get_dataset
from distributed_learning_simulator_tpu_torch.factory import get_algorithm
from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_leaf_order,
    params_from_jax,
)
from distributed_learning_simulator_tpu_torch.models.registry import (
    ParamLayout,
    get_model,
)
from distributed_learning_simulator_tpu_torch.models.resnet import ResNet18
from distributed_learning_simulator_tpu_torch.ops import cohort, sign
from distributed_learning_simulator_tpu_torch.parallel import engine
from distributed_learning_simulator_tpu_torch.simulator import (
    build_client_data,
    run_simulation,
)

HW = 8


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    # Quarter-integers: exact in f32, with zeros and exact ties.
    g = (rng.integers(-4, 5, size=(5, 40)) / 4).astype(np.float32)
    m = (rng.integers(-4, 5, size=(5, 40)) / 4).astype(np.float32)
    p = rng.standard_normal((5, 40)).astype(np.float32)
    return g, m, p


def test_sign_ops_bit_exact():
    g, m, p = _arrays()
    ties = np.array([[1, -1, 0, 1], [-1, 1, 0, 1]], np.float32)
    for arr in (g, ties):
        np.testing.assert_array_equal(
            sign.sign_compress(torch.from_numpy(arr)).numpy(),
            np.asarray(jsign.sign_compress(jnp.asarray(arr))))
        np.testing.assert_array_equal(
            sign.majority_vote(torch.from_numpy(arr)).numpy(),
            np.asarray(jsign.majority_vote(jnp.asarray(arr))))
    assert sign.majority_vote(torch.from_numpy(ties)).tolist() == [0, 0, 0, 1]
    first = np.array([True, False, True, False, False])[:, None]
    for mu, damp in ((0.9, 0.0), (0.5, 0.1)):
        want = jsign.momentum_leaf(jnp.asarray(m), jnp.asarray(g),
                                   jnp.asarray(first), mu, damp)
        got = sign.momentum_leaf(torch.from_numpy(m), torch.from_numpy(g),
                                 torch.from_numpy(first), mu, damp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for nesterov in (False, True):
            np.testing.assert_array_equal(
                sign.direction_leaf(torch.from_numpy(g), got, mu,
                                    nesterov).numpy(),
                np.asarray(jsign.direction_leaf(jnp.asarray(g), want, mu,
                                                nesterov)))
    # As the round program compiles it (XLA fuses it into two FMAs).
    voted = np.sign(g.sum(0))
    jit_apply = jax.jit(lambda p, v: jsign.vote_apply_leaf(p, v, 0.01, 1e-3))
    np.testing.assert_array_equal(
        sign.vote_apply_leaf(torch.from_numpy(p), torch.from_numpy(voted),
                             0.01, 1e-3).numpy(),
        np.asarray(jit_apply(jnp.asarray(p), jnp.asarray(voted))))


def test_batched_take_gathers_each_clients_rows():
    stacked = torch.arange(3 * 5 * 2).reshape(3, 5, 2)
    idx = torch.tensor([[4, 0], [1, 1], [2, 3]])
    want = torch.stack([stacked[c, idx[c]] for c in range(3)])
    assert torch.equal(cohort.batched_take(stacked, idx), want)


def _config_kw(**extra):
    kw = dict(
        dataset_name="synthetic", model_name="resnet18",
        distributed_algorithm="sign_SGD", worker_number=5, seed=3, epoch=2,
        batch_size=4, learning_rate=0.01, momentum=0.9, weight_decay=1e-3,
        partition="iid", client_chunk_size=2,
    )
    kw.update(extra)
    return kw


def _flat_momenta(jmomenta, i, layout):
    tree = jax.tree_util.tree_map(lambda a: a[i], jmomenta)
    return layout.flatten(params_from_jax(jax.device_get(tree)))


def test_round_matches_jax():
    kw = _config_kw()
    cfg = ExperimentConfig(device="cpu", **kw)
    jcfg = JaxConfig(**kw)
    ds = get_dataset("synthetic", n_train=40, n_test=8, seed=3,
                     shape=(HW, HW, 3))
    cd = build_client_data(cfg, ds)
    n, shard = cd.n_clients, cd.x.shape[1]
    assert (n, shard) == (5, 8)  # two steps per epoch
    sample_shape = cd.sample_shape

    jmodel = JaxResNet18(stage_sizes=(1,), width=8, dtype=jnp.float32)
    jparams = flax.core.unfreeze(jmodel.init(
        jax.random.key(1), jnp.zeros((1,) + sample_shape, jnp.float32)
    )["params"])
    tx = jengine.make_optimizer("sgd", 0.01, momentum=0.9)
    jalgo = JaxSignSGD(jcfg)
    jround = jalgo.make_round_fn(
        jmodel.apply, tx, n, preprocess=jengine.make_decoder(sample_shape),
    )
    jstate = jalgo.init_client_state(tx, jparams, n)
    key = jax.random.key(2)
    j_new, j_state, j_aux = jax.jit(jround)(
        jparams, jstate, jnp.asarray(cd.x), jnp.asarray(cd.y),
        jnp.asarray(cd.mask), jnp.asarray(cd.sizes), key,
    )
    # The JAX program's batch orders: per epoch, one permutation per client.
    perms = [
        jax.vmap(lambda k: jax.random.permutation(k, shard))(
            jax.random.split(ek, n))
        for ek in jax.random.split(key, cfg.epoch)
    ]

    def client_rng(i, n_slots):
        assert n_slots == shard
        return [torch.from_numpy(np.asarray(p[i])) for p in perms], 0

    model = ResNet18(stage_sizes=(1,), width=8, dtype=torch.float32)
    params = params_from_jax(jparams)
    layout = ParamLayout.from_params(params, jax_leaf_order(model, (HW, HW)))

    def apply_fn(views, x):
        return torch.func.functional_call(model, views, (x,))

    algo = SignSGD(cfg)
    flat = layout.flatten(params)
    state = algo.init_client_state(None, flat, n)
    round_fn = algo.make_round_fn(
        apply_fn, None, layout, n,
        preprocess=engine.make_decoder(sample_shape), device="cpu",
    )
    new, state, aux = round_fn(
        flat, state, torch.from_numpy(cd.x),
        torch.from_numpy(cd.y.astype(np.int64)), torch.from_numpy(cd.mask),
        cd.sizes, np.asarray(jax.random.key_data(key)),
        client_rng=client_rng,
    )
    want = layout.flatten(params_from_jax(jax.device_get(j_new)))
    diff = (new - want).abs()
    steps = cfg.epoch * (shard // cfg.batch_size)
    assert aux["sync_steps"] == int(j_aux["sync_steps"]) == steps
    assert (diff == 0).float().mean().item() >= 0.999
    assert diff.max().item() <= 2 * cfg.learning_rate
    assert state["steps"].tolist() == np.asarray(j_state["steps"]).tolist()
    for i in range(n):
        jm = _flat_momenta(j_state["momenta"], i, layout)
        np.testing.assert_allclose(
            state["momenta"][i].numpy(), jm.numpy(), rtol=1e-5,
            atol=1e-5 * jm.abs().max().item(), err_msg=f"client {i}")
    np.testing.assert_allclose(float(aux["mean_client_loss"]),
                               float(j_aux["mean_client_loss"]), rtol=1e-4)


def test_no_momentum_keeps_no_state():
    cfg = ExperimentConfig(device="cpu", **_config_kw(momentum=0.0))
    assert SignSGD(cfg).init_client_state(None, torch.zeros(3), 4) is None


@pytest.mark.parametrize("change", [
    dict(optimizer_name="adam"),
    dict(augment="flip"),
    dict(aggregation="median"),
    dict(local_compute_dtype="bfloat16"),
    dict(participation_fraction=0.5),
    dict(failure_mode="corrupt_nan", failure_prob=0.2),
])
def test_constructor_refusals_match_jax(change):
    kw = _config_kw(**change)
    with pytest.raises(ValueError) as want:
        JaxSignSGD(JaxConfig(**kw))
    with pytest.raises(ValueError) as got:
        SignSGD(ExperimentConfig(device="cpu", **kw))
    assert str(got.value) == str(want.value)


def test_lr_schedule_refused_as_in_jax():
    kw = _config_kw(lr_schedule="cosine")
    with pytest.raises(ValueError) as want:
        JaxConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        ExperimentConfig(device="cpu", **kw).validate()
    assert str(got.value) == str(want.value)


def test_post_round_payload_fields_match_jax():
    jmodel = JaxResNet18()
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3))
    )["params"]
    jtree = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   shapes)
    model = get_model("resnet18")
    named = dict(model.named_parameters())
    layout = ParamLayout.from_params(named, jax_leaf_order(model, (32, 32)))
    assert sum(layout.numels) == sum(
        a.size for a in jax.tree_util.tree_leaves(jtree))
    kw = _config_kw(worker_number=100)

    class _Ctx:
        global_params = jtree

    want = JaxSignSGD(JaxConfig(**kw)).post_round(_Ctx())
    got = SignSGD(ExperimentConfig(device="cpu", **kw)).post_round(
        RoundContext(0, None, None, None, {}, {}, None, (), None,
                     layout=layout))
    assert got == want
    assert got["uplink_compression_ratio"] == pytest.approx(32.0, rel=1e-6)


def test_cli_run_on_cpu():
    argv = [
        "--dataset_name", "synthetic", "--model_name", "resnet18",
        "--distributed_algorithm", "sign_SGD", "--worker_number", "3",
        "--round", "2", "--epoch", "1", "--learning_rate", "0.01",
        "--momentum", "0.9", "--batch_size", "8", "--n_train", "48",
        "--n_test", "16", "--client_chunk_size", "2",
        "--model_args", '{"stage_sizes": [1], "width": 8}',
        "--device", "cpu",
    ]
    result = run_simulation(get_config(argv), setup_logging=False)
    assert isinstance(get_algorithm("sign_SGD", get_config(argv)), SignSGD)
    history = result["history"]
    assert len(history) == 2
    for rec in history:
        assert np.isfinite(rec["test_loss"]) and np.isfinite(
            rec["mean_client_loss"])
        assert rec["uplink_compression_ratio"] == pytest.approx(32, rel=1e-2)
    state = result["client_state"]
    assert state["momenta"].shape[0] == 3
    assert state["steps"].tolist() == [4, 4, 4]  # 2 rounds x 2 steps
    with pytest.raises(ValueError, match="requires the SGD optimizer"):
        run_simulation(get_config(argv + ["--optimizer_name", "adam"]),
                       setup_logging=False)
