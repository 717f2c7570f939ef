"""fed_quant in the port (ops/quantize.py, ops/payload.py,
algorithms/fed_quant.py, FedAvg's client_eval) against the JAX package:
stochastic quantization and fake-quant bit for bit given the same salts,
the straight-through gradient, the payload accounting on a ResNet-18
layout, the client_eval auto rule, and one round of the JAX ``FedQuant``
program with its permutations and per-(client, leaf) quantization salts
injected into the port.

Round tolerances: each client's trained params (QAT in f32) rtol 1e-4 /
atol 1e-5, as test_torch_fedavg.py; the payload hooks bit-exact on the same
inputs and salts. The final model is quantized twice (upload and
broadcast) with a dither hashed from the value's bits, so a ulp-level
difference in a quantizer's input redraws that element's dither: the final
params agree within one level of the broadcast plus one weighted level of
the uploads, and on average to a fraction of a level.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.algorithms.base import (
    RoundContext as JaxRoundContext,
)
from distributed_learning_simulator_tpu.algorithms.fed_quant import (
    FedQuant as JaxFedQuant,
)
from distributed_learning_simulator_tpu.algorithms.fedavg import (
    round_key_splits,
)
from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.models.resnet import (
    ResNet18 as JaxResNet18,
)
from distributed_learning_simulator_tpu.ops import quantize as jq
from distributed_learning_simulator_tpu.parallel import engine as jengine
from distributed_learning_simulator_tpu_torch.algorithms.base import (
    RoundContext,
)
from distributed_learning_simulator_tpu_torch.algorithms.fed_quant import (
    FedQuant,
)
from distributed_learning_simulator_tpu_torch.algorithms.fedavg import FedAvg
from distributed_learning_simulator_tpu_torch.config import (
    ExperimentConfig,
    get_config,
)
from distributed_learning_simulator_tpu_torch.data.registry import get_dataset
from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_leaf_order,
    params_from_jax,
)
from distributed_learning_simulator_tpu_torch.models.registry import (
    ParamLayout,
    get_model,
)
from distributed_learning_simulator_tpu_torch.models.resnet import ResNet18
from distributed_learning_simulator_tpu_torch.ops import payload
from distributed_learning_simulator_tpu_torch.ops.quantize import (
    Segments,
    dequantize,
    fake_quant,
    stochastic_quantize,
)
from distributed_learning_simulator_tpu_torch.parallel import engine
from distributed_learning_simulator_tpu_torch.simulator import (
    build_client_data,
    run_simulation,
)

HW = 8
LEVELS = 256


def _salt(key) -> int:
    return int(jq._salt_from_key(key))


def _tree(rng):
    return {
        "a": (rng.standard_normal((5, 4)) * 0.3).astype(np.float32),
        "b": np.full((7,), 0.25, np.float32),  # zero span: scale 1
        "c": (rng.standard_normal((2, 3, 2)) + 2.0).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stochastic_quantize_bit_exact(dtype):
    rng = np.random.default_rng(0)
    key = jax.random.key(11)
    x = jnp.asarray(rng.standard_normal((7, 33)) * 0.3, getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    # As compiled in the round program (jit), which the port reproduces.
    want = jax.jit(jq.stochastic_quantize, static_argnums=1)(x, LEVELS, key)
    got = stochastic_quantize(xt, LEVELS, [_salt(key)])
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert got.scale.item() == float(want.scale)
    assert got.zero_point.item() == float(want.zero_point)
    np.testing.assert_array_equal(dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(want)))

    # A tree: per-leaf ranges and per-leaf salts on one flat vector.
    tree = {k: jnp.asarray(v, getattr(jnp, dtype))
            for k, v in _tree(rng).items()}
    leaves = jax.tree_util.tree_leaves(tree)
    want = jax.jit(lambda t: jq.dequantize_tree(
        jq.stochastic_quantize_tree(t, LEVELS, key)))(tree)
    salts = [_salt(k) for k in jax.random.split(key, len(leaves))]
    flat = torch.cat([
        torch.from_numpy(np.array(leaf.astype(jnp.float32))).reshape(-1)
        for leaf in leaves
    ]).to(getattr(torch, dtype))
    seg = Segments([leaf.size for leaf in leaves])
    got = dequantize(stochastic_quantize(flat, LEVELS, salts, seg), seg)
    np.testing.assert_array_equal(
        got.numpy(),
        np.concatenate([np.asarray(v).reshape(-1)
                        for v in jax.tree_util.tree_leaves(want)]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_bit_exact_with_identity_gradient(dtype):
    rng = np.random.default_rng(1)
    tree = {k: jnp.asarray(v, getattr(jnp, dtype))
            for k, v in _tree(rng).items()}
    leaves = jax.tree_util.tree_leaves(tree)
    jit_fq = jax.jit(lambda t: jq.fake_quant_tree(t, 16))
    want = np.concatenate([
        np.asarray(leaf.astype(jnp.float32)).reshape(-1)
        for leaf in jax.tree_util.tree_leaves(jit_fq(tree))
    ])
    flat = torch.cat([
        torch.from_numpy(np.array(leaf.astype(jnp.float32))).reshape(-1)
        for leaf in leaves
    ]).to(getattr(torch, dtype)).requires_grad_(True)
    seg = Segments([leaf.size for leaf in leaves])
    out = fake_quant(flat, 16, seg)
    assert out.dtype == flat.dtype
    np.testing.assert_array_equal(out.detach().float().numpy(), want)
    w = torch.arange(flat.numel(), dtype=flat.dtype)
    (out * w).sum().backward()
    assert torch.equal(flat.grad, w)


def _resnet18_layout():
    model = get_model("resnet18")
    named = dict(model.named_parameters())
    return ParamLayout.from_params(named, jax_leaf_order(model, (32, 32)))


def test_payload_bytes_match_jax_on_resnet18():
    from distributed_learning_simulator_tpu.ops import payload as jpayload

    shapes = jax.eval_shape(
        JaxResNet18().init, jax.random.key(0), jnp.zeros((1, 32, 32, 3))
    )["params"]
    jtree = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   shapes)
    layout = _resnet18_layout()
    assert payload.payload_bytes(layout) == jpayload.payload_bytes(jtree)
    for levels in (2, 16, 256):
        assert payload.quantized_payload_bytes(layout, levels) == (
            jpayload.quantized_payload_bytes(jtree, levels))
    assert payload.sign_payload_bytes(layout) == (
        jpayload.sign_payload_bytes(jtree))
    kw = dict(distributed_algorithm="fed_quant", worker_number=100)

    class _Ctx:
        global_params = jtree

    want = JaxFedQuant(JaxConfig(**kw)).post_round(_Ctx())
    got = FedQuant(ExperimentConfig(device="cpu", **kw)).post_round(
        RoundContext(0, None, None, None, {}, {}, None, (), None,
                     layout=layout))
    assert got == want
    assert got["uplink_compression_ratio"] == pytest.approx(4.0, rel=1e-4)


@pytest.mark.parametrize("algo,workers,client_eval,want", [
    ("fed_quant", 32, None, True),
    ("fed_quant", 33, None, False),
    ("fed", 4, None, False),
    ("fed", 4, True, True),
    ("fed_quant", 4, False, False),
])
def test_client_eval_auto_rule_matches_jax(algo, workers, client_eval, want):
    kw = dict(distributed_algorithm=algo, worker_number=workers,
              client_eval=client_eval)
    cls, jcls = (FedQuant, JaxFedQuant) if algo == "fed_quant" else (
        FedAvg, None)
    got = cls(ExperimentConfig(device="cpu", **kw))._client_eval_enabled
    assert got == want
    if jcls is not None:
        assert jcls(JaxConfig(**kw))._client_eval_enabled == want


def _round_setup():
    kw = dict(
        dataset_name="synthetic", model_name="resnet18",
        distributed_algorithm="fed_quant", worker_number=4, seed=5, epoch=1,
        batch_size=4, learning_rate=0.05, momentum=0.9, weight_decay=1e-3,
        partition="dirichlet", dirichlet_alpha=0.5, max_shard_size=8,
        client_chunk_size=2, quant_levels=LEVELS,
    )
    ds = get_dataset("synthetic", n_train=32, n_test=16, seed=5,
                     shape=(HW, HW, 3))
    cfg = ExperimentConfig(device="cpu", **kw)
    return cfg, JaxConfig(**kw), ds, build_client_data(cfg, ds)


def test_round_matches_jax():
    cfg, jcfg, ds, cd = _round_setup()
    n = cd.n_clients
    sample_shape = cd.sample_shape
    jmodel = JaxResNet18(stage_sizes=(1,), width=8, dtype=jnp.float32)
    jparams = flax.core.unfreeze(jmodel.init(
        jax.random.key(1), jnp.zeros((1,) + sample_shape, jnp.float32)
    )["params"])
    tx = jengine.make_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    jalgo = JaxFedQuant(jcfg)
    assert jalgo._client_eval_enabled  # auto-on at 4 <= 32 clients
    jeval = jengine.make_eval_fn(jmodel.apply)
    jalgo.prepare(jmodel.apply, jeval)
    jround = jalgo.make_round_fn(
        jmodel.apply, tx, n, preprocess=jengine.make_decoder(sample_shape),
        client_sizes=cd.sizes,
    )
    round_key = jax.random.key(2)
    j_new, _, j_aux = jax.jit(jround)(
        jparams, None, jnp.asarray(cd.x), jnp.asarray(cd.y),
        jnp.asarray(cd.mask), jnp.asarray(cd.sizes), round_key,
    )

    # The JAX key chain: training keys per client, uplink salts per
    # (client, leaf), broadcast salts per leaf.
    _, train_key, payload_key, agg_key, _ = round_key_splits(round_key, False)
    client_keys = jax.random.split(train_key, n)
    n_leaves = len(jax.tree_util.tree_leaves(jparams))

    def client_rng(i, n_slots):
        perms = [
            torch.from_numpy(np.asarray(jax.random.permutation(k, n_slots)))
            for k in jax.random.split(client_keys[i], cfg.epoch)
        ]
        return perms, 0

    def leaf_salts(key):
        return [_salt(k) for k in jax.random.split(key, n_leaves)]

    up_keys = jax.random.split(payload_key, n)
    salts = {i: leaf_salts(up_keys[i]) for i in range(n)}
    salts[None] = leaf_salts(agg_key)

    model = ResNet18(stage_sizes=(1,), width=8, dtype=torch.float32)
    params = params_from_jax(jparams)
    layout = ParamLayout.from_params(params, jax_leaf_order(model, (HW, HW)))

    def apply_fn(views, x):
        return torch.func.functional_call(model, views, (x,))

    algo = FedQuant(cfg)
    xb, yb, mb = engine.pad_eval_set(ds.x_test, ds.y_test, cfg.eval_batch_size)
    eval_batches = (torch.from_numpy(xb), torch.from_numpy(yb.astype(np.int64)),
                    torch.from_numpy(mb))
    evaluate = engine.make_eval_fn(apply_fn)
    algo.prepare(apply_fn, evaluate, eval_batches)
    round_fn = algo.make_round_fn(
        apply_fn, engine.make_optimizer("sgd", 0.05, 0.9, 1e-3), layout, n,
        preprocess=engine.make_decoder(sample_shape), client_sizes=cd.sizes,
        device="cpu",
    )
    raw = {}
    upload = algo.process_client_payload

    def recording_upload(params, client_salts):
        i = next(k for k, v in salts.items() if v is client_salts)
        raw[i] = params.clone()
        return upload(params, client_salts)

    algo.process_client_payload = recording_upload
    flat = layout.flatten(params)
    new, _, aux = round_fn(
        flat, None, torch.from_numpy(cd.x),
        torch.from_numpy(cd.y.astype(np.int64)), torch.from_numpy(cd.mask),
        cd.sizes, np.asarray(jax.random.key_data(round_key)),
        client_rng=client_rng,
        payload_salts=salts.__getitem__,
    )
    algo.process_client_payload = upload
    assert sorted(raw) == list(range(n))  # client_eval: every client trains

    # 1. QAT training: each client's raw params at f32 tolerance.
    j_raw = j_aux["client_params_raw"]
    j_raw_flat = {}
    for i in range(n):
        tree = jax.tree_util.tree_map(lambda a: a[i], j_raw)
        j_raw_flat[i] = layout.flatten(params_from_jax(jax.device_get(tree)))
        np.testing.assert_allclose(raw[i].numpy(), j_raw_flat[i].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=f"client {i}")
    np.testing.assert_allclose(aux["client_loss"].numpy(),
                               np.asarray(j_aux["client_loss"]), rtol=1e-4)

    # 2. The payload hooks bit-exact on the same inputs and salts (against
    # the JAX hooks compiled, as they run in the round program).
    j_up = jax.jit(jalgo.process_client_payload)(j_raw, payload_key)[0]
    for i in range(n):
        got, _ = algo.process_client_payload(j_raw_flat[i], salts[i])
        tree = jax.tree_util.tree_map(lambda a: a[i], j_up)
        assert torch.equal(
            got, layout.flatten(params_from_jax(jax.device_get(tree))))
    got, _ = algo.process_aggregated(flat, salts[None])
    want, _ = jax.jit(jalgo.process_aggregated)(jparams, agg_key)
    assert torch.equal(got, layout.flatten(params_from_jax(
        jax.device_get(want))))

    # 3. The final model: within one broadcast level plus one weighted
    # upload level per leaf, and a fraction of a level on average.
    want = layout.flatten(params_from_jax(jax.device_get(j_new)))
    w = np.asarray(cd.sizes, np.float64) / np.sum(cd.sizes)
    seg = Segments(layout.numels)
    q_down = stochastic_quantize(want, LEVELS, salts[None], seg)
    up_scale = sum(
        w[i] * stochastic_quantize(raw[i], LEVELS, salts[i], seg).scale
        for i in range(n)
    )
    bound = seg.spread(q_down.scale + up_scale.float()) * 1.001
    diff = (new - want).abs()
    assert (diff <= bound).all()
    assert (diff / seg.spread(q_down.scale)).mean().item() < 0.5

    # 4. The client_eval record equals the JAX package's.
    j_metrics = {k: float(v) for k, v in
                 jeval(j_new, *map(jnp.asarray, (xb, yb, mb))).items()}
    jctx = JaxRoundContext(0, j_new, jparams, cd.sizes, j_aux, j_metrics,
                           None, tuple(map(jnp.asarray, (xb, yb, mb))), None)
    ctx = RoundContext(0, new, flat, cd.sizes, aux, j_metrics, None,
                       eval_batches, None, layout=layout)
    want_rec = jalgo.post_round(jctx)
    got_rec = algo.post_round(ctx)
    assert set(got_rec) == set(want_rec)
    for k in ("uplink_compression_ratio", "downlink_compression_ratio",
              "payload_bytes_raw", "payload_bytes_quantized"):
        assert got_rec[k] == want_rec[k]
    assert got_rec["client_eval"] == want_rec["client_eval"]


def test_cli_run_on_cpu():
    argv = [
        "--dataset_name", "synthetic", "--model_name", "resnet18",
        "--distributed_algorithm", "fed_quant", "--worker_number", "3",
        "--round", "2", "--epoch", "1", "--learning_rate", "0.05",
        "--momentum", "0.9", "--batch_size", "8", "--n_train", "48",
        "--n_test", "16", "--client_chunk_size", "2",
        "--local_compute_dtype", "bfloat16", "--quant_levels", "256",
        "--model_args", '{"stage_sizes": [1], "width": 8}',
        "--device", "cpu",
    ]
    history = run_simulation(get_config(argv), setup_logging=False)["history"]
    assert len(history) == 2
    for rec in history:
        assert np.isfinite(rec["test_loss"])
        # 8 metadata bytes per tensor weigh on a model this small.
        assert rec["uplink_compression_ratio"] == pytest.approx(4, rel=0.1)
        assert set(rec["client_eval"]) == {
            "pre_agg_accuracy_mean", "pre_agg_accuracy_min",
            "pre_agg_accuracy_max", "post_agg_accuracy"}
