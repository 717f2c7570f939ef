"""The port's ResNet (models/resnet.py) with parameters transplanted from the
JAX package's ResNet18 through models/bridge.py, for both of the JAX
model's parameter trees: the default W-folded one and the unfolded one.

Tolerances: f32 logits rtol/atol 1e-4 (same math, other op orders); the
gradients' worst per-leaf relative L2 <= 2e-2, the bound
tests/test_folded_resnet.py uses for ReLU-flip noise (a ulp-level forward
difference that lands on a ReLU threshold flips that element's backward
mask). The initial parameters (models/flax_init.py) are bitwise equal to
the JAX package's draws for ResNet-18 and each plain model.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu.models.registry import (
    get_model as jax_get_model,
    init_params as jax_init_params,
)
from distributed_learning_simulator_tpu.models.resnet import (
    ResNet18 as JaxResNet18,
)
from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_leaf_order,
    jax_path,
    n_folded_blocks,
    params_from_jax,
    torch_name,
)
from distributed_learning_simulator_tpu_torch.models.registry import (
    get_model,
    init_params,
)
from distributed_learning_simulator_tpu_torch.models.resnet import (
    PlainGroupNorm,
    ResNet18,
)
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    no_vmap_fallback,
)


def _jax_setup(fold, stage_sizes=(1, 1), width=64, hw=16):
    rng = np.random.default_rng(0)
    x = rng.random((4, hw, hw, 3), dtype=np.float32)
    y = rng.integers(0, 10, size=4)
    model = JaxResNet18(stage_sizes=stage_sizes, width=width,
                        dtype=jnp.float32, fold_stage1=fold)
    params = flax.core.unfreeze(
        model.init(jax.random.key(0), jnp.asarray(x[:1]))["params"]
    )
    return model, params, x, y


def _jax_paths(tree):
    return [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]
    ]


@pytest.mark.parametrize("fold", [True, False])
def test_transplanted_resnet_matches_jax(fold):
    jmodel, jparams, x, y = _jax_setup(fold)
    assert (n_folded_blocks(jparams) > 0) == fold

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)), logits

    (_, j_logits), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jparams
    )

    model = ResNet18(stage_sizes=(1, 1), width=64, dtype=torch.float32)
    state = params_from_jax(jparams)
    model.load_state_dict(state)
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(jparams)
    )
    logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(
        logits.detach().numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-4
    )
    F.cross_entropy(logits, torch.from_numpy(y)).backward()
    want = params_from_jax(jax.device_get(j_grads))
    worst = ("", 0.0)
    for name, p in model.named_parameters():
        a, b = p.grad.numpy(), want[name].numpy()
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        if rel > worst[1]:
            worst = (name, float(rel))
    assert worst[1] <= 2e-2, worst


@pytest.mark.parametrize(
    "fold,stage_sizes,width,hw",
    [(True, (1, 1), 64, 16), (False, (1, 1), 64, 16),
     (True, (2, 2), 64, 8), (False, (3, 4, 6, 3), 8, 8)],
)
def test_bridge_leaf_order_is_jax_tree_order(fold, stage_sizes, width, hw):
    """jax_leaf_order lists the port's parameters in the JAX tree's
    tree_flatten order (ResNet-34's 16 blocks sort ResidualBlock_10 before
    ResidualBlock_2), and the path mapping round-trips."""
    _, jparams, _, _ = _jax_setup(fold, stage_sizes, width, hw)
    model = ResNet18(stage_sizes=stage_sizes, width=width, fold_stage1=fold)
    n_folded = n_folded_blocks(jparams)
    paths = _jax_paths(jparams)
    assert jax_leaf_order(model, (hw, hw)) == [
        torch_name(p, n_folded) for p in paths
    ]
    assert [jax_path(torch_name(p, n_folded), n_folded) for p in paths] == paths
    assert set(params_from_jax(jparams)) == {
        n for n, _ in model.named_parameters()
    }


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,shape,args", [
    ("resnet18", (32, 32, 3), {}),
    ("resnet18", (32, 32, 3), {"fold_stage1": False}),
    ("mlp", (8, 8, 1), {}),
    ("lenet5", (28, 28, 1), {}),
    ("cnn", (32, 32, 3), {}),
    ("cnn_tpu", (32, 32, 3), {}),
])
def test_init_params_equal_jax_draws(name, shape, args, seed):
    """init_params replays flax's init (models/flax_init.py): every value
    of ResNet-18's folded and unfolded trees and of each plain model is
    BITWISE equal to ``jax.device_get(init_params(...))`` of the JAX
    package (ops/prng.py repeats XLA's f32 erf_inv operation by
    operation), for seeds 0 and 1."""
    jmodel = jax_get_model(name, **args)
    want = params_from_jax(jax.device_get(jax_init_params(
        jmodel, np.zeros((1,) + shape, np.float32), seed=seed)))
    got = init_params(get_model(name, input_shape=shape, **args), shape[:2],
                      seed=seed)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, want[k]), k


def test_model_args_and_refusals():
    assert ResNet18(fold_stage1=False).stage_sizes == (2, 2, 2, 2)
    assert get_model("resnet34").stage_sizes == (3, 4, 6, 3)
    autodiff = ResNet18(gn_custom_backward=False)
    assert not autodiff.stem_norm.custom_backward
    assert not any(m.custom_backward for m in autodiff.modules()
                   if isinstance(m, PlainGroupNorm))
    lenet = get_model("lenet5", input_shape=(28, 28, 1))
    assert lenet(torch.zeros(2, 28, 28, 1)).shape == (2, 10)
    with pytest.raises(ValueError, match="unknown model"):
        get_model("vgg")


def _grads_by_leaf(model, x, y):
    model.zero_grad()
    F.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _worst_rel(got, want):
    return max(
        float(torch.linalg.norm(got[n] - want[n])
              / max(float(torch.linalg.norm(want[n])), 1e-12))
        for n in want)


def test_gn_autodiff_backward_matches_jax_and_custom():
    """``gn_custom_backward=False``: the port's gradients (autodiff of the
    plain GroupNorm forward) against the JAX model's at the same flag, and
    against the port's closed-form backward; f32, per-leaf relative L2
    <= 1e-4. Also a vmapped gradient over two models with functorch's
    per-example fallback off, against the two one-model gradients."""
    rng = np.random.default_rng(1)
    x = rng.random((4, 8, 8, 3), dtype=np.float32)
    y = rng.integers(0, 10, size=4)
    jmodel = JaxResNet18(stage_sizes=(1, 1), width=8, dtype=jnp.float32,
                         fold_stage1=False, gn_custom_backward=False)
    jparams = flax.core.unfreeze(
        jmodel.init(jax.random.key(0), jnp.asarray(x[:1]))["params"])

    def loss(p):
        logp = jax.nn.log_softmax(jmodel.apply({"params": p}, jnp.asarray(x)))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    want = params_from_jax(jax.device_get(jax.jit(jax.grad(loss))(jparams)))
    state = params_from_jax(jparams)
    models = {}
    for custom in (False, True):
        models[custom] = ResNet18(stage_sizes=(1, 1), width=8,
                                  dtype=torch.float32,
                                  gn_custom_backward=custom)
        models[custom].load_state_dict(state)
    autodiff = _grads_by_leaf(models[False], x, y)
    assert _worst_rel(autodiff, want) <= 1e-4
    assert _worst_rel(autodiff, _grads_by_leaf(models[True], x, y)) <= 1e-4

    model = models[False]
    names = [n for n, _ in model.named_parameters()]
    second = {n: v * 1.01 for n, v in state.items()}
    stacked = {n: torch.stack([state[n], second[n]]) for n in names}

    def one_loss(p, xb, yb):
        out = torch.func.functional_call(model, p, (xb,))
        return F.cross_entropy(out, yb)

    xb = torch.from_numpy(x)
    yb = torch.from_numpy(y)
    with no_vmap_fallback():
        batched = torch.func.vmap(torch.func.grad(one_loss),
                                  in_dims=(0, None, None))(stacked, xb, yb)
    for m, p in enumerate((state, second)):
        single = torch.func.grad(one_loss)(p, xb, yb)
        assert _worst_rel({n: batched[n][m] for n in names}, single) <= 1e-5
