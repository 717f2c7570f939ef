"""The port's ResNet (models/resnet.py) with parameters transplanted from the
JAX package's ResNet18 through models/bridge.py, for both of the JAX
model's parameter trees: the default W-folded one and the unfolded one.

Tolerances: f32 logits rtol/atol 1e-4 (same math, other op orders); the
gradients' worst per-leaf relative L2 <= 2e-2, the bound
tests/test_folded_resnet.py uses for ReLU-flip noise (a ulp-level forward
difference that lands on a ReLU threshold flips that element's backward
mask).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
from distributed_learning_simulator_tpu_torch.models.resnet import ResNet18


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


def test_init_params_statistics():
    """flax lecun_normal init (truncated, fan-in scaled): parity is only
    statistical, since jax.random and torch draw different numbers."""
    model = get_model("resnet18")
    params = init_params(model, seed=0)
    w = params["blocks.7.conv2.weight"]  # 512 x 512 x 3 x 3
    std = np.sqrt(1.0 / (512 * 9))
    assert abs(float(w.std()) / std - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.equal(params["stem_norm.scale"], torch.ones(64))
    assert torch.equal(params["head.bias"], torch.zeros(10))
    again = init_params(get_model("resnet18"), seed=0)
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_model_args_and_refusals():
    assert ResNet18(fold_stage1=False).stage_sizes == (2, 2, 2, 2)
    assert get_model("resnet34").stage_sizes == (3, 4, 6, 3)
    with pytest.raises(NotImplementedError, match="item 20"):
        ResNet18(gn_custom_backward=False)
    with pytest.raises(NotImplementedError, match="item 18"):
        get_model("lenet5")
    with pytest.raises(ValueError, match="unknown model"):
        get_model("vgg")
