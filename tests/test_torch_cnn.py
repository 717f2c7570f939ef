"""The port's plain models (models/cnn.py, models/lenet.py: ``MLP``,
``LeNet5``, ``CifarCNN``, ``TpuCifarCNN``) against the JAX package's flax
modules, with the JAX init transplanted through models/bridge.py; and the
registry's eight names.

Tolerances:

* f32 models (``MLP``, ``LeNet5``, and both CNNs with ``model_args
  {"dtype": "float32"}``): logits and every gradient at rtol 1e-4, atol
  1e-4 of the leaf's largest magnitude (same math, other op orders).
* bf16 CNNs (the default ``dtype``): logits within rtol/atol 2**-7 (one
  bf16 ulp; the bf16 activations round identically almost everywhere);
  kernel and dense gradients within a relative L2 of 2**-6 (each bf16
  convolution's backward rounds its f32 accumulation to bf16 once, and
  the two libraries accumulate in other orders). A bf16 conv bias's
  gradient is the sum of the output's bf16 cotangent: XLA on the CPU adds
  it up in bf16, one rounding per term, while PyTorch accumulates in f32.
  So the bias gradients are held, at the same 2**-6, against the f32 sum
  of the JAX package's own cotangent, taken from the flax conv outputs
  with ``nn.intercept_methods``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu.models import registry as jregistry
from distributed_learning_simulator_tpu_torch.models import registry
from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_leaf_order,
    jax_paths,
    params_from_jax,
    plain_jax_path,
    plain_torch_name,
    to_jax_layout,
)

SHAPES = {"mlp": (8, 8, 1), "lenet5": (28, 28, 1), "cnn": (32, 32, 3),
          "cnn_tpu": (32, 32, 3)}


def _batch(shape, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n,) + shape, dtype=np.float32),
            rng.integers(0, 10, size=n))


def _conv_cotangents(jmodel, params, x, y):
    """JAX logits, parameter gradients and the cotangent of each flax
    ``Conv`` output (a zero added to every conv output, differentiated)."""
    shapes = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Conv):
            shapes[context.module.name] = (out.shape, out.dtype)
        return out

    with fnn.intercept_methods(record):
        jmodel.apply({"params": params}, jnp.asarray(x))

    def loss(p, deltas):
        def add(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Conv):
                out = out + deltas[context.module.name]
            return out

        with fnn.intercept_methods(add):
            logits = jmodel.apply({"params": p}, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1)), logits

    zeros = {k: jnp.zeros(s, dt) for k, (s, dt) in shapes.items()}
    (_, logits), (grads, cots) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, zeros)
    return np.asarray(logits), params_from_jax(jax.device_get(grads)), cots


def _port_run(name, shape, args, jparams, x, y):
    model = registry.get_model(name, input_shape=shape, **args)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    logits = model(torch.from_numpy(x))
    F.cross_entropy(logits, torch.from_numpy(y)).backward()
    return model, logits.detach().numpy()


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("name,args", [
    ("mlp", {}), ("mlp", {"hidden": 32}), ("lenet5", {}),
    ("cnn", {"dtype": "float32"}), ("cnn_tpu", {"dtype": "float32"}),
    ("cnn_tpu", {"dtype": "float32", "width": 64}),
])
def test_f32_models_match_jax(name, args):
    shape = SHAPES[name]
    x, y = _batch(shape)
    jmodel = jregistry.get_model(name, **args)
    jparams = jregistry.init_params(jmodel, x[:1], seed=1)
    j_logits, j_grads, _ = _conv_cotangents(jmodel, jparams, x, y)
    model, logits = _port_run(name, shape, args, jparams, x, y)
    np.testing.assert_allclose(logits, j_logits, rtol=1e-4,
                               atol=1e-4 * np.abs(j_logits).max())
    for n, p in model.named_parameters():
        want = j_grads[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=n)


@pytest.mark.parametrize("name,args", [
    ("cnn", {}), ("cnn_tpu", {}), ("cnn_tpu", {"width": 64}),
])
def test_bf16_cnns_match_jax(name, args):
    shape = SHAPES[name]
    x, y = _batch(shape, seed=2)
    jmodel = jregistry.get_model(name, **args)
    jparams = jregistry.init_params(jmodel, x[:1], seed=0)
    j_logits, j_grads, cots = _conv_cotangents(jmodel, jparams, x, y)
    model, logits = _port_run(name, shape, args, jparams, x, y)
    tol = 2.0**-7
    np.testing.assert_allclose(logits, j_logits, rtol=tol,
                               atol=tol * np.abs(j_logits).max())
    for n, p in model.named_parameters():
        got = p.grad.numpy()
        if n.startswith("conv") and n.endswith(".bias"):
            flax_name = plain_jax_path(n)[0]
            cot = np.asarray(cots[flax_name]).astype(np.float32)
            want = cot.sum(axis=(0, 1, 2))
        else:
            want = j_grads[n].numpy()
        assert _rel_l2(got, want) <= 2.0**-6, (n, _rel_l2(got, want))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_leaf_order_and_names_are_the_jax_trees(name):
    """jax_leaf_order is the JAX tree's tree_flatten order (Conv_i before
    Dense_i, bias before kernel), and the name mapping round-trips."""
    shape = SHAPES[name]
    jparams = jregistry.init_params(jregistry.get_model(name),
                                    np.zeros((1,) + shape, np.float32))
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    model = registry.get_model(name, input_shape=shape)
    assert jax_leaf_order(model, shape[:2]) == [plain_torch_name(p)
                                                for p in paths]
    assert sorted(jax_paths(model, shape[:2]).values()) == sorted(paths)
    assert all(plain_jax_path(plain_torch_name(p)) == p for p in paths)
    for n, p in model.named_parameters():
        leaf = jparams
        for k in plain_jax_path(n):
            leaf = leaf[k]
        assert to_jax_layout(np.empty(p.shape)).shape == leaf.shape, n


def test_registry_builds_every_jax_name():
    """The eight JAX registry names, with the JAX normalization (case, '-'
    and '_' dropped), build models whose parameter counts equal the JAX
    trees'."""
    assert registry.registered_models() == jregistry.registered_models()
    for name in ("LeNet5", "cnn", "CifarCNN", "cnn_tpu", "tpu-cnn",
                 "resnet18", "ResNet34", "MLP"):
        shape = (28, 28, 1) if name == "LeNet5" else (32, 32, 3)
        model = registry.get_model(name, input_shape=shape)
        jmodel = jregistry.get_model(name)
        jparams = jax.eval_shape(
            jmodel.init, jax.random.key(0),
            jax.ShapeDtypeStruct((1,) + shape, jnp.float32))["params"]
        assert sum(p.numel() for p in model.parameters()) == sum(
            a.size for a in jax.tree_util.tree_leaves(jparams)), name
    with pytest.raises(ValueError, match="unknown model"):
        registry.get_model("vgg")
