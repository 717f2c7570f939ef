"""The port's local-training engine (parallel/engine.py) against the JAX
package's: the dither hash and bf16 stochastic rounding bit for bit, the
sgd step against optax, and one client's local run with the JAX package's
own batch permutations injected into the port.

Tolerances: exact for the integer and bit math; 1e-6 relative for one
optimizer step (same f32 arithmetic); rtol 1e-4 / atol 1e-5 for a local
run of 8 steps (f32 forward/backward in another op order, compounded over
the steps).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_learning_simulator_tpu.models.resnet import (
    ResNet18 as JaxResNet18,
)
from distributed_learning_simulator_tpu.ops.quantize import (
    hash_mix as jax_hash_mix,
)
from distributed_learning_simulator_tpu.parallel import engine as jengine
from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_leaf_order,
    params_from_jax,
)
from distributed_learning_simulator_tpu_torch.models.registry import (
    ParamLayout,
)
from distributed_learning_simulator_tpu_torch.models.resnet import ResNet18
from distributed_learning_simulator_tpu_torch.ops.quantize import hash_mix
from distributed_learning_simulator_tpu_torch.parallel import engine


def _bits16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_hash_mix_bit_exact():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    for salt in rng.integers(0, 2**32, size=8, dtype=np.uint64):
        want = np.asarray(jax_hash_mix(jnp.asarray(u), jnp.uint32(salt)))
        got = hash_mix(torch.from_numpy(u.astype(np.int64)), int(salt))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_sr_to_bf16_bit_exact():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=8192) * np.exp2(rng.integers(-30, 30, size=8192))
         ).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.0, -3.0]
    for salt in rng.integers(0, 2**32, size=6, dtype=np.uint64):
        want, want_salt = jengine._sr_to_bf16(jnp.asarray(x), jnp.uint32(salt))
        got, got_salt = engine._sr_to_bf16(torch.from_numpy(x), int(salt))
        np.testing.assert_array_equal(
            _bits16(got), np.asarray(want).view(np.uint16)
        )
        assert got_salt == int(want_salt)


@pytest.mark.parametrize("fold", [True, False])
def test_flat_rounder_equals_jax_tree_rounding(fold):
    """SR of a transplanted parameter tree is bit-exact when the salts
    thread through the JAX tree's leaf order (folded or unfolded)."""
    jmodel = JaxResNet18(stage_sizes=(1, 1), width=64, fold_stage1=fold)
    jparams = flax.core.unfreeze(jmodel.init(
        jax.random.key(1), jnp.zeros((1, 16, 16, 3), jnp.float32)
    )["params"])
    rng = np.random.default_rng(2)
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        jparams,
    )
    salt = 0xDEADBEEF
    want, want_salt = jengine._sr_tree_to_bf16(jparams, jnp.uint32(salt))
    want = params_from_jax(jax.device_get(want))  # bf16 -> f32 is exact

    model = ResNet18(stage_sizes=(1, 1), width=64, fold_stage1=fold)
    params = params_from_jax(jparams)
    layout = ParamLayout.from_params(params, jax_leaf_order(model, (16, 16)))
    rounder = engine.FlatRounder(layout, "cpu")
    got, got_salt = rounder(layout.flatten(params), salt)
    assert got_salt == int(want_salt)
    for name, leaf in layout.unflatten(got).items():
        assert torch.equal(leaf.float(), want[name]), name
    # The leaf-by-leaf loop in the same order gives the same bits.
    leaves, loop_salt = engine._sr_tree_to_bf16(
        [params[n] for n in layout.names], salt
    )
    assert loop_salt == got_salt
    assert torch.equal(torch.cat([v.reshape(-1) for v in leaves]), got)


def test_sgd_momentum_weight_decay_matches_optax():
    rng = np.random.default_rng(3)
    p = rng.normal(size=257).astype(np.float32)
    grads = [rng.normal(size=257).astype(np.float32) for _ in range(3)]
    tx = jengine.make_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    opt = engine.make_optimizer("SGD", 0.05, momentum=0.9, weight_decay=1e-3)
    jp, js = jnp.asarray(p), tx.init(jnp.asarray(p))
    tp = torch.from_numpy(p.copy())
    ts = opt.init(tp)
    for g in grads:
        ju, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = opt.update(torch.from_numpy(g), ts, tp)
        tp = tp + tu
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(NotImplementedError, match="item 19"):
        engine.make_optimizer("adam", 0.1)


def test_local_train_matches_jax_with_injected_permutations():
    """One client's local run at f32: E=2 epochs x 4 steps, momentum and
    weight decay, compact uint8 storage with padded (masked) slots, the
    batch orders taken from the JAX key chain and handed to the port."""
    rng = np.random.default_rng(4)
    shard, batch, epochs, hw = 16, 4, 2, 8
    xs = rng.integers(0, 256, size=(shard, hw * hw * 3)).astype(np.uint8)
    ys = rng.integers(0, 10, size=shard).astype(np.int32)
    mask = np.ones(shard, np.float32)
    mask[11:] = 0.0
    sample_shape = (hw, hw, 3)

    jmodel = JaxResNet18(stage_sizes=(1, 1), width=16, dtype=jnp.float32)
    jparams = flax.core.unfreeze(jmodel.init(
        jax.random.key(5), jnp.zeros((1,) + sample_shape, jnp.float32)
    )["params"])
    tx = jengine.make_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3)
    jtrain = jengine.make_local_train_fn(
        jmodel.apply, tx, epochs, batch,
        preprocess=jengine.make_decoder(sample_shape),
    )
    key = jax.random.key(6)
    j_out, _, j_metrics = jax.jit(jtrain)(
        jparams, None, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(mask),
        key,
    )
    perms = [
        torch.from_numpy(np.asarray(jax.random.permutation(k, shard)))
        for k in jax.random.split(key, epochs)
    ]

    model = ResNet18(stage_sizes=(1, 1), width=16, dtype=torch.float32)
    params = params_from_jax(jparams)
    layout = ParamLayout.from_params(params, jax_leaf_order(model, (hw, hw)))

    def apply_fn(views, x):
        return torch.func.functional_call(model, views, (x,))

    local_train = engine.make_local_train_fn(
        apply_fn, engine.make_optimizer("sgd", 0.05, 0.9, 1e-3), layout,
        epochs, batch, preprocess=engine.make_decoder(sample_shape),
    )
    out, metrics = local_train(
        layout.flatten(params), torch.from_numpy(xs),
        torch.from_numpy(ys.astype(np.int64)), torch.from_numpy(mask),
        perms, sr_salt=0,
    )
    want = params_from_jax(jax.device_get(j_out))
    for name, leaf in layout.unflatten(out).items():
        np.testing.assert_allclose(
            leaf.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
            err_msg=name,
        )
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-4)
    assert float(metrics["accuracy"]) == float(j_metrics["accuracy"])


def test_pad_eval_set_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.random((37, 4, 4, 3), dtype=np.float32)
    y = rng.integers(0, 10, size=37).astype(np.int32)
    for flatten in (False, True):
        for got, want in zip(engine.pad_eval_set(x, y, 16, flatten),
                             jengine.pad_eval_set(x, y, 16, flatten)):
            np.testing.assert_array_equal(got, want)
