"""The fleet replayer of tests/test_torch_fleet_replay_cuda.py on the CPU:
it names an op whose bits depend on how many models share its launch, and
an op that takes another layout at the two model counts, and passes one
that does neither; it pairs a fleet's eval of E models with one model's
eval. The training GroupNorm (``training=True``) takes one
layout at 10 and at 40 bf16 models; the eval's, which reads the models on
the channel side while ``M*C`` fits a kernel row, does not."""

import pytest
import torch

from distributed_learning_simulator_tpu_torch.ops import gn_cuda
from test_torch_fleet_replay_cuda import (
    EXACT_FORMS,
    MLP,
    _Step,
    eval_differences,
    replay,
)


@torch.library.custom_op("dls_test::count_scaled", mutates_args=())
def count_scaled(x: torch.Tensor) -> torch.Tensor:
    """``x`` scaled by a factor of its leading size: a stand-in for an op
    whose rounding follows the launch's shape."""
    return x * (1.0 + 1e-3 * x.shape[0])


@count_scaled.register_fake
def _(x):
    return torch.empty_like(x)


def _count_scaled_vmap(info, in_dims, x):
    x = x.movedim(in_dims[0], 0)
    y = count_scaled(x.reshape((-1,) + tuple(x.shape[2:])))
    return y.reshape(x.shape), 0


torch.library.register_vmap("dls_test::count_scaled", _count_scaled_vmap)


def _models(m: int, *shape, dtype=torch.float32):
    """``m`` models' inputs; model k's are the same for every ``m``."""
    gen = torch.Generator().manual_seed(3)
    return torch.randn((40,) + shape, generator=gen)[:m].to(dtype)


@pytest.mark.parametrize("planted", [False, True])
def test_replayer_names_the_op_that_moves(planted):
    def one(x):
        y = (x * 2).sum(dim=-1)
        return count_scaled(y) if planted else y

    fn = torch.func.vmap(one)
    found = replay(fn, (_models(10, 3, 8),), (_models(40, 3, 8),), 4)
    assert found.replayed >= 2 and not found.layouts
    assert [m.split()[0] for m in found.moved] == (
        ["dls_test::count_scaled"] if planted else [])


@pytest.mark.parametrize("training", [False, True])
def test_training_group_norm_keeps_its_layout(training):
    """bf16 ``[B, H, W, M, C]`` as the grouped convolutions leave it, 64
    channels: at 10 models ``M*C`` fits a kernel row and at 40 it does not,
    so the eval's GroupNorm reads the models on the channel side
    at 10 and folds them at 40; the training one folds at both."""
    def args(m):
        x = _models(m, 2, 2, 2, 64, dtype=torch.bfloat16).permute(
            1, 2, 3, 0, 4).contiguous()
        return x, _models(m, 64), _models(m, 64)

    fn = torch.func.vmap(
        lambda x, s, b: gn_cuda.group_norm_op(x, s, b, 32, 1e-6,
                                              torch.bfloat16, training),
        in_dims=(3, 0, 0))
    found = replay(fn, args(10), args(40), 4)
    layouts = [m.split()[0] for m in found.layouts]
    assert layouts == ([] if training else ["dls::group_norm"])


@pytest.mark.parametrize("model,experiments,n", [
    ({"model": "resnet18"}, 2, 4), (MLP, 8, 64)])
def test_replayer_pairs_a_fleet_eval_with_one_models(model, experiments, n):
    """A fleet's server eval of E models against a solo run's eval of its
    one model, ResNet-18 at full width (f32) and the MLP: the fleet
    evaluates each model as the solo run does (one call a model of every
    op), so every op pairs, none moves, and each model's loss and accuracy
    are its solo eval's bits. One vmapped forward of the E models takes
    batched products and sums of its own: the replayer names them as ops
    of another form."""
    kwargs = {k: v for k, v in model.items() if k != "model"}
    step = _Step("float32", torch.device("cpu"), model["model"], **kwargs)
    solo_fn, fleet_fn, vmapped_fn = step.eval_fns()
    models = step.rows(experiments)[0]
    batches = step.eval_batches(n)
    found = replay(fleet_fn, (models[0].clone(),) + batches,
                   (models,) + batches, experiments, solo_fn=solo_fn)
    assert found.replayed > 10
    assert not found.moved and not found.layouts
    assert not found.other_forms(EXACT_FORMS)
    assert not eval_differences(solo_fn, fleet_fn, models, batches)
    vmapped = replay(vmapped_fn, (models[0].clone(),) + batches,
                     (models,) + batches, experiments, solo_fn=solo_fn)
    assert "aten::bmm" in vmapped.other_forms(EXACT_FORMS)
