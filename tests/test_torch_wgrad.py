"""The stage-1 weight gradient (ops/wgrad_cuda.py) on the CPU, where the
wrapper takes its plain version, against the JAX package's Pallas prototype
(scripts/exp_pallas_wgrad.py ``pallas_wgrad`` in TPU interpret mode) and
against torch autograd's convolution weight gradient; and the ResNet's
``_Conv3x3Fn`` backward against autograd through a plain convolution.

Tolerances: vs the Pallas kernel, max|diff| <= 2e-5 * max|dW| (both sum
bf16 products in f32, in other orders over 25600 rows); vs autograd in f32,
rtol 1e-5 (same math, other summation order).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu_torch.models.resnet import (
    ResNet18,
    SameConv2d,
)
from distributed_learning_simulator_tpu_torch.ops import wgrad_cuda
from distributed_learning_simulator_tpu_torch.ops.wgrad_cuda import (
    conv3x3_wgrad,
    conv3x3_wgrad_plain,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_prototype():
    path = os.path.join(_REPO, "scripts", "exp_pallas_wgrad.py")
    spec = importlib.util.spec_from_file_location("exp_pallas_wgrad", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plain_matches_pallas_prototype():
    proto = _load_prototype()
    b, h, w, c = proto.B, proto.H, 2 * proto.WF, proto.C
    assert (b, h, w, c) == (25, 32, 32, 64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    gj = jnp.asarray(g, jnp.bfloat16)
    # The prototype's folded layout is a plain reshape of NHWC: folded
    # column J, block t holds unfolded column 2J + t.
    want = np.asarray(proto.pallas_wgrad(
        xj.reshape(1, b, h, w // 2, 2 * c), gj.reshape(1, b, h, w // 2, 2 * c),
        interpret=True,
    ))[0]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).bfloat16()
    got = conv3x3_wgrad(xt, gt)
    assert got.dtype == torch.float32 and got.shape == (3, 3, c, c)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 2e-5 * scale


@pytest.mark.parametrize("shape", [(2, 5, 7, 8), (3, 8, 8, 16)])
def test_plain_matches_autograd_weight_gradient(shape):
    b, h, w, c = shape
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    weight = torch.zeros(c, c, 3, 3, requires_grad=True)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1)
    (want,) = torch.autograd.grad(y, weight, g.permute(0, 3, 1, 2))
    got = conv3x3_wgrad_plain(x, g).permute(3, 2, 0, 1)  # HWIO -> OIHW
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def test_conv3x3_fn_backward_matches_plain_conv():
    """``SameConv2d(wgrad_kernel=True)`` has the same forward and the same
    input and weight gradients as the plain-autograd convolution."""
    torch.manual_seed(0)
    plain = SameConv2d(8, 8, 3, 1, torch.float32)
    fast = SameConv2d(8, 8, 3, 1, torch.float32, wgrad_kernel=True)
    fast.load_state_dict(plain.state_dict())
    x = torch.randn(3, 6, 5, 8)
    g = torch.randn(3, 6, 5, 8)
    outs = []
    for conv in (plain, fast):
        xi = x.clone().requires_grad_(True)
        y = conv(xi)
        (y * g).sum().backward()
        outs.append((y.detach(), xi.grad, conv.weight.grad))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


def test_wgrad_kernel_only_in_stage_zero():
    model = ResNet18(stage_sizes=(2, 1), width=8)
    on = [n for n, m in model.named_modules()
          if isinstance(m, SameConv2d) and m.wgrad_kernel]
    assert on == ["blocks.0.conv1", "blocks.0.conv2", "blocks.1.conv1",
                  "blocks.1.conv2"]
    with pytest.raises(ValueError, match="3x3 stride-1"):
        SameConv2d(8, 8, 3, 2, wgrad_kernel=True)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    wgrad_cuda.reset_launch_counts()
    model = ResNet18(stage_sizes=(1,), width=8, dtype=torch.float32)
    x = torch.rand(2, 8, 8, 3)
    F.cross_entropy(model(x), torch.tensor([1, 2])).backward()
    assert conv3x3_wgrad.launches == 0


def test_chunking_covers_every_row():
    for k in (1, 31, 192, 25600, 10**6):
        per, n = wgrad_cuda.chunking(k)
        assert per % 32 == 0 and n * per >= k > (n - 1) * per
