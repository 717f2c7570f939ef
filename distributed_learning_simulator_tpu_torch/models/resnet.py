"""ResNet-18/34 with GroupNorm on NHWC inputs (models/resnet.py of the JAX
package).

Same network and numerics as the JAX ``ResNet18`` with its unfolded
stage 1:

* inputs are ``[B, H, W, C]`` and cast to the model dtype (bf16 by default);
  convolutions run in that dtype with the JAX package's SAME padding (at
  stride 2 on an even input that pads (0, 1), not PyTorch's (1, 1));
* GroupNorm (``PlainGroupNorm``) computes its statistics and affine in f32
  and casts once at the output: one-pass E[x^2] - E[x]^2 statistics,
  subtract-first normalize, eps 1e-6, ``min(32, C)`` groups. Its forward is
  the hand-written CUDA kernel pair (ops/gn_cuda.py ``group_norm``); its
  backward is the closed form ``_pgn_bwd`` in plain PyTorch, consuming the
  forward's per-group mean and rstd;
* residual add and relu run in the model dtype, the mean pool returns the
  model dtype, and the classifier head is f32 with f32 logits;
* stage 0's 3x3 stride-1 width->width convolutions (``2 * stage_sizes[0]``
  of them, 4 in ResNet-18) are ``_Conv3x3Fn``: the forward and the input
  gradient are cuDNN's, the weight gradient is the hand-written kernel
  (ops/wgrad_cuda.py ``conv3x3_wgrad``), which the JAX package prototyped
  in Pallas for exactly these convolutions. The stem, the stride-2 and
  projection convolutions and the later stages stay on plain autograd.

Activations move between layers as NHWC tensors. Each convolution reads a
``permute`` view of its NHWC input, which is a channels-last NCHW tensor,
so cuDNN writes its output channels-last too, and the output permuted back
is the contiguous ``[B, HW, C]`` the GroupNorm kernels read with no copy.

The W-folded stage 1 of the JAX package (``fold_stage1``) is a TPU
lane-layout device with identical parameters and exact math, so the port
builds only the unfolded network; ``fold_stage1`` is accepted and kept only
so models/bridge.py knows which JAX parameter tree (and leaf order) a run
corresponds to.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_learning_simulator_tpu_torch.ops.gn_cuda import group_norm
from distributed_learning_simulator_tpu_torch.ops.wgrad_cuda import (
    conv3x3_wgrad,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) not in _DTYPES:
        raise ValueError(f"unknown model dtype {dtype!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[str(dtype)]


def pgn_backward(x, scale, bias, mean_g, rstd_g, dy, g: int):
    """Closed-form GroupNorm backward for NHWC ``x`` (``_pgn_bwd``):

      dx = rstd * (dy*scale - mean_grp(dy*scale)
                   - xhat * mean_grp(dy*scale * xhat))

    in f32, with ``dx`` cast to x's dtype and the parameter gradients to the
    parameters' dtypes."""
    b, h, w, c = x.shape
    cpg = c // g
    x32 = x.float().reshape(b, h, w, g, cpg)
    dy32 = dy.float().reshape(b, h, w, g, cpg)
    mean = mean_g.reshape(b, 1, 1, g, 1)
    rstd = rstd_g.reshape(b, 1, 1, g, 1)
    xhat = (x32 - mean) * rstd
    dyg = dy32 * scale.float().reshape(g, cpg)
    m1 = dyg.mean(dim=(1, 2, 4), keepdim=True)
    m2 = (dyg * xhat).mean(dim=(1, 2, 4), keepdim=True)
    dx = ((dyg - m1 - xhat * m2) * rstd).to(x.dtype).reshape(b, h, w, c)
    dscale = (dy32 * xhat).sum(dim=(0, 1, 2)).reshape(c).to(scale.dtype)
    dbias = dy32.sum(dim=(0, 1, 2)).reshape(c).to(bias.dtype)
    return dx, dscale, dbias


class _PlainGroupNormFn(torch.autograd.Function):
    """GroupNorm whose forward is :func:`group_norm` (the CUDA kernels on a
    CUDA tensor, their plain versions on a CPU tensor) and whose backward
    is :func:`pgn_backward`."""

    @staticmethod
    def forward(ctx, x, scale, bias, g, eps, out_dtype):
        y, mean_g, rstd_g = group_norm(x, scale, bias, g, eps, out_dtype)
        ctx.save_for_backward(x, scale, bias, mean_g, rstd_g)
        ctx.g = g
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean_g, rstd_g = ctx.saved_tensors
        dx, dscale, dbias = pgn_backward(x, scale, bias, mean_g, rstd_g, dy,
                                         ctx.g)
        return dx, dscale, dbias, None, None, None


class PlainGroupNorm(nn.Module):
    """GroupNorm over the channels of an NHWC tensor (``PlainGroupNorm``)."""

    def __init__(self, channels: int, num_groups: int,
                 dtype=torch.bfloat16, epsilon: float = 1e-6):
        super().__init__()
        if channels % num_groups:
            raise ValueError(
                f"number of groups ({num_groups}) must divide the "
                f"channel count ({channels})"
            )
        self.num_groups = num_groups
        self.dtype = resolve_dtype(dtype)
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        # contiguous() is free on the channels-last conv outputs the model
        # feeds here (see the module docstring).
        return _PlainGroupNormFn.apply(
            x.contiguous(), self.scale, self.bias, self.num_groups,
            self.epsilon, self.dtype,
        )


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's SAME convolution for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class _Conv3x3Fn(torch.autograd.Function):
    """3x3 stride-1 SAME convolution of NHWC ``x`` with an OIHW ``weight``,
    both in the compute dtype. Forward and input gradient are cuDNN's
    (``convolution_backward`` asked for the input gradient only); the weight
    gradient is :func:`conv3x3_wgrad` (the kernel on a CUDA tensor, its
    plain version on a CPU one), f32, cast to the weight's dtype as JAX
    gives a bf16 convolution a bf16 weight cotangent."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight, None,
                [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [True, False, False],
            )[0].permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x.contiguous(), dy)
            dw = dw.permute(3, 2, 0, 1).to(weight.dtype)
        return dx, dw


class SameConv2d(nn.Conv2d):
    """Bias-free convolution on NHWC tensors with the JAX package's SAME
    padding, computed in ``dtype``. ``wgrad_kernel=True`` (3x3, stride 1,
    cin == cout only) takes its weight gradient from the hand-written
    kernel (``_Conv3x3Fn``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype=torch.bfloat16, wgrad_kernel: bool = False):
        super().__init__(cin, cout, k, stride=stride, bias=False)
        if wgrad_kernel and not (k == 3 and stride == 1 and cin == cout):
            raise ValueError(
                "the wgrad kernel takes 3x3 stride-1 width->width "
                f"convolutions, got k={k} stride={stride} {cin}->{cout}"
            )
        self.compute_dtype = resolve_dtype(dtype)
        self.wgrad_kernel = wgrad_kernel

    def forward(self, x):
        if self.wgrad_kernel:
            return _Conv3x3Fn.apply(x.to(self.compute_dtype),
                                    self.weight.to(self.compute_dtype))
        xc = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        k, s = self.kernel_size[0], self.stride[0]
        ph = _same_pads(xc.shape[2], k, s)
        pw = _same_pads(xc.shape[3], k, s)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
            padding = (0, 0)
        y = F.conv2d(xc, self.weight.to(self.compute_dtype), stride=s,
                     padding=padding)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """Classifier head computed in f32 whatever the parameters' dtype."""

    def forward(self, x):
        return F.linear(x.float(), self.weight.float(), self.bias.float())


class ResidualBlock(nn.Module):
    """Basic block; ``wgrad_kernel`` (stage 0) routes both 3x3 convolutions'
    weight gradients through the hand-written kernel."""

    def __init__(self, cin: int, features: int, strides: int = 1,
                 dtype=torch.bfloat16, wgrad_kernel: bool = False):
        super().__init__()
        groups = min(32, features)
        self.conv1 = SameConv2d(cin, features, 3, strides, dtype,
                                wgrad_kernel)
        self.norm1 = PlainGroupNorm(features, groups, dtype)
        self.conv2 = SameConv2d(features, features, 3, 1, dtype, wgrad_kernel)
        self.norm2 = PlainGroupNorm(features, groups, dtype)
        self.proj = self.proj_norm = None
        if strides != 1 or cin != features:
            self.proj = SameConv2d(cin, features, 1, strides, dtype)
            self.proj_norm = PlainGroupNorm(features, groups, dtype)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        residual = x
        if self.proj is not None:
            residual = self.proj_norm(self.proj(x))
        return F.relu(y + residual)


class ResNet18(nn.Module):
    """Generic basic-block ResNet; default stage sizes give ResNet-18.

    ``in_channels`` is the input's channel count (the JAX module infers it
    from its first input). ``fold_stage1`` changes nothing here (module
    docstring); ``gn_custom_backward=False`` is not ported yet."""

    def __init__(self, num_classes: int = 10,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), width: int = 64,
                 dtype=torch.bfloat16, fold_stage1: bool = True,
                 gn_custom_backward: bool = True, in_channels: int = 3):
        super().__init__()
        if not gn_custom_backward:
            raise NotImplementedError(
                "gn_custom_backward=False is not ported to the PyTorch "
                "package yet (ROADMAP.md queue 1 item 20)"
            )
        self.stage_sizes = tuple(stage_sizes)
        self.width = width
        self.fold_stage1 = fold_stage1
        self.dtype = resolve_dtype(dtype)
        # CIFAR-style stem (3x3, no initial downsample).
        self.stem = SameConv2d(in_channels, width, 3, 1, self.dtype)
        self.stem_norm = PlainGroupNorm(width, min(32, width), self.dtype)
        blocks = []
        cin = width
        for stage, n_blocks in enumerate(self.stage_sizes):
            features = width * 2**stage
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                blocks.append(ResidualBlock(cin, features, strides, self.dtype,
                                            wgrad_kernel=stage == 0))
                cin = features
        self.blocks = nn.Sequential(*blocks)
        self.head = Dense(cin, num_classes)

    def folds_stage1(self, height: int, width: int) -> bool:
        """Whether the JAX model runs this input with its W-folded stage 1
        (its parameter tree then has the folded layout, models/bridge.py)."""
        return (
            self.fold_stage1 and self.width == 64
            and height % 2 == 0 and width % 2 == 0
        )

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(self.stem_norm(self.stem(x)))
        x = self.blocks(x)
        x = x.mean(dim=(1, 2))
        return self.head(x).float()


def ResNet34(num_classes: int = 10, **kwargs):
    """ResNet-34 stage configuration of the same basic-block network."""
    kwargs.setdefault("stage_sizes", (3, 4, 6, 3))
    return ResNet18(num_classes=num_classes, **kwargs)


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so the truncated draw has variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)
