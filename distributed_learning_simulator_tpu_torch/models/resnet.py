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
  forward's per-group mean and rstd, or with ``gn_custom_backward=False``
  autodiff of the plain forward (the kernels still run the forward);
* residual add and relu run in the model dtype, the mean pool returns the
  model dtype, and the classifier head is f32 with f32 logits;
* stage 0's 3x3 stride-1 width->width convolutions (``2 * stage_sizes[0]``
  of them, 4 in ResNet-18) are ``_Conv3x3Fn``: the forward and the input
  gradient are cuDNN's, the weight gradient is the hand-written kernel
  (ops/wgrad_cuda.py ``conv3x3_wgrad``), which the JAX package prototyped
  in Pallas for exactly these convolutions. The stem, the stride-2
  convolutions, the 1x1 projections and the later stages are cuDNN's
  forward and backward (ops/conv.py ``conv_nhwc``).

Activations move between layers as NHWC tensors. Each convolution reads a
``permute`` view of its NHWC input, which is a channels-last NCHW tensor,
so cuDNN writes its output channels-last too, and the output permuted back
is the contiguous ``[B, HW, C]`` the GroupNorm kernels read with no copy.

Both autograd functions work under ``torch.func.grad`` inside
``torch.func.vmap``, the shape of the JAX package's vmapped local training:
their forward and backward are vmapped as written (``generate_vmap_rule``),
and the hand-written kernels they reach are custom ops whose vmap rules
fold the vmapped dim into the kernel's leading axis. A vmapped ResNet-18
forward over M models therefore launches each GroupNorm kernel 20 times in
all, at M*B samples with the models' ``[M, C]`` scale/bias, and its
backward launches the weight-gradient kernel 4 times, with M clients on its
client axis; the convolutions become grouped channels-last ones
(ops/conv.py), their outputs left with the models on the channel side,
where an eval forward's GroupNorm reads them without a copy while ``M*C``
fits its kernels' row (2048 bf16 channels) and folds them into its batch
beyond. A training forward's GroupNorm always folds them (one layout
at any model count; ops/gn_cuda.py ``group_norm_op``), its statistics'
sums take an order set by a group's shape alone (csrc/gn.cu), and its
backward sums in short runs (``_sum_bhw``): a client's training has the
same bits however many models share its program, as a sweep fleet's
points must be their solo runs.
With gradients off (an eval forward) the layers call the custom ops
directly: under vmap an autograd function costs host time for each call
even when nothing is differentiated.

The W-folded stage 1 of the JAX package (``fold_stage1``) is a TPU
lane-layout device with identical parameters and exact math, so the port
builds only the unfolded network; ``fold_stage1`` is accepted and kept only
so models/bridge.py knows which JAX parameter tree (and leaf order) a run
corresponds to.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_learning_simulator_tpu_torch.ops.conv import (
    conv_nhwc,
    conv_nhwc_dx_op,
    conv_nhwc_op,
)
from distributed_learning_simulator_tpu_torch.ops.gn_cuda import (
    group_norm_op,
)
from distributed_learning_simulator_tpu_torch.ops.wgrad_cuda import (
    conv3x3_wgrad_op,
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
    dscale = _sum_bhw(dy32 * xhat).reshape(c).to(scale.dtype)
    dbias = _sum_bhw(dy32).reshape(c).to(bias.dtype)
    return dx, dscale, dbias


def _sum_bhw(t):
    """``t [b, h, w, ...]`` summed over (b, h, w) in three short sums (w,
    then h, then b), so that a model's sums have the same bits however many
    models vmap folds beside it (a sweep fleet is held bitwise to its solo
    runs): PyTorch's CUDA reduction reads a short sum in one thread per
    output, while one sum over b*h*w splits across blocks by the output
    count, which grows with the models."""
    return t.sum(dim=2).sum(dim=1).sum(dim=0)


class _PlainGroupNormFn(torch.autograd.Function):
    """GroupNorm whose forward is ``group_norm`` (the custom op over the
    CUDA kernels on a CUDA tensor, their plain versions on a CPU tensor) and
    whose backward is :func:`pgn_backward`. Returns ``(y, mean_g,
    rstd_g)``; the statistics are not differentiable. Under vmap the
    backward runs per model, so dscale/dbias stay per client."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, scale, bias, g, eps, out_dtype):
        with torch.no_grad():
            return group_norm_op(x, scale, bias, g, eps, out_dtype,
                                 training=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias, g, _, _ = inputs
        _, mean_g, rstd_g = output
        ctx.save_for_backward(x, scale, bias, mean_g, rstd_g)
        ctx.mark_non_differentiable(mean_g, rstd_g)
        ctx.g = g

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x, scale, bias, mean_g, rstd_g = ctx.saved_tensors
        dx, dscale, dbias = pgn_backward(x, scale, bias, mean_g, rstd_g, dy,
                                         ctx.g)
        return dx, dscale, dbias, None, None, None


def gn_forward_plain(x, scale, bias, g: int, eps: float, out_dtype):
    """The JAX package's plain GroupNorm forward (``_gn_forward`` without
    Pallas) on NHWC ``x``: one-pass ``E[x^2] - E[x]^2`` statistics in f32,
    ``max(var, 0)``, subtract first, and one cast at the end."""
    b, h, w, c = x.shape
    cpg = c // g
    x5 = x.reshape(b, h, w, g, cpg)
    x32 = x5.float()
    mean = x32.mean(dim=(1, 2, 4), keepdim=True)
    mean2 = (x32 * x32).mean(dim=(1, 2, 4), keepdim=True)
    rstd = torch.rsqrt(torch.clamp(mean2 - mean * mean, min=0.0) + eps)
    a = rstd * scale.reshape(g, cpg)
    y = ((x5 - mean) * a + bias.reshape(g, cpg)).to(out_dtype)
    return y.reshape(b, h, w, c)


class _AutodiffGroupNormFn(torch.autograd.Function):
    """GroupNorm with ``gn_custom_backward=False``: the forward is the same
    ``group_norm`` as :class:`_PlainGroupNormFn`'s (the CUDA kernels on a
    CUDA tensor), and the backward is autodiff of
    :func:`gn_forward_plain`, recomputed from the saved ``x`` by
    ``torch.func.vjp``, as the JAX package differentiates its plain
    forward when the closed form is off. Under vmap the recomputation is
    vmapped with the rest of the backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, scale, bias, g, eps, out_dtype):
        with torch.no_grad():
            return group_norm_op(x, scale, bias, g, eps, out_dtype,
                                 training=True)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias, g, eps, out_dtype = inputs
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (g, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda x, s, b: gn_forward_plain(x, s, b, *ctx.args),
            x, scale, bias)
        return (*vjp(dy), None, None, None)


class PlainGroupNorm(nn.Module):
    """GroupNorm over the channels of an NHWC tensor (``PlainGroupNorm``);
    ``custom_backward=False`` differentiates the forward by autodiff
    (:class:`_AutodiffGroupNormFn`) instead of the closed form."""

    def __init__(self, channels: int, num_groups: int,
                 dtype=torch.bfloat16, epsilon: float = 1e-6,
                 custom_backward: bool = True):
        super().__init__()
        if channels % num_groups:
            raise ValueError(
                f"number of groups ({num_groups}) must divide the "
                f"channel count ({channels})"
            )
        self.num_groups = num_groups
        self.dtype = resolve_dtype(dtype)
        self.epsilon = epsilon
        self.custom_backward = custom_backward
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        # Not made contiguous here: under vmap that would move the models
        # off the channel side where the convolutions leave them (the op
        # makes its input contiguous itself).
        args = (x, self.scale, self.bias, self.num_groups, self.epsilon,
                self.dtype)
        if not torch.is_grad_enabled():
            return group_norm_op(*args)[0]
        if not self.custom_backward:
            return _AutodiffGroupNormFn.apply(*args)
        return _PlainGroupNormFn.apply(*args)[0]


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's SAME convolution for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def same_conv(x, weight, stride: int):
    """XLA's SAME convolution of NHWC ``x`` with an OIHW ``weight``
    (ops/conv.py ``conv_nhwc``, which pads an asymmetric split itself)."""
    ph = _same_pads(x.shape[1], weight.shape[2], stride)
    pw = _same_pads(x.shape[2], weight.shape[3], stride)
    return conv_nhwc(x, weight, stride, ph + pw)


class _Conv3x3Fn(torch.autograd.Function):
    """3x3 stride-1 SAME convolution of NHWC ``x`` with an OIHW ``weight``,
    both in the compute dtype. Forward and input gradient are ops/conv.py's
    ops (vmapped as grouped convolutions); the weight gradient is
    :func:`conv3x3_wgrad` (the kernel on a CUDA tensor, its plain version
    on a CPU one), f32, cast to the weight's dtype as JAX gives a bf16
    convolution a bf16 weight cotangent."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, weight):
        with torch.no_grad():
            return conv_nhwc_op(x, weight, 1, [1] * 4, 1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = dw = None
        with torch.no_grad():
            if ctx.needs_input_grad[0]:
                dx = conv_nhwc_dx_op(dy, weight, x.shape[1], x.shape[2], 1,
                                     [1] * 4, 1)
            if ctx.needs_input_grad[1]:
                dw = conv3x3_wgrad_op(x.contiguous(), dy.contiguous())
        if dw is not None:
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
        x = x.to(self.compute_dtype)
        w = self.weight.to(self.compute_dtype)
        if not self.wgrad_kernel:
            return same_conv(x, w, self.stride[0])
        if not torch.is_grad_enabled():
            return conv_nhwc_op(x, w, 1, [1] * 4, 1)
        return _Conv3x3Fn.apply(x, w)


class Dense(nn.Linear):
    """Classifier head computed in f32 whatever the parameters' dtype."""

    def forward(self, x):
        return F.linear(x.float(), self.weight.float(), self.bias.float())


class ResidualBlock(nn.Module):
    """Basic block; ``wgrad_kernel`` (stage 0) routes both 3x3 convolutions'
    weight gradients through the hand-written kernel."""

    def __init__(self, cin: int, features: int, strides: int = 1,
                 dtype=torch.bfloat16, wgrad_kernel: bool = False,
                 gn_custom_backward: bool = True):
        super().__init__()
        groups = min(32, features)

        def norm():
            return PlainGroupNorm(features, groups, dtype,
                                  custom_backward=gn_custom_backward)

        self.conv1 = SameConv2d(cin, features, 3, strides, dtype,
                                wgrad_kernel)
        self.norm1 = norm()
        self.conv2 = SameConv2d(features, features, 3, 1, dtype, wgrad_kernel)
        self.norm2 = norm()
        self.proj = self.proj_norm = None
        if strides != 1 or cin != features:
            self.proj = SameConv2d(cin, features, 1, strides, dtype)
            self.proj_norm = norm()

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
    docstring); ``gn_custom_backward=False`` differentiates every
    GroupNorm by autodiff of its plain forward (:class:`PlainGroupNorm`)."""

    def __init__(self, num_classes: int = 10,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), width: int = 64,
                 dtype=torch.bfloat16, fold_stage1: bool = True,
                 gn_custom_backward: bool = True, in_channels: int = 3):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.width = width
        self.fold_stage1 = fold_stage1
        self.dtype = resolve_dtype(dtype)
        # CIFAR-style stem (3x3, no initial downsample).
        self.stem = SameConv2d(in_channels, width, 3, 1, self.dtype)
        self.stem_norm = PlainGroupNorm(width, min(32, width), self.dtype,
                                        custom_backward=gn_custom_backward)
        blocks = []
        cin = width
        for stage, n_blocks in enumerate(self.stage_sizes):
            features = width * 2**stage
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                blocks.append(ResidualBlock(
                    cin, features, strides, self.dtype,
                    wgrad_kernel=stage == 0,
                    gn_custom_backward=gn_custom_backward))
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

