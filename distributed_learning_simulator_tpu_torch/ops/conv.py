"""NHWC convolutions as ``torch.library`` custom ops with vmap rules.

The models keep activations channels-last (``[B, H, W, C]``). Under
``torch.func.vmap`` over M stacked models, functorch's own convolution rule
folds the models into the channel axis of a contiguous NCHW tensor: a
layout copy in, cuDNN's conversions to NHWC and back, and another copy
where the next GroupNorm folds the models into its batch. The ops here
take the NHWC tensors as they are and give the vmapped call its grouped
convolution in channels-last layout:

* the input ``[B, H, W, C]`` of M models is viewed (one copy at most) as
  ``[B, H, W, M*C]``, the weights ``[M, O, C, k, k]`` as ``[M*O, C, k,
  k]``, and one convolution with M groups computes every model's output;
* the result ``[B, H', W', M*O]`` is returned as ``[B, H', W', M, O]``
  with the vmapped dim at 3, a view, so the op that reads it next decides
  whether it needs the models first (ops/gn_cuda.py's GroupNorm reads
  them in place while ``M*O`` fits its kernels' row, and keeps the layout
  for the next convolution; else it folds them into its batch);
* shared weights (sign_SGD's params) fold the models into the batch
  instead, and a shared input (the eval forward's first layer) runs one
  ungrouped convolution with the M models' filters side by side.

Padding is ``[top, bottom, left, right]``. cuDNN pads symmetrically; an
asymmetric padding (XLA's SAME at stride 2 on an even input pads only the
high end) is applied inside the op, to the tensor as the op receives it. A
pad outside, under vmap, would move the models in front of the batch and
cost a second copy to bring them back to the channel side.

:func:`conv_nhwc` is the differentiable entry point: its forward and its
input and weight gradients are the three ops below, so a vmapped training
step runs each convolution's forward and backward once for the chunk. The
weight gradient is per model (a grouped weight gradient), as the JAX
package's vmapped ``grad`` gives.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu_torch.ops._vmap import models_first


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC tensor, channels-last in memory."""
    return t.contiguous().permute(0, 3, 1, 2)


def _padded(x: torch.Tensor, padding) -> tuple[torch.Tensor, int]:
    """``(x, p)`` for a convolution with symmetric padding ``p``: ``x``
    itself when ``padding`` is symmetric, else ``x`` padded here (p = 0)."""
    top, bottom, left, right = padding
    if top == bottom == left == right:
        return x, top
    return F.pad(x, (0, 0, left, right, top, bottom)), 0


def _out_size(size: int, k: int, stride: int, lo: int, hi: int) -> int:
    return (size + lo + hi - k) // stride + 1


@torch.library.custom_op("dls::conv_nhwc", mutates_args=())
def conv_nhwc_op(x: torch.Tensor, w: torch.Tensor, stride: int,
                 padding: list[int], groups: int) -> torch.Tensor:
    """``y [B, H', W', O]`` of ``x [B, H, W, C]`` and OIHW ``w``."""
    x, p = _padded(x, padding)
    return F.conv2d(_nchw(x), w, stride=stride, padding=p,
                    groups=groups).permute(0, 2, 3, 1)


@conv_nhwc_op.register_fake
def _(x, w, stride, padding, groups):
    h = _out_size(x.shape[1], w.shape[2], stride, padding[0], padding[1])
    wd = _out_size(x.shape[2], w.shape[3], stride, padding[2], padding[3])
    return x.new_empty((x.shape[0], h, wd, w.shape[0]))


def _flipped_forward_dx(dy: torch.Tensor, w: torch.Tensor, p: int,
                        groups: int) -> torch.Tensor:
    """The input gradient of a stride-1 convolution with symmetric padding
    ``p`` as a forward convolution: ``dy`` with each group's kernel flipped
    in space and transposed in channels, padded by ``k - 1 - p``."""
    o, cg, kh, kw = w.shape
    wt = w.reshape(groups, o // groups, cg, kh, kw).transpose(1, 2).flip(
        3, 4).reshape(groups * cg, o // groups, kh, kw)
    return torch.ops.aten.convolution(
        _nchw(dy), wt, None, [1, 1], [kh - 1 - p, kw - 1 - p], [1, 1],
        False, [0, 0], groups).permute(0, 2, 3, 1)


@torch.library.custom_op("dls::conv_nhwc_dx", mutates_args=())
def conv_nhwc_dx_op(dy: torch.Tensor, w: torch.Tensor, in_h: int,
                    in_w: int, stride: int, padding: list[int],
                    groups: int) -> torch.Tensor:
    """The input gradient ``[B, in_h, in_w, C]`` of :func:`conv_nhwc_op`
    (the input's values do not enter it, only its shape).

    In f32 at stride 1 with symmetric padding it is the forward
    convolution of :func:`_flipped_forward_dx`: cuDNN's f32 grouped input
    gradient changes its rounding with the group count, so with the models
    vmap folds into the groups (a ResNet-18 stage-1 convolution at 19
    against 76 models on an H100), while its forward at the same shape
    keeps its bits, and an f32 sweep fleet is held bitwise to its solo runs
    (chip_smoke.py ``sweep_fleet``). In bf16, cuDNN's grouped input
    gradient keeps its bits from the solo chunk's group count to the
    fleet's (10 against 40 models, every ResNet-18 convolution on an H100:
    tests/test_torch_fleet_replay_cuda.py), and bf16 keeps it."""
    top, bottom, left, right = padding
    symmetric = top == bottom == left == right
    p = top if symmetric else 0
    kh, kw = w.shape[2:]
    if (dy.dtype == torch.float32 and stride == 1 and symmetric
            and p < min(kh, kw)):
        return _flipped_forward_dx(dy, w, p, groups)
    ph, pw = (in_h, in_w) if symmetric else (in_h + top + bottom,
                                             in_w + left + right)
    inp = dy.new_empty((dy.shape[0], ph, pw, w.shape[1] * groups)).permute(
        0, 3, 1, 2)
    dx = torch.ops.aten.convolution_backward(
        _nchw(dy), inp, w, None, [stride] * 2, [p] * 2, [1, 1],
        False, [0, 0], groups, [True, False, False])[0].permute(0, 2, 3, 1)
    if not symmetric:  # the padded input's gradient, cut to the input's
        dx = dx[:, top:top + in_h, left:left + in_w].contiguous()
    return dx


@conv_nhwc_dx_op.register_fake
def _(dy, w, in_h, in_w, stride, padding, groups):
    return dy.new_empty((dy.shape[0], in_h, in_w, w.shape[1] * groups))


@torch.library.custom_op("dls::conv_nhwc_dw", mutates_args=())
def conv_nhwc_dw_op(dy: torch.Tensor, x: torch.Tensor, kh: int, kw: int,
                    stride: int, padding: list[int],
                    groups: int) -> torch.Tensor:
    """The weight gradient ``[O, C / groups, kh, kw]`` of
    :func:`conv_nhwc_op`, in the output gradient's dtype."""
    weight = dy.new_empty((dy.shape[-1], x.shape[-1] // groups, kh, kw))
    x, p = _padded(x, padding)
    return torch.ops.aten.convolution_backward(
        _nchw(dy), _nchw(x), weight, None, [stride] * 2, [p] * 2,
        [1, 1], False, [0, 0], groups, [False, True, False])[1]


@conv_nhwc_dw_op.register_fake
def _(dy, x, kh, kw, stride, padding, groups):
    return dy.new_empty((dy.shape[-1], x.shape[-1] // groups, kh, kw))


def _channels(t: torch.Tensor, bdim, size: int) -> torch.Tensor:
    """An NHWC tensor of ``size`` models (vmapped at ``bdim``; broadcast
    when None) as one ``[B, H, W, size*C]`` tensor, contiguous."""
    if bdim is None:
        t = t.unsqueeze(3).expand(t.shape[:3] + (size, t.shape[3]))
    else:
        t = t.movedim(bdim, 3)
    return t.reshape(t.shape[:3] + (-1,)).contiguous()


def _stacked_weight(w: torch.Tensor, bdim, size: int) -> torch.Tensor:
    """M models' OIHW weights as one ``[M*O, C, k, k]`` weight."""
    w = models_first(w, bdim, size)
    return w.reshape((-1,) + tuple(w.shape[2:])).contiguous()


def _models_on_channels(y: torch.Tensor, size: int):
    """``[B, H, W, M*O]`` -> ``([B, H, W, M, O] view, vmapped dim 3)``."""
    return y.reshape(y.shape[:3] + (size, -1)), 3


def _conv_vmap(info, in_dims, x, w, stride, padding, groups):
    m = info.batch_size
    xd, wd = in_dims[:2]
    if wd is None:  # shared weights: the models' samples are one batch
        x = models_first(x, xd, m)
        y = conv_nhwc_op(x.reshape((-1,) + tuple(x.shape[2:])), w, stride,
                         padding, groups)
        return y.reshape((m, -1) + tuple(y.shape[1:])), 0
    weight = _stacked_weight(w, wd, m)
    if xd is None and groups == 1:  # shared input: the filters side by side
        return _models_on_channels(
            conv_nhwc_op(x, weight, stride, padding, 1), m)
    return _models_on_channels(conv_nhwc_op(
        _channels(x, xd, m), weight, stride, padding, groups * m), m)


def _dx_vmap(info, in_dims, dy, w, in_h, in_w, stride, padding, groups):
    m = info.batch_size
    dd, wd = in_dims[:2]
    if wd is None:
        dy = models_first(dy, dd, m)
        dx = conv_nhwc_dx_op(dy.reshape((-1,) + tuple(dy.shape[2:])), w,
                             in_h, in_w, stride, padding, groups)
        return dx.reshape((m, -1) + tuple(dx.shape[1:])), 0
    return _models_on_channels(conv_nhwc_dx_op(
        _channels(dy, dd, m), _stacked_weight(w, wd, m), in_h, in_w,
        stride, padding, groups * m), m)


def _dw_vmap(info, in_dims, dy, x, kh, kw, stride, padding, groups):
    # Always grouped: each model's weight gradient is its own, also when
    # the weights are shared (the vmapped grad of shared params).
    m = info.batch_size
    dd, xd = in_dims[:2]
    dw = conv_nhwc_dw_op(_channels(dy, dd, m), _channels(x, xd, m), kh, kw,
                         stride, padding, groups * m)
    return dw.reshape((m, -1) + tuple(dw.shape[1:])), 0


torch.library.register_vmap("dls::conv_nhwc", _conv_vmap)
torch.library.register_vmap("dls::conv_nhwc_dx", _dx_vmap)
torch.library.register_vmap("dls::conv_nhwc_dw", _dw_vmap)


class _ConvNHWCFn(torch.autograd.Function):
    """A convolution of NHWC ``x`` with OIHW ``w``: forward, input gradient
    and weight gradient are the custom ops above (vmapped as written)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, stride, padding):
        with torch.no_grad():
            return conv_nhwc_op(x, w, stride, list(padding), 1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, stride, padding = inputs
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        with torch.no_grad():
            if ctx.needs_input_grad[0]:
                dx = conv_nhwc_dx_op(dy, w, x.shape[1], x.shape[2],
                                     ctx.stride, list(ctx.padding), 1)
            if ctx.needs_input_grad[1]:
                dw = conv_nhwc_dw_op(dy, x, w.shape[2], w.shape[3],
                                     ctx.stride, list(ctx.padding), 1)
        return dx, dw, None, None


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              padding=0) -> torch.Tensor:
    """``[B, H, W, C]`` NHWC convolution with OIHW ``w``; ``padding`` is
    one int for every side or ``(top, bottom, left, right)``.
    Differentiable, and vmapped as grouped channels-last convolutions
    (module docstring). With gradients off (an eval forward) it is the op
    alone, without the autograd function's costs under vmap."""
    padding = ((padding,) * 4 if isinstance(padding, int)
               else tuple(padding))
    if not torch.is_grad_enabled():
        return conv_nhwc_op(x, w, stride, list(padding), 1)
    return _ConvNHWCFn.apply(x, w, stride, padding)
