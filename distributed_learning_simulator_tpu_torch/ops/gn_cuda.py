"""GroupNorm forward: the hand-written Hopper kernels and their plain versions.

Counterpart of ``distributed_learning_simulator_tpu/ops/gn_pallas.py``:

* :func:`gn_stats` launches ``gn_stats_kernel`` (csrc/gn.cu), which replaces
  ``gn_pallas.py:_stats_kernel`` together with the host glue after it
  (``_per_group``, ``var = max(E[x^2] - E[x]^2, 0)``, ``rsqrt``): it emits
  per-(sample, group) ``mean`` and ``rstd`` in f32 directly, from one
  launch of ``B x S`` CTAs in clusters of ``S`` per sample
  (:func:`stats_split` plans ``S``).
* :func:`gn_normalize` launches ``gn_normalize_kernel``, which replaces
  ``gn_pallas.py:_norm_kernel``: ``y = (x - mean) * (rstd * scale) + bias``
  in f32, cast once, from ``B x slices`` CTAs (:func:`normalize_plan`
  plans the slices), with ``scale``/``bias`` read in their own dtype (bf16
  or f32). Called alone it is an ordinary launch. Inside
  :func:`group_norm`, right behind the stats kernel, it is a programmatic
  dependent launch: its CTAs start while the stats kernel still runs, and
  read mean/rstd only once it has completed (csrc/gn.cu says why that is
  safe there and only there).
* :func:`group_norm` is the counterpart of ``pallas_group_norm(...,
  folds=1)``: ``x [B, H, W, C] -> (y, mean_g [B, G], rstd_g [B, G])``.

``scale``/``bias`` are per channel, ``[C]``, or per model, ``[M, C]``: under
the JAX package's client vmap each client's GroupNorm has its own affine,
and here M models' samples are stacked on the batch axis (``x [M*B, HW,
C]``, sample ``s`` reads row ``s // B``). The statistics are per sample
either way.

``torch.func.vmap`` cannot look inside a ctypes launch, so the three
functions the models call are also registered as ``torch.library`` custom
ops (``torch.ops.dls.gn_stats``, ``dls.gn_normalize``, ``dls.group_norm``)
with vmap rules that fold the vmapped dim into the kernel's leading axis:
a vmapped ResNet forward over M models launches each kernel once per
GroupNorm, at ``M*B`` samples, with the models' scale/bias as ``[M, C]``
(or as one ``[C]`` where the params are shared, as under sign_SGD). Where
the models sit on the channel side instead, as ops/conv.py's grouped
convolutions leave them, and ``M*C`` channels fit a kernel row,
``dls.group_norm`` reads them in place: the GroupNorm of ``[B, HW, M*C]``
with ``M*G`` groups and the M affines side by side is each model's.

Both kernels are bound by bytes on an H100 (3.35 TB/s): the stats pass must
read ``x`` once, the normalize pass read ``x`` and write ``y`` once each.
csrc/gn.cu says what the design does about that bound.

Dispatch rule: a tensor on the CPU takes the plain PyTorch version (that is
how the tests run); a CUDA tensor launches the kernel or raises. There is no
fallback from the kernel to the plain version. Each wrapper counts its
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from distributed_learning_simulator_tpu_torch.ops._build import (
    count_launch,
    device_guard,
    launch_stream,
    load_library,
    locked_once,
)
from distributed_learning_simulator_tpu_torch.ops._vmap import models_first

_THREADS = 256  # csrc/gn.cu kThreads
_MAX_SPLIT = 8  # the largest portable thread-block cluster
_IN_FLIGHT = 8  # csrc/gn.cu kInFlight: loads a thread issues together
# Two CTAs per SM of the H100 SXM (132 SMs) that stats_split was measured
# on: below that many CTAs a split can fill the card.
_TARGET_CTAS = 2 * 132
# What a cluster of S > 1 costs beyond one CTA per sample, in load round
# trips: on an H100 the cluster launch and its two barriers cost about as
# much as 1.5 batches of in-flight loads (chip_smoke.py's split sweep).
_CLUSTER_COST = 1.5


def stats_split(b: int, hw: int, c: int, elem_size: int) -> int:
    """CTAs per sample (the cluster size S, a power of two up to 8) of the
    stats kernel for ``x [B, HW, C]``. One CTA walks its HW rows in batches
    of ``_IN_FLIGHT`` loads per thread, each batch one memory round trip;
    S CTAs cut the batches by S but pay ``_CLUSTER_COST``. S is the smallest
    split with the fewest batches plus that cost, 1 once B alone gives
    ``_TARGET_CTAS`` CTAs, and at most HW (a CTA with an empty slice adds
    zeros)."""
    if b >= _TARGET_CTAS:
        return 1
    rows = _THREADS // (c // (16 // elem_size))  # HW rows in flight a CTA
    best = None
    for split in (1, 2, 4, 8):
        if split > hw:
            break
        rows_per_cta = -(-hw // split)
        batches = -(-rows_per_cta // (rows * _IN_FLIGHT))
        cost = batches + (_CLUSTER_COST if split > 1 else 0.0)
        if best is None or cost < best[0]:
            best = (cost, split)
    return best[1]


class NormalizePlan(NamedTuple):
    """The normalize kernel's grid: CTA ``i`` normalizes HW rows
    ``[s * rows_per_slice, (s + 1) * rows_per_slice)`` of sample ``i //
    slices``, with ``s = i % slices``."""

    slices: int          # CTAs per sample
    rows_per_slice: int  # HW rows a CTA normalizes (the last may have fewer)
    grid: int            # CTAs in all, B x slices


def normalize_plan(b: int, hw: int, c: int, elem_size: int, sms: int,
                   slices: int | None = None) -> NormalizePlan:
    """Slices per sample of the normalize kernel for ``x [B, HW, C]`` on a
    card of ``sms`` SMs. A CTA covers ``rows`` HW rows per step (one
    16-byte vector a thread), and a thread issues all its steps' loads
    together, so it may have at most ``_IN_FLIGHT`` steps. Each CTA pays a
    fixed start (its launch, its threads' scale/bias/mean/rstd loads), so
    fewer, fuller CTAs win until the card runs out of SMs (chip_gn_sweep.py
    at B=25). So: at most one CTA per SM (``sms // B`` slices), unless a
    thread would have more than ``_IN_FLIGHT`` steps; never more slices than
    steps (no CTA without rows); the steps spread evenly. ``slices`` asks
    for a count instead (chip_gn_sweep.py, the card tests); it is clipped to
    that range and spread the same way. A slice never spans two samples."""
    rows = _THREADS // (c // (16 // elem_size))
    steps = -(-hw // rows)
    least = -(-steps // _IN_FLIGHT)  # one batch of loads a thread
    if slices is None:
        slices = sms // b
    slices = max(least, min(steps, slices))
    per = -(-steps // slices)  # steps of each slice but the last
    assert per <= _IN_FLIGHT
    slices = -(-steps // per)
    return NormalizePlan(slices, per * rows, b * slices)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def gn_stats_plain(x: torch.Tensor, g: int, eps: float):
    """Plain version of the stats kernel: ``x [B, HW, C] -> (mean, rstd)``,
    both ``[B, G]`` f32 (one-pass E[x^2] - E[x]^2 statistics)."""
    b, hw, c = x.shape
    cpg = c // g
    x32 = x.float().reshape(b, hw, g, cpg)
    cnt = hw * cpg
    mean = x32.sum(dim=(1, 3)) / cnt
    mean2 = (x32 * x32).sum(dim=(1, 3)) / cnt
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def _affine_rows(t: torch.Tensor, b: int, g: int) -> torch.Tensor:
    """``[C]`` -> ``[G, cpg]``; ``[M, C]`` -> ``[B, G, cpg]`` (model
    ``s // (B / M)`` for sample ``s``), f32."""
    if t.dim() == 1:
        return t.float().reshape(g, -1)
    return t.float().repeat_interleave(b // t.shape[0], dim=0).reshape(
        b, g, -1)


def gn_normalize_plain(x, mean, rstd, scale, bias, out_dtype):
    """Plain version of the normalize kernel: subtract first, then one
    multiply by ``a = rstd * scale``, then the bias, in f32, cast once.
    ``scale``/``bias`` are ``[C]`` or ``[M, C]`` (module docstring)."""
    b, hw, c = x.shape
    g = mean.shape[1]
    cpg = c // g
    a = rstd[:, :, None] * _affine_rows(scale, b, g)            # [B, G, cpg]
    bi = _affine_rows(bias, b, g)
    if bi.dim() == 3:
        bi = bi[:, None]
    y = (x.float().reshape(b, hw, g, cpg) - mean[:, None, :, None]) * a[
        :, None
    ] + bi
    return y.to(out_dtype).reshape(b, hw, c)


_KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


@locked_once
def _lib() -> ctypes.CDLL:
    lib = load_library("gn")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for suffix in _KERNEL_DTYPES.values():
        stats = getattr(lib, f"dls_gn_stats_{suffix}")
        stats.argtypes = [vp, vp, vp, ci, ci, ci, ci, cf, ci, vp]
        stats.restype = ci
        for params in _KERNEL_DTYPES.values():
            norm = getattr(lib, f"dls_gn_normalize_{suffix}_{params}")
            norm.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                             ci, ci, vp]
            norm.restype = ci
    return lib


def _check_cuda_input(x: torch.Tensor, g: int) -> str:
    """Raise on anything the kernels do not take; return the dtype suffix."""
    if x.device.type != "cuda":
        raise ValueError(f"GroupNorm kernels run on CUDA tensors, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"GroupNorm kernels take bfloat16 or float32, got {x.dtype}"
        )
    if x.dim() != 3:
        raise ValueError(f"expected x [B, HW, C], got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("GroupNorm kernels need a contiguous [B, HW, C] x")
    b, hw, c = x.shape
    vec = 16 // x.element_size()
    if b < 1 or hw < 1:
        raise ValueError(f"empty GroupNorm input {tuple(x.shape)}")
    if c % g:
        raise ValueError(f"groups ({g}) must divide channels ({c})")
    if c % vec or c // vec > _THREADS:
        raise ValueError(
            f"GroupNorm kernels need C a multiple of {vec} and at most "
            f"{_THREADS * vec} for {x.dtype}, got C={c}"
        )
    if x.data_ptr() % 16:
        raise ValueError("GroupNorm kernels need a 16-byte aligned x")
    return _KERNEL_DTYPES[x.dtype]


def _raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: cudaError {err} "
            f"({torch.cuda.get_device_name()})"
        )


def gn_stats(x: torch.Tensor, g: int, eps: float, split: int | None = None):
    """Per-(sample, group) ``(mean, rstd)`` of ``x [B, HW, C]``, f32.
    ``split`` overrides the planned cluster size (tests and chip_smoke.py's
    sweep)."""
    if x.device.type == "cpu":
        return gn_stats_plain(x, g, eps)
    suffix = _check_cuda_input(x, g)
    b, hw, c = x.shape
    if split is None:
        split = stats_split(b, hw, c, x.element_size())
    elif split not in (1, 2, 4, 8):
        raise ValueError(f"split must be 1, 2, 4 or 8, got {split}")
    mean = torch.empty((b, g), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    fn = getattr(_lib(), f"dls_gn_stats_{suffix}")
    with device_guard(x):
        err = fn(
            x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b, hw, c, g, eps,
            split, launch_stream(x),
        )
    _raise_on_error(err, "gn_stats_kernel")
    count_launch(gn_stats, x.device)
    return mean, rstd


gn_stats.launches = 0
gn_stats.launches_by_device = {}


def gn_normalize(x, mean, rstd, scale, bias, out_dtype):
    """``y = (x - mean) * (rstd * scale) + bias`` on ``x [B, HW, C]``, with
    ``scale``/``bias`` ``[C]`` or ``[M, C]`` (M dividing B): an ordinary
    launch, so it may follow any kernel that wrote its inputs."""
    return _normalize(x, mean, rstd, scale, bias, out_dtype, after_stats=False)


def _normalize(x, mean, rstd, scale, bias, out_dtype, after_stats: bool,
               slices: int | None = None):
    """:func:`gn_normalize`, launched as a programmatic dependent launch of
    the kernel before it when ``after_stats``: only :func:`group_norm` may
    ask for that, right behind the ``gn_stats`` launch that wrote ``mean``
    and ``rstd`` (csrc/gn.cu). ``slices`` overrides the planned CTAs per
    sample (chip_gn_sweep.py, the card tests)."""
    if x.device.type == "cpu":
        return gn_normalize_plain(x, mean, rstd, scale, bias, out_dtype)
    suffix = _check_cuda_input(x, mean.shape[1])
    b, hw, c = x.shape
    g = mean.shape[1]
    if out_dtype != x.dtype:
        raise ValueError(
            f"gn_normalize_kernel writes y in x's dtype ({x.dtype}), "
            f"asked for {out_dtype}"
        )
    stats = (mean, rstd)
    if any(
        t.dtype != torch.float32 or t.shape != (b, g) or not t.is_contiguous()
        or t.device != x.device
        for t in stats
    ):
        raise ValueError("mean/rstd must be contiguous [B, G] f32 on x's device")
    # The kernel reads the per-channel affine in its own dtype (bf16 under
    # bf16 local training) and widens it exactly: no conversion launches.
    if (
        scale.dtype not in _KERNEL_DTYPES or bias.dtype != scale.dtype
        or scale.shape != bias.shape
        or scale.shape not in ((c,), (scale.shape[0], c))
        or (scale.dim() == 2 and (scale.shape[0] < 1
                                  or b % scale.shape[0]))
        or any(not t.is_contiguous() or t.device != x.device
               for t in (scale, bias))
    ):
        raise ValueError(
            f"scale/bias must be contiguous [{c}] or [M, {c}] (M dividing "
            f"B={b}) bfloat16 or float32 of one dtype and shape on x's device"
        )
    rows_per_model = b // scale.shape[0] if scale.dim() == 2 else 0
    plan = normalize_plan(b, hw, c, x.element_size(),
                          _sm_count(x.device.index), slices)
    y = torch.empty_like(x)
    fn = getattr(
        _lib(), f"dls_gn_normalize_{suffix}_{_KERNEL_DTYPES[scale.dtype]}"
    )
    with device_guard(x):
        err = fn(
            x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), b, hw, c, g, plan.slices,
            plan.rows_per_slice, rows_per_model, int(after_stats),
            launch_stream(x),
        )
    _raise_on_error(err, "gn_normalize_kernel")
    count_launch(gn_normalize, x.device)
    return y


gn_normalize.launches = 0
gn_normalize.launches_by_device = {}


def reset_launch_counts() -> None:
    for wrapper in (gn_stats, gn_normalize):
        wrapper.launches = 0
        wrapper.launches_by_device = {}


def group_norm(x, scale, bias, g: int, eps: float, out_dtype):
    """GroupNorm forward on ``x [B, H, W, C]``; returns ``(y [B, H, W, C],
    mean_g [B, G] f32, rstd_g [B, G] f32)`` — ``pallas_group_norm`` at
    ``folds=1``. ``scale``/``bias`` are per-channel ``[C]``, or ``[M, C]``
    for M models stacked on the batch axis."""
    b, h, w, c = x.shape
    if x.device.type != "cpu" and not x.is_contiguous():
        # A reshape would copy silently; the model keeps its activations
        # channels-last so this view is free.
        raise ValueError("group_norm on CUDA needs a contiguous NHWC x")
    xr = x.reshape(b, h * w, c)
    # Back to back on one stream, nothing launched between: the normalize
    # kernel's programmatic dependent launch overlaps the stats kernel.
    mean_g, rstd_g = gn_stats(xr, g, eps)
    y = _normalize(xr, mean_g, rstd_g, scale, bias, out_dtype,
                   after_stats=True)
    return y.reshape(b, h, w, c), mean_g, rstd_g


# --- custom ops: what torch.func.vmap sees ---------------------------------
#
# Each op runs the wrapper above (the kernel on a CUDA tensor, the plain
# version on a CPU one). A vmap rule folds the vmapped dim into the leading
# (sample) axis and calls the op once: x batched at dim d becomes [M*B, ...];
# a batched scale/bias becomes the kernel's [M, C] affine, an unbatched one
# stays [C] (shared params). Nothing here differentiates: the models' autograd
# functions call these ops under no_grad and give their own backward.


def _fold(t: torch.Tensor, bdim, size: int) -> torch.Tensor:
    """``t``'s models folded into its first dim: ``[M, B, ...] -> [M*B,
    ...]``, contiguous."""
    t = models_first(t, bdim, size)
    return t.reshape((-1,) + tuple(t.shape[2:])).contiguous()


def _samples(t: torch.Tensor, bdim) -> int:
    """The per-model batch B of ``t``: its first dim other than the
    vmapped one."""
    return t.shape[1 if bdim == 0 else 0]


def _model_rows(scale, bias, in_dims, size: int):
    """The affine as the kernel takes it: ``[C]`` when neither is vmapped,
    else both as contiguous ``[M, C]``."""
    if in_dims == (None, None):
        return scale, bias
    return tuple(models_first(t, d, size).contiguous()
                 for t, d in zip((scale, bias), in_dims))


@torch.library.custom_op("dls::gn_stats", mutates_args=())
def gn_stats_op(x: torch.Tensor, g: int, eps: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    return gn_stats(x.contiguous(), g, eps)


@gn_stats_op.register_fake
def _(x, g, eps):
    out = x.new_empty((x.shape[0], g), dtype=torch.float32)
    return out, torch.empty_like(out)


def _gn_stats_vmap(info, in_dims, x, g, eps):
    b = _samples(x, in_dims[0])
    mean, rstd = gn_stats_op(_fold(x, in_dims[0], info.batch_size), g, eps)
    return (mean.reshape(-1, b, g), rstd.reshape(-1, b, g)), (0, 0)


torch.library.register_vmap("dls::gn_stats", _gn_stats_vmap)


@torch.library.custom_op("dls::gn_normalize", mutates_args=())
def gn_normalize_op(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    return gn_normalize(x.contiguous(), mean.contiguous(),
                        rstd.contiguous(), scale.contiguous(),
                        bias.contiguous(), out_dtype)


@gn_normalize_op.register_fake
def _(x, mean, rstd, scale, bias, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype)


def _gn_normalize_vmap(info, in_dims, x, mean, rstd, scale, bias, out_dtype):
    size = info.batch_size
    xd, md, rd, sd, bd = in_dims[:5]
    b = _samples(x, xd)
    scale, bias = _model_rows(scale, bias, (sd, bd), size)
    y = gn_normalize_op(_fold(x, xd, size), _fold(mean, md, size),
                        _fold(rstd, rd, size), scale, bias, out_dtype)
    return y.reshape((size, b) + tuple(y.shape[1:])), 0


torch.library.register_vmap("dls::gn_normalize", _gn_normalize_vmap)


@torch.library.custom_op("dls::group_norm", mutates_args=())
def group_norm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  g: int, eps: float, out_dtype: torch.dtype
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return group_norm(x.contiguous(), scale.contiguous(), bias.contiguous(),
                      g, eps, out_dtype)


@group_norm_op.register_fake
def _(x, scale, bias, g, eps, out_dtype):
    mean = x.new_empty((x.shape[0], g), dtype=torch.float32)
    return (x.new_empty(x.shape, dtype=out_dtype), mean,
            torch.empty_like(mean))


def _group_norm_folded(info, in_dims, x, scale, bias, g, eps, out_dtype):
    """The models folded into the batch: ``[M*B, HW, C]`` with the
    ``[M, C]`` affine (or the shared ``[C]`` one)."""
    size = info.batch_size
    xd, sd, bd = in_dims[:3]
    b = _samples(x, xd)
    scale, bias = _model_rows(scale, bias, (sd, bd), size)
    y, mean, rstd = group_norm_op(_fold(x, xd, size), scale, bias, g, eps,
                                  out_dtype)
    return ((y.reshape((size, b) + tuple(y.shape[1:])),
             mean.reshape(size, -1, g), rstd.reshape(size, -1, g)),
            (0, 0, 0))


def channel_side(x: torch.Tensor, xd, size: int) -> bool:
    """Whether ``group_norm``'s vmap rule reads ``x`` (vmapped at ``xd``
    over ``size`` models) in place with the models on the channel side:
    ``[B, H, W, M, C]`` as the grouped convolutions leave it, contiguous,
    and ``M*C`` within a kernel row (one 16-byte vector a thread: 2048
    bf16 or 1024 f32 channels)."""
    return (xd == x.dim() - 2 and x.is_contiguous()
            and size * x.shape[-1] <= _THREADS * (16 // x.element_size()))


def _group_norm_vmap(info, in_dims, x, scale, bias, g, eps, out_dtype):
    # x is folded (or, below, viewed) once, then the stats -> normalize
    # pair runs back to back inside group_norm (the programmatic dependent
    # launch needs nothing launched between them).
    size = info.batch_size
    xd, sd, bd = in_dims[:3]
    if not channel_side(x, xd, size):
        return _group_norm_folded(info, in_dims, x, scale, bias, g, eps,
                                  out_dtype)
    # x is [B, H, W, M*C] in memory, and its GroupNorm with M*G groups and
    # the M affines side by side is each model's GroupNorm (a group never
    # spans two models). No copy, and the output keeps the layout for the
    # next convolution.
    wide = x.reshape(tuple(x.shape[:xd]) + (size * x.shape[-1],))
    scale, bias = (models_first(t, d, size).reshape(-1).contiguous()
                   for t, d in ((scale, sd), (bias, bd)))
    y, mean, rstd = group_norm_op(wide, scale, bias, g * size, eps,
                                  out_dtype)
    b = x.shape[0]
    return ((y.reshape(x.shape), mean.reshape(b, size, g),
             rstd.reshape(b, size, g)), (xd, 1, 1))


torch.library.register_vmap("dls::group_norm", _group_norm_vmap)
