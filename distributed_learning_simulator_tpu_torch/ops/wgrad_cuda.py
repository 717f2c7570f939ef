"""Weight gradient of ResNet's stage-1 3x3 convolutions: the hand-written
Hopper kernel and its plain version.

Counterpart of ``scripts/exp_pallas_wgrad.py`` ``pallas_wgrad`` (its
``_wgrad_kernel``), the TPU prototype written to replace XLA's autodiff
weight gradient of exactly these convolutions:

    dW[dy, dx, ci, co] = sum_{b, h, w} x_pad[b, h + dy, w + dx, ci]
                                       * g[b, h, w, co]

for a 3x3, stride-1, SAME (zero padding 1) convolution, ``x`` its NHWC
input, ``g`` the gradient of its NHWC output, ``dW`` ``[3, 3, C, C]`` f32
(HWIO). Like the prototype, whose grid runs over N clients, the kernel also
takes a client axis: ``x, g [N, B, H, W, C] -> dW [N, 3, 3, C, C]``, one
launch for a whole chunk of clients (the JAX package's client vmap). The
prototype worked on a W-folded layout (a TPU lane device); the port keeps
the plain NHWC layout, so the kernel is written from the formula above, not
block by block (csrc/wgrad.cu says how).

:func:`conv3x3_wgrad` launches ``wgrad_tc_kernel`` (bf16, tensor cores) or
``wgrad_f32_partial_kernel`` (f32, CUDA cores, no TF32), and
``wgrad_reduce_kernel`` where partials meet (csrc/wgrad.cu), on CUDA
tensors, ``C % 8 == 0``, any N, B, H, W. :func:`chunking` plans the work:
each client's K is cut into runs by (B, H, W, C) alone and the runs'
partials are added left to right, so a client's dW has the same bits
whatever N is and whichever layout computes it; N only picks the layout.
:func:`conv3x3_wgrad_plain` is the same function in plain PyTorch (nine
shifted contractions in f32). ``torch.ops.dls.conv3x3_wgrad`` is the custom
op ``torch.func.vmap`` sees: its vmap rule folds the vmapped dim into the
client axis, so a vmapped training step launches the kernel once per
convolution for the whole chunk.

Dispatch rule: a tensor on the CPU takes the plain version (that is how the
tests run); a CUDA tensor launches the kernel or raises. There is no
fallback from the kernel to the plain version. ``conv3x3_wgrad.launches``
counts the wrapper's launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu_torch.ops._build import (
    count_launch,
    device_guard,
    launch_stream,
    load_library,
    locked_once,
)
from distributed_learning_simulator_tpu_torch.ops._vmap import models_first

_TILE = 64  # csrc/wgrad.cu kTile: ci and co extent of a block's tile
_SEG = 32  # csrc/wgrad.cu kSeg: positions of one image row per staged piece
# Runs a client's K is cut into: 44 x 3 dy = 132 tensor-core CTAs for one
# client, one per SM of an H100, each with the same number of row pairs
# (within one). The count depends on the client's shape alone, never on
# how many clients share the launch.
_RUNS = 132 // 3
_MIN_RUN_PAIRS = 2  # smaller problems take fewer, fuller runs
# The bf16 kernel's layouts (csrc/wgrad.cu `dls_wgrad_bf16`), which give
# the same bits: one CTA per (client, run, dy, tile) and a reduce (FEW); or
# one CTA per (client, dy, tile) walking the client's runs, alone on its SM
# (WALK). Walking pays from _WALK_CTAS CTAs on (chip_smoke.py phase 1d,
# H100 80GB HBM3 at 700 W, (N, 25, 32, 32, 64): FEW 0.1233 ms at N = 10
# and 0.2331 at 20, WALK 0.1416 and 0.1424).
FEW, WALK = 0, 1
_WALK_CTAS = 36


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dW [3, 3, C, C]`` f32 from ``x, g [B, H, W, C]`` (``[N, 3, 3, C,
    C]`` from ``[N, B, H, W, C]``): one f32 contraction over (b, h, w) per
    tap of the zero-padded ``x``."""
    h, w = x.shape[-3:-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))  # pad W, then H, by 1
    g32 = g.float()
    taps = [
        torch.einsum("...bhwi,...bhwo->...io",
                     xp[..., dy:dy + h, dx:dx + w, :], g32)
        for dy in range(3) for dx in range(3)
    ]
    return torch.stack(taps, dim=-3).reshape(
        x.shape[:-4] + (3, 3, x.shape[-1], g.shape[-1]))


_KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


@locked_once
def _lib() -> ctypes.CDLL:
    lib = load_library("wgrad")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for suffix in _KERNEL_DTYPES.values():
        fn = getattr(lib, f"dls_wgrad_{suffix}")
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _check_cuda_inputs(x: torch.Tensor, g: torch.Tensor) -> str:
    """Raise on anything the kernel does not take; return the dtype
    suffix."""
    if x.device.type != "cuda" or g.device != x.device:
        raise ValueError(
            f"the wgrad kernel runs on CUDA tensors on one device, got "
            f"{x.device} and {g.device}"
        )
    if x.dtype not in _KERNEL_DTYPES or g.dtype != x.dtype:
        raise ValueError(
            f"the wgrad kernel takes bfloat16 or float32 x and g of one "
            f"dtype, got {x.dtype} and {g.dtype}"
        )
    if x.dim() not in (4, 5) or g.shape != x.shape:
        raise ValueError(
            f"expected x and g [B, H, W, C] or [N, B, H, W, C] of one shape, "
            f"got {tuple(x.shape)} and {tuple(g.shape)}"
        )
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("the wgrad kernel needs contiguous NHWC x and g")
    if x.numel() == 0:
        raise ValueError(f"empty wgrad input {tuple(x.shape)}")
    if x.shape[-1] % 8:
        raise ValueError(
            f"the wgrad kernel needs C a multiple of 8, got C={x.shape[-1]}"
        )
    if x[0].numel() >= 2**31 or x.shape[:-3].numel() >= 2**31:
        raise ValueError("the wgrad kernel indexes rows with 32-bit ints")
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("the wgrad kernel needs 16-byte aligned x and g")
    return _KERNEL_DTYPES[x.dtype]


def _raise_on_error(err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"wgrad kernel launch failed: cudaError {err} "
            f"({torch.cuda.get_device_name()})"
        )


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """The work of both kernels for one (N, B, H, W, C).

    Each client's K (its B*H*W positions) is cut into ``n_runs`` runs of
    whole row pairs (rows 2p, 2p + 1 of one sample; with H odd a sample's
    last pair has one row), balanced to within one pair: run ``i`` covers
    the image rows ``run_rows(i)`` of the client's B*H rows (a run may span
    samples, a pair never does, and no run spans clients). ``n_runs``
    depends on (B, H, W, C) alone. A stage of the tensor-core kernel is
    ``_SEG`` positions of one pair (``pieces_per_row`` per row, the last one
    ragged when ``_SEG`` does not divide W). Each run's partial is summed
    from zero, and a client's dW is ``((p_0 + p_1) + p_2) + ...``. The bf16
    kernel lays that work out by ``layout``, with the same bits: one CTA
    per (client, run, dy, tile) and a reduce (``FEW``), or one CTA per
    (client, dy, tile) that adds each finished run to a running total
    (``WALK``); the f32 kernel always takes ``FEW``."""

    n: int
    b: int
    h: int
    w: int
    c: int
    n_runs: int
    pieces_per_row: int
    c_tiles: int
    layout: int

    @property
    def pairs(self) -> int:
        """Row pairs per sample."""
        return -(-self.h // 2)

    def tc_grid(self, layout: int) -> tuple[int, int, int]:
        """bf16 kernel in ``layout``: (client [x run], dy, tile); a CTA
        computes taps (dy, 0..2)."""
        runs = self.n_runs if layout == FEW else 1
        return self.n * runs, 3, self.c_tiles**2

    @property
    def f32_grid(self) -> tuple[int, int, int]:
        """f32 kernel: (client x run, tap, tile)."""
        return self.n * self.n_runs, 9, self.c_tiles**2

    def partial_floats(self, layout: int) -> int:
        """Scratch floats of ``layout``: the per-run partials, or none when
        the CTAs write dW themselves (one run a client, or walking)."""
        if layout != FEW or self.n_runs == 1:
            return 0
        return self.n * self.n_runs * 9 * self.c * self.c

    def run_units(self, run: int) -> tuple[int, int]:
        """``[u0, u1)``: the row pairs of run ``run`` (csrc/wgrad.cu
        ``run_start``)."""
        total = self.b * self.pairs
        return (run * total // self.n_runs,
                (run + 1) * total // self.n_runs)

    def run_rows(self, run: int) -> tuple[int, int]:
        """``[r0, r1)``: the rows (``sample * H + h``) of run ``run``."""

        def first_row(unit: int) -> int:
            sample, pair = divmod(unit, self.pairs)
            return sample * self.h + 2 * pair

        u0, u1 = self.run_units(run)
        return first_row(u0), first_row(u1)


def chunking(b: int, h: int, w: int, c: int, n: int = 1) -> WgradPlan:
    """The plan of ``conv3x3_wgrad`` for ``x, g [N, B, H, W, C]`` (``n =
    1``: one client's ``[B, H, W, C]``). Every client's runs are those of
    one client (``_RUNS``, fewer when the client has under ``2 * _RUNS``
    row pairs); ``n`` only picks the bf16 layout."""
    c_tiles = -(-c // _TILE)
    if c_tiles**2 > 65535:
        raise ValueError(f"the wgrad kernel's grid takes C <= 16320, got {c}")
    units = b * -(-h // 2)
    n_runs = min(_RUNS, -(-units // _MIN_RUN_PAIRS))
    layout = FEW if n * 3 * c_tiles**2 < _WALK_CTAS else WALK
    return WgradPlan(n=n, b=b, h=h, w=w, c=c, n_runs=n_runs,
                     pieces_per_row=-(-w // _SEG), c_tiles=c_tiles,
                     layout=layout)


def _launch(x: torch.Tensor, g: torch.Tensor, layout: int | None = None
            ) -> torch.Tensor:
    """One launch on CUDA ``x, g``; ``layout`` forces the bf16 layout
    (None: the plan's; every layout gives the same bits)."""
    suffix = _check_cuda_inputs(x, g)
    lead, (b, h, w, c) = tuple(x.shape[:-4]), tuple(x.shape[-4:])
    n = x.shape[0] if lead else 1
    plan = chunking(b, h, w, c, n)
    if suffix == "f32":
        layout = FEW
    elif layout is None:
        layout = plan.layout
    out = torch.empty(lead + (3, 3, c, c), dtype=torch.float32,
                      device=x.device)
    partial = out
    if plan.partial_floats(layout):
        partial = torch.empty(plan.partial_floats(layout),
                              dtype=torch.float32, device=x.device)
    fn = getattr(_lib(), f"dls_wgrad_{suffix}")
    # The library encodes its TMA tensor maps and launches on the current
    # device: x's.
    with device_guard(x):
        err = fn(
            x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, b, h, w, c, plan.n_runs, layout, launch_stream(x),
        )
    _raise_on_error(err)
    count_launch(conv3x3_wgrad, x.device)
    return out


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dW [3, 3, C, C]`` f32 (HWIO) of a 3x3 stride-1 SAME convolution
    with NHWC input ``x`` and output gradient ``g`` (``[N, 3, 3, C, C]``
    for N clients' ``[N, B, H, W, C]``): each client's row bitwise its
    one-client call's."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, g)
    return _launch(x, g)


conv3x3_wgrad.launches = 0
conv3x3_wgrad.launches_by_device = {}


def reset_launch_counts() -> None:
    conv3x3_wgrad.launches = 0
    conv3x3_wgrad.launches_by_device = {}


@torch.library.custom_op("dls::conv3x3_wgrad", mutates_args=())
def conv3x3_wgrad_op(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """:func:`conv3x3_wgrad` as a custom op (no autograd of its own: the
    model's convolution calls it inside its backward, under no_grad)."""
    return conv3x3_wgrad(x.contiguous(), g.contiguous())


@conv3x3_wgrad_op.register_fake
def _(x, g):
    return x.new_empty(tuple(x.shape[:-4]) + (3, 3, x.shape[-1], g.shape[-1]),
                       dtype=torch.float32)


def _wgrad_vmap(info, in_dims, x, g):
    """The vmapped dim becomes the kernel's client axis: one launch for the
    chunk. An unbatched operand is broadcast over it."""
    if (x.dim() if in_dims[0] is None else x.dim() - 1) != 4:
        raise ValueError("conv3x3_wgrad's vmap rule takes one client's "
                         "[B, H, W, C] per vmapped row")
    x, g = (models_first(t, d, info.batch_size).contiguous()
            for t, d in zip((x, g), in_dims[:2]))
    return conv3x3_wgrad_op(x, g), 0


torch.library.register_vmap("dls::conv3x3_wgrad", _wgrad_vmap)
