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

:func:`conv3x3_wgrad` launches a partial kernel and ``wgrad_reduce_kernel``
(csrc/wgrad.cu) on CUDA tensors, bf16 or f32, ``C % 8 == 0``, any N, B, H,
W: bf16 inputs take ``wgrad_tc_partial_kernel`` (tensor cores), f32 inputs
``wgrad_f32_partial_kernel`` (CUDA cores, no TF32). :func:`chunking` plans
both grids; a one-client call may be handed the plan of a batched call, and
then gives bitwise that client's row of the batched result.
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
# K-chunks per tap row dy for one client: 3 x 44 = 132 tensor-core CTAs,
# one per SM of an H100, each with the same number of row pairs (within
# one). N clients share them: 44 // N chunks each, at least one.
_CHUNKS = 132 // 3
_MIN_CHUNK_PAIRS = 2  # smaller problems take fewer, fuller chunks


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
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
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
    """The grids of both partial kernels for one (N, B, H, W, C).

    Each client's K (its B*H*W positions) is cut into ``n_chunks`` runs of
    whole row pairs (rows 2p, 2p + 1 of one sample; with H odd a sample's
    last pair has one row), balanced to within one pair: chunk ``i`` covers
    the image rows ``chunk_rows(i)`` of the client's B*H rows (a run may
    span samples, a pair never does, and no run spans clients). A stage of
    the tensor-core kernel is ``_SEG`` positions of one pair
    (``pieces_per_row`` per row, the last one ragged when ``_SEG`` does not
    divide W). Both kernels write one ``[C, C]`` f32 partial per (client,
    chunk, tap), straight into dW when ``n_chunks`` is 1. A plan made for N
    clients may be given to a one-client call (``n`` is then ignored): the
    client's CTAs do the same work in the same order either way."""

    n: int
    b: int
    h: int
    w: int
    c: int
    n_chunks: int
    pieces_per_row: int
    c_tiles: int

    @property
    def pairs(self) -> int:
        """Row pairs per sample."""
        return -(-self.h // 2)

    @property
    def tc_grid(self) -> tuple[int, int, int]:
        """bf16 kernel: (client x chunk, dy, tile); a CTA computes taps
        (dy, 0..2)."""
        return self.n * self.n_chunks, 3, self.c_tiles**2

    @property
    def f32_grid(self) -> tuple[int, int, int]:
        """f32 kernel: (client x chunk, tap, tile)."""
        return self.n * self.n_chunks, 9, self.c_tiles**2

    @property
    def partial_floats(self) -> int:
        """Partial floats the partial kernel writes: into a scratch buffer,
        or with one chunk a client straight into dW."""
        return self.n * self.n_chunks * 9 * self.c * self.c

    def chunk_units(self, chunk: int) -> tuple[int, int]:
        """``[u0, u1)``: the row pairs of chunk ``chunk`` (csrc/wgrad.cu
        ``chunk_units``)."""
        total = self.b * self.pairs
        return (chunk * total // self.n_chunks,
                (chunk + 1) * total // self.n_chunks)

    def chunk_rows(self, chunk: int) -> tuple[int, int]:
        """``[r0, r1)``: the rows (``sample * H + h``) of chunk ``chunk``."""

        def first_row(unit: int) -> int:
            sample, pair = divmod(unit, self.pairs)
            return sample * self.h + 2 * pair

        u0, u1 = self.chunk_units(chunk)
        return first_row(u0), first_row(u1)


def chunking(b: int, h: int, w: int, c: int, n: int = 1) -> WgradPlan:
    """The grid plan of ``conv3x3_wgrad`` for ``x, g [N, B, H, W, C]``
    (``n = 1``: one client's ``[B, H, W, C]``). The clients share the
    card's 132 SMs: ``_CHUNKS // n`` chunks each, so from 44 clients on one
    chunk a client and no partials at all."""
    c_tiles = -(-c // _TILE)
    if c_tiles**2 > 65535:
        raise ValueError(f"the wgrad kernel's grid takes C <= 16320, got {c}")
    units = b * -(-h // 2)
    n_chunks = min(max(1, _CHUNKS // n), -(-units // _MIN_CHUNK_PAIRS))
    return WgradPlan(n=n, b=b, h=h, w=w, c=c, n_chunks=n_chunks,
                     pieces_per_row=-(-w // _SEG), c_tiles=c_tiles)


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor,
                  plan: WgradPlan | None = None) -> torch.Tensor:
    """``dW [3, 3, C, C]`` f32 (HWIO) of a 3x3 stride-1 SAME convolution
    with NHWC input ``x`` and output gradient ``g`` (``[N, 3, 3, C, C]``
    for N clients' ``[N, B, H, W, C]``). ``plan`` overrides the planned
    grid's chunking (its B, H, W, C must be the input's): a one-client call
    given a batched call's plan computes that client's row bitwise as the
    batched call does."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, g)
    suffix = _check_cuda_inputs(x, g)
    lead, (b, h, w, c) = tuple(x.shape[:-4]), tuple(x.shape[-4:])
    n = x.shape[0] if lead else 1
    if plan is None:
        plan = chunking(b, h, w, c, n)
    elif (plan.b, plan.h, plan.w, plan.c) != (b, h, w, c):
        raise ValueError(f"a wgrad plan for {(plan.b, plan.h, plan.w, plan.c)}"
                         f" given x of shape {tuple(x.shape)}")
    out = torch.empty(lead + (3, 3, c, c), dtype=torch.float32,
                      device=x.device)
    partial = out
    if plan.n_chunks > 1:
        partial = torch.empty(n * plan.n_chunks * 9 * c * c,
                              dtype=torch.float32, device=x.device)
    fn = getattr(_lib(), f"dls_wgrad_{suffix}")
    # The library encodes its TMA tensor maps and launches on the current
    # device: x's.
    with device_guard(x):
        err = fn(
            x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, b, h, w, c, plan.n_chunks, launch_stream(x),
        )
    _raise_on_error(err)
    count_launch(conv3x3_wgrad, x.device)
    return out


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
