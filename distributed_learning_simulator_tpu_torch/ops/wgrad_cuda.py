"""Weight gradient of ResNet's stage-1 3x3 convolutions: the hand-written
Hopper kernel and its plain version.

Counterpart of ``scripts/exp_pallas_wgrad.py`` ``pallas_wgrad`` (its
``_wgrad_kernel``), the TPU prototype written to replace XLA's autodiff
weight gradient of exactly these convolutions:

    dW[dy, dx, ci, co] = sum_{b, h, w} x_pad[b, h + dy, w + dx, ci]
                                       * g[b, h, w, co]

for a 3x3, stride-1, SAME (zero padding 1) convolution, ``x`` its NHWC
input, ``g`` the gradient of its NHWC output, ``dW`` ``[3, 3, C, C]`` f32
(HWIO). The prototype worked on a W-folded layout (a TPU lane device); the
port keeps the plain NHWC layout, so the kernel is written from the formula
above, not block by block (csrc/wgrad.cu says how).

:func:`conv3x3_wgrad` launches ``wgrad_partial_kernel`` and
``wgrad_reduce_kernel`` (csrc/wgrad.cu) on CUDA tensors, bf16 or f32,
``C % 8 == 0``, any B, H, W. :func:`conv3x3_wgrad_plain` is the same
function in plain PyTorch (nine shifted contractions in f32).

Dispatch rule: a tensor on the CPU takes the plain version (that is how the
tests run); a CUDA tensor launches the kernel or raises. There is no
fallback from the kernel to the plain version. ``conv3x3_wgrad.launches``
counts the wrapper's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu_torch.ops._build import load_library

_ROWS = 32  # csrc/wgrad.cu kRows: K rows a block stages per step
_CHUNKS = 64  # K chunks to aim for: with 9 taps, ~4 blocks per SM


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dW [3, 3, C, C]`` f32 from ``x, g [B, H, W, C]``: one f32
    contraction over (b, h, w) per tap of the zero-padded ``x``."""
    _, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))  # pad W, then H, by 1
    g32 = g.float()
    taps = [
        torch.einsum("bhwi,bhwo->io", xp[:, dy:dy + h, dx:dx + w], g32)
        for dy in range(3) for dx in range(3)
    ]
    return torch.stack(taps).reshape(3, 3, x.shape[3], g.shape[3])


_KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


@functools.lru_cache(maxsize=None)
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
    if x.dim() != 4 or g.shape != x.shape:
        raise ValueError(
            f"expected x and g [B, H, W, C] of one shape, got "
            f"{tuple(x.shape)} and {tuple(g.shape)}"
        )
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("the wgrad kernel needs contiguous NHWC x and g")
    if x.numel() == 0:
        raise ValueError(f"empty wgrad input {tuple(x.shape)}")
    if x.shape[3] % 8:
        raise ValueError(
            f"the wgrad kernel needs C a multiple of 8, got C={x.shape[3]}"
        )
    if x.numel() >= 2**31:
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


def chunking(k_total: int) -> tuple[int, int]:
    """``(rows_per_block, n_chunks)`` for ``k_total = B*H*W`` rows: about
    ``_CHUNKS`` chunks, each a whole number of staged row tiles."""
    per = -(-k_total // _CHUNKS)
    per = -(-per // _ROWS) * _ROWS
    return per, -(-k_total // per)


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dW [3, 3, C, C]`` f32 (HWIO) of a 3x3 stride-1 SAME convolution
    with NHWC input ``x`` and output gradient ``g``."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, g)
    suffix = _check_cuda_inputs(x, g)
    b, h, w, c = x.shape
    rows_per_block, n_chunks = chunking(b * h * w)
    partial = torch.empty(n_chunks * 9 * c * c, dtype=torch.float32,
                          device=x.device)
    out = torch.empty((3, 3, c, c), dtype=torch.float32, device=x.device)
    fn = getattr(_lib(), f"dls_wgrad_{suffix}")
    err = fn(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
        b, h, w, c, rows_per_block, n_chunks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on_error(err)
    conv3x3_wgrad.launches += 1
    return out


conv3x3_wgrad.launches = 0


def reset_launch_counts() -> None:
    conv3x3_wgrad.launches = 0
