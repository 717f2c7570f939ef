"""Device memory watermark: the ONE memory probe (telemetry/memory.py of
the JAX package).

On a CUDA device the numbers come from PyTorch's caching allocator: the
peak is ``torch.cuda.max_memory_allocated`` (bytes held by tensors at the
high-water mark, since the process started or the last
``reset_peak_memory_stats``), the limit is the card's memory as
``torch.cuda.mem_get_info`` reports it. On the CPU every function returns
None, as the JAX probe does there. The round loop's per-round watermark and
the chunk auto-sizer's budget both go through here.
"""

from __future__ import annotations

import torch


def _cuda_device(device):
    """``device`` as a CUDA ``torch.device`` (None: the current CUDA
    device), or None when it is not a CUDA device or no card is present."""
    if not torch.cuda.is_available():
        return None
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_memory_stats(device=None) -> dict | None:
    """The allocator's raw ``torch.cuda.memory_stats`` of ``device``
    (default: the current CUDA device), or None on the CPU."""
    device = _cuda_device(device)
    if device is None:
        return None
    try:
        stats = torch.cuda.memory_stats(device)
    except Exception:  # noqa: BLE001 - a probe, never a failure
        return None
    return dict(stats) if stats else None


def peak_hbm_bytes(device=None) -> int | None:
    """High-water mark of device memory held by tensors, or None on the
    CPU. Cumulative since the process started (or the last peak reset), so
    per-round samples are monotone and the run's watermark is the last
    round's."""
    device = _cuda_device(device)
    if device is None:
        return None
    peak = torch.cuda.max_memory_allocated(device)
    return int(peak) if peak else None


def hbm_limit_bytes(device=None) -> int | None:
    """The card's memory (``torch.cuda.mem_get_info``'s total), or None on
    the CPU. Feeds the chunk auto-sizer's budget (simulator.py)."""
    device = _cuda_device(device)
    if device is None:
        return None
    return int(torch.cuda.mem_get_info(device)[1])
