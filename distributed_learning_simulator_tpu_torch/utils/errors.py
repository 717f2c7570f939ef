"""Error classification (utils/errors.py of the JAX package)."""

from __future__ import annotations

import torch

#: Lowercased phrases of the allocation failures CUDA, cuBLAS and cuDNN
#: report through a RuntimeError rather than torch.OutOfMemoryError.
_OOM_PHRASES = (
    "out of memory",
    "cublas_status_alloc_failed",
    "cudnn_status_alloc_failed",
    "cudnn_status_not_enough_workspace",
    "cudaerrormemoryallocation",
)


def is_device_oom(e: BaseException) -> bool:
    """True when ``e`` is a device allocation failure: a
    ``torch.OutOfMemoryError``, or a RuntimeError whose text says a CUDA,
    cuBLAS or cuDNN allocation failed. The one classifier of the round
    hint (simulator ``_oom_hint``) and the Shapley evaluator's hint."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    if not isinstance(e, RuntimeError):
        return False
    text = str(e).lower()
    return any(p in text for p in _OOM_PHRASES)
