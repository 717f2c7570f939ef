"""What the custom ops' vmap rules share (ops/gn_cuda.py, ops/wgrad_cuda.py,
ops/conv.py)."""

from __future__ import annotations

import torch


def models_first(t: torch.Tensor, bdim, size: int) -> torch.Tensor:
    """``t`` with its vmapped dim (the models) moved to dim 0, or, when it
    has none (an operand shared by every model), broadcast to ``size``
    models there: a view either way."""
    if bdim is None:
        return t.expand((size,) + tuple(t.shape))
    return t.movedim(bdim, 0)
