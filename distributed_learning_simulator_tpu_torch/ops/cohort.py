"""Per-row gather over the client axis (ops/cohort.py ``batched_take`` of
the JAX package)."""

from __future__ import annotations

import torch


def batched_take(stacked: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[c] = stacked[c, idx[c]]``: ``stacked [C, S, ...]`` and ``idx
    [C, B]`` give ``[C, B, ...]``, each client's own minibatch rows."""
    rows = torch.arange(stacked.shape[0], device=stacked.device)[:, None]
    return stacked[rows, idx.to(stacked.device)]
