"""Aggregation over the client axis (ops/aggregate.py in the JAX package)."""

from __future__ import annotations

import torch


def weighted_mean(stacked: torch.Tensor, weights) -> torch.Tensor:
    """Weighted average over the leading (client) axis of ``stacked``.

    ``weights`` is ``[n_clients]`` (e.g. per-client dataset sizes); they are
    normalized internally in f32, and all-zero weights give zeros rather
    than NaN (the caller decides the fallback). As in the JAX function the
    normalized weights are cast to the stack's dtype before the contraction.
    """
    w = torch.as_tensor(weights, dtype=torch.float32, device=stacked.device)
    w = w / torch.clamp(w.sum(), min=1e-12)
    return torch.tensordot(w.to(stacked.dtype), stacked, dims=([0], [0]))
