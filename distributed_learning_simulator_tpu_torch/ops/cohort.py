"""Gather and scatter over the client axis (ops/cohort.py of the JAX
package): a cohort's rows of a client-stacked tensor, writing them back,
and each client's own minibatch rows."""

from __future__ import annotations

import torch


def cohort_take(stacked, idx):
    """Rows ``idx`` of ``stacked`` along axis 0 (None passes through)."""
    if stacked is None:
        return None
    return stacked[torch.as_tensor(idx, dtype=torch.long,
                                   device=stacked.device)]


def cohort_scatter(stacked, idx, update):
    """``stacked`` with rows ``idx`` replaced by ``update`` (a new tensor;
    the other rows keep their values). ``idx`` must be duplicate-free, as a
    cohort drawn without replacement is. None passes through."""
    if stacked is None:
        return None
    out = stacked.clone()
    out[torch.as_tensor(idx, dtype=torch.long, device=stacked.device)] = (
        update
    )
    return out


def batched_take(stacked: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[c] = stacked[c, idx[c]]``: ``stacked [C, S, ...]`` and ``idx
    [C, B]`` give ``[C, B, ...]``, each client's own minibatch rows."""
    rows = torch.arange(stacked.shape[0], device=stacked.device)[:, None]
    return stacked[rows, idx.to(stacked.device)]
