"""Gather and scatter over the client axis (ops/cohort.py of the JAX
package): a cohort's rows of a client-stacked tensor, writing them back,
and each client's own minibatch rows.

Per-client state is a tensor or a dict of tensors (Adam's count and
moments), each with the clients on its leading axis; :func:`tree_map`
applies a function leaf by leaf, as ``jax.tree_util.tree_map`` does."""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tensor or a dict of tensors (and the
    matching leaves of ``rest``); None passes through."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def to_device(x, device, dtype=None) -> torch.Tensor:
    """``x`` (a host array, list or tensor) as a tensor on ``device``. A
    host value bound for a card goes through pinned memory as an
    asynchronous copy, so that a round never waits on the card for its
    index and weight vectors (a plain copy from pageable memory
    synchronizes)."""
    t = torch.as_tensor(x, dtype=dtype)
    if device is None:
        return t
    device = torch.device(device)
    if device.type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    return t.contiguous().pin_memory().to(device, non_blocking=True)


def _index(idx, t: torch.Tensor) -> torch.Tensor:
    return to_device(idx, t.device, torch.long)


def cohort_take(stacked, idx):
    """Rows ``idx`` of ``stacked`` along axis 0 (None passes through)."""
    return tree_map(lambda t: t[_index(idx, t)], stacked)


def cohort_scatter(stacked, idx, update):
    """``stacked`` with rows ``idx`` replaced by ``update`` (a new tensor;
    the other rows keep their values). ``idx`` must be duplicate-free, as a
    cohort drawn without replacement is. None passes through."""

    def scatter(t, u):
        out = t.clone()
        out[_index(idx, t)] = u
        return out

    return tree_map(scatter, stacked, update)


def set_rows(stacked, idx, update) -> None:
    """Write ``update`` into rows ``idx`` of ``stacked`` in place."""

    def write(t, u):
        t[_index(idx, t)] = u

    tree_map(write, stacked, update)


def batched_take(stacked: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[c] = stacked[c, idx[c]]``: ``stacked [C, S, ...]`` and ``idx
    [C, B]`` give ``[C, B, ...]``, each client's own minibatch rows."""
    rows = torch.arange(stacked.shape[0], device=stacked.device)[:, None]
    return stacked[rows, to_device(idx, stacked.device)]
