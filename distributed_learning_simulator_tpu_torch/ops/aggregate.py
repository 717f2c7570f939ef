"""Aggregation over the client axis (ops/aggregate.py in the JAX package).

The port keeps each model as one flat vector, so a client stack is one
``[n_clients, P]`` tensor. The JAX functions work leaf by leaf on a pytree;
every rule here is per coordinate (or, for Krum, over the concatenated
leaves), so the flat form computes the same function.

* :func:`weighted_mean`: the dataset-size-weighted FedAvg mean.
* The robust rules on the materializing path (config.aggregation):
  :func:`coordinate_median`, :func:`trimmed_mean` (:func:`trim_count`),
  :func:`krum`, and the :func:`aggregate` dispatcher.
* The Shapley helpers: :func:`subset_weighted_mean` (a subset's model as a
  0/1 mask's weighted mean, the previous global model for an empty one),
  :func:`block_prefix_cumsum` and :func:`prefix_means_from_cumsum` (GTG's
  running prefix sums), :func:`subset_masks_all` (the powerset).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.ops.cohort import to_device


def weighted_mean(stacked: torch.Tensor, weights) -> torch.Tensor:
    """Weighted average over the leading (client) axis of ``stacked``.

    ``weights`` is ``[n_clients]`` (e.g. per-client dataset sizes); they are
    normalized internally in f32, and all-zero weights give zeros rather
    than NaN (the caller decides the fallback). As in the JAX function the
    normalized weights are cast to the stack's dtype before the contraction.
    """
    w = to_device(weights, stacked.device, torch.float32)
    w = w / torch.clamp(w.sum(), min=1e-12)
    return torch.tensordot(w.to(stacked.dtype), stacked, dims=([0], [0]))


def _valid_mask(weights, device) -> torch.Tensor:
    """Participation mask ``weights > 0``; an all-zero cohort counts every
    client (the statistic then degrades to the unmasked one)."""
    valid = to_device(weights, device, torch.float32) > 0
    return valid | ~valid.any()


def coordinate_median(stacked: torch.Tensor, weights=None) -> torch.Tensor:
    """Coordinate-wise median over the client axis, ignoring NaN (a
    diverged client does not poison the aggregate). Zero-weight clients
    are masked out of the statistic. Midpoint of the two middle values at
    an even count, ``(lo + hi) * 0.5`` in f32, as ``jnp.nanmedian``."""
    xf = stacked.float()
    if weights is not None:
        valid = _valid_mask(weights, stacked.device)
        xf = torch.where(valid[:, None], xf, torch.nan)
    s, _ = torch.sort(xf, dim=0)  # NaN sorts last
    counts = (~torch.isnan(s)).sum(dim=0, dtype=torch.float32)
    q = 0.5 * (counts - 1.0)
    last = counts - 1.0
    lo = torch.clamp(torch.minimum(torch.floor(q), last), min=0.0).long()
    hi = torch.clamp(torch.minimum(torch.ceil(q), last), min=0.0).long()
    lo_v = torch.gather(s, 0, lo[None]).squeeze(0)
    hi_v = torch.gather(s, 0, hi[None]).squeeze(0)
    return ((lo_v + hi_v) * 0.5).to(stacked.dtype)


_TRIM_SCALE = 10_000  # trim ratios quantized to 1e-4 (see trim_count)


def trim_count(m: int, trim_ratio: float) -> int:
    """``floor(m * trim_ratio)`` with the ratio floored to 1e-4, in integer
    math, so every site trims the same count for the same configuration."""
    q = int(trim_ratio * _TRIM_SCALE)
    return (int(m) * q) // _TRIM_SCALE


def trimmed_mean(stacked: torch.Tensor, trim_ratio: float,
                 weights=None) -> torch.Tensor:
    """Coordinate-wise trimmed mean: drop the k lowest and k highest values
    per coordinate (k = trim_count(m, trim_ratio), at least 1 when a ratio
    was asked for and the window survives), average the rest. With
    ``weights`` only clients of positive weight count (m of them); NaN
    uploads sort into the trimmed top region."""
    n = stacked.shape[0]
    if not 0.0 <= trim_ratio < 0.5:
        raise ValueError(f"trim_ratio {trim_ratio} removes all {n} clients")
    xf = stacked.float()
    if weights is None:
        k = trim_count(n, trim_ratio)
        if trim_ratio > 0.0:
            k = min(max(k, 1), (n - 1) // 2)
        s, _ = torch.sort(xf, dim=0)
        kept = s[k:n - k] if k else s
        return kept.mean(dim=0).to(stacked.dtype)
    valid = _valid_mask(weights, stacked.device)
    m = int(valid.sum())
    k = trim_count(m, trim_ratio)
    if trim_ratio > 0.0:
        k = min(max(k, 1), max((m - 1) // 2, 0))
    s, _ = torch.sort(torch.where(valid[:, None], xf, torch.nan), dim=0)
    kept_sum = s[k:m - k].sum(dim=0)
    return (kept_sum / (m - 2 * k)).to(stacked.dtype)


def krum(stacked: torch.Tensor, n_byzantine: int = 0,
         weights=None) -> torch.Tensor:
    """Krum (Blanchard et al.): the single client update closest to its
    n - f - 2 nearest neighbours. Non-finite uploads and zero-weight
    clients are masked out of the candidates and of everyone's neighbour
    lists with a large finite distance. Returns the selected row."""
    return stacked[krum_select(stacked, n_byzantine, weights)]


def krum_select(stacked: torch.Tensor, n_byzantine: int = 0,
                weights=None) -> int:
    """The index :func:`krum` selects."""
    n = stacked.shape[0]
    if n < 2 * n_byzantine + 3:
        raise ValueError(
            f"krum needs n >= 2f + 3 clients (n={n}, assumed Byzantine "
            f"f={n_byzantine}); lower trim_ratio or add clients"
        )
    x = stacked.reshape(n, -1).float()
    bad = ~torch.isfinite(x).all(dim=1)
    if weights is not None:
        w = to_device(weights, x.device, torch.float32)
        bad = bad | (w <= 0.0)
    x = torch.nan_to_num(x, nan=0.0)
    sq = (x * x).sum(dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0)
    big = torch.full((), 1e30, dtype=torch.float32, device=x.device)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d2 = torch.where(bad[:, None] | bad[None, :] | eye, big, d2)
    k = max(1, min(n - n_byzantine - 2, n - 1))
    nearest, _ = torch.sort(d2, dim=1)
    scores = nearest[:, :k].sum(dim=1) + bad.float() * big * n
    return int(torch.argmin(scores))


def aggregate(stacked: torch.Tensor, weights, rule: str,
              trim_ratio: float = 0.1) -> torch.Tensor:
    """Dispatch over the aggregation rules. For ``krum``, ``trim_ratio``
    doubles as the assumed Byzantine fraction (f = trim_count(n, ratio))."""
    rule = rule.lower()
    if rule == "median":
        return coordinate_median(stacked, weights=weights)
    if rule == "trimmed_mean":
        return trimmed_mean(stacked, trim_ratio, weights=weights)
    if rule == "krum":
        n = stacked.shape[0]
        return krum(stacked, n_byzantine=trim_count(n, trim_ratio),
                    weights=weights)
    if rule == "mean":
        return weighted_mean(stacked, weights)
    raise ValueError(
        f"unknown aggregation {rule!r}; known: mean, median, trimmed_mean, "
        "krum"
    )


def subset_weighted_mean(stacked: torch.Tensor, weights, masks,
                         fallback: torch.Tensor) -> torch.Tensor:
    """The models of a batch of client subsets: ``masks`` ``[M, n]`` 0/1
    (or one ``[n]`` mask) over the stack ``[n, P]``. Each row is the
    mask-weighted mean in f32 (f32 weights, the stack's values in f32),
    or ``fallback`` (the previous global model) for an empty subset.
    One ``[M, n] @ [n, P]`` product forms every model of the batch."""
    single = torch.as_tensor(masks).dim() == 1
    dev = stacked.device
    w = to_device(weights, dev, torch.float32)
    m = to_device(masks, dev, torch.float32).reshape(
        -1, stacked.shape[0])
    mw = m * w
    total = mw.sum(dim=1)
    nonempty = total > 0
    norm = mw / torch.where(nonempty, total, torch.ones_like(total))[:, None]
    avg = norm @ stacked.float()
    out = torch.where(nonempty[:, None], avg, fallback.float()[None])
    return out[0] if single else out


def block_prefix_cumsum(stacked: torch.Tensor, weights, perm_block,
                        carry=None, carry_total=None):
    """Weighted running sums over a block of permutation positions (GTG's
    ``gtg_prefix_mode='cumsum'``). ``perm_block`` ``[G, B]`` holds, for G
    permutations, the clients at walk positions ``[j0, j0+B)``; ``carry``
    ``[G, P]`` / ``carry_total`` ``[G]`` (f32) the sums over ``[0, j0)``
    (None: the block starts the walk). Returns ``(cs [G, B, P], totals
    [G, B])`` in f32: ``cs[g, b]`` sums ``w[c] * x[c]`` over the first
    ``j0 + b + 1`` clients of permutation g."""
    dev = stacked.device
    idx = to_device(perm_block, dev, torch.long)
    w = to_device(weights, dev, torch.float32)[idx]
    totals = torch.cumsum(w, dim=1)
    if carry_total is not None:
        totals = totals + carry_total[:, None]
    cs = torch.cumsum(stacked[idx].float() * w[..., None], dim=1)
    if carry is not None:
        cs = cs + carry[:, None]
    return cs, totals


def prefix_means_from_cumsum(cs: torch.Tensor, totals: torch.Tensor,
                             fallback: torch.Tensor) -> torch.Tensor:
    """Prefix models from running sums: ``cs / total`` where the prefix
    carries weight, ``fallback`` (the previous global model) where it does
    not. ``[G, B, P]`` f32."""
    nonempty = totals > 0
    safe = torch.where(nonempty, totals, torch.ones_like(totals))
    avg = cs / safe[..., None]
    return torch.where(nonempty[..., None], avg, fallback.float())


def subset_masks_all(n_clients: int, include_empty: bool = True) -> np.ndarray:
    """All subset masks as a ``[2^N, N]`` f32 0/1 array, sorted by (size,
    lexicographic), the empty subset first."""
    ids = list(range(n_clients))
    rows = []
    for r in range(0 if include_empty else 1, n_clients + 1):
        for combo in itertools.combinations(ids, r):
            row = np.zeros((n_clients,), dtype=np.float32)
            row[list(combo)] = 1.0
            rows.append(row)
    return np.stack(rows)
