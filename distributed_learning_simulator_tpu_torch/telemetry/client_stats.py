"""Per-client training statistics computed inside the round
(telemetry/client_stats.py of the JAX package).

* :class:`ClientStats` is built from the config (``client_stats='off'``
  gives None, and every call site branches on that when the round function
  is built: the default run is the pre-feature run, the same draws and the
  same arithmetic).
* Per client the round computes a compact f32 stats vector
  (:data:`STAT_FIELDS`): the local loss before and after the local run, the
  L2 norm of the uploaded update, the root of the mean per-step squared
  gradient norm, the cosine of the client's update against the aggregate's
  over a strided probe, and the count of non-finite uploaded elements. All
  of it comes from streaming per-chunk reductions on the device — O(1)
  scalars and a ``client_stats_probe``-coordinate probe per client — so the
  mean path never holds the ``[N, P]`` stack. The ``[N, S]`` matrix is
  fetched once per ``client_stats_every`` rounds, inside the round's one
  metric fetch.
* The port keeps a model as one flat vector in the JAX tree's leaf order
  (models/registry.py ``ParamLayout``), so the probe strides each leaf's
  segment as the JAX package strides each leaf: the same coordinates.
* Host side, :func:`detect_anomalies` is the median/MAD outlier detector
  and :func:`client_stats_record` builds the ``client_stats`` sub-object of
  a schema-v3 record; both are the JAX package's, numpy only, shared by the
  vmap path and the threaded oracle.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.config import (
    CLIENT_STATS_LEVELS,
)
from distributed_learning_simulator_tpu_torch.ops.cohort import to_device

#: Column order of the per-client ``[N, S]`` stats matrix. Fields an
#: execution path cannot produce (the threaded oracle's workers report no
#: losses) are NaN and render as null in the record.
STAT_FIELDS = (
    "loss_before",      # first-step local loss (global params, 1st batch)
    "loss_after",       # final-epoch mean local loss
    "update_norm",      # L2 norm of the uploaded delta (post-corruption)
    "grad_norm",        # sqrt(mean per-step squared gradient L2 norm)
    "agg_cosine",       # cos(client delta, aggregate delta) over the probe
    "nonfinite_count",  # non-finite elements in the upload (exact count)
)

_IDX = {name: i for i, name in enumerate(STAT_FIELDS)}

#: Cohorts up to this size get raw per-client values in the record.
PER_CLIENT_CAP = 32

#: Quantiles summarizing each stat column in the record.
_QUANTILES = (0, 25, 50, 75, 100)

#: Elements of the f32 upload-delta temporary per slice of a chunk's rows.
_SLICE_ELEMENTS = 1 << 26


@functools.lru_cache(maxsize=16)
def _probe_index(numels: tuple, stride: int, device: str) -> torch.Tensor:
    """Flat positions of the probe: every ``stride``-th element of each
    leaf's segment, from the segment's start (``leaf.reshape(-1)[::stride]``
    per leaf, concatenated in leaf order)."""
    starts = np.concatenate([[0], np.cumsum(numels)[:-1]]).astype(np.int64)
    idx = np.concatenate([s + np.arange(0, n, stride, dtype=np.int64)
                          for s, n in zip(starts, numels)])
    return to_device(idx, device)


@dataclass(frozen=True)
class ClientStats:
    """Client-statistics settings; the per-round reductions are pure
    functions of the round's tensors."""

    every: int = 1
    probe: int = 4096
    mad_threshold: float = 8.0

    @classmethod
    def from_config(cls, config) -> "ClientStats | None":
        """None when ``client_stats='off'``."""
        level = (getattr(config, "client_stats", "off") or "off").lower()
        if level == "off":
            return None
        if level not in CLIENT_STATS_LEVELS:
            raise ValueError(
                f"unknown client_stats {level!r}; known: "
                + ", ".join(CLIENT_STATS_LEVELS)
            )
        return cls(
            every=int(getattr(config, "client_stats_every", 1)),
            probe=int(getattr(config, "client_stats_probe", 4096)),
            mad_threshold=float(
                getattr(config, "client_stats_mad_threshold", 8.0)
            ),
        )

    def fetch_round(self, round_idx: int) -> bool:
        """Whether this round's stats are fetched to the host (the device
        computes them every round)."""
        return round_idx % self.every == 0

    # ---- device-side streaming reductions ---------------------------------
    def _index(self, numels, device) -> torch.Tensor:
        numels = tuple(int(n) for n in numels)
        stride = max(1, sum(numels) // max(self.probe, 1))
        return _probe_index(numels, stride, str(device))

    def probe_size(self, numels) -> int:
        """Coordinates in the probe of a model with leaves of ``numels``."""
        return int(self._index(numels, "cpu").numel())

    def probe_delta(self, base_flat, new_flat, numels) -> torch.Tensor:
        """``[K]`` strided probe of ``new - base`` (one flat model, leaves
        of sizes ``numels``): the coordinates :meth:`add_upload_stats`
        samples."""
        idx = self._index(numels, base_flat.device)
        return new_flat.float()[idx] - base_flat.float()[idx]

    def add_upload_stats(self, train_metrics: dict, global_flat, stacked,
                         numels) -> dict:
        """Fold per-client upload statistics of an ``[M, P]`` chunk of
        uploads into the train-metrics dict: ``update_sq`` and
        ``nonfinite_count`` ``[M]``, ``stat_probe`` ``[M, K]``. Called once
        per chunk on the mean paths (scalars and the probe, never the
        stack) and per chunk of the stack on the materializing path, after
        fault corruption: the stats describe what the server received."""
        base = global_flat.float()
        sq, nonfinite = [], []
        # A few rows at a time, so the f32 delta temporary stays bounded.
        step = max(1, _SLICE_ELEMENTS // max(1, stacked.shape[1]))
        for r in range(0, stacked.shape[0], step):
            rows = stacked[r:r + step]
            d = rows.float() - base
            sq.append((d * d).sum(dim=1))
            nonfinite.append((~torch.isfinite(rows)).sum(dim=1).float())
        sq, nonfinite = torch.cat(sq), torch.cat(nonfinite)
        idx = self._index(numels, stacked.device)
        out = dict(train_metrics)
        out["update_sq"] = sq
        out["nonfinite_count"] = nonfinite
        out["stat_probe"] = stacked[:, idx].float() - base[idx]
        return out

    def stats_matrix(self, train_metrics: dict, agg_probe) -> torch.Tensor:
        """The ``[N, S]`` stats matrix (:data:`STAT_FIELDS` order) from the
        collected per-client metrics and the aggregate-delta probe; a loss
        or gradient column the path cannot produce is NaN."""
        probe = train_metrics["stat_probe"].float()
        agg_probe = agg_probe.float()
        n = probe.shape[0]
        nan = torch.full((n,), float("nan"), dtype=torch.float32,
                         device=probe.device)
        dots = probe @ agg_probe
        denom = (torch.linalg.vector_norm(probe, dim=1)
                 * torch.linalg.vector_norm(agg_probe) + 1e-12)
        grad_sq = train_metrics.get("grad_sq_mean")
        cols = (
            train_metrics.get("loss_first", nan),
            train_metrics.get("loss", nan),
            torch.sqrt(train_metrics["update_sq"]),
            nan if grad_sq is None else torch.sqrt(grad_sq),
            dots / denom,
            train_metrics["nonfinite_count"],
        )
        return torch.stack([c.float() for c in cols], dim=1)

    def stack_stats(self, prev_global, stacked, aggregated,
                    numels) -> torch.Tensor:
        """One-shot ``[N, S]`` stats from a whole ``[N, P]`` upload stack
        and the raw aggregate (the threaded oracle's path: it holds the
        stack at its rendezvous, and its workers report no losses)."""
        tm = self.add_upload_stats({}, prev_global, stacked, numels)
        return self.stats_matrix(
            tm, self.probe_delta(prev_global, aggregated, numels))


# ---- host-side detection + record building --------------------------------


def detect_anomalies(stats: np.ndarray, mad_threshold: float = 8.0):
    """Median/MAD outlier detection over one round's ``[N, S]`` stats.

    Returns ``(flagged, reasons)``: the sorted flagged row indices and
    ``{row: reason}`` ("+"-joined when several rules fire):

    * ``non_finite`` — any non-finite uploaded element;
    * ``update_norm`` / ``loss_diverged`` — a robust z-score ``(x -
      median) / (1.4826 * MAD)`` above ``mad_threshold``, high side only,
      over the active clients (``update_norm > 0``; an empty shard never
      trained), needing at least 3 finite active values; the denominator
      floors at ``1e-6 * |median|`` so identical updates never flag.

    The z rules assume an honest majority, as the robust aggregation
    rules do."""
    stats = np.asarray(stats, dtype=np.float64)
    n = stats.shape[0]
    reasons: dict[int, list[str]] = {}

    def flag(i: int, reason: str) -> None:
        reasons.setdefault(int(i), []).append(reason)

    nonfinite = np.nan_to_num(stats[:, _IDX["nonfinite_count"]], nan=1.0)
    for i in np.flatnonzero(nonfinite > 0):
        flag(i, "non_finite")
    upd = stats[:, _IDX["update_norm"]]
    active = np.isfinite(upd) & (upd > 0.0)
    if n >= 3:
        for col, reason in (
            ("update_norm", "update_norm"),
            ("loss_after", "loss_diverged"),
        ):
            x = stats[:, _IDX[col]]
            ok = active & np.isfinite(x)
            if ok.sum() < 3:
                continue
            med = float(np.median(x[ok]))
            mad = float(np.median(np.abs(x[ok] - med)))
            denom = max(1.4826 * mad, 1e-6 * abs(med), 1e-12)
            z = (x - med) / denom
            for i in np.flatnonzero(ok & (z > mad_threshold)):
                flag(i, reason)
    flagged = sorted(reasons)
    return flagged, {i: "+".join(r) for i, r in reasons.items()}


def _san(v) -> float | None:
    """JSON-safe scalar: a non-finite float becomes None."""
    v = float(v)
    return v if np.isfinite(v) else None


def client_stats_record(stats: np.ndarray, flagged, reasons,
                        participants=None, extras: dict | None = None,
                        per_client_cap: int = PER_CLIENT_CAP) -> dict:
    """The ``client_stats`` sub-object of a schema-v3 record.
    ``participants`` maps stats rows to true client ids under participation
    sampling; ``extras`` merges algorithm round scalars (fed_quant's
    ``quant_mse``, sign_SGD's ``vote_agreement``)."""
    stats = np.asarray(stats, dtype=np.float64)
    n = stats.shape[0]
    ids = (
        np.arange(n, dtype=np.int64) if participants is None
        else np.asarray(participants, dtype=np.int64)
    )
    quantiles = {}
    for name, col in _IDX.items():
        x = stats[:, col]
        finite = x[np.isfinite(x)]
        quantiles[name] = {
            f"p{q}": (
                round(float(np.percentile(finite, q)), 6)
                if finite.size else None
            )
            for q in _QUANTILES
        }
    record: dict = {
        "n_clients": n,
        "flagged_clients": [int(ids[i]) for i in flagged],
        "flag_reason": {str(int(ids[i])): reasons[i] for i in flagged},
        "quantiles": quantiles,
    }
    if n <= per_client_cap:
        per_client: dict = {"client_ids": [int(i) for i in ids]}
        for name, col in _IDX.items():
            per_client[name] = [
                round(float(x), 6) if np.isfinite(x) else None
                for x in stats[:, col]
            ]
        record["per_client"] = per_client
    if extras:
        record.update({k: _san(v) for k, v in extras.items()})
    return record


def detect_and_record(stats, cs: "ClientStats", round_idx: int,
                      logger=None, participants=None,
                      extras: dict | None = None):
    """One round's host-side flagging: detector, record builder and the
    WARNING line, shared by the vmap path and the threaded oracle. Returns
    ``(record, n_flagged)``."""
    stats = np.asarray(stats)
    flagged, reasons = detect_anomalies(stats, cs.mad_threshold)
    record = client_stats_record(
        stats, flagged, reasons, participants=participants, extras=extras
    )
    if flagged and logger is not None:
        logger.warning(
            "round %d: client-stats detector flagged clients %s (%s)",
            round_idx, record["flagged_clients"], record["flag_reason"],
        )
    return record, len(flagged)


def attribution_crosscheck(shapley_values: np.ndarray,
                           stats: np.ndarray) -> float | None:
    """Pearson correlation between the per-client Shapley values and the
    local loss improvement (``loss_before - loss_after``); None when
    either side is degenerate."""
    sv = np.asarray(shapley_values, dtype=np.float64)
    stats = np.asarray(stats, dtype=np.float64)
    improve = stats[:, _IDX["loss_before"]] - stats[:, _IDX["loss_after"]]
    ok = np.isfinite(sv) & np.isfinite(improve)
    if ok.sum() < 2:
        return None
    sv, improve = sv[ok], improve[ok]
    if np.ptp(sv) == 0.0 or np.ptp(improve) == 0.0:
        return None
    return float(np.corrcoef(sv, improve)[0, 1])
