"""Always-on client valuation and its GTG audit (telemetry/valuation.py of
the JAX package).

* **The streaming estimator** (``client_valuation='on'``; off by default,
  and then the round is the pre-feature round): from the ``[N, S]``
  client-stats matrix the round already builds, each cohort client scores
  ``cos(update_i, aggregate) * ||update_i||``, normalized to unit L1 over
  the cohort (:meth:`ClientValuation.scores`, on the device). On the host
  each round's scores are scaled by the server loss delta (the previous
  test loss minus this round's) and folded into a per-client vector with
  exponential decay ``valuation_decay`` (:class:`ValuationState`):
  clients whose updates keep aligning with improving aggregates gain
  value. The vector is a host numpy ``[N]`` array, scatter-updated per
  cohort and kept in the checkpoint's ``algo_state``.
* **The audit** (``valuation_audit_every``): on that cadence
  :class:`ValuationAuditor` replays the round's cohort training from the
  round key (``FedAvg.make_valuation_audit_fn``, at the run's
  ``client_chunk_size``), runs a budgeted GTG walk over the replayed
  uploads (``algorithms/shapley.gtg_walk``, ``valuation_audit_permutations``
  permutations a sampling iteration) and reports the Spearman and Pearson
  correlations between the streaming vector and the audits' running
  per-client Shapley estimate in the schema-v7 ``valuation`` record. The
  audit never feeds back into training.

The replay holds the cohort's uploads as one f32 ``[cohort, P]`` stack on
the device: 50 ResNet-18 clients are 50 x 11.2M x 4 B = 2.2 GB, a
1000-client cohort 44.7 GB. The auditor refuses a stack larger than the
device budget (60% of the card's memory) when it is built.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.telemetry.client_stats import (
    _IDX,
    PER_CLIENT_CAP,
)

#: Clients listed in the per-round record's top/bottom valuation tables.
TOP_K = 8


@dataclass(frozen=True)
class ClientValuation:
    """The valuation configuration; ``from_config`` returns None when
    ``client_valuation='off'``, and every call site branches on that."""

    decay: float = 0.9
    audit_every: int = 0
    audit_permutations: int = 16

    @classmethod
    def from_config(cls, config) -> "ClientValuation | None":
        level = (
            getattr(config, "client_valuation", "off") or "off"
        ).lower()
        if level == "off":
            return None
        if level != "on":
            raise ValueError(
                f"unknown client_valuation {level!r}; known: off, on"
            )
        return cls(
            decay=float(getattr(config, "valuation_decay", 0.9)),
            audit_every=int(getattr(config, "valuation_audit_every", 0)),
            audit_permutations=int(
                getattr(config, "valuation_audit_permutations", 16)
            ),
        )

    def audit_round(self, round_idx: int) -> bool:
        """Whether this round runs the audit. Round 0 never does: the
        vector is all zero before its first fold."""
        return (
            self.audit_every > 0
            and round_idx > 0
            and round_idx % self.audit_every == 0
        )

    def scores(self, stats_matrix: torch.Tensor) -> torch.Tensor:
        """The cohort's streaming scores from the ``[N, S]`` stats matrix:
        ``agg_cosine * update_norm`` normalized to unit L1; a non-finite
        product (a corrupt upload's NaN norm) scores 0."""
        cos = stats_matrix[:, _IDX["agg_cosine"]]
        norm = stats_matrix[:, _IDX["update_norm"]]
        raw = cos * norm
        raw = torch.where(torch.isfinite(raw), raw, torch.zeros_like(raw))
        return raw / (torch.sum(torch.abs(raw)) + 1e-12)


def cohort_crc(ids, n_clients: int) -> int:
    """CRC32 of the cohort's ids as int64 (every client when ``ids`` is
    None): the records' ``cohort_hash`` formula, the audit memo's key."""
    arr = (
        np.arange(n_clients, dtype=np.int64) if ids is None
        else np.ascontiguousarray(ids, dtype=np.int64)
    )
    return zlib.crc32(arr.tobytes())


# ---- correlations ------------------------------------------------------------


def pearson_corr(a, b) -> float | None:
    """Pearson correlation over the finite pairs; None when fewer than 2
    or either side is constant."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    ok = np.isfinite(a) & np.isfinite(b)
    if ok.sum() < 2:
        return None
    a, b = a[ok], b[ok]
    if np.ptp(a) == 0.0 or np.ptp(b) == 0.0:
        return None
    return float(np.corrcoef(a, b)[0, 1])


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """Ranks with ties sharing the mean of their positions."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(x.shape[0], dtype=np.float64)
    sx = x[order]
    i = 0
    while i < x.shape[0]:
        j = i
        while j + 1 < x.shape[0] and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j)
        i = j + 1
    return ranks


def spearman_corr(a, b) -> float | None:
    """Spearman rank correlation (average ranks on ties) over the finite
    pairs; None when degenerate. Valuation is a ranking signal, so this is
    the audit's headline number."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    ok = np.isfinite(a) & np.isfinite(b)
    if ok.sum() < 2:
        return None
    ra, rb = _average_ranks(a[ok]), _average_ranks(b[ok])
    if np.ptp(ra) == 0.0 or np.ptp(rb) == 0.0:
        return None
    return float(np.corrcoef(ra, rb)[0, 1])


# ---- host-side state ---------------------------------------------------------


class ValuationState:
    """The per-client valuation vector (host numpy ``[N]``).

    Under ``client_residency='streamed'`` the vector lives in the host
    shard store (``store.valuation``, data/residency.py), the one owner of
    every population-sized array between rounds, and grows with it under a
    dynamic population; a resident run owns the array itself. Either way a
    round updates its cohort's entries."""

    def __init__(self, n_clients: int, store=None):
        self._store = store
        if store is not None:
            if store.valuation is None:
                store.attach_valuation(np.zeros(n_clients, dtype=np.float64))
            if store.valuation.shape[0] != n_clients:
                raise ValueError(
                    "store valuation length "
                    f"{store.valuation.shape[0]} != n_clients {n_clients}"
                )
        else:
            self._values = np.zeros(n_clients, dtype=np.float64)

    @property
    def values(self) -> np.ndarray:
        return (self._store.valuation if self._store is not None
                else self._values)

    def load(self, values) -> None:
        """Restore a checkpoint's saved vector."""
        values = np.asarray(values, dtype=np.float64)
        if values.shape != self.values.shape:
            raise ValueError(
                "checkpoint valuation vector has "
                f"{values.shape[0]} clients, this run has "
                f"{self.values.shape[0]}; resume with the configuration "
                "the checkpoint was written with"
            )
        if self._store is not None:
            self._store.attach_valuation(values)
        else:
            self._values = values

    def fold(self, ids, scores, loss_delta: float, decay: float) -> None:
        """One round's decayed fold: participants move toward ``loss_delta
        * score``, the others keep their value; ``ids=None`` is every
        client."""
        contrib = loss_delta * np.asarray(scores, dtype=np.float64)
        contrib = np.where(np.isfinite(contrib), contrib, 0.0)
        v = self.values
        if ids is None:
            v *= decay
            v += (1.0 - decay) * contrib
        else:
            idx = np.asarray(ids, dtype=np.int64)
            v[idx] = decay * v[idx] + (1.0 - decay) * contrib

    def top(self, k: int = TOP_K) -> list[tuple[int, float]]:
        v = self.values
        order = np.argsort(-v, kind="mergesort")[: min(k, v.shape[0])]
        return [(int(i), float(v[i])) for i in order]

    def bottom(self, k: int = TOP_K) -> list[tuple[int, float]]:
        v = self.values
        order = np.argsort(v, kind="mergesort")[: min(k, v.shape[0])]
        return [(int(i), float(v[i])) for i in order]

    def summary(self, last_audit: dict | None = None) -> dict:
        """The result dict's ``valuation``: top/bottom tables and the
        latest audit."""
        return {
            "top_clients": [
                {"id": i, "value": round(v, 8)} for i, v in self.top()
            ],
            "bottom_clients": [
                {"id": i, "value": round(v, 8)} for i, v in self.bottom()
            ],
            "last_audit": last_audit,
        }


def valuation_record(state: ValuationState, ids, loss_delta: float,
                     audit: dict | None = None,
                     per_client_cap: int = PER_CLIENT_CAP) -> dict:
    """The ``valuation`` sub-object of a schema-v7 record: top/bottom
    tables always, every client's value up to ``per_client_cap`` clients,
    the audit on audit rounds."""
    v = state.values
    n = int(v.shape[0])
    record: dict = {
        "n_clients": n,
        "updated": n if ids is None else int(np.asarray(ids).shape[0]),
        "loss_delta": round(float(loss_delta), 6),
        "top_clients": [
            {"id": i, "value": round(val, 8)} for i, val in state.top()
        ],
        "bottom_clients": [
            {"id": i, "value": round(val, 8)} for i, val in state.bottom()
        ],
    }
    if n <= per_client_cap:
        record["per_client"] = {
            "client_ids": list(range(n)),
            "value": [round(float(x), 8) for x in v],
        }
    if audit is not None:
        record["audit"] = audit
    return record


def grade_client_labels(y, num_classes: int, seed: int = 0) -> np.ndarray:
    """Graded label corruption for the fidelity differential: client ``i``
    of ``N`` gets the fraction ``i / (N - 1)`` of its packed labels (``y``,
    ``[N, S]``) replaced with uniform classes, from clean (client 0) to
    noise (client N-1)."""
    y = np.array(y, copy=True)
    n = y.shape[0]
    rng = np.random.default_rng(seed)
    for i in range(n):
        frac = i / max(n - 1, 1)
        k = int(round(frac * y.shape[1]))
        if k == 0:
            continue
        slots = rng.choice(y.shape[1], size=k, replace=False)
        y[i, slots] = rng.integers(0, num_classes, size=k)
    return y


def audit_stack_bytes(cohort: int, n_params: int) -> int:
    """Bytes of the audit's replayed ``[cohort, P]`` f32 stack."""
    return 4 * int(cohort) * int(n_params)


class ValuationAuditor:
    """The sparse-cadence GTG cross-check of the streaming estimator.

    On audit rounds it (1) replays the round's cohort uploads from the
    round key (``algorithm.make_valuation_audit_fn``: config.validate()
    refuses faults, async, persistent client state and everything else
    that would make the replay differ from the round), (2) runs a budgeted
    GTG walk over them (``algorithms/shapley.gtg_walk``, the GTG server's
    estimator), with the subset memo of the last audit of the same cohort
    when ``gtg_cross_round_memo`` is on, and (3) correlates the streaming
    vector, restricted to the cohort, with the audits' running per-client
    Shapley mean. Its permutation RNG is ``np.random.default_rng(seed +
    29)``, as in the JAX package, apart from every training stream."""

    def __init__(self, config, cv: ClientValuation, algorithm, apply_fn,
                 optimizer, layout, preprocess, eval_fn, client_data,
                 eval_batches, n_clients: int, device, budget_bytes=None):
        """``client_data`` is the run's ``(cx, cy, cmask)`` shards on the
        device, or under streamed residency its host shard store, from
        which each audit uploads its cohort's shards; ``budget_bytes`` the
        device budget the replayed stack must fit (None: unchecked)."""
        self._config = config
        self._cv = cv
        cohort = config.cohort_size(n_clients)
        n_params = sum(layout.numels)
        need = audit_stack_bytes(cohort, n_params)
        if budget_bytes is not None and need > budget_bytes:
            raise ValueError(
                f"valuation audits replay the cohort's uploads as one f32 "
                f"[{cohort}, {n_params}] stack ({need / 1e9:.1f} GB), "
                f"more than the device budget ({budget_bytes / 1e9:.1f} GB, "
                "60% of the device's memory); audit a smaller cohort "
                "(participation_fraction) or set valuation_audit_every=0"
            )
        self._stack_fn = algorithm.make_valuation_audit_fn(
            apply_fn, optimizer, layout, preprocess=preprocess,
            device=device,
        )
        self._layout = layout
        self._eval_fn = eval_fn
        self._device = device
        self._store = None
        if isinstance(client_data, tuple):
            self._cx, self._cy, self._cmask = client_data
        else:
            self._store = client_data
        self._eval_batches = eval_batches
        self._n = n_clients
        self._evaluator = None
        self._capped_batches = None
        # Only the latest walk's utilities: {cohort crc: utilities}.
        self._memo_store: dict[int, dict] = {}
        # The running per-client mean of the audits' Shapley values, by
        # true client id.
        self._sv_sum = np.zeros(n_clients, dtype=np.float64)
        self._sv_count = np.zeros(n_clients, dtype=np.int64)
        self._n_audits = 0
        self._rng = np.random.default_rng(
            getattr(config, "seed", 0) + 29
        )

    def due(self, round_idx: int) -> bool:
        return self._cv.audit_round(round_idx)

    def _get_evaluator(self):
        if self._evaluator is None:
            from distributed_learning_simulator_tpu_torch.algorithms.shapley import (  # noqa: E501
                _SubsetEvaluator,
                cap_eval_batches,
                eval_mesh_devices,
            )

            layout, eval_fn = self._layout, self._eval_fn

            def eval_flat(flat, *batches):
                return eval_fn(layout.unflatten(flat), *batches)

            # f32 stack reads: the audit is the fidelity reference (an
            # explicit shapley_eval_dtype='bfloat16' wins).
            dtype = self._config.shapley_eval_dtype
            self._evaluator = _SubsetEvaluator(
                eval_flat, chunk=self._config.shapley_eval_chunk,
                eval_dtype="float32" if dtype == "auto" else dtype,
                # The run's single-process mesh splits the walk's subset
                # axis too (bit-identical to the serial walk).
                mesh_devices=eval_mesh_devices(self._config),
                device=self._eval_batches[0].device,
            )
            self._capped_batches = cap_eval_batches(
                self._eval_batches, self._config.shapley_eval_samples,
            )
        return self._evaluator

    def replay(self, round_key, prev_global, ids, lr_scale: float = 1.0):
        """The round's cohort uploads ``[cohort, P]`` f32, replayed from
        ``round_key`` against the pre-round global model."""
        from distributed_learning_simulator_tpu_torch.algorithms.fedavg import (  # noqa: E501
            round_key_splits,
        )
        from distributed_learning_simulator_tpu_torch.ops import prng

        idx = (
            np.arange(self._n, dtype=np.int64) if ids is None
            else np.asarray(ids, dtype=np.int64)
        )
        # Audits refuse failure models: the 4-way split.
        _, train_key, payload_key, _, _ = round_key_splits(
            round_key, with_faults=False)
        client_keys = prng.split(train_key, int(idx.shape[0]))
        if self._store is None:
            return self._stack_fn(prev_global, self._cx, self._cy,
                                  self._cmask, idx, client_keys, payload_key,
                                  lr_scale)
        # Streamed: the cohort's shards, uploaded as the resident run holds
        # them, indexed by cohort position.
        x, y, m, _ = self._store.gather_data(idx)
        return self._stack_fn(
            prev_global, torch.as_tensor(x, device=self._device),
            torch.as_tensor(y, dtype=torch.int64, device=self._device),
            torch.as_tensor(m, device=self._device),
            np.arange(idx.shape[0]), client_keys, payload_key, lr_scale)

    def run(self, round_idx: int, round_key, prev_global, ids,
            values: np.ndarray, sizes, lr_scale: float = 1.0) -> dict:
        """One audit: the ``audit`` record sub-object (correlations, the
        walk's budget, memo reuse, wall seconds)."""
        from distributed_learning_simulator_tpu_torch.algorithms.shapley import (  # noqa: E501
            SubsetMemo,
            eval_subsets,
            gtg_walk,
        )

        t0 = time.perf_counter()
        idx = (
            np.arange(self._n, dtype=np.int64) if ids is None
            else np.asarray(ids, dtype=np.int64)
        )
        n = int(idx.shape[0])
        stack = self.replay(round_key, prev_global, ids, lr_scale)
        evaluator = self._get_evaluator()
        stack = evaluator.prepare_stack(stack)
        sizes_k = np.asarray(sizes, dtype=np.float32)[idx]
        key = cohort_crc(idx, self._n)
        # Cross-round memo reuse only with gtg_cross_round_memo (reused
        # utilities describe an earlier audit's params).
        cross_round = bool(getattr(self._config, "gtg_cross_round_memo",
                                   False))
        seed = self._memo_store.get(key) if cross_round else None
        if seed:
            seed = {k: v for k, v in seed.items() if 0 < len(k) < n}
        memo = SubsetMemo(seed)
        grand = frozenset(range(n))
        eval_subsets(
            evaluator, stack, sizes_k, prev_global,
            self._capped_batches, n, memo, [frozenset(), grand],
        )
        cfg = self._config
        sv_arr, n_perms, converged = gtg_walk(
            evaluator, stack, sizes_k, prev_global, self._capped_batches,
            n, self._rng,
            eps=cfg.gtg_eps,
            cap=self._cv.audit_permutations,
            last_k=cfg.gtg_last_k,
            converge_criteria=cfg.gtg_converge_criteria,
            trunc_ref=memo[grand],
            prefix_mode=cfg.gtg_prefix_mode,
            memo=memo,
            starts_per_iteration=min(self._cv.audit_permutations, n),
        )
        evaluator.release_round()
        if cross_round:
            self._memo_store = {key: dict(memo)}
        self._sv_sum[idx] += sv_arr
        self._sv_count[idx] += 1
        self._n_audits += 1
        sv_mean = self._sv_sum[idx] / np.maximum(self._sv_count[idx], 1)
        vals_cohort = np.asarray(values, dtype=np.float64)[idx]
        sp = spearman_corr(vals_cohort, sv_mean)
        pe = pearson_corr(vals_cohort, sv_mean)
        sp_round = spearman_corr(vals_cohort, sv_arr)
        hit_rate = memo.hit_rate() if cross_round else None
        return {
            "spearman": None if sp is None else round(sp, 4),
            "pearson": None if pe is None else round(pe, 4),
            "spearman_round": (
                None if sp_round is None else round(sp_round, 4)
            ),
            "audits": int(self._n_audits),
            "permutations": int(n_perms),
            "subset_evals": int(memo.evaluated),
            "converged": bool(converged),
            "memo_hit_rate": (
                None if hit_rate is None else round(hit_rate, 4)
            ),
            "seconds": round(time.perf_counter() - t0, 3),
        }
