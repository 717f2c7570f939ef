"""Shapley-value contribution scoring: exact multi-round and GTG Monte-Carlo
(algorithms/shapley.py of the JAX package).

Both algorithms run FedAvg rounds on the materializing path
(``keep_client_params``: the round keeps the cohort's uploads as an f32
``[n, P]`` stack) and then score each client's contribution to the round's
test accuracy from the utilities of client subsets. A subset's utility is
the test accuracy of its subset model: the dataset-size-weighted mean of
its members' uploads, or the previous global model for the empty subset.

* ``multiround_shapley_value`` evaluates all 2^N subsets (N <= 16) and
  takes the exact Shapley values (:func:`shapley_from_utilities`).
* ``GTG_shapley_value`` samples permutations, one starting with each
  client per iteration, and walks their prefixes with eps-truncation until
  the running means converge (:func:`gtg_walk`). Its walk RNG is
  ``np.random.default_rng(seed + 17)``, as in the JAX package, so the same
  permutations are drawn.

How the subset models are formed (:class:`_SubsetEvaluator`): a chunk of
up to ``shapley_eval_chunk`` subset masks becomes one product ``(masks * w)
[chunk, n] @ stack [n, P]`` (ops/aggregate.py ``subset_weighted_mean``),
and the chunk's models are evaluated together: the run's eval function
vmapped over them with the eval batches shared, as the JAX evaluator does,
so on the card one ResNet forward per eval batch serves the whole chunk
(the GroupNorm kernels take the models' samples stacked, each with its own
affine). GTG's default prefix mode
``cumsum`` extends each permutation's weighted running sum block by block
instead (:class:`_CumsumPrefixWalker`); ``masked`` forms every prefix by
the mask product. ``shapley_eval_dtype`` (``auto``: f32 for multiround,
bf16 for GTG) rounds the stack's values to bf16 once per round; the
weights and every product stay f32, so a subset model is f32 either way,
as in the JAX package. The evaluator runs on one device (``mesh_devices >
1`` is refused: ROADMAP.md queue 1 item 17).

Artifacts as in the JAX package: ``metric_<round>.pkl`` in the run's log
directory holds ``{sorted subset tuple: utility}`` for every subset
evaluated, and each round logs a ``shapley values`` line.
"""

from __future__ import annotations

import math
import os
import pickle
import traceback
from itertools import combinations

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.algorithms.base import (
    RoundContext,
)
from distributed_learning_simulator_tpu_torch.algorithms.fedavg import FedAvg
from distributed_learning_simulator_tpu_torch.ops.aggregate import (
    block_prefix_cumsum,
    prefix_means_from_cumsum,
    subset_masks_all,
    subset_weighted_mean,
)
from distributed_learning_simulator_tpu_torch.telemetry.client_stats import (
    ClientStats,
    attribution_crosscheck,
)
from distributed_learning_simulator_tpu_torch.utils.errors import is_device_oom
from distributed_learning_simulator_tpu_torch.utils.logging import get_logger
from distributed_learning_simulator_tpu_torch.utils.reporting import (
    cohort_crc,
)

_EVAL_CHUNK = 16  # subset models formed per product
_PREFIX_BLOCK = 16  # GTG permutation prefixes fetched per wave


class SubsetMemo(dict):
    """Subset-utility memo with cross-round reuse accounting.

    A plain dict to the walk (``s in memo`` / ``memo[s]`` / ``memo[s] =
    v``). Entries present at construction are the seed, utilities carried
    over from an earlier round with the same cohort
    (``gtg_cross_round_memo``); :meth:`hit_rate` reports what fraction of
    the subsets this walk requested came from the seed. Under the
    ``cumsum`` prefix mode a seeded prefix is still computed inside its
    wave and only its memo write is skipped, so the rate then measures
    reuse, not work avoided."""

    def __init__(self, seed: dict | None = None):
        super().__init__(seed or {})
        self._seeded = frozenset(self)
        self._hits: set = set()
        self._inserted = 0

    def __contains__(self, key) -> bool:
        present = super().__contains__(key)
        if present and key in self._seeded:
            self._hits.add(key)
        return present

    def __setitem__(self, key, value) -> None:
        if not super().__contains__(key):
            self._inserted += 1
        super().__setitem__(key, value)

    @property
    def evaluated(self) -> int:
        """Subsets evaluated into this memo (seeded entries excluded)."""
        return self._inserted

    def hit_rate(self) -> float | None:
        """Fraction of requested subsets served from the seed (None when
        the walk requested nothing)."""
        requested = len(self._hits) + self._inserted
        if requested == 0:
            return None
        return len(self._hits) / requested


def eval_subsets(evaluator, client_params, sizes, prev_global,
                 eval_batches, n: int, memo, subset_sets) -> None:
    """Evaluate the listed subsets (frozensets of client indices) into
    ``memo``, skipping those it holds."""
    todo = list(dict.fromkeys(s for s in subset_sets if s not in memo))
    if not todo:
        return
    mask_rows = np.zeros((len(todo), n), dtype=np.float32)
    for r, s in enumerate(todo):
        mask_rows[r, list(s)] = 1.0
    vals = evaluator(
        client_params, sizes, mask_rows, prev_global, eval_batches
    )
    for s, v in zip(todo, vals):
        memo[s] = float(v)


def _gtg_converged(records: list[np.ndarray], n: int, last_k: int,
                   converge_criteria: float) -> bool:
    """More than ``max(30, n, last_k)`` records, and each of the last
    ``last_k`` running means within ``converge_criteria`` (relative error
    averaged over the clients) of the final one."""
    converge_min = max(30, n)
    if len(records) <= max(converge_min, last_k):
        return False
    all_arr = np.stack(records)
    cumsum = np.cumsum(all_arr, axis=0)
    counts = np.arange(1, len(records) + 1)[:, None]
    running_means = (cumsum / counts)[-last_k:]
    final = running_means[-1:]
    errors = np.mean(
        np.abs(running_means - final) / (np.abs(final) + 1e-12), axis=1
    )
    return bool(np.max(errors) <= converge_criteria)


def gtg_walk(evaluator, client_params, sizes, prev_global, eval_batches,
             n: int, rng, *, eps: float, cap: int, last_k: int,
             converge_criteria: float, trunc_ref: float,
             prefix_mode: str = "cumsum", memo=None,
             starts_per_iteration: int | None = None):
    """One round's GTG permutation-sampling walk over ``n`` clients (shared
    by the GTG server and the valuation audit, telemetry/valuation.py).

    Each sampling iteration draws one permutation starting with each client
    (the rest shuffled by ``rng``), or with ``starts_per_iteration`` of
    them drawn without replacement from ``rng`` (the audit's budget), and
    walks all of them in waves of
    ``_PREFIX_BLOCK`` prefix positions; a permutation whose running utility
    is within ``eps`` of ``trunc_ref`` stops (its remaining marginals are 0). Records one
    marginal vector per permutation until :func:`_gtg_converged` or
    ``cap`` permutations. Returns ``(sv_arr, n_perms, converged)``;
    utilities accumulate into ``memo``."""
    if memo is None:
        memo = {}
    eval_subsets(
        evaluator, client_params, sizes, prev_global, eval_batches, n,
        memo, [frozenset()],
    )  # u(empty): every walk's starting value
    walker = None
    if prefix_mode == "cumsum":
        walker = _CumsumPrefixWalker(
            evaluator, client_params, sizes, prev_global, eval_batches, n,
        )
    records: list[np.ndarray] = []
    n_perms = 0
    converged = False
    while not converged and n_perms < cap:
        if starts_per_iteration is None or starts_per_iteration >= n:
            starts = list(range(n))
        else:
            starts = [int(s) for s in
                      rng.choice(n, size=starts_per_iteration, replace=False)]
        m = len(starts)
        perms = []
        for first in starts:
            rest = [i for i in range(n) if i != first]
            rng.shuffle(rest)
            perms.append([first] + rest)
        if walker is not None:
            walker.reset()  # fresh zero carries for this iteration
        marginals = np.zeros((m, n), dtype=np.float64)
        v_prev = [memo[frozenset()]] * m
        truncated = [False] * m
        for j0 in range(0, n, _PREFIX_BLOCK):
            j1 = min(j0 + _PREFIX_BLOCK, n)
            active: list[int] = []
            for p_idx in range(m):
                if truncated[p_idx] or (
                    abs(trunc_ref - v_prev[p_idx]) < eps
                ):
                    truncated[p_idx] = True
                else:
                    active.append(p_idx)
            if not active:
                break  # every permutation truncated
            if walker is not None:
                walker.eval_block(perms, active, j0, j1, memo)
            else:
                eval_subsets(
                    evaluator, client_params, sizes, prev_global,
                    eval_batches, n, memo,
                    [
                        frozenset(perms[p][: j + 1])
                        for p in active for j in range(j0, j1)
                    ],
                )
            for p_idx in active:
                perm = perms[p_idx]
                vp = v_prev[p_idx]
                for j in range(j0, j1):
                    if abs(trunc_ref - vp) >= eps:
                        v_j = memo[frozenset(perm[: j + 1])]
                    else:
                        v_j = vp  # truncated: marginal exactly 0
                    marginals[p_idx, perm[j]] = v_j - vp
                    vp = v_j
                v_prev[p_idx] = vp
        for p_idx in range(m):
            records.append(marginals[p_idx].copy())
            n_perms += 1
            if _gtg_converged(records, n, last_k, converge_criteria):
                converged = True
                break
    return np.mean(np.stack(records), axis=0), n_perms, converged


def _sv_crosscheck_extra(ctx: RoundContext, sv_arr, config) -> dict:
    """The Shapley-vs-client-stats cross-check (telemetry/client_stats.py):
    on a round that carried per-client stats, the correlation between the
    Shapley values and the local loss improvement, ``sv_stats_corr``. Reads
    the matrix the round loop already fetched (``ctx.extra``, set only on
    ``client_stats_every`` rounds), else the round's device matrix on the
    same cadence. Empty when stats are off, off-cadence, or the correlation
    is degenerate."""
    stats = ctx.extra.get("client_stats_np")
    if stats is None:
        stats_dev = ctx.aux.get("client_stats")
        cs = ClientStats.from_config(config)
        if (
            stats_dev is None
            or cs is None
            or not cs.fetch_round(ctx.round_idx)
        ):
            return {}
        stats = stats_dev.detach().cpu().numpy()
    corr = attribution_crosscheck(sv_arr, stats)
    return {} if corr is None else {"sv_stats_corr": corr}


def _resolve_eval_dtype(config, default: str) -> str:
    """``shapley_eval_dtype='auto'`` per algorithm: f32 for exact
    multi-round Shapley, bf16 for GTG; an explicit value wins."""
    dtype = config.shapley_eval_dtype
    return default if dtype == "auto" else dtype


def shapley_from_utilities(utilities: dict[frozenset, float],
                           n: int) -> np.ndarray:
    """Exact Shapley values from a complete 2^n utility table:
    ``SV_i = sum over S not containing i of (u(S + {i}) - u(S)) /
    (n * C(n-1, |S|))``."""
    sv = np.zeros(n, dtype=np.float64)
    ids = list(range(n))
    for size in range(n):
        weight = 1.0 / (n * math.comb(n - 1, size))
        for combo in combinations(ids, size):
            s = frozenset(combo)
            for i in ids:
                if i in s:
                    continue
                sv[i] += weight * (utilities[s | {i}] - utilities[s])
    return sv


def cap_eval_batches(eval_batches, max_samples: int | None):
    """The first ``max_samples`` test samples, for subset utilities only
    (the round's metric keeps the whole set): one smaller batch below one
    eval batch, else whole eval batches with the tail masked out."""
    if max_samples is None:
        return eval_batches
    xb, yb, mb = eval_batches
    bs = xb.shape[1]
    total = xb.shape[0] * bs

    def flat(a):
        return a.reshape((total,) + tuple(a.shape[2:]))

    k = min(max_samples, total)
    if k < bs:
        return (flat(xb)[:k][None], flat(yb)[:k][None], flat(mb)[:k][None])
    n_batches = min((k + bs - 1) // bs, xb.shape[0])
    take = n_batches * bs

    def reshape(a):
        return a[:take].reshape((n_batches, bs) + tuple(a.shape[1:]))

    keep = (torch.arange(take, device=mb.device) < k).to(mb.dtype)
    return (
        reshape(flat(xb)),
        reshape(flat(yb)),
        (flat(mb)[:take] * keep).reshape((n_batches, bs) + tuple(mb.shape[2:])),
    )


class _SubsetEvaluator:
    """Subset-model accuracies, ``chunk`` (config.shapley_eval_chunk)
    models formed per product and evaluated per vmapped forward.

    ``eval_fn(flat_model, xb, yb, mb) -> {"accuracy": ...}`` evaluates one
    flat model; it is vmapped over each chunk's models. A call's
    accuracies are fetched to the host once, at the end of the call."""

    def __init__(self, eval_fn, chunk: int = _EVAL_CHUNK,
                 eval_dtype: str = "float32"):
        self._chunk = int(chunk)
        self._eval_fn = eval_fn
        self._batched = {}  # number of eval batch tensors -> vmapped eval_fn
        self._eval_dtype = {"float32": torch.float32,
                            "bfloat16": torch.bfloat16}[str(eval_dtype)]

    @property
    def eval_dtype(self) -> torch.dtype:
        return self._eval_dtype

    def prepare_stack(self, client_params: torch.Tensor) -> torch.Tensor:
        """The round's stack as the evaluator reads it: under bf16 its
        values rounded to bf16 once (held in f32, so every product stays an
        f32 product, as the JAX package's mixed bf16 x f32 contraction)."""
        if self._eval_dtype == torch.float32:
            return client_params
        return client_params.to(self._eval_dtype).float()

    def _accuracies(self, models: torch.Tensor, eval_batches
                    ) -> torch.Tensor:
        """``[K]`` accuracies of ``models [K, P]``: one vmapped forward per
        eval batch."""
        n = len(eval_batches)
        if n not in self._batched:
            self._batched[n] = torch.func.vmap(
                self._eval_fn, in_dims=(0,) + (None,) * n)
        with torch.no_grad():
            return self._batched[n](models, *eval_batches)["accuracy"]

    def _reraise_oom(self, e, n_models: int, eval_batches,
                     min_chunk: int = 1):
        """Re-raise a device OOM of a subset evaluation with the JAX
        package's hint (``_SubsetEvaluator._reraise_oom``): ``n_models``
        subset models times the eval set's activations were resident at
        once; it names ``shapley_eval_chunk`` (never below ``min_chunk``,
        the cumsum walk's one prefix block) and ``shapley_eval_samples``.
        The OOM's finished frames are cleared first, so the chained cause
        holds no tensor."""
        traceback.clear_frames(e.__traceback__)
        xb = eval_batches[0]
        n_eval = int(xb.shape[0]) * int(xb.shape[1])
        suggestion = max(self._chunk // 4, min_chunk)
        chunk_advice = (
            f"Lower shapley_eval_chunk (e.g. {suggestion}) or cap "
            if suggestion < self._chunk
            else f"shapley_eval_chunk={self._chunk} is already minimal — cap "
        )
        raise RuntimeError(
            "device OOM inside the Shapley subset evaluator: "
            f"{n_models} subset models x ~{n_eval} "
            "eval samples of activations were resident at once. "
            + chunk_advice +
            "shapley_eval_samples (subset utilities only; the "
            "round metric keeps the full test set)."
        ) from e

    def __call__(self, client_params, sizes, masks, prev_global,
                 eval_batches) -> np.ndarray:
        """``masks``: ``[M, n]`` numpy 0/1. Returns ``[M]`` accuracies."""
        accs = []
        try:
            for start in range(0, len(masks), self._chunk):
                models = subset_weighted_mean(
                    client_params, sizes, masks[start:start + self._chunk],
                    prev_global,
                )
                accs.append(self._accuracies(models, eval_batches))
            return torch.cat(accs).float().cpu().numpy()
        except RuntimeError as e:
            if not is_device_oom(e):
                raise
            accs.clear()
            self._reraise_oom(e, self._chunk, eval_batches)

    def prefix_wave(self, client_params, sizes, carry, carry_t, perm_block,
                    prev_global, eval_batches):
        """GTG's cumsum mode: advance G permutations by one block of B
        prefix positions from their carried running sums, and evaluate the
        G*B prefix models. Returns ``(accs [G, B], new carry [G, P], new
        carry totals [G])``."""
        cs, totals = block_prefix_cumsum(client_params, sizes, perm_block,
                                         carry, carry_t)
        models = prefix_means_from_cumsum(cs, totals, prev_global)
        g, b = models.shape[:2]
        accs = self._accuracies(models.reshape(g * b, -1), eval_batches)
        return accs.reshape(g, b), cs[:, -1], totals[:, -1]


class _CumsumPrefixWalker:
    """One GTG sampling iteration's prefix walks under
    ``gtg_prefix_mode='cumsum'``.

    Each active permutation carries the f32 running weighted sum (and total
    weight) of its walked prefix; :meth:`eval_block` advances a wave of
    them by one prefix block, ``group`` permutations per
    ``prefix_wave`` call (group x block matches the masked path's
    ``shapley_eval_chunk`` models, at least one group). The carries are
    compacted each wave to the still-active walks, so a truncated walk's
    sum is simply no longer carried. The same prefix sets land in the memo
    as under the masked mode (the first value of a set is kept)."""

    def __init__(self, evaluator, client_params, sizes, prev_global,
                 eval_batches, n: int):
        self._ev = evaluator
        self._stack = client_params
        self._sizes = sizes
        self._prev_global = prev_global
        self._eval_batches = tuple(eval_batches)
        self._block = min(_PREFIX_BLOCK, n)
        self._group = max(1, evaluator._chunk // self._block)
        self._carry = None
        self._carry_t = None
        self._row_of: dict[int, int] = {}

    def reset(self):
        """Fresh empty prefixes for a new sampling iteration."""
        self._carry = None
        self._carry_t = None
        self._row_of = {}

    def _wave_carries(self, active):
        """The carries of this wave's active permutations, row k =
        active[k], padded to whole groups by repeating the last row (its
        results are discarded)."""
        padded = -(-len(active) // self._group) * self._group
        if self._carry is None:  # first wave: every carry is the empty sum
            return (
                torch.zeros((padded,) + tuple(self._stack.shape[1:]),
                            dtype=torch.float32, device=self._stack.device),
                torch.zeros(padded, dtype=torch.float32,
                            device=self._stack.device),
            )
        rows = [self._row_of[p] for p in active]
        rows += [rows[-1]] * (padded - len(rows))
        rows = torch.as_tensor(rows, dtype=torch.long,
                               device=self._stack.device)
        return self._carry[rows], self._carry_t[rows]

    def eval_block(self, perms, active, j0: int, j1: int, memo) -> None:
        """Advance every permutation in ``active`` through prefix positions
        ``[j0, j1)``, filling ``memo`` with the block's utilities."""
        g_size, b_size = self._group, self._block
        carry, carry_t = self._wave_carries(active)
        pending = []
        new_carries = []
        try:
            for start in range(0, len(active), g_size):
                group = active[start:start + g_size]
                # A short final block pads its trailing positions with
                # client 0: that corrupts the carry past position n-1,
                # which no later block reads.
                block = np.zeros((g_size, b_size), np.int64)
                for g, p in enumerate(group):
                    block[g, : j1 - j0] = perms[p][j0:j1]
                accs, nc, nct = self._ev.prefix_wave(
                    self._stack, self._sizes, carry[start:start + g_size],
                    carry_t[start:start + g_size], block, self._prev_global,
                    self._eval_batches,
                )
                pending.append((group, accs))
                new_carries.append((nc, nct))
            fetched = torch.stack(
                [a for _, a in pending]).float().cpu().numpy()
        except RuntimeError as e:
            if not is_device_oom(e):
                raise
            pending.clear()
            new_carries.clear()
            del carry, carry_t
            # The call's floor is one prefix block of models.
            self._ev._reraise_oom(e, g_size * b_size, self._eval_batches,
                                  min_chunk=b_size)
        self._carry = torch.cat([nc for nc, _ in new_carries])
        self._carry_t = torch.cat([t for _, t in new_carries])
        self._row_of = {p: k for k, p in enumerate(active)}
        for (group, _), acc in zip(pending, fetched):
            for g, p in enumerate(group):
                perm = perms[p]
                for b in range(j1 - j0):
                    s = frozenset(perm[: j0 + b + 1])
                    if s not in memo:
                        memo[s] = float(acc[g, b])


def _check_shapley_config(config) -> None:
    """Both Shapley algorithms' preconditions: every client each round,
    plain FedAvg aggregation, honest synchronous uploads."""
    if config.participation_fraction < 1.0:
        raise ValueError(
            "Shapley scoring needs every client's update each round; "
            "participation_fraction < 1 is not supported"
        )
    if (config.server_optimizer_name or "none").lower() not in ("none", ""):
        raise ValueError(
            "Shapley scoring assumes plain FedAvg aggregation; set "
            "server_optimizer_name='none'"
        )
    if config.aggregation.lower() != "mean":
        raise ValueError(
            "Shapley scoring assumes the weighted-mean aggregator (subset "
            "utilities are weighted means); set aggregation='mean'"
        )
    if config.failure_mode != "none" and config.failure_prob > 0.0:
        raise ValueError(
            "Shapley scoring refuses failure injection: the subset-utility "
            "memo assumes a fixed cohort of honest updates; set "
            "failure_mode='none'"
        )
    if config.async_mode.lower() == "on":
        raise ValueError(
            "Shapley scoring refuses async_mode='on': subset utilities "
            "assume a synchronous fixed cohort; set async_mode='off'"
        )


class _ShapleyBase(FedAvg):
    """What both Shapley algorithms share: the client stack, the subset
    evaluator over flat models, and the per-round artifacts."""

    #: The subset re-evaluation needs the cohort's stack on the device
    #: every round: no streamed residency (JAX shapley.py).
    supports_streamed_residency = False

    keep_client_params = True
    _default_eval_dtype = "float32"

    def __init__(self, config):
        super().__init__(config)
        _check_shapley_config(config)
        self.shapley_values: dict[int, dict[int, float]] = {}
        self._evaluator = None
        self._layout = None

    def bind_layout(self, layout) -> None:
        """The flat layout the subset models unflatten with (make_round_fn
        sets it; the threaded oracle, which builds no round function,
        calls it)."""
        self._layout = layout

    def make_round_fn(self, apply_fn, optimizer, layout, n_clients: int,
                      preprocess=None, client_sizes=None, device=None):
        self.bind_layout(layout)
        return super().make_round_fn(apply_fn, optimizer, layout, n_clients,
                                     preprocess, client_sizes, device)

    def prepare(self, apply_fn, eval_fn, eval_batches=None):
        super().prepare(apply_fn, eval_fn, eval_batches)

        def eval_flat(flat, *batches):
            return eval_fn(self._layout.unflatten(flat), *batches)

        self._evaluator = _SubsetEvaluator(
            eval_flat, chunk=self.config.shapley_eval_chunk,
            eval_dtype=_resolve_eval_dtype(self.config,
                                           self._default_eval_dtype),
        )

    def _subset_eval_batches(self, ctx):
        return cap_eval_batches(ctx.eval_batches,
                                self.config.shapley_eval_samples)

    @staticmethod
    def _write_metrics(ctx, utilities) -> None:
        """``metric_<round>.pkl``: ``{sorted subset tuple: utility}``."""
        if ctx.log_dir:
            path = os.path.join(ctx.log_dir, f"metric_{ctx.round_idx}.pkl")
            with open(path, "wb") as f:
                pickle.dump(
                    {tuple(sorted(k)): v for k, v in utilities.items()}, f
                )

    def _truncated(self, ctx, threshold, n: int, extra: dict):
        """Round truncation: with a threshold, a round whose accuracy moved
        at most that far from the last round's scores all zeros."""
        if (
            threshold is None
            or ctx.prev_metrics is None
            or abs(float(ctx.metrics["accuracy"])
                   - float(ctx.prev_metrics["accuracy"])) > threshold
        ):
            return None
        sv = {i: 0.0 for i in range(n)}
        self.shapley_values[ctx.round_idx] = sv
        get_logger().info("round %d: truncated, shapley values all 0",
                          ctx.round_idx)
        return {"shapley_values": sv, **extra}


class MultiRoundShapley(_ShapleyBase):
    """Exact multi-round Shapley: the utility of every subset of the N
    clients each round (N <= 16; the reference's canonical run is N=4)."""

    supports_round_batching = False  # post_round scores every round

    name = "multiround_shapley_value"

    def __init__(self, config):
        super().__init__(config)
        if config.worker_number > 16:
            get_logger().warning(
                "exact Shapley needs 2^N subset evaluations and "
                "worker_number=%d > 16; this run will be refused at build "
                "time unless the injected client data has <= 16 clients",
                config.worker_number,
            )

    def check_cohort(self, n_clients: int) -> None:
        if n_clients > 16:
            raise ValueError(
                "exact Shapley needs 2^N subset evaluations; "
                f"N={n_clients} > 16. "
                "Use GTG_shapley_value for large client counts."
            )

    def post_round(self, ctx: RoundContext) -> dict:
        n = int(np.asarray(ctx.sizes).shape[0])
        self.check_cohort(n)
        cut = self._truncated(ctx, self.config.round_trunc_threshold, n, {})
        if cut is not None:
            return cut
        masks = subset_masks_all(n, include_empty=True)
        utilities_arr = self._evaluator(
            self._evaluator.prepare_stack(ctx.aux["client_params"]),
            ctx.sizes, masks, ctx.prev_global_params,
            self._subset_eval_batches(ctx),
        )
        utilities = {
            frozenset(np.flatnonzero(m).tolist()): float(u)
            for m, u in zip(masks, utilities_arr)
        }
        sv_arr = shapley_from_utilities(utilities, n)
        sv = {i: float(v) for i, v in enumerate(sv_arr)}
        self.shapley_values[ctx.round_idx] = sv
        self._write_metrics(ctx, utilities)
        get_logger().info("round %d shapley values: %s", ctx.round_idx, sv)
        return {
            "shapley_values": sv,
            **_sv_crosscheck_extra(ctx, sv_arr, self.config),
        }


class GTGShapley(_ShapleyBase):
    """GTG-Shapley: Monte-Carlo permutation sampling with guided
    truncation (defaults: eps 1e-3, round truncation 0.01, last_k 10,
    convergence 0.05, at most max(500, 2N) permutations)."""

    supports_round_batching = False  # post_round scores every round

    name = "GTG_shapley_value"
    _default_eval_dtype = "bfloat16"

    def __init__(self, config):
        super().__init__(config)
        self.eps = config.gtg_eps
        self.round_trunc_threshold = config.round_trunc_threshold
        if self.round_trunc_threshold is None:
            self.round_trunc_threshold = 0.01
        self.last_k = config.gtg_last_k
        self.converge_criteria = config.gtg_converge_criteria
        self.max_permutations = config.gtg_max_permutations
        # {cohort crc32 -> the last walk's utilities}
        # (config.gtg_cross_round_memo).
        self._memo_store: dict[int, dict] = {}
        self.gtg_memo_hit_rate: float | None = None
        self._warned_mc_budget = False
        if (
            self.max_permutations is not None
            and self.max_permutations < config.worker_number
        ):
            get_logger().warning(
                "gtg_max_permutations=%d < worker_number=%d: one sampling "
                "iteration draws one permutation per client, so the cap "
                "would be exceeded before it is ever checked; this run "
                "will be refused at build time unless the actual client "
                "count is <= the cap",
                self.max_permutations, config.worker_number,
            )
        self._rng = np.random.default_rng(config.seed + 17)

    def check_cohort(self, n_clients: int) -> None:
        if self.max_permutations is None:
            return
        converge_floor = max(30, n_clients, self.last_k)
        if self.max_permutations < n_clients:
            raise ValueError(
                f"gtg_max_permutations={self.max_permutations} < "
                f"N={n_clients}: one GTG sampling iteration draws N "
                "permutations (one starting with each worker), so this "
                "cap cannot be honored — raise it to >= "
                f"{n_clients} (> {converge_floor} for a convergence-"
                "capable run) or leave it unset for auto max(500, 2N)"
            )
        if (self.max_permutations <= converge_floor
                and not self._warned_mc_budget):
            self._warned_mc_budget = True
            get_logger().warning(
                "gtg_max_permutations=%d <= max(30, N=%d, last_k=%d): the "
                "convergence test needs more records than that, so every "
                "round will report a fixed-budget Monte-Carlo estimate "
                "with converged=False",
                self.max_permutations, n_clients, self.last_k,
            )

    def _effective_cap(self, n_clients: int) -> int:
        if self.max_permutations is not None:
            return self.max_permutations
        return max(500, 2 * n_clients)

    def post_round(self, ctx: RoundContext) -> dict:
        n = int(np.asarray(ctx.sizes).shape[0])
        logger = get_logger()
        cut = self._truncated(ctx, self.round_trunc_threshold, n,
                              {"gtg_permutations": 0})
        if cut is not None:
            return cut
        client_params = self._evaluator.prepare_stack(ctx.aux["client_params"])
        cohort_key = cohort_crc(None, n)
        cross_round = bool(self.config.gtg_cross_round_memo)
        seed = self._memo_store.get(cohort_key) if cross_round else None
        if seed:
            # The empty and grand coalitions anchor the walk: always
            # re-evaluated against this round's params.
            seed = {k: v for k, v in seed.items() if 0 < len(k) < n}
        memo = SubsetMemo(seed)
        eval_batches = self._subset_eval_batches(ctx)

        def utilities_for(subsets: list[frozenset]) -> None:
            eval_subsets(
                self._evaluator, client_params, ctx.sizes,
                ctx.prev_global_params, eval_batches, n, memo, subsets,
            )

        utilities_for([frozenset()])  # u(empty) = prev-global metric
        # The eps-truncation reference comes from the same estimator as the
        # walked prefixes: the round metric, unless the utilities use a
        # subsample or a bf16 stack, then the grand coalition's utility.
        if (
            self.config.shapley_eval_samples is not None
            or self._evaluator.eval_dtype != torch.float32
        ):
            grand = frozenset(range(n))
            utilities_for([grand])
            trunc_ref = memo[grand]
        else:
            trunc_ref = float(ctx.metrics["accuracy"])
        cap = self._effective_cap(n)
        if cap < n:
            logger.warning(
                "gtg_max_permutations=%d < N=%d: the first sampling "
                "iteration alone draws N permutations; the cap will be "
                "exceeded and convergence cannot fire", cap, n,
            )
        sv_arr, n_perms, converged = gtg_walk(
            self._evaluator, client_params, ctx.sizes,
            ctx.prev_global_params, eval_batches, n, self._rng,
            eps=self.eps, cap=cap, last_k=self.last_k,
            converge_criteria=self.converge_criteria, trunc_ref=trunc_ref,
            prefix_mode=self.config.gtg_prefix_mode, memo=memo,
        )
        sv = {i: float(v) for i, v in enumerate(sv_arr)}
        self.shapley_values[ctx.round_idx] = sv
        memo_extra = {}
        if cross_round:
            self._memo_store[cohort_key] = dict(memo)
            self.gtg_memo_hit_rate = memo.hit_rate()
            if self.gtg_memo_hit_rate is not None:
                memo_extra["gtg_memo_hit_rate"] = round(
                    self.gtg_memo_hit_rate, 4
                )
        self._write_metrics(ctx, memo)
        logger.info(
            "round %d shapley values (GTG, %d permutations, %d subset evals, "
            "converged=%s): %s",
            ctx.round_idx, n_perms, memo.evaluated, converged, sv,
        )
        return {
            "shapley_values": sv,
            "gtg_permutations": n_perms,
            "gtg_subset_evals": memo.evaluated,
            "gtg_converged": converged,
            **memo_extra,
            **_sv_crosscheck_extra(ctx, sv_arr, self.config),
        }
