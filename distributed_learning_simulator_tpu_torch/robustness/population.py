"""Open-world client populations: joins, departures, drift
(robustness/population.py of the JAX package).

``config.population='dynamic'`` drives a round-key-chained registration
stream:

* **joins** (``join_rate`` a round): new clients register; their shards
  are IID draws from the training set at the packed slot size, keyed by the
  stream, appended to the host shard store (``HostShardStore.grow``). A
  joiner can be sampled from the next round.
* **departures** (``depart_rate``): each alive client departs with that
  probability a round; departed ids are masked out of the hashed sampler's
  stream and never drawn again. A departure that hits a client sampled in
  the same round zeroes its contribution in the round (the ``departed``
  operand of algorithms/fedavg.py), and the quorum counts it. Departures
  are capped so that at least a cohort stays alive (excess draws dropped
  in id order).
* **drift** (``drift_fraction``/``drift_factor``): a planted cohort of the
  startup population whose labels degrade on a schedule: member of rank j
  of m ramps linearly over the run toward ``drift_factor * (j+1)/m`` of
  its labels relabeled at random. The corruption is absolute per round, so
  applying it lazily, to sampled drifting clients just before their slice
  is gathered, is idempotent and exact across a resume.

The three streams come from ``fold_in(round_key, _POP_FOLD +
population_seed)``; the Threefry draws run in numpy (ops/sampling.py), the
fold_in over the port's key chain (ops/prng.py), so every event equals the
JAX package's. The stream's state (alive mask, registered count, joined
shards) is checkpointed and restored, so a resume mid-growth stitches
bitwise. The cohort stays pinned at the startup population's sampled
size while N grows.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from distributed_learning_simulator_tpu_torch.data.partition import (
    _compact_encode,
)
from distributed_learning_simulator_tpu_torch.data.residency import (
    tree_map_np,
)
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.sampling import threefry2x32

#: fold_in salt decoupling the registration stream from every other
#: round-key consumer (failure_seed / arrival_seed use the same
#: discipline with their own constants).
_POP_FOLD = 104729

#: Counter-lane tags separating the three event streams drawn from one
#: round's fold_in words (the x1 word of the Threefry counter).
_LANE_DEPART = 1
_LANE_JOIN = 2
_LANE_SHARD = 3

#: Drift-cohort member ids are listed in per-round records only up to
#: this size (the PER_CLIENT_CAP discipline — large cohorts report their
#: size, never a list that bloats metrics.jsonl).
DRIFT_IDS_CAP = 32

def pop_key_words(round_key, seed: int) -> np.ndarray:
    """The uint32 key words of a round's registration stream:
    ``key_data(fold_in(round_key, _POP_FOLD + seed))``, over the port's
    numpy key chain."""
    return np.asarray(
        prng.key_data(prng.fold_in(round_key, _POP_FOLD + seed))).ravel()


def _stream_uniform(words, lane: int, start: int, size: int) -> np.ndarray:
    """``size`` uniform [0, 1) draws from the round's registration-stream
    words at counter positions ``start..start+size-1`` of ``lane`` —
    pure numpy (ops/sampling.threefry2x32 with xp=np), so the stream is
    unit-testable without a backend and identical on every host."""
    kw = np.asarray(words).ravel()
    ctr = np.arange(start, start + size, dtype=np.uint32)
    v0, _ = threefry2x32(
        np, np.uint32(kw[0]), np.uint32(kw[1]), ctr,
        np.full(size, lane, np.uint32),
    )
    return v0.astype(np.float64) / 2.0**32


def _stream_ints(words, lane: int, size: int, n: int) -> np.ndarray:
    """``size`` stream integers in [0, n) (shard sample draws — the
    ~n/2^32 modulo bias is statistically irrelevant for data sampling,
    unlike the cohort draw's exactly-uniform contract)."""
    kw = np.asarray(words).ravel()
    ctr = np.arange(size, dtype=np.uint32)
    v0, _ = threefry2x32(
        np, np.uint32(kw[0]), np.uint32(kw[1]), ctr,
        np.full(size, lane, np.uint32),
    )
    return (v0 % np.uint32(n)).astype(np.int64)


@dataclass
class PopulationEvents:
    """One round's registration-stream outcome (drawn BEFORE the round's
    dispatch — the departure mask is a round-program operand — and
    APPLIED after it: a joiner is sampleable from the next round)."""

    round_idx: int
    joins: int
    departs: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64)
    )


class PopulationModel:
    """The dynamic population's host-side owner (see module docstring).

    State: the ``alive`` bool mask over the registered index space and
    ``n_registered`` (the index space's current size; the store's
    client-axis length tracks it). The model never touches device state
    — the streamed cohort pipeline is population-size-free by
    construction, which is the whole design.
    """

    @classmethod
    def from_config(cls, config, n_initial: int, cohort: int,
                    dataset=None) -> "PopulationModel | None":
        """None when ``population='static'`` — every call site gates on
        that, so static runs execute the exact pre-feature path."""
        mode = config.population.lower()
        if mode == "static":
            return None
        return cls(config, n_initial, cohort, dataset=dataset)

    def __init__(self, config, n_initial: int, cohort: int, dataset=None):
        self.config = config
        self.n0 = int(n_initial)
        self.cohort = int(cohort)
        self.seed = int(config.population_seed)
        self.join_rate = float(config.join_rate)
        self.depart_rate = float(config.depart_rate)
        self.total_rounds = int(config.round)
        self.alive = np.ones(self.n0, dtype=bool)
        self.n_registered = self.n0
        self.totals = {"joins": 0, "departs": 0}
        # Round whose events were last APPLIED — the registration-stream
        # cursor the checkpoint carries (resume must not re-apply or
        # skip a round's events).
        self.cursor = -1
        # Join-shard source: the training set the growing index space
        # draws from (None = joins refuse; tests exercising only
        # departures/drift may omit the dataset).
        self._x_train = None
        self._x_compact = None  # the training set uint8-encoded, lazily
        self._y_train = None
        self._num_classes = None
        if dataset is not None:
            self._x_train = np.asarray(dataset.x_train)
            self._y_train = np.asarray(dataset.y_train)
            self._num_classes = int(dataset.num_classes)
        # ---- planted drift cohort (startup population only) ----------------
        m = int(round(float(config.drift_fraction)
                      * self.n0))
        factor = float(config.drift_factor)
        rng = np.random.default_rng(self.seed + 9973)
        self.drift_ids = (
            np.sort(rng.choice(self.n0, size=m, replace=False))
            if m > 0 else np.zeros(0, np.int64)
        )
        order = rng.permutation(m)
        #: grade[i] = peak corruption fraction of drift_ids[i] — a
        #: monotone gradient over the (shuffled) cohort, the planted
        #: ground truth valuation is correlated against.
        self.drift_grades = (
            factor * (order + 1.0) / m if m > 0 else np.zeros(0)
        )
        # Per-member corruption pack, built lazily from the store rows
        # the first time the member is sampled: (original y row, valid-
        # slot corruption order, fixed noise labels).
        self._drift_pack: dict[int, tuple] = {}
        self._drift_index = {
            int(c): i for i, c in enumerate(self.drift_ids)
        }

    # ---- event stream -------------------------------------------------------
    def draw_events(self, words, round_idx: int) -> PopulationEvents:
        """Round ``round_idx``'s registration events from its fold_in
        words (``fold_in(round_key, _POP_FOLD + seed)`` key
        data — the simulator derives them once per round). Pure: the
        model's state is only changed by :meth:`apply`."""
        joins = 0
        if self.join_rate > 0.0:
            base = int(self.join_rate)
            frac = self.join_rate - base
            joins = base
            if frac > 0.0 and _stream_uniform(words, _LANE_JOIN, 0, 1)[0] < (
                frac
            ):
                joins += 1
        departs = np.zeros(0, np.int64)
        if self.depart_rate > 0.0:
            # Keyed by TRUE client index (counter = id): a client's
            # departure draw is stable under any array packing.
            u = _stream_uniform(words, _LANE_DEPART, 0, self.n_registered)
            cand = np.flatnonzero(self.alive & (u < self.depart_rate))
            # Cap: the alive population must keep at least a cohort's
            # worth of clients (the sampler has to fill k slots). Joins
            # land after this round's draw, so the cap ignores them;
            # excess draws are dropped in index order — deterministic.
            allowed = max(0, int(self.alive.sum()) - self.cohort)
            departs = cand[:allowed].astype(np.int64)
        return PopulationEvents(
            round_idx=round_idx, joins=joins, departs=departs
        )

    def cohort_departed_mask(self, events: PopulationEvents,
                            cohort_ids) -> np.ndarray:
        """Bool mask over the round's sampled cohort: which members
        depart THIS round (the round program's ``departed`` operand —
        their contribution is zeroed in-program, quorum-visible)."""
        return np.isin(np.asarray(cohort_ids), events.departs)

    # ---- join shards --------------------------------------------------------
    def _join_rows(self, store, events: PopulationEvents, words):
        """Packed shard rows for this round's joiners: IID draws from
        the training set at the store's slot size, keyed by the
        registration stream — 'the partitioner over a growing index
        space'. Matches the store layout (compact uint8 or float32)."""
        if self._x_train is None:
            raise ValueError(
                "population='dynamic' with join_rate > 0 needs the "
                "dataset (the growing index space draws joiners' shards "
                "from the training set); run through run_simulation or "
                "pass dataset= to PopulationModel"
            )
        n_new = events.joins
        slots = store.x.shape[1]
        idx = _stream_ints(words, _LANE_SHARD, n_new * slots,
                           self._x_train.shape[0])
        if store.x.dtype == np.uint8:
            # The uint8 encoding is elementwise, so the training set is
            # encoded once and the joiners' samples gathered from it (the
            # same bytes as encoding each round's draw).
            if self._x_compact is None:
                n = self._x_train.shape[0]
                self._x_compact = _compact_encode(
                    self._x_train.reshape(n, -1).astype(np.float32), n,
                    store.x.shape[2],
                )
            x_rows = self._x_compact[idx].reshape(n_new, slots, -1)
        else:
            x_rows = self._x_train[idx].astype(store.x.dtype).reshape(
                (n_new, slots) + store.x.shape[2:]
            )
        y_rows = self._y_train[idx].astype(np.int32).reshape(n_new, slots)
        mask_rows = np.ones((n_new, slots), dtype=np.float32)
        sizes_rows = np.full(n_new, float(slots), dtype=np.float32)
        return x_rows, y_rows, mask_rows, sizes_rows

    # ---- state transitions --------------------------------------------------
    def apply(self, events: PopulationEvents, store,
              state_proto=None, words=None) -> None:
        """Apply one round's events to the population state + store:
        joins append (sampleable from the NEXT round), departures clear
        the alive mask (never resampled). ``state_proto`` is a one-row
        per-client state tree (None for stateless algorithms) replicated
        per joiner."""
        if events.joins > 0:
            x_r, y_r, m_r, s_r = self._join_rows(store, events, words)
            state_rows = None
            if store.state is not None:
                if state_proto is None:
                    raise ValueError(
                        "store carries per-client state; joins need a "
                        "state_proto row"
                    )
                state_rows = tree_map_np(
                    lambda a: np.repeat(
                        np.asarray(a), events.joins, axis=0
                    ),
                    state_proto,
                )
            store.grow(x_r, y_r, m_r, s_r, state_rows=state_rows)
            self.alive = np.concatenate(
                [self.alive, np.ones(events.joins, dtype=bool)]
            )
            self.n_registered += events.joins
            self.totals["joins"] += events.joins
        if events.departs.size:
            self.alive[events.departs] = False
            self.totals["departs"] += int(events.departs.size)
        self.cursor = events.round_idx

    # ---- drift --------------------------------------------------------------
    def _drift_level(self, round_idx: int, rank: int, n_valid: int) -> int:
        """Corrupted-slot count of drift member ``rank`` at ``round_idx``:
        its grade ramping linearly over the run (absolute, not
        incremental — resume-exact by construction)."""
        ramp = min(1.0, (round_idx + 1) / max(self.total_rounds, 1))
        return int(round(self.drift_grades[rank] * ramp * n_valid))

    def apply_drift(self, store, round_idx: int, ids=None) -> None:
        """Set the drifting members of ``ids`` (None = the whole drift
        cohort) to their round-``round_idx`` corruption level, in place
        in the store's label rows. Lazy + absolute: only sampled members
        pay, and re-applying any level is idempotent."""
        if self.drift_ids.size == 0:
            return
        members = (
            self.drift_ids if ids is None
            else np.intersect1d(np.asarray(ids), self.drift_ids)
        )
        for cid in members:
            cid = int(cid)
            rank = self._drift_index[cid]
            pack = self._drift_pack.get(cid)
            if pack is None:
                orig = np.array(store.y[cid], copy=True)
                valid = np.flatnonzero(store.mask[cid] > 0)
                rng = np.random.default_rng(
                    self.seed * 1_000_003 + 7 * cid + 13
                )
                order = valid[rng.permutation(valid.size)]
                if self._num_classes is not None:
                    n_cls = self._num_classes
                else:
                    n_cls = int(store.y.max()) + 1
                noise = rng.integers(
                    0, n_cls, size=order.size
                ).astype(store.y.dtype)
                pack = (orig, order, noise)
                self._drift_pack[cid] = pack
            orig, order, noise = pack
            k = self._drift_level(round_idx, rank, order.size)
            row = np.array(orig, copy=True)
            row[order[:k]] = noise[:k]
            store.y[cid] = row

    # ---- checkpoint / resume ------------------------------------------------
    def checkpoint_state(self, store) -> dict:
        """The registration stream's resume payload: cursor, alive mask,
        and the JOINED clients' shard rows (drawn from past round keys a
        resumed run cannot replay — the initial-N rows re-derive from
        the dataset partition, and drift re-applies lazily from its
        absolute schedule)."""
        return {
            "cursor": self.cursor,
            "n_initial": self.n0,
            "n_registered": int(self.n_registered),
            "alive": self.alive.copy(),
            "joined": {
                "x": np.array(store.x[self.n0:]),
                "y": np.array(store.y[self.n0:]),
                "mask": np.array(store.mask[self.n0:]),
                "sizes": np.array(store.sizes[self.n0:]),
            },
            "totals": dict(self.totals),
        }

    def restore(self, saved: dict, store) -> None:
        """Re-enter a checkpointed population state (resume mid-growth):
        grow the store by the saved joined rows, restore the alive mask
        and cursor. The store must still be at the startup population
        (the caller builds it from the dataset partition first)."""
        if saved["n_initial"] != self.n0:
            raise ValueError(
                f"checkpoint population has n_initial="
                f"{saved['n_initial']}, this run partitions "
                f"{self.n0} startup clients; resume with the "
                "configuration the checkpoint was written with"
            )
        if store.n_clients != self.n0:
            raise ValueError(
                "population restore needs the store at the startup "
                f"population ({self.n0}), got {store.n_clients}"
            )
        j = saved["joined"]
        if j["x"].shape[0]:
            store.grow(j["x"], j["y"], j["mask"], j["sizes"])
        self.n_registered = int(saved["n_registered"])
        if store.n_clients != self.n_registered:
            raise ValueError(
                "checkpoint joined rows do not add up: store has "
                f"{store.n_clients} clients, checkpoint registered "
                f"{self.n_registered}"
            )
        self.alive = np.asarray(saved["alive"], dtype=bool).copy()
        self.totals = dict(saved["totals"])
        self.cursor = int(saved["cursor"])

    # ---- records ------------------------------------------------------------
    def round_record(self, events: PopulationEvents,
                     cohort_departs: int) -> dict:
        """The schema-v9 ``population`` sub-object of this round's
        metrics record (utils/reporting.build_round_record attaches it;
        ``rejected_by_churn`` is filled by the emitter once the round's
        quorum verdict is known)."""
        record = {
            # Startup population on every record: a resumed run's
            # metrics file may not start at round 0, and the reporter's
            # growth ratio must not mistake the resume-time population
            # for the run's origin.
            "n_initial": self.n0,
            "n_registered": int(self.n_registered),
            "n_alive": int(self.alive.sum()),
            "joins": int(events.joins),
            "departs": int(events.departs.size),
            "cohort_departs": int(cohort_departs),
            "drift_cohort_size": int(self.drift_ids.size),
            "rejected_by_churn": False,
        }
        if 0 < self.drift_ids.size <= DRIFT_IDS_CAP:
            # Small planted cohorts list their ids so report_run can
            # overlay them on the valuation tables (the PER_CLIENT_CAP
            # discipline: large cohorts report the size only).
            record["drift_clients"] = [int(c) for c in self.drift_ids]
        return record

    def summary(self, churn_rejected: int = 0) -> dict:
        """The result dict's ``population_summary``."""
        return {
            "mode": "dynamic",
            "n_initial": self.n0,
            "n_registered": int(self.n_registered),
            "n_alive": int(self.alive.sum()),
            "joins_total": self.totals["joins"],
            "departs_total": self.totals["departs"],
            "growth_ratio": round(self.n_registered / self.n0, 4),
            "drift_cohort_size": int(self.drift_ids.size),
            "rounds_rejected_by_churn": int(churn_rejected),
        }
