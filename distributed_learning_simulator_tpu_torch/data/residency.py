"""Host-side client residency: the full-population shard store
and its multihost view, the distributed shard store (data/residency.py of
the JAX package).

Under ``client_residency='streamed'`` the per-client arrays (the packed data
shards and any persistent per-client state) live here, in host memory, for
the whole population, and only the sampled cohort's slice goes to the card
for a round (parallel/streaming.py owns the upload; this module owns the
arrays and the index math). It imports numpy only: its gather and scatter
are the host mirror of ops/cohort.py's ``cohort_take`` and
``cohort_scatter``.

Per-client state trees are dicts, lists, tuples or namedtuples of arrays;
``None`` is a leaf that passes through.
"""

from __future__ import annotations

import numpy as np

from distributed_learning_simulator_tpu_torch.data.partition import (
    ClientData,
    _compact_encode,
    _unit_range,
)


def tree_map_np(fn, *trees):
    """``fn`` over the leaves of ``trees`` (which share one structure of
    dicts, lists, tuples and namedtuples), as ``jax.tree_util.tree_map``;
    ``None`` passes through."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map_np(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):  # namedtuple
        return type(t0)(
            *(tree_map_np(fn, *leaves) for leaves in zip(*trees))
        )
    if isinstance(t0, (list, tuple)):
        mapped = [tree_map_np(fn, *leaves) for leaves in zip(*trees)]
        return type(t0)(mapped)
    if t0 is None:
        return None
    return fn(*trees)


def tree_leaves_np(tree) -> list:
    """The non-None leaves of ``tree`` (the containers of
    :func:`tree_map_np`), in traversal order."""
    out: list = []

    def walk(t):
        if isinstance(t, dict):
            for k in t:
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for c in t:
                walk(c)
        elif t is not None:
            out.append(t)

    walk(tree)
    return out


def tree_bytes(tree) -> int:
    """Total bytes of every array leaf in ``tree``."""
    return sum(int(np.asarray(leaf).nbytes) for leaf in tree_leaves_np(tree))


class HostShardStore:
    """The population's client arrays in host memory, gathered per cohort.

    Owns the packed data shards (``x``/``y``/``mask``/``sizes``, the
    data/partition.py layout) and, when the algorithm keeps persistent
    per-client state under participation sampling, the population's state
    tree. Between rounds the store is the source of truth: checkpoints read
    it, and a round's cohort state is scattered back into it.
    """

    def __init__(self, x, y, mask, sizes, state=None):
        self.x = np.ascontiguousarray(x)
        self.y = np.ascontiguousarray(y)
        self.mask = np.ascontiguousarray(mask)
        self.sizes = np.ascontiguousarray(sizes)
        self.state = state
        # population='dynamic' (:meth:`grow`): every grown array becomes a
        # view of a capacity-doubling backing buffer, keyed here by name or
        # state leaf position, so that joins never re-copy the population.
        self._grow_backing: dict = {}
        # The per-client valuation vector (telemetry/valuation.py), attached
        # under client_valuation='on', so that the store owns every
        # population-sized array between rounds.
        self.valuation = None
        n = self.x.shape[0]
        if not (self.y.shape[0] == self.mask.shape[0]
                == self.sizes.shape[0] == n):
            raise ValueError(
                "client-axis length mismatch: "
                f"x={n}, y={self.y.shape[0]}, mask={self.mask.shape[0]}, "
                f"sizes={self.sizes.shape[0]}"
            )
        for leaf in tree_leaves_np(state):
            if np.asarray(leaf).ndim >= 1 and np.asarray(leaf).shape[0] != n:
                raise ValueError(
                    "per-client state leaf has client-axis length "
                    f"{np.asarray(leaf).shape[0]}, store has {n}"
                )

    @property
    def n_clients(self) -> int:
        return self.x.shape[0]

    def _check_idx(self, idx) -> np.ndarray:
        idx = np.asarray(idx)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_clients):
            raise IndexError(
                f"cohort index out of range [0, {self.n_clients}): "
                f"[{idx.min()}, {idx.max()}]"
            )
        return idx

    def gather_data(self, idx=None):
        """The cohort's data shards ``(x, y, mask, sizes)``; ``idx=None``
        is the whole population (the store's own arrays, no copy)."""
        if idx is None:
            return self.x, self.y, self.mask, self.sizes
        idx = self._check_idx(idx)
        return (
            np.take(self.x, idx, axis=0),
            np.take(self.y, idx, axis=0),
            np.take(self.mask, idx, axis=0),
            np.take(self.sizes, idx, axis=0),
        )

    def gather_state(self, idx=None):
        """The cohort's rows of the persistent per-client state tree."""
        if self.state is None:
            return None
        if idx is None:
            return self.state
        idx = self._check_idx(idx)
        return tree_map_np(
            lambda a: np.take(np.asarray(a), idx, axis=0), self.state
        )

    def scatter_state(self, idx, cohort_state) -> None:
        """Write a round's cohort state back at rows ``idx``, in place; the
        other rows keep their values. ``idx`` is duplicate-free (a cohort
        drawn without replacement); ``idx=None`` replaces the whole tree."""
        if self.state is None:
            if cohort_state is not None and tree_leaves_np(cohort_state):
                raise ValueError(
                    "scatter_state on a store with no per-client state"
                )
            return
        if idx is None:
            self.state = tree_map_np(np.asarray, cohort_state)
            return
        idx = self._check_idx(idx)

        def put(full, part):
            full = np.asarray(full)
            full[idx] = np.asarray(part)
            return full

        self.state = tree_map_np(put, self.state, cohort_state)

    def attach_state(self, state) -> None:
        """Adopt a population-sized state tree after construction (the
        dynamic-population resume builds the store first), length-checked
        as the constructor checks it."""
        for leaf in tree_leaves_np(state):
            arr = np.asarray(leaf)
            if arr.ndim >= 1 and arr.shape[0] != self.n_clients:
                raise ValueError(
                    "per-client state leaf has client-axis length "
                    f"{arr.shape[0]}, store has {self.n_clients}"
                )
        self.state = state

    def grow(self, x, y, mask, sizes, state_rows=None) -> int:
        """Append joined clients' rows (population='dynamic',
        robustness/population.py); returns the first new client index.

        The data shards, the state tree's leaves (``state_rows``, the same
        structure, gives the joiners' rows) and the attached valuation
        vector (zeros for a joiner) move to capacity-doubling backing
        buffers on their first growth, so a population's rows are copied
        O(log N) times over any growth schedule. A grow that raises leaves
        the store as it was."""
        x = np.asarray(x)
        n_new = x.shape[0]
        if n_new == 0:
            return self.n_clients
        rows = {
            "x": x, "y": np.asarray(y), "mask": np.asarray(mask),
            "sizes": np.asarray(sizes),
        }
        for name, new_rows in rows.items():
            cur = getattr(self, name)
            if new_rows.shape[0] != n_new or (
                new_rows.shape[1:] != cur.shape[1:]
            ):
                raise ValueError(
                    f"joined {name} rows have shape {new_rows.shape}, "
                    f"store rows are {cur.shape[1:]} x {n_new} clients"
                )
        if self.state is not None and state_rows is None:
            raise ValueError(
                "store carries per-client state; grow() needs "
                "state_rows for the joined clients"
            )
        if self.state is None and state_rows is not None and (
            tree_leaves_np(state_rows)
        ):
            raise ValueError("grow() got state_rows on a stateless store")
        first = self.n_clients
        need = first + n_new

        def grow_one(key, cur, new_rows):
            """The capacity-doubled append of one array."""
            cur = np.asarray(cur)
            new_rows = np.asarray(new_rows)
            buf = self._grow_backing.get(key)
            if buf is None or need > buf.shape[0] or (
                buf.dtype != cur.dtype or buf.shape[1:] != cur.shape[1:]
            ):
                buf = np.empty(
                    (max(2 * cur.shape[0], need),) + cur.shape[1:],
                    cur.dtype,
                )
                buf[: cur.shape[0]] = cur
                self._grow_backing[key] = buf
            elif cur.base is not buf:
                # Replaced since the last grow (a resume's attach, a whole
                # tree scatter): refresh the resident rows.
                buf[: cur.shape[0]] = cur
            buf[first:need] = new_rows.astype(buf.dtype, copy=False)
            return buf[:need]

        for name, new_rows in rows.items():
            setattr(self, name, grow_one((name,), getattr(self, name),
                                         new_rows))
        if self.state is not None:
            counter = iter(range(1_000_000))
            # tree_map_np walks in a fixed order: the leaf position is a
            # stable backing key across grows.
            self.state = tree_map_np(
                lambda a, r: grow_one(("state", next(counter)), a, r),
                self.state, state_rows,
            )
        if self.valuation is not None:
            self.valuation = grow_one(
                ("valuation",), self.valuation,
                np.zeros(n_new, dtype=np.float64),
            )
        return first

    def attach_valuation(self, values) -> None:
        """Adopt the per-client valuation vector (telemetry/valuation.py)
        as a store-owned population array, length-checked."""
        values = np.asarray(values, dtype=np.float64)
        if values.shape != (self.n_clients,):
            raise ValueError(
                f"valuation vector has shape {values.shape}, store has "
                f"{self.n_clients} clients"
            )
        self.valuation = values

    def data_bytes(self) -> int:
        """Host bytes of the population's data shards."""
        return (self.x.nbytes + self.y.nbytes + self.mask.nbytes
                + self.sizes.nbytes)

    def cohort_data_bytes(self, cohort: int) -> int:
        """Device bytes of one uploaded cohort's data."""
        n = self.n_clients
        per_client = self.data_bytes() / max(n, 1)
        return int(per_client * min(cohort, n))

    def state_bytes(self) -> int:
        return tree_bytes(self.state)

    def cohort_state_bytes(self, cohort: int) -> int:
        n = self.n_clients
        return int(self.state_bytes() / max(n, 1) * min(cohort, n))


# --- distributed shard store (multihost streamed residency) ----------------
#
# ``client_residency='streamed'`` + ``multihost``: the full-N client
# arrays no longer live in ONE process's RAM — each rank owns a
# contiguous N/num_hosts slice (data + persistent algorithm state), and
# the per-round cohort is assembled owner-sharded: every rank replays
# the same round-key-deterministic cohort, permutes it into
# owner-contiguous groups aligned with the mesh's cohort blocks (a rank's
# block rows live on its device of parallel/mesh.py's mesh), and serves
# its own members directly (parallel/streaming.DistributedCohortStreamer
# owns the device side). Everything here is numpy index math, a copy of
# the JAX package's, pinned equal to it by
# tests/test_torch_distributed_store.py.


def host_axis_bounds(length: int, devices_per_host) -> np.ndarray:
    """Contiguous per-host boundaries of a sharded axis.

    ``devices_per_host[h]`` is how many of the mesh's devices process h
    contributes (parallel/multihost.mesh_devices_per_host derives it from
    the mesh's device order). Host h covers rows
    ``[bounds[h], bounds[h+1])`` — proportional to its device share, so
    when the axis length divides the device count the host blocks are
    exactly the union of the host's device shards (the full-cohort
    upload case); otherwise the floor split keeps every boundary
    deterministic from (length, device counts) alone, which is what the
    checkpoint manifest records and re-validates at resume.
    """
    devs = np.asarray(devices_per_host, dtype=np.int64)
    if devs.size < 1 or (devs <= 0).any():
        raise ValueError(
            f"devices_per_host must be positive, got {devs.tolist()}"
        )
    cum = np.concatenate([[0], np.cumsum(devs)])
    return (length * cum) // cum[-1]


def owner_of(idx, bounds) -> np.ndarray:
    """Owning host of each global client id under ``bounds``
    (:func:`host_axis_bounds` layout)."""
    return np.searchsorted(
        np.asarray(bounds)[1:-1], np.asarray(idx), side="right"
    )


class AssemblyPlan:
    """One round's owner-sharded cohort assembly (pure index math).

    Every host computes the SAME plan from the same replayed cohort, so
    the spill exchange needs no negotiation: each field below is global
    knowledge.

    * ``idx`` — the cohort's global client ids in DRAW order (the order
      the 1-process round trains them in).
    * ``draw_pos`` — for each cohort ROW p (the device layout's
      position), the draw position of the client placed there. The
      round program uses it to permute its per-POSITION draws (training
      keys, fault flags) back to the draw-order assignment, which is
      what keeps the owner-permuted run equal to the draw-order run
      per client (algorithms/fedavg.py, the streamed round's
      ``draw_pos``).
    * ``row_of`` — inverse of ``draw_pos``.
    * spill_* — the members whose assigned row lies in ANOTHER host's
      block (assignment fills each host's block with its OWN members
      first, so spill is only the per-round ownership imbalance,
      expected O(sqrt(cohort)) rows — the only client data that ever
      crosses DCN). Canonical order: ascending destination row, shared
      by the send and receive sides of both exchange directions.
    """

    def __init__(self, idx, owners, draw_pos, row_of, spill_q,
                 spill_rows, spill_owner, spill_block, owner_bounds,
                 block_bounds):
        self.idx = idx
        self.owners = owners
        self.draw_pos = draw_pos
        self.row_of = row_of
        self.spill_q = spill_q            # draw positions, canonical order
        self.spill_rows = spill_rows      # their destination rows
        self.spill_owner = spill_owner    # who owns (sends) each entry
        self.spill_block = spill_block    # whose block receives it
        self.owner_bounds = np.asarray(owner_bounds, np.int64)
        self.block_bounds = np.asarray(block_bounds, np.int64)
        # Slot of each spill entry within its sender's send list and its
        # receiver's block list — the padded-exchange addressing both
        # transfer directions share (forward: owner -> block host;
        # writeback: block host -> owner).
        self.slot_in_owner = _cumcount(spill_owner)
        self.slot_in_block = _cumcount(spill_block)
        self.spill_ids = idx[spill_q]

    @property
    def n_hosts(self) -> int:
        return len(self.owner_bounds) - 1

    @property
    def cohort(self) -> int:
        return self.idx.size

    @property
    def idx_perm(self) -> np.ndarray:
        """Cohort ids in ROW order (owner-grouped) — the round program's
        ``idx`` operand under the distributed layout."""
        return self.idx[self.draw_pos]

    def send_counts(self) -> np.ndarray:
        return np.bincount(self.spill_owner, minlength=self.n_hosts)

    def recv_counts(self) -> np.ndarray:
        return np.bincount(self.spill_block, minlength=self.n_hosts)


def _cumcount(groups: np.ndarray) -> np.ndarray:
    """Occurrence rank of each element within its group value (stable)."""
    out = np.zeros(groups.size, dtype=np.int64)
    for g in np.unique(groups):
        m = groups == g
        out[m] = np.arange(int(m.sum()))
    return out


def plan_owner_assembly(idx, owner_bounds, block_bounds) -> AssemblyPlan:
    """Assign each cohort member a device-layout row, own-block first.

    ``idx``: global cohort ids in draw order. ``owner_bounds``: the
    store's client-space ownership split. ``block_bounds``: the cohort
    row-space per-host addressable blocks (same shape, cohort length).
    Each host's block is filled with its own members in draw order;
    members beyond a block's capacity (the per-round ownership
    imbalance) take the remaining free rows in ascending row order —
    those are the spill entries the hosts exchange. Deterministic pure
    function of its inputs; H=1 reduces to the identity assignment
    (``draw_pos == arange``, no spill) — the num_hosts==1 zero-cost
    contract.
    """
    idx = np.asarray(idx, dtype=np.int64)
    owner_bounds = np.asarray(owner_bounds, dtype=np.int64)
    block_bounds = np.asarray(block_bounds, dtype=np.int64)
    c = idx.size
    if block_bounds[-1] != c or block_bounds[0] != 0:
        raise ValueError(
            f"block bounds {block_bounds.tolist()} do not cover the "
            f"cohort (size {c})"
        )
    if len(owner_bounds) != len(block_bounds):
        raise ValueError(
            "owner and block bounds disagree on the host count: "
            f"{len(owner_bounds) - 1} vs {len(block_bounds) - 1}"
        )
    owners = owner_of(idx, owner_bounds)
    n_hosts = len(owner_bounds) - 1
    row_of = np.full(c, -1, dtype=np.int64)
    overflow_parts: list[np.ndarray] = []
    free_parts: list[np.ndarray] = []
    for h in range(n_hosts):
        lo, hi = int(block_bounds[h]), int(block_bounds[h + 1])
        mine = np.flatnonzero(owners == h)
        take = mine[: hi - lo]
        row_of[take] = lo + np.arange(take.size)
        overflow_parts.append(mine[hi - lo:])
        if take.size < hi - lo:
            free_parts.append(np.arange(lo + take.size, hi))
    overflow = (
        np.concatenate(overflow_parts) if overflow_parts
        else np.empty(0, np.int64)
    )
    free = (
        np.concatenate(free_parts) if free_parts else np.empty(0, np.int64)
    )
    # A host has either overflow or free rows, never both, so every
    # overflow assignment is cross-host by construction; sizes match
    # because both count C minus the in-own-block placements.
    row_of[overflow] = free[: overflow.size]
    draw_pos = np.empty(c, dtype=np.int64)
    draw_pos[row_of] = np.arange(c)
    order = np.argsort(row_of[overflow], kind="stable")
    spill_q = overflow[order]
    spill_rows = row_of[spill_q]
    return AssemblyPlan(
        idx, owners, draw_pos, row_of, spill_q, spill_rows,
        owners[spill_q], owner_of(spill_rows, block_bounds),
        owner_bounds, block_bounds,
    )


class DistributedShardStore(HostShardStore):
    """The host shard store's owner-indexed multihost view.

    Process ``host_id`` of ``n_hosts`` owns the contiguous global client
    slice ``[bounds[host_id], bounds[host_id+1])``; the constructor takes
    the FULL arrays every process materializes at startup (the dataset
    partition is deterministic, so all hosts derive the same full-N
    view) and keeps ONLY its owned slice — per-host RAM scales as
    N/num_hosts, which is what lets a million-client population span
    hosts none of which could hold it alone. All index arguments stay
    GLOBAL client ids; the store maps them to local rows and refuses
    ids it does not own (an out-of-slice gather is an assembly-plan bug,
    never something to serve silently). numpy only, like the base class.
    """

    def __init__(self, x, y, mask, sizes, state=None, *, host_id: int,
                 owner_bounds):
        owner_bounds = np.asarray(owner_bounds, dtype=np.int64)
        n_global = int(owner_bounds[-1])
        if np.asarray(x).shape[0] != n_global:
            raise ValueError(
                f"owner bounds cover {n_global} clients but x has "
                f"{np.asarray(x).shape[0]} rows"
            )
        if not 0 <= host_id < len(owner_bounds) - 1:
            raise ValueError(
                f"host_id {host_id} out of range for "
                f"{len(owner_bounds) - 1} hosts"
            )
        self.host_id = int(host_id)
        self.owner_bounds = owner_bounds
        self.n_global = n_global
        self.lo = int(owner_bounds[host_id])
        self.hi = int(owner_bounds[host_id + 1])
        # np.array(..., copy=True): own the slice outright so the caller
        # can free the full-N arrays — the memory claim of the feature.
        super().__init__(
            np.array(np.asarray(x)[self.lo:self.hi]),
            np.array(np.asarray(y)[self.lo:self.hi]),
            np.array(np.asarray(mask)[self.lo:self.hi]),
            np.array(np.asarray(sizes)[self.lo:self.hi]),
            state=state,
        )

    @property
    def n_hosts(self) -> int:
        return len(self.owner_bounds) - 1

    @property
    def n_owned(self) -> int:
        return self.hi - self.lo

    def to_local(self, idx) -> np.ndarray:
        """Map global client ids to local rows; refuse non-owned ids."""
        idx = np.asarray(idx)
        if idx.size and (idx.min() < self.lo or idx.max() >= self.hi):
            raise IndexError(
                f"host {self.host_id} owns clients [{self.lo}, {self.hi})"
                f" but was asked for ids in [{idx.min()}, {idx.max()}] — "
                "owner-sharded assembly must route these through their "
                "owning host's spill exchange"
            )
        return idx - self.lo

    def gather_data(self, idx=None):
        """``idx=None`` returns the OWNED slice (the host's share of a
        full-population upload); otherwise global ids -> owned rows."""
        if idx is None:
            return self.x, self.y, self.mask, self.sizes
        return super().gather_data(self.to_local(idx))

    def gather_state(self, idx=None):
        if idx is None or self.state is None:
            return self.state
        return super().gather_state(self.to_local(idx))

    def scatter_state(self, idx, cohort_state) -> None:
        if self.state is None or idx is None:
            super().scatter_state(idx, cohort_state)
            return
        super().scatter_state(self.to_local(idx), cohort_state)

    def grow(self, *args, **kwargs):
        raise NotImplementedError(
            "population='dynamic' does not compose with the distributed "
            "shard store (config.validate names the refusal): growth "
            "would re-partition ownership mid-run"
        )

    def attach_valuation(self, values) -> None:
        raise NotImplementedError(
            "client_valuation='on' does not compose with the distributed "
            "shard store (config.validate names the refusal): the "
            "valuation vector is a full-N host array with one owner"
        )


def synthetic_stream_shards(x_train, y_train, n_clients: int,
                            shard_size: int, seed: int = 0) -> ClientData:
    """A population of ``n_clients`` shards of ``shard_size`` samples each,
    drawn in one gather from a small sample pool (with replacement across
    clients), in the packed layout: uint8-compact when the pool lies in
    [0, 1], float32 otherwise, full masks. The vectorized counterpart of
    ``pack_client_shards`` for population-scale runs (a million clients),
    as the JAX package's."""
    n_pool = x_train.shape[0]
    sample_shape = tuple(x_train.shape[1:])
    dim = int(np.prod(sample_shape))
    ok, _, _ = _unit_range(x_train)
    if ok:
        pool = _compact_encode(
            x_train.reshape(n_pool, dim).astype(np.float32), n_pool, dim
        )
    else:
        pool = np.asarray(x_train, dtype=np.float32)
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, n_pool, size=(n_clients, shard_size))
    return ClientData(
        x=pool[ix],
        y=np.asarray(y_train, dtype=np.int32)[ix],
        mask=np.ones((n_clients, shard_size), dtype=np.float32),
        sizes=np.full(n_clients, float(shard_size), dtype=np.float32),
        sample_shape=sample_shape,
    )
