"""Host-side client residency: the full-population shard store
(data/residency.py of the JAX package, its single-host half).

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
