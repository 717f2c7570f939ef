"""The prefetched host-to-card cohort pipeline of
``client_residency='streamed'`` (parallel/streaming.py of the JAX package,
its single-host ``CohortStreamer``).

The population's per-client arrays live in the host shard store
(data/residency.py); this module owns their device side:

* **cohort replay**: the round's cohort is drawn on the host from the round
  key (``Algorithm.cohort_indices``), so the streamer knows which clients a
  dispatch trains before it runs; the draw is timed (the ``sample`` phase
  and the record's ``sample_ms``);
* **upload**: the cohort's shards are gathered from the store and copied to
  the card as the round's operands;
* **prefetch**: the next dispatch's upload runs on a worker thread while
  the current dispatch computes; ``overlap_ratio`` is the share of upload
  seconds hidden behind compute;
* **writeback**: persistent per-client state the round returns is copied
  back and scattered into the store, the source of truth between rounds.

On the card the worker gathers each cohort into one set of pinned host
buffers, copies it with ``non_blocking=True`` on a side CUDA stream of its
own (the current stream is per thread, so the worker enters the side stream
itself), and records an event. It waits for that event before it reports
the upload done, which times the upload up to the copy's end and frees the
pinned set: with at most one upload in flight the next one never refills
it while a copy reads it, so one set is enough. :meth:`CohortStreamer.acquire`
makes the compute stream wait on the event and marks the uploaded tensors
as used on it (``record_stream``): nothing there synchronizes the main
thread. The
compact uint8 shards go up as stored and are decoded on the card by the
round, exactly as the resident run decodes them; labels go up as the
store's int32 and widen to int64 on the side stream.

Every transfer is timed and byte-counted: the per-dispatch stats are the
schema-v5 ``stream`` record (utils/reporting.py), the run totals the result
dict's ``stream_*`` fields. The bytes are the ones copied to the card: the
shards, labels and masks (the sizes and indices the round reads on the
host).

**Under a single-process mesh** (``mesh_devices > 1``) the upload lands
as :class:`~..parallel.mesh.Blocks` over the cohort rows, each block on
its device of the mesh (views on the CPU slots), and the cohort's state
joins it; the writeback brings the blocks' state rows home first.

**Across processes** (``multihost``, :class:`DistributedCohortStreamer`)
each rank owns a slice of the population (data/residency.py
``DistributedShardStore``), every rank replays the whole cohort, and the
cohort is permuted so that each rank's block rows hold its own members
first (``plan_owner_assembly``): only the per-round ownership imbalance
("spill") crosses between ranks, in a padded gloo ``all_gather``
(parallel/multihost.py ``allgather_rows``), forward at the plan and back
at the writeback. Every collective runs on the main thread; the worker
thread only copies this rank's block to its device.
"""

from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.data.residency import (
    HostShardStore,
    plan_owner_assembly,
    tree_bytes,
    tree_leaves_np,
    tree_map_np,
)
from distributed_learning_simulator_tpu_torch.ops.cohort import to_device
from distributed_learning_simulator_tpu_torch.parallel.mesh import (
    Blocks,
    shard_client_data,
)
from distributed_learning_simulator_tpu_torch.parallel.multihost import (
    allgather_rows,
    allgather_wall_stamps,
)
from distributed_learning_simulator_tpu_torch.telemetry import clock

#: Straggler injection for the distributed-tracing tests: when set, this
#: rank sleeps that many seconds before each spill exchange, and the other
#: ranks' measured wait names it the slowest. Inert unless set.
ENV_STRAGGLE = "DLS_STRAGGLE_S"


def _maybe_straggle() -> None:
    s = os.environ.get(ENV_STRAGGLE)
    if s:
        time.sleep(float(s))


def state_to_host(tree):
    """A per-client state tree (a tensor or a dict of tensors) as numpy."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: state_to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def state_to_device(host_tree, like):
    """``host_tree`` (numpy) as tensors on the devices and in the dtypes of
    ``like``'s leaves (Adam's step count stays on the host); a copy the
    round may write in place, sent from pinned memory to a card."""
    if host_tree is None:
        return None
    if isinstance(like, dict):
        return {k: state_to_device(host_tree[k], like[k]) for k in like}
    t = torch.from_numpy(np.array(host_tree, copy=True))
    return to_device(t, like.device, like.dtype)


@contextlib.contextmanager
def _maybe_span(rec, name: str, cat: str, **kw):
    """A span when a recorder is attached, else nothing."""
    if rec is None:
        yield None
    else:
        with rec.span(name, cat, **kw) as extra:
            yield extra


class CohortStreamer:
    """The host shard store's device side: upload, prefetch, writeback.

    One dispatch's upload is ``(x, y, mask)`` on the card plus the host
    ``sizes`` and ``idx``: cohort-shaped for one round, or stacked ``[k,
    cohort, ...]`` for a dispatch of k rounds (config.rounds_per_dispatch).
    :meth:`prefetch` schedules it on the one worker thread (at most one in
    flight); :meth:`acquire` collects it, or uploads at once
    when nothing, or another cohort, is pending."""

    def __init__(self, store: HostShardStore, algorithm, n_clients: int,
                 device, mesh=None):
        self.store = store
        self._algorithm = algorithm
        self._n = n_clients
        self._device = torch.device(device)
        # A single-process mesh (parallel/mesh.py): uploads land as Blocks
        # over the cohort rows.
        self._mesh = mesh
        self._cuda = self._device.type == "cuda"
        self._sampler = algorithm.config.participation_sampler.lower()
        self._sample_pending = 0.0
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="cohort-upload"
        )
        self._pending = None  # (idx_list, stack, future)
        if self._cuda:
            self._stream = torch.cuda.Stream(self._device)
            # The pinned buffer set, reshaped when the upload's shapes change.
            self._buffers: list | None = None
        # Span tracing (telemetry/spans.py): attached when span_trace='on',
        # with this rank's clock offset against rank 0.
        self.span_recorder = None
        self.clock_offset_s = 0.0
        self.span_round: int | None = None
        self.totals = {
            "h2d_bytes": 0, "h2d_seconds": 0.0, "hidden_seconds": 0.0,
            "d2h_bytes": 0, "d2h_seconds": 0.0, "sample_seconds": 0.0,
        }

    # ---- cohort replay -----------------------------------------------------
    def cohort_for(self, round_key, n=None, alive=None, k=None):
        """The host's copy of the cohort the round draws from ``round_key``
        (``Algorithm.cohort_indices``): a numpy index array, or None when
        the cohort is everyone. Timed into the next upload's
        ``sample_ms``. ``n``/``alive``/``k`` are the dynamic
        population's draw over the registered index space."""
        t0 = clock.monotonic()
        idx = self._algorithm.cohort_indices(
            round_key, self._n if n is None else n,
            alive=alive, n_participants=k,
        )
        dt = clock.monotonic() - t0
        self._sample_pending += dt
        self.totals["sample_seconds"] += dt
        return None if idx is None else np.asarray(idx)

    # ---- upload / prefetch -------------------------------------------------
    def _gather(self, idx_list, stack: bool):
        """The dispatch's host arrays ``(x, y, mask, sizes, idx)``."""
        slices = [self.store.gather_data(idx) for idx in idx_list]
        if not stack:
            x, y, m, s = slices[0]
            idx = (None if idx_list[0] is None
                   else np.asarray(idx_list[0]))
        else:
            x, y, m, s = (np.stack([sl[j] for sl in slices])
                          for j in range(4))
            idx = np.stack([np.asarray(i) for i in idx_list])
        return x, y, m, s, idx

    def _copy_cuda(self, host):
        """``host`` (x, y, mask) to the card through the pinned buffer set,
        on the side stream; returns the device tensors and the copy's event.
        Runs on the worker thread, after the previous upload's copy has
        ended (:meth:`_to_device` waits for it)."""
        bufs = self._buffers
        if bufs is None or any(
            b.shape != a.shape or b.numpy().dtype != a.dtype
            for b, a in zip(bufs, host)
        ):
            bufs = [torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                pin_memory=True) for a in host]
            self._buffers = bufs
        for b, a in zip(bufs, host):
            np.copyto(b.numpy(), a)
        with torch.cuda.stream(self._stream):
            x, y, m = (b.to(self._device, non_blocking=True) for b in bufs)
            y = y.to(torch.int64)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return (x, y, m), ev

    def _to_device(self, x, y, m):
        """Host ``(x, y, mask)`` as tensors on this streamer's device and
        the copy's event (None on the CPU). On the card the copy goes
        through the pinned set on the side stream and is waited for on
        this thread only, which frees the set: run it on the worker."""
        host = (np.ascontiguousarray(x), np.ascontiguousarray(y),
                np.ascontiguousarray(m))
        if not self._cuda:
            return (torch.as_tensor(host[0]),
                    torch.as_tensor(host[1], dtype=torch.int64),
                    torch.as_tensor(host[2])), None
        dev, ev = self._copy_cuda(host)
        ev.synchronize()
        return dev, ev

    def _upload(self, idx_list, stack: bool):
        """The worker's body: gather, copy and wait for the copy, timed."""
        with _maybe_span(self.span_recorder, "prefetch_upload", "stream",
                         round_idx=self.span_round) as sp:
            t0 = clock.monotonic()
            x, y, m, s, idx = self._gather(idx_list, stack)
            dev, ev = self._to_device(x, y, m)
            nbytes = sum(int(a.nbytes) for a in (x, y, m))
            if sp is not None:
                sp["bytes"] = nbytes
            return (dev, ev, s, idx), nbytes, clock.monotonic() - t0

    def _place(self, upload):
        """The compute stream's view of a finished upload: it waits on the
        copy's event and the tensors are marked as used on it. Under a
        mesh the arrays become Blocks over the cohort rows (a stacked
        dispatch's, one Blocks a round)."""
        (x, y, m), ev, s, idx = upload
        if ev is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(ev)
            for t in (x, y, m):
                t.record_stream(cur)
        if self._mesh is not None and idx is not None:
            if idx.ndim == 2:
                x, y, m = (
                    [shard_client_data(a[i], self._mesh)
                     for i in range(a.shape[0])]
                    for a in (x, y, m))
            else:
                x, y, m = shard_client_data((x, y, m), self._mesh)
        return x, y, m, s, idx

    def prefetch(self, idx_list, stack: bool = False) -> None:
        """Schedule the next dispatch's upload and return at once."""
        if self._pending is not None:
            self._pending[2].result()
            self._pending = None
        self._pending = (idx_list, stack,
                         self._pool.submit(self._upload, idx_list, stack))

    def acquire(self, idx_list, stack: bool = False):
        """The upload of ``idx_list``, the prefetched one when it matches.
        Returns ``((x, y, mask, sizes, idx), stats)``, the tensors on the
        card and ``sizes``/``idx`` on the host; ``stats`` is this upload's
        share of the stream record."""
        upload = None
        if self._pending is not None:
            pend_idx, pend_stack, fut = self._pending
            self._pending = None
            if (
                pend_stack == stack
                and len(pend_idx) == len(idx_list)
                and all(np.array_equal(a, b)
                        for a, b in zip(pend_idx, idx_list))
            ):
                t0 = clock.monotonic()
                upload, nbytes, dt = fut.result()
                blocked = clock.monotonic() - t0
                hidden = max(dt - blocked, 0.0)
            else:
                # A cohort the loop no longer wants (a resume or a
                # preemption changed the sequence): its bytes still moved.
                _, stale_bytes, stale_dt = fut.result()
                self.totals["h2d_bytes"] += stale_bytes
                self.totals["h2d_seconds"] += stale_dt
        if upload is None:
            upload, nbytes, dt = self._pool.submit(
                self._upload, idx_list, stack).result()
            hidden = 0.0
        self.totals["h2d_bytes"] += nbytes
        self.totals["h2d_seconds"] += dt
        self.totals["hidden_seconds"] += hidden
        stats = {
            "h2d_bytes": nbytes,
            "h2d_seconds": round(dt, 6),
            "hidden_seconds": round(hidden, 6),
            "overlap_ratio": round(hidden / dt, 4) if dt > 0 else 0.0,
        }
        if any(idx is not None for idx in idx_list):
            stats["sampler"] = self._sampler
            stats["sample_ms"] = round(self._sample_pending * 1e3, 3)
            self._sample_pending = 0.0
        return self._place(upload), stats

    def upload_full(self):
        """One upload of the whole population (participation_fraction >= 1,
        e.g. sign_SGD's vote over everyone): the arrays stay on the card
        for the run."""
        upload, nbytes, dt = self._pool.submit(
            self._upload, [None], False).result()
        self.totals["h2d_bytes"] += nbytes
        self.totals["h2d_seconds"] += dt
        stats = {
            "h2d_bytes": nbytes,
            "h2d_seconds": round(dt, 6),
            "hidden_seconds": 0.0,
            "overlap_ratio": 0.0,
        }
        return self._place(upload), stats

    # ---- one round's cohort, keyed by its plan -----------------------------
    def plan(self, idx):
        """One round's assembly of the cohort ``idx``: the cohort itself,
        its rows in draw order. :class:`DistributedCohortStreamer` permutes
        it across ranks and runs the spill exchange. Main thread."""
        return idx

    def cohort_ids(self, plan) -> np.ndarray:
        """The cohort of ``plan`` in draw order."""
        return plan

    def prefetch_plan(self, plan) -> None:
        """Schedule ``plan``'s upload and return at once."""
        self.prefetch([plan])

    def acquire_plan(self, plan):
        """``plan``'s upload, the prefetched one when it matches. Returns
        ``((x, y, mask, sizes, idx, draw_pos), stats, plan)``: ``idx`` the
        cohort's ids in row order, ``draw_pos`` the draw position of each
        row (None: the rows are in draw order)."""
        (x, y, m, s, idx), stats = self.acquire([plan])
        return (x, y, m, s, idx, None), stats, plan

    def multihost_record(self, plan, stats: dict) -> dict | None:
        """The schema-v11 ``multihost`` record sub-object: None in one
        process."""
        return None

    # ---- writeback ---------------------------------------------------------
    def writeback(self, idx, new_state_k, stats: dict | None = None) -> None:
        """Copy the round's cohort state to the host and scatter it into
        the store (``Algorithm.scatter_client_state``); nothing for a
        stateless algorithm. ``stats`` gains the d2h fields."""
        if self.store.state is None:
            return
        t0 = clock.monotonic()
        if isinstance(new_state_k, Blocks):
            new_state_k = new_state_k.full(self._device)
        host_state = state_to_host(new_state_k)
        self._algorithm.scatter_client_state(self.store, idx, host_state)
        dt = clock.monotonic() - t0
        nbytes = tree_bytes(host_state)
        self.totals["d2h_bytes"] += nbytes
        self.totals["d2h_seconds"] += dt
        if stats is not None:
            stats["d2h_bytes"] = nbytes
            stats["d2h_seconds"] = round(dt, 6)

    def gather_state(self, idx, like):
        """The cohort's persistent state from the store, on the devices and
        in the dtypes of ``like`` (a one-client state tree); Blocks over
        the cohort rows under a mesh."""
        host = self._algorithm.gather_client_state(self.store, idx)
        state = state_to_device(host, like)
        if self._mesh is not None:
            state = shard_client_data(state, self._mesh)
        return state

    # ---- reporting ---------------------------------------------------------
    def overlap_ratio(self) -> float:
        """The run's share of upload seconds hidden behind compute."""
        total = self.totals["h2d_seconds"]
        return self.totals["hidden_seconds"] / total if total > 0 else 0.0

    def close(self) -> None:
        if self._pending is not None:
            try:
                self._pending[2].result()
            except Exception:
                pass
            self._pending = None
        self._pool.shutdown(wait=True)


# --- the distributed shard store's streamer ---------------------------------


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad a row payload to the exchange's common row count."""
    if a.shape[0] == rows:
        return a
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def _pad_bucket(n: int) -> int:
    """A spill row count rounded up to the next power of two, so that a
    run's exchanges take at most log2(cohort) distinct payload shapes."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _host_rows(t: torch.Tensor) -> np.ndarray:
    """A state leaf's rows on the host: a card's through a pinned
    buffer."""
    if t.device.type != "cuda":
        return t.detach().numpy()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf.numpy()


def _unflatten_like(tree, leaves: list):
    """``tree``'s structure (tree_map_np's containers) over ``leaves``, in
    :func:`tree_leaves_np` order."""
    it = iter(leaves)
    return tree_map_np(lambda _: next(it), tree)


class _ExecPlan:
    """One round's owner-sharded assembly, resolved for THIS rank.

    Wraps the global :class:`data.residency.AssemblyPlan` (the same on
    every rank) with this rank's routing: which of its block rows hold its
    own members, where each spill-in row comes from in the forward
    exchange, and where each of its spilled-out members sits for the
    writeback; plus the assembled host-side data block once
    :meth:`DistributedCohortStreamer.plan` has run the exchange. The plan
    keeps that block alive until its upload has been waited on."""

    def __init__(self, plan, host_id: int):
        self.plan = plan
        self.idx = plan.idx
        self.blo = int(plan.block_bounds[host_id])
        self.bhi = int(plan.block_bounds[host_id + 1])
        occupants_q = plan.draw_pos[self.blo:self.bhi]
        own = plan.owners[occupants_q] == host_id
        self.own_rows_rel = np.flatnonzero(own)
        self.own_ids = plan.idx[occupants_q[own]]
        # Spill-in: rows of this rank's block served by other ranks.
        sel_in = plan.spill_block == host_id
        self.in_rows_rel = plan.spill_rows[sel_in] - self.blo
        self.in_src_host = plan.spill_owner[sel_in]
        self.in_src_slot = plan.slot_in_owner[sel_in]
        # Spill-out: this rank's members placed in other ranks' blocks.
        sel_out = plan.spill_owner == host_id
        self.out_ids = plan.spill_ids[sel_out]
        self.out_block = plan.spill_block[sel_out]
        self.out_slot = plan.slot_in_block[sel_out]
        self.total_spill = int(plan.spill_q.size)
        self.pad_fwd = _pad_bucket(int(plan.send_counts().max()))
        self.pad_back = _pad_bucket(int(plan.recv_counts().max()))
        self.data_block = None  # filled by DistributedCohortStreamer.plan
        self.dcn_bytes = 0
        self.assemble_seconds = 0.0


class DistributedCohortStreamer(CohortStreamer):
    """Owner-sharded cohort assembly across ranks (the JAX package's
    ``DistributedCohortStreamer``).

    The population lives rank-sharded (data/residency.py
    ``DistributedShardStore``: each rank owns N/ranks clients); the hashed
    sampler lets every rank replay the whole cohort, and each round's
    cohort is permuted into owner-contiguous rows aligned with the mesh's
    cohort blocks (``plan_owner_assembly``). Each rank then serves its own
    members into its block rows on its device; the only client data that
    crosses between ranks is the per-round ownership imbalance ("spill",
    expected O(sqrt(cohort)) rows), moved by a padded gloo ``all_gather``
    and byte-counted into ``dcn_bytes``. The ``draw_pos`` operand of the
    upload sends each row's training keys and failure flag back to draw
    order (algorithms/fedavg.py), which keeps every client's training that
    of the one-process run.

    Threading contract: the exchange is a collective, so it runs on the
    MAIN thread, at the same point of the round loop on every rank
    (:meth:`plan`, :meth:`gather_state`, :meth:`writeback`); the
    worker thread only copies this rank's block to its device. A
    collective on the worker thread could interleave differently on two
    ranks and deadlock them."""

    def __init__(self, store, algorithm, n_clients: int, device, mesh,
                 block_bounds, sizes):
        super().__init__(store, algorithm, n_clients, device, mesh=mesh)
        self._host = store.host_id
        self._n_hosts = store.n_hosts
        self._block_bounds = np.asarray(block_bounds, np.int64)
        self._cohort = int(self._block_bounds[-1])
        # The whole population's weights, known to every rank (the
        # partition is deterministic): the round reads the cohort's.
        self._sizes = np.asarray(sizes, dtype=np.float32)
        self.totals.update({"dcn_bytes": 0, "spill_rows": 0})

    # ---- exchange ----------------------------------------------------------
    def _allgather(self, leaves, pad: int, name: str = "spill"):
        """Padded exchange of per-rank row payloads: every rank sends
        ``pad`` rows a leaf (zeros past its real count, which every rank
        knows from the shared plan); returns ``[n_hosts, pad, ...]`` a
        leaf. Collective: main thread only.

        With a span recorder the exchange is a ``<name>_wait`` span (a
        wall-stamp gather whose length is set by the last rank to arrive;
        the stamps give the round's barrier skew) and a ``<name>_xfer``
        span (the payload gather). The wait span is eager: a rank stuck
        there while a peer dies leaves its open line on disk."""
        _maybe_straggle()
        rec = self.span_recorder
        if rec is not None:
            with rec.span(f"{name}_wait", "dcn_wait",
                          round_idx=self.span_round, eager=True) as w:
                stamps = allgather_wall_stamps(
                    clock.wall() - self.clock_offset_s)
                skew_ms = float(stamps.max() - stamps.min()) * 1e3
                w["skew_ms"] = round(skew_ms, 3)
            if self.span_round is not None:
                rec.note_skew(self.span_round, "spill_skew_ms", skew_ms)
        padded = [_pad_rows(np.asarray(a), pad) for a in leaves]
        with _maybe_span(rec, f"{name}_xfer", "dcn",
                         round_idx=self.span_round) as x:
            gathered = allgather_rows(padded)
            nbytes = sum(int(g.nbytes) for g in gathered)
            if x is not None:
                x["bytes"] = nbytes
        self.totals["dcn_bytes"] += nbytes
        return gathered, nbytes

    def _assemble_block(self, ex: _ExecPlan, local_leaves):
        """This rank's block rows of each leaf: its own members from its
        slice, the spill-in rows from the forward exchange."""
        own_local = self.store.to_local(ex.own_ids)
        send_local = (self.store.to_local(ex.out_ids) if ex.out_ids.size
                      else np.empty(0, np.int64))
        gathered = None
        if ex.total_spill:
            send = [np.take(np.asarray(a), send_local, axis=0)
                    for a in local_leaves]
            gathered, nbytes = self._allgather(send, ex.pad_fwd)
            ex.dcn_bytes += nbytes
        out = []
        for li, a in enumerate(local_leaves):
            a = np.asarray(a)
            blk = np.empty((ex.bhi - ex.blo,) + a.shape[1:], a.dtype)
            if ex.own_rows_rel.size:
                blk[ex.own_rows_rel] = np.take(a, own_local, axis=0)
            if ex.in_rows_rel.size:
                blk[ex.in_rows_rel] = gathered[li][ex.in_src_host,
                                                   ex.in_src_slot]
            out.append(blk)
        return out

    # ---- planning ----------------------------------------------------------
    def plan(self, idx_np) -> _ExecPlan:
        """One round's owner-sharded assembly: the global plan and this
        rank's data block with its spill-in rows exchanged. Main thread
        (the exchange is a collective)."""
        t0 = clock.monotonic()
        p = plan_owner_assembly(np.asarray(idx_np, np.int64),
                                self.store.owner_bounds, self._block_bounds)
        ex = _ExecPlan(p, self._host)
        ex.data_block = self._assemble_block(
            ex, [self.store.x, self.store.y, self.store.mask,
                 self.store.sizes])
        ex.assemble_seconds = clock.monotonic() - t0
        self.totals["spill_rows"] += ex.total_spill
        return ex

    # ---- placement ---------------------------------------------------------
    def _blocks(self, local, bounds, n_rows: int):
        """``local`` (this rank's rows, a tensor or a dict of them) as
        Blocks of the mesh, the other ranks' parts None."""
        mesh = self._mesh
        shape = (None if isinstance(local, dict)
                 else (n_rows,) + tuple(local.shape[1:]))
        return Blocks(mesh, [local if mesh.is_local(b) else None
                             for b in range(mesh.size)],
                      np.asarray(bounds, np.int64), shape)

    def _upload_plan(self, ex: _ExecPlan):
        """The worker's body: this rank's block to its device (the exchange
        already ran in :meth:`plan`, on the main thread), waited for."""
        with _maybe_span(self.span_recorder, "prefetch_upload", "stream",
                         round_idx=self.span_round) as sp:
            t0 = clock.monotonic()
            # Waited for here: the pinned set is free again, and the plan's
            # blocks may go.
            upload = self._to_device(*ex.data_block[:3])
            nbytes = sum(int(b.nbytes) for b in ex.data_block) + int(
                ex.plan.idx_perm.nbytes + ex.plan.draw_pos.nbytes)
            if sp is not None:
                sp["bytes"] = nbytes
            return upload, nbytes, clock.monotonic() - t0

    def _place_plan_arrays(self, arrays, ev, bounds, n_rows: int):
        """The compute stream's view of this rank's uploaded block rows:
        it waits on the copy's event, the tensors are marked as used on
        it, and each becomes Blocks of ``n_rows`` rows cut at
        ``bounds``."""
        if ev is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(ev)
            for t in arrays:
                t.record_stream(cur)
        return [self._blocks(t, bounds, n_rows) for t in arrays]

    def _place_plan(self, ex: _ExecPlan, upload):
        """A finished block upload as Blocks of the cohort rows, with the
        host operands."""
        dev, ev = upload
        x, y, m = self._place_plan_arrays(dev, ev, self._block_bounds,
                                          self._cohort)
        idx_perm = ex.plan.idx_perm
        return (x, y, m, self._sizes[idx_perm], idx_perm,
                np.asarray(ex.plan.draw_pos))

    # ---- upload / prefetch (keyed by the plan) -----------------------------
    def cohort_ids(self, ex: _ExecPlan) -> np.ndarray:
        return ex.idx

    def prefetch_plan(self, ex: _ExecPlan) -> None:
        if self._pending is not None:
            self._pending[2].result()
            self._pending = None
        self._pending = (ex, False, self._pool.submit(self._upload_plan, ex))

    def acquire_plan(self, ex: _ExecPlan):
        """The upload for ``ex``, the prefetched one when it matches.
        Returns ``((x, y, mask, sizes, idx, draw_pos), stats, ex)``: Blocks
        of the cohort rows, the cohort's weights and ids in row order and
        ``draw_pos`` on the host."""
        upload = None
        if self._pending is not None:
            pend_ex, _, fut = self._pending
            self._pending = None
            if pend_ex is ex or np.array_equal(pend_ex.idx, ex.idx):
                t0 = clock.monotonic()
                upload, nbytes, dt = fut.result()
                blocked = clock.monotonic() - t0
                hidden = max(dt - blocked, 0.0)
                ex = pend_ex
            else:
                _, stale_bytes, stale_dt = fut.result()
                self.totals["h2d_bytes"] += stale_bytes
                self.totals["h2d_seconds"] += stale_dt
        if upload is None:
            upload, nbytes, dt = self._pool.submit(
                self._upload_plan, ex).result()
            hidden = 0.0
        self.totals["h2d_bytes"] += nbytes
        self.totals["h2d_seconds"] += dt
        self.totals["hidden_seconds"] += hidden
        stats = {
            "h2d_bytes": nbytes,
            "h2d_seconds": round(dt, 6),
            "hidden_seconds": round(hidden, 6),
            "overlap_ratio": round(hidden / dt, 4) if dt > 0 else 0.0,
            "sampler": self._sampler,
            "sample_ms": round(self._sample_pending * 1e3, 3),
        }
        self._sample_pending = 0.0
        return self._place_plan(ex, upload), stats, ex

    # ---- persistent per-client state ---------------------------------------
    def gather_state(self, ex: _ExecPlan, like):
        """This rank's block of the cohort's persistent state (own rows
        from its slice, spill-in rows exchanged) on its device, in the
        dtypes of ``like`` (a one-client state tree), as Blocks; None for
        a stateless algorithm. Main thread (collective)."""
        if self.store.state is None:
            return None
        state = tree_map_np(np.asarray, self.store.state)
        blocks = self._assemble_block(ex, tree_leaves_np(state))
        local = state_to_device(_unflatten_like(state, blocks), like)
        return self._blocks(local, self._block_bounds, self._cohort)

    def writeback(self, ex, new_state_k, stats: dict | None = None):
        """The round's cohort state back to its OWNERS: this rank keeps
        its own members' rows of its block and returns the spill rows to
        their owners through the reverse exchange. Main thread
        (collective)."""
        if self.store.state is None:
            return
        t0 = clock.monotonic()
        local = next(p for p in new_state_k.parts if p is not None)
        host_state = tree_map_np(_host_rows, local)
        leaves = tree_leaves_np(host_state)
        if ex.own_ids.size:
            self._algorithm.scatter_client_state(
                self.store, ex.own_ids,
                _unflatten_like(host_state,
                                [a[ex.own_rows_rel] for a in leaves]))
        if ex.total_spill:
            gathered, dcn = self._allgather(
                [a[ex.in_rows_rel] for a in leaves], ex.pad_back,
                name="writeback")
            ex.dcn_bytes += dcn
            if ex.out_ids.size:
                self._algorithm.scatter_client_state(
                    self.store, ex.out_ids,
                    _unflatten_like(host_state,
                                    [g[ex.out_block, ex.out_slot]
                                     for g in gathered]))
        dt = clock.monotonic() - t0
        nbytes = sum(int(a.nbytes) for a in leaves)
        self.totals["d2h_bytes"] += nbytes
        self.totals["d2h_seconds"] += dt
        if stats is not None:
            stats["d2h_bytes"] = nbytes
            stats["d2h_seconds"] = round(dt, 6)

    # ---- full-cohort regime ------------------------------------------------
    def upload_full(self):
        """One upload of the whole population: each rank places its OWNED
        slice as its block of the client axis (the owner bounds are the
        mesh's blocks). Nothing crosses between ranks."""
        t0 = clock.monotonic()
        x, y, m, _ = self.store.gather_data(None)
        # On the worker, as every upload (the side stream is its own).
        dev, ev = self._pool.submit(self._to_device, x, y, m).result()
        arrays = tuple(self._place_plan_arrays(
            dev, ev, self.store.owner_bounds,
            int(self.store.owner_bounds[-1])))
        nbytes = self.store.data_bytes()
        dt = clock.monotonic() - t0
        self.totals["h2d_bytes"] += nbytes
        self.totals["h2d_seconds"] += dt
        stats = {
            "h2d_bytes": nbytes,
            "h2d_seconds": round(dt, 6),
            "hidden_seconds": 0.0,
            "overlap_ratio": 0.0,
        }
        return arrays + (self._sizes, None), stats

    # ---- reporting ---------------------------------------------------------
    def multihost_record(self, ex: _ExecPlan | None, stats: dict) -> dict:
        """The schema-v11 ``multihost`` record sub-object: this rank's
        slice of the population and the round's assembly traffic: every
        byte its exchanges moved (data and state forward, state back).
        The round's spill rows and bytes live here only: the ``stream``
        sub-object keeps the schema's fields (utils/reporting.py
        ``build_round_record`` routes both)."""
        shard_bytes = self.store.data_bytes()
        if self.store.state is not None:
            shard_bytes += self.store.state_bytes()
        return {
            "hosts": self._n_hosts,
            "host_id": self._host,
            "owned_clients": self.store.n_owned,
            "shard_bytes": int(shard_bytes),
            "spill_rows": int(ex.total_spill) if ex is not None else 0,
            "dcn_bytes": int(ex.dcn_bytes) if ex is not None else 0,
            "h2d_seconds": stats.get("h2d_seconds", 0.0),
            "overlap_ratio": stats.get("overlap_ratio", 0.0),
        }


def host_client_state(algorithm, optimizer, global_flat, n_clients: int):
    """The population's per-client state on the host (streamed residency):
    one client's initial state repeated ``n_clients`` times, which is the
    state the resident run would gather (every client's initial state is
    the same). Returns ``(host tree or None, one-client device tree)``."""
    proto = algorithm.init_client_state(optimizer, global_flat, 1)
    if proto is None:
        return None, None
    host = tree_map_np(
        lambda a: np.repeat(np.asarray(a), n_clients, axis=0),
        state_to_host(proto),
    )
    return host, proto
