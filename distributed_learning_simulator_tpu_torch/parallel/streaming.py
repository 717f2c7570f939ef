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
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.data.residency import (
    HostShardStore,
    tree_bytes,
    tree_map_np,
)
from distributed_learning_simulator_tpu_torch.ops.cohort import to_device
from distributed_learning_simulator_tpu_torch.telemetry import clock


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
                 device):
        self.store = store
        self._algorithm = algorithm
        self._n = n_clients
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._sampler = algorithm.config.participation_sampler.lower()
        self._sample_pending = 0.0
        self.last_sample_seconds = 0.0
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="cohort-upload"
        )
        self._pending = None  # (idx_list, stack, future)
        if self._cuda:
            self._stream = torch.cuda.Stream(self._device)
            # The pinned buffer set, reshaped when the upload's shapes change.
            self._buffers: list | None = None
        # Span tracing (telemetry/spans.py): attached when span_trace='on'.
        self.span_recorder = None
        self.span_round: int | None = None
        self.totals = {
            "h2d_bytes": 0, "h2d_seconds": 0.0, "hidden_seconds": 0.0,
            "d2h_bytes": 0, "d2h_seconds": 0.0, "sample_seconds": 0.0,
        }

    # ---- cohort replay -----------------------------------------------------
    def cohort_for(self, round_key, n=None, alive=None, k=None):
        """The host's copy of the cohort the round draws from ``round_key``
        (``Algorithm.cohort_indices``): a numpy index array, or None when
        the cohort is everyone. Timed into the next upload's ``sample_ms``
        and ``last_sample_seconds``. ``n``/``alive``/``k`` are the dynamic
        population's draw over the registered index space."""
        t0 = clock.monotonic()
        idx = self._algorithm.cohort_indices(
            round_key, self._n if n is None else n,
            alive=alive, n_participants=k,
        )
        dt = clock.monotonic() - t0
        self._sample_pending += dt
        self.last_sample_seconds = dt
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
        ended (:meth:`_upload` waits for it)."""
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

    def _upload(self, idx_list, stack: bool):
        """The worker's body: gather, copy and wait for the copy, timed."""
        with _maybe_span(self.span_recorder, "prefetch_upload", "stream",
                         round_idx=self.span_round) as sp:
            t0 = clock.monotonic()
            x, y, m, s, idx = self._gather(idx_list, stack)
            host = (np.ascontiguousarray(x), np.ascontiguousarray(y),
                    np.ascontiguousarray(m))
            ev = None
            if self._cuda:
                dev, ev = self._copy_cuda(host)
                ev.synchronize()  # this thread only; frees the buffers
            else:
                dev = (torch.as_tensor(host[0]),
                       torch.as_tensor(host[1], dtype=torch.int64),
                       torch.as_tensor(host[2]))
            nbytes = sum(int(a.nbytes) for a in host)
            if sp is not None:
                sp["bytes"] = nbytes
            return (dev, ev, s, idx), nbytes, clock.monotonic() - t0

    def _place(self, upload):
        """The compute stream's view of a finished upload: it waits on the
        copy's event and the tensors are marked as used on it."""
        (x, y, m), ev, s, idx = upload
        if ev is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(ev)
            for t in (x, y, m):
                t.record_stream(cur)
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

    # ---- writeback ---------------------------------------------------------
    def writeback(self, idx, new_state_k, stats: dict | None = None) -> None:
        """Copy the round's cohort state to the host and scatter it into
        the store (``Algorithm.scatter_client_state``); nothing for a
        stateless algorithm. ``stats`` gains the d2h fields."""
        if self.store.state is None:
            return
        t0 = clock.monotonic()
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
        in the dtypes of ``like`` (a one-client state tree)."""
        host = self._algorithm.gather_client_state(self.store, idx)
        return state_to_device(host, like)

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
