"""Span journals and the crash flight recorder (telemetry/spans.py of the
JAX package), line for line in its journal format, so that
``scripts/trace_timeline.py`` reads a port run's journal.

* :class:`SpanRecorder` — ``begin``/``end`` stamp ``clock.monotonic()`` and
  append one dict to a bounded in-memory ring (``deque(maxlen=...)``; an
  overflow counts into ``dropped`` and never blocks). ``flush()`` drains
  completed spans to a per-host ``spans_<host_id>.jsonl`` journal once a
  round.
* The flight recorder is the same ring read out under failure. A span
  begun with ``eager=True`` (the per-round envelope, checkpoint writes:
  anything that can hang or die inside) also writes an ``open`` line at
  its begin, flushed to the OS before the span's body runs, so a SIGKILLed
  process leaves its open span on disk. ``flush_inflight(reason)`` is the
  soft-failure path (SIGTERM, a round rejected by quorum, an unhandled
  exception): the last K completed spans, a ``flight`` marker and one
  ``inflight`` line per span still open.
* :class:`SpanPhaseTimer` wraps the phase timer (telemetry/phases.py, or
  its null twin) so that every phase boundary is also a span, at any
  ``telemetry_level``.

Journal lines (JSONL, one object a line): ``header`` (host identity, the
clock anchors ``epoch_wall``/``epoch_mono`` sampled back to back, the
clock offset against host 0), ``open``, ``span`` (``t0`` monotonic,
``dur`` seconds), ``event`` (an instant: compiles, dispatch marks),
``flight`` (the force-flush's ``reason``, and the innermost span an
exception escaped from as ``in_span``) and ``inflight``.

Span categories (``cat``): ``round``, ``phase``, ``io`` (checkpoint
writes), ``compile`` (recompile-counter events), ``dispatch``, and the
categories only a multi-host or streamed run emits, ``dcn_wait``, ``dcn``
and ``stream`` (ROADMAP.md items 15 and 17), which the port keeps in the
record layout. ``round_summary()`` folds a round's spans into the
schema-v12 ``spans`` sub-object (utils/reporting.py).

Spans measure host time: under ``basic`` telemetry device work pools into
the span that first blocks on it, as with the phase timer. Everything here
is thread-safe. ``span_trace='off'`` (the default) builds none of this.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading

from distributed_learning_simulator_tpu_torch.telemetry import clock

JOURNAL_VERSION = 1

#: A host's journal file, beside metrics.jsonl (or in ``span_dir``).
JOURNAL_PATTERN = "spans_{host_id}.jsonl"


def journal_filename(host_id: int) -> str:
    return JOURNAL_PATTERN.format(host_id=int(host_id))


class SpanRecorder:
    """Bounded in-memory span ring and per-host JSONL journal. A span costs
    a dict and a deque append under a lock; the journal is written in
    ``flush()``, at eager begins and on the failure paths."""

    def __init__(self, host_id: int = 0, n_hosts: int = 1,
                 capacity: int = 4096, flush_last_k: int = 64):
        if capacity < 1:
            raise ValueError(f"span buffer capacity must be >= 1: {capacity}")
        if flush_last_k < 1:
            raise ValueError(f"flush_last_k must be >= 1: {flush_last_k}")
        self.host_id = int(host_id)
        self.n_hosts = int(n_hosts)
        self.capacity = int(capacity)
        self.flush_last_k = int(flush_last_k)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._open: dict[int, dict] = {}
        self._next_id = 0
        self._dropped = 0
        self._round_agg: dict[int, dict] = {}
        # Skews measured after their round's record was written: merged
        # into the next round_summary.
        self._pending_skews: dict[str, float] = {}
        self._run = {"count": 0, "by_cat": {}, "skews": {}}
        # The innermost span an exception unwound through: the flight
        # marker's ``in_span`` (every span has closed by the time the crash
        # handler runs).
        self._last_error: dict | None = None
        self._file = None
        self.journal_path: str | None = None
        self._closed = False

    # ---- journal -----------------------------------------------------------
    def attach(self, directory: str, clock_offset_s: float = 0.0,
               clock_uncertainty_s: float = 0.0) -> str:
        """Open ``spans_<host_id>.jsonl`` under ``directory`` and write the
        header line. Returns the path."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, journal_filename(self.host_id))
        epoch_wall = clock.wall()
        epoch_mono = clock.monotonic()
        header = {
            "kind": "header",
            "journal_version": JOURNAL_VERSION,
            "host_id": self.host_id,
            "n_hosts": self.n_hosts,
            "pid": os.getpid(),
            "epoch_wall": epoch_wall,
            "epoch_mono": epoch_mono,
            "clock_offset_s": float(clock_offset_s),
            "clock_uncertainty_s": float(clock_uncertainty_s),
            "span_trace": "on",
        }
        with self._lock:
            self._file = open(path, "w", encoding="utf-8")
            self.journal_path = path
            self._file.write(json.dumps(header) + "\n")
            self._file.flush()
        return path

    # ---- spans -------------------------------------------------------------
    def begin(self, name: str, cat: str, round_idx: int | None = None,
              eager: bool = False, **attrs) -> int:
        """Open a span; returns its id for :meth:`end`. ``eager=True``
        writes an ``open`` line now and flushes it to the OS."""
        t0 = clock.monotonic()
        span = {"id": -1, "name": name, "cat": cat, "t0": t0}
        if round_idx is not None:
            span["round"] = int(round_idx)
        if attrs:
            span["attrs"] = attrs
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            span["id"] = sid
            self._open[sid] = span
            if eager and self._file is not None:
                line = {"kind": "open", **{k: span[k] for k in span
                                           if k != "attrs"}}
                if attrs:
                    line["attrs"] = attrs
                self._file.write(json.dumps(line) + "\n")
                self._file.flush()
        return sid

    def end(self, span_id: int, **attrs) -> float:
        """Close a span; returns its seconds. ``attrs`` merge into its
        record."""
        t1 = clock.monotonic()
        with self._lock:
            span = self._open.pop(span_id, None)
            if span is None:
                return 0.0
            dur = t1 - span["t0"]
            span["dur"] = dur
            if attrs:
                span.setdefault("attrs", {}).update(attrs)
            self._append_locked(span)
            self._aggregate_locked(span)
        return dur

    @contextlib.contextmanager
    def span(self, name: str, cat: str, round_idx: int | None = None,
             eager: bool = False, **attrs):
        """Context-manager form of begin/end. Yields a dict the body may
        fill with result attrs."""
        extra: dict = {}
        sid = self.begin(name, cat, round_idx=round_idx, eager=eager,
                         **attrs)
        try:
            yield extra
        except BaseException as e:
            err = {"name": name, "cat": cat, "error": type(e).__name__}
            if round_idx is not None:
                err["round"] = int(round_idx)
            with self._lock:
                if self._last_error is None:
                    self._last_error = err
            raise
        finally:
            self.end(sid, **extra)

    def event(self, name: str, cat: str, round_idx: int | None = None,
              **attrs) -> None:
        """An instant event (a compile, a dispatch mark)."""
        ev = {"kind": "event", "name": name, "cat": cat,
              "t": clock.monotonic()}
        if round_idx is not None:
            ev["round"] = int(round_idx)
        if attrs:
            ev["attrs"] = attrs
        with self._lock:
            self._append_locked(ev)
            self._run["count"] += 1
            if round_idx is not None:
                agg = self._agg_for_locked(round_idx)
                agg["count"] += 1

    def note_skew(self, round_idx: int, key: str, skew_ms: float) -> None:
        """A measured barrier skew into the round's summary (the largest
        of a round's)."""
        with self._lock:
            agg = self._agg_for_locked(round_idx)
            prev = agg["skews"].get(key)
            if prev is None or skew_ms > prev:
                agg["skews"][key] = float(skew_ms)
            self._note_run_skew_locked(key, skew_ms)

    def note_pending_skew(self, key: str, skew_ms: float) -> None:
        """:meth:`note_skew` for a barrier after its round's record was
        written: merged into the next :meth:`round_summary`."""
        with self._lock:
            prev = self._pending_skews.get(key)
            if prev is None or skew_ms > prev:
                self._pending_skews[key] = float(skew_ms)
            self._note_run_skew_locked(key, skew_ms)

    # ---- draining ----------------------------------------------------------
    def flush(self) -> int:
        """Drain completed spans and events to the journal. Returns the
        lines written (0 with no journal: the ring then keeps the last
        ``capacity`` entries as a flight recorder)."""
        with self._lock:
            if self._file is None:
                return 0
            n = 0
            while self._ring:
                rec = self._ring.popleft()
                self._file.write(json.dumps(self._line_locked(rec)) + "\n")
                n += 1
            if n:
                self._file.flush()
            return n

    def flush_inflight(self, reason: str) -> int:
        """Force-flush for the failure paths: the last K completed spans, a
        ``flight`` marker carrying ``reason``, one ``inflight`` line per
        open span, then fsync. Safe to call repeatedly or unattached."""
        with self._lock:
            if self._file is None or self._closed:
                return 0
            n = 0
            tail = list(self._ring)[-self.flush_last_k:]
            self._ring.clear()
            for rec in tail:
                self._file.write(json.dumps(self._line_locked(rec)) + "\n")
                n += 1
            flight = {
                "kind": "flight", "reason": str(reason),
                "t": clock.monotonic(), "wall": clock.wall(),
            }
            if self._last_error is not None:
                flight["in_span"] = self._last_error
            self._file.write(json.dumps(flight) + "\n")
            n += 1
            for span in self._open.values():
                line = {"kind": "inflight", "inflight": True,
                        **{k: span[k] for k in span}}
                self._file.write(json.dumps(line) + "\n")
                n += 1
            self._file.flush()
            try:
                os.fsync(self._file.fileno())
            except OSError:
                pass
            return n

    def close(self) -> None:
        """Final drain, then close the journal (idempotent)."""
        self.flush()
        with self._lock:
            self._closed = True
            if self._file is not None:
                try:
                    self._file.flush()
                    self._file.close()
                finally:
                    self._file = None

    # ---- summaries ---------------------------------------------------------
    def round_summary(self, round_idx: int) -> dict:
        """Pop the round's aggregate as the schema-v12 ``spans`` record
        sub-object (pending skews merge in here)."""
        with self._lock:
            agg = self._round_agg.pop(int(round_idx), None)
            dropped = self._dropped
            pending = self._pending_skews
            self._pending_skews = {}
        rec = {
            "host_id": self.host_id,
            "hosts": self.n_hosts,
            "count": 0 if agg is None else int(agg["count"]),
        }
        if dropped:
            rec["dropped"] = int(dropped)
        if agg is not None:
            if agg["by_cat"]:
                rec["seconds_by_cat"] = {
                    k: round(v, 6) for k, v in sorted(agg["by_cat"].items())
                }
            rec["dcn_wait_s"] = round(agg["by_cat"].get("dcn_wait", 0.0), 6)
            rec["dcn_transfer_s"] = round(agg["by_cat"].get("dcn", 0.0), 6)
            skews = dict(agg["skews"])
        else:
            skews = {}
        for k, v in pending.items():
            if skews.get(k) is None or v > skews[k]:
                skews[k] = v
        if agg is not None or skews:
            rec["spill_skew_ms"] = skews.get("spill_skew_ms")
            rec["ckpt_skew_ms"] = skews.get("ckpt_skew_ms")
        return rec

    def run_summary(self) -> dict:
        """The whole run's aggregate: the result dict's ``span_summary``."""
        with self._lock:
            run = {
                "count": int(self._run["count"]),
                "dropped": int(self._dropped),
                "by_cat": dict(self._run["by_cat"]),
                "skews": dict(self._run["skews"]),
            }
        return {
            "host_id": self.host_id,
            "hosts": self.n_hosts,
            "journal_path": self.journal_path,
            "count": run["count"],
            "dropped": run["dropped"],
            "seconds_by_cat": {
                k: round(v, 6) for k, v in sorted(run["by_cat"].items())
            },
            "dcn_wait_s": round(run["by_cat"].get("dcn_wait", 0.0), 6),
            "dcn_transfer_s": round(run["by_cat"].get("dcn", 0.0), 6),
            "spill_skew_ms_max": run["skews"].get("spill_skew_ms"),
            "ckpt_skew_ms_max": run["skews"].get("ckpt_skew_ms"),
        }

    # ---- internals (self._lock held) ---------------------------------------
    def _append_locked(self, rec: dict) -> None:
        if len(self._ring) == self._ring.maxlen:
            self._dropped += 1
        self._ring.append(rec)

    def _agg_for_locked(self, round_idx: int) -> dict:
        return self._round_agg.setdefault(int(round_idx), {
            "count": 0, "by_cat": {}, "skews": {},
        })

    def _aggregate_locked(self, span: dict) -> None:
        cat = span.get("cat", "")
        dur = span.get("dur", 0.0)
        self._run["count"] += 1
        self._run["by_cat"][cat] = self._run["by_cat"].get(cat, 0.0) + dur
        rnd = span.get("round")
        if rnd is None:
            return
        agg = self._agg_for_locked(rnd)
        agg["count"] += 1
        agg["by_cat"][cat] = agg["by_cat"].get(cat, 0.0) + dur

    def _note_run_skew_locked(self, key: str, skew_ms: float) -> None:
        prev = self._run["skews"].get(key)
        if prev is None or skew_ms > prev:
            self._run["skews"][key] = float(skew_ms)

    @staticmethod
    def _line_locked(rec: dict) -> dict:
        if rec.get("kind") == "event":
            return rec
        return {"kind": "span", **rec}


class SpanPhaseTimer:
    """A phase timer that also records a span per phase: the same
    accounting as the timer it wraps (either class of telemetry/phases.py),
    so spans work at any ``telemetry_level``, 'off' included."""

    def __init__(self, inner, recorder: SpanRecorder):
        self._inner = inner
        self._rec = recorder

    @property
    def enabled(self) -> bool:
        return self._inner.enabled

    @contextlib.contextmanager
    def phase(self, round_idx: int, name: str):
        # The round function's entry is where the round's work is handed to
        # the card: an instant event marks it on the timeline.
        if name == "client_step":
            self._rec.event("dispatch", "dispatch", round_idx=round_idx)
        # The span encloses the inner phase, so under 'detailed' the inner
        # timer's synchronization lands inside the span too.
        with self._rec.span(name, "phase", round_idx=round_idx):
            with self._inner.phase(round_idx, name) as box:
                yield box

    def take(self, round_idx: int):
        return self._inner.take(round_idx)

    def carve(self, round_idx: int, name: str, seconds: float,
              source: str) -> None:
        self._inner.carve(round_idx, name, seconds, source)
