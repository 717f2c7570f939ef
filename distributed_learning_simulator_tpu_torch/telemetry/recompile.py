"""Recompilation counter (telemetry/recompile.py of the JAX package).

The JAX package counts XLA backend compiles: a shape-stable run compiles
each of its programs once, in the first executed round (warmup), and any
compile after that means an operand's shape, dtype or static argument
changed across rounds — a shape-instability bug that multiplies round
cost — so the round loop logs it as a WARNING naming the function.

PyTorch runs eagerly and compiles no program, so the port counts what
stands for a compile in it:

* **A first-seen call signature of a round program.** The port's round
  programs are wrapped by :func:`tracked`: the round function
  (``round_fn``), the chunk train function (``train_chunk``), the eval
  function (``evaluate``), the models-eval function (``evaluate_models``)
  and the server update (``server_update``). Each wrapped function keeps,
  as a jit cache would, the set of signatures it has been called with:
  its name plus, per argument, a tensor's or array's shape and dtype (and
  a tensor's device type), a Python scalar's type (scalars are traced
  values in the JAX programs), a string's value (a static argument), and
  the structure of dicts, lists and tuples; a callable (a host hook, not
  a program input) counts as its type only. A call whose signature the
  function has not seen is one event ``(name, seconds)``, the seconds
  being that first call's host time: the price a new shape pays where the
  JAX package pays a compile.
* **An nvcc build.** ``ops/_build.load_library`` reports each build of a
  CUDA source it actually compiles (not a reused library) as
  ``("nvcc <source>", seconds)``.

:class:`RecompileMonitor` collects the events of every thread while it is
started (the threaded oracle's workers report from theirs).
``attribute(round)`` files the pending events under a round, ``take``
pops them, ``drain`` returns the pending ones. The only process-global
state is the list of started monitors, which ``start`` appends to and
``stop`` removes from; a wrapped function's signature set belongs to the
function object, so each run's programs count their own first calls.
"""

from __future__ import annotations

import functools
import logging
import threading

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.telemetry import clock

_ACTIVE: list["RecompileMonitor"] = []
_ACTIVE_LOCK = threading.Lock()


def notify(name: str, seconds: float) -> None:
    """Report one compile-equivalent event to every started monitor."""
    with _ACTIVE_LOCK:
        monitors = list(_ACTIVE)
    for mon in monitors:
        mon._record(name, seconds)


def signature(value):
    """A hashable description of a call argument (module docstring)."""
    if isinstance(value, torch.Tensor):
        return ("tensor", tuple(value.shape), str(value.dtype),
                value.device.type)
    if isinstance(value, (np.ndarray, np.generic)):
        return ("array", tuple(np.shape(value)), np.asarray(value).dtype.str)
    if value is None or isinstance(value, (bool, int, float)):
        return type(value).__name__
    if isinstance(value, str):
        return ("str", value)
    if isinstance(value, dict):
        return ("dict",) + tuple(
            (k, signature(v)) for k, v in sorted(value.items(),
                                                  key=lambda kv: str(kv[0])))
    if isinstance(value, (list, tuple)):
        return (type(value).__name__,) + tuple(signature(v) for v in value)
    return type(value).__name__


def tracked(name: str, fn):
    """``fn`` counting its first-seen call signatures as events named
    ``name`` (module docstring)."""
    seen: set = set()
    lock = threading.Lock()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        sig = (signature(args), signature(kwargs))
        with lock:
            new = sig not in seen
            if new:
                seen.add(sig)
        if not new:
            return fn(*args, **kwargs)
        t0 = clock.monotonic()
        out = fn(*args, **kwargs)
        notify(name, clock.monotonic() - t0)
        return out

    return wrapper


class RecompileMonitor:
    """Counts first-seen round-program signatures and nvcc builds, and
    attributes them to rounds.

    Usage (the simulator's round loop)::

        with RecompileMonitor() as mon:
            for round_idx in ...:
                dispatch(...)
                mon.attribute(round_idx)   # pending events -> this round
            events = mon.take(round_idx)   # [(fn_name, seconds), ...]
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: list[tuple[str, float]] = []
        self._per_round: dict[int, list[tuple[str, float]]] = {}
        self._active = False

    def _record(self, name: str, seconds: float) -> None:
        with self._lock:
            if self._active:
                self._pending.append((name, float(seconds)))

    def start(self) -> "RecompileMonitor":
        with _ACTIVE_LOCK:
            if not self._active:
                self._active = True
                _ACTIVE.append(self)
        return self

    def stop(self) -> None:
        with _ACTIVE_LOCK:
            if self._active:
                self._active = False
                _ACTIVE.remove(self)

    def __enter__(self) -> "RecompileMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def drain(self) -> list[tuple[str, float]]:
        """Pop the events recorded since the last drain, as ``[(name,
        seconds), ...]`` in arrival order."""
        with self._lock:
            events, self._pending = self._pending, []
        return events

    def attribute(self, round_idx: int) -> None:
        """File the pending events under ``round_idx``."""
        events = self.drain()
        if events:
            self._per_round.setdefault(round_idx, []).extend(events)

    def take(self, round_idx: int) -> list[tuple[str, float]]:
        """Pop the events attributed to ``round_idx``."""
        return self._per_round.pop(round_idx, [])


def log_round_compiles(logger: logging.Logger, round_idx: int,
                       events: list[tuple[str, float]],
                       warmup: bool) -> int:
    """Log a round's events; returns their count. The first executed
    round's are expected (INFO); a later round's are the instability
    signal, a WARNING naming the functions."""
    if not events:
        return 0
    names = ", ".join(f"{name} ({secs:.1f}s)" for name, secs in events)
    if warmup:
        logger.info(
            "round %d: %d compile(s) during warmup: %s",
            round_idx, len(events), names,
        )
    else:
        logger.warning(
            "round %d: %d recompile(s) AFTER warmup — shape-unstable "
            "round program? offending: %s",
            round_idx, len(events), names,
        )
    return len(events)
