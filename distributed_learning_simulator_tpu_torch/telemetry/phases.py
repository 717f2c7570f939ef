"""Per-round phase timing (telemetry/phases.py of the JAX package).

A round's wall clock splits into ``client_step`` (the round function:
local training and the aggregation, one program in the JAX package and one
call here), ``aggregate`` (the server optimizer's step, when there is one;
the threaded oracle's rendezvous aggregation), ``eval``, ``host_sync`` (the
round's one device-to-host metric fetch) and ``post_round`` (host-side
algorithm work, e.g. Shapley scoring).

Two fidelity modes, selected by ``config.telemetry_level``:

* ``basic`` — host clocks only. CUDA work is asynchronous: a phase measures
  the host time to issue its work, and the device time it launched pools
  into whichever later phase first blocks on a result (usually
  ``host_sync``). Nothing is added to the measured program.
* ``detailed`` — before a phase's clock stops, the current CUDA stream of
  each device its fenced output lives on is synchronized, so the split is
  per-phase device time. The synchronization serializes issue with
  execution: a measurement mode, not a production mode.

``telemetry_level='off'`` gets the :class:`NullPhaseTimer`, whose phase
contexts do nothing: the default run is untouched.
"""

from __future__ import annotations

import contextlib

import torch

from distributed_learning_simulator_tpu_torch.telemetry import clock


class _FenceBox:
    """Slot a phase body parks its output in; a fencing timer waits for it
    before stopping the clock (under ``basic`` the value is only kept)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def fence(self, value) -> None:
        self.value = value


def _cuda_devices(value, found: set) -> set:
    """The CUDA devices of the tensors in ``value`` (a tensor or nested
    dicts, lists and tuples of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, found)
    return found


def block_until_ready(value) -> None:
    """Wait until the work that produced ``value`` has finished: the
    current stream of each CUDA device it lives on is synchronized (CPU
    tensors are ready when they exist)."""
    for device in _cuda_devices(value, set()):
        torch.cuda.current_stream(device).synchronize()


class PhaseTimer:
    """Accumulates per-(round, phase) wall-clock seconds; ``take(round)``
    pops a finished round's dict for its record."""

    enabled = True

    def __init__(self, fence: bool = False):
        self._fence = fence
        self._acc: dict[int, dict[str, float]] = {}

    @contextlib.contextmanager
    def phase(self, round_idx: int, name: str):
        box = _FenceBox()
        t0 = clock.monotonic()
        try:
            yield box
        finally:
            if self._fence and box.value is not None:
                block_until_ready(box.value)
            dt = clock.monotonic() - t0
            acc = self._acc.setdefault(round_idx, {})
            acc[name] = acc.get(name, 0.0) + dt

    def take(self, round_idx: int) -> dict[str, float]:
        """Pop the round's accumulated phase seconds (empty if none)."""
        return self._acc.pop(round_idx, {})

    def carve(self, round_idx: int, name: str, seconds: float,
              source: str) -> None:
        """Move ``seconds`` of host work out of the open ``source`` phase
        into phase ``name``: the streamed cohort draw for the next round
        runs inside ``client_step`` so that it overlaps the card, and its
        cost still shows as ``sample``. The negative share nets out when
        ``source`` closes, so phases stay disjoint."""
        acc = self._acc.setdefault(round_idx, {})
        acc[name] = acc.get(name, 0.0) + seconds
        acc[source] = acc.get(source, 0.0) - seconds


class NullPhaseTimer:
    """``telemetry_level='off'``: the same API, no clocks, no records."""

    enabled = False

    @contextlib.contextmanager
    def phase(self, round_idx: int, name: str):
        yield _FenceBox()

    def take(self, round_idx: int) -> None:
        return None

    def carve(self, round_idx: int, name: str, seconds: float,
              source: str) -> None:
        return None


def make_phase_timer(level: str) -> PhaseTimer | NullPhaseTimer:
    """'off' is inert, 'basic' clocks without waiting, 'detailed' waits
    for each phase's output."""
    level = level.lower()
    if level == "off":
        return NullPhaseTimer()
    return PhaseTimer(fence=(level == "detailed"))
