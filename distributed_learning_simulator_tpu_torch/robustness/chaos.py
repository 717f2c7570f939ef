"""Deterministic crash injection for the chaos harness (robustness/chaos.py
of the JAX package).

``run_simulation`` calls :func:`maybe_crash` at the end of every round,
after the round's metrics line and its checkpoint (if one is due) are on
disk, so an injected failure models "the process died right after round N
was persisted". The kind comes from the environment, so in-process tests,
subprocess SIGKILL tests and the SIGTERM grace path need no test-only
wiring in the simulator:

  * ``DLS_CRASH_KIND=raise`` (default): raise :class:`InjectedCrash`;
  * ``DLS_CRASH_KIND=sigkill``: SIGKILL to self (no cleanup at all, the
    torn-state variant a real preemption or OOM kill produces);
  * ``DLS_CRASH_KIND=sigterm``: SIGTERM to self (the graceful-preemption
    path: finish the round, write a final checkpoint, exit cleanly).

Inert unless ``DLS_CRASH_AT_ROUND`` is set.
"""

from __future__ import annotations

import os
import signal

ENV_CRASH_ROUND = "DLS_CRASH_AT_ROUND"
ENV_CRASH_KIND = "DLS_CRASH_KIND"


class InjectedCrash(RuntimeError):
    """Raised by the ``raise`` crash kind; never by the program itself."""


def maybe_crash(round_idx: int) -> None:
    """Kill this process if ``DLS_CRASH_AT_ROUND`` names ``round_idx``."""
    target = os.environ.get(ENV_CRASH_ROUND)
    if target is None:
        return
    try:
        target_round = int(target)
    except ValueError as e:
        raise ValueError(
            f"{ENV_CRASH_ROUND}={target!r} is not an integer round index"
        ) from e
    if target_round != round_idx:
        return
    kind = os.environ.get(ENV_CRASH_KIND, "raise").lower()
    if kind == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif kind == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
        return  # the handler only sets a flag; the round loop stops
    else:
        raise InjectedCrash(
            f"injected crash after round {round_idx} was persisted"
        )
