"""One clock for every timing subsystem (telemetry/clock.py of the JAX
package).

* :func:`monotonic` — the intra-host phase clock: monotonic, unaffected by
  NTP steps, meaningless across hosts.
* :func:`wall` — UNIX epoch seconds, for anchoring a host's monotonic epoch
  only, never for durations.

A span journal's header (telemetry/spans.py) records the pair
``(epoch_wall, epoch_mono)`` sampled back to back and the host's clock
offset against host 0; :func:`align` maps a host's monotonic stamp onto
the shared timeline with them, the one copy of that sign convention.
"""

from __future__ import annotations

import time


def monotonic() -> float:
    """Host-local monotonic seconds (``time.perf_counter``): durations and
    phase stamps. Never comparable across hosts."""
    return time.perf_counter()


def wall() -> float:
    """UNIX epoch seconds (``time.time``): cross-host anchoring only."""
    return time.time()



def align(t_mono: float, epoch_mono: float, epoch_wall: float,
          clock_offset_s: float = 0.0) -> float:
    """A host-local monotonic stamp on the shared wall timeline:
    ``(t_mono - epoch_mono) + epoch_wall - clock_offset_s``.
    ``clock_offset_s`` is this host's wall-clock offset against host 0
    (positive: this host's clock reads ahead), so the result is in host
    0's wall time."""
    return (t_mono - epoch_mono) + epoch_wall - clock_offset_s
