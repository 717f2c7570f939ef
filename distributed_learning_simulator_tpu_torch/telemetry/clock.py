"""One clock for every timing subsystem (telemetry/clock.py of the JAX
package).

* :func:`monotonic` — the intra-host phase clock: monotonic, unaffected by
  NTP steps, meaningless across hosts.
* :func:`wall` — UNIX epoch seconds, for anchoring a host's monotonic epoch
  only, never for durations.

The JAX module's cross-host ``align`` serves its span journals, which the
port does not have yet (ROADMAP.md queue 1 item 13).
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

