"""Run telemetry (telemetry/ of the JAX package): the part ported so far.

* :mod:`.phases` — per-round phase timers (client step / aggregate / eval /
  host sync / post round), waiting for the device only at
  ``telemetry_level='detailed'``.
* :mod:`.clock` — the one monotonic and wall clock convention.
* :mod:`.recompile` — the recompilation counter: first-seen call
  signatures of the round programs and nvcc builds; any after the warmup
  round is a shape-instability warning naming the function.
* :mod:`.memory` — the one device-memory probe (watermark and capacity).
* :mod:`.client_stats` — per-client training statistics from streaming
  reductions inside the round, the median/MAD anomaly detector and the
  ``client_stats`` sub-object of the schema-v3 record.

Records go to ``metrics.jsonl`` through ``utils/reporting.py``'s
``build_round_record``; ``scripts/report_run.py`` renders a run's
artifacts directory. The valuation (v7), span (v12) and cost-model (v6)
parts are not ported yet (ROADMAP.md queue 1 item 13).
"""

from distributed_learning_simulator_tpu_torch.config import (
    CLIENT_STATS_LEVELS,
    TELEMETRY_LEVELS,
)
from distributed_learning_simulator_tpu_torch.telemetry.client_stats import (
    PER_CLIENT_CAP,
    STAT_FIELDS,
    ClientStats,
    attribution_crosscheck,
    client_stats_record,
    detect_and_record,
    detect_anomalies,
)
from distributed_learning_simulator_tpu_torch.telemetry.memory import (
    device_memory_stats,
    hbm_limit_bytes,
    peak_hbm_bytes,
)
from distributed_learning_simulator_tpu_torch.telemetry.phases import (
    NullPhaseTimer,
    PhaseTimer,
    make_phase_timer,
)
from distributed_learning_simulator_tpu_torch.telemetry.recompile import (
    RecompileMonitor,
    log_round_compiles,
    tracked,
)

__all__ = [
    "CLIENT_STATS_LEVELS",
    "PER_CLIENT_CAP",
    "STAT_FIELDS",
    "TELEMETRY_LEVELS",
    "ClientStats",
    "NullPhaseTimer",
    "PhaseTimer",
    "RecompileMonitor",
    "attribution_crosscheck",
    "client_stats_record",
    "detect_and_record",
    "detect_anomalies",
    "device_memory_stats",
    "hbm_limit_bytes",
    "log_round_compiles",
    "make_phase_timer",
    "peak_hbm_bytes",
    "tracked",
]
