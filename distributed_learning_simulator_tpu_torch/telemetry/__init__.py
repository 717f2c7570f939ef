"""Run telemetry (telemetry/ of the JAX package).

* :mod:`.phases` — per-round phase timers (client step / aggregate / eval /
  host sync / post round), waiting for the device only at
  ``telemetry_level='detailed'``.
* :mod:`.clock` — the one monotonic and wall clock convention, and the
  journals' clock alignment.
* :mod:`.recompile` — the recompilation counter: first-seen call
  signatures of the round programs and nvcc builds; any after the warmup
  round is a shape-instability warning naming the function.
* :mod:`.memory` — the one device-memory probe (watermark and capacity).
* :mod:`.client_stats` — per-client training statistics from streaming
  reductions inside the round, the median/MAD anomaly detector and the
  ``client_stats`` sub-object of the schema-v3 record.
* :mod:`.valuation` — the streaming per-client valuation, its GTG audit
  and the v7 ``valuation`` sub-object.
* :mod:`.spans` — span journals, the crash flight recorder and the v12
  ``spans`` sub-object.
* :mod:`.costmodel` over :mod:`.topologies` — the roofline prediction of
  a round from a torch.profiler trace's op ledger (utils/tracing.py), the
  v6 ``costmodel`` sub-object.

Records go to ``metrics.jsonl`` through ``utils/reporting.py``'s
``build_round_record``; ``scripts/report_run.py`` renders a run's
artifacts directory and ``scripts/trace_timeline.py`` its span journal.
"""

from distributed_learning_simulator_tpu_torch.config import (
    CLIENT_STATS_LEVELS,
    TELEMETRY_LEVELS,
)
from distributed_learning_simulator_tpu_torch.telemetry.clock import align
from distributed_learning_simulator_tpu_torch.telemetry.client_stats import (
    PER_CLIENT_CAP,
    STAT_FIELDS,
    ClientStats,
    attribution_crosscheck,
    client_stats_record,
    detect_and_record,
    detect_anomalies,
)
from distributed_learning_simulator_tpu_torch.telemetry.costmodel import (
    DEFAULT_ANCHOR,
    DEFAULT_EFFICIENCY,
    costmodel_record,
    ledger_totals,
    predict_round,
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
from distributed_learning_simulator_tpu_torch.telemetry.spans import (
    SpanPhaseTimer,
    SpanRecorder,
    journal_filename,
)
from distributed_learning_simulator_tpu_torch.telemetry.topologies import (
    TOPOLOGIES,
    Topology,
    get_topology,
)
from distributed_learning_simulator_tpu_torch.telemetry.valuation import (
    ClientValuation,
    ValuationAuditor,
    ValuationState,
    cohort_crc,
    grade_client_labels,
    pearson_corr,
    spearman_corr,
    valuation_record,
)

__all__ = [
    "CLIENT_STATS_LEVELS",
    "DEFAULT_ANCHOR",
    "DEFAULT_EFFICIENCY",
    "PER_CLIENT_CAP",
    "STAT_FIELDS",
    "TELEMETRY_LEVELS",
    "TOPOLOGIES",
    "ClientStats",
    "ClientValuation",
    "NullPhaseTimer",
    "PhaseTimer",
    "RecompileMonitor",
    "SpanPhaseTimer",
    "SpanRecorder",
    "Topology",
    "ValuationAuditor",
    "ValuationState",
    "align",
    "attribution_crosscheck",
    "client_stats_record",
    "cohort_crc",
    "costmodel_record",
    "detect_and_record",
    "detect_anomalies",
    "device_memory_stats",
    "get_topology",
    "grade_client_labels",
    "hbm_limit_bytes",
    "journal_filename",
    "ledger_totals",
    "log_round_compiles",
    "make_phase_timer",
    "peak_hbm_bytes",
    "pearson_corr",
    "predict_round",
    "spearman_corr",
    "tracked",
    "valuation_record",
]
