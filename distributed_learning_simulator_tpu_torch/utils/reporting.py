"""Per-round metrics.jsonl records and the config hash (utils/reporting.py
of the JAX package).

Copied so that the port's records carry the same layout and schema
versions: ``scripts/report_run.py`` and the checked-in
``tests/data/metrics_record.schema.json`` read both packages' output. The
port emits only v1 records so far (no telemetry sub-objects), but keeps
the function whole so later slices add their sub-objects through it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import zlib

import numpy as np

# metrics.jsonl layout version. v1 (implicit — no version field) is the
# pre-telemetry record: round/test_accuracy/test_loss/… only. v2 adds
# ``schema_version`` and the ``telemetry`` sub-object (phase_seconds,
# compiles, peak_hbm_bytes; docs/OBSERVABILITY.md). v3 adds the
# ``client_stats`` sub-object (per-client quantile summaries, flagged
# ids + reasons; telemetry/client_stats.py). v4 adds the ``async``
# sub-object (deadline-round outcomes, staleness-buffer occupancy, the
# simulated clock; robustness/arrivals.py). v5 adds the ``stream``
# sub-object (per-dispatch host<->HBM transfer bytes/seconds and the
# prefetch overlap ratio; client_residency='streamed',
# parallel/streaming.py). v6 adds the ``costmodel`` sub-object (the
# roofline cost model's per-topology round-time/cost prediction with
# model-vs-measured error ratio; telemetry/costmodel.py — attached to
# the run's LAST record when config.cost_model_trace is set). v7 adds
# the ``valuation`` sub-object (the streaming per-client contribution
# vector's fold inputs and top/bottom tables, and — on audit rounds —
# the truncated-GTG cross-validation correlations;
# telemetry/valuation.py). v8 adds the ``sweep`` sub-object (which
# sweep point a record belongs to, the execution strategy, the point's
# config-hash group, and whether its program was reused warm;
# sweep/engine.py). v9 adds the ``population`` sub-object (the
# dynamic-population registration stream's per-round outcome: alive/
# registered counts, joins, departures — total and in-cohort — the
# planted drift cohort, and the rejected-by-churn flag;
# robustness/population.py). v10 adds the ``gtg`` sub-object (the
# mesh-sharded GTG walk's provenance: devices the subset-evaluation
# batch axis partitioned over, subset-eval throughput, the fused-call
# wave width, and the walk's wall seconds; algorithms/shapley.py —
# attached only on rounds whose walk actually sharded). v11 adds the
# ``multihost`` sub-object (the distributed shard store's per-host
# assembly provenance: host count, this host's id/owned-client
# count/shard bytes, the round's spill rows + bytes over DCN, and this
# host's h2d/overlap; parallel/streaming.DistributedCohortStreamer —
# attached only under client_residency='streamed' with >1 host
# process). v12 adds the ``spans`` sub-object (the distributed tracing
# layer's per-round per-host summary: span/drop counts, per-category
# seconds, DCN wait vs transfer, and the measured spill/checkpoint
# barrier skews; telemetry/spans.py — attached only under
# span_trace='on'). A record
# is stamped with the LOWEST version that describes it:
# telemetry_level='off' keeps emitting v1 byte-for-byte,
# client_stats='off' keeps telemetry-only records at v2 byte-for-byte,
# async_mode='off' keeps records at v3 or below, client_residency=
# 'resident' keeps records at v4 or below, cost_model_trace=None
# keeps records at v5 or below, client_valuation='off' keeps
# records at v6 or below, solo (non-sweep) runs keep records at v7
# or below, population='static' keeps records at v8 or below,
# serial (single-device) GTG walks keep records at v9 or below,
# single-process runs keep records at v10 or below, and
# span_trace='off' keeps records at v11 or below —
# longitudinal tooling never sees a
# layout change it didn't opt into.
METRICS_SCHEMA_VERSION = 12
_MULTIHOST_SCHEMA_VERSION = 11
_GTG_SCHEMA_VERSION = 10
_POPULATION_SCHEMA_VERSION = 9
_SWEEP_SCHEMA_VERSION = 8
_VALUATION_SCHEMA_VERSION = 7
_COSTMODEL_SCHEMA_VERSION = 6
_STREAM_SCHEMA_VERSION = 5
_ASYNC_SCHEMA_VERSION = 4
_CLIENT_STATS_SCHEMA_VERSION = 3
_TELEMETRY_ONLY_SCHEMA_VERSION = 2

# Config fields that do NOT define the measured program: two runs
# differing only in these are still comparable cost points. Everything
# else (model, population, chunking, dtypes, failure knobs, ...) lands in
# the hash. ``round`` is excluded because per-round medians are
# comparable across run lengths (bench records its rounds separately).
# ``telemetry_level`` is deliberately NOT excluded: 'detailed' fences
# every phase and defeats round pipelining, so its wall-clock is not a
# comparable cost point against an unfenced run.
_NON_PROGRAM_FIELDS = (
    "round",
    "log_root",
    "log_level",
    # Host-side detector sensitivity only (telemetry/client_stats.py):
    # never touches the compiled program or any measured cost, so tuning
    # it must not make bench runs incomparable. The other client-stats
    # knobs (on/off, cadence, probe size) DO change the program or its
    # transfer volume and stay in the hash.
    "client_stats_mad_threshold",
    "compilation_cache_dir",
    "profile_dir",
    "profile_from_round",
    # Cost-model knobs (telemetry/costmodel.py): pure host-side analysis
    # of an already-captured trace — never touches the compiled program
    # or any measured cost, so pricing a run must not make it
    # incomparable to an unpriced one.
    "cost_model_trace",
    "cost_model_trace_rounds",
    "cost_model_topology",
    "checkpoint_dir",
    "checkpoint_every",
    "checkpoint_keep_last",
    "resume",
    "data_dir",
    # Span-journal routing (telemetry/spans.py): where the per-host
    # jsonl lands — pure I/O, never the measured program. The other
    # span knobs off-gate out of the hash below instead (an ACTIVE
    # trace adds instrumentation overhead to the measured round).
    "span_dir",
    # Sweep persistence knobs (sweep/engine.py): where completed points
    # land and whether to resume — pure I/O, never the measured program.
    "sweep_dir",
    "sweep_resume",
)


def build_round_record(base: dict, telemetry: dict | None = None,
                       client_stats: dict | None = None,
                       async_federation: dict | None = None,
                       stream: dict | None = None,
                       costmodel: dict | None = None,
                       valuation: dict | None = None,
                       sweep: dict | None = None,
                       population: dict | None = None,
                       gtg: dict | None = None,
                       multihost: dict | None = None,
                       spans: dict | None = None) -> dict:
    """The ONE per-round metrics.jsonl record constructor (vmap simulator and
    threaded oracle both write through this).

    All sub-objects ``None`` (``telemetry_level='off'``,
    ``client_stats='off'``, ``async_mode='off'``,
    ``client_residency='resident'``) returns ``base`` unchanged — the
    legacy v1 layout, byte-identical to pre-telemetry builds. A
    telemetry dict alone upgrades the record to v2 (``schema_version``
    + the ``telemetry`` sub-object — byte-identical to pre-client-stats
    v2 builds); a client_stats dict (telemetry/client_stats.py
    ``client_stats_record``) upgrades it to v3; an async dict (the
    simulator's per-round deadline/buffer outcome) upgrades it to v4
    under the ``"async"`` key; a stream dict (the streamer's
    per-dispatch transfer stats, parallel/streaming.py) upgrades it to
    v5 under the ``"stream"`` key; a costmodel dict
    (telemetry/costmodel.costmodel_record) upgrades it to v6 under the
    ``"costmodel"`` key; a valuation dict
    (telemetry/valuation.valuation_record) upgrades it to v7 under the
    ``"valuation"`` key; a sweep dict (sweep/engine.py per-point
    provenance) upgrades it to v8 under the ``"sweep"`` key; a
    population dict (robustness/population.PopulationModel.round_record)
    upgrades it to v9 under the ``"population"`` key; a gtg dict (the
    mesh-sharded GTG walk's provenance, algorithms/shapley.GTGShapley
    .post_round) upgrades it to v10 under the ``"gtg"`` key; a
    multihost dict (the distributed shard store's per-host assembly
    summary, parallel/streaming.DistributedCohortStreamer
    .multihost_record) upgrades it to v11 under the ``"multihost"``
    key; a spans dict (the distributed tracing layer's per-round
    per-host summary, telemetry/spans.SpanRecorder.round_summary)
    upgrades it to v12 under the ``"spans"`` key.
    """
    if telemetry is None and client_stats is None and (
        async_federation is None
    ) and stream is None and costmodel is None and valuation is None and (
        sweep is None
    ) and population is None and gtg is None and multihost is None and (
        spans is None
    ):
        return base
    record = dict(base)
    if spans is not None:
        record["schema_version"] = METRICS_SCHEMA_VERSION
    elif multihost is not None:
        record["schema_version"] = _MULTIHOST_SCHEMA_VERSION
    elif gtg is not None:
        record["schema_version"] = _GTG_SCHEMA_VERSION
    elif population is not None:
        record["schema_version"] = _POPULATION_SCHEMA_VERSION
    elif sweep is not None:
        record["schema_version"] = _SWEEP_SCHEMA_VERSION
    elif valuation is not None:
        record["schema_version"] = _VALUATION_SCHEMA_VERSION
    elif costmodel is not None:
        record["schema_version"] = _COSTMODEL_SCHEMA_VERSION
    elif stream is not None:
        record["schema_version"] = _STREAM_SCHEMA_VERSION
    elif async_federation is not None:
        record["schema_version"] = _ASYNC_SCHEMA_VERSION
    elif client_stats is not None:
        record["schema_version"] = _CLIENT_STATS_SCHEMA_VERSION
    else:
        record["schema_version"] = _TELEMETRY_ONLY_SCHEMA_VERSION
    if telemetry is not None:
        record["telemetry"] = telemetry
    if client_stats is not None:
        record["client_stats"] = client_stats
    if async_federation is not None:
        record["async"] = async_federation
    if stream is not None:
        record["stream"] = stream
    if costmodel is not None:
        record["costmodel"] = costmodel
    if valuation is not None:
        record["valuation"] = valuation
    if sweep is not None:
        record["sweep"] = sweep
    if population is not None:
        record["population"] = population
    if gtg is not None:
        record["gtg"] = gtg
    if multihost is not None:
        record["multihost"] = multihost
    if spans is not None:
        record["spans"] = spans
    return record


def cohort_crc(ids, n_clients: int) -> int:
    """CRC32 of a cohort's client ids as int64 (the full population when
    ``ids`` is None): the records' ``cohort_hash`` and the key of GTG's
    cross-round memo (``cohort_crc`` in the JAX package's
    telemetry/valuation.py)."""
    arr = (
        np.arange(n_clients, dtype=np.int64) if ids is None
        else np.ascontiguousarray(ids, dtype=np.int64)
    )
    return zlib.crc32(arr.tobytes())


def config_hash(config) -> str:
    """Short stable hash of the program-defining config fields.

    Stamped into bench output so compare_bench.py can refuse to diff runs
    whose knobs make their numbers incomparable. JSON-serialized with sorted keys (repr fallback
    for exotic values) so dict-field ordering can't move the hash.
    """
    d = dataclasses.asdict(config)
    for k in _NON_PROGRAM_FIELDS:
        d.pop(k, None)
    # Off-gated knobs drop out of the hash AT THEIR OFF VALUE: a
    # trace-time-gated feature that is off compiles the exact pre-feature
    # program, so pre-feature configs keep their pre-feature hash
    # (longitudinal bench comparability survives the feature landing)
    # while any ACTIVE setting — which does change the program or its
    # record stream — lands every one of its knobs in the hash.
    if (d.get("client_valuation") or "off").lower() == "off":
        for k in ("client_valuation", "valuation_decay",
                  "valuation_audit_every", "valuation_audit_permutations"):
            d.pop(k, None)
    if not d.get("gtg_cross_round_memo", False):
        d.pop("gtg_cross_round_memo", None)
    if (d.get("span_trace") or "off").lower() == "off":
        # Tracing off IS the pre-feature program (no spans, no journal,
        # no extra DCN arrival stamps), so pre-feature configs keep
        # their pre-feature hash; 'on' perturbs the measured round
        # (instrumentation overhead + the arrival-stamp allgathers) and
        # lands every span knob in the hash.
        for k in ("span_trace", "span_buffer_size", "span_flush_last_k"):
            d.pop(k, None)
    if (d.get("participation_sampler") or "exact").lower() == "exact":
        # 'exact' IS the pre-feature draw (ops/sampling.py), so
        # pre-feature configs keep their pre-feature hash; 'hashed'
        # changes the drawn cohorts and lands in the hash.
        d.pop("participation_sampler", None)
    if not d.get("sweep_seeds") and not d.get("sweep_points"):
        # No sweep requested: the sweep knobs drop out at their off
        # values (pre-feature configs keep their pre-feature hash); an
        # ACTIVE sweep — which changes what the process runs — lands
        # its point list and strategy in the hash.
        for k in ("sweep_seeds", "sweep_points", "sweep_strategy"):
            d.pop(k, None)
    if (d.get("population") or "static").lower() == "static":
        # 'static' IS the pre-feature fixed population (the round
        # program and record stream are untouched), so pre-feature
        # configs keep their pre-feature hash; 'dynamic' changes the
        # program (the departed operand) and the drawn cohorts, and
        # lands every population knob in the hash.
        for k in ("population", "population_seed", "join_rate",
                  "depart_rate", "drift_fraction", "drift_factor"):
            d.pop(k, None)
    blob = json.dumps(d, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]
