"""Predictive cost model: a roofline over the traced-op ledger
(telemetry/costmodel.py of the JAX package, the same formulas).

``utils/tracing.categorize_ops`` turns a torch.profiler trace of a few
rounds into a ledger: per op category the device milliseconds, the bytes
the launching operators read and wrote, and the profiler's FLOPs. This
module evaluates that ledger against the hardware table
(telemetry/topologies.py): per category ``c`` on a topology of ``n``
chips,

    t_c = max( flops_c / (n * peak_flops * E_mxu),
               bytes_c / (n * hbm_bw    * E_hbm) )      [roofline]
    t_collective = collective_bytes / n / (ici_bw * E_ici)
    predicted_round = sum_c t_c + t_collective (+ all-reduce estimate)

Dividing by ``n`` is the data-parallel client axis: per-chip bytes and
FLOPs divide, while the global model's all-reduce (``2 * param_bytes *
(n-1)/n`` when ``param_bytes`` is given; a one-card trace holds no
collective) rides the interconnect term. It is an optimistic linear-scaling
bound.

``DEFAULT_EFFICIENCY`` holds the fractions of datasheet peak that the
port's own rounds reach on the card, fitted by chip_smoke.py's
``profile_costmodel`` phase from a ResNet-18 round's ledger (each
category's bytes or FLOPs over its device time, against the H100 row's
peaks); PERF.md gives the fit, the card and its power limit. The model
predicts device time; a round's wall clock adds the host's share on top.

``sweep_cost_record`` prices a sweep (sweep/engine.py): the shared round
program's prediction times the sweep's round occupancy, per topology.
"""

from __future__ import annotations

from distributed_learning_simulator_tpu_torch.telemetry.topologies import (
    TOPOLOGIES,
    Topology,
    get_topology,
)

GIB = 2**30

#: Fitted fractions of datasheet peak (chip_smoke's ``profile_costmodel``:
#: one profiled ``fed`` round of ResNet-18 at 5 clients, chunk 40, bf16
#: local state, on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6):
#: "mxu", the convolution category's FLOPs over its device time against
#: 989 TFLOP/s; "hbm", every other category's bytes over their device time
#: against 3.35 TB/s. "ici" has no traced collective to fit (one card): a
#: nominal large-message efficiency.
DEFAULT_EFFICIENCY = {"mxu": 0.057, "hbm": 0.47, "ici": 0.70}

#: The topology the port's measured rounds come from.
DEFAULT_ANCHOR = "h100-sxm-1"

#: The converged-run horizon behind "$/converged-run" projections.
CONVERGED_RUN_ROUNDS = 150


def ledger_totals(ledger: dict) -> dict:
    """Summed ``{"bytes_gb", "flops_g", "device_ms", "op_count"}`` over a
    categorized ledger (zeros for an empty one)."""
    out = {"bytes_gb": 0.0, "flops_g": 0.0, "device_ms": 0.0, "op_count": 0}
    for entry in ledger.values():
        for key in out:
            out[key] += entry.get(key, 0)
    return out


def predict_round(ledger: dict, topology: Topology | str, *,
                  trace_rounds: int = 1, efficiency: dict | None = None,
                  param_bytes: int | None = None) -> dict:
    """Roofline-predicted per-round device time of ``ledger`` (a trace of
    ``trace_rounds`` rounds) on ``topology``: ``{"predicted_ms",
    "bottleneck", "categories"}``, each category with its own
    ``predicted_ms`` and ``bottleneck``; the top-level bottleneck is the
    largest summed term (compute, memory or collective)."""
    if isinstance(topology, str):
        topology = get_topology(topology)
    if trace_rounds < 1:
        raise ValueError(f"trace_rounds must be >= 1, got {trace_rounds}")
    eff = {**DEFAULT_EFFICIENCY, **(efficiency or {})}
    n = topology.chips
    flops_rate = n * topology.peak_tflops * 1e12 * eff["mxu"]
    hbm_rate = n * topology.hbm_gbps * 1e9 * eff["hbm"]
    ici_rate = topology.ici_gbps * 1e9 * eff["ici"]  # per chip

    categories: dict[str, dict] = {}
    terms = {"compute": 0.0, "memory": 0.0, "collective": 0.0}
    total_s = 0.0
    for cat in sorted(ledger):
        entry = ledger[cat]
        nbytes = entry.get("bytes_gb", 0.0) * GIB / trace_rounds
        flops = entry.get("flops_g", 0.0) * 1e9 / trace_rounds
        if cat == "collective" and n > 1 and ici_rate > 0:
            t = nbytes / n / ici_rate
            bound = "collective"
        else:
            t_compute = flops / flops_rate if flops_rate > 0 else 0.0
            t_memory = nbytes / hbm_rate if hbm_rate > 0 else 0.0
            t = max(t_compute, t_memory)
            bound = "compute" if t_compute > t_memory else "memory"
        terms[bound] += t
        total_s += t
        categories[cat] = {
            "predicted_ms": t * 1e3,
            "bottleneck": bound,
        }
    if param_bytes and n > 1 and ici_rate > 0:
        # The global model's ring all-reduce, absent from one-card traces.
        t_allreduce = 2.0 * param_bytes * (n - 1) / n / ici_rate
        terms["collective"] += t_allreduce
        total_s += t_allreduce
    bottleneck = max(terms, key=lambda k: terms[k]) if any(
        terms.values()
    ) else "memory"
    return {
        "predicted_ms": total_s * 1e3,
        "bottleneck": bottleneck,
        "categories": categories,
    }


def costmodel_record(ledger: dict, *, trace_rounds: int = 1,
                     anchor: str = DEFAULT_ANCHOR,
                     measured_ms: float | None = None,
                     topologies: dict | None = None,
                     efficiency: dict | None = None,
                     param_bytes: int | None = None,
                     run_rounds: int | None = None) -> dict:
    """The schema-v6 ``costmodel`` record sub-object.

    ``anchor`` names the topology the run was measured on;
    ``model_error_ratio`` is the anchor's predicted over the measured
    per-round ms. ``run_rounds`` adds ``usd_per_run`` per topology."""
    topos = topologies if topologies is not None else TOPOLOGIES
    anchor_topo = (
        topos[anchor] if anchor in topos else get_topology(anchor)
    )
    anchor_pred = predict_round(
        ledger, anchor_topo, trace_rounds=trace_rounds,
        efficiency=efficiency, param_bytes=param_bytes,
    )
    per_topology = {}
    for name in sorted(topos):
        topo = topos[name]
        pred = (
            anchor_pred if name == anchor else predict_round(
                ledger, topo, trace_rounds=trace_rounds,
                efficiency=efficiency, param_bytes=param_bytes,
            )
        )
        entry = {
            "chips": topo.chips,
            "predicted_ms": round(pred["predicted_ms"], 3),
            "bottleneck": pred["bottleneck"],
            "usd_per_round": round(
                pred["predicted_ms"] / 3.6e6
                * topo.chips * topo.usd_per_chip_hour, 6
            ),
        }
        if run_rounds:
            entry["usd_per_run"] = round(
                entry["usd_per_round"] * run_rounds, 4
            )
        per_topology[name] = entry
    record = {
        "anchor_topology": anchor_topo.name,
        "predicted_ms": round(anchor_pred["predicted_ms"], 3),
        "measured_ms": (
            round(measured_ms, 3) if measured_ms is not None else None
        ),
        "model_error_ratio": (
            round(anchor_pred["predicted_ms"] / measured_ms, 4)
            if measured_ms else None
        ),
        "bottleneck": anchor_pred["bottleneck"],
        "trace_rounds": trace_rounds,
        "categories": {
            cat: {
                "bytes_gb": round(
                    ledger[cat].get("bytes_gb", 0.0) / trace_rounds, 3
                ),
                "device_ms": round(
                    ledger[cat].get("device_ms", 0.0) / trace_rounds, 2
                ),
                "flops_g": round(
                    ledger[cat].get("flops_g", 0.0) / trace_rounds, 2
                ),
                "predicted_ms": round(pred_c["predicted_ms"], 3),
                "bottleneck": pred_c["bottleneck"],
            }
            for cat, pred_c in anchor_pred["categories"].items()
        },
        "per_topology": per_topology,
    }
    if run_rounds:
        record["run_rounds"] = run_rounds
    return record


def sweep_cost_record(ledger: dict, *, trace_rounds: int = 1,
                      points: int, rounds_total: int,
                      programs_compiled: int,
                      executed_points: int | None = None,
                      anchor: str = DEFAULT_ANCHOR,
                      topologies: dict | None = None,
                      efficiency: dict | None = None,
                      param_bytes: int | None = None) -> dict:
    """$/sweep: price the round program ONCE, multiply by the sweep's
    round occupancy per topology (sweep/engine.py; the JAX package's
    ``sweep_cost_record``, the same formulas).

    ``ledger`` describes the sweep's (shared) round program over
    ``trace_rounds`` traced rounds; ``rounds_total`` is the sweep's
    total round occupancy (sum of every point's horizon — a vmapped
    fleet of E experiments over R rounds occupies E*R experiment-rounds
    even though it dispatches R programs, because each dispatch does E
    experiments' device work); ``programs_compiled`` over
    ``executed_points`` (default ``points``; a partially-resumed sweep
    built programs only for the points it actually ran) gives the
    program-reuse bookkeeping (``compile_reuse_fraction`` — every point
    past each group's first rides a warm program). Device-work cost does
    NOT amortize, so ``usd_per_sweep`` scales with occupancy while the
    program column scales with programs.
    """
    if points < 1:
        raise ValueError(f"points must be >= 1, got {points}")
    if rounds_total < 1:
        raise ValueError(f"rounds_total must be >= 1, got {rounds_total}")
    if executed_points is None:
        executed_points = points
    topos = topologies if topologies is not None else TOPOLOGIES
    per_topology = {}
    for name in sorted(topos):
        topo = topos[name]
        pred = predict_round(
            ledger, topo, trace_rounds=trace_rounds,
            efficiency=efficiency, param_bytes=param_bytes,
        )
        usd_per_round = (
            pred["predicted_ms"] / 3.6e6 * topo.chips
            * topo.usd_per_chip_hour
        )
        per_topology[name] = {
            "chips": topo.chips,
            "predicted_round_ms": round(pred["predicted_ms"], 3),
            "bottleneck": pred["bottleneck"],
            "usd_per_sweep": round(usd_per_round * rounds_total, 6),
            "usd_per_point": round(
                usd_per_round * rounds_total / points, 6
            ),
        }
    return {
        "anchor_topology": (
            topos[anchor].name if anchor in topos
            else get_topology(anchor).name
        ),
        "points": points,
        "rounds_total": rounds_total,
        "programs_compiled": programs_compiled,
        "compile_reuse_fraction": (
            round(max(0.0, 1.0 - programs_compiled / executed_points), 4)
            if executed_points else None
        ),
        "trace_rounds": trace_rounds,
        "per_topology": per_topology,
    }
