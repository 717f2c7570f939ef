"""Sweep specification: many experiments as first-class traffic
(sweep/spec.py of the JAX package, the same rules and texts).

A :class:`SweepSpec` turns a base
:class:`~distributed_learning_simulator_tpu_torch.config.ExperimentConfig`
plus a list of per-point overrides into a validated experiment fleet and
resolves HOW the fleet executes (sweep/engine.py):

* ``vmapped`` — every point agrees on every program-defining knob except
  the :data:`FLEET_AXES` (seed, learning_rate). The points run as ONE
  fleet: each round trains every experiment's chunk j as one program of E
  x chunk models (the experiment axis folded into the chunk's model axis,
  parallel/engine.py ``make_experiment_round_fn``). Per-point seeds become
  per-experiment model inits and key chains (point ``i`` is its solo run
  with that seed on the shared data), per-point learning rates a length-E
  f32 factor vector against the base lr.
* ``scheduled`` — heterogeneous points are grouped by
  ``utils/reporting.config_hash`` and each group runs sequentially
  through one warm program (the model, layout, round function and eval
  built once), cached under a seed-normalized program key, with per-point
  reuse recorded.
* ``auto`` (default) — ``vmapped`` when every point is fleet-compatible,
  else ``scheduled``.

Data contract: the whole sweep shares the BASE config's dataset and
client partition (data seed = base seed). Each point's ``seed`` drives
model init and the training key chain only, which is what makes a fleet
point's history that of ``run_simulation(replace(base, seed=s),
dataset=shared, client_data=shared)``.
"""

from __future__ import annotations

import dataclasses
import json

from distributed_learning_simulator_tpu_torch.config import (
    SHAPLEY_ALGORITHMS,
    SWEEP_STRATEGIES,
    ExperimentConfig,
)
from distributed_learning_simulator_tpu_torch.utils.reporting import config_hash

#: Knobs the fleet turns into per-experiment operands: the seed (per-
#: experiment model inits and key chains) and the learning rate (a
#: length-E factor vector against the base lr, multiplied into the
#: schedule factor exactly like config.lr_schedule's per-round factor).
#: Everything else is a program-defining knob a fleet cannot vary — such
#: points go through the scheduled strategy.
FLEET_AXES = ("seed", "learning_rate")


@dataclasses.dataclass
class SweepPoint:
    """One experiment of the sweep: the base config plus overrides."""

    index: int
    overrides: dict
    config: ExperimentConfig

    @property
    def seed(self) -> int:
        return self.config.seed

    @property
    def learning_rate(self) -> float:
        return self.config.learning_rate


def _parse_points_field(value):
    """``config.sweep_points`` accepts a JSON string (CLI) or a list of
    override dicts (library callers); normalize to a list of dicts."""
    if value in (None, "", []):
        return None
    if isinstance(value, str):
        value = json.loads(value)
    if not isinstance(value, list) or not all(
        isinstance(p, dict) for p in value
    ):
        raise ValueError(
            "sweep_points must be a JSON list of per-point override "
            'objects, e.g. \'[{"learning_rate": 0.05}, '
            '{"learning_rate": 0.1}]\''
        )
    return value


def _parse_seeds_field(value):
    """``config.sweep_seeds``: comma-separated seed list (or a list)."""
    if value in (None, "", []):
        return None
    if isinstance(value, str):
        seeds = [int(s) for s in value.split(",") if s.strip()]
    else:
        seeds = [int(s) for s in value]
    if not seeds:
        return None
    return seeds


class SweepSpec:
    """A validated multi-experiment sweep (see module docstring)."""

    def __init__(self, base: ExperimentConfig, points: list[dict],
                 strategy: str = "auto", sweep_dir: str | None = None,
                 resume: bool = False):
        self.base = base
        self.strategy = strategy
        self.sweep_dir = sweep_dir
        self.resume = resume
        # Point configs are SOLO experiment configs: the sweep knobs are
        # stripped so a point's config_hash equals the hash of the same
        # experiment run standalone (the comparability the scheduler's
        # grouping and the bench's serial baseline both rest on).
        strip = dict(
            sweep_seeds=None, sweep_points=None, sweep_strategy="auto",
            sweep_dir=None, sweep_resume=False,
        )
        self.points = []
        for i, ov in enumerate(points):
            try:
                cfg = dataclasses.replace(base, **{**strip, **ov})
            except TypeError as e:
                raise ValueError(
                    f"sweep point {i} overrides unknown config field(s): "
                    f"{sorted(ov)} ({e})"
                ) from e
            self.points.append(
                SweepPoint(index=i, overrides=dict(ov), config=cfg)
            )
        self._validated = False

    @classmethod
    def from_config(cls, config: ExperimentConfig) -> "SweepSpec":
        """Build the spec from the config's sweep knobs: ``sweep_seeds``
        (comma-separated seed fleet) x ``sweep_points`` (JSON override
        list) — when both are given, every override runs at every seed
        (the seeds-x-hyperparameters grid)."""
        seeds = _parse_seeds_field(config.sweep_seeds)
        point_dicts = _parse_points_field(config.sweep_points)
        if seeds is None and point_dicts is None:
            raise ValueError(
                "no sweep requested: set sweep_seeds (e.g. '0,1,2,3') "
                "and/or sweep_points (a JSON list of override objects)"
            )
        if seeds is None:
            grid = [dict(p) for p in point_dicts]
        elif point_dicts is None:
            grid = [{"seed": s} for s in seeds]
        else:
            grid = [
                {**p, "seed": s} for p in point_dicts for s in seeds
            ]
        return cls(
            config, grid, strategy=config.sweep_strategy,
            sweep_dir=config.sweep_dir, resume=config.sweep_resume,
        )

    @staticmethod
    def active(config) -> bool:
        """Whether this config asks for a sweep (the front-door dispatch
        in ``simulator.main`` / ``__main__``)."""
        return bool(
            _parse_seeds_field(getattr(config, "sweep_seeds", None))
            or _parse_points_field(getattr(config, "sweep_points", None))
        )

    # ---- validation / refusals --------------------------------------------
    def validate(self) -> "SweepSpec":
        if not self.points:
            raise ValueError("a sweep needs at least one point")
        if self.strategy not in SWEEP_STRATEGIES:
            raise ValueError(
                f"unknown sweep strategy {self.strategy!r}; known: "
                + ", ".join(SWEEP_STRATEGIES)
            )
        seen: dict[tuple, int] = {}
        for p in self.points:
            # Per-point config validation first: a typo'd override fails
            # with the normal config error, named with its point index.
            try:
                p.config.validate()
            except ValueError as e:
                raise ValueError(
                    f"sweep point {p.index} ({p.overrides!r}) is invalid: "
                    f"{e}"
                ) from e
            cfg = p.config
            if cfg.execution_mode.lower() == "threaded":
                raise ValueError(
                    "execution_mode='threaded' does not support sweeps: "
                    "the thread-per-client oracle owns one OS thread per "
                    "client per experiment and shares no compiled "
                    "program; run threaded points as solo runs"
                )
            if cfg.distributed_algorithm in SHAPLEY_ALGORITHMS:
                raise ValueError(
                    f"algorithm {cfg.distributed_algorithm!r} does not "
                    "support sweeps: its post_round drives data-dependent "
                    "subset evaluation that must observe every round "
                    "synchronously — neither a vmapped fleet nor a "
                    "shared warm program can serve it; run Shapley "
                    "configs as solo runs"
                )
            if (
                cfg.client_residency.lower() == "streamed"
                and cfg.rounds_per_dispatch > 1
            ):
                raise ValueError(
                    "client_residency='streamed' with rounds_per_dispatch"
                    " > 1 does not compose with sweeps: the scheduler "
                    "cannot host-replay K stacked cohort plans across "
                    "points sharing one streamer; set "
                    "rounds_per_dispatch=1 or client_residency='resident'"
                )
            if cfg.multihost:
                raise ValueError(
                    "sweeps do not compose with multihost: every process "
                    "would re-run the whole point list; shard the sweep "
                    "across hosts by splitting the point list instead"
                )
            key = (config_hash(cfg), cfg.round)
            if key in seen:
                raise ValueError(
                    f"sweep points {seen[key]} and {p.index} are "
                    "identical experiments (same program-defining knobs, "
                    "seed, and horizon) — a duplicate point would just "
                    "recompute the same history; drop one or vary a knob"
                )
            seen[key] = p.index
        if self.strategy == "vmapped":
            ok, reason = self.fleet_compatible()
            if not ok:
                raise ValueError(
                    f"sweep_strategy='vmapped' refused: {reason}; use "
                    "sweep_strategy='scheduled' (or 'auto')"
                )
        self._validated = True
        return self

    def fleet_compatible(self) -> tuple[bool, str]:
        """Whether every point can join ONE vmapped fleet.

        Returns ``(ok, reason)`` — the reason names the first blocking
        feature so 'auto' falling back to 'scheduled' (and 'vmapped'
        refusing) is always explainable.
        """
        base = self.points[0].config
        for p in self.points:
            stripped = {
                k: v for k, v in p.overrides.items() if k not in FLEET_AXES
            }
            if dataclasses.replace(
                p.config, **{a: getattr(base, a) for a in FLEET_AXES}
            ) != dataclasses.replace(
                base, **{a: getattr(base, a) for a in FLEET_AXES}
            ):
                return False, (
                    f"point {p.index} overrides program-defining knobs "
                    f"beyond the fleet axes {FLEET_AXES}: "
                    f"{sorted(stripped)} — a vmapped fleet shares one "
                    "compiled program, so only operand-valued knobs may "
                    "vary"
                )
        cfg = base
        if cfg.distributed_algorithm not in ("fed",):
            return False, (
                f"algorithm {cfg.distributed_algorithm!r} does not "
                "support the experiment-vmapped fleet (fed only: "
                "fed_quant's post_round computes per-model payload "
                "analytics the stacked fleet cannot attribute; sign_SGD "
                "takes no lr operand and may carry per-client momentum)"
            )
        if not cfg.reset_client_optimizer:
            return False, (
                "reset_client_optimizer=False keeps per-client optimizer "
                "state — a vmapped fleet would hold E full per-client "
                "state stacks resident"
            )
        if cfg.client_eval is True:
            return False, (
                "client_eval=True materializes the per-client parameter "
                "stack per experiment and its post_round evaluates every "
                "client's model per point"
            )
        if cfg.aggregation.lower() != "mean":
            return False, (
                f"aggregation={cfg.aggregation!r} materializes the "
                "per-client parameter stack — E resident stacks defeat "
                "the fleet's memory envelope"
            )
        if cfg.client_stats.lower() == "on" or (
            cfg.client_valuation.lower() == "on"
        ):
            return False, (
                "client_stats/client_valuation host-side detectors are "
                "per-run machinery (median/MAD flags, the streaming "
                "valuation fold) not yet stacked over an experiment axis"
            )
        if cfg.async_mode.lower() == "on":
            return False, (
                "async_mode='on' carries a staleness-buffer state tree "
                "per experiment; the fleet does not stack it"
            )
        if getattr(cfg, "population", "static").lower() != "static":
            return False, (
                "population='dynamic' grows the client axis mid-run "
                "(robustness/population.py); experiment-axis stacking "
                "assumes a fixed N shared by every point, so a vmapped "
                "fleet cannot serve it — the scheduled strategy runs "
                "each dynamic point through a full run_simulation"
            )
        if cfg.client_residency.lower() != "resident":
            return False, (
                "client_residency='streamed' pins the cohort pipeline to "
                "one host store/streamer pair; the fleet runs resident "
                "data shared across experiments"
            )
        if cfg.rounds_per_dispatch > 1:
            return False, (
                "rounds_per_dispatch > 1 fuses the host round loop into "
                "a scan per run; the fleet owns its own round loop"
            )
        if cfg.server_optimizer_name.lower() not in ("none", ""):
            return False, (
                "a server optimizer keeps per-experiment server state; "
                "the fleet does not stack it"
            )
        if cfg.telemetry_level.lower() != "off":
            return False, (
                "telemetry_level != 'off' attributes phase timings and "
                "recompiles per run; a fleet dispatch is one program for "
                "all points"
            )
        if cfg.checkpoint_dir or cfg.resume:
            return False, (
                "per-round checkpointing is per-run state; sweep-level "
                "checkpoint/resume (sweep_dir) covers interrupted sweeps"
            )
        if cfg.profile_dir or cfg.cost_model_trace:
            return False, (
                "profiling / cost-model trace attachment are per-run "
                "analyses"
            )
        if (
            cfg.mesh_devices and cfg.mesh_devices > 1
            and len(self.points) % cfg.mesh_devices != 0
        ):
            return False, (
                f"experiment-axis mesh packing needs the point count "
                f"({len(self.points)}) to be a multiple of mesh_devices "
                f"({cfg.mesh_devices}) — each device owns whole "
                "experiments"
            )
        return True, ""

    def resolve_strategy(self) -> str:
        """The strategy the engine will run (validate() first)."""
        if not self._validated:
            self.validate()
        if self.strategy == "vmapped":
            return "vmapped"
        if self.strategy == "scheduled":
            return "scheduled"
        ok, _ = self.fleet_compatible()
        return "vmapped" if ok else "scheduled"
