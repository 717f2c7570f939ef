"""Experiment configuration + CLI (config.py of the JAX package).

``ExperimentConfig`` carries every field of the JAX package's config under
the same name and default, so the two CLIs take the same flags, plus the
port's own ``device`` (default ``"cuda"``; the tests pass ``"cpu"``).
The field comments are short; the JAX package's config.py documents each
knob in full.

``validate()`` keeps the JAX package's value checks and raises
``NotImplementedError`` for every feature this port does not have yet,
naming the ROADMAP.md queue item that will bring it. Nothing is silently
ignored: a field the port does not read is either inert for the FedAvg
main path in the JAX package too (the other algorithms' knobs), or refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

from distributed_learning_simulator_tpu_torch.ops.aggregate import trim_count

TELEMETRY_LEVELS = ("off", "basic", "detailed")
CLIENT_STATS_LEVELS = ("off", "on")
PARTICIPATION_SAMPLERS = ("exact", "hashed")
SWEEP_STRATEGIES = ("auto", "vmapped", "scheduled")
POPULATION_MODES = ("static", "dynamic")


@dataclass
class ExperimentConfig:
    # --- reference-parity flags -------------------------------------------
    dataset_name: str = "mnist"
    model_name: str = "lenet5"
    distributed_algorithm: str = "fed"
    worker_number: int = 4
    round: int = 10
    epoch: int = 2  # local epochs per round
    learning_rate: float = 0.01
    optimizer_name: str = "SGD"
    log_level: str = "INFO"
    dataset_args: dict[str, Any] = field(default_factory=dict)
    # Model-constructor kwargs (models/registry.get_model), e.g.
    # {"stage_sizes": [1, 1], "width": 16}. {"fold_stage1": ...} is accepted
    # and changes nothing: the W-folded stage 1 is a TPU layout device with
    # identical parameters and math.
    model_args: dict[str, Any] = field(default_factory=dict)

    # --- training -----------------------------------------------------------
    batch_size: int = 32
    momentum: float = 0.0
    weight_decay: float = 0.0
    dampening: float = 0.0  # not read by the JAX sgd either (optax.sgd)
    nesterov: bool = False  # not read by the JAX sgd either (optax.sgd)
    seed: int = 0
    reset_client_optimizer: bool = True
    # "bfloat16": per-client params/grads/momenta stored in bf16 during the
    # local run, with hash-dither stochastic rounding at every store and an
    # f32 aggregate (parallel/engine.py).
    local_compute_dtype: str = "float32"
    augment: str = "none"
    aggregation: str = "mean"
    trim_ratio: float = 0.1
    # --- failure model -------------------------------------------------------
    failure_mode: str = "none"
    failure_prob: float = 0.0
    failure_correlation: float = 0.0
    failure_seed: int = 0
    # --- open-world population ----------------------------------------------
    population: str = "static"
    population_seed: int = 0
    join_rate: float = 0.0
    depart_rate: float = 0.0
    drift_fraction: float = 0.0
    drift_factor: float = 0.5
    # --- asynchronous federation --------------------------------------------
    async_mode: str = "off"
    arrival_model: str = "none"
    arrival_slow_fraction: float = 0.2
    arrival_slow_factor: float = 8.0
    arrival_sigma: float = 0.5
    arrival_seed: int = 0
    round_deadline: float = float("inf")
    async_buffer_size: int = 8
    staleness_alpha: float = 0.5
    min_survivors: int = 0
    # --- server optimizer ----------------------------------------------------
    server_optimizer_name: str = "none"
    server_learning_rate: float = 1.0
    server_momentum: float = 0.0

    # --- data partitioning (data/partition.py) -----------------------------
    partition: str = "iid"  # iid | dirichlet
    dirichlet_alpha: float = 0.1
    # Cap on each client's shard (an unbiased seed+17 draw, simulator.py).
    max_shard_size: int | None = None
    n_train: int | None = None
    n_test: int | None = None
    data_dir: str | None = None

    # --- quantization (fed_quant) -------------------------------------------
    quant_levels: int = 256
    qat: bool = True
    client_eval: bool | None = None

    # --- learning-rate schedule ---------------------------------------------
    lr_schedule: str = "constant"
    lr_schedule_rounds: int | None = None
    lr_min_factor: float = 0.0
    lr_step_size: int = 30
    lr_step_gamma: float = 0.1

    # --- Shapley ---------------------------------------------------------------
    round_trunc_threshold: float | None = None
    gtg_eps: float = 1e-3
    gtg_last_k: int = 10
    gtg_converge_criteria: float = 0.05
    gtg_max_permutations: int | None = None
    shapley_eval_samples: int | None = None
    shapley_eval_chunk: int = 16
    shapley_eval_dtype: str = "auto"
    gtg_prefix_mode: str = "cumsum"

    # --- execution -------------------------------------------------------------
    execution_mode: str = "vmap"
    mesh_devices: int | None = None
    multihost: bool = False
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    # Clients per aggregation chunk. The port trains the clients of a chunk
    # one after another and adds each one's params into the chunk's f32
    # partial sum, in the order the JAX fused path reduces them.
    client_chunk_size: int | None = None
    # Size-aware schedule: clients sorted by shard size, each chunk scans
    # only as far as its largest member (algorithms/fedavg.py _bucket_plan).
    bucket_client_work: bool = True
    client_residency: str = "resident"
    participation_fraction: float = 1.0
    participation_sampler: str = "exact"
    # The JAX package defers each round's metric fetch by one round; the
    # port fetches every round synchronously. Results are identical either
    # way, so the flag has no effect here.
    pipeline_rounds: bool = True
    rounds_per_dispatch: int = 1
    # --- telemetry -------------------------------------------------------------
    telemetry_level: str = "off"
    span_trace: str = "off"
    span_dir: str | None = None
    span_buffer_size: int = 4096
    span_flush_last_k: int = 64
    client_stats: str = "off"
    client_stats_every: int = 1
    client_stats_probe: int = 4096
    client_stats_mad_threshold: float = 8.0
    client_valuation: str = "off"
    valuation_decay: float = 0.9
    valuation_audit_every: int = 0
    valuation_audit_permutations: int = 16
    gtg_cross_round_memo: bool = False
    profile_dir: str | None = None
    profile_from_round: int = 0
    cost_model_trace: str | None = None
    cost_model_trace_rounds: int = 1
    cost_model_topology: str = "v5e-1"
    # --- multi-experiment sweep ---------------------------------------------
    sweep_seeds: str | None = None
    sweep_points: str | None = None
    sweep_strategy: str = "auto"
    sweep_dir: str | None = None
    sweep_resume: bool = False
    # XLA's compilation cache in the JAX package; PyTorch runs eagerly and
    # compiles nothing, so the port does not read it.
    compilation_cache_dir: str | None = ".jax_cache"
    # Client shards stored as uint8-flattened samples, decoded per batch.
    compact_client_data: bool = True
    eval_batch_size: int = 512
    log_root: str = "log"
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    checkpoint_keep_last: int | None = None
    resume: bool = False
    # --- port only -------------------------------------------------------------
    # Where the run executes: "cuda" (the default; raises when no card is
    # present — the port never carries on on the CPU by itself), "cuda:N",
    # or "cpu" (the tests).
    device: str = "cuda"

    def cohort_size(self, n_clients: int | None = None) -> int:
        """Participants per round (the one copy of the sampling formula)."""
        n = self.worker_number if n_clients is None else n_clients
        if self.participation_fraction >= 1.0:
            return n
        return max(1, round(self.participation_fraction * n))

    def validate(self) -> "ExperimentConfig":
        self._validate_values()
        self._refuse_unported()
        return self

    def _validate_values(self) -> None:
        """The JAX package's checks of plain field values (ValueError)."""
        if self.worker_number < 1:
            raise ValueError("worker_number must be >= 1")
        if self.round < 1:
            raise ValueError("round must be >= 1")
        if self.partition not in ("iid", "dirichlet"):
            raise ValueError(f"unknown partition {self.partition!r}")
        if not 0.0 < self.participation_fraction <= 1.0:
            raise ValueError("participation_fraction must be in (0, 1]")
        if self.participation_sampler.lower() not in PARTICIPATION_SAMPLERS:
            raise ValueError(
                f"unknown participation_sampler "
                f"{self.participation_sampler!r}; known: "
                + ", ".join(PARTICIPATION_SAMPLERS)
            )
        if self.compilation_cache_dir in ("", "none", "None"):
            self.compilation_cache_dir = None
        if self.sweep_strategy not in SWEEP_STRATEGIES:
            raise ValueError(
                f"unknown sweep_strategy {self.sweep_strategy!r}; known: "
                + ", ".join(SWEEP_STRATEGIES)
            )
        if not isinstance(self.model_args, dict):
            raise ValueError(
                "model_args must be a dict of model-constructor kwargs "
                '(CLI: a JSON object, e.g. \'{"fold_stage1": false}\')'
            )
        if self.aggregation.lower() not in ("mean", "median", "trimmed_mean",
                                            "krum"):
            raise ValueError(
                f"unknown aggregation {self.aggregation!r}; known: mean, "
                "median, trimmed_mean, krum"
            )
        if not 0.0 <= self.trim_ratio < 0.5:
            raise ValueError("trim_ratio must be in [0, 0.5)")
        if self.aggregation.lower() == "trimmed_mean":
            cohort = self.cohort_size()
            if trim_count(cohort, self.trim_ratio) < 1:
                raise ValueError(
                    f"trimmed_mean with trim_ratio={self.trim_ratio} and a "
                    f"cohort of {cohort} trims k=0 clients — a plain mean "
                    "with zero robustness (one NaN upload poisons the "
                    "round); raise trim_ratio or the cohort size so "
                    "trim_ratio * cohort >= 1"
                )
        if self.aggregation.lower() == "krum":
            cohort = self.cohort_size()
            f = trim_count(cohort, self.trim_ratio)
            if cohort < 2 * f + 3:
                raise ValueError(
                    f"krum needs n >= 2f + 3 participants (cohort={cohort}, "
                    f"assumed Byzantine f={f}); lower trim_ratio or raise "
                    "worker_number/participation_fraction"
                )
        if (
            self.client_eval is True
            and self.distributed_algorithm not in ("fed", "fed_quant")
        ):
            raise ValueError(
                "client_eval=True is only supported for the FedAvg family "
                f"(fed, fed_quant), not {self.distributed_algorithm!r}"
            )
        if (
            self.shapley_eval_samples is not None
            and self.shapley_eval_samples < 1
        ):
            raise ValueError("shapley_eval_samples must be >= 1 or None")
        if self.shapley_eval_chunk < 1:
            raise ValueError("shapley_eval_chunk must be >= 1")
        if self.shapley_eval_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                "shapley_eval_dtype must be 'auto', 'float32' or "
                f"'bfloat16', got {self.shapley_eval_dtype!r}"
            )
        if self.gtg_prefix_mode not in ("cumsum", "masked"):
            raise ValueError(
                "gtg_prefix_mode must be 'cumsum' or 'masked', got "
                f"{self.gtg_prefix_mode!r}"
            )
        if (
            self.gtg_max_permutations is not None
            and self.gtg_max_permutations < 1
        ):
            raise ValueError(
                "gtg_max_permutations must be >= 1 or None (= auto "
                "max(500, 2N))"
            )
        if not 0.0 <= self.failure_prob <= 1.0:
            raise ValueError("failure_prob must be in [0, 1]")
        if not 0.0 <= self.failure_correlation <= 1.0:
            raise ValueError("failure_correlation must be in [0, 1]")
        if self.min_survivors < 0:
            raise ValueError("min_survivors must be >= 0")
        if self.checkpoint_keep_last is not None and (
            self.checkpoint_keep_last < 1
        ):
            raise ValueError(
                "checkpoint_keep_last must be >= 1 or None (= keep all)"
            )
        if self.local_compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown local_compute_dtype {self.local_compute_dtype!r}; "
                "known: float32, bfloat16"
            )
        if (
            self.local_compute_dtype == "bfloat16"
            and not self.reset_client_optimizer
        ):
            raise ValueError(
                "local_compute_dtype='bfloat16' requires "
                "reset_client_optimizer=True (persistent per-client "
                "optimizer state is f32 and would mix dtypes across rounds)"
            )
        if self.client_chunk_size is not None and self.client_chunk_size < 0:
            raise ValueError(
                "client_chunk_size must be positive, 0 (auto), or None"
            )
        if self.execution_mode.lower() not in ("vmap", "threaded"):
            raise ValueError(
                f"unknown execution_mode {self.execution_mode!r}; known: "
                "vmap, threaded"
            )
        if self.client_residency.lower() not in ("resident", "streamed"):
            raise ValueError(
                f"unknown client_residency {self.client_residency!r}; "
                "known: resident, streamed"
            )
        if self.population.lower() not in POPULATION_MODES:
            raise ValueError(
                f"unknown population {self.population!r}; known: "
                + ", ".join(POPULATION_MODES)
            )
        if self.rounds_per_dispatch < 1:
            raise ValueError("rounds_per_dispatch must be >= 1")
        if self.telemetry_level.lower() not in TELEMETRY_LEVELS:
            raise ValueError(
                f"unknown telemetry_level {self.telemetry_level!r}; known: "
                + ", ".join(TELEMETRY_LEVELS)
            )
        if self.span_trace.lower() not in ("off", "on"):
            raise ValueError(
                f"unknown span_trace {self.span_trace!r}; known: off, on"
            )
        if self.client_stats.lower() not in CLIENT_STATS_LEVELS:
            raise ValueError(
                f"unknown client_stats {self.client_stats!r}; known: "
                + ", ".join(CLIENT_STATS_LEVELS)
            )
        if self.client_valuation.lower() not in ("off", "on"):
            raise ValueError(
                f"unknown client_valuation {self.client_valuation!r}; "
                "known: off, on"
            )
        if self.profile_from_round < 0:
            raise ValueError(
                f"profile_from_round must be >= 0, got "
                f"{self.profile_from_round}"
            )
        if self.lr_schedule.lower() not in ("constant", "cosine", "step"):
            raise ValueError(
                f"unknown lr_schedule {self.lr_schedule!r}; known: "
                "constant, cosine, step"
            )
        if self.lr_schedule.lower() != "constant":
            if self.distributed_algorithm == "sign_SGD":
                raise ValueError(
                    "lr_schedule is supported for the FedAvg family only, "
                    "not sign_SGD"
                )
            if not 0.0 <= self.lr_min_factor <= 1.0:
                raise ValueError("lr_min_factor must be in [0, 1]")
            if (
                self.lr_schedule_rounds is not None
                and self.lr_schedule_rounds < 1
            ):
                raise ValueError(
                    "lr_schedule_rounds must be >= 1 or None (= whole run)"
                )
            if self.lr_step_size < 1:
                raise ValueError("lr_step_size must be >= 1")
            if not 0.0 <= self.lr_step_gamma <= 1.0:
                raise ValueError("lr_step_gamma must be in [0, 1]")
        server_opt = self.server_optimizer_name.lower()
        if server_opt not in ("none", "", "sgd", "adam"):
            raise ValueError(
                f"unknown server optimizer {self.server_optimizer_name!r}; "
                "known: none, sgd, adam"
            )
        if self.server_learning_rate <= 0.0:
            raise ValueError("server_learning_rate must be > 0")
        if not 0.0 <= self.server_momentum < 1.0:
            raise ValueError("server_momentum must be in [0, 1)")
        if self.device != "cpu" and not (
            self.device == "cuda"
            or (self.device.startswith("cuda:")
                and self.device[5:].isdigit())
        ):
            raise ValueError(
                f"unknown device {self.device!r}; known: cuda, cuda:N, cpu"
            )

    def _refuse_unported(self) -> None:
        """NotImplementedError for every feature the port lacks so far,
        naming the ROADMAP.md queue 1 item that brings it."""
        checks = (
            (self.client_residency.lower() == "streamed",
             "client_residency='streamed'", 15),
            (self.population.lower() == "dynamic",
             "population='dynamic'", 15),
            (self.mesh_devices is not None and self.mesh_devices > 1,
             "mesh_devices > 1", 17),
            (self.multihost, "multihost", 17),
            (self.async_mode.lower() == "on", "async_mode='on'", 14),
            (self.rounds_per_dispatch > 1, "rounds_per_dispatch > 1", 14),
            (self.failure_mode != "none" and self.failure_prob > 0.0,
             f"failure_mode={self.failure_mode!r}", 12),
            (self.min_survivors > 0, "min_survivors > 0", 12),
            (bool(self.checkpoint_dir) or self.checkpoint_every > 0
             or self.resume, "checkpoints (checkpoint_dir/resume)", 12),
            (self.execution_mode.lower() == "threaded",
             "execution_mode='threaded'", 12),
            (self.telemetry_level.lower() != "off",
             f"telemetry_level={self.telemetry_level!r}", 13),
            (self.span_trace.lower() == "on", "span_trace='on'", 13),
            (self.client_stats.lower() == "on", "client_stats='on'", 13),
            (self.client_valuation.lower() == "on"
             or self.valuation_audit_every > 0, "client valuation", 13),
            (self.profile_dir is not None, "profile_dir", 13),
            (self.cost_model_trace is not None, "cost_model_trace", 13),
            (bool(self.sweep_seeds or self.sweep_points), "sweeps", 16),
            # sign_SGD's constructor raises ValueError for any optimizer
            # but SGD, as in the JAX package.
            (self.optimizer_name.lower() != "sgd"
             and self.distributed_algorithm != "sign_SGD",
             f"optimizer_name={self.optimizer_name!r}", 19),
            (self.server_optimizer_name.lower() not in ("none", ""),
             f"server_optimizer_name={self.server_optimizer_name!r}", 19),
            (self.augment.lower() != "none", f"augment={self.augment!r}", 20),
            (not self.reset_client_optimizer,
             "reset_client_optimizer=False", 20),
            (self.client_chunk_size == 0, "client_chunk_size=0 (auto)", 20),
            (self.model_args.get("gn_custom_backward", True) is False,
             "model_args gn_custom_backward=False", 20),
        )
        for refused, what, item in checks:
            if refused:
                raise NotImplementedError(
                    f"{what} is not ported to the PyTorch package yet "
                    f"(ROADMAP.md queue 1 item {item})"
                )


def _add_args(parser: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(ExperimentConfig):
        if f.name == "dataset_args":
            continue
        arg = f"--{f.name}"
        if f.name == "model_args":
            parser.add_argument(
                arg, type=json.loads, default={},
                help="JSON object of model-constructor kwargs, e.g. "
                     '\'{"stage_sizes": [1, 1]}\'',
            )
            continue
        if f.type in ("bool", bool):
            parser.add_argument(arg, type=lambda s: s.lower() in ("1", "true"),
                                default=f.default)
        elif f.name == "client_eval":  # tri-state: auto/None, true, false
            parser.add_argument(
                arg,
                type=lambda s: (
                    None if s.lower() in ("auto", "none")
                    else s.lower() in ("1", "true")
                ),
                default=None,
            )
        elif f.name in ("n_train", "n_test", "mesh_devices", "num_processes",
                        "process_id", "lr_schedule_rounds",
                        "shapley_eval_samples", "gtg_max_permutations",
                        "checkpoint_keep_last"):
            parser.add_argument(arg, type=int, default=None)
        elif f.name in ("round_trunc_threshold", "checkpoint_dir", "data_dir",
                        "profile_dir", "cost_model_trace",
                        "client_chunk_size", "max_shard_size",
                        "coordinator_address", "sweep_seeds",
                        "sweep_points", "sweep_dir", "span_dir"):
            typ = {
                "round_trunc_threshold": float,
                "client_chunk_size": int,
                "max_shard_size": int,
            }.get(f.name, str)
            parser.add_argument(arg, type=typ, default=None)
        else:
            parser.add_argument(arg, type=type(f.default), default=f.default)


def get_config(args: list[str] | None = None) -> ExperimentConfig:
    """Parse CLI args into a validated ExperimentConfig."""
    parser = argparse.ArgumentParser(
        description="Federated-learning simulator (PyTorch/CUDA port)"
    )
    _add_args(parser)
    ns = parser.parse_args(args)
    return ExperimentConfig(**vars(ns)).validate()
