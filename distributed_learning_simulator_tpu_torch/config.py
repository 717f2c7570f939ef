"""Experiment configuration + CLI (config.py of the JAX package).

``ExperimentConfig`` carries every field of the JAX package's config under
the same name and default, so the two CLIs take the same flags, plus the
port's own ``device`` (default ``"cuda"``; the tests pass ``"cpu"``). One
default differs on purpose: ``cost_model_topology`` is ``"h100-sxm-1"``,
the card the port's traces come from.
The field comments are short; the JAX package's config.py documents each
knob in full.

``validate()`` keeps the JAX package's checks, with its texts: the port
accepts every configuration the JAX package accepts and refuses the
others as it does. Nothing is silently ignored: every field acts as in
the JAX package (``pipeline_rounds`` included: the round loop defers each
round's fetch where the JAX package does, and logs the JAX text where it
turns that off), and a field that neither package reads on a path is the
other algorithms' knob there.
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
#: The Shapley family (their population refusal names its cause).
SHAPLEY_ALGORITHMS = ("multiround_shapley_value", "GTG_shapley_value")


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
    # partial sum, in the order the JAX fused path reduces them. 0 = auto,
    # from the JAX package's device-memory footprint model (simulator.py).
    client_chunk_size: int | None = None
    # Size-aware schedule: clients sorted by shard size, each chunk scans
    # only as far as its largest member (algorithms/fedavg.py _bucket_plan).
    bucket_client_work: bool = True
    client_residency: str = "resident"
    participation_fraction: float = 1.0
    participation_sampler: str = "exact"
    # Defer each round's metric fetch, record and checkpoint until the next
    # round is dispatched (off, with a logged reason, where the JAX package
    # turns it off); results are identical either way.
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
    # The anchor is the card that made the trace: the port's default is its
    # own table's H100 row (telemetry/topologies.py), where the JAX
    # package's is a TPU row.
    cost_model_topology: str = "h100-sxm-1"
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
        if self.sweep_resume and not self.sweep_dir:
            raise ValueError(
                "sweep_resume=True needs sweep_dir (where the completed "
                "points were persisted)"
            )
        if self.sweep_seeds or self.sweep_points:
            # Sweep-wide refusals (the one authoritative copy; sweep/
            # spec.py re-checks per point because overrides can
            # introduce any of these).
            if self.execution_mode.lower() == "threaded":
                raise ValueError(
                    "execution_mode='threaded' does not support sweeps: "
                    "the thread-per-client oracle owns one OS thread per "
                    "client per experiment and shares no compiled "
                    "program; run threaded points as solo runs"
                )
            if self.distributed_algorithm in SHAPLEY_ALGORITHMS:
                raise ValueError(
                    f"algorithm {self.distributed_algorithm!r} does not "
                    "support sweeps: its post_round drives data-dependent "
                    "subset evaluation that must observe every round "
                    "synchronously; run Shapley configs as solo runs"
                )
            if (
                self.client_residency.lower() == "streamed"
                and self.rounds_per_dispatch > 1
            ):
                raise ValueError(
                    "client_residency='streamed' with rounds_per_dispatch"
                    " > 1 does not compose with sweeps: the scheduler "
                    "cannot host-replay K stacked cohort plans across "
                    "points sharing one streamer; set "
                    "rounds_per_dispatch=1 or client_residency='resident'"
                )
            if self.multihost:
                raise ValueError(
                    "sweeps do not compose with multihost: every process "
                    "would re-run the whole point list; shard the sweep "
                    "across hosts by splitting the point list instead"
                )
        if self.cost_model_trace_rounds < 1:
            raise ValueError("cost_model_trace_rounds must be >= 1")
        from distributed_learning_simulator_tpu_torch.telemetry.topologies import (  # noqa: E501
            get_topology,
        )

        get_topology(self.cost_model_topology)  # fail fast on typos
        if not isinstance(self.model_args, dict):
            raise ValueError(
                "model_args must be a dict of model-constructor kwargs "
                '(CLI: a JSON object, e.g. \'{"fold_stage1": false}\')'
            )
        # ops/augment.py imports this module's package through ops/prng.py.
        from distributed_learning_simulator_tpu_torch.ops.augment import (
            get_augment,
        )

        get_augment(self.augment)  # fail fast on unknown augmentation names
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
        from distributed_learning_simulator_tpu_torch.robustness import (
            faults,
        )

        if self.failure_mode not in faults.MODES:
            raise ValueError(
                f"unknown failure_mode {self.failure_mode!r}; known: "
                + ", ".join(faults.MODES)
            )
        if not 0.0 <= self.failure_prob <= 1.0:
            raise ValueError("failure_prob must be in [0, 1]")
        if not 0.0 <= self.failure_correlation <= 1.0:
            raise ValueError("failure_correlation must be in [0, 1]")
        if self.min_survivors < 0:
            raise ValueError("min_survivors must be >= 0")
        if self.min_survivors > self.cohort_size():
            raise ValueError(
                f"min_survivors={self.min_survivors} exceeds the sampled "
                f"cohort size ({self.cohort_size()}); every round would be "
                "rejected — lower it or raise worker_number/"
                "participation_fraction"
            )
        if (
            self.failure_mode != "none" and self.failure_prob > 0.0
            and self.execution_mode.lower() == "threaded"
        ):
            raise ValueError(
                "the threaded execution oracle does not model client "
                "failures; use execution_mode='vmap' with a failure "
                "model"
            )
        from distributed_learning_simulator_tpu_torch.robustness.arrivals import (  # noqa: E501
            ARRIVAL_MODES,
            AsyncFederation,
        )

        if self.arrival_model not in ARRIVAL_MODES:
            # Checked at async_mode='off' too, so a typo fails fast.
            raise ValueError(
                f"unknown arrival_model {self.arrival_model!r}; known: "
                + ", ".join(ARRIVAL_MODES)
            )
        # The async_mode / arrival-model gate (the errors library callers
        # of AsyncFederation.from_config see).
        AsyncFederation.from_config(self)
        if self.async_mode.lower() == "on":
            if not self.round_deadline > 0.0:
                raise ValueError("round_deadline must be > 0 (inf = sync)")
            if self.async_buffer_size < 1:
                raise ValueError("async_buffer_size must be >= 1")
            if self.staleness_alpha < 0.0:
                raise ValueError("staleness_alpha must be >= 0")
            if not 0.0 <= self.arrival_slow_fraction <= 1.0:
                raise ValueError(
                    "arrival_slow_fraction must be in [0, 1]"
                )
            if self.arrival_slow_factor < 1.0:
                raise ValueError("arrival_slow_factor must be >= 1")
            if self.arrival_model == "lognormal" and self.arrival_sigma <= 0.0:
                raise ValueError("arrival_sigma must be > 0")
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
        if self.client_residency.lower() == "streamed":
            if self.execution_mode.lower() == "threaded":
                raise ValueError(
                    "client_residency='streamed' requires the vmap "
                    "execution mode (the threaded oracle owns its own "
                    "per-worker data)"
                )
            if self.multihost:
                # The distributed shard store (data/residency.py
                # DistributedShardStore, parallel/streaming.py
                # DistributedCohortStreamer): each process owns an
                # N/num_hosts client slice and serves its own cohort
                # members; only the per-round ownership imbalance crosses
                # between processes. The refusals below are the JAX
                # package's, with its texts.
                if self.mesh_devices is None or self.mesh_devices < 2:
                    raise ValueError(
                        "client_residency='streamed' under multihost "
                        "needs mesh_devices set to the GLOBAL device "
                        "count: the distributed shard store serves each "
                        "host's cohort members into its addressable "
                        "shards of the client-axis PartitionSpec, so "
                        "there must be a mesh spanning every process"
                    )
                if (
                    self.participation_fraction < 1.0
                    and self.participation_sampler.lower() != "hashed"
                ):
                    raise ValueError(
                        "client_residency='streamed' under multihost "
                        "requires participation_sampler='hashed' for "
                        "sampled cohorts: every host replays the full "
                        "cohort independently each round, and only the "
                        "O(cohort) hashed draw keeps that replay free "
                        "at million-client populations (the exact "
                        "sampler pays an O(N log N) permutation PER "
                        "HOST per round)"
                    )
                if self.rounds_per_dispatch > 1:
                    raise ValueError(
                        "client_residency='streamed' under multihost "
                        "requires rounds_per_dispatch=1: a fused "
                        "K-round dispatch would need K owner-sharded "
                        "assemblies and spill exchanges inside one "
                        "program, which the host-side exchange cannot "
                        "serve mid-dispatch"
                    )
                if (
                    self.distributed_algorithm == "fed_quant"
                    and self.participation_fraction < 1.0
                ):
                    raise ValueError(
                        "client_residency='streamed' under multihost "
                        "does not compose with fed_quant at sampled "
                        "cohorts: its uplink stochastic-quantization "
                        "keys split per cohort ROW, so the "
                        "owner-permuted layout would dither each "
                        "client's upload with a different key than "
                        "the 1-process run (silently breaking the "
                        "per-client bit-identity contract the "
                        "draw_pos operand provides for training "
                        "draws); use participation_fraction=1, plain "
                        "'fed', or client_residency='resident'"
                    )
                if self.async_mode.lower() == "on":
                    raise ValueError(
                        "client_residency='streamed' under multihost "
                        "does not compose with async_mode='on': the "
                        "staleness buffer's late-upload row has been "
                        "validated on single-host meshes only; use "
                        "client_residency='resident' for async "
                        "multihost runs"
                    )
                if self.client_stats.lower() == "on":
                    raise ValueError(
                        "client_residency='streamed' under multihost "
                        "does not compose with client_stats='on': the "
                        "per-client stats matrix is client-axis sharded "
                        "across processes and the host-side detector "
                        "fetch would need a cross-host gather every "
                        "round; use resident multihost for client stats"
                    )
                if self.client_valuation.lower() == "on":
                    raise ValueError(
                        "client_residency='streamed' under multihost "
                        "does not compose with client_valuation='on': "
                        "the streaming valuation vector is a full-N "
                        "host array with ONE owner, which the "
                        "host-sharded store deliberately no longer has"
                    )
                if self.participation_fraction >= 1.0 and (
                    (
                        self.distributed_algorithm == "sign_SGD"
                        and self.momentum != 0.0
                    )
                    or not self.reset_client_optimizer
                ):
                    raise ValueError(
                        "client_residency='streamed' under multihost "
                        "does not compose with persistent per-client "
                        "state at full participation (momentum "
                        "sign_SGD / reset_client_optimizer=False): the "
                        "full-population state stack stays "
                        "device-resident across rounds, which the "
                        "per-host store cannot checkpoint-own; sampled "
                        "cohorts (participation_fraction < 1) carry "
                        "state through the owner exchange, or use "
                        "client_residency='resident'"
                    )
        if self.population.lower() not in POPULATION_MODES:
            raise ValueError(
                f"unknown population {self.population!r}; known: "
                + ", ".join(POPULATION_MODES)
            )
        if self.join_rate < 0.0:
            raise ValueError("join_rate must be >= 0")
        if not 0.0 <= self.depart_rate < 1.0:
            raise ValueError("depart_rate must be in [0, 1)")
        if not 0.0 <= self.drift_fraction <= 1.0:
            raise ValueError("drift_fraction must be in [0, 1]")
        if not 0.0 <= self.drift_factor <= 1.0:
            raise ValueError("drift_factor must be in [0, 1]")
        if self.population.lower() == "dynamic":
            self._validate_dynamic()
        if self.rounds_per_dispatch < 1:
            raise ValueError("rounds_per_dispatch must be >= 1")
        if (
            self.rounds_per_dispatch > 1
            and self.execution_mode.lower() == "threaded"
        ):
            # The threaded oracle sequences rounds on the host.
            raise ValueError(
                "rounds_per_dispatch > 1 requires the vmap execution mode "
                "(the threaded oracle dispatches per round)"
            )
        if self.telemetry_level.lower() not in TELEMETRY_LEVELS:
            raise ValueError(
                f"unknown telemetry_level {self.telemetry_level!r}; known: "
                + ", ".join(TELEMETRY_LEVELS)
            )
        if self.span_trace.lower() not in ("off", "on"):
            raise ValueError(
                f"unknown span_trace {self.span_trace!r}; known: off, on"
            )
        if self.span_buffer_size < 1:
            raise ValueError("span_buffer_size must be >= 1")
        if self.span_flush_last_k < 1:
            raise ValueError("span_flush_last_k must be >= 1")
        if self.client_stats.lower() not in CLIENT_STATS_LEVELS:
            raise ValueError(
                f"unknown client_stats {self.client_stats!r}; known: "
                + ", ".join(CLIENT_STATS_LEVELS)
            )
        if self.client_stats_every < 1:
            raise ValueError("client_stats_every must be >= 1")
        if self.client_stats_probe < 1:
            raise ValueError("client_stats_probe must be >= 1")
        if self.client_stats_mad_threshold <= 0.0:
            raise ValueError("client_stats_mad_threshold must be > 0")
        if self.client_valuation.lower() not in ("off", "on"):
            raise ValueError(
                f"unknown client_valuation {self.client_valuation!r}; "
                "known: off, on"
            )
        self._validate_valuation()
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
        if server_opt == "adam" and self.server_momentum:
            raise ValueError(
                "server_momentum is only used by the sgd server optimizer; "
                "adam ignores it — unset one of the two"
            )
        if self.device != "cpu" and not (
            self.device == "cuda"
            or (self.device.startswith("cuda:")
                and self.device[5:].isdigit())
        ):
            raise ValueError(
                f"unknown device {self.device!r}; known: cuda, cuda:N, cpu"
            )

    def _validate_valuation(self) -> None:
        """The JAX package's checks of the valuation fields: the scores
        come from the client-stats matrix, and the audit's replay must be
        the round's training."""
        if not 0.0 <= self.valuation_decay < 1.0:
            raise ValueError("valuation_decay must be in [0, 1)")
        if self.valuation_audit_every < 0:
            raise ValueError("valuation_audit_every must be >= 0")
        if self.valuation_audit_permutations < 1:
            raise ValueError("valuation_audit_permutations must be >= 1")
        if self.client_valuation.lower() == "on":
            if self.client_stats.lower() != "on":
                raise ValueError(
                    "client_valuation='on' requires client_stats='on' "
                    "(the streaming scores derive from the per-client "
                    "stats matrix)"
                )
            if self.execution_mode.lower() == "threaded":
                raise ValueError(
                    "client_valuation='on' requires the vmap execution "
                    "mode (the threaded oracle computes no in-round "
                    "score vector)"
                )
            if self.distributed_algorithm == "sign_SGD":
                raise ValueError(
                    "client_valuation='on' is not supported for sign_SGD "
                    "(no per-client update delta to score)"
                )
        if self.valuation_audit_every > 0:
            if self.client_valuation.lower() != "on":
                raise ValueError(
                    "valuation_audit_every > 0 requires "
                    "client_valuation='on' (there is no streaming vector "
                    "to audit)"
                )
            if self.distributed_algorithm != "fed":
                raise ValueError(
                    "valuation audits support distributed_algorithm="
                    f"'fed' only, not {self.distributed_algorithm!r} "
                    "(fed_quant's per-chunk upload-quantization keys "
                    "cannot be replayed exactly on a whole-stack audit; "
                    "the Shapley servers already compute exact SVs)"
                )
            if self.failure_mode != "none" and self.failure_prob > 0.0:
                raise ValueError(
                    "valuation audits refuse failure injection (the "
                    "cohort replay assumes honest uploads, the same "
                    "contract as Shapley scoring); set failure_mode="
                    "'none' or valuation_audit_every=0"
                )
            if self.async_mode.lower() == "on":
                raise ValueError(
                    "valuation audits refuse async_mode='on' (subset "
                    "utilities assume a synchronous cohort); set "
                    "valuation_audit_every=0"
                )
            if self.aggregation.lower() != "mean":
                raise ValueError(
                    "valuation audits assume the weighted-mean "
                    "aggregator (subset utilities are weighted means); "
                    "set aggregation='mean' or valuation_audit_every=0"
                )
            if not self.reset_client_optimizer:
                raise ValueError(
                    "valuation audits require reset_client_optimizer="
                    "True (the replay cannot reconstruct pre-round "
                    "persistent optimizer state)"
                )
            if self.rounds_per_dispatch > 1:
                raise ValueError(
                    "valuation audits require rounds_per_dispatch=1 "
                    "(the audit replays one round's key chain against "
                    "that round's pre-round global params)"
                )
            if self.multihost:
                raise ValueError(
                    "valuation audits do not compose with multihost: the "
                    "audit's cohort replay and GTG walk are driven by a "
                    "single host process; run audits on one host's mesh "
                    "(single-process mesh_devices sharding is supported)"
                )

    def _validate_dynamic(self) -> None:
        """population='dynamic': each composition it does not support is
        refused with its cause, the JAX package's texts."""
        if self.execution_mode.lower() == "threaded":
            raise ValueError(
                "population='dynamic' requires the vmap execution "
                "mode: the thread-per-client oracle spawns one OS "
                "thread per client at startup and cannot register "
                "or retire clients mid-run"
            )
        if self.distributed_algorithm not in ("fed", "fed_quant"):
            cause = (
                "its utility memo assumes a fixed cohort over a "
                "fixed population"
                if self.distributed_algorithm in SHAPLEY_ALGORITHMS
                else "its round program does not take the dynamic-"
                     "population departure operand (FedAvg family "
                     "only: fed, fed_quant)"
            )
            raise ValueError(
                f"algorithm {self.distributed_algorithm!r} does not "
                f"support population='dynamic': {cause}"
            )
        if self.client_residency.lower() != "streamed":
            raise ValueError(
                "population='dynamic' requires client_residency="
                "'streamed': the resident path bakes the population "
                "length into every device array shape, so each join "
                "round would recompile the round program; the "
                "streamed cohort pipeline is population-size-free "
                "(the host shard store grows by appending)"
            )
        if self.participation_sampler.lower() != "hashed":
            raise ValueError(
                "population='dynamic' requires participation_sampler"
                "='hashed': the exact sampler's O(N log N) "
                "permutation draw has no maskable stream; the hashed "
                "first-k-distinct stream masks departed indices "
                "exactly (ops/sampling.py)"
            )
        if self.participation_fraction >= 1.0:
            raise ValueError(
                "population='dynamic' requires participation_fraction"
                " < 1: the cohort is pinned at the startup "
                "population's sampled size so the compiled round "
                "program never changes shape while N grows; a "
                "full-participation cohort would have to grow with "
                "the population"
            )
        if self.rounds_per_dispatch > 1:
            raise ValueError(
                "population='dynamic' requires rounds_per_dispatch=1:"
                " registration events (joins/departures/drift) apply "
                "at host round boundaries, which a fused K-round "
                "scan dispatch does not expose"
            )
        if self.multihost:
            raise ValueError(
                "population='dynamic' does not compose with "
                "multihost: joins grow the store and would "
                "re-partition the distributed shard store's "
                "ownership bounds mid-run; run dynamic populations "
                "on one host's mesh"
            )
        if self.async_mode.lower() == "on":
            raise ValueError(
                "population='dynamic' does not compose with "
                "async_mode='on': the persistent per-client arrival "
                "speed table is built into the round program at "
                "trace time for the startup population — a joined "
                "client has no speed row; set async_mode='off'"
            )
        if self.valuation_audit_every > 0:
            raise ValueError(
                "population='dynamic' does not compose with "
                "valuation audits: the auditor replays cohorts from "
                "a startup snapshot of the packed shards, which "
                "churn (joins and drifting labels) invalidates; set "
                "valuation_audit_every=0 (the streaming valuation "
                "itself composes — its vector grows with the "
                "population)"
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
