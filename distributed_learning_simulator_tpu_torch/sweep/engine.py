"""Sweep execution engine: experiment fleets + a warm-program scheduler
(sweep/engine.py of the JAX package).

Two execution strategies behind the :class:`~.spec.SweepSpec` front door
(strategy selection + refusals live there):

* **fleet** (``vmapped``) — points that agree on every program-defining
  knob except the fleet axes (seed, learning_rate) train together. The
  JAX package vmaps its whole round over an experiment axis so that one
  XLA compile serves E experiments; the port compiles nothing, and its
  round plans on the host, so the fleet's value is that E experiments
  share each batched forward and backward: the experiment axis is folded
  into the chunk's model axis (``parallel/engine.make_experiment_round_
  fn`` over ``FedAvg.make_fleet_round_fn``). Per-point model inits and key
  chains stay per experiment, per-point learning rates become a length-E
  f32 factor vector, and point ``i``'s metric history is its solo
  ``run_simulation`` with that seed on the shared data, bitwise: a
  client's training has the same bits however many models share its
  program, and each experiment's global model is evaluated as its solo
  run evaluates it (``parallel/engine.make_experiment_eval_fn``; one
  vmapped forward of the E models takes other kernels than one model's)
  (tests/test_torch_sweep.py; on the card chip_smoke.py ``sweep_fleet``
  in f32 and bf16). A fleet round makes as many training forwards as one
  solo round, and E eval forwards per eval batch. With ``mesh_devices >
  1`` the experiment axis is packed over the mesh (parallel/mesh.py):
  each device owns E/n whole experiments and trains them as a fleet of its
  own, on its copy of the shared data (the spec refuses an E that is not a
  multiple of n).

* **scheduled** — heterogeneous points group by
  ``utils/reporting.config_hash`` and each group runs sequentially
  through one warm program (:class:`_Program`: the model, its layout, the
  algorithm's round function and the eval, built once). Programs are
  cached under a SEED-NORMALIZED program key: the seed is a pure operand
  (model init + the key chain), so seed-varied groups share one program
  even though their config hashes differ — per-point ``compile_reused``
  records exactly which points rode a warm program. Points whose features
  the lean warm-program loop does not cover (streamed/async/telemetry/
  ...) fall back to a full ``run_simulation`` with
  ``compile_reused=False`` — recorded, never silent.

Sweep-level checkpoint/resume: with ``sweep_dir`` set, every completed
point persists its result (``point_NNNN.json``) and its per-round records
append to the sweep's ``metrics.jsonl`` (schema v8 ``sweep`` sub-object
through ``build_round_record``, utils/reporting.py). A killed sweep resumes
with ``sweep_resume=True``: persisted points load, only the remainder
executes — and because points are independent (per-experiment key
chains), the stitched results equal the uninterrupted sweep's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.algorithms.base import (
    RoundContext,
)
from distributed_learning_simulator_tpu_torch.config import (
    SHAPLEY_ALGORITHMS,
)
from distributed_learning_simulator_tpu_torch.data.registry import get_dataset
from distributed_learning_simulator_tpu_torch.factory import get_algorithm
from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_leaf_order,
)
from distributed_learning_simulator_tpu_torch.models.registry import (
    ParamLayout,
    get_model,
    init_params,
)
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    make_decoder,
    make_eval_fn,
    make_experiment_eval_fn,
    make_experiment_round_fn,
    make_optimizer,
    pad_eval_set,
)
from distributed_learning_simulator_tpu_torch.parallel.mesh import make_mesh
from distributed_learning_simulator_tpu_torch.sweep.spec import SweepSpec
from distributed_learning_simulator_tpu_torch.utils.logging import (
    get_logger,
    set_level,
)
from distributed_learning_simulator_tpu_torch.utils.reporting import (
    build_round_record,
    config_hash,
)

#: Chaos hook (the robustness/chaos.py idiom): when set to integer k,
#: run_sweep raises after k newly-executed points have been persisted —
#: the harness tests/test_torch_sweep.py uses to show that sweep-level
#: resume stitches bitwise. Inert in production.
_CRASH_ENV = "DLS_SWEEP_CRASH_AFTER"

#: Axis name of the experiment mesh (the fleet packed over a mesh).
EXPERIMENT_AXIS = "experiments"

#: The round's aux values a record reads.
_TEL_KEYS = ("survivor_count", "round_rejected", "participants")


def _seed_key(seed: int):
    """The solo round loop's key root for ``config.seed`` — one definition
    shared by the fleet's per-experiment key chains and the lean scheduler
    loop, so every strategy replays ``run_simulation``'s
    ``prng.key(config.seed + 1)`` exactly."""
    return prng.key(seed + 1)


def _sweep_record(point, strategy: str, compile_reused: bool,
                  experiments: int | None = None) -> dict:
    """The schema-v8 ``sweep`` sub-object for one point's records."""
    rec = {
        "point": point.index,
        "seed": int(point.config.seed),
        "lr": float(point.config.learning_rate),
        "strategy": strategy,
        "group": config_hash(point.config),
        "compile_reused": bool(compile_reused),
    }
    if experiments is not None:
        rec["experiments"] = int(experiments)
    return rec


def _shared_data(base, dataset, client_data):
    """Resolve the sweep's ONE dataset + client partition (the base
    config's data seed — see sweep/spec.py's data contract)."""
    from distributed_learning_simulator_tpu_torch.simulator import (
        build_client_data,
    )

    if dataset is None:
        dataset = get_dataset(
            base.dataset_name, data_dir=base.data_dir, seed=base.seed,
            n_train=base.n_train, n_test=base.n_test, **base.dataset_args,
        )
    if client_data is None:
        client_data = build_client_data(base, dataset)
    return dataset, client_data


class _Program:
    """One round program + everything needed to run points through it:
    the warm unit the scheduler caches and the fleet builds once — the
    model, its flat layout, the algorithm with its round function and the
    server eval, set up as ``run_simulation`` sets them up. The device
    arrays are owned by the enclosing scheduler/fleet (shared across
    programs — one upload per sweep)."""

    def __init__(self, cfg, dataset, client_data, devices):
        from distributed_learning_simulator_tpu_torch.simulator import (
            _assert_client_stack_feasible,
            _assert_residency_feasible,
            _auto_chunk_size,
            resolve_device,
        )

        self.device = device = resolve_device(cfg.device)
        sample_shape = dataset.x_train.shape[1:]
        self.model = get_model(
            cfg.model_name, num_classes=dataset.num_classes,
            input_shape=sample_shape, **cfg.model_args,
        ).to(device)
        # The init's image size is kept so each point re-initializes with
        # ITS seed (flax's init replayed, models/flax_init.py).
        self.init_hw = sample_shape[:2]
        self.layout = ParamLayout.from_params(
            init_params(self.model, self.init_hw, seed=cfg.seed),
            jax_leaf_order(self.model, self.init_hw),
        )
        self.n_params = n_params = sum(self.layout.numels)
        self.n_clients = n_clients = client_data.n_clients
        if cfg.client_chunk_size == 0:  # auto, same resolution as solo
            cfg = dataclasses.replace(
                cfg,
                client_chunk_size=_auto_chunk_size(cfg, n_params, n_clients,
                                                   device),
            )
        self.cfg = cfg
        # The algorithm first, as in run_simulation (sign_SGD refuses a
        # non-SGD optimizer before the optimizer registry is asked).
        self.algorithm = get_algorithm(cfg.distributed_algorithm, cfg)
        self.optimizer = make_optimizer(
            cfg.optimizer_name, cfg.learning_rate,
            momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        )
        # Sized with the solo config, not E-scaled, as in the JAX package.
        _assert_residency_feasible(
            cfg, n_params, n_clients,
            client_data.x.nbytes + client_data.y.nbytes
            + client_data.mask.nbytes + client_data.sizes.nbytes, device,
        )
        if self.algorithm.materializes_client_stack:
            _assert_client_stack_feasible(cfg, n_params, n_clients, device)
        model = self.model

        def apply_fn(flat_views, x):
            return torch.func.functional_call(model, flat_views, (x,))

        self.apply_fn = apply_fn
        self.eval_fn = make_eval_fn(apply_fn)
        self.algorithm.prepare(apply_fn, self.eval_fn, devices[4])
        self.preprocess = (make_decoder(client_data.sample_shape)
                           if client_data.compact else None)
        self.client_sizes = client_data.sizes
        self.round_fn = self.algorithm.make_round_fn(
            apply_fn, self.optimizer, self.layout, n_clients,
            preprocess=self.preprocess, client_sizes=self.client_sizes,
            device=device,
        )
        self.server_init = self.server_update = None
        server = self.algorithm.make_server_update()
        if server is None and (
            cfg.server_optimizer_name.lower() not in ("none", "")
        ):
            raise ValueError(
                f"algorithm {cfg.distributed_algorithm!r} does not support "
                "a server optimizer; set server_optimizer_name='none'"
            )
        if server is not None:
            self.server_init, self.server_update = server
        self.devices = devices  # (cx, cy, cmask, sizes, eval_batches)

    def init_flat(self, seed: int) -> torch.Tensor:
        """The f32 global model a run with ``seed`` starts from."""
        params = init_params(self.model, self.init_hw, seed=seed)
        return self.layout.flatten(params).to(self.device)

    def fleet_round_fn(self, device=None):
        """The algorithm's fleet form of this program's round body, on
        ``device`` (the program's by default)."""
        return self.algorithm.make_fleet_round_fn(
            self.apply_fn, self.optimizer, self.layout, self.n_clients,
            preprocess=self.preprocess, client_sizes=self.client_sizes,
            device=self.device if device is None else device,
        )


def _device_arrays(cfg, dataset, client_data):
    """One upload of the shared data: packed client arrays + the padded
    eval set, reused by every program of the sweep. The client sizes stay
    on the host, as in ``run_simulation``."""
    from distributed_learning_simulator_tpu_torch.simulator import (
        resolve_device,
    )

    device = resolve_device(cfg.device)
    xb, yb, mb = pad_eval_set(dataset.x_test, dataset.y_test,
                              cfg.eval_batch_size)
    return (
        torch.as_tensor(client_data.x, device=device),
        torch.as_tensor(client_data.y, dtype=torch.int64, device=device),
        torch.as_tensor(client_data.mask, device=device),
        client_data.sizes,
        (torch.as_tensor(xb, device=device),
         torch.as_tensor(yb, dtype=torch.int64, device=device),
         torch.as_tensor(mb, device=device)),
    )


def lean_supported(cfg) -> bool:
    """Whether the scheduler's lean warm-program loop covers this config.

    The lean loop replays ``run_simulation``'s core round sequence for a
    resident, static, one-round-a-dispatch run (split -> round -> optional
    server step -> eval -> record), bitwise — but not the per-run
    machinery around it. Anything outside this envelope falls back to a
    full ``run_simulation`` with ``compile_reused=False`` (recorded, not
    silent). The port also sends a span-traced run there: its journal is
    per-run machinery the lean loop does not keep.
    """
    return (
        cfg.execution_mode.lower() == "vmap"
        and not cfg.multihost
        and (cfg.mesh_devices or 1) <= 1
        and cfg.client_residency.lower() == "resident"
        and getattr(cfg, "population", "static").lower() == "static"
        and cfg.rounds_per_dispatch == 1
        and cfg.async_mode.lower() == "off"
        and cfg.client_stats.lower() == "off"
        and cfg.client_valuation.lower() == "off"
        and cfg.telemetry_level.lower() == "off"
        and cfg.span_trace.lower() == "off"
        and not cfg.profile_dir
        and not cfg.cost_model_trace
        and not (cfg.checkpoint_dir and cfg.checkpoint_every)
        and not cfg.resume
        and cfg.distributed_algorithm not in SHAPLEY_ALGORITHMS
    )


def _emit_base_record(cfg, round_idx, metrics, mean_loss, fetched_tel,
                      extra, round_seconds) -> dict:
    """One round's v1-layout base record — delegated to the simulator's
    shared ``build_base_round_record`` (the ONE copy of the field set and
    insert order), so a sweep point's records can never drift from solo
    metrics.jsonl lines."""
    from distributed_learning_simulator_tpu_torch.simulator import (
        build_base_round_record,
    )

    return build_base_round_record(
        cfg, round_idx, metrics, mean_loss, fetched_tel, extra,
        round_seconds=round_seconds,
    )


def _warmup_seconds(times: list[float]) -> float:
    """Explicit warmup accounting shared by every strategy's point
    summary: round 0's wall minus a steady round (in the port: the first
    calls, the kernels' first launches and the allocator's growth)."""
    if not times:
        return 0.0
    steady = times[1:]
    return round(
        max(times[0] - (float(np.median(steady)) if steady else 0.0), 0.0),
        4,
    )


class SweepScheduler:
    """The program-cache-aware point runner (scheduled strategy).

    Programs are cached under a seed-normalized program key — the seed is
    a pure operand (model init + key chain), so seed-varied config hashes
    share one program. Reusable OUTSIDE run_sweep too: repeated runs of
    one configuration route through one scheduler so that the set-up is
    paid once and the warm-up is recorded per point.
    """

    def __init__(self):
        self._programs: dict[str, _Program] = {}
        self._data_key = None
        self._devices = None
        # Live references to the dataset/client_data the cache was built
        # from: keeps the id()-based key honest (a collected object's id
        # can be recycled) and lets run() detect a data swap.
        self._data_ref = None
        self.points_run = 0
        self.programs_compiled = 0
        self.fallback_points = 0

    def program_key(self, cfg) -> str:
        """Seed-normalized program identity: every knob that defines the
        program, with the seed (a pure operand) pinned. The learning rate
        stays IN the key — the lean loop bakes it into the optimizer
        exactly like a solo run, so lr-varied points build their own
        programs (the fleet is the strategy that makes lr an operand)."""
        return config_hash(dataclasses.replace(cfg, seed=0))

    def _data(self, cfg, dataset, client_data):
        """Device arrays for the shared data — uploaded once. Swapping to
        DIFFERENT data invalidates every cached program (their round
        functions captured the old client sizes): the cache must never
        serve a warm program against data it was not built from."""
        key = (id(dataset), id(client_data), cfg.eval_batch_size,
               cfg.device)
        if self._data_key != key:
            if self._data_key is not None:
                self._programs.clear()
            self._devices = _device_arrays(cfg, dataset, client_data)
            self._data_key = key
            self._data_ref = (dataset, client_data)
        return self._devices

    def run(self, cfg, dataset=None, client_data=None):
        """Run one point; returns a result dict (history/final_accuracy/
        total_seconds/rounds_rejected/... — the run_simulation subset
        sweep consumers read) plus ``compile_reused`` and
        ``warmup_seconds``."""
        from distributed_learning_simulator_tpu_torch.simulator import (
            run_simulation,
        )

        cfg.validate()
        dataset, client_data = _shared_data(cfg, dataset, client_data)
        self.points_run += 1
        if not lean_supported(cfg):
            t0 = time.perf_counter()
            result = run_simulation(
                cfg, dataset=dataset, client_data=client_data,
                setup_logging=False,
            )
            self.fallback_points += 1
            result["compile_reused"] = False
            result["warmup_seconds"] = _warmup_seconds(
                [h["round_seconds"] for h in result["history"]]
            )
            result["total_seconds"] = time.perf_counter() - t0
            return result
        # Data first: a swapped dataset/client_data clears the program
        # cache (stale closures) BEFORE any cache lookup.
        devices = self._data(cfg, dataset, client_data)
        key = self.program_key(cfg)
        prog = self._programs.get(key)
        reused = prog is not None
        if prog is None:
            prog = _Program(cfg, dataset, client_data, devices)
            self._programs[key] = prog
            self.programs_compiled += 1
        result = _run_point_lean(prog, cfg)
        result["compile_reused"] = reused
        return result


def _run_point_lean(prog: _Program, cfg) -> dict:
    """The warm-program point loop: ``run_simulation``'s K=1 round
    sequence for a resident static run (``key, round_key = split(key)`` ->
    the round -> optional server step -> eval -> fetch -> post_round ->
    record), each dispatch inside ``_oom_hint`` as there, with the solo
    loop's pipelined rounds where nothing needs same-round host state (the
    algorithm allows it and no client or server state is carried): round
    r is finalized after round r+1 is dispatched. Its history is the solo
    run's bitwise. Everything outside this envelope is gated out by
    ``lean_supported``."""
    from distributed_learning_simulator_tpu_torch.simulator import (
        _oom_hint,
        finish_fetch,
        lr_factors,
        start_fetch,
    )

    if cfg.client_chunk_size == 0:
        # Adopt the program's auto-resolved chunk only — the point keeps
        # its OWN horizon/seed/schedule knobs.
        cfg = dataclasses.replace(
            cfg, client_chunk_size=prog.cfg.client_chunk_size
        )
    algorithm = prog.algorithm
    layout = prog.layout
    device = prog.device
    cx, cy, cmask, sizes, eval_batches = prog.devices
    n_params, n_clients = prog.n_params, prog.n_clients
    global_flat = prog.init_flat(cfg.seed)
    client_state = algorithm.init_client_state(
        prog.optimizer, global_flat, n_clients
    )
    server_state = (
        prog.server_init(global_flat)
        if prog.server_init is not None else None
    )
    key = _seed_key(cfg.seed)
    history: list[dict] = []
    telemetry = {"rounds_rejected": 0, "survivor_counts": []}
    prev_metrics = None
    # The JAX package's condition (its sweep engine's lean loop).
    pipelined = (cfg.pipeline_rounds and algorithm.supports_round_pipelining
                 and client_state is None and server_state is None)
    t_start = time.perf_counter()
    t_prev_done = t_start

    def start(aux, metrics_dev):
        """The round's one metric fetch, started (simulator.start_fetch)."""
        return start_fetch({
            "metrics": metrics_dev,
            "mean_client_loss": aux["mean_client_loss"],
            "tel": {k: aux[k] for k in _TEL_KEYS if k in aux},
        })

    def finalize(p):
        nonlocal prev_metrics, t_prev_done
        aux = p["aux"]
        with _oom_hint(cfg, n_params, n_clients, device,
                       site="deferred metric fetch"):
            fetched = finish_fetch(p["fetch"])
        metrics = {k: float(v) for k, v in fetched["metrics"].items()}
        ctx = RoundContext(
            round_idx=p["round"], global_params=p["new_global"],
            prev_global_params=p["prev_global"], sizes=sizes, aux=aux,
            metrics=metrics, prev_metrics=prev_metrics,
            eval_batches=eval_batches, log_dir=None, layout=layout,
        )
        extra = algorithm.post_round(ctx) or {}
        now = time.perf_counter()
        record = _emit_base_record(
            cfg, p["round"], metrics, float(fetched["mean_client_loss"]),
            fetched["tel"], extra, now - t_prev_done,
        )
        t_prev_done = now
        if record.get("round_rejected"):
            telemetry["rounds_rejected"] += 1
        if "survivor_count" in record:
            telemetry["survivor_counts"].append(record["survivor_count"])
        history.append(record)
        prev_metrics = metrics

    pending = None
    try:
        for round_idx in range(cfg.round):
            lr_scale = float(lr_factors(cfg, round_idx, 1)[0])
            key, round_key = prng.split(key)
            with _oom_hint(cfg, n_params, n_clients, device):
                new_global, client_state, aux = prog.round_fn(
                    global_flat, client_state, cx, cy, cmask, sizes,
                    round_key, lr_scale=lr_scale,
                )
                if prog.server_update is not None:
                    new_global, server_state = prog.server_update(
                        global_flat, new_global, server_state,
                        aux.get("round_rejected"))
            with _oom_hint(cfg, n_params, n_clients, device, site="eval"):
                metrics_dev = prog.eval_fn(layout.unflatten(new_global),
                                           *eval_batches)
            # The copies go behind this round's work now.
            with _oom_hint(cfg, n_params, n_clients, device,
                           site="deferred metric fetch"):
                fetch = start(aux, metrics_dev)
            entry = {"round": round_idx, "aux": aux, "fetch": fetch,
                     "new_global": new_global, "prev_global": global_flat}
            global_flat = new_global
            if pipelined:
                prev_pending, pending = pending, entry
                if prev_pending is not None:
                    finalize(prev_pending)
            else:
                finalize(entry)
    finally:
        if pending is not None:
            finalize(pending)
    total = time.perf_counter() - t_start
    return {
        "history": history,
        "final_accuracy": history[-1]["test_accuracy"] if history else None,
        "total_seconds": total,
        "client_rounds_per_sec": (
            len(history) * n_clients / max(total, 1e-9)
        ),
        "rounds_rejected": telemetry["rounds_rejected"],
        "mean_survivor_count": (
            float(np.mean(telemetry["survivor_counts"]))
            if telemetry["survivor_counts"] else None
        ),
        "warmup_seconds": _warmup_seconds(
            [h["round_seconds"] for h in history]
        ),
        "client_chunk_size": cfg.client_chunk_size,
    }


def _on(value, device):
    """``value`` on ``device`` if it is a tensor."""
    return value.to(device) if isinstance(value, torch.Tensor) else value


def _run_fleet(spec: SweepSpec, points, dataset, client_data,
               logger) -> list[dict]:
    """The seed/lr fleet: E experiments trained together, every chunk
    position one program of E x chunk models (see module docstring).
    Returns per-point result dicts.

    ``points`` may be a subset of the spec's points (sweep resume reruns
    only the missing ones), but the program reference config — and the
    lr-factor base — is ALWAYS the spec's first point, so a resumed
    fleet's operands (hence its histories) are those of the uninterrupted
    run.
    """
    from distributed_learning_simulator_tpu_torch.simulator import (
        _oom_hint,
        fetch_to_host,
        lr_factors,
    )

    fcfg = spec.points[0].config
    n_exp = len(points)
    devices = _device_arrays(fcfg, dataset, client_data)
    cx, cy, cmask, sizes, eval_batches = devices
    prog = _Program(fcfg, dataset, client_data, devices)
    cfg = prog.cfg  # auto chunk resolved
    params_e = torch.stack([prog.init_flat(p.config.seed) for p in points])
    keys_e = [_seed_key(p.config.seed) for p in points]
    # Per-point lr factors against the program's base lr: exact 1.0 for a
    # pure seed fleet, so a factor row's multiply is exact there; an
    # lr-varied point's factor multiplies the update as config.lr_schedule's
    # factor does.
    lr_mults = np.asarray(
        [p.config.learning_rate / fcfg.learning_rate for p in points],
        dtype=np.float32,
    )
    lr_schedule_active = cfg.lr_schedule.lower() != "constant"
    lr_active = lr_schedule_active or bool(np.any(lr_mults != 1.0))
    fleet_eval = make_experiment_eval_fn(prog.eval_fn, prog.layout)
    # The experiment-axis mesh: group g of experiments on its device, with
    # the shared data there and a round function built for it (one group
    # on the program's device without a mesh).
    groups = [(prog.device, 0, n_exp)]
    if cfg.mesh_devices and cfg.mesh_devices > 1:
        mesh = make_mesh(cfg.mesh_devices, axis_name=EXPERIMENT_AXIS,
                         device=prog.device)
        bounds = (n_exp * np.arange(mesh.size + 1)) // mesh.size
        groups = [(mesh.devices[g], int(bounds[g]), int(bounds[g + 1]))
                  for g in range(mesh.size)]
        logger.info(
            "sweep fleet: %d experiments packed over %d mesh devices",
            n_exp, mesh.size,
        )
    round_fns, data_on = {}, {}
    for dev, _, _ in groups:
        if dev not in round_fns:
            round_fns[dev] = make_experiment_round_fn(
                prog.fleet_round_fn(dev), lr_active)
            data_on[dev] = (
                tuple(t.to(dev) for t in (cx, cy, cmask)),
                tuple(t.to(dev) for t in eval_batches))
    logger.info(
        "sweep fleet: %d experiments, %d x %d models per chunk program",
        n_exp, groups[0][2] - groups[0][1],
        cfg.client_chunk_size or cfg.cohort_size(prog.n_clients),
    )
    histories: list[list[dict]] = [[] for _ in points]
    telemetry = [
        {"rounds_rejected": 0, "survivor_counts": []} for _ in points
    ]
    t_start = time.perf_counter()
    t_prev = t_start
    for round_idx in range(cfg.round):
        lr_args = ()
        if lr_active:
            factor = lr_factors(cfg, round_idx, 1)[0]
            lr_args = (lr_mults * np.float32(factor),)
        new_params, new_keys, auxes, metric_parts = [], [], [], []
        for dev, lo, hi in groups:
            (gx, gy, gm), g_eval = data_on[dev]
            with _oom_hint(cfg, prog.n_params, prog.n_clients, dev):
                p_g, k_g, a_g = round_fns[dev](
                    params_e[lo:hi].to(dev), keys_e[lo:hi], gx, gy, gm,
                    sizes, *(lr[lo:hi] for lr in lr_args))
            with _oom_hint(cfg, prog.n_params, prog.n_clients, dev,
                           site="eval"):
                metric_parts.append(fleet_eval(p_g, *g_eval))
            new_params.append(p_g.to(prog.device))
            new_keys += k_g
            auxes += a_g
        keys_e = new_keys
        if len(groups) == 1:  # no mesh: nothing to join
            params_e, metrics_dev = new_params[0], metric_parts[0]
        else:
            params_e = torch.cat(new_params)
            metrics_dev = {k: torch.cat([m[k].to(prog.device)
                                         for m in metric_parts])
                           for k in metric_parts[0]}
        with _oom_hint(cfg, prog.n_params, prog.n_clients, prog.device,
                       site="deferred metric fetch"):
            # Every tensor on the program's device: under a mesh each
            # group's aux stays on its own, and one fetch copies one
            # device's values.
            fetched = fetch_to_host({
                "metrics": metrics_dev,
                "aux": {str(e): {k: _on(aux[k], prog.device) for k in
                                 ("mean_client_loss",) + _TEL_KEYS
                                 if k in aux}
                        for e, aux in enumerate(auxes)},
            })
        now = time.perf_counter()
        wall = now - t_prev
        t_prev = now
        for e, point in enumerate(points):
            metrics = {
                k: float(v[e]) for k, v in fetched["metrics"].items()
            }
            tel_row = dict(fetched["aux"][str(e)])
            mean_loss = tel_row.pop("mean_client_loss")
            record = _emit_base_record(
                point.config, round_idx, metrics, mean_loss, tel_row, {},
                # One round trains all E experiments: the per-experiment
                # wall is the amortized share — what the
                # sweep_amortization_ratio measures.
                wall / n_exp,
            )
            if record.get("round_rejected"):
                telemetry[e]["rounds_rejected"] += 1
            if "survivor_count" in record:
                telemetry[e]["survivor_counts"].append(
                    record["survivor_count"]
                )
            histories[e].append(record)
    total = time.perf_counter() - t_start
    results = []
    for e, point in enumerate(points):
        results.append({
            "history": histories[e],
            "final_accuracy": (
                histories[e][-1]["test_accuracy"] if histories[e] else None
            ),
            "total_seconds": total / n_exp,
            "rounds_rejected": telemetry[e]["rounds_rejected"],
            "mean_survivor_count": (
                float(np.mean(telemetry[e]["survivor_counts"]))
                if telemetry[e]["survivor_counts"] else None
            ),
            # The fleet sets up once; the set-up is attributed to point 0
            # so mean(compile_reused) = 1 - programs/points — the same
            # accounting as the scheduler.
            "compile_reused": e > 0,
            "warmup_seconds": _warmup_seconds(
                [h["round_seconds"] for h in histories[e]]
            ),
            "client_chunk_size": cfg.client_chunk_size,
            "global_params": prog.layout.unflatten(params_e[e]),
        })
    return results


def _point_path(sweep_dir: str, index: int) -> str:
    return os.path.join(sweep_dir, f"point_{index:04d}.json")


def _persist_point(sweep_dir, point, summary, records) -> None:
    os.makedirs(sweep_dir, exist_ok=True)
    with open(_point_path(sweep_dir, point.index), "w") as f:
        json.dump(summary, f)
    with open(os.path.join(sweep_dir, "metrics.jsonl"), "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def _load_point(sweep_dir, point) -> dict | None:
    """A previously persisted result for this point, or None. The stored
    config_hash must match — a resumed sweep whose points changed must
    re-run them, never stitch foreign histories."""
    path = _point_path(sweep_dir, point.index)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            saved = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if saved.get("config_hash") != config_hash(point.config) or (
        saved.get("rounds") != point.config.round
    ):
        return None
    return saved


def run_sweep(spec_or_config, dataset=None, client_data=None) -> dict:
    """Run a multi-experiment sweep; returns the sweep result dict.

    Accepts a validated :class:`SweepSpec` or an ``ExperimentConfig``
    whose sweep knobs are set (``SweepSpec.from_config``). ``dataset`` /
    ``client_data`` are the same injection points as ``run_simulation``
    — the whole sweep shares them (the base config's data).
    """
    spec = (
        spec_or_config if isinstance(spec_or_config, SweepSpec)
        else SweepSpec.from_config(spec_or_config)
    )
    spec.validate()
    logger = get_logger()
    strategy = spec.resolve_strategy()
    base = spec.base
    set_level(base.log_level)
    dataset, client_data = _shared_data(base, dataset, client_data)
    crash_after = os.environ.get(_CRASH_ENV)
    crash_after = int(crash_after) if crash_after else None
    results: dict[int, dict] = {}
    resumed: set[int] = set()
    if spec.sweep_dir and spec.resume:
        for point in spec.points:
            saved = _load_point(spec.sweep_dir, point)
            if saved is not None:
                results[point.index] = saved
                resumed.add(point.index)
        if resumed:
            logger.info(
                "sweep resume: %d/%d point(s) loaded from %s",
                len(resumed), len(spec.points), spec.sweep_dir,
            )
    if spec.sweep_dir and not spec.resume:
        # Fresh sweep into an existing dir: clear the previous sweep's
        # artifacts so records never interleave two sweeps (point files
        # would be overwritten anyway; metrics.jsonl appends).
        stale = os.path.join(spec.sweep_dir, "metrics.jsonl")
        if os.path.exists(stale):
            os.remove(stale)
        for p in spec.points:
            path = _point_path(spec.sweep_dir, p.index)
            if os.path.exists(path):
                os.remove(path)
    todo = [p for p in spec.points if p.index not in resumed]
    executed = 0
    t_start = time.perf_counter()

    def record_point(point, run_result, strategy_name):
        nonlocal executed
        sweep_rec = _sweep_record(
            point, strategy_name, run_result.get("compile_reused", False),
            # The EXECUTED fleet's width (a resumed fleet re-runs only
            # the missing points).
            experiments=(
                len(todo) if strategy_name == "vmapped" else None
            ),
        )
        records = [
            build_round_record(dict(h), sweep=sweep_rec)
            for h in run_result["history"]
        ]
        summary = {
            "index": point.index,
            "seed": int(point.config.seed),
            "learning_rate": float(point.config.learning_rate),
            "overrides": point.overrides,
            "config_hash": config_hash(point.config),
            "rounds": point.config.round,
            "strategy": strategy_name,
            "compile_reused": bool(run_result.get("compile_reused", False)),
            "warmup_seconds": run_result.get("warmup_seconds"),
            "final_accuracy": run_result.get("final_accuracy"),
            "total_seconds": round(run_result.get("total_seconds", 0.0), 4),
            "rounds_rejected": run_result.get("rounds_rejected", 0),
            "history": run_result["history"],
        }
        results[point.index] = summary
        if spec.sweep_dir:
            _persist_point(spec.sweep_dir, point, summary, records)
        executed += 1
        if crash_after is not None and executed >= crash_after:
            raise RuntimeError(
                f"sweep chaos crash after {executed} point(s) "
                f"({_CRASH_ENV})"
            )

    if strategy == "vmapped":
        # (A fully-resumed fleet has nothing to run — the strategy label
        # stays 'vmapped', matching the persisted per-point records.)
        if todo:
            fleet_results = _run_fleet(
                spec, todo, dataset, client_data, logger
            )
            for point, rr in zip(todo, fleet_results):
                record_point(point, rr, "vmapped")
        programs_compiled = 1 if todo else 0
    else:
        scheduler = SweepScheduler()
        # config_hash grouping: points of one hash run consecutively so
        # each group streams through its (seed-normalized) warm program.
        groups: dict[str, list] = {}
        for p in todo:
            groups.setdefault(config_hash(p.config), []).append(p)
        for group_points in groups.values():
            for point in group_points:
                rr = scheduler.run(
                    point.config, dataset=dataset, client_data=client_data
                )
                record_point(point, rr, "scheduled")
        programs_compiled = (
            scheduler.programs_compiled + scheduler.fallback_points
        )
    total = time.perf_counter() - t_start
    ordered = [results[p.index] for p in spec.points]
    n_exec = len(todo)
    reuse = (
        sum(1 for p in spec.points
            if p.index not in resumed and results[p.index]["compile_reused"])
        / n_exec if n_exec else None
    )
    finals = [
        (r["final_accuracy"], -r["index"]) for r in ordered
        if r["final_accuracy"] is not None
    ]
    winner = None
    if finals:
        best = max(finals)
        winner_idx = -best[1]
        winner = {
            "point": winner_idx,
            "seed": ordered[winner_idx]["seed"],
            "learning_rate": ordered[winner_idx]["learning_rate"],
            "final_accuracy": best[0],
        }
    out = {
        "strategy": strategy,
        "points": [
            {**r, "resumed": r["index"] in resumed} for r in ordered
        ],
        "n_points": len(spec.points),
        "executed_points": n_exec,
        "resumed_points": len(resumed),
        "programs_compiled": programs_compiled if n_exec else 0,
        "compile_reuse_fraction": reuse,
        "winner": winner,
        "total_seconds": total,
        "experiments_per_hour": (
            n_exec / total * 3600.0 if n_exec and total > 0 else None
        ),
        "sweep_dir": spec.sweep_dir,
    }
    # $/sweep (telemetry/costmodel.py): price the round program once,
    # multiply by the sweep's round occupancy per topology. Attached when
    # the base config names a trace of the (shared) program.
    if base.cost_model_trace:
        from distributed_learning_simulator_tpu_torch.telemetry.costmodel import (  # noqa: E501
            ledger_totals,
            sweep_cost_record,
        )
        from distributed_learning_simulator_tpu_torch.utils.tracing import (
            categorize_ops,
        )

        ledger = categorize_ops(base.cost_model_trace)
        if ledger and ledger_totals(ledger)["bytes_gb"] > 0:
            out["costmodel_sweep"] = sweep_cost_record(
                ledger,
                trace_rounds=base.cost_model_trace_rounds,
                points=len(spec.points),
                rounds_total=sum(r["rounds"] for r in ordered),
                programs_compiled=out["programs_compiled"],
                # Program bookkeeping over the points THIS run executed
                # (a partial resume built programs only for them) — keeps
                # the cost record's reuse fraction equal to the result
                # dict's.
                executed_points=n_exec,
                anchor=base.cost_model_topology,
            )
        else:
            logger.warning(
                "cost_model_trace %r holds no byte-annotated device-op "
                "events; $/sweep pricing disabled", base.cost_model_trace,
            )
            out["costmodel_sweep"] = None
    logger.info(
        "sweep finished: %d point(s) (%d resumed), strategy=%s, "
        "programs_compiled=%s, compile_reuse=%.2f, %.2fs",
        len(spec.points), len(resumed), strategy,
        out["programs_compiled"],
        reuse if reuse is not None else float("nan"), total,
    )
    return out
