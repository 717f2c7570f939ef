"""The port's sweep engine (sweep/) against its own solo runs and against
the JAX package's sweep engine, on the CPU.

* ``SweepSpec``: the grid, ``active``, every refusal's type and text
  (``sweep_resume`` without ``sweep_dir`` included), ``fleet_compatible``'s
  reasons and ``resolve_strategy`` equal the JAX package's.
* The MLP seed fleet (JAX ``tests/test_sweep.py``'s base: 8 clients, 3
  rounds, 50% participation) is each point's solo ``run_simulation`` on the
  shared data, bitwise on ``test_accuracy``, ``test_loss``,
  ``mean_client_loss`` and ``cohort_hash``; its v8 records validate and
  ``scripts/report_run.py`` reads them; it agrees with JAX's ``run_sweep``
  on the same spec (``cohort_hash`` exact, metrics at rtol 1e-4, the same
  result-dict keys).
* Point independence, the lr axis, a failure-model fleet, the scheduled
  2-hash sweep, resume after a chaos crash, the scheduler outside a sweep,
  ``sweep_cost_record``.
* ``torch_runs.BASE``'s tiny ResNet as a 2-seed f32 fleet against its solo
  runs, at the tolerances of a changed chunk size
  (tests/test_torch_batched_rounds.py): test losses at rtol 1e-4, the
  global model at rtol 1e-4 / atol 1e-5. A fleet round trains with one
  solo round's training forwards (E experiments' chunk j is one forward)
  and evaluates its E models in one forward per eval batch.

Every test runs with functorch's per-example fallback disabled
(``engine.no_vmap_fallback``).
"""

import contextlib
import dataclasses
import importlib.util
import json
import os

import jsonschema
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.sweep import run_sweep as jax_sweep
from distributed_learning_simulator_tpu.sweep import spec as jspec
from distributed_learning_simulator_tpu.telemetry import (
    costmodel as jcost,
)
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.data.registry import get_dataset
from distributed_learning_simulator_tpu_torch.models.resnet import ResNet18
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    no_vmap_fallback,
)
from distributed_learning_simulator_tpu_torch.simulator import (
    build_client_data,
    run_simulation,
)
from distributed_learning_simulator_tpu_torch.sweep import (
    SweepScheduler,
    SweepSpec,
    engine,
    run_sweep,
)
from distributed_learning_simulator_tpu_torch.sweep import spec as pspec
from distributed_learning_simulator_tpu_torch.telemetry import costmodel
from distributed_learning_simulator_tpu_torch.utils.logging import get_logger
from distributed_learning_simulator_tpu_torch.utils.reporting import (
    config_hash,
)
from test_torch_costmodel import LEDGER, _tables
from torch_runs import BASE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = os.path.join(REPO, "tests", "data", "metrics_record.schema.json")
#: The fields the fleet's bitwise contract covers (round_seconds is wall
#: clock; cohort_hash pins the sampled cohort stream).
KEYS = ("test_accuracy", "test_loss", "mean_client_loss", "cohort_hash")
MLP = dict(
    dataset_name="synthetic", model_name="mlp", distributed_algorithm="fed",
    worker_number=8, round=3, epoch=1, learning_rate=0.1, batch_size=16,
    n_train=256, n_test=128, log_level="WARNING",
    dataset_args={"difficulty": 0.5}, participation_fraction=0.5,
    compilation_cache_dir=None,
)


@pytest.fixture(autouse=True)
def _strict_vmap():
    with no_vmap_fallback():
        yield


def _port(**changes) -> ExperimentConfig:
    return ExperimentConfig(device="cpu", **dict(MLP, **changes))


def _jax(**changes) -> JaxConfig:
    return JaxConfig(**dict(MLP, **changes))


@pytest.fixture(scope="module")
def shared():
    base = _port()
    ds = get_dataset("synthetic", n_train=256, n_test=128, seed=base.seed,
                     difficulty=0.5)
    return base, ds, build_client_data(base, ds)


def _solo(shared, **changes):
    base, ds, cd = shared
    return run_simulation(dataclasses.replace(base, **changes), dataset=ds,
                          client_data=cd, setup_logging=False)["history"]


def _assert_bitwise(a, b, context=""):
    assert len(a) == len(b), context
    for ra, rb in zip(a, b):
        for k in KEYS:
            assert ra.get(k) == rb.get(k), (context, k, ra, rb)


def _assert_close_to_jax(port_hist, jax_hist, context=""):
    assert len(port_hist) == len(jax_hist), context
    for rp, rj in zip(port_hist, jax_hist):
        assert rp.get("cohort_hash") == rj.get("cohort_hash"), context
        for k in ("test_accuracy", "test_loss", "mean_client_loss"):
            np.testing.assert_allclose(rp[k], rj[k], rtol=1e-4,
                                       err_msg=f"{context} {k}")


def _raised(fn):
    """The exception ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared by type and text
        return e
    return None


def _outcome(fn):
    """``fn()``'s value, or its exception's type name and text."""
    e = _raised(fn)
    return fn() if e is None else (type(e).__name__, str(e))


def _same_error(port_fn, jax_fn):
    pe, je = _raised(port_fn), _raised(jax_fn)
    assert je is not None, "the JAX package accepted it"
    assert type(pe) is type(je), (pe, je)
    assert str(pe) == str(je)


# --- the spec ---------------------------------------------------------------

@pytest.mark.parametrize("seeds,points", [
    ("0,1,2", None),
    (None, '[{"learning_rate": 0.1}, {"learning_rate": 0.05}]'),
    ("0,1", '[{"learning_rate": 0.1}, {"batch_size": 32}]'),
    ([3, 4], [{"momentum": 0.9}]),
])
def test_grid_and_active_match_jax(seeds, points):
    kw = dict(sweep_seeds=seeds, sweep_points=points)
    ps = pspec.SweepSpec.from_config(_port(**kw))
    js = jspec.SweepSpec.from_config(_jax(**kw))
    assert [p.overrides for p in ps.points] == [p.overrides
                                                for p in js.points]
    assert [(p.seed, p.learning_rate) for p in ps.points] == [
        (p.seed, p.learning_rate) for p in js.points]
    assert [config_hash(p.config) for p in ps.points] == [
        config_hash(dataclasses.replace(_port(), **p.overrides))
        for p in ps.points]
    assert pspec.SweepSpec.active(_port(**kw)) is True
    assert jspec.SweepSpec.active(_jax(**kw)) is True
    assert pspec.SweepSpec.active(_port()) is False


@pytest.mark.parametrize("case", [
    "resume_without_dir", "threaded", "shapley", "streamed_k2",
    "multihost", "no_sweep", "points_not_a_list", "points_not_json",
    "unknown_field", "duplicate", "unknown_strategy", "vmapped_refused",
    "invalid_point",
])
def test_refusals_match_jax(case):
    """Each refusal: the same exception type and text as the JAX
    package's (``sweep_resume`` without ``sweep_dir`` is the port's
    repaired fault: it validated before)."""
    sweep = dict(sweep_seeds="0,1")

    def config_case(changes):
        return (lambda: _port(**changes).validate(),
                lambda: _jax(**changes).validate())

    def spec_case(base_changes, points, **kw):
        return (lambda: SweepSpec(_port(**base_changes), points,
                                  **kw).validate(),
                lambda: jspec.SweepSpec(_jax(**base_changes), points,
                                        **kw).validate())

    def from_config_case(changes):
        return (lambda: SweepSpec.from_config(_port(**changes)),
                lambda: jspec.SweepSpec.from_config(_jax(**changes)))

    cases = {
        "resume_without_dir": config_case(dict(sweep_resume=True)),
        "threaded": config_case(dict(sweep, execution_mode="threaded")),
        "shapley": config_case(dict(
            sweep, distributed_algorithm="GTG_shapley_value")),
        "streamed_k2": config_case(dict(
            sweep, client_residency="streamed", rounds_per_dispatch=2)),
        "multihost": config_case(dict(sweep, multihost=True)),
        "no_sweep": from_config_case({}),
        "points_not_a_list": from_config_case(
            dict(sweep_points='{"not": "a list"}')),
        "points_not_json": from_config_case(
            dict(sweep_points="learning_rate=0.1,0.2")),
        "unknown_field": spec_case({}, [{"seed": 0}, {"no_such_knob": 1}]),
        "duplicate": spec_case({}, [{"seed": 3}, {"seed": 3}]),
        "unknown_strategy": spec_case({}, [{"seed": 0}], strategy="fast"),
        "vmapped_refused": spec_case(dict(client_stats="on"),
                                     [{"seed": 0}, {"seed": 1}],
                                     strategy="vmapped"),
        "invalid_point": spec_case({}, [{"seed": 0},
                                        {"worker_number": 0}]),
    }
    _same_error(*cases[case])
    assert ExperimentConfig(sweep_resume=True, sweep_dir="d").validate()


@pytest.mark.parametrize("base_changes,points", [
    ({}, [{"seed": 0}, {"seed": 1, "learning_rate": 0.05}]),
    ({}, [{"seed": 0}, {"batch_size": 32}]),
    (dict(distributed_algorithm="fed_quant"), [{"seed": 0}, {"seed": 1}]),
    (dict(distributed_algorithm="sign_SGD"), [{"seed": 0}, {"seed": 1}]),
    (dict(reset_client_optimizer=False), [{"seed": 0}, {"seed": 1}]),
    (dict(client_eval=True), [{"seed": 0}, {"seed": 1}]),
    (dict(aggregation="median", participation_fraction=1.0),
     [{"seed": 0}, {"seed": 1}]),
    (dict(client_stats="on"), [{"seed": 0}, {"seed": 1}]),
    (dict(async_mode="on", arrival_model="bimodal"),
     [{"seed": 0}, {"seed": 1}]),
    (dict(population="dynamic", client_residency="streamed",
          participation_sampler="hashed"), [{"seed": 0}, {"seed": 1}]),
    (dict(client_residency="streamed"), [{"seed": 0}, {"seed": 1}]),
    (dict(rounds_per_dispatch=2), [{"seed": 0}, {"seed": 1}]),
    (dict(server_optimizer_name="sgd"), [{"seed": 0}, {"seed": 1}]),
    (dict(telemetry_level="basic"), [{"seed": 0}, {"seed": 1}]),
    (dict(checkpoint_dir="ckpt"), [{"seed": 0}, {"seed": 1}]),
    (dict(profile_dir="prof"), [{"seed": 0}, {"seed": 1}]),
    (dict(failure_mode="dropout", failure_prob=0.3, min_survivors=2),
     [{"seed": 0}, {"seed": 1}]),
    (dict(participation_fraction=1.0, bucket_client_work=True,
          client_chunk_size=3), [{"seed": 0}, {"seed": 1}]),
])
@pytest.mark.parametrize("strategy", ["auto", "scheduled"])
def test_fleet_compatible_and_strategy_match_jax(base_changes, points,
                                                 strategy):
    ps = SweepSpec(_port(**base_changes), points, strategy=strategy)
    js = jspec.SweepSpec(_jax(**base_changes), points, strategy=strategy)
    assert ps.fleet_compatible() == js.fleet_compatible()
    assert _outcome(ps.resolve_strategy) == _outcome(js.resolve_strategy)


# --- the MLP fleet ------------------------------------------------------------

@pytest.fixture(scope="module")
def seed_fleet(shared, tmp_path_factory):
    """The 3-seed fleet of JAX's acceptance test, into a sweep_dir."""
    base, ds, cd = shared
    sweep_dir = str(tmp_path_factory.mktemp("fleet"))
    spec = SweepSpec(base, [{"seed": s} for s in (0, 1, 2)],
                     strategy="vmapped", sweep_dir=sweep_dir)
    return run_sweep(spec, dataset=ds, client_data=cd), sweep_dir


def test_fleet_bitwise_to_solo_and_v8_records(shared, seed_fleet):
    out, sweep_dir = seed_fleet
    assert out["strategy"] == "vmapped"
    assert out["programs_compiled"] == 1
    assert out["compile_reuse_fraction"] == pytest.approx(2 / 3)
    assert [p["compile_reused"] for p in out["points"]] == [
        False, True, True]
    for p in out["points"]:
        _assert_bitwise(_solo(shared, seed=p["seed"]), p["history"],
                        f"seed {p['seed']}")
    finals = [p["final_accuracy"] for p in out["points"]]
    assert out["winner"]["final_accuracy"] == max(finals)
    assert out["winner"]["point"] == finals.index(max(finals))
    with open(SCHEMA) as f:
        schema = json.load(f)
    with open(os.path.join(sweep_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    assert len(records) == 3 * MLP["round"]
    for rec in records:
        assert rec["schema_version"] == 8
        assert rec["sweep"]["strategy"] == "vmapped"
        assert rec["sweep"]["experiments"] == 3
        jsonschema.validate(rec, schema)
    spec = importlib.util.spec_from_file_location(
        "report_run", os.path.join(REPO, "scripts", "report_run.py"))
    report_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report_run)
    summary = report_run.summarize_sweep(records)
    assert summary["n_points"] == 3
    assert summary["strategies"] == ["vmapped"]
    assert summary["compile_reuse_fraction"] == pytest.approx(2 / 3, 1e-3)
    assert summary["winner"]["point"] == out["winner"]["point"]


def test_fleet_matches_jax_run_sweep(seed_fleet):
    out, _ = seed_fleet
    ref = jax_sweep(jspec.SweepSpec(_jax(), [{"seed": s} for s in (0, 1, 2)],
                                    strategy="vmapped"))
    assert set(out) == set(ref)
    assert [set(p) for p in out["points"]] == [set(p)
                                               for p in ref["points"]]
    for key in ("strategy", "n_points", "executed_points",
                "resumed_points", "programs_compiled",
                "compile_reuse_fraction"):
        assert out[key] == ref[key], key
    for pp, pj in zip(out["points"], ref["points"]):
        assert pp["config_hash"] == config_hash(_port(seed=pj["seed"]))
        _assert_close_to_jax(pp["history"], pj["history"],
                             f"seed {pp['seed']}")


@pytest.mark.parametrize("mesh_devices,seeds", [(2, (0, 1)),
                                                 (2, (0, 1, 2, 3)),
                                                 (4, (0, 1, 2, 3))])
def test_fleet_mesh_packing(shared, mesh_devices, seeds):
    """The experiment-axis mesh (each device owns E/n whole experiments,
    the JAX package's tests/test_sweep.py ``test_fleet_mesh_packing``):
    every cohort stream exact against the solo runs, the metrics within
    rel 1e-5; and the JAX package's meshed fleet within its parity band."""
    base, ds, cd = shared
    meshed = dataclasses.replace(base, round=2, mesh_devices=mesh_devices)
    out = run_sweep(SweepSpec(meshed, [{"seed": s} for s in seeds],
                              strategy="vmapped"),
                    dataset=ds, client_data=cd)
    assert out["strategy"] == "vmapped"
    for p in out["points"]:
        solo = _solo(shared, seed=p["seed"], round=2)
        assert len(solo) == len(p["history"])
        for rs, rf in zip(solo, p["history"]):
            assert rs["cohort_hash"] == rf["cohort_hash"]
            for k in ("test_accuracy", "test_loss", "mean_client_loss"):
                assert rs[k] == pytest.approx(rf[k], rel=1e-5), (
                    p["seed"], k)
    if mesh_devices == 2 and len(seeds) == 2:
        ref = jax_sweep(jspec.SweepSpec(
            _jax(round=2, mesh_devices=2), [{"seed": s} for s in seeds],
            strategy="vmapped"))
        for pp, pj in zip(out["points"], ref["points"]):
            _assert_close_to_jax(pp["history"], pj["history"],
                                 f"meshed seed {pp['seed']}")


def test_fleet_point_independence(shared):
    """A point's history does not depend on who else is in the fleet —
    what sweep-level resume (running only the missing points) rests on."""
    base, ds, cd = shared
    small = dataclasses.replace(base, round=2)
    a = run_sweep(SweepSpec(small, [{"seed": 0}, {"seed": 1}],
                            strategy="vmapped"), dataset=ds, client_data=cd)
    b = run_sweep(SweepSpec(small, [{"seed": 5}, {"seed": 0}],
                            strategy="vmapped"), dataset=ds, client_data=cd)
    _assert_bitwise(a["points"][0]["history"], b["points"][1]["history"],
                    "fleet composition changed seed 0")


def test_fleet_lr_axis(shared):
    """learning_rate is a fleet axis: the base-lr point (factor exactly
    1.0) is its solo run bitwise, the varied point trains at another rate,
    and both agree with JAX's fleet."""
    base, ds, cd = shared
    points = [{"learning_rate": 0.1}, {"learning_rate": 0.05}]
    small = dataclasses.replace(base, round=2)
    out = run_sweep(SweepSpec(small, points, strategy="vmapped"),
                    dataset=ds, client_data=cd)
    ref = jax_sweep(jspec.SweepSpec(_jax(round=2), points,
                                    strategy="vmapped"))
    _assert_bitwise(_solo(shared, round=2, learning_rate=0.1),
                    out["points"][0]["history"], "base lr")
    assert (out["points"][0]["history"][-1]["test_loss"]
            != out["points"][1]["history"][-1]["test_loss"])
    for pp, pj in zip(out["points"], ref["points"]):
        _assert_close_to_jax(pp["history"], pj["history"],
                             f"lr {pp['learning_rate']}")


def test_failure_model_fleet(shared):
    """Dropout with a quorum: each point's survivor counts and rejections
    are its solo run's, its history bitwise."""
    base, ds, cd = shared
    faulty = dict(failure_mode="dropout", failure_prob=0.3, min_survivors=3)
    out = run_sweep(SweepSpec(dataclasses.replace(base, **faulty),
                              [{"seed": 0}, {"seed": 1}],
                              strategy="vmapped"),
                    dataset=ds, client_data=cd)
    rejected = 0
    for p in out["points"]:
        solo = _solo(shared, seed=p["seed"], **faulty)
        _assert_bitwise(solo, p["history"], f"seed {p['seed']}")
        for rs, rf in zip(solo, p["history"]):
            assert rs["survivor_count"] == rf["survivor_count"]
            assert rs["round_rejected"] == rf["round_rejected"]
        assert p["rounds_rejected"] == sum(r["round_rejected"]
                                           for r in solo)
        rejected += p["rounds_rejected"]
    assert rejected > 0  # the quorum was exercised


def test_scheduled_two_hash_sweep(shared):
    """Seeds x horizons: two config hashes (the seed hashes, the horizon
    does not) but one seed-normalized program, built once; every point is
    its solo run bitwise."""
    base, ds, cd = shared
    points = [{"seed": s, "round": r} for s in (0, 1) for r in (2, 3)]
    out = run_sweep(SweepSpec(base, points, strategy="scheduled"),
                    dataset=ds, client_data=cd)
    assert out["strategy"] == "scheduled"
    assert len({p["config_hash"] for p in out["points"]}) == 2
    assert out["programs_compiled"] == 1
    assert out["compile_reuse_fraction"] == 0.75
    assert [p["compile_reused"] for p in out["points"]] == [
        False, True, True, True]
    for p in out["points"]:
        _assert_bitwise(_solo(shared, seed=p["seed"], round=p["rounds"]),
                        p["history"], f"point {p['index']}")


@pytest.mark.parametrize("strategy", ["scheduled", "vmapped"])
def test_resume_after_crash(shared, tmp_path, monkeypatch, strategy):
    """A chaos crash after 2 persisted points, then resume: the persisted
    points load, the other 2 run (a fleet of 2 under 'vmapped'), and the
    stitched sweep is the uninterrupted one bitwise."""
    base, ds, cd = shared
    small = dataclasses.replace(base, round=2)
    points = [{"seed": s} for s in range(4)]
    sweep_dir = str(tmp_path / "sweep")
    monkeypatch.setenv("DLS_SWEEP_CRASH_AFTER", "2")
    with pytest.raises(RuntimeError, match="chaos"):
        run_sweep(SweepSpec(small, points, strategy=strategy,
                            sweep_dir=sweep_dir), dataset=ds, client_data=cd)
    monkeypatch.delenv("DLS_SWEEP_CRASH_AFTER")
    resumed = run_sweep(SweepSpec(small, points, strategy=strategy,
                                  sweep_dir=sweep_dir, resume=True),
                        dataset=ds, client_data=cd)
    assert resumed["resumed_points"] == 2
    assert resumed["executed_points"] == 2
    assert [p["resumed"] for p in resumed["points"]] == [
        True, True, False, False]
    reference = run_sweep(SweepSpec(small, points, strategy=strategy),
                          dataset=ds, client_data=cd)
    for pr, pf in zip(reference["points"], resumed["points"]):
        _assert_bitwise(pr["history"], pf["history"],
                        f"resumed point {pr['index']}")
    with open(os.path.join(sweep_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    assert sorted({r["sweep"]["point"] for r in records}) == [0, 1, 2, 3]
    assert len(records) == 4 * small.round


def test_scheduler_outside_a_sweep(shared):
    """The warm-program cache on its own: two configs differing only in
    seed and horizon share a program, and the second run reports it."""
    base, ds, cd = shared
    sched = SweepScheduler()
    r1 = sched.run(dataclasses.replace(base, round=2), dataset=ds,
                   client_data=cd)
    r2 = sched.run(dataclasses.replace(base, seed=9, round=3), dataset=ds,
                   client_data=cd)
    assert r1["compile_reused"] is False
    assert r2["compile_reused"] is True
    assert sched.programs_compiled == 1
    _assert_bitwise(_solo(shared, seed=9, round=3), r2["history"],
                    "scheduler lean loop")
    # A config the lean loop does not cover runs run_simulation.
    r3 = sched.run(dataclasses.replace(base, round=1,
                                       telemetry_level="basic"),
                   dataset=ds, client_data=cd)
    assert r3["compile_reused"] is False and sched.fallback_points == 1


@pytest.mark.parametrize("kw", [
    dict(points=4, rounds_total=12, programs_compiled=1),
    dict(points=6, rounds_total=30, programs_compiled=2, executed_points=3,
         trace_rounds=2, anchor="toy-4", param_bytes=44_700_000),
])
def test_sweep_cost_record_equals_jax(kw):
    ptab, jtab = _tables()
    kw = dict(dict(anchor="toy-1",
                   efficiency={"mxu": 0.3, "hbm": 0.6, "ici": 0.5}), **kw)
    assert costmodel.sweep_cost_record(
        LEDGER, topologies=ptab, **kw) == jcost.sweep_cost_record(
        LEDGER, topologies=jtab, **kw)


# --- the tiny ResNet fleet ------------------------------------------------------

@contextlib.contextmanager
def _forwards():
    """Counts the ResNet's training and evaluation forwards."""
    counts = {"train": 0, "eval": 0}

    def hook(module, args, output):
        if isinstance(module, ResNet18):
            counts["train" if torch.is_grad_enabled() else "eval"] += 1

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield counts
    finally:
        handle.remove()


def test_tiny_resnet_fleet_against_solo_runs():
    """2 seeds, f32 model and local state: each point against its solo
    run, the fleet one program a chunk-step for both experiments, and each
    experiment's model evaluated as its solo run evaluates it (one eval
    forward a batch each)."""
    base = ExperimentConfig(device="cpu", **BASE)
    ds = get_dataset(base.dataset_name, n_train=base.n_train,
                     n_test=base.n_test, seed=base.seed, **base.dataset_args)
    cd = build_client_data(base, ds)
    spec = SweepSpec(base, [{"seed": 0}, {"seed": 1}],
                     strategy="vmapped").validate()
    with _forwards() as fleet_fwd:
        fleet = engine._run_fleet(spec, spec.points, ds, cd, get_logger())
    for point, res in zip(spec.points, fleet):
        with _forwards() as solo_fwd:
            solo = run_simulation(point.config, dataset=ds, client_data=cd,
                                  setup_logging=False)
        assert fleet_fwd["train"] == solo_fwd["train"]
        assert fleet_fwd["eval"] == len(spec.points) * solo_fwd["eval"]
        for rs, rf in zip(solo["history"], res["history"]):
            np.testing.assert_allclose(rf["test_loss"], rs["test_loss"],
                                       rtol=1e-4)
            assert rf["mean_client_loss"] == pytest.approx(
                rs["mean_client_loss"], rel=1e-4)
        names = sorted(solo["global_params"])
        torch.testing.assert_close(
            torch.cat([res["global_params"][n].reshape(-1) for n in names]),
            torch.cat([solo["global_params"][n].reshape(-1)
                       for n in names]),
            rtol=1e-4, atol=1e-5)
    n_eval_batches = -(-base.n_test // base.eval_batch_size)
    assert fleet_fwd["eval"] == len(spec.points) * base.round * n_eval_batches
