"""The port's dynamic populations (``population='dynamic'``:
robustness/population.py, the ``departed`` operand of the ``fed`` round
and the simulator's glue), the twins of the JAX package's
tests/test_population.py (all but its sweep case) and of the dynamic
SIGKILL-resume case of tests/test_chaos_resume.py.

Exact against the JAX package, on the same numpy inputs: the masked hashed
draw (numpy against the JAX program's jitted draw), the registration
stream's words and events, the departure cap, the joined shard rows the
store grows by, the drift schedule, the refusal texts, and the records of
whole runs (population sub-objects, cohort hashes, survivor counts, quorum
verdicts, the summary; test losses at rtol 1e-4, the port's f32 ``fed``
parity tolerance). The port's own contracts: a dynamic run is bitwise the
static run until the first join, ``rejected_by_churn`` marks a quorum
rejection under departures, the caller's client data is never changed,
and a SIGKILLed dynamic run resumes bitwise. The Spearman >= 0.8 floor of
the JAX valuation test is not asserted (the JAX test misses it itself);
the port's valuation vector is compared with the JAX run's instead.
"""

import dataclasses
import importlib.util
import json
import os
import signal

import jax
import jax.numpy as jnp
import jsonschema
import numpy as np
import pytest

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.data.residency import (
    HostShardStore as JaxStore,
)
from distributed_learning_simulator_tpu.ops.sampling import hashed_cohort
from distributed_learning_simulator_tpu.robustness import (
    population as jpop,
)
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run,
)
from distributed_learning_simulator_tpu_torch.data.registry import (
    get_dataset,
)
from distributed_learning_simulator_tpu_torch.data.residency import (
    HostShardStore,
)
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.ops.sampling import (
    draw_cohort_host,
    hashed_cohort_np,
)
from distributed_learning_simulator_tpu_torch.robustness import (
    chaos_resume as chaos,
)
from distributed_learning_simulator_tpu_torch.robustness.population import (
    PopulationModel,
    pop_key_words,
)
from distributed_learning_simulator_tpu_torch.simulator import (
    build_client_data,
    run_simulation,
)
from distributed_learning_simulator_tpu_torch.utils.reporting import (
    config_hash,
)
from torch_runs import port_config

REPO = os.path.join(os.path.dirname(__file__), "..")
SCHEMA = json.load(open(os.path.join(REPO, "tests", "data",
                                     "metrics_record.schema.json")))
DYN = dict(
    dataset_name="synthetic", model_name="mlp", distributed_algorithm="fed",
    worker_number=8, round=5, epoch=1, learning_rate=0.1, batch_size=32,
    n_train=512, n_test=256, log_level="WARNING",
    dataset_args={"difficulty": 0.5}, participation_fraction=0.5,
    participation_sampler="hashed", client_residency="streamed",
    population="dynamic",
)


def _jcfg(**kw) -> JaxConfig:
    return JaxConfig(**dict(DYN, **kw))


def _run(**kw):
    return run_simulation(port_config(_jcfg(**kw)), setup_logging=False)


def _jax_run(**kw):
    return jax_run(_jcfg(**kw), setup_logging=False)


# ---- the masked hashed draw ------------------------------------------------


def test_masked_hashed_draw_equals_jax_program():
    key = prng.key(7)
    words = prng.key_data(key)
    jkey = jax.random.wrap_key_data(jnp.asarray(words))
    rng = np.random.default_rng(3)
    for n, k in ((37, 9), (100, 25), (64, 16)):
        alive = np.ones(n, dtype=bool)
        alive[rng.choice(n, n // 3, replace=False)] = False
        got = hashed_cohort_np(words, n, k, alive=alive)
        want = np.asarray(hashed_cohort(jkey, n, k, alive=alive))
        np.testing.assert_array_equal(got, want)
        assert alive[got].all()  # a departed id is never drawn


def test_all_alive_mask_equals_unmasked_draw():
    words = prng.key_data(prng.key(11))
    for n, k in ((50, 10), (128, 32)):
        np.testing.assert_array_equal(
            hashed_cohort_np(words, n, k),
            hashed_cohort_np(words, n, k, alive=np.ones(n, dtype=bool)))


def test_masked_draw_errors():
    words = prng.key_data(prng.key(0))
    with pytest.raises(ValueError, match="alive"):
        hashed_cohort_np(words, 10, 5, alive=np.zeros(10, dtype=bool))
    with pytest.raises(ValueError, match="exact"):
        draw_cohort_host(prng.key(0), 10, 5, "exact",
                         alive=np.ones(10, dtype=bool))


# ---- the registration stream -----------------------------------------------


def _models(n=10, cohort=4, dataset=None, jdataset=None, **kw):
    cfg = _jcfg(worker_number=n, **kw)
    return (PopulationModel.from_config(port_config(cfg), n, cohort,
                                        dataset=dataset),
            jpop.PopulationModel.from_config(cfg, n, cohort,
                                             dataset=jdataset))


@pytest.mark.parametrize("seed", [0, 42, 9001])
def test_event_stream_equals_jax(seed):
    pm, jm = _models(join_rate=1.5, depart_rate=0.3, drift_fraction=0.3)
    np.testing.assert_array_equal(pm.drift_ids, jm.drift_ids)
    np.testing.assert_array_equal(pm.drift_grades, jm.drift_grades)
    key = prng.key(seed)
    words = pop_key_words(key, pm.seed)
    np.testing.assert_array_equal(
        words, jpop.pop_key_words(jax.random.key(seed), jm.seed))
    for r in range(3):
        e, je = pm.draw_events(words, r), jm.draw_events(words, r)
        assert e.joins == je.joins and e.joins in (1, 2)
        np.testing.assert_array_equal(e.departs, je.departs)
        words = pop_key_words(prng.fold_in(key, r + 1), pm.seed)
    # Another population_seed re-rolls the stream.
    assert not np.array_equal(pop_key_words(key, 0), pop_key_words(key, 9))


def _store(cls, n, slots=4, dim=3, state=None):
    return cls(
        np.arange(n * slots * dim, dtype=np.float32).reshape(n, slots, dim),
        np.zeros((n, slots), dtype=np.int32),
        np.ones((n, slots), dtype=np.float32),
        np.full(n, float(slots), dtype=np.float32), state=state)


def test_departure_cap_keeps_cohort_fillable():
    pm, jm = _models(n=6, cohort=4, depart_rate=0.999)
    words = pop_key_words(prng.key(1), pm.seed)
    ev = pm.draw_events(words, 0)
    np.testing.assert_array_equal(ev.departs,
                                  jm.draw_events(words, 0).departs)
    assert ev.departs.size <= 6 - 4
    pm.apply(ev, _store(HostShardStore, 6))
    assert int(pm.alive.sum()) >= 4
    ev2 = pm.draw_events(pop_key_words(prng.key(2), pm.seed), 1)
    assert not np.isin(ev2.departs, ev.departs).any()


def test_store_grow_appends_without_touching_resident_rows():
    store = _store(HostShardStore, 4)
    before = np.array(store.x, copy=True)
    first = store.grow(np.ones((2, 4, 3), np.float32),
                       np.ones((2, 4), np.int32),
                       np.ones((2, 4), np.float32),
                       np.full(2, 4.0, np.float32))
    assert first == 4 and store.n_clients == 6
    np.testing.assert_array_equal(store.x[:4], before)
    x, _, _, s = store.gather_data(np.array([0, 5]))
    assert x.shape[0] == 2 and s[1] == 4.0
    for _ in range(5):
        store.grow(np.zeros((3, 4, 3), np.float32),
                   np.zeros((3, 4), np.int32), np.ones((3, 4), np.float32),
                   np.full(3, 4.0, np.float32))
    assert store.n_clients == 21
    np.testing.assert_array_equal(store.x[:4], before)
    store2 = _store(HostShardStore, 3)
    store2.attach_valuation(np.array([1.0, 2.0, 3.0]))
    store2.grow(np.zeros((2, 4, 3), np.float32), np.zeros((2, 4), np.int32),
                np.ones((2, 4), np.float32), np.full(2, 4.0, np.float32))
    np.testing.assert_array_equal(store2.valuation,
                                  [1.0, 2.0, 3.0, 0.0, 0.0])
    store2.attach_valuation(np.array([9.0, 8.0, 7.0, 6.0, 5.0]))
    store2.grow(np.zeros((1, 4, 3), np.float32), np.zeros((1, 4), np.int32),
                np.ones((1, 4), np.float32), np.full(1, 4.0, np.float32))
    np.testing.assert_array_equal(store2.valuation,
                                  [9.0, 8.0, 7.0, 6.0, 5.0, 0.0])
    store3 = _store(HostShardStore, 2,
                    state={"m": np.zeros((2, 5), np.float32)})
    with pytest.raises(ValueError, match="state_rows"):
        store3.grow(np.zeros((1, 4, 3), np.float32),
                    np.zeros((1, 4), np.int32), np.ones((1, 4), np.float32),
                    np.full(1, 4.0, np.float32))
    store3.grow(np.zeros((1, 4, 3), np.float32), np.zeros((1, 4), np.int32),
                np.ones((1, 4), np.float32), np.full(1, 4.0, np.float32),
                state_rows={"m": np.ones((1, 5), np.float32)})
    assert store3.state["m"].shape == (3, 5)


@pytest.mark.parametrize("compact", [True, False])
def test_joined_rows_equal_jax(compact):
    """Joins draw the same training samples and pack them as the JAX
    package does (uint8-compact or float32)."""
    ds = get_dataset("synthetic", n_train=64, n_test=16, seed=0,
                     shape=(4, 4, 1))
    pm, jm = _models(n=5, cohort=2, dataset=ds, jdataset=ds, join_rate=3.0,
                     depart_rate=0.2)
    dim = 16
    shape = (5, 6, dim) if compact else (5, 6, 4, 4, 1)
    rng = np.random.default_rng(0)
    x = (rng.integers(0, 255, size=shape).astype(np.uint8) if compact
         else rng.uniform(size=shape).astype(np.float32))
    args = (x, np.zeros((5, 6), np.int32), np.ones((5, 6), np.float32),
            np.full(5, 6.0, np.float32))
    store = HostShardStore(*(a.copy() for a in args))
    jstore = JaxStore(*(a.copy() for a in args))
    for r in range(3):
        words = pop_key_words(prng.key(100 + r), pm.seed)
        for m, s in ((pm, store), (jm, jstore)):
            m.apply(m.draw_events(words, r), s, words=words)
    assert store.n_clients == jstore.n_clients == 5 + 9
    for f in ("x", "y", "mask", "sizes"):
        np.testing.assert_array_equal(getattr(store, f), getattr(jstore, f))
    np.testing.assert_array_equal(pm.alive, jm.alive)
    saved = pm.checkpoint_state(store)
    jsaved = jm.checkpoint_state(jstore)
    for f in ("x", "y", "mask", "sizes"):
        np.testing.assert_array_equal(saved["joined"][f],
                                      jsaved["joined"][f])
    assert saved["totals"] == jsaved["totals"]


def test_drift_schedule_absolute_idempotent_and_equal_jax():
    pm, jm = _models(n=6, cohort=3, drift_fraction=1.0, drift_factor=0.9,
                     round=8)
    stores = [_store(HostShardStore, 6, slots=8),
              _store(JaxStore, 6, slots=8)]
    for m, s in zip((pm, jm), stores):
        s.y[:] = 7
        m._num_classes = 5
        m.apply_drift(s, 7)
    np.testing.assert_array_equal(stores[0].y, stores[1].y)
    final = np.array(stores[0].y, copy=True)
    pm2, _ = _models(n=6, cohort=3, drift_fraction=1.0, drift_factor=0.9,
                     round=8)
    pm2._num_classes = 5
    store2 = _store(HostShardStore, 6, slots=8)
    store2.y[:] = 7
    pm2.apply_drift(store2, 3)
    mid = np.array(store2.y, copy=True)
    assert ((mid != 7) <= (final != 7)).all()
    pm2.apply_drift(store2, 3)
    np.testing.assert_array_equal(store2.y, mid)
    pm2.apply_drift(store2, 7)
    np.testing.assert_array_equal(store2.y, final)


# ---- configuration ---------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    dict(client_residency="resident"),
    dict(participation_sampler="exact"),
    dict(participation_fraction=1.0),
    dict(rounds_per_dispatch=2),
    dict(async_mode="on", arrival_model="bimodal"),
    dict(distributed_algorithm="sign_SGD"),
    dict(distributed_algorithm="GTG_shapley_value"),
    dict(execution_mode="threaded"),
    dict(client_stats="on", client_valuation="on", valuation_audit_every=2),
    dict(join_rate=-1.0),
    dict(depart_rate=1.0),
    dict(drift_fraction=2.0),
])
def test_refusal_texts_equal_jax(overrides):
    jcfg = _jcfg(**overrides)
    with pytest.raises(ValueError) as jerr:
        jcfg.validate()
    with pytest.raises(ValueError) as err:
        port_config(jcfg).validate()
    assert str(err.value) == str(jerr.value)


def test_base_validates_and_multihost_is_item_17():
    port_config(_jcfg()).validate()
    with pytest.raises(NotImplementedError, match="item 17"):
        port_config(_jcfg(), multihost=True).validate()


def test_static_offgate_hash_and_history():
    base = port_config(_jcfg(population="static"))
    knobs = dict(population_seed=5, join_rate=3.0, depart_rate=0.2,
                 drift_fraction=0.4, drift_factor=0.9)
    assert config_hash(base) == config_hash(
        dataclasses.replace(base, **knobs))
    assert config_hash(base) != config_hash(
        dataclasses.replace(base, population="dynamic"))
    r1 = run_simulation(base, setup_logging=False)
    r2 = run_simulation(dataclasses.replace(base, **knobs),
                        setup_logging=False)
    assert r1["history"][0].keys() == r2["history"][0].keys()
    for key in ("test_accuracy", "cohort_hash"):
        assert ([h[key] for h in r1["history"]]
                == [h[key] for h in r2["history"]])
    assert r1["population_summary"] is None


# ---- runs ------------------------------------------------------------------


def test_dynamic_bitwise_static_until_first_join():
    static = _run(population="static")
    dyn = _run(join_rate=1.0)
    for key in ("test_accuracy", "test_loss", "mean_client_loss",
                "cohort_hash"):
        assert static["history"][0][key] == dyn["history"][0][key], key
    assert ([h["cohort_hash"] for h in static["history"][1:]]
            != [h["cohort_hash"] for h in dyn["history"][1:]])
    assert dyn["population_summary"]["joins_total"] == len(dyn["history"])


def _compare_with_jax(port, jres):
    for key in ("cohort_hash", "survivor_count", "round_rejected",
                "population"):
        assert ([h.get(key) for h in port["history"]]
                == [h.get(key) for h in jres["history"]]), key
    np.testing.assert_allclose(
        [h["test_loss"] for h in port["history"]],
        [h["test_loss"] for h in jres["history"]], rtol=1e-4)
    assert port["population_summary"] == jres["population_summary"]


def test_tenx_growth_records_equal_jax():
    n0, rounds = 8, 6
    kw = dict(round=rounds, join_rate=float(round(9 * n0 / rounds)),
              depart_rate=0.05, drift_fraction=0.25, drift_factor=0.8)
    result = _run(**kw)
    summary = result["population_summary"]
    assert summary["n_registered"] == n0 + summary["joins_total"]
    assert summary["growth_ratio"] >= 9.0
    for r in result["history"]:
        assert r["schema_version"] == 9
        jsonschema.validate(r, SCHEMA)
        assert r["population"]["n_alive"] <= r["population"]["n_registered"]
    assert len({r["cohort_hash"] for r in result["history"]}) == rounds
    assert result["client_state"] is None
    _compare_with_jax(result, _jax_run(**kw))


def test_churn_quorum_rejection_flagged_equal_jax():
    kw = dict(depart_rate=0.6, min_survivors=4)
    result = _run(**kw)
    assert result["rounds_rejected"] >= 1
    flagged = [r for r in result["history"]
               if r["population"]["rejected_by_churn"]]
    assert flagged
    for r in flagged:
        assert r["round_rejected"] is True
        assert r["population"]["cohort_departs"] > 0
        jsonschema.validate(r, SCHEMA)
    assert (result["population_summary"]["rounds_rejected_by_churn"]
            == len(flagged))
    _compare_with_jax(result, _jax_run(**kw))


def test_valuation_through_churn_equals_jax():
    """The streaming valuation over a growing, churning population: its
    vector lives in the store and covers the grown population, and equals
    the JAX run's (relative 1e-3 of its largest entry; the loss deltas it
    folds agree at the f32 parity tolerance)."""
    kw = dict(worker_number=12, round=6, participation_fraction=0.75,
              client_stats="on", client_valuation="on", join_rate=0.5,
              depart_rate=0.03, drift_fraction=1.0, drift_factor=0.9)
    port = _run(**kw)
    jres = _jax_run(**kw)
    _compare_with_jax(port, jres)
    v = port["valuation_state"].values
    jv = jres["valuation_state"].values
    assert v.shape == jv.shape
    assert v.shape[0] == port["population_summary"]["n_registered"] > 12
    np.testing.assert_allclose(v, jv, atol=1e-3 * np.abs(jv).max())


def test_dynamic_run_does_not_mutate_caller_client_data():
    cfg = port_config(_jcfg(join_rate=1.0, drift_fraction=0.5,
                            drift_factor=0.9))
    ds = get_dataset(cfg.dataset_name, n_train=cfg.n_train,
                     n_test=cfg.n_test, seed=cfg.seed, **cfg.dataset_args)
    cd = build_client_data(cfg, ds)
    y_before, x_before = cd.y.copy(), cd.x.copy()
    run_simulation(cfg, dataset=ds, client_data=cd, setup_logging=False)
    np.testing.assert_array_equal(cd.y, y_before)
    np.testing.assert_array_equal(cd.x, x_before)
    assert cd.n_clients == 8


def test_report_run_population_section(tmp_path):
    run_simulation(port_config(
        _jcfg(round=4, join_rate=2.0, depart_rate=0.1, drift_fraction=0.25,
              client_stats="on", client_valuation="on"),
        log_root=str(tmp_path)))
    records = chaos.read_metrics_jsonl(str(tmp_path))
    spec = importlib.util.spec_from_file_location(
        "report_run", os.path.join(REPO, "scripts", "report_run.py"))
    rr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rr)
    summary = rr.summarize_run(records)
    p = summary["population"]
    assert p["n_initial"] == 8
    assert p["n_registered_final"] == records[-1]["population"][
        "n_registered"]
    assert p["joins_total"] == sum(r["population"]["joins"]
                                   for r in records)
    assert p["drift_clients"] == records[0]["population"]["drift_clients"]
    text = "\n".join(rr.render_summary(summary))
    assert f"dynamic population: 8 -> {p['n_registered_final']}" in text


def test_subprocess_sigkill_mid_growth_resume_bitwise(tmp_path):
    """SIGKILL between checkpoints during joins, departures and drift:
    the resumed run restores the stream's cursor, alive mask and grown
    store, replays the round past the newest checkpoint, and the stitched
    history is the straight run's, bitwise."""
    dyn = dict(population="dynamic", join_rate=2.0, depart_rate=0.1,
               drift_fraction=0.5, drift_factor=0.8,
               participation_sampler="hashed", client_residency="streamed",
               min_survivors=1)
    straight = chaos.run_straight(chaos.chaos_config(
        str(tmp_path), "straight", 5, device="cpu", log_level="WARNING",
        **dyn))
    assert any(r["population"]["joins"] for r in straight)
    cfg = chaos.chaos_config(
        str(tmp_path), "sigkill", 5, device="cpu", log_level="WARNING",
        checkpoint_dir=str(tmp_path / "sigkill" / "ckpt"),
        checkpoint_every=2, **dyn)
    proc = chaos.run_crashed_subprocess(cfg, 2, "sigkill", timeout=420)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                proc.stderr[-800:])
    crashed = chaos.read_metrics_jsonl(cfg.log_root)
    assert crashed
    verdict = chaos.stitch_and_compare(straight, crashed,
                                       chaos.run_resumed(cfg))
    assert verdict["bit_identical"], verdict
    assert straight[-1]["population"]["n_registered"] > 6
