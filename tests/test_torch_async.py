"""The port's asynchronous federation (robustness/arrivals.py and the async
round of algorithms/fedavg.py) against the JAX package's.

* ``prng.normal`` is bitwise ``jax.random.normal``; the speed table, the
  latencies of both arrival models, the deadline split, the staleness and
  the discount are bitwise JAX's on the same keys (the lognormal jitter's
  ``exp`` is XLA's CPU ``exp`` replayed, ``arrivals.xla_exp``).
* The buffer step (``absorb_and_apply``) matches JAX's hand-computed
  3-client trace and JAX's own step at rtol 1e-6.
* ``fed`` with async on through both packages: params at rtol 1e-5, every
  round's v4 ``async`` record, ``async_speedup_ratio`` and the buffer
  occupancy; a straggler fault routed into the buffer, the same way.
* ``round_deadline=inf`` is bitwise the port's sync run; a resumed async
  run is bitwise the straight one; the refusals (config, algorithms,
  checkpoint mismatches) carry JAX's texts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.robustness import (
    arrivals as jarrivals,
)
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run,
)
from distributed_learning_simulator_tpu_torch.ops import prng
from distributed_learning_simulator_tpu_torch.robustness import arrivals
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
from torch_runs import flat_params, port_config

ASYNC_ON = dict(
    async_mode="on", arrival_model="bimodal", arrival_slow_fraction=0.4,
    arrival_slow_factor=8.0, round_deadline=1.5, async_buffer_size=3,
    staleness_alpha=0.5,
)


def _port(jcfg, **changes):
    return run_simulation(port_config(jcfg, **changes), setup_logging=False)


def _flat(result):
    return flat_params(result, sorted(result["global_params"]))


@pytest.mark.parametrize("seed, shape", [(0, (1000,)), (7, (3, 257)),
                                         (123, (4096,))])
def test_normal_is_bitwise_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = prng.normal(prng.key(seed), shape)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # Inside a jitted program XLA folds a scale into sqrt(2) first.
    want = np.asarray(jax.jit(
        lambda k: 0.7 * jax.random.normal(k, shape))(jax.random.key(seed)))
    np.testing.assert_array_equal(prng.normal(prng.key(seed), shape, 0.7),
                                  want)


def test_xla_exp_is_bitwise_jnp_exp():
    x = np.random.default_rng(0).normal(scale=3.0, size=50000).astype(
        np.float32)
    np.testing.assert_array_equal(arrivals.xla_exp(x),
                                  np.asarray(jax.jit(jnp.exp)(x)))


@pytest.mark.parametrize("model", ["bimodal", "lognormal"])
def test_draws_and_classification_equal_jax(model):
    kw = dict(arrival_model=model, slow_fraction=0.3, slow_factor=8.0,
              sigma=0.7, seed=3, deadline=1.5, buffer_size=4, alpha=0.5)
    jaf, paf = jarrivals.AsyncFederation(**kw), arrivals.AsyncFederation(**kw)
    table = np.asarray(jaf.speed_table(40))
    np.testing.assert_array_equal(paf.speed_table(40), table)
    ids = np.arange(3, 40, 2)
    for r in range(8):
        jl = np.asarray(jax.jit(lambda k: jaf.draw_latency(
            k, jnp.asarray(ids), jnp.asarray(table[ids])))(
                jax.random.key(r)))
        pl = paf.draw_latency(prng.key(r), ids, table[ids])
        np.testing.assert_array_equal(pl, jl)
        forced = np.asarray(jax.random.bernoulli(jax.random.key(100 + r),
                                                 0.2, ids.shape))
        jout = jax.jit(jaf.classify)(jnp.asarray(jl), jnp.asarray(forced))
        pout = paf.classify(pl, forced)
        for p, j in zip(pout, jout):
            np.testing.assert_array_equal(p, np.asarray(j))
        for p, j in zip(paf.durations(pl), jax.jit(jaf.durations)(jl)):
            assert p == np.asarray(j)


def test_buffer_step_matches_jax_and_the_hand_trace():
    """The JAX test's 3-client trace: A (size 3) on time at 12, the late
    discounted sum 17.5 at weight 1.25 against a global of 10."""
    mk = dict(arrival_model="bimodal", slow_fraction=0.2, slow_factor=8.0,
              sigma=0.5, seed=0, deadline=1.0, alpha=1.0)
    g = torch.tensor([10.0, -3.0])
    fresh = torch.tensor([12.0, -1.0])
    late = torch.tensor([17.5, float("nan")])
    for k, late_sum, want in ((2, torch.tensor([17.5, -2.0]), None),
                              (3, torch.tensor([17.5, -2.0]), None),
                              (2, late, None)):
        paf = arrivals.AsyncFederation(buffer_size=k, **mk)
        jaf = jarrivals.AsyncFederation(buffer_size=k, **mk)
        pout = paf.absorb_and_apply(paf.init_state(g), g, fresh, 3.0,
                                    late_sum, 1.25, 2, 1.0)
        jg = jnp.asarray(g.numpy())
        jout = jaf.absorb_and_apply(
            jaf.init_state(jg), jg, jnp.asarray(fresh.numpy()),
            jnp.float32(3.0), jnp.asarray(late_sum.numpy()),
            jnp.float32(1.25), jnp.int32(2), jnp.float32(1.0))
        np.testing.assert_allclose(pout[0].numpy(), np.asarray(jout[0]),
                                   rtol=1e-6)
        assert bool(pout[1]) == bool(jout[1])
        for p_state, j_state in zip(pout[2:], jout[2:]):
            for name in p_state:
                np.testing.assert_allclose(
                    p_state[name].numpy(), np.asarray(j_state[name]),
                    rtol=1e-6)
    paf = arrivals.AsyncFederation(buffer_size=2, **mk)
    new, applied, ins, nxt = paf.absorb_and_apply(
        paf.init_state(g), g, fresh, 3.0, torch.tensor([17.5, -2.0]), 1.25,
        2, 1.0)
    assert bool(applied)
    np.testing.assert_allclose(float(new[0]), 10.0 + 44.0 / 17.0, rtol=1e-6)
    assert float(ins["buf_sum"][0]) == 5.0 and int(nxt["buf_count"]) == 0
    np.testing.assert_allclose(
        arrivals.staleness_discount(np.asarray([0.0, 1.0, 3.0]), 1.0),
        [1.0, 0.5, 0.25])


@pytest.fixture(scope="module")
def async_pair():
    """One async configuration with late clients through both packages."""
    cfg = JaxConfig(dataset_name="synthetic", model_name="mlp",
                    worker_number=6, round=4, epoch=1, learning_rate=0.1,
                    batch_size=32, n_train=512, n_test=256,
                    log_level="WARNING", dataset_args={"difficulty": 0.5},
                    **ASYNC_ON)
    return cfg, jax_run(cfg, setup_logging=False), _port(cfg)


def test_async_fed_matches_jax(async_pair):
    cfg, jres, pres = async_pair
    jrecs = [h["async"] for h in jres["history"]]
    prec = [h["async"] for h in pres["history"]]
    assert any(r["late"] for r in prec) and any(r["applied"] for r in prec)
    for p, j in zip(prec, jrecs, strict=True):
        assert {k: p[k] for k in ("on_time", "late", "buffer", "applied",
                                  "mean_staleness", "sim_round_s",
                                  "sim_round_sync_s")} == {
            k: j[k] for k in ("on_time", "late", "buffer", "applied",
                              "mean_staleness", "sim_round_s",
                              "sim_round_sync_s")}
        np.testing.assert_allclose(p["sim_clock_s"], j["sim_clock_s"],
                                   rtol=1e-6)
    assert all(h["schema_version"] == 4 for h in pres["history"])
    np.testing.assert_allclose(pres["async_speedup_ratio"],
                               jres["async_speedup_ratio"], rtol=1e-6)
    assert pres["mean_buffer_occupancy"] == jres["mean_buffer_occupancy"]
    np.testing.assert_allclose(pres["sim_clock_seconds"],
                               jres["sim_clock_seconds"], rtol=1e-6)
    names = sorted(pres["global_params"])
    np.testing.assert_allclose(_flat(pres).numpy(),
                               flat_params(jres, names).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        [h["test_loss"] for h in pres["history"]],
        [h["test_loss"] for h in jres["history"]], rtol=1e-5)


def test_straggler_fault_routes_into_the_buffer_as_in_jax(tiny_config):
    cfg = dataclasses.replace(
        tiny_config, round=3, failure_mode="straggler", failure_prob=1.0,
        min_survivors=4,
        **{**ASYNC_ON, "round_deadline": float("inf"),
           "async_buffer_size": 5})
    jres = jax_run(cfg, setup_logging=False)
    pres = _port(cfg)
    assert [h["async"] for h in pres["history"]] == [
        h["async"] for h in jres["history"]]
    assert [h["survivor_count"] for h in pres["history"]] == [4, 4, 4]
    assert not any(h["round_rejected"] for h in pres["history"])
    np.testing.assert_allclose(
        [h["test_loss"] for h in pres["history"]],
        [h["test_loss"] for h in jres["history"]], rtol=1e-5)


def test_deadline_inf_is_bitwise_sync(tiny_config):
    """With sampling, dropout faults and the quorum, as in the JAX test."""
    cfg = dataclasses.replace(
        tiny_config, worker_number=8, round=3, participation_fraction=0.5,
        failure_mode="dropout", failure_prob=0.3, min_survivors=1)
    sync = _port(cfg)
    inf = _port(cfg, **{**ASYNC_ON, "round_deadline": float("inf")})
    for s, a in zip(sync["history"], inf["history"], strict=True):
        assert a["async"]["late"] == 0 and not a["async"]["applied"]
        strip = {k: v for k, v in a.items()
                 if k not in ("async", "schema_version", "round_seconds")}
        assert strip == {k: v for k, v in s.items() if k != "round_seconds"}
    assert torch.equal(_flat(sync), _flat(inf))


def test_resume_is_bitwise_and_mismatches_refuse_as_jax(tiny_config,
                                                        tmp_path):
    cfg = dataclasses.replace(
        tiny_config, round=4,
        **{**ASYNC_ON, "arrival_slow_fraction": 1.0, "round_deadline": 1.0,
           "async_buffer_size": 6})
    golden = _port(cfg)
    ckpt = str(tmp_path / "ckpt")
    first = _port(cfg, round=2, checkpoint_dir=ckpt, checkpoint_every=2)
    resumed = _port(cfg, checkpoint_dir=ckpt, checkpoint_every=2,
                    resume=True)
    stitched = first["history"] + resumed["history"]
    assert [{k: v for k, v in h.items() if k != "round_seconds"}
            for h in stitched] == [
        {k: v for k, v in h.items() if k != "round_seconds"}
        for h in golden["history"]]
    assert torch.equal(_flat(resumed), _flat(golden))
    sync_ckpt = str(tmp_path / "sync_ckpt")
    _port(tiny_config, round=2, checkpoint_dir=sync_ckpt, checkpoint_every=2)
    for run_cfg, directory in ((tiny_config, ckpt), (cfg, sync_ckpt)):
        with pytest.raises(ValueError) as port_err:
            _port(run_cfg, checkpoint_dir=directory, resume=True)
        with pytest.raises(ValueError) as jax_err:
            jax_run(dataclasses.replace(run_cfg, checkpoint_dir=directory,
                                        resume=True), setup_logging=False)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("changes", [
    dict(async_mode="sometimes"),
    dict(async_mode="on"),
    dict(arrival_model="poisson"),
    dict(ASYNC_ON, round_deadline=0.0),
    dict(ASYNC_ON, async_buffer_size=0),
    dict(ASYNC_ON, staleness_alpha=-1.0),
    dict(ASYNC_ON, arrival_slow_fraction=1.5),
    dict(ASYNC_ON, arrival_slow_factor=0.5),
    dict(ASYNC_ON, arrival_model="lognormal", arrival_sigma=0.0),
])
def test_config_refusals_match_jax(tiny_config, changes):
    with pytest.raises(ValueError) as port_err:
        port_config(tiny_config, **changes).validate()
    with pytest.raises(ValueError) as jax_err:
        dataclasses.replace(tiny_config, **changes).validate()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("changes", [
    dict(distributed_algorithm="sign_SGD"),
    dict(distributed_algorithm="GTG_shapley_value"),
])
def test_algorithms_without_a_buffer_refuse_as_jax(tiny_config, changes):
    cfg = dataclasses.replace(tiny_config, round=1, **ASYNC_ON, **changes)
    with pytest.raises(ValueError) as port_err:
        _port(cfg)
    with pytest.raises(ValueError) as jax_err:
        jax_run(cfg, setup_logging=False)
    assert str(port_err.value) == str(jax_err.value)
    assert "async_mode='on'" in str(port_err.value)
