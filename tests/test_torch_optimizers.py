"""The port's client and server optimizers against the JAX package's.

* ``Adam`` / ``AdamW`` (parallel/engine.py) against optax's jitted update
  over 20 seeded gradient steps: bitwise in f32 and in bf16, on one flat
  model and on a stack of three models whose step counts differ.
* ``FedAvg.make_server_update`` (sgd, FedAvgM, FedAdam) against the JAX
  package's jitted update over 10 rounds, with and without rejected rounds:
  bitwise, and a rejected round leaves params and state unchanged.
* End-to-end: the JAX tests' ``tiny_config`` with each new optimizer, run
  by both packages with nothing injected, in the accuracy band of
  tests/test_torch_band.py (accuracy within 1/256, test loss rtol 1e-4),
  and with bf16 local state and adamw at rtol 2e-3 (the bf16 band of
  tests/test_torch_keychain.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.algorithms.fedavg import (
    FedAvg as JaxFedAvg,
)
from distributed_learning_simulator_tpu.parallel import engine as jengine
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run_simulation,
)
from distributed_learning_simulator_tpu_torch import simulator
from distributed_learning_simulator_tpu_torch.algorithms.fedavg import FedAvg
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.parallel import engine

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _port_config(jcfg, **changes):
    # cost_model_topology's JAX default is a TPU row the port lacks.
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name != "cost_model_topology"}
    return ExperimentConfig(device="cpu", **{**fields, **changes})


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_matches_optax(name, dtype, stacked):
    """20 steps, gradients over five decades. Stacked: three models whose
    counts differ (model m skips the first m steps), each held against its
    own optax state."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(7)
    n_models, size = (3, 3001) if stacked else (1, 4099)
    tx = jengine.make_optimizer(name, 1e-3, weight_decay=1e-2)
    opt = engine.make_optimizer(name, 1e-3, weight_decay=1e-2)
    p0 = rng.normal(size=(n_models, size)).astype(np.float32)
    jp = [jnp.asarray(p).astype(jdt) for p in p0]
    js = [tx.init(p) for p in jp]
    update = jax.jit(tx.update)
    tp = torch.from_numpy(p0).to(tdt)
    if not stacked:
        tp = tp[0]
    ts = opt.init(tp)
    assert ts["mu"].dtype == tdt and ts["count"].dtype == torch.int32
    for step in range(20):
        g = (rng.normal(size=(n_models, size))
             * 10 ** rng.uniform(-4, 1, size=(n_models, size))
             ).astype(np.float32)
        active = [m for m in range(n_models) if step >= m]
        for m in active:
            u, js[m] = update(jnp.asarray(g[m]).astype(jdt), js[m], jp[m])
            jp[m] = (jp[m].astype(jnp.float32)
                     + u.astype(jnp.float32)).astype(jdt)
        tg = torch.from_numpy(g).to(tdt)
        if not stacked:
            tu, ts = opt.update(tg[0], ts, tp)
            tp = (tp.float() + tu.float()).to(tdt)
            continue
        rows = torch.tensor(active)
        sub = {k: v[rows] for k, v in ts.items()}
        tu, sub = opt.update(tg[rows], sub, tp[rows])
        tp[rows] = (tp[rows].float() + tu.float()).to(tdt)
        for k in ts:
            ts[k][rows] = sub[k]
    got = tp.float().numpy().reshape(n_models, size)
    for m in range(n_models):
        np.testing.assert_array_equal(
            got[m], np.asarray(jp[m].astype(jnp.float32)))
        assert int(ts["count"].reshape(-1)[m]) == int(js[m][0].count)


@pytest.mark.parametrize("rejected_rounds", [(), (3, 4)])
@pytest.mark.parametrize("name,momentum", [("sgd", 0.0), ("sgd", 0.9),
                                           ("adam", 0.0)])
def test_server_update_matches_jax(tiny_config, name, momentum,
                                   rejected_rounds):
    kw = dict(server_optimizer_name=name, server_momentum=momentum,
              server_learning_rate=0.3)
    jinit, jupdate = JaxFedAvg(
        dataclasses.replace(tiny_config, **kw)).make_server_update()
    pinit, pupdate = FedAvg(_port_config(tiny_config, **kw)
                            ).make_server_update()
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=20000).astype(np.float32)
    jp, tp = jnp.asarray(p0), torch.from_numpy(p0.copy())
    js, ts = jinit(jp), pinit(tp)
    jupdate = jax.jit(jupdate)
    for r in range(10):
        agg = (p0 + rng.normal(size=p0.size).astype(np.float32)
               * 10 ** rng.uniform(-4, 0, size=p0.size)).astype(np.float32)
        if rejected_rounds:
            rejected = r in rejected_rounds
            jp, js = jupdate(jp, jnp.asarray(agg), js, jnp.bool_(rejected))
            before = (tp, ts)
            tp, ts = pupdate(tp, torch.from_numpy(agg), ts, rejected)
            if rejected:
                assert tp is before[0] and ts is before[1]
        else:
            jp, js = jupdate(jp, jnp.asarray(agg), js)
            tp, ts = pupdate(tp, torch.from_numpy(agg), ts)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("changes,rtol,acc_band", [
    (dict(optimizer_name="adam", learning_rate=0.01), 1e-4, 1 / 256),
    (dict(optimizer_name="adamw", learning_rate=0.01, weight_decay=0.05),
     1e-4, 1 / 256),
    (dict(server_optimizer_name="sgd", server_learning_rate=1.0,
          server_momentum=0.9), 1e-4, 1 / 256),
    (dict(server_optimizer_name="adam", server_learning_rate=0.05), 1e-4,
     1 / 256),
    (dict(optimizer_name="adamw", learning_rate=0.01, weight_decay=0.05,
          local_compute_dtype="bfloat16", server_optimizer_name="adam",
          server_learning_rate=0.05), 2e-3, 2 / 256),
])
def test_optimizer_histories_match_jax(tiny_config, changes, rtol, acc_band):
    jcfg = dataclasses.replace(tiny_config, round=3, **changes)
    jhist = jax_run_simulation(jcfg, setup_logging=False)["history"]
    phist = simulator.run_simulation(_port_config(jcfg),
                                     setup_logging=False)["history"]
    assert len(phist) == len(jhist) == 3
    for p, j in zip(phist, jhist):
        assert abs(p["test_accuracy"] - j["test_accuracy"]) <= acc_band
        np.testing.assert_allclose(p["test_loss"], j["test_loss"], rtol=rtol)
        np.testing.assert_allclose(p["mean_client_loss"],
                                   j["mean_client_loss"], rtol=rtol)


def test_make_optimizer_registry_and_persistent_adam_budget(tiny_config):
    """adam/adamw build, an unknown name raises as in the JAX package, and
    with reset_client_optimizer=False Adam's two moments per client count
    against the auto chunk size's memory budget."""
    assert isinstance(engine.make_optimizer("adam", 0.1), engine.Adam)
    assert engine.make_optimizer("AdamW", 0.1, weight_decay=0.1).adamw
    with pytest.raises(ValueError, match="unknown optimizer"):
        engine.make_optimizer("lion", 0.1)
    factors = {
        name: simulator._persistent_state_factor(_port_config(
            tiny_config, optimizer_name=name, momentum=0.9,
            reset_client_optimizer=False))
        for name in ("sgd", "adam", "adamw")
    }
    assert factors == {"sgd": 1, "adam": 2, "adamw": 2}
    cfg = _port_config(tiny_config, optimizer_name="adam",
                       reset_client_optimizer=False, worker_number=100)
    device = torch.device("cpu")
    sgd = _port_config(tiny_config, momentum=0.9,
                       reset_client_optimizer=False, worker_number=100)
    n_params = 5_000_000
    assert (simulator._auto_chunk_size(cfg, n_params, 100, device)
            < simulator._auto_chunk_size(sgd, n_params, 100, device))
