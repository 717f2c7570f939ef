"""The port's per-client statistics (telemetry/client_stats.py and its
hooks in the round functions) against the JAX package's on the CPU.

* The host side (detector, record builder, attribution cross-check,
  config knobs) equals the JAX package's on the same inputs.
* The ``[N, S]`` matrix of a ``tiny_config`` run equals the JAX run's on
  the mean, materializing and bucketed paths (f32 columns rtol 1e-4, the
  non-finite count exact), and the mean and materializing paths agree
  with each other (the bucketed schedule trains other steps).
* Under ``corrupt_nan`` and ``corrupt_scale`` both packages flag exactly
  the injected clients, with the same reasons.
* The cadence and the participant mapping, sign_SGD's ``vote_agreement``
  and Shapley's ``sv_stats_corr`` equal the JAX run's (rtol 1e-4), and
  fed_quant's ``quant_mse`` the JAX hook's on one aggregate (a run's
  broadcast dither is another draw); ``client_stats='off'`` trains exactly
  as 'on'.
"""

import dataclasses

import numpy as np
import pytest

from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run_simulation,
)
from distributed_learning_simulator_tpu.telemetry import (
    client_stats as jcs,
)
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
from distributed_learning_simulator_tpu_torch.telemetry import client_stats
from distributed_learning_simulator_tpu_torch.telemetry.client_stats import (
    STAT_FIELDS,
    ClientStats,
    attribution_crosscheck,
    client_stats_record,
    detect_anomalies,
)
from torch_runs import port_config

_IDX = {name: i for i, name in enumerate(STAT_FIELDS)}


def _stats(n, update_norm=1.0, loss_after=2.0, nonfinite=0.0):
    s = np.zeros((n, len(STAT_FIELDS)))
    s[:, _IDX["loss_before"]] = 2.5
    s[:, _IDX["loss_after"]] = loss_after
    s[:, _IDX["update_norm"]] = update_norm
    s[:, _IDX["grad_norm"]] = 1.0
    s[:, _IDX["agg_cosine"]] = 0.9
    s[:, _IDX["nonfinite_count"]] = nonfinite
    return s


def _case(name):
    """The JAX package's detector cases: (stats, expected flags)."""
    if name == "single_client":
        return _stats(1, update_norm=1e9), []
    if name == "single_client_nan":
        return _stats(1, nonfinite=3.0), [0]
    if name == "identical":
        s = _stats(8)
        s[3, _IDX["update_norm"]] += 1e-7
        return s, []
    if name == "one_nan":
        s = _stats(8)
        s[5, _IDX["nonfinite_count"]] = 1234.0
        s[5, _IDX["update_norm"]] = np.nan
        s[5, _IDX["loss_after"]] = np.nan
        return s, [5]
    if name == "scaled_high_side_only":
        s = _stats(8)
        s[2, _IDX["update_norm"]] *= 100.0
        s[6, _IDX["update_norm"]] = 0.0
        return s, [2]
    if name == "diverged":
        s = _stats(8)
        s[1, _IDX["loss_after"]] = 400.0
        return s, [1]
    if name == "majority_empty":
        s = _stats(8)
        s[:5] = 0.0
        return s, []
    if name == "empty_minority_outlier":
        s = _stats(8)
        s[:4] = 0.0
        s[7, _IDX["update_norm"]] *= 100.0
        return s, [7]
    s = _stats(8)  # reasons join
    s[4, _IDX["nonfinite_count"]] = 1.0
    s[4, _IDX["update_norm"]] *= 100.0
    return s, [4]


@pytest.mark.parametrize("name", [
    "single_client", "single_client_nan", "identical", "one_nan",
    "scaled_high_side_only", "diverged", "majority_empty",
    "empty_minority_outlier", "reasons_join",
])
def test_detector_matches_jax(name):
    stats, want = _case(name)
    flagged, reasons = detect_anomalies(stats)
    assert flagged == want
    assert (flagged, reasons) == jcs.detect_anomalies(stats)


def test_record_builder_and_crosscheck_match_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(4, len(STAT_FIELDS)))
    s[1, _IDX["loss_after"]] = np.nan
    args = (s, [1], {1: "non_finite"})
    kw = dict(participants=np.asarray([7, 5, 3, 1]),
              extras={"quant_mse": np.nan, "vote_agreement": 0.75})
    rec = client_stats_record(*args, **kw)
    assert rec == jcs.client_stats_record(*args, **kw)
    assert rec["flagged_clients"] == [5] and rec["quant_mse"] is None
    big = _stats(33)
    assert client_stats_record(big, [], {}) == jcs.client_stats_record(
        big, [], {})
    assert "per_client" not in client_stats_record(big, [], {})
    sv = np.asarray([0.1, 0.2, 0.3, 0.4])
    s = _stats(4)
    s[:, _IDX["loss_before"]] = 2.0 + sv
    for stats_sv in ((sv, s), (np.zeros(4), s), (sv[:1], s[:1])):
        assert attribution_crosscheck(*stats_sv) == (
            jcs.attribution_crosscheck(*stats_sv))
    assert attribution_crosscheck(sv, s) == pytest.approx(1.0)


@pytest.mark.parametrize("changes,match", [
    ({"client_stats": "loud"}, "client_stats"),
    ({"client_stats_every": 0}, "client_stats_every"),
    ({"client_stats_probe": 0}, "client_stats_probe"),
    ({"client_stats_mad_threshold": 0.0}, "client_stats_mad_threshold"),
])
def test_config_knobs_refuse_as_jax(tiny_config, changes, match):
    with pytest.raises(ValueError, match=match) as jerr:
        dataclasses.replace(tiny_config, **changes).validate()
    with pytest.raises(ValueError, match=match) as perr:
        port_config(tiny_config, **changes).validate()
    assert str(perr.value) == str(jerr.value)
    on = ClientStats.from_config(port_config(
        tiny_config, client_stats="on", client_stats_every=3))
    assert on == ClientStats(every=3)
    assert on.fetch_round(0) and not on.fetch_round(2) and on.fetch_round(3)
    assert ClientStats.from_config(port_config(tiny_config)) is None


def _both(cfg):
    jres = jax_run_simulation(cfg, setup_logging=False)
    pres = run_simulation(port_config(cfg), setup_logging=False)
    assert len(jres["history"]) == len(pres["history"])
    return jres, pres


def _assert_stats_close(p, j):
    """Two ``client_stats`` sub-objects: ids, flags and the non-finite
    count exact, the f32 columns at rtol 1e-4."""
    assert p["n_clients"] == j["n_clients"]
    assert p["flagged_clients"] == j["flagged_clients"]
    assert p["flag_reason"] == j["flag_reason"]
    pp, jp = p["per_client"], j["per_client"]
    assert pp["client_ids"] == jp["client_ids"]
    assert pp["nonfinite_count"] == jp["nonfinite_count"]
    for field in STAT_FIELDS:
        a = np.asarray(pp[field], dtype=np.float64)
        b = np.asarray(jp[field], dtype=np.float64)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-6,
                                   err_msg=field)


PATHS = {
    "mean": dict(client_chunk_size=2),
    "materializing": dict(client_chunk_size=2, client_eval=True),
    "bucketed": dict(client_chunk_size=2, partition="dirichlet",
                     dirichlet_alpha=0.3),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_stats_matrix_matches_jax(tiny_config, path):
    cfg = dataclasses.replace(tiny_config, client_stats="on",
                              **PATHS[path])
    jres, pres = _both(cfg)
    assert pres["clients_flagged"] == jres["clients_flagged"] == 0
    for p, j in zip(pres["history"], jres["history"]):
        assert p["schema_version"] == j["schema_version"] == 3
        _assert_stats_close(p["client_stats"], j["client_stats"])
        np.testing.assert_allclose(p["test_loss"], j["test_loss"],
                                   rtol=1e-4)


def test_paths_agree_and_off_trains_the_same(tiny_config):
    """The mean and materializing paths give the same stats; the stats
    change nothing in training ('off' against 'on', exact)."""
    base = dataclasses.replace(tiny_config, client_stats="on",
                               client_chunk_size=2)
    runs = {name: run_simulation(port_config(
        base, client_eval=name == "materializing"), setup_logging=False)
        for name in ("mean", "materializing")}
    for hm, hs in zip(runs["mean"]["history"],
                      runs["materializing"]["history"]):
        pm, ps = hm["client_stats"], hs["client_stats"]
        for field in STAT_FIELDS:
            np.testing.assert_allclose(
                np.asarray(pm["per_client"][field], dtype=np.float64),
                np.asarray(ps["per_client"][field], dtype=np.float64),
                rtol=2e-4, atol=1e-6, err_msg=field)
    off = run_simulation(port_config(base, client_stats="off"),
                         setup_logging=False)
    assert off["clients_flagged"] is None
    keys = ("test_accuracy", "test_loss", "mean_client_loss")
    assert [{k: h[k] for k in keys} for h in off["history"]] == [
        {k: h[k] for k in keys} for h in runs["mean"]["history"]]
    assert all("client_stats" not in h for h in off["history"])


@pytest.mark.parametrize("mode,prob,reason", [
    ("corrupt_nan", 0.4, "non_finite"),
    ("corrupt_scale", 0.3, "update_norm"),
])
def test_detector_flags_injected_clients_as_jax(tiny_config, mode, prob,
                                                reason):
    cfg = dataclasses.replace(
        tiny_config, worker_number=8, round=3, client_stats="on",
        failure_mode=mode, failure_prob=prob, min_survivors=1,
        aggregation="median", trim_ratio=0.1,
    )
    jres, pres = _both(cfg)
    flagged = 0
    for p, j in zip(pres["history"], jres["history"]):
        pc, jc = p["client_stats"], j["client_stats"]
        assert pc["flagged_clients"] == jc["flagged_clients"]
        assert pc["flag_reason"] == jc["flag_reason"]
        assert all(r == reason for r in pc["flag_reason"].values())
        flagged += len(pc["flagged_clients"])
        assert p["survivor_count"] == j["survivor_count"]
        # The flagged are the failure model's corrupt clients.
        assert len(pc["flagged_clients"]) == 8 - p["survivor_count"]
    assert flagged > 0
    assert pres["clients_flagged"] == jres["clients_flagged"] == flagged


def test_cadence_and_participants_match_jax(tiny_config):
    cfg = dataclasses.replace(
        tiny_config, worker_number=8, round=3, client_stats="on",
        client_stats_every=2, participation_fraction=0.5,
    )
    jres, pres = _both(cfg)
    for p, j in zip(pres["history"], jres["history"]):
        assert ("client_stats" in p) == ("client_stats" in j)
        assert p.get("schema_version") == j.get("schema_version")
        if "client_stats" in p:
            _assert_stats_close(p["client_stats"], j["client_stats"])
    assert "client_stats" not in pres["history"][1]


@pytest.mark.parametrize("algo,field", [
    ("sign_SGD", "vote_agreement"),
    ("fed_quant", "quant_mse"),
    ("multiround_shapley_value", "sv_stats_corr"),
])
def test_algorithm_round_scalars_match_jax(tiny_config, algo, field):
    cfg = dataclasses.replace(
        tiny_config, distributed_algorithm=algo, client_stats="on",
        learning_rate=0.01 if algo == "sign_SGD" else 0.1,
    )
    jres, pres = _both(cfg)
    seen = 0
    for p, j in zip(pres["history"], jres["history"]):
        pv = p.get(field, p.get("client_stats", {}).get(field))
        jv = j.get(field, j.get("client_stats", {}).get(field))
        assert (pv is None) == (jv is None)
        if pv is not None and field == "quant_mse":
            # The broadcast's dither hashes the aggregate's bits, and QAT
            # training agrees only at rtol 1e-4 (tests/test_torch_keychain
            # .py), so a run's realized error is another draw:
            # test_quant_mse_matches_jax holds it on one aggregate.
            assert 0.0 < pv < 1e-3 and 0.0 < jv < 1e-3
            seen += 1
        elif pv is not None:
            np.testing.assert_allclose(pv, jv, rtol=1e-4)
            seen += 1
    assert seen
    if algo == "sign_SGD":
        assert all(0.5 <= h["client_stats"][field] <= 1.0
                   and "flagged_clients" not in h["client_stats"]
                   for h in pres["history"])


def test_probe_coordinates_are_the_jax_leaf_strides():
    """The probe strides each leaf's segment of the flat vector as the JAX
    package strides each leaf."""
    import jax.numpy as jnp
    import torch

    numels = (10, 3, 7, 1)
    cs, jcs_ = ClientStats(probe=4), jcs.ClientStats(probe=4)
    rng = np.random.default_rng(1)
    base = rng.normal(size=sum(numels)).astype(np.float32)
    new = rng.normal(size=sum(numels)).astype(np.float32)
    splits = np.cumsum(numels)[:-1]
    tree = lambda v: [jnp.asarray(a) for a in np.split(v, splits)]  # noqa
    want = np.asarray(jcs_.probe_delta(tree(base), tree(new)))
    got = cs.probe_delta(torch.from_numpy(base), torch.from_numpy(new),
                         numels).numpy()
    np.testing.assert_array_equal(got, want)
    assert cs.probe_size(numels) == want.size
    assert client_stats.PER_CLIENT_CAP == jcs.PER_CLIENT_CAP
    assert STAT_FIELDS == jcs.STAT_FIELDS


def test_quant_mse_matches_jax(tiny_config):
    """fed_quant's ``quant_mse`` on one aggregate and broadcast key: the
    port's hook against the JAX package's jitted hook, rtol 1e-4."""
    import jax
    import torch

    from distributed_learning_simulator_tpu.algorithms.fed_quant import (
        FedQuant as JaxFedQuant,
    )
    from distributed_learning_simulator_tpu_torch.algorithms.fed_quant import (
        FedQuant,
    )
    from distributed_learning_simulator_tpu_torch.ops import prng
    from distributed_learning_simulator_tpu_torch.ops.quantize import Segments

    cfg = dataclasses.replace(tiny_config, distributed_algorithm="fed_quant",
                              client_stats="on")
    numels = (300, 20, 64, 1)
    rng = np.random.default_rng(3)
    flat = rng.normal(size=sum(numels)).astype(np.float32)
    tree = {f"w{i}": a for i, a in enumerate(
        np.split(flat, np.cumsum(numels)[:-1]))}
    key = prng.key(11)
    _, jaux = jax.jit(JaxFedQuant(cfg).process_aggregated)(
        tree, jax.random.wrap_key_data(key))
    alg = FedQuant(port_config(cfg))
    alg.segments = Segments(numels)
    _, aux = alg.process_aggregated(torch.from_numpy(flat),
                                    prng.leaf_salts(key, len(numels)))
    np.testing.assert_allclose(float(aux["quant_mse"]),
                               float(jaux["quant_mse"]), rtol=1e-4)
    assert float(aux["quant_mse"]) > 0.0
    off = FedQuant(port_config(cfg, client_stats="off"))
    off.segments = alg.segments
    assert off.process_aggregated(torch.from_numpy(flat),
                                  prng.leaf_salts(key, 4))[1] == {}
