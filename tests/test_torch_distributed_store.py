"""The distributed shard store of the port (data/residency.py,
parallel/streaming.py ``DistributedCohortStreamer``'s per-rank routing,
utils/checkpoint.py's shards and manifest, the config's refusals), held
against the JAX package's counterparts in one process: the counterpart of
its tests/test_distributed_store.py.

* The owner bounds, the assembly plan (every array), a rank's routing of
  it, and the store (its slice, ``to_local``, the gathers and the scatter
  by global id, its refusals) are numpy copies and must equal the JAX
  package's exactly on seeded inputs.
* Sharded checkpoints: a round trip, the fall-back past a round whose
  manifest never landed or whose shard is missing or corrupt, retention,
  and files each package reads from the other; ``validate_manifest``'s and
  the loader's refusal texts equal the JAX package's.
* The config: every streamed x multihost refusal carries the JAX text, and
  what the JAX package accepts validates.
* The streamer's routing by global id: two ranks' streamers in one
  process, their exchanges met through a thread barrier, on a state that
  differs row by row: each block row holds the data and the state of the
  client the plan puts there, and the writeback returns every row's new
  state to its owner.
* ``draw_pos``: the streamed round called on owner-permuted rows with
  ``draw_pos`` trains every client as the draw-order call does (per-client
  losses bitwise, the same survivors; the aggregate to summation order),
  and as the JAX package's round does on the same inputs (rtol 1e-5).
"""

import dataclasses
import json
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.data import residency as jres
from distributed_learning_simulator_tpu.factory import (
    get_algorithm as jax_get_algorithm,
)
from distributed_learning_simulator_tpu.models import registry as jreg
from distributed_learning_simulator_tpu.parallel import engine as jengine
from distributed_learning_simulator_tpu.parallel import streaming as jstream
from distributed_learning_simulator_tpu.utils import checkpoint as jckpt
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.data import residency as pres
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
from distributed_learning_simulator_tpu_torch.parallel import engine
from distributed_learning_simulator_tpu_torch.parallel import streaming
from distributed_learning_simulator_tpu_torch.simulator import (
    build_client_data,
    run_simulation,
)
from distributed_learning_simulator_tpu_torch.utils import checkpoint as pckpt

PLAN_FIELDS = ("idx", "owners", "draw_pos", "row_of", "spill_q",
               "spill_rows", "spill_owner", "spill_block", "owner_bounds",
               "block_bounds", "slot_in_owner", "slot_in_block", "spill_ids",
               "idx_perm")
EXEC_FIELDS = ("blo", "bhi", "own_rows_rel", "own_ids", "in_rows_rel",
               "in_src_host", "in_src_slot", "out_ids", "out_block",
               "out_slot", "total_spill", "pad_fwd", "pad_back")


def _cohorts():
    """(n, cohort, devices per host, seed): even and uneven splits,
    device-proportional hosts, one host."""
    return [(8, 4, [1, 1], 0), (64, 16, [1, 1], 1), (64, 16, [1, 1, 1, 1], 2),
            (100, 20, [3, 1], 3), (1000, 64, [2, 2, 4], 4),
            (50, 10, [1], 5)]


@pytest.mark.parametrize("n,cohort,devs,seed", _cohorts())
def test_bounds_and_plan_equal_jax(n, cohort, devs, seed):
    ob = pres.host_axis_bounds(n, devs)
    bb = pres.host_axis_bounds(cohort, devs)
    np.testing.assert_array_equal(ob, jres.host_axis_bounds(n, devs))
    np.testing.assert_array_equal(bb, jres.host_axis_bounds(cohort, devs))
    idx = np.random.default_rng(seed).choice(n, cohort, replace=False)
    np.testing.assert_array_equal(pres.owner_of(idx, ob),
                                  jres.owner_of(idx, ob))
    got = pres.plan_owner_assembly(idx, ob, bb)
    want = jres.plan_owner_assembly(idx, ob, bb)
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.send_counts(), want.send_counts())
    np.testing.assert_array_equal(got.recv_counts(), want.recv_counts())
    assert (got.n_hosts, got.cohort) == (want.n_hosts, want.cohort)
    if len(devs) == 1:
        # One host: the identity and no spill.
        np.testing.assert_array_equal(got.draw_pos, np.arange(cohort))
        assert got.spill_q.size == 0
    # Each rank's routing of the plan, as the JAX streamer resolves it.
    for h in range(len(devs)):
        mine = streaming._ExecPlan(got, h)
        theirs = jstream._ExecPlan(want, h)
        for name in EXEC_FIELDS:
            np.testing.assert_array_equal(getattr(mine, name),
                                          getattr(theirs, name),
                                          err_msg=f"host {h} {name}")
    assert streaming._pad_bucket(5) == jstream._pad_bucket(5) == 8
    assert streaming._pad_bucket(0) == jstream._pad_bucket(0) == 1


@pytest.mark.parametrize("bad", ["cover", "hosts", "devices"])
def test_plan_refusals_equal_jax(bad):
    idx = np.arange(4)
    args = {"cover": (idx, [0, 4, 8], [0, 2, 3]),
            "hosts": (idx, [0, 4, 8], [0, 1, 2, 4]),
            "devices": None}[bad]
    if args is None:
        with pytest.raises(ValueError) as jerr:
            jres.host_axis_bounds(8, [1, 0])
        with pytest.raises(ValueError) as perr:
            pres.host_axis_bounds(8, [1, 0])
    else:
        with pytest.raises(ValueError) as jerr:
            jres.plan_owner_assembly(*args)
        with pytest.raises(ValueError) as perr:
            pres.plan_owner_assembly(*args)
    assert str(perr.value) == str(jerr.value)


def _arrays(n, rng):
    return (rng.integers(0, 255, size=(n, 3, 5), dtype=np.uint8),
            rng.integers(0, 10, size=(n, 3)).astype(np.int32),
            rng.integers(0, 2, size=(n, 3)).astype(np.float32),
            rng.integers(1, 4, size=n).astype(np.float32))


@pytest.mark.parametrize("host_id", [0, 1, 2])
def test_store_equals_jax(host_id):
    rng = np.random.default_rng(host_id)
    n, bounds = 12, pres.host_axis_bounds(12, [1, 2, 1])
    x, y, m, sz = _arrays(n, rng)
    lo, hi = int(bounds[host_id]), int(bounds[host_id + 1])
    state = {"mom": rng.normal(size=(hi - lo, 4)).astype(np.float32)}
    stores = [mod.DistributedShardStore(
        x, y, m, sz, state={"mom": state["mom"].copy()}, host_id=host_id,
        owner_bounds=bounds) for mod in (pres, jres)]
    p, j = stores
    assert (p.lo, p.hi, p.n_owned, p.n_hosts, p.n_global) == (
        j.lo, j.hi, j.n_owned, j.n_hosts, j.n_global)
    for a, b in zip(p.gather_data(None), j.gather_data(None)):
        np.testing.assert_array_equal(a, b)
    ids = rng.choice(np.arange(lo, hi), size=min(2, hi - lo), replace=False)
    np.testing.assert_array_equal(p.to_local(ids), j.to_local(ids))
    for a, b in zip(p.gather_data(ids), j.gather_data(ids)):
        np.testing.assert_array_equal(a, b)
    rows = {"mom": rng.normal(size=(ids.size, 4)).astype(np.float32)}
    p.scatter_state(ids, rows)
    j.scatter_state(ids, rows)
    np.testing.assert_array_equal(p.state["mom"], j.state["mom"])
    np.testing.assert_array_equal(p.gather_state(ids)["mom"], rows["mom"])
    assert p.data_bytes() == j.data_bytes()
    assert p.state_bytes() == j.state_bytes()
    # Another rank's client, growth and the valuation vector: the JAX
    # package's refusals, with its texts.
    other = np.array([hi % n])
    for call in (lambda s: s.gather_data(other),
                 lambda s: s.grow(x, y, m, sz),
                 lambda s: s.attach_valuation(np.zeros(n))):
        errs = []
        for s in (p, j):
            with pytest.raises((IndexError, NotImplementedError)) as err:
                call(s)
            errs.append(err.value)
        assert type(errs[0]) is type(errs[1])
        assert str(errs[0]) == str(errs[1])


def test_store_constructor_refusals_equal_jax():
    x, y, m, sz = _arrays(8, np.random.default_rng(0))
    for kw in (dict(host_id=2, owner_bounds=[0, 4, 8]),
               dict(host_id=0, owner_bounds=[0, 4, 9])):
        with pytest.raises(ValueError) as jerr:
            jres.DistributedShardStore(x, y, m, sz, **kw)
        with pytest.raises(ValueError) as perr:
            pres.DistributedShardStore(x, y, m, sz, **kw)
        assert str(perr.value) == str(jerr.value)


# ---- the streamer's routing ---------------------------------------------------


class _Routing:
    """What the streamer asks of its algorithm: the sampler's name and the
    store's state rows."""

    config = types.SimpleNamespace(participation_sampler="hashed")

    def gather_client_state(self, store, idx):
        return store.gather_state(idx)

    def scatter_client_state(self, store, idx, state) -> None:
        store.scatter_state(idx, state)


@pytest.mark.parametrize("from_host0", [5, 2, 4])
def test_streamer_routes_rows_by_global_id(from_host0, monkeypatch):
    """``from_host0`` of the 8 cohort members are rank 0's: 5 spill one
    row into rank 1's block, 2 spill two the other way, 4 spill none."""
    from distributed_learning_simulator_tpu_torch.parallel.mesh import Mesh

    n, cohort, width = 16, 8, 3
    rng = np.random.default_rng(from_host0)
    x, y, m, sz = _arrays(n, rng)
    bounds = pres.host_axis_bounds(n, [1, 1])
    blocks = np.array([0, cohort // 2, cohort])
    # Every client's state differs from every other's.
    mom = rng.normal(size=(n, width)).astype(np.float32)
    idx = rng.permutation(np.concatenate([
        rng.choice(8, from_host0, replace=False),
        8 + rng.choice(8, cohort - from_host0, replace=False)]))
    want = pres.plan_owner_assembly(idx, bounds, blocks)
    np.testing.assert_array_equal(want.idx[want.draw_pos], want.idx_perm)

    # The exchange: each rank's payload meets its peer's at a barrier.
    sent, barrier, me = [None, None], threading.Barrier(2), threading.local()

    def allgather(arrays):
        sent[me.host] = [np.asarray(a) for a in arrays]
        barrier.wait()
        out = [np.stack([sent[0][i], sent[1][i]]) for i in range(len(arrays))]
        barrier.wait()
        return out

    monkeypatch.setattr(streaming, "allgather_rows", allgather)
    like = {"mom": torch.zeros(1, width)}
    stores, got, errors = [], {}, []

    def rank(h):
        try:
            me.host = h
            store = pres.DistributedShardStore(
                x, y, m, sz, state={"mom": mom[bounds[h]:bounds[h + 1]]
                                    .copy()},
                host_id=h, owner_bounds=bounds)
            stores.append(store)
            mesh = Mesh((torch.device("cpu"),) * 2, ranks=(0, 1), rank=h,
                        backend="gloo")
            st = streaming.DistributedCohortStreamer(
                store, _Routing(), n, "cpu", mesh, blocks, sz)
            try:
                ex = st.plan(idx)
                (bx, by, _, bsz, row_ids, draw_pos), _, ex = (
                    st.acquire_plan(ex))
                state = st.gather_state(ex, like)
                ids = row_ids[blocks[h]:blocks[h + 1]]
                new = ids[:, None] * 10.0 + np.arange(width)
                st.writeback(ex, st._blocks(
                    {"mom": torch.from_numpy(new.astype(np.float32))},
                    blocks, cohort))
                got[h] = (ids, bx.parts[h].numpy(), by.parts[h].numpy(),
                          state.parts[h]["mom"].numpy(), row_ids, draw_pos,
                          bsz, ex.total_spill)
            finally:
                st.close()
        except BaseException as e:  # surfaced on the main thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=rank, args=(h,)) for h in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert sorted(got) == [0, 1]
    for h in range(2):
        ids, bx, by, bmom, row_ids, draw_pos, bsz, spill = got[h]
        np.testing.assert_array_equal(row_ids, want.idx_perm)
        np.testing.assert_array_equal(draw_pos, want.draw_pos)
        np.testing.assert_array_equal(bsz, sz[want.idx_perm])
        np.testing.assert_array_equal(
            ids, want.idx_perm[want.block_bounds[h]:want.block_bounds[h + 1]])
        np.testing.assert_array_equal(bx, x[ids])
        np.testing.assert_array_equal(by, y[ids])
        np.testing.assert_array_equal(bmom, mom[ids])
        assert spill == abs(from_host0 - cohort // 2)
    # Every cohort member's new state is home; the others' kept theirs.
    final = np.concatenate([s.state["mom"] for s in
                            sorted(stores, key=lambda s: s.host_id)])
    expect = mom.copy()
    expect[idx] = idx[:, None] * 10.0 + np.arange(width)
    np.testing.assert_array_equal(final, expect)


# ---- sharded checkpoints -----------------------------------------------------


def _shard(mod, d, r, h, value=None):
    mod.save_shard_checkpoint(d, r, h, 2, {
        "global_params": {"w": np.full(3, float(r if value is None
                                                 else value))},
        "client_state": {"mom": np.full((4, 2), float(h), np.float32)},
        "algo_state": {"prev_metrics": {"loss": float(r)}},
        "rng_key": np.asarray([r, h], dtype=np.uint32),
    })


def _manifest(mod, d, r):
    mod.write_manifest(d, r, {"n_hosts": 2, "n_clients": 8,
                              "owner_bounds": [0, 4, 8]})


@pytest.mark.parametrize("writer,reader", [(pckpt, jckpt), (jckpt, pckpt),
                                           (pckpt, pckpt)])
def test_sharded_checkpoint_round_trip(tmp_path, writer, reader):
    d = str(tmp_path)
    for r in (0, 1):
        for h in (0, 1):
            _shard(writer, d, r, h)
        _manifest(writer, d, r)
    assert sorted(os.listdir(d)) == sorted(
        [f"round_{r}.host{h}-of-2.ckptshard" for r in (0, 1)
         for h in (0, 1)] + [f"round_{r}.manifest.json" for r in (0, 1)])
    assert reader.manifest_rounds(d) == writer.manifest_rounds(d)
    for h in (0, 1):
        manifest, payload = reader.load_latest_valid_sharded_checkpoint(
            d, h, 2)
        assert manifest["round"] == 1 and manifest["n_hosts"] == 2
        assert (payload["round_idx"], payload["host_id"],
                payload["n_hosts"]) == (1, h, 2)
        np.testing.assert_array_equal(payload["client_state"]["mom"],
                                      np.full((4, 2), float(h)))
        key = payload["rng_key"]
        if reader is jckpt:  # the JAX loader hands back a typed key
            key = jax.random.key_data(key)
        np.testing.assert_array_equal(np.asarray(key), [1, h])
    # The single-file discovery never sees shards or manifests.
    assert reader.latest_checkpoint(d) is None


def test_sharded_checkpoint_fallback_and_retention(tmp_path):
    d = str(tmp_path)
    for r in (0, 1):
        for h in (0, 1):
            _shard(pckpt, d, r, h)
        _manifest(pckpt, d, r)
    # Round 2: a rank died before the barrier (no manifest).
    _shard(pckpt, d, 2, 0)
    assert pckpt.load_latest_valid_sharded_checkpoint(d, 0, 2)[0][
        "round"] == 1
    # Round 2 committed but rank 1's shard is missing: skipped.
    _manifest(pckpt, d, 2)
    assert pckpt.load_latest_valid_sharded_checkpoint(d, 0, 2)[0][
        "round"] == 1
    # Round 3 whole, but this rank's shard corrupt: skipped.
    for h in (0, 1):
        _shard(pckpt, d, 3, h)
    _manifest(pckpt, d, 3)
    path = pckpt.shard_checkpoint_path(d, 3, 0, 2)
    with open(path, "r+b") as f:
        f.seek(20)
        f.write(b"\x00\xff")
    assert pckpt.load_latest_valid_sharded_checkpoint(d, 0, 2)[0][
        "round"] == 1
    assert pckpt.load_latest_valid_sharded_checkpoint(d, 1, 2)[0][
        "round"] == 3
    removed = pckpt.gc_sharded_checkpoints(d, 1)
    assert {os.path.basename(p) for p in removed} == {
        f"round_{r}.{s}" for r in (0, 1, 2)
        for s in ("manifest.json", "host0-of-2.ckptshard",
                  "host1-of-2.ckptshard")} - {"round_2.host1-of-2.ckptshard"}
    assert [r for r, _ in pckpt.manifest_rounds(d)] == [3]


@pytest.mark.parametrize("kw", [
    dict(n_hosts=3, n_clients=8),
    dict(n_hosts=2, n_clients=16),
    dict(n_hosts=2, n_clients=8, owner_bounds=[0, 6, 8]),
    dict(n_hosts=2, n_clients=8, owner_bounds=[0, 4, 8]),
])
def test_manifest_checks_equal_jax(tmp_path, kw):
    manifest = {"n_hosts": 2, "n_clients": 8, "owner_bounds": [0, 4, 8]}
    errs = []
    for mod in (pckpt, jckpt):
        try:
            mod.validate_manifest(dict(manifest), **kw)
            errs.append(None)
        except RuntimeError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    if kw["n_hosts"] != 2:
        # The loader refuses a host-count change itself, never walking
        # past it to a fresh start.
        d = str(tmp_path)
        for h in (0, 1):
            _shard(pckpt, d, 0, h)
        _manifest(pckpt, d, 0)
        texts = []
        for mod in (pckpt, jckpt):
            with pytest.raises(RuntimeError) as err:
                mod.load_latest_valid_sharded_checkpoint(d, 0, 3)
            texts.append(str(err.value))
        assert texts[0] == texts[1] and "topology mismatch" in texts[0]


def test_one_process_resume_of_a_sharded_dir_refused(tmp_path):
    """A single-process run pointed at a sharded checkpoint directory is
    refused with the JAX package's text instead of starting afresh."""
    ckpt = str(tmp_path / "shards")
    os.makedirs(ckpt)
    pckpt.write_manifest(ckpt, 0, {"n_hosts": 2, "n_clients": 8,
                                   "owner_bounds": [0, 4, 8]})
    kw = dict(
        dataset_name="synthetic", model_name="mlp",
        distributed_algorithm="fed", worker_number=8, round=1, epoch=1,
        learning_rate=0.1, n_train=256, n_test=128, log_level="ERROR",
        client_residency="streamed", participation_fraction=0.5,
        participation_sampler="hashed", checkpoint_dir=ckpt,
        checkpoint_every=1, resume=True)
    from distributed_learning_simulator_tpu.simulator import (
        run_simulation as jax_run,
    )

    with pytest.raises(RuntimeError) as jerr:
        jax_run(JaxConfig(**kw), setup_logging=False)
    with pytest.raises(RuntimeError) as perr:
        run_simulation(ExperimentConfig(device="cpu", **kw),
                       setup_logging=False)
    assert str(perr.value) == str(jerr.value)
    assert "sharded checkpoints" in str(perr.value)


# ---- the config ----------------------------------------------------------------

MH = dict(dataset_name="synthetic", model_name="mlp", worker_number=8,
          multihost=True, client_residency="streamed", mesh_devices=2,
          participation_fraction=0.5, participation_sampler="hashed")


@pytest.mark.parametrize("changes", [
    dict(),
    dict(mesh_devices=None),
    dict(participation_sampler="exact"),
    dict(rounds_per_dispatch=2),
    dict(distributed_algorithm="fed_quant", client_eval=False),
    dict(async_mode="on", arrival_model="bimodal", round_deadline=1.0),
    dict(client_stats="on"),
    dict(client_valuation="on"),
    dict(participation_fraction=1.0, reset_client_optimizer=False),
    dict(participation_fraction=1.0, distributed_algorithm="sign_SGD",
         momentum=0.9),
    dict(participation_fraction=1.0, distributed_algorithm="sign_SGD"),
    dict(population="dynamic", join_rate=1.0),
    dict(participation_fraction=1.0, distributed_algorithm="fed_quant"),
])
def test_config_refusals_equal_jax(changes):
    """Each streamed x multihost composition validates where the JAX
    package's does and is refused with its text where it is not."""
    errs = []
    for cls in (JaxConfig, ExperimentConfig):
        try:
            cls(**dict(MH, **changes)).validate()
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]


# ---- draw_pos ------------------------------------------------------------------


def _draw_pos_setup():
    cfg = ExperimentConfig(
        dataset_name="synthetic", model_name="mlp",
        distributed_algorithm="fed", worker_number=8, round=1, epoch=1,
        learning_rate=0.1, batch_size=16, n_train=256, n_test=128,
        log_level="ERROR", client_residency="streamed",
        participation_fraction=0.5, participation_sampler="hashed",
        failure_mode="dropout", failure_prob=0.3, client_chunk_size=2,
        device="cpu")
    ds = get_dataset("synthetic", n_train=256, n_test=128, seed=0)
    data = build_client_data(cfg, ds)
    return cfg, ds, data


def test_draw_pos_permutes_back_to_draw_order_as_in_jax():
    cfg, ds, data = _draw_pos_setup()
    shape = ds.x_train.shape[1:]
    model = get_model("mlp", num_classes=ds.num_classes, input_shape=shape)
    params = init_params(model, shape[:2], seed=0)
    layout = ParamLayout.from_params(params, jax_leaf_order(model,
                                                            shape[:2]))
    flat = layout.flatten(params)
    algo = get_algorithm("fed", cfg)

    def apply_fn(views, x):
        return torch.func.functional_call(model, views, (x,))

    round_fn = algo.make_round_fn(
        apply_fn, engine.make_optimizer("sgd", 0.1), layout, 8,
        preprocess=(engine.make_decoder(data.sample_shape)
                    if data.compact else None), device="cpu")
    key = prng.key(7)
    idx = np.asarray(algo.cohort_indices(key, 8))
    perm = np.array([2, 0, 3, 1])[: idx.size]

    def call(order, draw_pos):
        take = lambda a: torch.as_tensor(np.take(a, order, axis=0))  # noqa
        return round_fn(
            flat, None, take(data.x), take(data.y).long(), take(data.mask),
            np.take(data.sizes, order), np.asarray(order), key,
            draw_pos=draw_pos)

    g_ref, _, aux_ref = call(idx, None)
    g_perm, _, aux_perm = call(idx[perm], perm)
    ref_loss = aux_ref["client_loss"].numpy()
    perm_loss = aux_perm["client_loss"].numpy()
    np.testing.assert_array_equal(perm_loss, ref_loss[perm])
    assert aux_ref["survivor_count"] == aux_perm["survivor_count"]
    torch.testing.assert_close(g_perm, g_ref, rtol=2e-6, atol=2e-7)

    # The JAX package's streamed round on the same permuted inputs.
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(JaxConfig)
                        if f.name != "cost_model_topology"}).validate()
    jmodel = jreg.get_model("mlp", num_classes=ds.num_classes)
    jparams = jreg.init_params(jmodel, ds.x_train[:1], seed=0)
    jalgo = jax_get_algorithm("fed", jcfg)
    jround = jalgo.make_round_fn(
        jmodel.apply, jengine.make_optimizer("SGD", 0.1), 8,
        preprocess=(jengine.make_decoder(data.sample_shape)
                    if data.compact else None))
    jkey = jax.random.key(7)
    np.testing.assert_array_equal(np.asarray(jalgo.cohort_indices(jkey, 8)),
                                  idx)
    order = idx[perm]
    jtake = lambda a: jnp.asarray(np.take(a, order, axis=0))  # noqa
    _, _, j_aux = jround(
        jparams, None, jtake(data.x), jtake(data.y), jtake(data.mask),
        jtake(data.sizes), jnp.asarray(order, jnp.int32), jkey,
        draw_pos=jnp.asarray(perm, jnp.int32))
    np.testing.assert_allclose(perm_loss, np.asarray(j_aux["client_loss"]),
                               rtol=1e-5)
    assert aux_perm["survivor_count"] == int(j_aux["survivor_count"])


def test_sign_sgd_draw_pos_follows_the_client():
    """sign_SGD's round with permuted client rows and ``draw_pos`` casts
    the same votes as the draw-order round: the same model bitwise."""
    cfg, ds, data = _draw_pos_setup()
    cfg = dataclasses.replace(
        cfg, distributed_algorithm="sign_SGD", learning_rate=0.01,
        participation_fraction=1.0, participation_sampler="exact",
        client_residency="resident", client_chunk_size=None)
    shape = ds.x_train.shape[1:]
    model = get_model("mlp", num_classes=ds.num_classes, input_shape=shape)
    params = init_params(model, shape[:2], seed=0)
    layout = ParamLayout.from_params(params, jax_leaf_order(model,
                                                            shape[:2]))
    flat = layout.flatten(params)

    def apply_fn(views, x):
        return torch.func.functional_call(model, views, (x,))

    round_fn = get_algorithm("sign_SGD", cfg).make_round_fn(
        apply_fn, engine.make_optimizer("sgd", 0.01), layout, 8,
        preprocess=(engine.make_decoder(data.sample_shape)
                    if data.compact else None), device="cpu")
    perm = np.array([5, 2, 7, 0, 1, 6, 3, 4])

    def call(order, draw_pos):
        take = lambda a: torch.as_tensor(np.take(a, order, axis=0))  # noqa
        return round_fn(flat, None, take(data.x), take(data.y).long(),
                        take(data.mask), np.take(data.sizes, order),
                        prng.key(3), draw_pos=draw_pos)

    g_ref, _, aux_ref = call(np.arange(8), None)
    g_perm, _, aux_perm = call(perm, perm)
    assert torch.equal(g_perm, g_ref)
    assert aux_perm["survivor_count"] == aux_ref["survivor_count"]


def test_allgather_rows_without_a_group():
    from distributed_learning_simulator_tpu_torch.parallel.multihost import (
        allgather_rows,
    )

    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.array([[1], [250]], dtype=np.uint8)
    got = allgather_rows([a, b])
    assert [g.shape for g in got] == [(1, 2, 3), (1, 2, 1)]
    np.testing.assert_array_equal(got[0][0], a)
    np.testing.assert_array_equal(got[1][0], b)
    assert json.dumps(got[0].dtype.str) == json.dumps(a.dtype.str)
