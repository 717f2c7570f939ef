"""Streamed residency across two gloo ranks on the CPU (the distributed
shard store: data/residency.py ``DistributedShardStore``,
parallel/streaming.py ``DistributedCohortStreamer``, the sharded
checkpoints of utils/checkpoint.py), the counterparts of the JAX package's
tests/test_multihost.py streamed cases.

The tiny MLP of those tests, 8 clients, 3 rounds, ``mesh_devices=2``;
each rank is launched with ``OMP_NUM_THREADS=2`` and killed, with its
peer, at its own timeout.

* ``_STATEFUL`` ``fed`` (momentum state, a hashed half cohort: both
  exchange directions and real shards; rounds 1 and 2 each spill a
  client that trained before): the ranks agree exactly, own
  complementary halves of the population, and their histories (cohort
  hashes exact) are within 1e-4 of the port's one-process streamed run,
  its resident run and the JAX package's one-process streamed run, each at
  the same global mesh of two (CPU slots). Observed: the test losses
  bitwise the port's one-process runs (the owner permutation moves only
  the summation order).
* Full-cohort ``sign_SGD``: bitwise the one-process streamed run at the
  same mesh, with no spill row and no exchanged byte.
* Rank 1 SIGKILLed right after round 1's shard: the resumed run stitches
  bitwise into the uninterrupted one; a manifest edited to three hosts is
  refused on both ranks with the JAX package's text.
* The straggler: rank 1 slowed 200 ms before every exchange
  (``DLS_STRAGGLE_S``) is named the slowest host of every spill wait by
  the JAX package's unchanged scripts/trace_timeline.py, rank 0 carries
  the wait, and process 0's records are v12 with the skew (and v11's
  ``multihost`` sub-object inside, valid against the schema).
"""

import glob
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import jsonschema
import pytest

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run,
)
from distributed_learning_simulator_tpu.utils import checkpoint as jckpt
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.simulator import run_simulation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 150
TINY = dict(
    dataset_name="synthetic", model_name="mlp", distributed_algorithm="fed",
    worker_number=8, round=3, epoch=1, learning_rate=0.1, n_train=256,
    n_test=128, log_level="ERROR")
# Seed 6: rounds 1 and 2 each spill a client that trained in an earlier
# round (client 5 both times), so both exchange directions carry state of
# a client's own, not the initial state every client starts from.
STATEFUL = dict(momentum=0.9, reset_client_optimizer=False,
                participation_fraction=0.5, participation_sampler="hashed",
                seed=6)
SIGN = dict(distributed_algorithm="sign_SGD", learning_rate=0.01)
KEYS = ("round", "test_accuracy", "test_loss", "mean_client_loss",
        "cohort_hash")

_CODE = textwrap.dedent("""
    import json
    import sys

    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )
    from distributed_learning_simulator_tpu_torch.parallel import streaming
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    # Each round's cohort in draw order and the clients that spill.
    plans, plan = [], streaming.DistributedCohortStreamer.plan

    def recorded(self, idx):
        ex = plan(self, idx)
        plans.append({"idx": ex.idx.tolist(),
                      "spill_ids": ex.plan.spill_ids.tolist()})
        return ex

    streaming.DistributedCohortStreamer.plan = recorded
    addr, pid, fields = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
    setup = fields.pop("setup_logging", False)
    config = ExperimentConfig(
        **fields, multihost=True, coordinator_address=addr,
        num_processes=2, process_id=pid, mesh_devices=2,
        client_residency="streamed", device="cpu")
    try:
        res = run_simulation(config, setup_logging=setup)
    except RuntimeError as e:
        print("RESULT " + json.dumps({"error": str(e)}))
        sys.exit(0)
    print("RESULT " + json.dumps({
        "history": [{k: h[k] for k in %r if k in h}
                    for h in res["history"]],
        "multihost_summary": res["multihost_summary"],
        "stream_dcn_bytes": res["stream_dcn_bytes"],
        "span_summary": res["span_summary"],
        "plans": plans,
    }))
""" % (KEYS,))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(fields: dict, env=(None, None), expect_ok: bool = True):
    """Both ranks of ``_CODE`` on ``fields``; ``env[i]`` is merged into
    rank i's environment. Returns ``[(rc, result or None, stderr)]``. A
    rank still running at the timeout (blocked on a collective whose peer
    died) is killed, and so is its peer."""
    addr = f"127.0.0.1:{_free_port()}"
    procs = []
    for i in range(2):
        e = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
                 **(env[i] or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CODE, addr, str(i), json.dumps(fields)],
            cwd=REPO, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=LAUNCH_TIMEOUT_S)
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("RESULT ")]
            outs.append((p.returncode,
                         json.loads(lines[0][7:]) if lines else None, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank ran past {LAUNCH_TIMEOUT_S}s; both killed")
    if expect_ok:
        for i, (rc, res, err) in enumerate(outs):
            assert rc == 0 and res is not None and "error" not in res, (
                i, res, err[-3000:])
    return outs


def _history(result) -> list[dict]:
    return [{k: h[k] for k in KEYS if k in h} for h in result["history"]]


def _assert_close(got, want, bitwise=False):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["round"] == b["round"]
        assert a.get("cohort_hash") == b.get("cohort_hash"), (a, b)
        for k in ("test_accuracy", "test_loss", "mean_client_loss"):
            if bitwise:
                assert a[k] == b[k], (k, a, b)
            else:
                assert abs(a[k] - b[k]) <= 1e-4 * max(abs(b[k]), 1.0), (
                    k, a, b)


def _one_process(**changes):
    """The one-process reference at the same global mesh (two CPU
    slots), as the JAX package's tests take it."""
    return _history(run_simulation(ExperimentConfig(
        **dict(TINY, **changes), mesh_devices=2, device="cpu"),
        setup_logging=False))


@pytest.fixture(scope="module")
def stateful(tmp_path_factory):
    """The ``_STATEFUL`` two-rank run, checkpointing every round."""
    ckpt = str(tmp_path_factory.mktemp("stateful") / "shards")
    outs = _launch(dict(TINY, **STATEFUL, checkpoint_dir=ckpt,
                        checkpoint_every=1))
    return [res for _, res, _ in outs], ckpt


def test_stateful_ranks_agree_and_own_halves(stateful):
    (r0, r1), ckpt = stateful
    assert r0["history"] == r1["history"]
    sums = [r0["multihost_summary"], r1["multihost_summary"]]
    assert [s["host_id"] for s in sums] == [0, 1]
    assert all(s["hosts"] == 2 for s in sums)
    assert sum(s["owned_clients"] for s in sums) == 8
    assert sums[0]["spill_rows"] == sums[1]["spill_rows"]
    # Rounds 1 and 2 each spill a client that trained before: its state
    # crosses forward, and round 2's came home through round 1's
    # writeback exchange.
    plans = r0["plans"]
    assert plans == r1["plans"] and len(plans) == 3
    seen = set(plans[0]["idx"])
    for p in plans[1:]:
        assert set(p["spill_ids"]) & seen, plans
        seen |= set(p["idx"])
    assert r0["stream_dcn_bytes"] == sums[0]["dcn_bytes"]
    # A shard a rank and a manifest a round.
    for r in range(3):
        assert os.path.exists(os.path.join(ckpt, f"round_{r}.manifest.json"))
        for h in range(2):
            assert os.path.exists(os.path.join(
                ckpt, f"round_{r}.host{h}-of-2.ckptshard"))


@pytest.mark.parametrize("reference", ["port_streamed", "port_resident",
                                       "jax_streamed"])
def test_stateful_matches_one_process(stateful, reference):
    (r0, _), _ = stateful
    if reference == "jax_streamed":
        want = _history(jax_run(JaxConfig(
            **TINY, **STATEFUL, client_residency="streamed",
            mesh_devices=2), setup_logging=False))
    else:
        want = _one_process(**STATEFUL, client_residency=reference[5:])
    _assert_close(r0["history"], want)


def test_full_cohort_sign_sgd_bitwise_without_spill():
    (_, r0, _), (_, r1, _) = _launch(dict(TINY, **SIGN))
    assert r0["history"] == r1["history"]
    for r in (r0, r1):
        assert r["multihost_summary"]["spill_rows"] == 0
        assert r["multihost_summary"]["dcn_bytes"] == 0
        assert r["stream_dcn_bytes"] == 0
    _assert_close(r0["history"],
                  _one_process(**SIGN, client_residency="streamed"),
                  bitwise=True)


def test_sigkill_resume_stitches_bitwise(stateful, tmp_path):
    (ref, _), _ = stateful
    ckpt = str(tmp_path / "shards")
    base = dict(TINY, **STATEFUL, checkpoint_dir=ckpt, checkpoint_every=1)
    outs = _launch(base, env=(None, {"DLS_CRASH_AT_ROUND": "1",
                                     "DLS_CRASH_KIND": "sigkill"}),
                   expect_ok=False)
    # Rank 1 killed; rank 0's next collective raised (reported, exit 0).
    assert outs[1][0] != 0 and "error" in outs[0][1], [o[:2] for o in outs]
    assert os.path.exists(os.path.join(ckpt, "round_1.manifest.json"))
    (_, a, _), (_, b, _) = _launch(dict(base, resume=True))
    assert a["history"] == b["history"]
    assert [h["round"] for h in a["history"]] == [2]
    assert a["history"] == ref["history"][2:]


def test_topology_mismatch_refused_on_both_ranks(stateful, tmp_path):
    _, src = stateful
    ckpt = str(tmp_path / "shards")
    shutil.copytree(src, ckpt)
    path = os.path.join(ckpt, "round_2.manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["n_hosts"] = 3
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(RuntimeError) as jerr:
        jckpt.load_latest_valid_sharded_checkpoint(ckpt, 0, 2)
    outs = _launch(dict(TINY, **STATEFUL, checkpoint_dir=ckpt,
                        checkpoint_every=1, resume=True), expect_ok=False)
    for rc, res, err in outs:
        assert rc == 0 and res is not None, err[-3000:]
        assert res["error"] == str(jerr.value)


def _load_stitcher():
    spec = importlib.util.spec_from_file_location(
        "trace_timeline", os.path.join(REPO, "scripts", "trace_timeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_straggler_named_in_every_spill_wait(tmp_path):
    span_dir, art = str(tmp_path / "spans"), str(tmp_path / "art")
    (_, r0, _), (_, r1, _) = _launch(
        dict(TINY, **STATEFUL, span_trace="on", span_dir=span_dir,
             log_root=art, setup_logging=True),
        env=(None, {"DLS_STRAGGLE_S": "0.2"}))
    assert r0["history"] == r1["history"]
    assert r0["span_summary"]["spill_skew_ms_max"] > 100.0
    tt = _load_stitcher()
    journals = [tt.load_journal(p) for p in tt.find_journals([span_dir])]
    assert [j["header"]["host_id"] for j in journals] == [0, 1]
    summary = tt.summarize(journals)
    spill = [entry for rnd in summary["rounds"].values()
             for name, entry in rnd.items() if name == "spill_wait"]
    assert spill, summary["rounds"]
    assert all(e["slowest_host"] == 1 for e in spill), spill
    assert max(e["skew_ms"] for e in spill) > 100.0, spill
    assert (summary["totals"]["0"]["dcn_wait_s"]
            > summary["totals"]["1"]["dcn_wait_s"]), summary["totals"]
    (path,) = glob.glob(os.path.join(art, "**", "metrics.jsonl"),
                        recursive=True)
    with open(path) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(REPO, "tests", "data",
                           "metrics_record.schema.json")) as f:
        schema = json.load(f)
    assert [r["schema_version"] for r in records] == [12] * 3
    for r in records:
        jsonschema.validate(r, schema)
        assert r["multihost"]["hosts"] == 2 and r["multihost"]["host_id"] == 0
    # The per-round exchange bytes add up to the run's.
    assert sum(r["multihost"]["dcn_bytes"] for r in records) == (
        r0["stream_dcn_bytes"])
    assert sum(r["multihost"]["spill_rows"] for r in records) == (
        r0["multihost_summary"]["spill_rows"])
    skews = [r["spans"].get("spill_skew_ms") for r in records]
    assert any(s is not None and s > 100.0 for s in skews), skews


def _chip_smoke_stream_config(chip_smoke, monkeypatch, work):
    """chip_smoke.py's ``multihost_stream`` at the tiny MLP on the CPU (no
    kernel: 0 launches predicted and counted)."""
    monkeypatch.setattr(chip_smoke, "GN_PER_FORWARD", 0)
    monkeypatch.setattr(chip_smoke, "WGRAD_PER_STEP", 0)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    # STATEFUL's seed spills into round 1 a client trained in round 0.
    return ExperimentConfig(**dict(
        TINY, **STATEFUL, client_residency="streamed", batch_size=16,
        max_shard_size=32, client_chunk_size=2, round=2,
        bucket_client_work=False, span_trace="on",
        log_root=os.path.join(work, "log")), device="cpu")


def test_chip_smoke_multihost_stream_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's ``multihost_stream`` phase, whole, on two CPU ranks
    of the tiny MLP (no kernel: 0 launches predicted and counted)."""
    import chip_smoke

    work = str(tmp_path / "work")
    config = _chip_smoke_stream_config(chip_smoke, monkeypatch, work)
    import torch

    out = chip_smoke.multihost_stream(torch, work, config)
    r0, r1 = out["ranks"]["rank0"], out["ranks"]["rank1"]
    assert r0["digests"] == r1["digests"] and len(r0["digests"]) == 2
    assert out["predicted_train_launches"] == {
        "gn_stats": 0, "gn_normalize": 0, "conv3x3_wgrad": 0}
    assert out["round0_state_bitwise"]
    # Round 1's received state: every cohort row checked, none differs.
    received = out["round1_received_state"]
    assert received["rows"] == 4 and received["mismatched"] == []
    assert received["trained_exchanged"] >= 1
    # The one-process run on the ranks' owner-grouped rows: bitwise.
    assert out["witness_bitwise"]
    assert out["spread"]["witness"] == out["spread"]["ranks"]
    assert [e["spill_rows"] for e in out["exchange"]] == [
        m["spill_rows"] for m in r1["multihost"]]
    assert all(e["dcn_wait_s"][0] >= 0 for e in out["exchange"])


def test_chip_smoke_multihost_preempt_beside_the_witness_on_the_cpu(
        tmp_path, monkeypatch):
    """chip_smoke.py's ``main`` runs ``multihost_preempt`` beside
    ``multihost_stream``'s witness: both phases, whole, on CPU ranks of the
    tiny MLP, the preemption phase on a thread of its own and its value
    returned as ``beside``; ``beside`` with ``solo_cards`` is refused
    before any process starts."""
    import threading

    import torch

    import chip_smoke

    work = str(tmp_path / "work")
    config = _chip_smoke_stream_config(chip_smoke, monkeypatch, work)
    preempt_work = str(tmp_path / "preempt")
    threads = []

    def preempt():
        threads.append(threading.current_thread())
        return chip_smoke.multihost_preempt(
            torch, preempt_work,
            chip_smoke.preempt_configs(preempt_work, device="cpu"))

    with pytest.raises(ValueError, match="solo_cards"):
        chip_smoke.multihost_stream(torch, work, config, solo_cards=(0, 1),
                                    beside=preempt)
    assert not threads and not os.path.exists(work)
    out = chip_smoke.multihost_stream(torch, work, config, beside=preempt)
    assert threads and threads[0] is not threading.main_thread()
    assert out["witness_bitwise"] and out["round0_state_bitwise"]
    assert out["round1_received_state"]["mismatched"] == []
    preempted = out["beside"]
    assert sorted(preempted) == ["resident_rank0", "streamed_all",
                                 "streamed_rank0"]
    for run, o in preempted.items():
        streamed = run.startswith("streamed")
        assert o["preempted_at"] == (0 if streamed else 1)
        assert o["files"] == ([] if streamed else ["round_1.ckpt"])
        signalled = o["ranks"] if run.endswith("_all") else o["ranks"][:1]
        assert all(r["rc"] == 0 and r["exit_s"] < chip_smoke.PREEMPT_EXIT_S
                   for r in signalled)
