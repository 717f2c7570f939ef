"""SIGTERM under multi-process runs (two gloo ranks on the CPU), held
against the JAX package's preemption block (simulator.py
``run_simulation``, ``if preempt["flag"]``).

The signal comes through the chaos hook (robustness/chaos.py:
``DLS_CRASH_AT_ROUND=0 DLS_CRASH_KIND=sigterm``), on both ranks or on one.
Each rank counts its ``torch.distributed`` collectives and its
``Blocks.full`` calls, and notes both counts when the SIGTERM handler
runs: nothing after the flag may join a collective, since a peer that
never got the signal would not join it.

* Streamed residency over the distributed shard store (``_STATEFUL``'s
  hashed half cohort with momentum state, a checkpoint every 2 rounds):
  no off-cadence shard or manifest, the JAX warning word for word, exit
  0. Both ranks signalled: against the JAX package's two-process run of
  the same configuration (its text, its empty checkpoint directory).
  Rank 0 alone: it exits 0 while its peer waits in the next round's
  exchange; the test then kills the peer.
* Resident ``fed`` without client state (pipelined rounds, the signal
  after round 0's deferred finalize, so round 1 is the one preempted): only
  process 0 writes ``round_1.ckpt``, process 1 logs the JAX package's
  "no checkpoint_dir configured" text (its condition includes
  ``is_primary``); against the JAX package's two-process run, checkpoint
  contents included. Rank 0 alone writes the same file and exits.
* Resident ``fed`` with per-client momentum state: process 0 cannot write
  the whole client state without gathering the other rank's block, and
  raises, as the JAX package's ``device_get`` of a non-addressable array
  does (a JAX run of it blocks at exit until its coordination service
  gives up, minutes: held against its text instead). No rank gathers.
  Both ranks log ``pipeline_rounds disabled`` (the JAX package only on
  process 0: the port checkpoints on every process, a deliberate
  difference, ROADMAP queue 3).
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest

from distributed_learning_simulator_tpu.utils import checkpoint as jckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 120
TINY = dict(
    dataset_name="synthetic", model_name="mlp", distributed_algorithm="fed",
    worker_number=8, round=2, epoch=1, learning_rate=0.1, n_train=256,
    n_test=128, log_level="INFO")
STATEFUL = dict(momentum=0.9, reset_client_optimizer=False)
STREAMED = dict(STATEFUL, client_residency="streamed",
                participation_fraction=0.5, participation_sampler="hashed",
                seed=6, checkpoint_every=2)
RESIDENT = dict(round=3, checkpoint_every=5)
SIGTERM_R0 = {"DLS_CRASH_AT_ROUND": "0", "DLS_CRASH_KIND": "sigterm"}
# The JAX package's texts (simulator.py, its preemption block).
SHARDED_TEXT = (
    "preempted at round {} (SIGTERM): sharded checkpoints persist on the "
    "checkpoint_every cadence only (last committed manifest is the resume "
    "point); exiting cleanly")
WRITTEN_TEXT = (
    "preempted at round {} (SIGTERM): final checkpoint {} written; exiting "
    "cleanly — resume with config.resume=True")
NO_DIR_TEXT = (
    "preempted at round {} (SIGTERM): no checkpoint_dir configured, exiting "
    "cleanly without persisting")
PIPELINE_OFF_TEXT = (
    "pipeline_rounds disabled: checkpointing needs per-client/"
    "server-optimizer state that round r+1's dispatch would donate away")

_PORT_CODE = textwrap.dedent("""
    import json
    import signal
    import sys

    import torch.distributed as dist

    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )
    from distributed_learning_simulator_tpu_torch.parallel import mesh
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    counts = {"collectives": 0, "blocks_full": 0}
    at_flag = {}

    def counted(fn, key):
        def wrapped(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in ("all_gather", "all_gather_object", "all_gather_into_tensor",
                 "all_reduce", "all_to_all", "barrier", "broadcast",
                 "broadcast_object_list", "gather", "reduce",
                 "reduce_scatter", "scatter", "monitored_barrier"):
        setattr(dist, name, counted(getattr(dist, name), "collectives"))
    mesh.Blocks.full = counted(mesh.Blocks.full, "blocks_full")
    install = signal.signal

    def spy(signum, handler):
        if signum == signal.SIGTERM and callable(handler):
            def on_sigterm(s, frame):
                at_flag.setdefault("counts", dict(counts))
                handler(s, frame)
            return install(signum, on_sigterm)
        return install(signum, handler)

    signal.signal = spy
    addr, pid, fields = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
    config = ExperimentConfig(
        **fields, multihost=True, coordinator_address=addr,
        num_processes=2, process_id=pid, mesh_devices=2, device="cpu")
    try:
        res = run_simulation(config, setup_logging=False)
    except RuntimeError as e:
        print("RESULT " + json.dumps({"error": str(e), "at_flag": at_flag,
                                      "counts": counts}), flush=True)
        raise
    print("RESULT " + json.dumps({
        "preempted_at": res["preempted_at"],
        "rounds": [h["round"] for h in res["history"]],
        "test_loss": [h["test_loss"] for h in res["history"]],
        "client_state_is_none": res["client_state"] is None,
        "at_flag": at_flag, "counts": counts}), flush=True)
""")

_JAX_CODE = textwrap.dedent("""
    import json
    import sys

    import jax
    jax.config.update("jax_platforms", "cpu")
    from distributed_learning_simulator_tpu.config import ExperimentConfig
    from distributed_learning_simulator_tpu.simulator import run_simulation

    addr, pid, fields = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
    config = ExperimentConfig(
        **fields, multihost=True, coordinator_address=addr,
        num_processes=2, process_id=pid, mesh_devices=2)
    res = run_simulation(config, setup_logging=False)
    print("RESULT " + json.dumps({
        "preempted_at": res["preempted_at"],
        "rounds": [h["round"] for h in res["history"]],
        "test_loss": [h["test_loss"] for h in res["history"]]}), flush=True)
""")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(code: str, fields: dict, env=(None, None)) -> list:
    """Both ranks of ``code`` on ``fields`` (``env[i]`` merged into rank
    i's environment), started at once."""
    addr = f"127.0.0.1:{_free_port()}"
    procs = []
    for i in range(2):
        e = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        e.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2", **(env[i] or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, addr, str(i), json.dumps(fields)],
            cwd=REPO, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return procs


def _finish(procs: list, wait_for=(0, 1)) -> list:
    """Each rank's ``(rc, result or None, stderr, seconds)``. Only the
    ranks of ``wait_for`` are waited for; as soon as they have exited the
    others are killed (a peer waiting in a collective that the signalled
    rank left never returns), and every rank is killed at the timeout."""
    t0 = time.monotonic()
    deadline = t0 + LAUNCH_TIMEOUT_S
    ended = {}
    while any(i not in ended for i in wait_for):
        for i in wait_for:
            if i not in ended and procs[i].poll() is not None:
                ended[i] = time.monotonic() - t0
        if time.monotonic() > deadline:
            for p in procs:
                p.kill()
                p.communicate()
            pytest.fail(f"a rank ran past {LAUNCH_TIMEOUT_S}s; both killed")
        time.sleep(0.05)
    outs = []
    for i, p in enumerate(procs):
        if i not in wait_for:
            p.kill()
        out, err = p.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        outs.append((p.returncode, json.loads(lines[0][7:]) if lines
                     else None, err, ended.get(i)))
    return outs


def _warnings(err: str) -> list[str]:
    return [ln[ln.index("preempted at round"):]
            for ln in err.splitlines() if "preempted at round" in ln]


def _pipeline_lines(err: str) -> list[str]:
    return [ln[ln.index("pipeline_rounds disabled"):]
            for ln in err.splitlines() if "pipeline_rounds disabled" in ln]


def _assert_nothing_after_flag(res: dict) -> None:
    """The SIGTERM handler ran, and no collective and no ``Blocks.full``
    came after it."""
    assert res["at_flag"], res
    assert res["counts"] == res["at_flag"]["counts"], res


def _assert_peer_stopped(out) -> None:
    """The unsignalled peer never finished its run: it was killed waiting
    in a collective, or that collective failed once the signalled rank's
    process was gone."""
    rc, res, err, _ = out
    assert rc != 0 and (res is None or "error" in res), (rc, res, err[-3000:])


def _files(path: str) -> list[str]:
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


@pytest.fixture(scope="module")
def both_signalled(tmp_path_factory):
    """Every both-ranks case of the port and the JAX package's runs of the
    same configurations, started together (the JAX runs take ~10 s of
    coordination-service set-up each) and collected in turn."""
    root = tmp_path_factory.mktemp("preempt")
    cases = {
        "streamed": (STREAMED, True),
        "resident": (RESIDENT, True),
        "resident_stateful": (dict(RESIDENT, **STATEFUL), False),
    }
    started = {}
    for name, (changes, with_jax) in cases.items():
        for pkg in ("port", "jax") if with_jax else ("port",):
            ckpt = str(root / f"{pkg}_{name}")
            fields = dict(TINY, **changes, checkpoint_dir=ckpt)
            if pkg == "jax":
                fields["log_level"] = "INFO"
            started[(pkg, name)] = (
                _start(_PORT_CODE if pkg == "port" else _JAX_CODE, fields,
                       env=(SIGTERM_R0, SIGTERM_R0)), ckpt)
    return {key: (_finish(procs), ckpt)
            for key, (procs, ckpt) in started.items()}


def test_streamed_both_ranks_as_jax(both_signalled):
    outs, ckpt = both_signalled[("port", "streamed")]
    jouts, jckpt_dir = both_signalled[("jax", "streamed")]
    for (rc, res, err, _), (jrc, jres, jerr, _) in zip(outs, jouts):
        assert rc == 0 and res is not None, err[-3000:]
        assert jrc == 0 and jres is not None, jerr[-3000:]
        assert res["preempted_at"] == jres["preempted_at"] == 0
        assert res["rounds"] == jres["rounds"] == [0]
        assert _warnings(err) == _warnings(jerr) == [SHARDED_TEXT.format(0)]
        _assert_nothing_after_flag(res)
    # Nothing off the cadence (round 0 is not on it), in either package.
    assert _files(ckpt) == _files(jckpt_dir) == []


def test_streamed_rank0_alone_exits_without_its_peer(tmp_path):
    ckpt = str(tmp_path / "shards")
    outs = _finish(_start(_PORT_CODE, dict(TINY, **STREAMED,
                                           checkpoint_dir=ckpt),
                          env=(SIGTERM_R0, None)), wait_for=(0,))
    rc, res, err, seconds = outs[0]
    assert rc == 0 and res is not None, err[-3000:]
    assert res["preempted_at"] == 0 and res["rounds"] == [0]
    assert _warnings(err) == [SHARDED_TEXT.format(0)]
    _assert_nothing_after_flag(res)
    _assert_peer_stopped(outs[1])
    assert _files(ckpt) == []
    assert seconds < LAUNCH_TIMEOUT_S


def test_resident_both_ranks_as_jax(both_signalled):
    outs, ckpt = both_signalled[("port", "resident")]
    jouts, jckpt_dir = both_signalled[("jax", "resident")]
    for r, ((rc, res, err, _), (jrc, jres, jerr, _)) in enumerate(
            zip(outs, jouts)):
        assert rc == 0 and res is not None, err[-3000:]
        assert jrc == 0 and jres is not None, jerr[-3000:]
        # Pipelined in both: the signal after round 0's deferred finalize,
        # round 1 already dispatched.
        assert _pipeline_lines(err) == _pipeline_lines(jerr) == []
        assert res["preempted_at"] == jres["preempted_at"] == 1
        assert res["rounds"] == jres["rounds"] == [0, 1]
        np.testing.assert_allclose(res["test_loss"], jres["test_loss"],
                                   rtol=1e-4)
        want = (WRITTEN_TEXT.format(1, os.path.join(jckpt_dir,
                                                     "round_1.ckpt"))
                if r == 0 else NO_DIR_TEXT.format(1))
        assert _warnings(jerr) == [want]
        assert _warnings(err) == [want.replace(jckpt_dir, ckpt)]
        _assert_nothing_after_flag(res)
    # Process 0 alone wrote the forced checkpoint, off the cadence.
    assert _files(ckpt) == _files(jckpt_dir) == ["round_1.ckpt"]
    port = jckpt.load_checkpoint(os.path.join(ckpt, "round_1.ckpt"))
    ref = jckpt.load_checkpoint(os.path.join(jckpt_dir, "round_1.ckpt"))
    assert port["round_idx"] == ref["round_idx"] == 1
    assert port["client_state"] is None and ref["client_state"] is None
    keys = [jax.random.key_data(c["rng_key"])
            if jax.dtypes.issubdtype(c["rng_key"].dtype, jax.dtypes.prng_key)
            else c["rng_key"] for c in (port, ref)]
    np.testing.assert_array_equal(np.asarray(keys[0]), np.asarray(keys[1]))
    leaves = [np.concatenate([np.asarray(v).ravel() for v in
                              jax.tree_util.tree_leaves(c["global_params"])])
              for c in (port, ref)]
    np.testing.assert_allclose(leaves[0], leaves[1], rtol=1e-5, atol=1e-6)


def test_resident_rank0_alone_writes_and_exits(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    outs = _finish(_start(_PORT_CODE, dict(TINY, **RESIDENT,
                                           checkpoint_dir=ckpt),
                          env=(SIGTERM_R0, None)), wait_for=(0,))
    rc, res, err, _ = outs[0]
    assert rc == 0 and res is not None, err[-3000:]
    assert res["preempted_at"] == 1 and res["rounds"] == [0, 1]
    path = os.path.join(ckpt, "round_1.ckpt")
    assert _warnings(err) == [WRITTEN_TEXT.format(1, path)]
    _assert_nothing_after_flag(res)
    _assert_peer_stopped(outs[1])
    assert _files(ckpt) == ["round_1.ckpt"]
    assert jckpt.load_checkpoint(path)["round_idx"] == 1


def test_resident_client_state_refused_without_a_gather(both_signalled):
    outs, ckpt = both_signalled[("port", "resident_stateful")]
    (rc0, res0, err0, _), (rc1, res1, err1, _) = outs
    # Process 0 raises where the JAX package's device_get raises.
    assert rc0 != 0 and res0 is not None and "error" in res0, err0[-3000:]
    assert "spans processes of the client-axis mesh" in res0["error"]
    assert _warnings(err0) == []
    _assert_nothing_after_flag(res0)
    # Process 1 takes the JAX package's branch for a process other than 0.
    assert rc1 == 0 and res1 is not None, err1[-3000:]
    assert res1["preempted_at"] == 0
    # Its state's other block lives on process 0: not gathered, None.
    assert res1["client_state_is_none"]
    assert _warnings(err1) == [NO_DIR_TEXT.format(0)]
    _assert_nothing_after_flag(res1)
    # The JAX text on process 0; the port logs it on every process.
    assert _pipeline_lines(err0) == _pipeline_lines(err1) == [
        PIPELINE_OFF_TEXT]
    assert _files(ckpt) == []
