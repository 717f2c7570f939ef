"""Multi-process runs of the port over torch.distributed (parallel/
multihost.py, the mesh across processes), against the JAX package.

In process: the single-process no-op initialization, the "refusing to
degrade" failure of explicit flags, the CLI flags (the JAX package's
``tests/test_multihost.py``), the threaded oracle's refusal of multihost
before any process group comes up, and a ``multihost=True`` run in one
process.

Two gloo ranks on the CPU (``_launch_two``, shaped like the JAX package's
launch helper: a free port, a timeout per launch, both ranks killed when
it runs out), ``mesh_devices=2``, one block a rank:

* ``fed`` (then a second run in each process, on the live group),
  ``sign_SGD`` with dropout failures (the masks are drawn from the
  round key on every rank) and GTG: the two ranks' final models bitwise
  equal, their histories (and Shapley values) equal, and the model within
  rtol 1e-5 / atol 1e-6 of the JAX package's single-process
  ``mesh_devices=2`` run, computed here (observed: 6e-8 for ``fed``,
  bitwise for ``sign_SGD`` and GTG);
* divergent checkpoint directories raise "multihost resume mismatch" on
  both ranks, a shared one resumes on both;
* process 1's clock offset against process 0 (one host, one clock) stays
  within its uncertainty plus 5 ms, and each process's span journal
  header carries its process id, the process count and that offset;
* chip_smoke.py's ``multihost_fed`` harness on two CPU ranks.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run,
)
from distributed_learning_simulator_tpu_torch.config import (
    ExperimentConfig,
    get_config,
)
from distributed_learning_simulator_tpu_torch.parallel import multihost
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
from torch_runs import flat_params

TINY = dict(
    dataset_name="synthetic", model_name="mlp", distributed_algorithm="fed",
    worker_number=8, round=2, epoch=1, learning_rate=0.1, batch_size=32,
    n_train=512, n_test=256, log_level="WARNING",
    dataset_args={"difficulty": 0.5},
)
LAUNCH_TIMEOUT_S = 120


def test_single_process_noop():
    assert not multihost.distributed_initialized()
    assert multihost.initialize_multihost() >= 1
    assert not multihost.distributed_initialized()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.estimate_clock_alignment() == (0.0, 0.0)
    np.testing.assert_array_equal(multihost.allgather_int64([3, 4]),
                                  [[3, 4]])


def test_explicit_flags_make_failure_fatal():
    with pytest.raises(RuntimeError, match="refusing to degrade"):
        # num_processes=2 without a coordinator address is unresolvable.
        multihost.initialize_multihost(num_processes=2, process_id=0)
    assert not multihost.distributed_initialized()


def test_multihost_cli_flags_parse():
    cfg = get_config([
        "--multihost", "true",
        "--coordinator_address", "localhost:9999",
        "--num_processes", "2",
        "--process_id", "0",
        "--mesh_devices", "2",
        "--device", "cpu",
    ])
    assert cfg.multihost is True
    assert cfg.coordinator_address == "localhost:9999"
    assert cfg.num_processes == 2
    assert cfg.process_id == 0
    assert cfg.mesh_devices == 2


def test_threaded_multihost_refused_before_the_process_group():
    """The JAX package's text; the flags name a coordinator nobody serves,
    so reaching init_process_group would wait there instead."""
    cfg = ExperimentConfig(
        **dict(TINY, execution_mode="threaded", multihost=True,
               coordinator_address=f"127.0.0.1:{_free_port()}",
               num_processes=2, process_id=1), device="cpu")
    with pytest.raises(ValueError) as err:
        run_simulation(cfg, setup_logging=False)
    assert str(err.value) == (
        "execution_mode='threaded' does not support multihost; "
        "use the vmap execution mode")
    assert not multihost.distributed_initialized()


def test_multihost_flag_in_one_process_runs():
    res = run_simulation(ExperimentConfig(**dict(TINY, multihost=True,
                                                 round=1), device="cpu"),
                         setup_logging=False)
    assert len(res["history"]) == 1 and res["mesh"] is None


# ---- two ranks ---------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_two(code: str, extra_args, timeout: int = LAUNCH_TIMEOUT_S):
    """Run ``code`` in two fresh interpreters against a fresh coordinator
    port (argv: ``addr process_id *extra_args(i)``); returns ``[(rc,
    stdout, stderr), ...]``. A rank still running at ``timeout`` (blocked
    on a collective whose peer died) is killed, and so is its peer."""
    addr = f"127.0.0.1:{_free_port()}"
    repo = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, addr, str(i), *extra_args(i)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank did not finish within {timeout}s; both killed")
    return outs


_TRAIN_CODE = textwrap.dedent("""
    import json
    import sys

    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )
    from distributed_learning_simulator_tpu_torch.parallel.multihost import (
        estimate_clock_alignment,
    )
    from distributed_learning_simulator_tpu_torch.simulator import (
        run_simulation,
    )

    addr, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    fields = json.loads(sys.argv[4])
    second_run = fields.pop("second_run", False)
    config = ExperimentConfig(
        **fields, multihost=True, coordinator_address=addr,
        num_processes=2, process_id=pid, mesh_devices=2, device="cpu")
    try:
        res = run_simulation(config, setup_logging=False)
    except RuntimeError as e:
        print("RESULT " + json.dumps({"error": str(e)}))
        sys.exit(0)
    params = res["global_params"]
    np.save(f"{out}.rank{pid}.npy",
            torch.cat([v.reshape(-1) for v in params.values()]).numpy())
    offset, uncertainty = estimate_clock_alignment()
    again = None
    if second_run:
        # A second run in the process reuses the live group.
        again = run_simulation(config, setup_logging=False)["history"][-1][
            "test_loss"]
    print("RESULT " + json.dumps({
        "names": list(params), "mesh": res["mesh"].describe(),
        "history": [{k: h[k] for k in ("test_accuracy", "test_loss",
                                        "shapley_values") if k in h}
                    for h in res["history"]],
        "clock": [offset, uncertainty], "second_run_loss": again,
    }))
""")

CASES = {
    "fed": dict(second_run=True),
    "sign_SGD_dropout": dict(distributed_algorithm="sign_SGD",
                             learning_rate=0.01, failure_mode="dropout",
                             failure_prob=0.3),
    "GTG_shapley_value": dict(distributed_algorithm="GTG_shapley_value",
                              shapley_eval_samples=64, round=1),
}
_RUNS: dict = {}


def _results(outs) -> list[dict]:
    results = []
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, (i, out, err[-3000:])
        (line,) = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(line[len("RESULT "):]))
    return results


def _two_rank_run(name: str, tmp_root) -> tuple[list[dict], list]:
    """Both ranks' results and final models for ``CASES[name]`` (each
    case launched once per module)."""
    if name not in _RUNS:
        out = str(tmp_root / name)
        fields = dict(TINY, **CASES[name])
        if name == "fed":
            # Span journals, one a process, headed with its clock offset.
            fields.update(span_trace="on", span_dir=str(tmp_root / "spans"))
        results = _results(_launch_two(
            _TRAIN_CODE, lambda i: [out, json.dumps(fields)]))
        models = [np.load(f"{out}.rank{r}.npy") for r in range(2)]
        _RUNS[name] = (results, models)
    return _RUNS[name]


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return tmp_path_factory.mktemp("two_ranks")


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_agree_and_match_jax(name, tmp_root):
    (r0, r1), (m0, m1) = _two_rank_run(name, tmp_root)
    assert r0["mesh"] == r1["mesh"] == {
        "axis": "clients", "devices": ["cpu", "cpu"], "ranks": [0, 1],
        "backend": "gloo"}
    np.testing.assert_array_equal(m0, m1)
    assert r0["history"] == r1["history"]
    changes = dict(CASES[name])
    if changes.pop("second_run", False):
        assert r0["second_run_loss"] == r1["second_run_loss"] == (
            r0["history"][-1]["test_loss"])
    jres = jax_run(JaxConfig(**dict(TINY, **changes, mesh_devices=2)),
                   setup_logging=False)
    want = flat_params(jres, r0["names"])
    torch.testing.assert_close(torch.from_numpy(m0), want, rtol=1e-5,
                               atol=1e-6)
    for hp, hj in zip(r0["history"], jres["history"], strict=True):
        assert abs(hp["test_accuracy"] - hj["test_accuracy"]) <= (
            1.0 / TINY["n_test"])
        if "shapley_values" in hj:
            sv_j = hj["shapley_values"]
            np.testing.assert_allclose(
                [hp["shapley_values"][str(i)] for i in sorted(sv_j)],
                [sv_j[i] for i in sorted(sv_j)], atol=2.0 / 64)


def test_clock_alignment_within_its_uncertainty(tmp_root):
    (r0, r1), _ = _two_rank_run("fed", tmp_root)
    assert r0["clock"][0] == 0.0
    offset, uncertainty = r1["clock"]
    assert uncertainty >= 0.0
    assert abs(offset) <= uncertainty + 5e-3
    # The span journals' headers: the process, the count and the offset
    # each process measured when the run began.
    for host in range(2):
        with open(tmp_root / "spans" / f"spans_{host}.jsonl") as f:
            header = json.loads(f.readline())
        assert header["kind"] == "header"
        assert (header["host_id"], header["n_hosts"]) == (host, 2)
        assert header["clock_uncertainty_s"] > 0.0
        assert abs(header["clock_offset_s"]) <= (
            header["clock_uncertainty_s"] + 5e-3)
        if host == 0:
            assert header["clock_offset_s"] == 0.0


@pytest.mark.parametrize("layout", ["shared", "divergent"])
def test_resume_agreement(layout, tmp_path):
    """A checkpoint every rank sees resumes on both; one rank seeing it
    and the other an empty directory raises on both instead of running
    different rounds."""
    ckpt = tmp_path / "ckpt"
    run_simulation(ExperimentConfig(
        **dict(TINY, round=1, checkpoint_dir=str(ckpt), checkpoint_every=1),
        device="cpu"), setup_logging=False)
    empty = tmp_path / "empty"
    empty.mkdir()
    dirs = [ckpt, ckpt if layout == "shared" else empty]
    config = dict(TINY, round=2, checkpoint_every=1, resume=True)
    results = _results(_launch_two(_TRAIN_CODE, lambda i: [
        str(tmp_path / "out"),
        json.dumps(dict(config, checkpoint_dir=str(dirs[i])))]))
    for r in results:
        if layout == "shared":
            assert "error" not in r and len(r["history"]) == 1
        else:
            assert "multihost resume mismatch" in r["error"]


def test_chip_smoke_rank_workers_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's ``multihost_fed`` harness (``launch_ranks`` over
    ``rank_worker``, the CLI's ``main`` in each rank) on two CPU ranks of
    the tiny MLP: both exit 0, report the gloo mesh, digest the same
    model each round and launch no kernel on the CPU."""
    import chip_smoke

    flags = chip_smoke.cli_flags(ExperimentConfig(
        **dict(TINY, round=1, log_root=str(tmp_path / "log")), device="cpu"))
    address = f"127.0.0.1:{_free_port()}"
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    ranks = chip_smoke.launch_ranks(str(tmp_path), {
        f"rank{r}": flags + [
            "--multihost", "true", "--coordinator_address", address,
            "--num_processes", "2", "--process_id", str(r),
            "--mesh_devices", "2"]
        for r in range(2)}, LAUNCH_TIMEOUT_S)
    r0, r1 = ranks["rank0"], ranks["rank1"]
    assert r0["digests"] == r1["digests"] and len(r0["digests"]) == 1
    assert r0["mesh"]["backend"] == "gloo" and r0["device"] == "cpu"
    assert r0["gathers"]["calls"] >= 1
    assert set(r0["launches"].values()) == {0}
    assert os.path.exists(r0["round0_path"])
