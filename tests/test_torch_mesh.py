"""The port's client-axis mesh (parallel/mesh.py) in one process, against
the JAX package's mesh runs on its forced host devices.

A mesh on the CPU is ``n`` slots of the one CPU device; each block of the
client axis trains its own clients and the blocks' partial sums (or stack
rows) are gathered and combined in block order.

* Every algorithm with ``mesh_devices`` set, the tiny MLP of the JAX tests'
  ``tiny_config`` at 8 (or 16) clients, the JAX run on as many of its 8
  host devices: parameters within rtol 1e-5 / atol 1e-6 and accuracies
  within one test sample. Observed: at most 6e-8 apart and the same
  accuracies for ``fed`` (also chunked with a remainder, under ``median``,
  with persistent client momentum and under partial participation),
  bitwise for ``sign_SGD`` and the Shapley algorithms (the same Shapley
  values). ``fed_quant`` is held to one quantization level instead: a ulp
  of reduction order moves the stochastic quantizer across a level (the
  JAX package's own mesh run is a level from its serial run, as is the
  port's serial run from the JAX serial run: 2.2e-3 after one round).
* The GTG subset mesh walk bitwise equal to the serial walk (Shapley
  values, permutation counts, convergence, the memo's keys and values),
  both prefix modes, full and eps-truncated walks, a chunk below the
  prefix block; the v10 ``gtg`` record of an end-to-end run.
* The JAX texts of the uneven-clients refusal and of the device
  shortfall (a CUDA mesh asking for more cards than there are never runs
  on the CPU); streamed residency and sweeps over a mesh validate as the
  JAX package's do.
* The kernel wrappers launch inside a device guard (mocked: one card
  cannot show a device mismatch).
"""

import contextlib

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.algorithms import shapley as jshap
from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run,
)
from distributed_learning_simulator_tpu_torch.algorithms import shapley
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.ops import gn_cuda, wgrad_cuda
from distributed_learning_simulator_tpu_torch.parallel import mesh as pmesh
from distributed_learning_simulator_tpu_torch.parallel import multihost
from distributed_learning_simulator_tpu_torch.robustness.faults import (
    FailureModel,
)
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
from torch_runs import flat_params, port_config, read_records

TINY = dict(
    dataset_name="synthetic", model_name="mlp", distributed_algorithm="fed",
    worker_number=8, round=2, epoch=1, learning_rate=0.1, batch_size=32,
    n_train=512, n_test=256, log_level="WARNING",
    dataset_args={"difficulty": 0.5},
)

# name -> (config changes, mesh devices)
CASES = {
    "fed": (dict(), 8),
    "fed_chunk_remainder": (dict(worker_number=16, client_chunk_size=5), 8),
    "fed_median": (dict(worker_number=16, aggregation="median",
                        client_chunk_size=4), 8),
    "fed_momentum_state": (dict(momentum=0.9, reset_client_optimizer=False,
                                client_chunk_size=3), 2),
    "fed_partial": (dict(worker_number=16, participation_fraction=0.5,
                         client_chunk_size=4), 8),
    "fed_dropout": (dict(failure_mode="dropout", failure_prob=0.3,
                         client_chunk_size=3), 2),
    "sign_SGD": (dict(distributed_algorithm="sign_SGD",
                      learning_rate=0.01), 8),
    "fed_quant": (dict(distributed_algorithm="fed_quant", client_eval=False,
                       round=1), 2),
    "multiround_shapley_value": (dict(
        distributed_algorithm="multiround_shapley_value", worker_number=4,
        round=1), 2),
    "GTG_shapley_value": (dict(distributed_algorithm="GTG_shapley_value",
                               shapley_eval_samples=64, round=1), 2),
    # Streamed residency over the mesh: the cohort's blocks a round (with
    # their state rows), or the whole population's blocks once.
    "fed_streamed_state": (dict(
        client_residency="streamed", worker_number=16,
        participation_fraction=0.5, participation_sampler="hashed",
        momentum=0.9, reset_client_optimizer=False, client_chunk_size=3),
        2),
    "fed_streamed_dropout": (dict(
        client_residency="streamed", worker_number=16,
        participation_fraction=0.5, failure_mode="dropout",
        failure_prob=0.3, client_chunk_size=2), 4),
    "fed_streamed_batched": (dict(
        client_residency="streamed", worker_number=16, round=4,
        participation_fraction=0.5, participation_sampler="hashed",
        rounds_per_dispatch=2, client_chunk_size=4), 2),
    "sign_SGD_streamed": (dict(distributed_algorithm="sign_SGD",
                               learning_rate=0.01,
                               client_residency="streamed"), 4),
}


def _quant_level(params: torch.Tensor, levels: int = 256) -> float:
    """The coarsest quantization step of a model's leaves, from the
    dequantized model's range (the aggregate it was taken from spans a
    hair more: 1e-3 of slack)."""
    return 1.001 * float((params.max() - params.min()) / (levels - 1))


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_run_matches_jax_mesh_run(name):
    changes, devices = CASES[name]
    jcfg = JaxConfig(**dict(TINY, **changes, mesh_devices=devices))
    jres = jax_run(jcfg, setup_logging=False)
    pres = run_simulation(port_config(jcfg), setup_logging=False)
    mesh = pres["mesh"]
    assert mesh.size == devices and mesh.axis_name == "clients"
    assert mesh.backend is None and set(mesh.ranks) == {0}
    names = list(pres["global_params"])
    got, want = flat_params(pres, names), flat_params(jres, names)
    if name == "fed_quant":
        assert float((got - want).abs().max()) <= _quant_level(want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for hp, hj in zip(pres["history"], jres["history"], strict=True):
        assert abs(hp["test_accuracy"] - hj["test_accuracy"]) <= (
            1.0 / TINY["n_test"])
        if "shapley_values" in hj:
            sv_p, sv_j = hp["shapley_values"], hj["shapley_values"]
            np.testing.assert_allclose(
                [sv_p[i] for i in sorted(sv_p)],
                [sv_j[i] for i in sorted(sv_j)], atol=2.0 / 64)
    if changes.get("reset_client_optimizer") is False:
        # The per-client state comes back whole, as the serial run's (the
        # streamed run's from its host store).
        solo = run_simulation(port_config(jcfg, mesh_devices=None),
                              setup_logging=False)
        state, want_state = pres["client_state"], solo["client_state"]
        if changes.get("client_residency") == "streamed":
            state, want_state = (torch.as_tensor(state),
                                 torch.as_tensor(want_state))
        assert isinstance(state, torch.Tensor)  # SGD's momentum stack
        assert state.shape == want_state.shape
        torch.testing.assert_close(state, want_state, rtol=1e-5, atol=1e-6)


def test_failure_masks_come_from_the_round_key():
    """A failure mask is a pure function of the round key (drawn on the
    host), so every block and every process draws the same one."""
    cfg = ExperimentConfig(**dict(TINY, failure_mode="dropout",
                                  failure_prob=0.3))
    from distributed_learning_simulator_tpu_torch.ops import prng

    fm = FailureModel.from_config(cfg)
    key = prng.split(prng.key(11))[1]
    a, b = fm.draw_failed(key, 8), fm.draw_failed(key, 8)
    np.testing.assert_array_equal(a, b)
    assert isinstance(a, np.ndarray)


# ---- the mesh itself ---------------------------------------------------------


def test_mesh_on_cpu_slots_and_placement():
    mesh = pmesh.make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.axis_name == "clients"
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert pmesh.make_mesh(None, device="cpu").size == 1
    np.testing.assert_array_equal(pmesh.block_bounds(16, 8),
                                  np.arange(9) * 2)
    x = torch.arange(16 * 4, dtype=torch.float32).reshape(16, 4)
    blocks = pmesh.shard_client_data(x, mesh)
    assert blocks.shape == (16, 4)
    for b, part in enumerate(blocks.parts):
        # A CPU slot takes a view of the rows, not a copy.
        assert part.data_ptr() == x[2 * b].data_ptr()
    np.testing.assert_array_equal(blocks.block_of([0, 1, 2, 15]),
                                  [0, 0, 1, 7])
    assert torch.equal(blocks.full("cpu"), x)
    state = pmesh.shard_client_data({"m": x, "n": x[:, 0]}, mesh)
    full = state.full("cpu")
    assert torch.equal(full["m"], x) and torch.equal(full["n"], x[:, 0])
    assert all(t is x for t in pmesh.replicate(x, mesh))
    with pytest.raises(ValueError, match="equal blocks"):
        pmesh.block_bounds(6, 4)
    # The streamed store's per-process device counts (JAX
    # multihost.mesh_devices_per_host), and its refusal of an interleaved
    # process order.
    assert multihost.mesh_devices_per_host(mesh) == [8]
    with pytest.raises(ValueError, match="interleaves processes"):
        multihost.mesh_devices_per_host(pmesh.Mesh(
            (torch.device("cpu"),) * 2, ranks=(1, 0)))


def test_cuda_shortfall_raises_and_never_runs_on_the_cpu(monkeypatch):
    """A single process asking for more cards than it sees raises the JAX
    package's shortfall ValueError, with or without the JAX package's
    CPU opt-in: the port never moves a CUDA run to the CPU."""
    monkeypatch.setenv("DLS_ALLOW_CPU_MESH_FALLBACK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # resolve_device switches TF32 off and cuDNN's determinism on for a
    # CUDA run: put them back after.
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic",
                        torch.backends.cudnn.deterministic)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    pattern = r"requested 2 mesh devices but only 1 visible"
    with pytest.raises(ValueError, match=pattern) as err:
        pmesh.make_mesh(2, device="cuda")
    assert "never moves a CUDA run to the CPU" in str(err.value)
    with pytest.raises(ValueError, match=pattern):
        run_simulation(ExperimentConfig(**dict(TINY, mesh_devices=2),
                                        device="cuda"),
                       setup_logging=False)
    monkeypatch.delenv("DLS_ALLOW_CPU_MESH_FALLBACK")
    with pytest.raises(ValueError,
                       match=r"requested 9 mesh devices but only 8 visible"):
        jax_make_mesh(9)


def test_uneven_clients_rejected_with_the_jax_text():
    jcfg = JaxConfig(**dict(TINY, worker_number=6, mesh_devices=4))
    with pytest.raises(ValueError) as jerr:
        jax_run(jcfg, setup_logging=False)
    with pytest.raises(ValueError) as perr:
        run_simulation(port_config(jcfg), setup_logging=False)
    assert str(perr.value) == str(jerr.value)
    assert "must be a multiple of mesh_devices" in str(perr.value)


@pytest.mark.parametrize("changes", [
    dict(client_residency="streamed", mesh_devices=2),
    dict(client_residency="streamed", multihost=True),
    dict(client_residency="streamed", participation_fraction=0.5,
         participation_sampler="hashed", multihost=True, mesh_devices=2),
    dict(sweep_seeds="0,1", mesh_devices=2),
])
def test_item_17b_stays_refused(changes):
    """What ROADMAP item 17b brought (streamed residency over a mesh or
    processes, the sweep's experiment-axis mesh): each configuration now
    validates where the JAX package's does, and is refused with the JAX
    text where it is not (multihost streaming without a global mesh)."""
    jerr = perr = None
    try:
        JaxConfig(**dict(TINY, **changes)).validate()
    except ValueError as e:
        jerr = e
    try:
        ExperimentConfig(**dict(TINY, **changes)).validate()
    except ValueError as e:
        perr = e
    assert (perr is None) == (jerr is None), (perr, jerr)
    if jerr is not None:
        assert str(perr) == str(jerr)


def test_resident_mesh_and_multihost_validate():
    ExperimentConfig(**dict(TINY, mesh_devices=2)).validate()
    ExperimentConfig(**dict(TINY, multihost=True)).validate()


# ---- the GTG subset mesh ----------------------------------------------------


def _toy_workload(n=20, p=400, seed=3):
    rng = np.random.default_rng(seed)
    stack = torch.from_numpy(rng.standard_normal((n, p)).astype(np.float32))
    sizes = rng.integers(1, 9, n).astype(np.float32)
    prev = torch.from_numpy(rng.standard_normal(p).astype(np.float32))
    xb = torch.from_numpy(rng.standard_normal((2, 32, p)).astype(np.float32))
    yb = torch.from_numpy(rng.integers(0, 4, (2, 32)))
    mb = torch.ones((2, 32))
    return stack, sizes, prev, (xb, yb, mb)


def _toy_eval(flat, xb, yb, mb):
    h = torch.tanh(xb @ flat)
    return {"accuracy": (h * mb).sum() / mb.sum()}


def _walk(devices, prefix_mode, eps, chunk=16, n=20, cap=12):
    stack, sizes, prev, batches = _toy_workload(n=n)
    ev = shapley._SubsetEvaluator(
        _toy_eval, chunk=chunk,
        mesh_devices=devices if devices > 1 else None, device="cpu")
    assert ev.devices == devices and ev.call_width == chunk * devices
    memo = shapley.SubsetMemo()
    shapley.eval_subsets(ev, stack, sizes, prev, batches, n, memo,
                         [frozenset(), frozenset(range(n))])
    rng = np.random.default_rng(7)
    sv, n_perms, converged = shapley.gtg_walk(
        ev, stack, sizes, prev, batches, n, rng,
        eps=eps, cap=cap, last_k=10, converge_criteria=0.05,
        trunc_ref=memo[frozenset(range(n))], prefix_mode=prefix_mode,
        memo=memo,
    )
    ev.release_round()
    return sv, n_perms, converged, dict(memo), memo.evaluated


@pytest.mark.parametrize("prefix_mode", ["cumsum", "masked"])
@pytest.mark.parametrize("eps", [1e-9, 0.02])
def test_subset_mesh_walk_bitwise_serial(prefix_mode, eps):
    """D=2 against D=1 (JAX tests/test_gtg_mesh.py:93): SVs, permutation
    counts, convergence, the memo's exact contents and evaluated counts;
    n=20 walks a block of 16 and a short block of 4."""
    serial = _walk(1, prefix_mode, eps)
    split = _walk(2, prefix_mode, eps)
    np.testing.assert_array_equal(serial[0], split[0])
    assert serial[1:] == split[1:]
    if eps == 0.02:
        assert serial[4] < _walk(1, prefix_mode, 1e-9)[4]


def test_subset_mesh_walk_chunk_not_dividing_block():
    for mode in ("cumsum", "masked"):
        serial = _walk(1, mode, 1e-9, chunk=5)
        split = _walk(2, mode, 1e-9, chunk=5)
        np.testing.assert_array_equal(serial[0], split[0])
        assert serial[3] == split[3]


@pytest.mark.parametrize("changes,want", [
    (dict(mesh_devices=2), 2),
    (dict(mesh_devices=1), None),
    (dict(), None),
    (dict(mesh_devices=2, multihost=True), None),
    (dict(mesh_devices=2, execution_mode="threaded"), None),
])
def test_eval_mesh_devices_as_in_jax(changes, want):
    cfg = ExperimentConfig(**dict(TINY, **changes))
    assert shapley.eval_mesh_devices(cfg) == want
    assert jshap.eval_mesh_devices(JaxConfig(**dict(TINY, **changes))) == (
        want)


def test_gtg_mesh_run_records_v10(tmp_path):
    """A mesh_devices=2 GTG run's records carry the v10 ``gtg``
    sub-object with the JAX run's keys, devices and wave width; the
    serial run's records have none."""
    changes = dict(distributed_algorithm="GTG_shapley_value",
                   shapley_eval_samples=64, round=1)
    jcfg = JaxConfig(**dict(TINY, **changes, mesh_devices=2))
    jrec = jax_run(jcfg, setup_logging=False)["history"][0]
    pcfg = port_config(jcfg, log_root=str(tmp_path / "mesh"))
    prec = run_simulation(pcfg, setup_logging=True)["history"][0]
    assert prec["schema_version"] == jrec["schema_version"] == 10
    assert set(prec["gtg"]) == set(jrec["gtg"])
    assert prec["gtg"]["devices"] == jrec["gtg"]["devices"] == 2
    assert prec["gtg"]["wave_width"] == jrec["gtg"]["wave_width"]
    assert prec["gtg"]["walk_seconds"] > 0
    (written,) = read_records(tmp_path / "mesh")
    assert written["schema_version"] == 10 and written["gtg"] == prec["gtg"]
    serial = run_simulation(port_config(JaxConfig(**dict(TINY, **changes))),
                            setup_logging=False)["history"][0]
    assert "gtg" not in serial and "schema_version" not in serial


# ---- the kernels' device guard ----------------------------------------------


class _Recorder:
    """A fake kernel library and device guard that log their calls."""

    def __init__(self):
        self.calls = []

    def guard(self, t):
        @contextlib.contextmanager
        def entered():
            self.calls.append(("enter", str(t.device)))
            yield
            self.calls.append(("exit", str(t.device)))

        return entered()

    def __getattr__(self, name):
        if not name.startswith("dls_"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append(("launch", name))
            return 0

        return launch


def test_kernel_wrappers_launch_inside_the_device_guard(monkeypatch):
    """Each wrapper makes its tensor's card current around the launch (the
    kernels launch on the current device, and wgrad encodes its tensor
    maps there). Meta tensors stand in for a card's."""
    rec = _Recorder()
    for mod in (gn_cuda, wgrad_cuda):
        monkeypatch.setattr(mod, "device_guard", rec.guard)
        monkeypatch.setattr(mod, "launch_stream", lambda t: 0)
        monkeypatch.setattr(mod, "_lib", lambda: rec)
        monkeypatch.setattr(mod, "count_launch", lambda w, device: None)
    monkeypatch.setattr(gn_cuda, "_check_cuda_input", lambda x, g: "f32")
    monkeypatch.setattr(gn_cuda, "_sm_count", lambda index: 132)
    monkeypatch.setattr(wgrad_cuda, "_check_cuda_inputs", lambda x, g: "f32")
    x = torch.empty((2, 16, 64), device="meta")
    mean, rstd = gn_cuda.gn_stats(x, 32, 1e-6)
    affine = torch.empty(64, device="meta")
    gn_cuda.gn_normalize(x, mean, rstd, affine, affine, torch.float32)
    xw = torch.empty((2, 8, 8, 64), device="meta")
    wgrad_cuda.conv3x3_wgrad(xw, xw)
    launches = [c for c in rec.calls if c[0] == "launch"]
    assert [name for _, name in launches] == [
        "dls_gn_stats_f32", "dls_gn_normalize_f32_f32", "dls_wgrad_f32"]
    for i, call in enumerate(rec.calls):
        if call[0] == "launch":
            assert rec.calls[i - 1] == ("enter", "meta")
            assert rec.calls[i + 1] == ("exit", "meta")
