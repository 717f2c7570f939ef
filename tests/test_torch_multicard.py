"""The device group of a multi-process run (parallel/multihost.py) and the
collectives' groups, on the CPU.

* The backend is a function of the ranks' devices (and, through
  ``rank_device``, of the card count): the CPU gives gloo, two ranks on
  one card gloo (NCCL refuses them), ranks on cards of their own NCCL.
* ``_setup_device_group`` chooses from the layout the ranks publish over
  the host group, makes the NCCL group only for NCCL, and honours the
  private override.
* Every host-side collective (the mesh's device list, ``allgather_int64``,
  ``allgather_rows``, ``allgather_wall_stamps``, the clock alignment) goes
  through the host group, and the blocks' gathers through the device
  group; ``Mesh.describe()`` names the backend.

A CPU run cannot start NCCL: the collectives here are stand-ins that
record their group (and, for gathers, hand every rank this rank's
tensor). The NCCL group itself, its gathers and one process over several
cards run on four cards in chip_multicard.py.
"""

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu_torch.parallel import mesh as pmesh
from distributed_learning_simulator_tpu_torch.parallel import multihost


@pytest.mark.parametrize("devices,hosts,want", [
    (["cpu", "cpu"], None, "gloo"),
    (["cuda:0", "cuda:0"], None, "gloo"),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], None, "nccl"),
    (["cuda:0", "cpu"], None, "gloo"),
    (["cuda:0", "cuda:0"], ["a", "b"], "nccl"),
    (["cuda:0", "cuda:1", "cuda:0"], ["a", "a", "a"], "gloo"),
])
def test_backend_from_the_ranks_devices(devices, hosts, want):
    assert multihost.choose_backend(devices, hosts) == want


@pytest.mark.parametrize("name,n_ranks,n_cards,want", [
    ("cpu", 2, 0, "gloo"),
    ("cuda", 2, 1, "gloo"),    # two ranks on the one card
    ("cuda", 4, 4, "nccl"),    # a card a rank
    ("cuda", 4, 2, "gloo"),    # two ranks a card
    ("cuda:0", 2, 4, "gloo"),  # the caller named one card for both
])
def test_backend_from_the_card_count(name, n_ranks, n_cards, want):
    devices = [multihost.rank_device(name, r, n_cards)
               for r in range(n_ranks)]
    assert multihost.choose_backend(devices) == want


class _World:
    """A stand-in process group of ``size`` ranks: each collective records
    its group; a gather hands every rank this rank's value."""

    def __init__(self, monkeypatch, size=2, layout=None):
        self.calls = []
        self.host, self.device = object(), object()
        dist = multihost.dist
        for module in (multihost, pmesh):
            monkeypatch.setattr(module, "distributed_initialized",
                                lambda: True)
            monkeypatch.setattr(module, "process_count", lambda: size)
            monkeypatch.setattr(module, "host_group", lambda: self.host)
        monkeypatch.setattr(pmesh, "device_group", lambda: self.device)
        monkeypatch.setattr(pmesh, "process_index", lambda: 0)
        monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: size)
        monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 0)
        monkeypatch.setattr(dist, "get_backend", lambda *a, **k: "gloo")

        def all_gather(out, t, group=None):
            self.calls.append(("all_gather", group))
            for o in out:
                o.copy_(t)

        def all_gather_object(out, obj, group=None):
            self.calls.append(("all_gather_object", group))
            for i in range(len(out)):
                out[i] = obj if layout is None else layout[i]

        monkeypatch.setattr(dist, "all_gather", all_gather)
        monkeypatch.setattr(dist, "all_gather_object", all_gather_object)


def test_host_collectives_use_the_host_group(monkeypatch):
    world = _World(monkeypatch)
    assert multihost.allgather_int64([3, 4]).tolist() == [[3, 4], [3, 4]]
    rows = multihost.allgather_rows([np.arange(3, dtype=np.int32)])
    assert rows[0].tolist() == [[0, 1, 2], [0, 1, 2]]
    assert multihost.allgather_wall_stamps(1.5).tolist() == [1.5, 1.5]
    multihost.estimate_clock_alignment()
    mesh = pmesh.make_mesh(None, device="cpu")
    assert mesh.size == 2 and mesh.multiprocess
    assert world.calls and all(group is world.host
                               for _, group in world.calls), world.calls


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_describe_names_the_device_backend(monkeypatch, backend):
    _World(monkeypatch)
    monkeypatch.setattr(multihost, "_device_backend", backend)
    mesh = pmesh.make_mesh(None, device="cpu")
    assert mesh.backend == backend
    assert mesh.describe()["backend"] == backend


def test_block_gathers_use_the_device_group(monkeypatch):
    """Under gloo a gather stages through host memory over the device
    group (the default group): the block order and packing hold."""
    world = _World(monkeypatch)
    mesh = pmesh.Mesh((torch.device("cpu"),) * 2, ranks=(0, 1), rank=0,
                      backend="gloo")
    parts = {0: {"a": torch.arange(4.0), "b": torch.tensor([9.0])}}
    spec = {"a": ((4,), torch.float32), "b": ((1,), torch.float32)}
    pmesh.reset_gather_stats()
    got = pmesh.gather_blocks(mesh, parts, spec, torch.device("cpu"))
    assert got["a"].tolist() == [[0.0, 1.0, 2.0, 3.0]] * 2
    assert got["b"].tolist() == [[9.0]] * 2
    assert world.calls == [("all_gather", world.device)]
    stats = pmesh.gather_stats()
    assert stats["calls"] == 1 and stats["bytes"] == 2 * 5 * 4
    assert stats["first_call_seconds"] == stats["seconds"]
    assert stats["min_call_seconds"] is None
    pmesh.gather_blocks(mesh, parts, spec, torch.device("cpu"))
    stats = pmesh.gather_stats()
    assert stats["calls"] == 2
    assert stats["min_call_seconds"] == stats["max_call_seconds"]


class _Event:
    """A timing CUDA event's stand-in: ended or not, and its time."""

    def __init__(self, ms, ended=True):
        self.ms, self.ended = ms, ended

    def query(self):
        return self.ended

    def synchronize(self):
        self.ended = True

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_ended_gather_events_are_added_and_dropped(monkeypatch):
    """An NCCL gather's events are read once they have ended, by the next
    gather or by gather_stats(): a long run keeps totals, not a list a
    gather."""
    monkeypatch.setattr(pmesh, "_PENDING_EVENTS", [])
    pmesh.reset_gather_stats()
    pmesh._PENDING_EVENTS.extend([
        (_Event(0.0), _Event(2.0)), (_Event(5.0), _Event(6.0)),
        (_Event(7.0), _Event(10.0, ended=False)),
        (_Event(11.0), _Event(12.5)),
    ])
    pmesh._drain_events(wait=False)
    # The oldest two ended; the third has not, and the fourth waits
    # behind it (one stream ends them in order).
    assert len(pmesh._PENDING_EVENTS) == 2
    assert pmesh.GATHER_STATS["seconds"] == pytest.approx(3e-3)
    stats = pmesh.gather_stats()
    assert pmesh._PENDING_EVENTS == []
    assert stats["seconds"] == pytest.approx(7.5e-3)
    assert stats["first_call_seconds"] == pytest.approx(2e-3)
    assert stats["min_call_seconds"] == pytest.approx(1e-3)
    assert stats["max_call_seconds"] == pytest.approx(3e-3)
    pmesh.reset_gather_stats()


@pytest.mark.parametrize("contexts,want", [({0}, [0]), ({1, 3}, [1, 3])])
def test_profiler_windows_wait_only_for_cards_in_use(monkeypatch, contexts,
                                                     want):
    """A profiler window waits for the cards this process holds a context
    on, so a rank that sees all four cards makes no context on the
    others'."""
    from distributed_learning_simulator_tpu_torch.utils import tracing

    waited = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    monkeypatch.setattr(torch._C, "_cuda_hasPrimaryContext",
                        lambda i: i in contexts, raising=False)
    tracing._synchronize_cards_in_use()
    assert waited == want


@pytest.mark.parametrize("layout,override,want,groups", [
    ([("h", "cuda:0"), ("h", "cuda:1")], None, "nccl", 1),
    ([("h", "cuda:0"), ("h", "cuda:0")], None, "gloo", 0),
    ([("h", "cpu"), ("h", "cpu")], None, "gloo", 0),
    ([("h", "cuda:0"), ("h", "cuda:1")], "gloo", "gloo", 0),
])
def test_device_group_from_the_published_layout(monkeypatch, layout,
                                                override, want, groups):
    world = _World(monkeypatch, layout=layout)
    made = []
    monkeypatch.setattr(multihost.dist, "new_group",
                        lambda **kw: made.append(kw) or "nccl-group")
    monkeypatch.setattr(multihost.torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(multihost, "_device_backend", None)
    monkeypatch.setattr(multihost, "_device_group", None)
    monkeypatch.setattr(multihost, "_backend_override", override)
    multihost._setup_device_group("cpu")
    assert multihost._device_backend == want
    assert [kw["backend"] for kw in made] == ["nccl"] * groups
    assert world.calls == [("all_gather_object", world.host)]
    assert (multihost.device_group() == "nccl-group") == (want == "nccl")


# --- chip_multicard.py's arms, set up on the CPU ---------------------------

def _scripts():
    import chip_multicard
    import chip_smoke

    return chip_smoke, chip_multicard


def test_arms_option_refuses_unknown_letters():
    """``--arms`` names arms (a)-(h) by letter; anything else is refused
    before the script looks for cards."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "chip_multicard.py", "--arms", "az"], cwd=repo,
        capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "--arms takes letters of a-h" in proc.stderr


def test_layout_flags_for_fed_as_before(tmp_path):
    """``layout_config`` with the algorithm argument gives (b) the flags it
    had before it took one."""
    import dataclasses
    import os

    smoke, multicard = _scripts()
    work = str(tmp_path)
    before = dataclasses.replace(
        smoke.path_configs(40, 4000, 1000, "INFO")["fed"],
        client_chunk_size=10, round=3, bucket_client_work=False,
        log_root=os.path.join(work, "log"))
    want = smoke.cli_flags(before)
    assert smoke.cli_flags(multicard.layout_config(smoke, work)) == want
    assert smoke.cli_flags(multicard.layout_config(smoke, work, "fed")) == (
        want)


def _arm_flags(work: str) -> dict:
    """Every process's CLI flags in arms (e)-(h)."""
    import dataclasses

    smoke, multicard = _scripts()
    n = multicard.N_CARDS
    out = {}

    def rank(flags):
        return flags + ["--multihost", "true", "--coordinator_address",
                        "127.0.0.1:1", "--num_processes", str(n),
                        "--process_id", "1", "--mesh_devices", str(n)]

    for algo in multicard.MESH_ALGORITHMS:
        flags = smoke.cli_flags(multicard.layout_config(smoke, work, algo))
        out[f"e {algo} rank"] = rank(flags)
        out[f"e {algo} mesh"] = flags + ["--mesh_devices", str(n)]
        out[f"e {algo} one card"] = flags
    stream = smoke.multihost_stream_config(work)
    out["f stream mesh"] = smoke.cli_flags(dataclasses.replace(
        stream, client_chunk_size=stream.cohort_size() // n,
        span_trace="off", mesh_devices=n))
    sweep = smoke.cli_flags(multicard.sweep_config(smoke))
    out["g sweep mesh"] = sweep + ["--mesh_devices", str(n)]
    out["g sweep one card"] = sweep
    out["g sweep seed alone"] = sweep + ["--sweep_seeds", "3"]
    out["h preempt rank"] = rank(smoke.cli_flags(dataclasses.replace(
        stream, checkpoint_every=2, checkpoint_dir=work)))
    return out


_ARMS = ["e sign_SGD rank", "e sign_SGD mesh", "e sign_SGD one card",
         "e fed_quant rank", "e fed_quant mesh", "e fed_quant one card",
         "e multiround_shapley_value rank", "e multiround_shapley_value mesh",
         "e multiround_shapley_value one card", "f stream mesh",
         "g sweep mesh", "g sweep one card", "g sweep seed alone",
         "h preempt rank"]


@pytest.mark.parametrize("arm", _ARMS)
def test_arm_flags_validate_as_in_jax(arm, tmp_path):
    """Each process's flags parse and validate in the port's config and
    in the JAX package's, to the same fields."""
    import dataclasses

    from distributed_learning_simulator_tpu.config import (
        get_config as jax_get_config,
    )
    from distributed_learning_simulator_tpu_torch.config import get_config

    flags = _arm_flags(str(tmp_path))
    assert sorted(flags) == sorted(_ARMS)
    argv = flags[arm]
    port = get_config(argv)
    # The port's own field, at its default (the card): not among the flags.
    assert "--device" not in argv and port.device == "cuda"
    ref = jax_get_config(argv)
    for f in dataclasses.fields(ref):
        if f.name != "cost_model_topology":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    if arm.startswith("e multiround"):
        assert port.worker_number == 8 and port.client_chunk_size == 2
    if arm.startswith("g"):
        assert port.sweep_seeds == ("3" if arm.endswith("alone")
                                    else "0,1,2,3")
    if arm.startswith("h"):
        assert port.checkpoint_every == 2 and port.round == 2
        assert port.client_residency == "streamed"


def test_multihost_preempt_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's ``multihost_preempt`` phase, whole, on two CPU ranks
    of the tiny MLP."""
    smoke, _ = _scripts()
    work = str(tmp_path / "work")
    out = smoke.multihost_preempt(torch, work,
                                  smoke.preempt_configs(work, device="cpu"))
    assert sorted(out) == ["resident_rank0", "streamed_all",
                           "streamed_rank0"]
    for run, o in out.items():
        streamed = run.startswith("streamed")
        # Streamed: not pipelined (state writeback), round 0; resident:
        # pipelined, so round 1 was in flight when round 0's finalize
        # raised the signal.
        assert o["preempted_at"] == (0 if streamed else 1)
        assert o["files"] == ([] if streamed else ["round_1.ckpt"])
        signalled = o["ranks"] if run.endswith("_all") else o["ranks"][:1]
        assert all(r["rc"] == 0 and r["exit_s"] < smoke.PREEMPT_EXIT_S
                   for r in signalled)
        assert len(o["peers"]) == (0 if run.endswith("_all") else 1)
        assert all(rc != 0 for rc in o["peers"])
