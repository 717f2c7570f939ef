"""Multi-process initialization over ``torch.distributed`` (parallel/
multihost.py of the JAX package).

``--multihost`` brings up a process group before any device query; after
it the mesh (parallel/mesh.py) lists every process's device in rank order
and the round programs gather the client-axis blocks across processes.

Two groups, one for each kind of collective:

* **The host group** is the default group, always **gloo**: the host-side
  collectives (the mesh's device list, :func:`allgather_int64`,
  :func:`allgather_rows`, :func:`allgather_wall_stamps`, the checkpoint
  barriers) go through it, on the CPU and on the card alike.
* **The device group** carries the blocks' gathers of CUDA tensors
  (parallel/mesh.py ``gather_blocks``). Once the default group is up, the
  ranks publish their devices over it and :func:`choose_backend` picks
  the backend from that layout, the same on every rank: **NCCL** when
  every rank's device is a CUDA device that no other rank on its node
  uses (a second group over all ranks, made beside the gloo one with this
  rank's card current), else **gloo**, the default group itself (the CPU,
  and two ranks on one card, which NCCL refuses); a gloo gather stages
  CUDA tensors through pinned host buffers.

Every process holds one device: the CPU, or ``cuda:(local_rank %
device_count)`` where ``local_rank`` is ``$LOCAL_RANK`` (a launcher's) or
else the process id.
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from distributed_learning_simulator_tpu_torch.utils.logging import get_logger

#: The host group's backend (see the module docstring).
BACKEND = "gloo"
#: Seconds a collective waits for its peers before it raises: a rank that
#: died or diverged turns into an error on the others, not a hang.
TIMEOUT_S = 300.0

# The coordinator this process initialized against (None when the group
# came up elsewhere): torch.distributed does not expose it, so a re-call
# naming a different one while the counts match is caught here.
_initialized_coordinator: str | None = None
# The device group: its backend once chosen, and the NCCL group (None
# when the device collectives use the default gloo group).
_device_backend: str | None = None
_device_group = None
# Set by a measurement that wants the gloo device gathers where the layout
# would give NCCL (chip_multicard.py compares the two); None otherwise.
_backend_override: str | None = None


def choose_backend(devices, hosts=None) -> str:
    """The device group's backend for ranks whose devices are ``devices``
    (rank order) on the nodes ``hosts`` (None: one node): ``"nccl"`` when
    every device is a CUDA device that no other rank on its node uses,
    else ``"gloo"``."""
    names = [str(torch.device(d)) for d in devices]
    hosts = [None] * len(names) if hosts is None else list(hosts)
    placed = list(zip(hosts, names))
    if all(n.startswith("cuda:") for n in names) and (
            len(set(placed)) == len(placed)):
        return "nccl"
    return "gloo"


def distributed_initialized() -> bool:
    """Whether a torch.distributed process group is up in this process."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if distributed_initialized() else 0


def process_count() -> int:
    """The number of processes in the group (1 without a group)."""
    return dist.get_world_size() if distributed_initialized() else 1


def local_rank() -> int:
    """This process's index among the processes of its host: a launcher's
    ``$LOCAL_RANK``, else its rank."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def rank_device(name: str, local: int, n_cards: int) -> torch.device:
    """The device of the process with local rank ``local`` on a node with
    ``n_cards`` cards: ``cuda`` becomes ``cuda:(local % n_cards)`` (a
    ``cuda:N`` the caller named stays as it is), anything else is taken as
    given."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None and n_cards > 0:
        return torch.device("cuda", local % n_cards)
    return device


def local_device(name: str) -> torch.device:
    """The one device this process contributes to a multi-process mesh
    (:func:`rank_device` of this process)."""
    return rank_device(name, local_rank(), torch.cuda.device_count()
                       if torch.cuda.is_available() else 0)


def host_group():
    """The group of the host-side collectives: the default (gloo) group."""
    return dist.group.WORLD


def device_backend() -> str | None:
    """The backend of the blocks' gathers: None without a group; the
    default group's when the group came up without
    :func:`initialize_multihost`."""
    if not distributed_initialized():
        return None
    return _device_backend or dist.get_backend()


def device_group():
    """The group of the blocks' gathers (the NCCL group, or the default
    group)."""
    return _device_group if _device_backend == "nccl" else dist.group.WORLD


def _setup_device_group(device: str) -> None:
    """Publish every rank's node and device over the host group, choose the
    device group's backend from them (the same choice on every rank) and,
    for NCCL, make the group with this rank's card current. Collective."""
    global _device_backend, _device_group
    mine = (socket.gethostname(), str(local_device(device)))
    layout = [None] * process_count()
    dist.all_gather_object(layout, mine, group=host_group())
    backend = _backend_override or choose_backend(
        [d for _, d in layout], [h for h, _ in layout])
    if torch.device(mine[1]).type == "cuda":
        # This rank's card is the current device: what NCCL's
        # communicator and any implicit allocation use.
        torch.cuda.set_device(torch.device(mine[1]))
    if backend == "nccl":
        _device_group = dist.new_group(
            backend="nccl", timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _device_backend = backend


def _global_device_count() -> int:
    if distributed_initialized():
        return process_count()
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str = "cpu",
) -> int:
    """Bring up the process group and the device group for ``device``
    (the run's ``--device``); returns the global device count (one device
    per process).

    With no arguments, a launcher's environment (``MASTER_ADDR``,
    ``WORLD_SIZE``, ``RANK``) is used when it is there; in a plain
    single-process environment the call degrades to a logged no-op. Safe
    to re-call when the group is up (a second run_simulation in one
    process) as long as explicit flags match the live group. With
    EXPLICIT flags and no group, failures are fatal: a misconfigured
    two-process launch must not split into two independent single-process
    runs that each write a full set of artifacts."""
    global _initialized_coordinator

    logger = get_logger()
    explicit = any(
        v is not None for v in (coordinator_address, num_processes, process_id)
    )
    if distributed_initialized():
        if explicit:
            if (
                num_processes is not None
                and dist.get_world_size() != num_processes
            ) or (
                process_id is not None and dist.get_rank() != process_id
            ):
                raise RuntimeError(
                    "torch.distributed is already initialized as process "
                    f"{dist.get_rank()}/{dist.get_world_size()}, which "
                    "does not match the explicit multihost flags "
                    f"(num_processes={num_processes}, "
                    f"process_id={process_id}); refusing to proceed"
                )
            if coordinator_address is not None:
                if (
                    _initialized_coordinator is not None
                    and _initialized_coordinator != coordinator_address
                ):
                    raise RuntimeError(
                        "torch.distributed is already initialized against "
                        f"coordinator {_initialized_coordinator!r} but the "
                        f"caller asked for {coordinator_address!r}; "
                        "refusing to silently reuse a different cluster"
                    )
                if _initialized_coordinator is None:
                    logger.warning(
                        "torch.distributed was initialized outside "
                        "initialize_multihost; cannot verify it points at "
                        "the requested coordinator %r",
                        coordinator_address,
                    )
        logger.info("torch.distributed already initialized; reusing it")
    else:
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        try:
            if explicit:
                if None in (coordinator_address, num_processes, process_id):
                    raise ValueError(
                        "coordinator_address, num_processes and process_id "
                        "are all required"
                    )
                dist.init_process_group(
                    backend=BACKEND,
                    init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id),
                    timeout=timeout,
                )
                _initialized_coordinator = coordinator_address
            elif all(k in os.environ
                     for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
                dist.init_process_group(backend=BACKEND, init_method="env://",
                                        timeout=timeout)
            else:
                raise RuntimeError(
                    "no coordinator configured and no launcher environment "
                    "(MASTER_ADDR, WORLD_SIZE, RANK) to detect"
                )
        except (RuntimeError, ValueError) as e:
            if explicit:
                raise RuntimeError(
                    "torch.distributed.init_process_group failed with "
                    "explicit multihost flags (coordinator_address="
                    f"{coordinator_address!r}, "
                    f"num_processes={num_processes}, "
                    f"process_id={process_id}); refusing to degrade to a "
                    "single-process run"
                ) from e
            logger.info(
                "torch.distributed.init_process_group skipped (single "
                "process): %s", e,
            )
    if distributed_initialized() and _device_backend is None:
        _setup_device_group(device)
    n = _global_device_count()
    logger.info(
        "multihost: process %d/%d, %d global devices, backend %s",
        process_index(), process_count(), n, device_backend(),
    )
    return n


def allgather_wall_stamps(stamp: float) -> np.ndarray:
    """One wall-clock stamp per process, gathered at full precision: the
    ``[n_hosts]`` float64 vector in rank order (gloo gathers float64
    as it is, so no split-float packing is needed). Collective."""
    if not distributed_initialized():
        return np.asarray([stamp], dtype=np.float64)
    mine = torch.tensor([stamp], dtype=torch.float64)
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine, group=host_group())
    return torch.cat(out).numpy()


def estimate_clock_alignment() -> tuple[float, float]:
    """This process's wall-clock offset against process 0 and its
    uncertainty, for the span journal headers (telemetry/spans.py).

    Two back-to-back gathers: every process stamps ``clock.wall()`` as soon
    as the first releases (all release within one collective latency of
    each other), and the second publishes the stamps. The offset is
    ``my_stamp - stamp_0`` (positive: this clock reads ahead). Each
    process times its own span across the two collectives; the earliest
    to be released waits in the second for the last, so the largest span
    of any process bounds how far apart the stamps were taken, and that
    largest span (a third, tiny gather) is the uncertainty. ``(0.0,
    0.0)`` for a single process."""
    if process_count() <= 1:
        return 0.0, 0.0
    from distributed_learning_simulator_tpu_torch.telemetry import clock

    zeros = torch.zeros(1, dtype=torch.int32)
    dist.all_gather([torch.empty_like(zeros)
                     for _ in range(dist.get_world_size())], zeros,
                    group=host_group())
    t_release = clock.monotonic()
    stamp = clock.wall()
    stamps = allgather_wall_stamps(stamp)
    spans = allgather_wall_stamps(clock.monotonic() - t_release)
    return float(stamp - stamps[0]), float(spans.max())


def mesh_devices_per_host(mesh) -> list[int]:
    """Per-process device counts of a mesh, checked for contiguous
    per-process blocks (the process sequence must be sorted) and for a
    device on every process; the input of the distributed shard store's
    ownership bounds."""
    procs = list(mesh.ranks)
    n_hosts = process_count()
    if sorted(procs) != procs:
        raise ValueError(
            "mesh device order interleaves processes "
            f"(process sequence {procs}); the distributed shard store "
            "needs each host's mesh shards contiguous — build the mesh "
            "in rank order"
        )
    counts = [0] * n_hosts
    for p in procs:
        counts[p] += 1
    missing = [h for h, c in enumerate(counts) if c == 0]
    if missing:
        raise ValueError(
            f"mesh spans {len(set(procs))} of {n_hosts} processes "
            f"(processes {missing} contribute no device); "
            "client_residency='streamed' under multihost needs every "
            "host addressable in the mesh — set mesh_devices to the "
            "global device count"
        )
    return counts


def allgather_int64(values) -> np.ndarray:
    """``values`` of every process as a ``[n_hosts, len(values)]`` int64
    array in rank order (one row without a group). Collective."""
    mine = torch.as_tensor(np.asarray(values, dtype=np.int64))
    if not distributed_initialized():
        return mine.numpy()[None]
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine, group=host_group())
    return torch.stack(out).numpy()


def allgather_rows(arrays) -> list[np.ndarray]:
    """Each of ``arrays`` (numpy, of the same shapes and dtypes on every
    process) from every process: one ``[n_hosts, *shape]`` array each, in
    rank order. One gloo ``all_gather`` carries all of them, their bytes
    packed into one uint8 buffer (pinned where there is a card). The
    distributed shard store's spill exchange (parallel/streaming.py).
    Collective."""
    flat = [np.ascontiguousarray(a).reshape(-1).view(np.uint8)
            for a in arrays]
    width = sum(f.size for f in flat)
    send = torch.empty(width, dtype=torch.uint8,
                       pin_memory=torch.cuda.is_available())
    off = 0
    for f in flat:
        send[off:off + f.size] = torch.from_numpy(f)
        off += f.size
    if distributed_initialized():
        recv = [torch.empty_like(send, pin_memory=False)
                for _ in range(dist.get_world_size())]
        dist.all_gather(recv, send, group=host_group())
    else:
        recv = [send]
    out = []
    off = 0
    for a, f in zip(arrays, flat):
        a = np.asarray(a)
        out.append(np.stack([
            r[off:off + f.size].numpy().view(a.dtype).reshape(a.shape)
            for r in recv]))
        off += f.size
    return out

