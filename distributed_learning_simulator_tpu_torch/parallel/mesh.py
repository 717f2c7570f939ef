"""The client-axis mesh (parallel/mesh.py of the JAX package).

A :class:`Mesh` is an ordered tuple of devices with an axis name. The
client axis is split into ``mesh.size`` equal contiguous blocks
(:func:`block_bounds`), and block ``b`` lives on ``mesh.devices[b]``:
:func:`shard_client_data` places each block's rows there
(:class:`Blocks`), :func:`replicate` copies a tree to every device.

* **CPU**: a mesh of ``n`` is ``n`` slots of the one CPU device, the
  counterpart of the JAX tests' forced host devices; placing a block there
  takes a view, not a copy.
* **CUDA, one process**: ``cuda:0 .. cuda:n-1``; asking for more than
  ``torch.cuda.device_count()`` raises the JAX package's shortfall
  ValueError. The port never moves a CUDA run to the CPU, with or without
  ``DLS_ALLOW_CPU_MESH_FALLBACK``.
* **Multihost** (parallel/multihost.py): the rank-ordered list of every
  process's one device; a process holds the blocks on its own device
  (``Blocks.parts[b]`` is None for the others).

:func:`gather_blocks` brings every block's values to one device of every
process, in block order, so that every process sums them in the same
order and holds the same bits whatever the backend. Across processes it
is one ``all_gather`` a dtype over the device group (parallel/
multihost.py): under NCCL of the CUDA tensors themselves, under gloo
through host buffers (pinned when there is a card). ``GATHER_STATS``
counts its calls, bytes and seconds (:func:`gather_stats` reads it).
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from distributed_learning_simulator_tpu_torch.ops.cohort import tree_map
from distributed_learning_simulator_tpu_torch.parallel.multihost import (
    device_backend,
    device_group,
    distributed_initialized,
    host_group,
    local_device,
    process_count,
    process_index,
)

CLIENT_AXIS = "clients"

#: Cross-process gathers of this process: calls, bytes received, seconds
#: in all, and the first call's seconds beside the least and most of the
#: later calls' (an NCCL gather's seconds are its CUDA events').
GATHER_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0,
                "first_call_seconds": None, "min_call_seconds": None,
                "max_call_seconds": None}
# The (start, end) CUDA events of NCCL gathers not yet added to
# GATHER_STATS, oldest first: each gather adds those that have ended, and
# gather_stats() waits for the rest.
_PENDING_EVENTS: list = []


def gather_stats() -> dict:
    """A copy of ``GATHER_STATS`` with every NCCL gather's seconds in it
    (waits for those gathers to end)."""
    _drain_events(wait=True)
    return dict(GATHER_STATS)


def _drain_events(wait: bool) -> None:
    while _PENDING_EVENTS and (wait or _PENDING_EVENTS[0][1].query()):
        start, end = _PENDING_EVENTS.pop(0)
        end.synchronize()
        _add_seconds(start.elapsed_time(end) / 1e3)


def _add_seconds(seconds: float) -> None:
    stats = GATHER_STATS
    stats["seconds"] += seconds
    if stats["first_call_seconds"] is None:
        stats["first_call_seconds"] = seconds
        return
    for key, pick in (("min_call_seconds", min), ("max_call_seconds", max)):
        seen = stats[key]
        stats[key] = seconds if seen is None else pick(seen, seconds)


def reset_gather_stats() -> None:
    """Zero ``GATHER_STATS`` (and drop the events not yet read)."""
    _PENDING_EVENTS.clear()
    GATHER_STATS.update(calls=0, bytes=0, seconds=0.0,
                        first_call_seconds=None, min_call_seconds=None,
                        max_call_seconds=None)


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: ``devices[b]`` holds block ``b``, owned by
    process ``ranks[b]``; ``rank`` is this process and ``backend`` the
    process group's (None in a single process)."""

    devices: tuple
    axis_name: str = CLIENT_AXIS
    ranks: tuple = ()
    rank: int = 0
    backend: str | None = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def multiprocess(self) -> bool:
        """Whether gathers cross processes."""
        return self.backend is not None

    def is_local(self, b: int) -> bool:
        return self.ranks[b] == self.rank

    def local_blocks(self) -> list[int]:
        return [b for b in range(self.size) if self.is_local(b)]

    def describe(self) -> dict:
        """The run result's view: axis, devices, owning ranks, backend."""
        return {"axis": self.axis_name,
                "devices": [str(d) for d in self.devices],
                "ranks": list(self.ranks), "backend": self.backend}


def make_mesh(num_devices: int | None = None, axis_name: str = CLIENT_AXIS,
              device="cuda") -> Mesh:
    """A mesh of ``num_devices`` (None: every visible device; one CPU slot
    on the CPU) of ``device``'s kind, or of every process's device under a
    multi-process group. A shortfall raises ValueError."""
    if distributed_initialized() and process_count() > 1:
        names = [None] * process_count()
        dist.all_gather_object(names, str(local_device(device)),
                               group=host_group())
        devices = [torch.device(n) for n in names]
        ranks = list(range(len(devices)))
        backend = device_backend()
        where = f"one device per process, {len(devices)} processes"
    else:
        device = torch.device(device)
        if device.type == "cuda":
            count = (torch.cuda.device_count() if torch.cuda.is_available()
                     else 0)
            devices = [torch.device("cuda", i) for i in range(count)]
            where = f"{count} cuda device(s)"
        else:
            devices = [device] * (num_devices or 1)
            where = f"{device.type} slots"
        ranks = [0] * len(devices)
        backend = None
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} mesh devices but only "
                f"{len(devices)} visible ({where}; the PyTorch port never "
                "moves a CUDA run to the CPU, DLS_ALLOW_CPU_MESH_FALLBACK=1 "
                "included — pass device='cpu' to validate sharding on CPU "
                "slots)"
            )
        devices, ranks = devices[:num_devices], ranks[:num_devices]
    return Mesh(tuple(devices), axis_name, tuple(ranks), process_index(),
                backend)


def block_bounds(n_rows: int, k: int) -> np.ndarray:
    """Row bounds of ``k`` equal contiguous blocks: block ``b`` is rows
    ``bounds[b]:bounds[b + 1]``."""
    if n_rows % k:
        raise ValueError(f"{n_rows} rows do not split into {k} equal blocks")
    return np.arange(k + 1, dtype=np.int64) * (n_rows // k)


class Blocks:
    """A client-axis array (a tensor or a dict of tensors, the clients on
    the leading axis) split over a mesh: ``parts[b]`` holds rows
    ``bounds[b]:bounds[b + 1]`` on ``mesh.devices[b]``, or None where
    another process holds them. ``shape`` is the whole array's (None for a
    dict)."""

    def __init__(self, mesh: Mesh, parts: list, bounds: np.ndarray,
                 shape: tuple | None = None):
        self.mesh = mesh
        self.parts = list(parts)
        self.bounds = bounds
        self.shape = shape

    def block_of(self, rows) -> np.ndarray:
        """The block of each row."""
        return np.searchsorted(self.bounds, np.asarray(rows),
                               side="right") - 1

    def full(self, device):
        """The whole array on ``device`` (collective across processes)."""
        local = {b: self.parts[b] for b in self.mesh.local_blocks()}
        template = next(iter(local.values()), None)
        if template is None:
            raise ValueError("this process holds no block of the mesh")
        is_dict = isinstance(template, dict)
        parts = {b: (p if is_dict else {"": p}) for b, p in local.items()}
        leaves = parts[next(iter(parts))]
        spec = {k: (tuple(v.shape), v.dtype) for k, v in leaves.items()}
        got = gather_blocks(self.mesh, parts, spec, device)
        out = {k: v.reshape((-1,) + v.shape[2:]) for k, v in got.items()}
        return out if is_dict else out[""]


def shard_client_data(tree, mesh: Mesh):
    """Each leaf's leading (client) axis split over the mesh: a tensor or
    array, or a dict of them, becomes :class:`Blocks`; a tuple or list is
    split element by element; None passes through."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return tuple(shard_client_data(t, mesh) for t in tree)
    leaf = next(iter(tree.values())) if isinstance(tree, dict) else tree
    bounds = block_bounds(int(leaf.shape[0]), mesh.size)

    def place(b):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        return tree_map(
            lambda t: torch.as_tensor(t)[lo:hi].to(mesh.devices[b]), tree)

    return Blocks(mesh, [place(b) if mesh.is_local(b) else None
                         for b in range(mesh.size)], bounds,
                  None if isinstance(tree, dict) else tuple(leaf.shape))


def replicate(tree, mesh: Mesh) -> tuple:
    """``tree`` on every local device of the mesh (the same object where
    it already lives there), None for another process's devices."""
    return tuple(
        tree_map(lambda t: t.to(mesh.devices[b]), tree)
        if mesh.is_local(b) else None
        for b in range(mesh.size)
    )


def gather_blocks(mesh: Mesh, parts: dict, spec: dict, device) -> dict:
    """Every block's values on ``device``, stacked in block order.

    ``parts[b]`` (for each local block ``b``) is a dict ``{name:
    tensor}`` with the shapes and dtypes of ``spec`` (``{name: (shape,
    dtype)}``, the same for every block); returns ``{name: [mesh.size,
    *shape]}``. A single process copies; across processes each dtype's
    leaves travel packed in one ``all_gather`` of ``[blocks a rank,
    width]`` rows over the device group: on the card under NCCL, through
    host buffers under gloo. Both pack the same rows, so the bits do not
    depend on the backend."""
    names = list(spec)
    if not mesh.multiprocess:
        return {n: torch.stack([parts[b][n].to(device)
                                for b in range(mesh.size)])
                for n in names}
    per = max(Counter(mesh.ranks).values())
    slot = {}
    seen = Counter()
    for b, r in enumerate(mesh.ranks):
        slot[b] = seen[r]
        seen[r] += 1
    nccl = mesh.backend == "nccl"
    # NCCL gathers the tensors where they are (this rank's card); gloo from
    # host memory, pinned when there is a card.
    where = (mesh.devices[mesh.local_blocks()[0]] if nccl
             else torch.device("cpu"))
    pinned = not nccl and torch.cuda.is_available()
    group = device_group()
    out = {}
    for dtype in dict.fromkeys(dt for _, dt in spec.values()):
        group_names = [n for n in names if spec[n][1] == dtype]
        sizes = [int(np.prod(spec[n][0])) for n in group_names]
        width = sum(sizes)
        send = torch.zeros((per, width), dtype=dtype, device=where,
                           pin_memory=pinned)
        for b in mesh.local_blocks():
            row = send[slot[b]]
            off = 0
            for n, s in zip(group_names, sizes):
                row[off:off + s].copy_(parts[b][n].reshape(-1))
                off += s
        recv = [torch.empty_like(send, pin_memory=False)
                for _ in range(process_count())]
        if nccl:
            # The events bracket the gather on the compute stream: the
            # collective's stream waits for the blocks' work recorded
            # before ``start``, and the compute stream waits for the
            # collective before ``end`` (and before the sum that reads
            # ``recv``). Nothing here waits on the card.
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(where))
            dist.all_gather(recv, send, group=group)
            end.record(torch.cuda.current_stream(where))
            _PENDING_EVENTS.append((start, end))
            _drain_events(wait=False)
        else:
            t0 = time.perf_counter()
            dist.all_gather(recv, send, group=group)
            _add_seconds(time.perf_counter() - t0)
        GATHER_STATS["calls"] += 1
        GATHER_STATS["bytes"] += sum(t.numel() * t.element_size()
                                     for t in recv)
        rows = torch.stack([recv[mesh.ranks[b]][slot[b]]
                            for b in range(mesh.size)]).to(device)
        off = 0
        for n, s in zip(group_names, sizes):
            out[n] = rows[:, off:off + s].reshape(
                (mesh.size,) + tuple(spec[n][0]))
            off += s
    return out
