"""Profiling: torch.profiler sessions, named regions, and the reader of
their traces (utils/tracing.py of the JAX package, over torch.profiler).

``profile_session(profile_dir)`` records the enclosed rounds with CPU and
CUDA activities, ``record_shapes=True`` and ``with_flops=True``, one window
per training step (:func:`profile_step`), and writes each window's Chrome
trace (``<profile_dir>/<stamp>_<window>.pt.trace.json.gz``) when it
closes. ``annotate(name)`` is a ``torch.profiler.record_function`` range
that a window boundary splits: the range ends before the boundary and
starts again, under the same name, after it, so no range outlives the
profiler session it began in (one that did wrote its end into the stopped
session's freed state, and the process died some time later in the
profiler or in any allocation: the segfault of ``prof.step()`` ->
``stop_trace``).

The reader turns such a trace into device-op records:

* a **device op** is a ``kernel``, ``gpu_memcpy`` or ``gpu_memset`` event;
* it is tied to the CPU operator that launched it through the trace's
  correlation ids: the kernel's ``correlation`` names the runtime call
  (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cudaMemcpyAsync``, ...)
  with the same id, and the operators open on that thread at the call's
  time are the launch's operator stack, innermost last (a trace without
  runtime events falls back to the kernel's ``External id``);
* its **bytes** are the innermost operator's input tensor bytes, from the
  recorded shapes and dtypes (``Input Dims``, ``Input type``; the profiler
  records no output shapes), split evenly over that operator's device
  ops, so an operator's bytes count once;
* its **flops** come from the nearest operator on the stack that the
  profiler gave FLOPs (``with_flops``: the convolution and matmul
  operators), split evenly over the device ops under it; otherwise there
  are none, as on the JAX side. The Chrome trace does not carry the
  profiler's FLOPs, so the session writes them beside it
  (``<stamp>.pt.flops.json``: the operator's ``External id`` -> FLOPs)
  and the reader puts them back as the operator's ``flops`` arg.

A CPU-only trace has no device op, so the ledger is empty and the cost
model degrades with a warning, as the JAX package's does with a trace
that carries no byte annotations.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import threading
import time
import warnings

import torch

#: The trace files a profile directory holds (one per session).
TRACE_GLOB = "*.pt.trace.json*"

#: Device-side event categories of a torch.profiler (Kineto) trace.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: Bytes per element of the dtype names torch.profiler records.
_DTYPE_BYTES = {
    "float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
    "long int": 8, "int": 4, "short int": 2, "signed char": 1,
    "unsigned char": 1, "bool": 1, "c10::complex<float>": 8,
    "c10::complex<double>": 16,
}


def trace_files(trace_dir: str) -> list[str]:
    """The Chrome traces under ``trace_dir``, oldest first (a missing
    directory holds none). Every file is read, so a directory should hold
    one profiling session."""
    paths = glob.glob(os.path.join(trace_dir, "**", TRACE_GLOB),
                      recursive=True)
    return sorted(paths, key=os.path.getmtime)


def _flops_path(trace_path: str) -> str:
    return re.sub(r"\.pt\.trace\.json(\.gz)?$", ".pt.flops.json",
                  trace_path)


def _load(path: str) -> dict:
    """A trace, with the session's FLOPs file (if any) merged into its
    operators' args."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    flops_path = _flops_path(path)
    if os.path.exists(flops_path):
        with open(flops_path) as f:
            flops = {int(k): v for k, v in json.load(f).items()}
        for ev in data.get("traceEvents", []):
            if ev.get("cat") == "cpu_op":
                args = ev.get("args") or {}
                value = flops.get(args.get("External id"))
                if value:
                    args["flops"] = value
    return data


def _tensor_bytes(dims, dtype) -> int:
    """Bytes of one recorded input: a tensor's ``[d0, d1, ...]`` or a
    tensor list's ``[[...], ...]``; 0 for a scalar or an unknown dtype."""
    if not isinstance(dims, list) or not dims and not dtype:
        return 0
    if dims and isinstance(dims[0], list):
        return sum(_tensor_bytes(d, dtype) for d in dims)
    size = _DTYPE_BYTES.get(dtype, 0)
    n = 1
    for d in dims:
        n *= int(d)
    return size * n


def op_input_bytes(args: dict) -> int:
    """An operator's input tensor bytes from its recorded shapes."""
    dims = args.get("Input Dims") or []
    types = args.get("Input type") or []
    return sum(_tensor_bytes(d, t) for d, t in zip(dims, types))


def _launch_stacks(events: list[dict], calls: list[dict]) -> list[list]:
    """For each runtime call of ``calls``, the ``cpu_op`` events open on its
    thread at its time, outermost first: one sweep per thread over the
    operators (which nest) and the calls, in time order."""
    ops_by_tid: dict = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "cpu_op":
            ops_by_tid.setdefault((ev.get("pid"), ev.get("tid")),
                                  []).append(ev)
    calls_by_tid: dict = {}
    for i, call in enumerate(calls):
        calls_by_tid.setdefault((call.get("pid"), call.get("tid")),
                                []).append(i)
    out: list[list] = [[] for _ in calls]
    for key, idxs in calls_by_tid.items():
        ops = sorted(ops_by_tid.get(key, ()),
                     key=lambda e: (float(e.get("ts", 0.0)),
                                    -float(e.get("dur", 0.0))))
        idxs.sort(key=lambda i: float(calls[i].get("ts", 0.0)))
        stack: list[dict] = []
        j = 0
        for i in idxs:
            t = float(calls[i].get("ts", 0.0))
            while j < len(ops) and float(ops[j].get("ts", 0.0)) <= t:
                op = ops[j]
                j += 1
                start = float(op.get("ts", 0.0))
                while stack and (float(stack[-1].get("ts", 0.0))
                                 + float(stack[-1].get("dur", 0.0))) < start:
                    stack.pop()
                stack.append(op)
            while stack and (float(stack[-1].get("ts", 0.0))
                             + float(stack[-1].get("dur", 0.0))) < t:
                stack.pop()
            out[i] = list(stack)
    return out


def iter_device_ops(trace_dir: str):
    """Yield one record per device op of the traces under ``trace_dir``:
    ``{"name", "dur" (µs), "op" (innermost launching operator's name or
    ""), "ops" (the stack's names, outermost first), "bytes", "flops",
    "input_types"}``. A missing or empty directory yields nothing."""
    for path in trace_files(trace_dir):
        events = _load(path).get("traceEvents", [])
        runtime = {}
        by_external = {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            args = ev.get("args") or {}
            if ev.get("cat") == "cuda_runtime" and "correlation" in args:
                runtime[args["correlation"]] = ev
            elif ev.get("cat") == "cpu_op" and "External id" in args:
                by_external[args["External id"]] = ev
        device = [ev for ev in events
                  if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]
        calls = [runtime.get((ev.get("args") or {}).get("correlation"))
                 for ev in device]
        found = [c for c in calls if c is not None]
        call_stacks = iter(_launch_stacks(events, found))
        stacks = []
        for ev, call in zip(device, calls):
            if call is not None:
                stacks.append(next(call_stacks))
            else:
                op = by_external.get((ev.get("args") or {}).get(
                    "External id"))
                stacks.append([op] if op is not None else [])
        # Each operator's bytes and flops are split over its device ops.
        n_inner: dict[int, int] = {}
        n_owned: dict[int, int] = {}
        flops_owner = []
        for stack in stacks:
            if stack:
                n_inner[id(stack[-1])] = n_inner.get(id(stack[-1]), 0) + 1
            owner = next((op for op in reversed(stack)
                          if (op.get("args") or {}).get("flops")), None)
            flops_owner.append(owner)
            if owner is not None:
                n_owned[id(owner)] = n_owned.get(id(owner), 0) + 1
        for ev, stack, owner in zip(device, stacks, flops_owner):
            inner = stack[-1] if stack else None
            iargs = (inner.get("args") or {}) if inner is not None else {}
            nbytes = 0.0
            if inner is not None:
                nbytes = op_input_bytes(iargs) / n_inner[id(inner)]
            flops = 0.0
            if owner is not None:
                flops = float(owner["args"]["flops"]) / n_owned[id(owner)]
            yield {
                "name": ev.get("name", ""),
                "dur": float(ev.get("dur", 0.0)),
                "op": inner.get("name", "") if inner is not None else "",
                "ops": [op.get("name", "") for op in stack],
                "bytes": nbytes,
                "flops": flops,
                "input_types": list(iargs.get("Input type") or []),
            }


def parse_device_trace(trace_dir: str) -> dict:
    """``{"device_ms", "bytes_gb", "op_count"}`` summed over
    :func:`iter_device_ops`."""
    device_us = 0.0
    bytes_total = 0.0
    op_count = 0
    for rec in iter_device_ops(trace_dir):
        device_us += rec["dur"]
        bytes_total += rec["bytes"]
        op_count += 1
    return {
        "device_ms": device_us / 1e3,
        "bytes_gb": bytes_total / 2**30,
        "op_count": op_count,
    }


#: Op classes of the cost model (telemetry/costmodel.py): every device op
#: lands in exactly one. ``group_norm`` is the port's own: the two GN
#: kernels (``dls::group_norm``, ``dls::gn_stats``, ``dls::gn_normalize``).
OP_CLASSES = (
    "matmul_conv",   # tensor-core work: convolutions, matmuls, the wgrad
    "group_norm",    # the GN stats and normalize kernels
    "elementwise",   # pointwise math, reductions, casts, the hash dither
    "copy_layout",   # data movement: copies, transposes, memcpy/memset
    "collective",    # cross-device: NCCL
    "decode",        # the uint8 shard decode (compact_client_data)
    "other",
)

#: Stage rules by the launching operator's recorded shapes (the JAX
#: package's STAGE_RULES read XLA long names; the port matches the
#: ``ops`` stack and kernel name instead). First match wins.
STAGE_RULES = [
    ("wgrad", r"dls::conv3x3_wgrad|wgrad_"),
    ("group_norm", r"dls::(group_norm|gn_stats|gn_normalize)|gn_"),
    ("conv", r"dls::conv_nhwc|convolution|cudnn|conv"),
    ("gemm", r"gemm|addmm|aten::mm|matmul|linear"),
    ("decode", r"unsigned char"),
]

_COLLECTIVE_MARKS = ("nccl", "all_reduce", "allreduce", "all_gather",
                     "reduce_scatter", "all_to_all", "broadcast_")
_GN_OPS = ("dls::group_norm", "dls::gn_stats", "dls::gn_normalize")
_MATMUL_OPS = ("dls::conv_nhwc", "dls::conv_nhwc_dx", "dls::conv_nhwc_dw",
               "dls::conv3x3_wgrad", "aten::convolution",
               "aten::_convolution", "aten::cudnn_convolution",
               "aten::convolution_backward", "aten::mm", "aten::addmm",
               "aten::bmm", "aten::matmul", "aten::linear",
               "aten::baddbmm", "aten::tensordot")
_MATMUL_KERNEL_MARKS = ("gemm", "cudnn", "xmma", "cutlass", "conv",
                        "wgrad", "sm90_", "sm80_", "dgrad", "implicit")
_COPY_OPS = ("aten::copy_", "aten::contiguous", "aten::clone",
             "aten::to", "aten::_to_copy", "aten::permute",
             "aten::transpose", "aten::cat", "aten::stack")


def classify_op(name: str, ops=(), input_types=()) -> str:
    """One device op's :data:`OP_CLASSES` bucket from its kernel ``name``,
    its launching operator stack ``ops`` (outermost first) and the
    innermost operator's ``input_types``. Order is part of the contract
    (tests/test_torch_costmodel.py): collectives first; the port's GN ops
    and the convolution/matmul ops (ops/conv.py's custom ops, the wgrad
    kernel, cuDNN and cuBLAS) by the stack, whatever kernel they launch;
    memcpy/memset and copy operators as layout; a uint8 input as the
    decode; everything else launched by an operator as elementwise."""
    lowered = name.lower()
    stack = [o.lower() for o in ops]
    if any(m in lowered for m in _COLLECTIVE_MARKS) or any(
            "c10d::" in o or "nccl" in o for o in stack):
        return "collective"
    if any(o in _GN_OPS for o in ops) or lowered.startswith("gn_"):
        return "group_norm"
    if any(o in _MATMUL_OPS for o in ops) or any(
            m in lowered for m in _MATMUL_KERNEL_MARKS):
        return "matmul_conv"
    if lowered.startswith(("memcpy", "memset")):
        return "copy_layout"
    inner = ops[-1] if ops else ""
    if inner in _COPY_OPS and "unsigned char" not in input_types:
        return "copy_layout"
    if "unsigned char" in input_types:
        return "decode"
    if ops:
        return "elementwise"
    return "other"


def categorize_long_name(long_name: str, rules=STAGE_RULES) -> str:
    """First-match rule category of a text (the stage attribution);
    "other" when no rule matches."""
    for cat, pat in rules:
        if re.search(pat, long_name):
            return cat
    return "other"


def categorize_ops(trace_dir: str, rules=None) -> dict[str, dict]:
    """The categorized op ledger of a trace directory, the cost model's
    input: per category ``{"device_ms", "bytes_gb", "flops_g",
    "op_count"}`` over :func:`iter_device_ops` (so its totals reconcile
    with :func:`parse_device_trace`). ``rules=None`` classifies by
    :func:`classify_op`; an ordered ``[(category, regex), ...]`` list
    (e.g. :data:`STAGE_RULES`) matches the kernel name, the operator stack
    and the input types joined into one line. A missing or empty trace
    directory gives an empty ledger."""
    ledger: dict[str, dict] = {}
    for rec in iter_device_ops(trace_dir):
        if rules is not None:
            text = " ".join([rec["name"], *rec["ops"],
                             *rec["input_types"]])
            cat = categorize_long_name(text, rules)
        else:
            cat = classify_op(rec["name"], rec["ops"], rec["input_types"])
        entry = ledger.setdefault(cat, {
            "device_ms": 0.0, "bytes_gb": 0.0, "flops_g": 0.0,
            "op_count": 0,
        })
        entry["device_ms"] += rec["dur"] / 1e3
        entry["bytes_gb"] += rec["bytes"] / 2**30
        entry["flops_g"] += rec["flops"] / 1e9
        entry["op_count"] += 1
    return ledger


def _aggregate_device_ops(trace_dir: str, key: str = "name"
                          ) -> dict[str, dict]:
    """Per kernel name (or per launching operator, ``key="op"``) bytes,
    time and count over one pass of :func:`iter_device_ops`."""
    agg: dict[str, dict] = {}
    for rec in iter_device_ops(trace_dir):
        name = rec[key] or "<unnamed>"
        entry = agg.setdefault(
            name, {"name": name, "bytes_gb": 0.0, "device_ms": 0.0,
                   "count": 0}
        )
        entry["bytes_gb"] += rec["bytes"]
        entry["device_ms"] += rec["dur"] / 1e3
        entry["count"] += 1
    for entry in agg.values():
        entry["bytes_gb"] = entry["bytes_gb"] / 2**30
    return agg


def _rank_ops(agg: dict[str, dict], k: int, by: str) -> list[dict]:
    if by not in ("bytes", "time"):
        raise ValueError(f"by must be 'bytes' or 'time', got {by!r}")
    ranked = sorted(
        agg.values(),
        key=(
            (lambda e: (e["bytes_gb"], e["device_ms"])) if by == "bytes"
            else (lambda e: (e["device_ms"], e["bytes_gb"]))
        ),
        reverse=True,
    )
    return ranked[:k]


def top_device_ops(trace_dir: str, k: int = 10,
                   by: str = "bytes") -> list[dict]:
    """The top ``k`` device ops by kernel name, ranked ``by`` "bytes"
    (time breaking ties) or "time" (bytes breaking ties)."""
    return _rank_ops(_aggregate_device_ops(trace_dir), k, by)


def device_op_report(trace_dir: str, k: int = 10) -> dict:
    """``{"totals", "by_bytes", "by_time"}`` of a trace directory in one
    read."""
    agg = _aggregate_device_ops(trace_dir)
    return {
        "totals": {
            "device_ms": sum(e["device_ms"] for e in agg.values()),
            "bytes_gb": sum(e["bytes_gb"] for e in agg.values()),
            "op_count": sum(e["count"] for e in agg.values()),
        },
        "by_bytes": _rank_ops(agg, k, "bytes"),
        "by_time": _rank_ops(agg, k, "time"),
    }


_OPEN = threading.local()


class annotate(contextlib.ContextDecorator):
    """A named region in the profiler's trace (``record_function``), kept
    on this thread's stack of open regions so that :func:`profile_step`
    can split it at a window boundary."""

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def _open(self) -> None:
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()

    def _close(self) -> None:
        self._range.__exit__(None, None, None)
        self._range = None

    def __enter__(self):
        self._open()
        _open_regions().append(self)
        return self

    def __exit__(self, *exc):
        _open_regions().remove(self)
        self._close()
        return False


def _open_regions() -> list:
    """This thread's open :class:`annotate` regions, outermost first."""
    if not hasattr(_OPEN, "regions"):
        _OPEN.regions = []
    return _OPEN.regions


def _between_regions(action) -> None:
    """``action()`` (a profiler start, step or stop) with this thread's
    open regions ended before it and started again after it."""
    regions = _open_regions()
    for region in reversed(regions):
        region._close()
    try:
        with warnings.catch_warnings():
            # A one-step window has no warmup, and each window's events
            # are its own: both on purpose.
            warnings.simplefilter("ignore")
            action()
    finally:
        for region in regions:
            region._open()


#: The open profiling session (one at a time), for :func:`profile_step`.
_SESSION: dict = {"prof": None}


def _synchronize_cards_in_use() -> None:
    """Wait for the cards this process holds a context on: a rank that
    sees every card of its node neither waits on the others' nor makes a
    context there."""
    if not torch.cuda.is_available():
        return
    for index in range(torch.cuda.device_count()):
        if torch._C._cuda_hasPrimaryContext(index):
            torch.cuda.synchronize(index)


def profile_step() -> None:
    """A training-step boundary: when a :func:`profile_session` is open,
    its current window closes (written as a trace of its own) and the next
    one opens. Nothing without a session. The chunk train functions call
    it after each step."""
    prof = _SESSION["prof"]
    if prof is None:
        return
    # The window's kernels finish inside it, on every card in use.
    _synchronize_cards_in_use()
    # The open regions end in this window and start again in the next
    # (module docstring).
    _between_regions(prof.step)


@contextlib.contextmanager
def profile_session(profile_dir: str | None):
    """Profile the enclosed block into ``profile_dir`` (nothing if None):
    CPU activity, and CUDA activity when a card is present, with shapes
    and FLOPs recorded.

    The session is a run of windows, one per training step
    (:func:`profile_step`) and one for whatever follows the last step,
    each written when it closes as ``<stamp>_<window>.pt.trace.json.gz``
    with its ``.pt.flops.json``; the reader sums every trace in the
    directory. With recorded shapes the profiler keeps a weak reference to
    each operator's inputs until its window's results are dropped, and a
    weak reference to one of functorch's batched tensors keeps the tensor
    it wraps alive: over a whole session that held every activation of
    every vmapped step (tens of GB at a ResNet-18 chunk). A window holds
    one step's."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    # Recorded shapes come with each operator's "Concrete Inputs", which
    # hold the inputs themselves; the reader needs only shapes and dtypes.
    concrete = getattr(torch._C._profiler,
                       "_set_record_concrete_inputs_enabled_val", None)
    if concrete is not None:
        concrete(False)
    base = os.path.join(profile_dir, time.strftime("%Y%m%d_%H%M%S")
                        + f"_{os.getpid()}")
    windows = iter(range(1_000_000))

    def write(p) -> None:
        path = f"{base}_{next(windows):05d}"
        # The operators' FLOPs by their trace ``External id`` (the Kineto
        # event's correlation id).
        flops = {
            str(e.correlation_id()): int(e.flops())
            for e in p.profiler.kineto_results.events() if e.flops()
        }
        with open(path + ".pt.flops.json", "w") as f:
            json.dump(flops, f)
        p.export_chrome_trace(path + ".pt.trace.json.gz")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prof = torch.profiler.profile(
            activities=activities, record_shapes=True, with_flops=True,
            schedule=torch.profiler.schedule(wait=0, warmup=0, active=1),
            on_trace_ready=write)
    _between_regions(prof.start)
    _SESSION["prof"] = prof
    try:
        yield
    finally:
        _SESSION["prof"] = None
        _synchronize_cards_in_use()
        _between_regions(prof.stop)
        if concrete is not None:
            concrete(True)
