"""ctypes binding of the native (C++) runtime: the rendezvous queue and the
thread pool (runtime/native.py of the JAX package).

* :class:`NativeTaskQueue` — blocking rendezvous queue. Workers
  ``add_task(obj)`` and block on ``get_result()``; the server side either
  polls ``get_task()`` or registers ``worker_fun``, which a serve thread
  (blocked in the C++ ``get_task``) calls for every task. A ``worker_fun``
  return of None means no reply; a :class:`RepeatedResult` broadcasts its
  payload N times.
* :class:`NativeThreadPool` — ``exec(fn, *args)``, ``poll``,
  ``join_pending``, ``results`` and ``stop``: Python callables run on the
  C++ pool's threads through a ctypes trampoline (which takes the GIL).

Payloads cross the C boundary as pickle bytes, so a caller hands host
objects (numpy arrays, never CUDA tensors). The library is the repository's
``native/dls_runtime.cc``, read as it is: at first use ``g++`` compiles it
into the port's build directory (ops/_build.py ``build_dir()``, which
``.gitignore`` lists), under a name that carries a hash of the source and
the flags, written to a temporary name and renamed into place; a lock makes
one thread of the process build it. Nothing is written into ``native/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from typing import Any, Callable

from distributed_learning_simulator_tpu_torch.ops._build import build_dir
from distributed_learning_simulator_tpu_torch.utils.logging import get_logger

NATIVE_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "native", "dls_runtime.cc",
)
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib = None
_lib_lock = threading.Lock()

_CALLBACK_T = ctypes.CFUNCTYPE(None, ctypes.c_uint64)


def library_path() -> str:
    """Where the built library lives: the build directory, named by a hash
    of the source and the flags."""
    with open(NATIVE_SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(build_dir(), f"libdls_runtime_{digest}.so")


def _build_library(lib_path: str) -> None:
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    get_logger().info("building native runtime: %s", lib_path)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run(
        ["g++", *GXX_FLAGS, "-o", tmp, NATIVE_SOURCE, "-lpthread"],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed building {NATIVE_SOURCE} (exit {proc.returncode}):"
            f"\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(NATIVE_SOURCE):
            raise FileNotFoundError(
                f"native source not found: {NATIVE_SOURCE}")
        lib_path = library_path()
        if not os.path.exists(lib_path):
            _build_library(lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.dlsq_create.restype = ctypes.c_void_p
        lib.dlsq_destroy.argtypes = [ctypes.c_void_p]
        lib.dlsq_add_task.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t
        ]
        lib.dlsq_get_task.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.dlsq_put_result.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int
        ]
        lib.dlsq_get_result.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.dlsq_stop.argtypes = [ctypes.c_void_p]
        lib.dlsq_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        lib.dlsp_create.restype = ctypes.c_void_p
        lib.dlsp_create.argtypes = [ctypes.c_int]
        lib.dlsp_destroy.argtypes = [ctypes.c_void_p]
        lib.dlsp_submit.argtypes = [ctypes.c_void_p, _CALLBACK_T,
                                    ctypes.c_uint64]
        lib.dlsp_join_pending.argtypes = [ctypes.c_void_p]
        lib.dlsp_stop.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True if the native library is present or buildable."""
    try:
        _get_lib()
        return True
    except Exception:  # noqa: BLE001 - availability probe
        return False


@dataclass
class RepeatedResult:
    """One-to-N broadcast wrapper."""

    data: Any
    num: int


class NativeTaskQueue:
    """Blocking rendezvous queue backed by the C++ runtime.

    ``worker_fun``: if given, a serve thread consumes every task and calls
    ``worker_fun(task, extra_args)``; a non-None return is broadcast
    (:class:`RepeatedResult`) or enqueued once (any other object)."""

    def __init__(self, worker_fun: Callable | None = None, extra_args=None):
        self._lib = _get_lib()
        self._q = self._lib.dlsq_create()
        self._stopped = False
        self._server_thread = None
        if worker_fun is not None:
            self._server_thread = threading.Thread(
                target=self._serve, args=(worker_fun, extra_args), daemon=True
            )
            self._server_thread.start()

    def _take(self, getter) -> Any | None:
        out = ctypes.POINTER(ctypes.c_char)()
        out_len = ctypes.c_size_t()
        rc = getter(self._q, ctypes.byref(out), ctypes.byref(out_len))
        if rc != 0:
            return None  # stopped
        try:
            payload = ctypes.string_at(out, out_len.value)
        finally:
            self._lib.dlsq_free(out)
        return pickle.loads(payload)

    def _serve(self, worker_fun, extra_args):
        while True:
            task = self._take(self._lib.dlsq_get_task)
            if task is None:
                return
            result = worker_fun(task, extra_args)
            if result is None:
                continue
            try:
                if isinstance(result, RepeatedResult):
                    self.put_result(result.data, copies=result.num)
                else:
                    self.put_result(result, copies=1)
            except RuntimeError:
                # stop() raced the final broadcast; nobody is listening.
                return

    # ---- worker side -------------------------------------------------------
    def add_task(self, obj: Any) -> None:
        payload = pickle.dumps(obj)
        rc = self._lib.dlsq_add_task(self._q, payload, len(payload))
        if rc != 0:
            raise RuntimeError("queue is stopped")

    def get_result(self) -> Any:
        result = self._take(self._lib.dlsq_get_result)
        if result is None:
            raise RuntimeError("queue is stopped")
        return result

    # ---- server side -------------------------------------------------------
    def get_task(self) -> Any | None:
        """Blocking pop of one task; None once stopped."""
        return self._take(self._lib.dlsq_get_task)

    def put_result(self, obj: Any, copies: int = 1) -> None:
        self.put_result_pickled(pickle.dumps(obj), copies=copies)

    def put_result_pickled(self, payload: bytes, copies: int = 1) -> None:
        """Enqueue an already-pickled payload (a broadcast to N per-worker
        queues pickles once)."""
        rc = self._lib.dlsq_put_result(self._q, payload, len(payload), copies)
        if rc != 0:
            raise RuntimeError("queue is stopped")

    @property
    def stopped(self) -> bool:
        """True once :meth:`stop` was called: tells the benign
        stopped-queue race from a real enqueue failure."""
        return self._stopped

    def stop(self) -> None:
        if not self._stopped:
            self._stopped = True
            self._lib.dlsq_stop(self._q)
            if (
                self._server_thread is not None
                and self._server_thread is not threading.current_thread()
            ):
                # A full join: the serve thread exits once its current
                # callback (maybe the last round's aggregation and eval)
                # has finished, so no record is lost. A callback may stop
                # its own queue (the current-thread guard).
                self._server_thread.join()

    def __del__(self):
        try:
            self.stop()
            self._lib.dlsq_destroy(self._q)
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


class NativeThreadPool:
    """Python callables on the C++ pool's native threads (the ctypes
    trampoline takes the GIL; PyTorch releases it inside its kernels, so
    clients' work overlaps)."""

    def __init__(self, n_threads: int):
        self._lib = _get_lib()
        self._pool = self._lib.dlsp_create(n_threads)
        self._tasks: dict[int, tuple] = {}
        self._results: dict[int, Any] = {}
        self._errors: dict[int, BaseException] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        # The trampoline must outlive every pending call: keep a reference.
        self._trampoline = _CALLBACK_T(self._run_task)
        self._stopped = False

    def _run_task(self, task_id: int) -> None:
        with self._lock:
            fn, args, kwargs = self._tasks.pop(task_id)
        try:
            result = fn(*args, **kwargs)
            with self._lock:
                self._results[task_id] = result
        except BaseException as e:  # noqa: BLE001 - surfaced via results()
            with self._lock:
                self._errors[task_id] = e

    def exec(self, fn: Callable, *args, **kwargs) -> int:
        """Submit ``fn(*args, **kwargs)``; returns a task id."""
        with self._lock:
            task_id = self._next_id
            self._next_id += 1
            self._tasks[task_id] = (fn, args, kwargs)
        rc = self._lib.dlsp_submit(self._pool, self._trampoline, task_id)
        if rc != 0:
            with self._lock:
                self._tasks.pop(task_id, None)
            raise RuntimeError("pool is stopped")
        return task_id

    def join_pending(self) -> None:
        """Block until every submitted task has run."""
        self._lib.dlsp_join_pending(self._pool)

    def poll(self) -> tuple[int, int, bool]:
        """Non-blocking progress: ``(completed, submitted, any_error)``, so
        a coordinator can stop the rendezvous on the first error instead
        of joining workers blocked on a barrier that cannot fill."""
        with self._lock:
            done = len(self._results) + len(self._errors)
            return done, self._next_id, bool(self._errors)

    def results(self) -> dict[int, Any]:
        """Completed results by task id; raises the first captured error."""
        with self._lock:
            if self._errors:
                raise next(iter(self._errors.values()))
            return dict(self._results)

    def stop(self) -> None:
        """Join all pending work and shut the pool down."""
        if not self._stopped:
            self.join_pending()
            self._stopped = True
            self._lib.dlsp_stop(self._pool)

    def __del__(self):
        try:
            self.stop()
            self._lib.dlsp_destroy(self._pool)
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
