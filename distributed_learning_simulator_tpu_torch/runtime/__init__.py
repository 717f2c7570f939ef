"""The native runtime's Python binding (runtime/ of the JAX package)."""

from distributed_learning_simulator_tpu_torch.runtime.native import (
    NativeTaskQueue,
    NativeThreadPool,
    RepeatedResult,
    native_available,
)

__all__ = [
    "NativeTaskQueue",
    "NativeThreadPool",
    "RepeatedResult",
    "native_available",
]
