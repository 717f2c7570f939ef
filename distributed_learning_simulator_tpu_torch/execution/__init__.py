"""Execution modes beside the vmap round loop (execution/ of the JAX
package): the threaded oracle."""

from distributed_learning_simulator_tpu_torch.execution.threaded import (
    ThreadedServer,
    ThreadedWorker,
    run_threaded_simulation,
)

__all__ = ["ThreadedServer", "ThreadedWorker", "run_threaded_simulation"]
