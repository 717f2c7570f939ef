"""distributed_learning_simulator_tpu_torch — the PyTorch/CUDA port of
``distributed_learning_simulator_tpu``.

A second package beside the JAX one, with the same module layout and names,
the same CLI flags and config fields, and the same registry names. It runs
on an NVIDIA GPU (``device="cuda"``, the default) or, for tests, on the CPU.
Every kernel the JAX package wrote in Pallas for the TPU is a kernel written
by hand for Hopper here (csrc/, ops/gn_cuda.py); what the JAX package left
to XLA, the port leaves to PyTorch.

The port imports torch and numpy, never jax and nothing of the JAX package.
Ported so far: synchronous FedAvg, sign_SGD and fed_quant on ResNet-18/34
(ROADMAP.md).
"""

__version__ = "0.1.0"

from distributed_learning_simulator_tpu_torch.config import (  # noqa: E402
    ExperimentConfig,
    get_config,
)
from distributed_learning_simulator_tpu_torch.factory import (  # noqa: E402
    get_algorithm,
    registered_algorithms,
)

__all__ = [
    "ExperimentConfig",
    "get_config",
    "get_algorithm",
    "registered_algorithms",
    "__version__",
]
