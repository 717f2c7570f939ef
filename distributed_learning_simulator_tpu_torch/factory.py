"""Algorithm registry: the JAX package's five names (factory.py there).

``fed``, ``sign_SGD`` and ``fed_quant`` are built; the two Shapley names
raise NotImplementedError naming the ROADMAP.md queue 1 item that ports
them; an unknown name raises RuntimeError naming all five, as in the JAX
package.
"""

from __future__ import annotations

from distributed_learning_simulator_tpu_torch.algorithms.fed_quant import (
    FedQuant,
)
from distributed_learning_simulator_tpu_torch.algorithms.fedavg import FedAvg
from distributed_learning_simulator_tpu_torch.algorithms.sign_sgd import (
    SignSGD,
)

_ALGORITHMS = {
    "fed": FedAvg,
    "sign_SGD": SignSGD,
    "fed_quant": FedQuant,
    "multiround_shapley_value": 10,
    "GTG_shapley_value": 10,
}


def registered_algorithms():
    return sorted(_ALGORITHMS)


def get_algorithm(name: str, config):
    """Instantiate the algorithm strategy registered under ``name``."""
    if name not in _ALGORITHMS:
        raise RuntimeError(
            f"unknown distributed algorithm {name!r}; "
            f"registered: {registered_algorithms()}"
        )
    algo = _ALGORITHMS[name]
    if isinstance(algo, int):
        raise NotImplementedError(
            f"algorithm {name!r} is not ported to the PyTorch package yet "
            f"(ROADMAP.md queue 1 item {algo})"
        )
    return algo(config)
