"""Algorithm registry: the JAX package's five names (factory.py there).
An unknown name raises RuntimeError naming all five, as in the JAX
package.
"""

from __future__ import annotations

from distributed_learning_simulator_tpu_torch.algorithms.fed_quant import (
    FedQuant,
)
from distributed_learning_simulator_tpu_torch.algorithms.fedavg import FedAvg
from distributed_learning_simulator_tpu_torch.algorithms.shapley import (
    GTGShapley,
    MultiRoundShapley,
)
from distributed_learning_simulator_tpu_torch.algorithms.sign_sgd import (
    SignSGD,
)

_ALGORITHMS = {
    "fed": FedAvg,
    "sign_SGD": SignSGD,
    "fed_quant": FedQuant,
    "multiround_shapley_value": MultiRoundShapley,
    "GTG_shapley_value": GTGShapley,
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
    return _ALGORITHMS[name](config)
