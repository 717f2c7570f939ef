"""Model registry and parameter initialization (models/registry.py of the
JAX package), plus the flat parameter layout the engine trains on.

Names are case-insensitive (``-`` and ``_`` dropped) and are the JAX
registry's eight: ``lenet5``, ``cnn``/``cifarcnn``, ``cnntpu``/``tpucnn``,
``resnet18``, ``resnet34`` and ``mlp``. ``init_params`` returns the JAX
package's own initial draws (models/flax_init.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from distributed_learning_simulator_tpu_torch.models import flax_init
from distributed_learning_simulator_tpu_torch.models.cnn import (
    MLP,
    CifarCNN,
    TpuCifarCNN,
)
from distributed_learning_simulator_tpu_torch.models.lenet import LeNet5
from distributed_learning_simulator_tpu_torch.models.resnet import (
    ResNet18,
    ResNet34,
)

_MODELS = {
    "lenet5": LeNet5,
    "cnn": CifarCNN,
    "cifarcnn": CifarCNN,
    "cnntpu": TpuCifarCNN,
    "tpucnn": TpuCifarCNN,
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "mlp": MLP,
}


def registered_models():
    return sorted(_MODELS)


def get_model(name: str, num_classes: int = 10,
              input_shape: tuple[int, int, int] = (32, 32, 3),
              **kwargs) -> nn.Module:
    """Instantiate a model by registry name for ``[B, *input_shape]`` NHWC
    inputs (the JAX modules infer the input size from their first input;
    the port's layers are sized from ``input_shape``)."""
    key = name.lower().replace("-", "").replace("_", "")
    if key not in _MODELS:
        raise ValueError(
            f"unknown model {name!r}; registered: {registered_models()}"
        )
    cls = _MODELS[key]
    if cls in (ResNet18, ResNet34):
        return cls(num_classes=num_classes, in_channels=input_shape[-1],
                   **kwargs)
    return cls(num_classes=num_classes, input_shape=tuple(input_shape),
               **kwargs)


def init_params(model: nn.Module, input_hw: tuple[int, int],
                seed: int = 0) -> dict[str, torch.Tensor]:
    """The JAX package's initial parameters for ``model`` on inputs of
    spatial size ``input_hw`` and ``seed``, as f32 CPU tensors."""
    return flax_init.init_params(model, input_hw, seed)


@dataclass(frozen=True)
class ParamLayout:
    """One flat parameter vector <-> named parameter views.

    The engine keeps each model as ONE flat tensor (the f32 global model,
    each client's local copy, its gradient and momentum), so the optimizer,
    the stochastic rounding and the aggregation are a handful of flat ops.
    ``names`` fixes the leaf order: models/bridge.py supplies the JAX
    package's ``tree_flatten`` order, which is the order the stochastic
    rounding salts advance in."""

    names: tuple[str, ...]
    shapes: tuple[torch.Size, ...]

    @classmethod
    def from_params(cls, params: dict[str, torch.Tensor], names) -> "ParamLayout":
        names = tuple(names)
        if sorted(names) != sorted(params):
            raise ValueError("layout names must cover the parameters exactly")
        return cls(names, tuple(params[n].shape for n in names))

    @property
    def numels(self) -> list[int]:
        return [s.numel() for s in self.shapes]

    def flatten(self, params: dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([params[n].reshape(-1) for n in self.names])

    def unflatten(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Views into ``flat`` (``split`` keeps the backward one ``cat``)."""
        parts = flat.split(self.numels)
        return {n: p.view(s) for n, p, s in zip(self.names, parts, self.shapes)}
