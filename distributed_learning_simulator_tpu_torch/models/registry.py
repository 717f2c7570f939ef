"""Model registry and parameter initialization (models/registry.py of the
JAX package), plus the flat parameter layout the engine trains on.

Names are case-insensitive and match the JAX registry. ``resnet18`` and
``resnet34`` are ported; the JAX package's other models raise
NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from distributed_learning_simulator_tpu_torch.models.resnet import (
    ResNet18,
    ResNet34,
    lecun_normal_,
)

_MODELS = {"resnet18": ResNet18, "resnet34": ResNet34}
_NOT_PORTED = ("lenet5", "cnn", "cifarcnn", "cnntpu", "tpucnn", "mlp")


def registered_models():
    return sorted(_MODELS)


def get_model(name: str, num_classes: int = 10, in_channels: int = 3,
              **kwargs) -> nn.Module:
    """Instantiate a model by registry name."""
    key = name.lower().replace("-", "").replace("_", "")
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to the PyTorch package yet "
            "(ROADMAP.md queue 1 item 18)"
        )
    if key not in _MODELS:
        raise ValueError(
            f"unknown model {name!r}; registered: {registered_models()}"
        )
    return _MODELS[key](num_classes=num_classes, in_channels=in_channels,
                        **kwargs)


def init_params(model: nn.Module, seed: int = 0) -> dict[str, torch.Tensor]:
    """Fresh f32 parameters on the CPU, drawn from an explicit generator.

    flax's defaults: ``lecun_normal`` (truncated normal, fan-in scaled) for
    conv and dense kernels, zeros for the dense bias, ones/zeros for the
    GroupNorm scale/bias. The draws differ from jax.random's, so parity with
    the JAX package is statistical; tests transplant parameters instead
    (models/bridge.py)."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, p in model.named_parameters():
        t = torch.empty(p.shape, dtype=torch.float32)
        if name.endswith(".scale"):
            t.fill_(1.0)
        elif name.endswith(".bias"):
            t.zero_()
        else:  # conv [O, I, H, W] or dense [out, in]: fan_in = I*H*W / in
            lecun_normal_(t, t[0].numel(), gen)
        params[name] = t
    return params


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
