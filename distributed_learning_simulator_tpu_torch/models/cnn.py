"""The CIFAR CNNs and the tiny MLP (models/cnn.py of the JAX package) on NHWC
inputs.

Numerics follow the flax modules. ``CifarCNN`` and ``TpuCifarCNN`` compute
in ``dtype`` (bf16 by default): the input and each kernel are cast to it,
each convolution returns it, and its bias is added to that output in the
same dtype as a separate operation (flax rounds the convolution, then the
sum; a bias fused into the convolution's accumulation would round once).
``relu`` and ``max_pool`` are exact; the global mean pool sums and divides
in f32 and casts the mean back to ``dtype``; the dense head is f32 with f32
logits (models/resnet.py ``Dense``). ``MLP`` is f32 throughout and flattens
the NHWC sample in (h, w, c) order, as the JAX module does.

The convolutions are ops/conv.py's ``conv_nhwc``: under the chunk's
``torch.func.vmap`` they run as grouped channels-last convolutions, one for
the whole chunk, and the biases, relus and pools act on the stacked models.

The submodules are named after flax's auto-names (``Conv_0`` -> ``conv0``,
``Dense_0`` -> ``dense0``), which is how models/bridge.py maps the two
parameter trees.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_learning_simulator_tpu_torch.models.resnet import (
    Dense,
    resolve_dtype,
    same_conv,
)
from distributed_learning_simulator_tpu_torch.ops.conv import conv_nhwc


class Conv(nn.Module):
    """flax ``nn.Conv`` with a bias on NHWC tensors: ``padding`` is
    ``"SAME"`` (XLA's split, the extra row/column at the high end) or
    ``"VALID"``; ``dtype=None`` computes in the input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: str = "SAME", dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding = stride, padding
        self.dtype = None if dtype is None else resolve_dtype(dtype)

    def forward(self, x):
        dt = self.dtype or x.dtype
        if self.padding == "SAME":
            y = same_conv(x.to(dt), self.weight.to(dt), self.stride)
        else:
            y = conv_nhwc(x.to(dt), self.weight.to(dt), self.stride, 0)
        return y + self.bias.to(dt)


def max_pool(x, k: int):
    """flax ``max_pool`` with a k x k window and stride k, VALID, NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def avg_pool(x, k: int):
    """flax ``avg_pool`` with a k x k window and stride k, VALID, NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def mean_pool(x, dtype):
    """``jnp.mean(x, axis=(1, 2))``: an f32 sum and division, cast to
    ``dtype``."""
    return x.float().mean(dim=(1, 2)).to(dtype)


class CifarCNN(nn.Module):
    """Conv-pool x3 with a global-average-pool head (``CifarCNN``)."""

    def __init__(self, num_classes: int = 10, width: int = 32,
                 dtype=torch.bfloat16, input_shape=(32, 32, 3)):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        w, cin = width, input_shape[-1]
        self.conv0 = Conv(cin, w, 3, dtype=self.dtype)
        self.conv1 = Conv(w, 2 * w, 3, dtype=self.dtype)
        self.conv2 = Conv(2 * w, 4 * w, 3, dtype=self.dtype)
        self.dense0 = Dense(4 * w, num_classes)

    def forward(self, x):
        x = x.to(self.dtype)
        x = max_pool(F.relu(self.conv0(x)), 2)
        x = max_pool(F.relu(self.conv1(x)), 2)
        x = F.relu(self.conv2(x))
        return self.dense0(mean_pool(x, self.dtype)).float()


class TpuCifarCNN(nn.Module):
    """4x4 stride-4 patch embedding to ``width`` channels, two 3x3 convs,
    one max pool and a global-average-pool head (``TpuCifarCNN``, the
    headline workload's model)."""

    def __init__(self, num_classes: int = 10, width: int = 128,
                 dtype=torch.bfloat16, input_shape=(32, 32, 3)):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        w, cin = width, input_shape[-1]
        self.conv0 = Conv(cin, w, 4, stride=4, padding="VALID",
                          dtype=self.dtype)
        self.conv1 = Conv(w, w, 3, dtype=self.dtype)
        self.conv2 = Conv(w, 2 * w, 3, dtype=self.dtype)
        self.dense0 = Dense(2 * w, num_classes)

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(self.conv0(x))
        x = max_pool(F.relu(self.conv1(x)), 2)
        x = F.relu(self.conv2(x))
        return self.dense0(mean_pool(x, self.dtype)).float()


class MLP(nn.Module):
    """Flatten, one hidden ReLU layer, f32 (``MLP``)."""

    def __init__(self, num_classes: int = 10, hidden: int = 64,
                 input_shape=(32, 32, 3)):
        super().__init__()
        self.dense0 = Dense(math.prod(input_shape), hidden)
        self.dense1 = Dense(hidden, num_classes)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.dense1(F.relu(self.dense0(x))).float()
