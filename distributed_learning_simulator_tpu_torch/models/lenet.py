"""LeNet-5 for 28x28 grayscale inputs (models/lenet.py of the JAX package), on
NHWC inputs and in f32 throughout: a SAME then a VALID 5x5 convolution, each
followed by ReLU and a 2x2 average pool (no padding), and three dense
layers over the NHWC sample flattened in (h, w, c) order."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from distributed_learning_simulator_tpu_torch.models.cnn import (
    Conv,
    avg_pool,
)
from distributed_learning_simulator_tpu_torch.models.resnet import Dense


class LeNet5(nn.Module):
    def __init__(self, num_classes: int = 10, input_shape=(28, 28, 1)):
        super().__init__()
        h, w, cin = input_shape
        self.conv0 = Conv(cin, 6, 5, padding="SAME")
        self.conv1 = Conv(6, 16, 5, padding="VALID")
        flat = ((h // 2 - 4) // 2) * ((w // 2 - 4) // 2) * 16
        self.dense0 = Dense(flat, 120)
        self.dense1 = Dense(120, 84)
        self.dense2 = Dense(84, num_classes)

    def forward(self, x):
        x = avg_pool(F.relu(self.conv0(x)), 2)
        x = avg_pool(F.relu(self.conv1(x)), 2)
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.dense0(x))
        x = F.relu(self.dense1(x))
        return self.dense2(x).float()
