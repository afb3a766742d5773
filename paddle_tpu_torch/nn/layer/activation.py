"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py)."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return F.relu6(x)


class GELU(Layer):
    def __init__(self, approximate: bool = False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Tanh(Layer):
    def forward(self, x):
        return F.tanh(x)

