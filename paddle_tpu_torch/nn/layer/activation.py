"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py)."""

from __future__ import annotations

from torch import nn

from .. import functional as F


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class GELU(nn.Module):
    def __init__(self, approximate: bool = False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)
