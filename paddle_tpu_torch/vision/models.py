"""LeNet and the ResNet family (counterpart of
paddle_tpu/vision/models.py:20-136).

The structure and the attribute names are the reference's (`conv1`,
`bn1`, `layer1` ... `layer4`, `downsample`, `fc`; Paddle's (in, out)
`Linear`), so `jit.functional_state` and `state_dict` keys such as
`layer1.0.downsample.1._mean` line up and `convert.load_jax_state` (or
`set_state_dict`) carries a JAX model's weights and running statistics
over.  Every module is an `nn.Layer` built in the reference's order, so
under the same `unique_name` counters its parameters get the
reference's names (`conv2d_0.w_0`, ...).

Weights are made on the CPU in float32 from a torch.Generator seeded with
`seed`, then moved to `device` (default cuda; raises without CUDA unless
device="cpu") and cast to `dtype`.  On the card the 4-D weights take
`torch.channels_last`; shapes stay NCHW, as the reference's modules see
them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import device as _device
from ..nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Flatten, Layer,
                  Linear, MaxPool2D, ReLU, Sequential)

__all__ = ["LeNet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]


def _place(module: nn.Module, device, dtype) -> nn.Module:
    dev = _device.resolve(device)
    module.to(device=dev, dtype=dtype)
    if dev.type == "cuda":
        module.to(memory_format=torch.channels_last)
    return module


class LeNet(Layer):
    def __init__(self, num_classes=10, device=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, generator=g), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, generator=g), ReLU(),
            MaxPool2D(2, 2))
        self.flatten = Flatten()
        self.fc = Sequential(
            Linear(400, 120, generator=g), ReLU(),
            Linear(120, 84, generator=g), ReLU(),
            Linear(84, num_classes, generator=g))
        _place(self, device, dtype)

    def forward(self, x):
        return self.fc(self.flatten(self.features(x)))


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 generator=None):
        super().__init__()
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, generator=generator)
        self.bn1 = BatchNorm2D(planes)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            generator=generator)
        self.bn2 = BatchNorm2D(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 generator=None):
        super().__init__()
        self.conv1 = Conv2D(inplanes, planes, 1, bias_attr=False,
                            generator=generator)
        self.bn1 = BatchNorm2D(planes)
        self.conv2 = Conv2D(planes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, generator=generator)
        self.bn2 = BatchNorm2D(planes)
        self.conv3 = Conv2D(planes, planes * 4, 1, bias_attr=False,
                            generator=generator)
        self.bn3 = BatchNorm2D(planes * 4)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(Layer):
    def __init__(self, block, depth_cfg, num_classes=1000, in_ch=3,
                 device=None, dtype: Optional[torch.dtype] = None,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.inplanes = 64
        self.conv1 = Conv2D(in_ch, 64, 7, stride=2, padding=3,
                            bias_attr=False, generator=g)
        self.bn1 = BatchNorm2D(64)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, depth_cfg[0], 1, g)
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], 2, g)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], 2, g)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], 2, g)
        self.avgpool = AdaptiveAvgPool2D(1)
        self.flatten = Flatten()
        self.fc = Linear(512 * block.expansion, num_classes, generator=g)
        _place(self, device, dtype)

    def _make_layer(self, block, planes, n, stride, g):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, generator=g),
                BatchNorm2D(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample, g)]
        self.inplanes = planes * block.expansion
        for _ in range(1, n):
            layers.append(block(self.inplanes, planes, generator=g))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(self.flatten(self.avgpool(x)))


def resnet18(num_classes=1000, **kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, **kw)


def resnet34(num_classes=1000, **kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet50(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet101(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes, **kw)


def resnet152(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], num_classes, **kw)
