"""LeNet, the ResNet family, VGG and MobileNet V1/V2 (counterpart of
paddle_tpu/vision/models.py).

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
from ..nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Flatten,
                  Layer, Linear, MaxPool2D, ReLU, ReLU6, Sequential)

__all__ = ["LeNet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "VGG",
           "vgg11", "vgg13", "vgg16", "vgg19", "MobileNetV1", "MobileNetV2",
           "mobilenet_v1", "mobilenet_v2"]


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


# -- VGG and MobileNet (paddle_tpu/vision/models.py:138-317) ------------------

def _make_divisible(v, divisor=8, min_value=None):
    """Channel counts rounded to multiples of `divisor`, never more than
    10 % below `v` (the reference's mobilenetv2 rule)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class VGG(Layer):
    """VGG: the conv stages `features`, an adaptive pool to 7 x 7 (with
    `with_pool`) and the three-layer classifier with Dropout(0.5)."""

    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, dtype: Optional[torch.dtype] = None,
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else \
            torch.Generator().manual_seed(seed)
        self.features = features
        self.with_pool = with_pool
        self.flatten = Flatten()
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        self.classifier = Sequential(
            Linear(512 * 7 * 7, 4096, generator=g), ReLU(),
            Dropout(generator=g), Linear(4096, 4096, generator=g), ReLU(),
            Dropout(generator=g), Linear(4096, num_classes, generator=g))
        _place(self, device, dtype)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        return self.classifier(self.flatten(x))


_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _vgg_features(cfg, batch_norm, generator):
    layers, in_ch = [], 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_ch, v, 3, padding=1,
                                 generator=generator))
            if batch_norm:
                layers.append(BatchNorm2D(v))
            layers.append(ReLU())
            in_ch = v
    return Sequential(*layers)


def _vgg(cfg, batch_norm, seed, kw):
    g = torch.Generator().manual_seed(seed)
    return VGG(_vgg_features(_VGG_CFGS[cfg], batch_norm, g), generator=g,
               **kw)


def vgg11(batch_norm=False, *, seed: int = 0, **kw):
    return _vgg("A", batch_norm, seed, kw)


def vgg13(batch_norm=False, *, seed: int = 0, **kw):
    return _vgg("B", batch_norm, seed, kw)


def vgg16(batch_norm=False, *, seed: int = 0, **kw):
    return _vgg("D", batch_norm, seed, kw)


def vgg19(batch_norm=False, *, seed: int = 0, **kw):
    return _vgg("E", batch_norm, seed, kw)


class _ConvBNReLU(Layer):
    """Conv2D (no bias), BatchNorm2D, then ReLU6 unless `act` is off."""

    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 act=True, generator=None):
        super().__init__()
        self.conv = Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                           groups=groups, bias_attr=False,
                           generator=generator)
        self.bn = BatchNorm2D(out_c)
        self.act = ReLU6() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class MobileNetV1(Layer):
    """Depthwise-separable stacks: each a depthwise 3 x 3 (groups = its
    channels) and a pointwise 1 x 1, each with BN and ReLU6; channel
    counts scaled by `scale` through `_make_divisible`."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype: Optional[torch.dtype] = None,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)

        def s(c):
            return _make_divisible(c * scale)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
            [(512, 1024, 2), (1024, 1024, 1)]
        layers = [_ConvBNReLU(3, s(32), 3, stride=2, padding=1, generator=g)]
        for in_c, out_c, stride in cfg:
            layers.append(_ConvBNReLU(s(in_c), s(in_c), 3, stride=stride,
                                      padding=1, groups=s(in_c),
                                      generator=g))
            layers.append(_ConvBNReLU(s(in_c), s(out_c), 1, generator=g))
        self.features = Sequential(*layers)
        self.with_pool = with_pool
        self.flatten = Flatten()
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        self.fc = Linear(s(1024), num_classes, generator=g)
        _place(self, device, dtype)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        return self.fc(self.flatten(x))


class _InvertedResidual(Layer):
    """1 x 1 expansion (unless `expand` is 1), depthwise 3 x 3, linear 1 x 1
    projection; the skip where the stride is 1 and the widths agree."""

    def __init__(self, in_c, out_c, stride, expand, generator=None):
        super().__init__()
        hidden = int(round(in_c * expand))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand != 1:
            layers.append(_ConvBNReLU(in_c, hidden, 1, generator=generator))
        layers += [
            _ConvBNReLU(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, generator=generator),
            _ConvBNReLU(hidden, out_c, 1, act=False, generator=generator),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    """Inverted residuals with linear bottlenecks, the last conv to
    1280 x max(1, scale) channels, then Dropout(0.2) and the fc."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype: Optional[torch.dtype] = None,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)

        def s(c):
            return _make_divisible(c * scale)

        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        layers = [_ConvBNReLU(3, s(32), 3, stride=2, padding=1, generator=g)]
        in_c = s(32)
        for expand, c, n, stride in cfg:
            for i in range(n):
                layers.append(_InvertedResidual(
                    in_c, s(c), stride if i == 0 else 1, expand, g))
                in_c = s(c)
        last = _make_divisible(1280 * max(1.0, scale))
        layers.append(_ConvBNReLU(in_c, last, 1, generator=g))
        self.features = Sequential(*layers)
        self.with_pool = with_pool
        self.flatten = Flatten()
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        self.classifier = Sequential(Dropout(0.2, generator=g),
                                     Linear(last, num_classes, generator=g))
        _place(self, device, dtype)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        return self.classifier(self.flatten(x))


def mobilenet_v1(scale=1.0, **kw):
    return MobileNetV1(scale=scale, **kw)


def mobilenet_v2(scale=1.0, **kw):
    return MobileNetV2(scale=scale, **kw)
