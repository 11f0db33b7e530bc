"""The ResNet family (counterpart of ``paddle_tpu/models/resnet.py``;
ResNet-50 is the repository's image-classification configuration).

Built from the paddle API's layers (``Conv2D``, ``BatchNorm2D``,
``MaxPool2D``, ``AdaptiveAvgPool2D``, ``Linear``), under the reference's
parameter and buffer names, so a reference state dict loads as it is.
"""
from __future__ import annotations

from typing import List

from ..nn.layer_base import Layer
from ..nn.layers import (Conv2D, BatchNorm2D, ReLU, MaxPool2D,
                         AdaptiveAvgPool2D, Linear, Sequential)


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False)
        self.bn1 = BatchNorm2D(planes)
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = BatchNorm2D(planes)
        self.downsample = downsample
        self.relu = ReLU()

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 base_width=64, groups=1):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = BatchNorm2D(width)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=1,
                            groups=groups, bias_attr=False)
        self.bn2 = BatchNorm2D(width)
        self.conv3 = Conv2D(width, planes * 4, 1, bias_attr=False)
        self.bn3 = BatchNorm2D(planes * 4)
        self.downsample = downsample
        self.relu = ReLU()

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    """``paddle.vision.models.ResNet``."""

    def __init__(self, block, depth_cfg: List[int], num_classes=1000,
                 with_pool=True, in_channels=3, width=64, groups=1):
        super().__init__()
        self.inplanes = 64
        # width=64*2 -> wide resnet (ResNet(..., width=128));
        # groups>1 + width=4/8 -> resnext (cardinality x bottleneck width)
        self._base_width = width
        self._groups = groups
        self.conv1 = Conv2D(in_channels, 64, 7, stride=2, padding=3,
                            bias_attr=False)
        self.bn1 = BatchNorm2D(64)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, depth_cfg[0])
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], stride=2)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], stride=2)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], stride=2)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes)
        self.num_classes = num_classes

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False),
                BatchNorm2D(planes * block.expansion))
        if not issubclass(block, BottleneckBlock) \
                and (self._base_width != 64 or self._groups != 1):
            raise ValueError(
                "width != 64 / groups != 1 require BottleneckBlock "
                "architectures (resnet50+); BasicBlock has no width knob")
        kw = {"base_width": self._base_width, "groups": self._groups} \
            if issubclass(block, BottleneckBlock) else {}
        layers = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **kw))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            from ..ops.manipulation import flatten
            x = self.fc(flatten(x, 1))
        return x


def resnet18(pretrained=False, **kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], **kw)


def resnet34(pretrained=False, **kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], **kw)


def resnet50(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], **kw)


def resnet101(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], **kw)


def resnet152(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], **kw)


def wide_resnet50_2(pretrained=False, **kw):
    """``paddle.vision.models.wide_resnet50_2``."""
    return ResNet(BottleneckBlock, [3, 4, 6, 3], width=64 * 2, **kw)


def wide_resnet101_2(pretrained=False, **kw):
    """``paddle.vision.models.wide_resnet101_2``."""
    return ResNet(BottleneckBlock, [3, 4, 23, 3], width=64 * 2, **kw)


def _resnext(depth_cfg, groups, width, **kw):
    return ResNet(BottleneckBlock, depth_cfg, groups=groups, width=width,
                  **kw)


def resnext50_32x4d(pretrained=False, **kw):
    """``paddle.vision.models.resnext50_32x4d``."""
    return _resnext([3, 4, 6, 3], 32, 4, **kw)


def resnext50_64x4d(pretrained=False, **kw):
    return _resnext([3, 4, 6, 3], 64, 4, **kw)


def resnext101_32x4d(pretrained=False, **kw):
    return _resnext([3, 4, 23, 3], 32, 4, **kw)


def resnext101_64x4d(pretrained=False, **kw):
    return _resnext([3, 4, 23, 3], 64, 4, **kw)


def resnext152_32x4d(pretrained=False, **kw):
    return _resnext([3, 8, 36, 3], 32, 4, **kw)


def resnext152_64x4d(pretrained=False, **kw):
    return _resnext([3, 8, 36, 3], 64, 4, **kw)
