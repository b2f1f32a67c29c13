"""The ResNet family (port of paddle_tpu/vision/models/resnet.py):
BasicBlock, BottleneckBlock, ResNet and resnet18 ... resnet152,
wide_resnet50_2 and resnext50_32x4d; ResNet-50 is the model of
BASELINE.md config 2.  Layout NCHW at the interface, as the reference;
channels-last activations inside (``ResNet.forward``).

``s2d_stem=True`` computes the 7x7 / stride 2 / pad 3 stem as a
space-to-depth rearrangement and a 4x4 / stride 1 conv (``_s2d_stem_conv``):
an exact rewrite, plain reshapes and a conv here, which keeps the
checkpoint's [64, 3, 7, 7] stem weight."""
from __future__ import annotations

import torch

from ... import nn
from ... import tensor_ops as T
from ...framework.place import resolve_device


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups,
                               dilation=dilation, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


def _s2d_stem_conv(x, weight):
    """conv(x, W, stride 2, pad 3) for a 7x7 W, as conv(s2d(x), W', stride
    1, pad (2, 1) each side) with W'[o, (i * 2 + j) * C + c, a, b] =
    Wpad[o, c, 2a + i - 1, 2b + j - 1] (Wpad: W with one zero row and
    column in front): a reshape of the padded kernel."""
    B, C, H, W = x.shape
    O = weight.shape[0]
    xs = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4) \
        .reshape(B, 4 * C, H // 2, W // 2)
    w8 = torch.nn.functional.pad(weight.to(x.dtype), (1, 0, 1, 0))
    wp = w8.reshape(O, C, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4) \
        .reshape(O, 4 * C, 4, 4)
    return torch.nn.functional.conv2d(
        torch.nn.functional.pad(xs, (2, 1, 2, 1)), wp)


class ResNet(nn.Layer):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, s2d_stem=False, device=None):
        super().__init__()
        self._s2d_stem = s2d_stem
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = nn.BatchNorm2D
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)
        self.to(device=resolve_device(device))

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False),
                norm_layer(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, norm_layer)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer))
        return nn.Sequential(*layers)

    def forward(self, x):
        # channels-last activations inside, NCHW at the interface (the
        # parameters keep their layout): cuDNN's NHWC convolutions and
        # ATen's channels-last batch norm (one grid over N x H x W, not a
        # block a channel) take the bf16 ResNet-50 step on an H100 from
        # 59 to 34 ms (PERF.md); the result is the same function
        if self._s2d_stem:
            x = _s2d_stem_conv(x, self.conv1.weight).contiguous(
                memory_format=torch.channels_last)
        else:
            x = self.conv1(x.contiguous(memory_format=torch.channels_last))
        x = self.relu(self.bn1(x))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(T.flatten(x, 1))
        return x


def _resnet(block, depth, **kwargs):
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 50, **kwargs)
