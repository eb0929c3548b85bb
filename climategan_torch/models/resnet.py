"""Dilated ResNet-101 backbone (output stride 8 or 16), NCHW.

Layer4 uses multi-grid dilations (1, 2, 4) x the stage's base dilation.
Returns (z_high: 2048 ch at H/8, z_low: 256 ch at H/4). Keys follow the
reference: ``conv1``, ``bn1``, ``layer{s}.{b}.conv{i}`` / ``bn{i}`` and
``layer{s}.0.downsample.{0,1}``.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.models.norms import BatchNorm2d


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                BatchNorm2d(planes * 4))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3),
                 output_stride: int = 8):
        super().__init__()
        if output_stride == 8:
            strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
        elif output_stride == 16:
            strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        else:
            raise NotImplementedError(f"output_stride {output_stride}")
        multi_grid = (1, 2, 4)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            blocks = []
            for b in range(layers[stage]):
                dil = dilations[stage]
                if stage == 3:
                    dil *= multi_grid[b % len(multi_grid)]
                first = b == 0
                blocks.append(Bottleneck(
                    inplanes, planes, strides[stage] if first else 1, dil,
                    downsample=first and (strides[stage] != 1
                                          or inplanes != planes * 4)))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, 1)
        low = self.layer1(y)
        y = self.layer4(self.layer3(self.layer2(low)))
        return y, low
