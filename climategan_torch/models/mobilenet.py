"""MobileNetV2 backbone and the separable DeepLab head of the mobilenet
variant (``gen.deeplabv3.backbone: mobilenet``), NCHW.

Inverted residual blocks (expand 1x1 -> depthwise 3x3 -> project 1x1), at
output stride 16 with dilation 2 in the last stage; the encoder returns
(the 320-channel features upsampled x2 nearest, the 24-channel low-level
features at H/4). The head is two separable convs (depthwise -> BN -> relu
-> pointwise -> BN -> relu) and a 1x1 classifier. Keys follow the
reference: ``conv1.{conv,bn}``, ``block{s}.{j}.conv.{i}`` (expand and
depthwise ``{conv,bn}``, then the project conv and its BN), and
``head.block.{0,1}.block.{depthwise,bn_depth,pointwise,bn_point}``,
``head.block.2``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.models.norms import BatchNorm2d
from climategan_torch.ops.interpolate import upsample_nearest


class ConvBNReLU6(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, dilation,
                              groups, bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        return F.relu6(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1,
                 expand_ratio: int = 6, dilation: int = 1):
        super().__init__()
        inter = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU6(cin, inter, 1))
        layers += [ConvBNReLU6(inter, inter, 3, stride, padding=dilation,
                               dilation=dilation, groups=inter),
                   nn.Conv2d(inter, cout, 1, bias=False), BatchNorm2d(cout)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res else y


# (t, c, n, s) per stage block1..block5
STAGES = (
    ((1, 16, 1, 1),),
    ((6, 24, 2, 2),),
    ((6, 32, 3, 2),),
    ((6, 64, 4, 2), (6, 96, 3, 1)),
    ((6, 160, 3, 2), (6, 320, 1, 1)),
)
STAGE_DILATIONS = (1, 1, 1, 1, 2)  # output stride 16


class MobileNetV2Encoder(nn.Module):
    """Returns (c4: 320 channels at H/8, c1: 24 channels at H/4)."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvBNReLU6(3, 32, 3, 2, padding=1)
        cin = 32
        for k, (settings, dilation) in enumerate(zip(STAGES, STAGE_DILATIONS)):
            blocks = []
            for t, c, n, s in settings:
                # the first block of each group takes the stride (or, in a
                # dilated stage, the dilation)
                blocks.append(InvertedResidual(cin, c, s if dilation == 1 else 1,
                                               t, dilation))
                blocks += [InvertedResidual(c, c, 1, t, 1) for _ in range(n - 1)]
                cin = c
            setattr(self, f"block{k + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        y = self.block1(self.conv1(x))
        c1 = self.block2(y)
        c4 = self.block5(self.block4(self.block3(c1)))
        return upsample_nearest(c4, 2), c1


class SeparableConvBlock(nn.Module):
    def __init__(self, cin: int, planes: int, dilation: int = 1):
        super().__init__()
        self.block = nn.ModuleDict({
            "depthwise": nn.Conv2d(cin, cin, 3, padding=dilation,
                                   dilation=dilation, groups=cin, bias=False),
            "bn_depth": BatchNorm2d(cin),
            "pointwise": nn.Conv2d(cin, planes, 1, bias=False),
            "bn_point": BatchNorm2d(planes)})

    def forward(self, x):
        b = self.block
        y = F.relu(b["bn_depth"](b["depthwise"](x)))
        return F.relu(b["bn_point"](b["pointwise"](y)))


class DeepLabHead(nn.Module):
    def __init__(self, cin: int, nclass: int):
        super().__init__()
        self.block = nn.Sequential(SeparableConvBlock(cin, 256),
                                   SeparableConvBlock(256, 256),
                                   nn.Conv2d(256, nclass, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)
