"""DeepLabV3+ segmentation decoder (ASPP + low-level decoder), NCHW.

Two reference quirks are kept for checkpoint parity:
  * ASPP's ``conv_out`` is a 1x1 conv with padding=1, so ASPP emits
    (H+2, W+2);
  * the decoder is called as ``decoder(aspp_out, z_low)``: ``conv_low``
    runs on the ASPP features and z_low is resized to their grid.
``ConvBN`` (the reference's ConvBNReLU) applies no ReLU.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from climategan_torch.ops.interpolate import resize


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, ks: int = 3, padding: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ks, padding=padding,
                              dilation=dilation, bias=True)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


class ASPP(nn.Module):
    def __init__(self, cin: int = 2048):
        super().__init__()
        self.conv1 = ConvBN(cin, 256, ks=1, padding=0)
        self.conv2 = ConvBN(cin, 256, ks=3, dilation=6, padding=6)
        self.conv3 = ConvBN(cin, 256, ks=3, dilation=12, padding=12)
        self.conv4 = ConvBN(cin, 256, ks=3, dilation=18, padding=18)
        self.conv_out = ConvBN(1024, 256, ks=1, padding=1)

    def forward(self, x):
        feat = torch.cat([self.conv1(x), self.conv2(x), self.conv3(x),
                          self.conv4(x)], dim=1)
        return self.conv_out(feat)


class DeepLabDecoder(nn.Module):
    def __init__(self, n_classes: int, low_dim: int = 256):
        super().__init__()
        self.conv_low = ConvBN(256, 48, ks=1, padding=0)
        self.conv_cat = nn.Sequential(ConvBN(48 + low_dim, 256),
                                      ConvBN(256, 256))
        self.conv_out = nn.Conv2d(256, n_classes, 1, bias=False)

    def forward(self, feat_low, feat_aspp):
        """Called in the reference's order: feat_low := ASPP output,
        feat_aspp := backbone z_low."""
        low = self.conv_low(feat_low)
        up = resize(feat_aspp, feat_low.shape[-2:], "bilinear",
                    align_corners=True)
        return self.conv_out(self.conv_cat(torch.cat([low, up], dim=1)))


class DeepLabV3Decoder(nn.Module):
    def __init__(self, num_classes: int = 11, use_dada: bool = True,
                 target_size: Tuple[int, int] = (640, 640)):
        super().__init__()
        self.use_dada = use_dada
        self.target_size = tuple(target_size)
        self.aspp = ASPP()
        self.decoder = DeepLabDecoder(num_classes)

    def forward(self, z, z_depth=None):
        z_high, z_low = z
        if z_depth is not None and self.use_dada:
            z_high = z_high * z_depth
        s = self.decoder(self.aspp(z_high), z_low)
        return resize(s, self.target_size, "bilinear", align_corners=True)
