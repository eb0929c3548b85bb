"""DeepLabV3+ segmentation decoder (ASPP + low-level decoder), NCHW.

Two reference quirks are kept for checkpoint parity:
  * ASPP's ``conv_out`` is a 1x1 conv with padding=1, so ASPP emits
    (H+2, W+2);
  * the decoder is called as ``decoder(aspp_out, z_low)``: ``conv_low``
    runs on the ASPP features and z_low is resized to their grid.
``ConvBN`` (the reference's ConvBNReLU) applies no ReLU. With the
mobilenet backbone the decoder is the separable ``head``
(``models/mobilenet.DeepLabHead``) on the 320-channel features.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from climategan_torch.models.mobilenet import DeepLabHead
from climategan_torch.models.norms import BatchNorm2d
from climategan_torch.ops.interpolate import resize
from climategan_torch.parallel import spatial
from climategan_torch.parallel.spatial import Rows


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, ks: int = 3, padding: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ks, padding=padding,
                              dilation=dilation, bias=True)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        return self.bn(self.conv(x))

    def forward_rows(self, x: Rows) -> Rows:
        return self.bn.forward_rows(spatial.conv2d(x, self.conv))


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

    def forward_rows(self, x: Rows) -> Rows:
        """Dilations 6, 12 and 18 read across shards; ``conv_out``'s
        padding makes the output h + 2 rows, split by the partition rule
        of its own height."""
        feats = [c.forward_rows(x) for c in (self.conv1, self.conv2,
                                             self.conv3, self.conv4)]
        return self.conv_out.forward_rows(feats[0].cat(*feats[1:]))


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

    def forward_rows(self, feat_low: Rows, feat_aspp: Rows) -> Rows:
        low = self.conv_low.forward_rows(feat_low)
        up = spatial.resize(feat_aspp, (feat_low.h, feat_low.w), "bilinear",
                            align_corners=True)
        y = low.cat(up)
        for block in self.conv_cat:
            y = block.forward_rows(y)
        return spatial.conv2d(y, self.conv_out)


class DeepLabV3Decoder(nn.Module):
    def __init__(self, num_classes: int = 11, use_dada: bool = True,
                 target_size: Tuple[int, int] = (640, 640),
                 backbone: str = "resnet"):
        super().__init__()
        self.use_dada = use_dada
        self.target_size = tuple(target_size)
        if backbone == "resnet":
            self.aspp = ASPP()
            self.decoder = DeepLabDecoder(num_classes)
        else:
            self.head = DeepLabHead(320, num_classes)

    def forward(self, z, z_depth=None):
        z_high, z_low = z
        if z_depth is not None and self.use_dada:
            z_high = z_high * z_depth
        if hasattr(self, "head"):
            s = self.head(z_high)
        else:
            s = self.decoder(self.aspp(z_high), z_low)
        return resize(s, self.target_size, "bilinear", align_corners=True)

    def forward_rows(self, z, z_depth: Optional[Rows] = None) -> Rows:
        """The forward on row-sharded maps."""
        z_high, z_low = z
        if z_depth is not None and self.use_dada:
            z_high = z_high.zip(z_depth, torch.mul)
        if hasattr(self, "head"):
            s = self.head.forward_rows(z_high)
        else:
            s = self.decoder.forward_rows(self.aspp.forward_rows(z_high),
                                          z_low)
        return spatial.resize(s, self.target_size, "bilinear",
                              align_corners=True)
