"""DADA depth decoder (NCHW): 1x1 2048->512, 3x3 512->512, 1x1 512->128,
the ``dec4`` 1x1 128->2048 feature-fusion map, an x2 nearest upsample head,
the channel mean, and the bicubic-384 -> nearest-target chain when the size
differs. Keys: ``enc4_{1,2,3}``, ``dec4``, ``upsample.{1,2}``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from climategan_torch.models.blocks import Conv2dBlock, UpsampleNearest
from climategan_torch.ops.interpolate import resize


class DADADepthDecoder(nn.Module):
    def __init__(self, res_dim: int = 2048, mid_dim: int = 512,
                 do_feat_fusion: bool = True,
                 upsample_featuremaps: bool = True, target_size: int = 160):
        super().__init__()
        self.target_size = target_size
        kw = dict(bias=False, activation="lrelu", pad_type="reflect",
                  norm="batch")
        self.enc4_1 = Conv2dBlock(res_dim, mid_dim, 1, 1, 0, **kw)
        self.enc4_2 = Conv2dBlock(mid_dim, mid_dim, 3, 1, 1, **kw)
        self.enc4_3 = Conv2dBlock(mid_dim, 128, 1, 1, 0, **kw)
        self.dec4 = None
        if do_feat_fusion:
            self.dec4 = Conv2dBlock(128, res_dim, 1, 1, 0, bias=True,
                                    activation="lrelu", norm="none")
        self.upsample = None
        if upsample_featuremaps:
            self.upsample = nn.Sequential(
                UpsampleNearest(), Conv2dBlock(128, 32, 3, 1, 1, **kw),
                nn.Conv2d(32, 1, 1))

    def forward(self, z):
        if isinstance(z, (list, tuple)):
            z = z[0]
        y = self.enc4_3(self.enc4_2(self.enc4_1(z)))
        z_depth = None if self.dec4 is None else self.dec4(y)
        if self.upsample is not None:
            y = self.upsample(y)
        depth = torch.mean(y, dim=1, keepdim=True)
        if depth.shape[3] != self.target_size:
            depth = resize(depth, (384, 384), "bicubic", align_corners=False)
            depth = resize(depth, (self.target_size, self.target_size),
                           "nearest")
        return depth, z_depth
