"""Depth decoders (NCHW).

* ``DADADepthDecoder`` (``gen.d.architecture: dada``, the default): 1x1
  2048->512, 3x3 512->512, 1x1 512->128, the ``dec4`` 1x1 128->2048
  feature-fusion map, an x2 nearest upsample head, the channel mean, and
  the bicubic-384 -> nearest-target chain when the size differs. Keys:
  ``enc4_{1,2,3}``, ``dec4``, ``upsample.{1,2}``.
* ``BaseDepthDecoder`` (``gen.d.architecture: base``): a BaseDecoder with
  batch norms in regression (one channel) or bucket classification
  (``classify_buckets`` logit channels), bilinear (align_corners) to the
  target size; no feature-fusion map. Keys: the BaseDecoder's.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from typing import Tuple

from climategan_torch.models.blocks import (
    BaseDecoder,
    Conv2dBlock,
    UpsampleNearest,
)
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

    def forward(self, z, update_sn: bool = False):
        if isinstance(z, (list, tuple)):
            z = z[0]
        y = z
        for block in (self.enc4_1, self.enc4_2, self.enc4_3):
            y = block(y, update_sn)
        z_depth = None if self.dec4 is None else self.dec4(y, update_sn)
        if self.upsample is not None:
            up, conv, out = self.upsample
            y = out(conv(up(y), update_sn))
        depth = torch.mean(y, dim=1, keepdim=True)
        if depth.shape[3] != self.target_size:
            depth = resize(depth, (384, 384), "bicubic", align_corners=False)
            depth = resize(depth, (self.target_size, self.target_size),
                           "nearest")
        return depth, z_depth


class BaseDepthDecoder(BaseDecoder):
    def __init__(self, input_dim: int = 2048, classify_buckets: int = 0,
                 upsample_featuremaps: bool = True,
                 target_size: Tuple[int, int] = (160, 160)):
        super().__init__(
            n_upsample=1 if upsample_featuremaps else 0, n_res=1,
            input_dim=input_dim, proj_dim=32,
            output_dim=classify_buckets if classify_buckets > 0 else 1,
            norm="batch", activ="lrelu", pad_type="reflect",
            output_activ="none")
        self.target_size = tuple(target_size)

    def forward(self, z, update_sn: bool = False):
        d = super().forward(z, None, update_sn)
        return resize(d, self.target_size, "bilinear", align_corners=True), None
