"""Mask decoders (NCHW).

* ``MaskBaseDecoder`` (the default ``gen.m.use_spade: false``): a
  BaseDecoder with low-level features and an un-activated 1-channel logit
  output at the input size.
* ``MaskSpadeDecoder`` (``gen.m.use_spade: true``): the high- and low-level
  features projected and merged, then ``num_layers`` SPADE blocks (batch
  param-free norms, a closing leaky relu) conditioned on ``cat(norm(d),
  softmax(s)[, x])`` with a nearest x2 upsample after each, and a spectral
  3x3 conv to one logit channel. Keys: ``low_level_conv``,
  ``high_level_conv``, ``merge_feats_conv`` (or ``fc_conv`` on a single
  feature map), ``spade_blocks.{i}``, ``mask_conv``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from climategan_torch.models.blocks import (
    BaseDecoder,
    Conv2dBlock,
    SPADEResnetBlock,
)
from climategan_torch.ops.interpolate import resize, upsample_nearest


class MaskBaseDecoder(BaseDecoder):
    def __init__(self, input_dim: int = 2048, n_upsample: int = 3,
                 n_res: int = 3, proj_dim: int = 64, norm: str = "spectral",
                 activ: str = "lrelu", pad_type: str = "reflect",
                 low_level_feats_dim: int = 256, use_dada: bool = False):
        super().__init__(
            n_upsample=n_upsample, n_res=n_res, input_dim=input_dim,
            proj_dim=proj_dim, output_dim=1, norm=norm, activ=activ,
            pad_type=pad_type, output_activ="none",
            low_level_feats_dim=low_level_feats_dim, use_dada=use_dada)

    def forward(self, z, cond=None, z_depth=None, update_sn: bool = False):
        return super().forward(z, z_depth, update_sn)


class MaskSpadeDecoder(nn.Module):
    def __init__(self, latent_dim: int = 128, cond_nc: int = 15,
                 num_layers: int = 3, use_proj: bool = True,
                 proj_dim: int = 64,
                 input_dims: Tuple[int, int] = (2048, 256),
                 spade_use_spectral_norm: bool = True,
                 spade_param_free_norm: str = "batch",
                 single_input: bool = False):
        """``single_input``: the encoder gives one feature map (the DeepLab
        v2 encoder), which ``fc_conv`` takes."""
        super().__init__()
        kw = dict(norm="spectral_batch", activation="lrelu",
                  pad_type="reflect")
        res_dim, low_dim = input_dims
        self.use_proj = use_proj
        if single_input:
            self.fc_conv = Conv2dBlock(res_dim, latent_dim, 3, 1, 1, **kw)
        else:
            mid = proj_dim if use_proj else res_dim
            self.low_level_conv = Conv2dBlock(low_dim, mid, 3, 1, 1, **kw)
            if use_proj:
                self.high_level_conv = Conv2dBlock(res_dim, mid, 3, 1, 1, **kw)
            self.merge_feats_conv = Conv2dBlock(2 * mid, latent_dim, 3, 1, 1,
                                                **kw)
        self.spade_blocks = nn.ModuleList([
            SPADEResnetBlock(latent_dim // 2 ** i, latent_dim // 2 ** (i + 1),
                             cond_nc, spade_use_spectral_norm,
                             spade_param_free_norm, last_activation="lrelu")
            for i in range(num_layers)])
        self.mask_conv = Conv2dBlock(latent_dim // 2 ** num_layers, 1, 3, 1,
                                     1, norm="spectral", activation="none",
                                     pad_type="reflect")

    def forward(self, z, cond: torch.Tensor, z_depth=None,
                update_sn: bool = False) -> torch.Tensor:
        """``cond``: the NCHW conditioning map (any size: each block
        nearest-resizes it to its own)."""
        if isinstance(z, (list, tuple)):
            z_h, z_l = z
            z_l = resize(self.low_level_conv(z_l, update_sn), z_h.shape[-2:],
                         "bilinear", align_corners=False)
            if self.use_proj:
                z_h = self.high_level_conv(z_h, update_sn)
            y = self.merge_feats_conv(torch.cat([z_h, z_l], dim=1), update_sn)
        else:
            y = self.fc_conv(z, update_sn)
        for block in self.spade_blocks:
            y = upsample_nearest(block(y, cond, update_sn), 2)
        return self.mask_conv(y, update_sn)
