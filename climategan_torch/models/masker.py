"""Base mask decoder (the default ``gen.m.use_spade: false``): a
BaseDecoder with low-level features and an un-activated 1-channel logit
output at the input size."""
from __future__ import annotations

from climategan_torch.models.blocks import BaseDecoder


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
