"""SPADE Painter (NCHW), the ``no_z`` path without a final shortcut.

The latent comes from ``fc``, a 3x3 conv over the masked input
nearest-resized to (H, W) / 2^spade_n_up. Then head_0, G_middle_0,
G_middle_1 and spade_n_up - 2 channel-halving up_spades, with a nearest x2
upsample before each block after head_0, a final SPADE block, and
``conv_img`` + tanh. Every SPADE is conditioned on the masked input
(cond_nc = 3) and computes its [gamma|beta] with the ``spade_cond`` kernel
in eval mode, with plain convs in train mode. ``update_sn`` stores the new
power-iteration u/v of every spectral conv (train mode).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from climategan_torch.models.blocks import SPADEResnetBlock, lrelu
from climategan_torch.ops.interpolate import resize, upsample_nearest


class PainterSpadeDecoder(nn.Module):
    def __init__(self, latent_dim: int = 640, cond_nc: int = 3,
                 spade_n_up: int = 7, spade_use_spectral_norm: bool = True):
        super().__init__()
        nc = latent_dim
        self.spade_n_up = spade_n_up

        def srb(fin, fout):
            return SPADEResnetBlock(fin, fout, cond_nc, spade_use_spectral_norm)

        self.fc = nn.Conv2d(cond_nc, nc, 3, padding=1)
        self.head_0 = srb(nc, nc)
        self.G_middle_0 = srb(nc, nc)
        self.G_middle_1 = srb(nc, nc)
        self.up_spades = nn.ModuleList([
            srb(nc // 2 ** i, nc // 2 ** (i + 1))
            for i in range(spade_n_up - 2)])
        final_nc = nc // 2 ** (spade_n_up - 2)
        self.final_spade = srb(final_nc, final_nc)
        self.conv_img = nn.Conv2d(final_nc, 3, 3, padding=1)

    def forward(self, cond: torch.Tensor,
                update_sn: bool = False) -> torch.Tensor:
        zh = cond.shape[2] // 2 ** self.spade_n_up
        zw = cond.shape[3] // 2 ** self.spade_n_up
        y = self.fc(resize(cond, (zh, zw), "nearest"))
        y = self.head_0(y, cond, update_sn)
        y = self.G_middle_0(upsample_nearest(y), cond, update_sn)
        y = self.G_middle_1(upsample_nearest(y), cond, update_sn)
        for block in self.up_spades:
            y = block(upsample_nearest(y), cond, update_sn)
        y = self.final_spade(y, cond, update_sn)
        return torch.tanh(self.conv_img(lrelu(y)))
