"""SPADE Painter (NCHW).

With ``no_z`` (the default) the latent comes from ``fc``, a 3x3 conv over
the masked input nearest-resized to (H, W) / 2^spade_n_up; without it the
latent is a given ``z`` (N, latent_dim, H / 2^spade_n_up, W / 2^spade_n_up)
and there is no ``fc``. Then head_0, G_middle_0, G_middle_1 and
spade_n_up - 2 channel-halving up_spades, with a nearest x2 upsample before
each block after head_0, a final SPADE block, and ``conv_img`` + tanh.
Every SPADE is conditioned on the masked input (cond_nc = 3), but with
``use_final_shortcut`` the final block's conditioning is
``lrelu(final_shortcut_bn(final_shortcut_conv(y)))``, a spectral 1x1 conv
to 3 channels and a batch norm over its own input. The SPADEs normalize
with instance norms, or with ``spade_param_free_norm="batch"`` batch norms,
and compute their [gamma|beta] with the ``spade_cond`` kernel in eval
mode, with plain convs in train mode. ``update_sn`` stores the new
power-iteration u/v of every spectral conv (train mode).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from climategan_torch.models.blocks import SPADEResnetBlock, lrelu
from climategan_torch.models.norms import BatchNorm2d, SNConv
from climategan_torch.ops.interpolate import resize, upsample_nearest
from climategan_torch.parallel import spatial
from climategan_torch.parallel.spatial import Rows


class PainterSpadeDecoder(nn.Module):
    def __init__(self, latent_dim: int = 640, cond_nc: int = 3,
                 spade_n_up: int = 7, spade_use_spectral_norm: bool = True,
                 spade_param_free_norm: str = "instance", no_z: bool = True,
                 use_final_shortcut: bool = False):
        super().__init__()
        nc = latent_dim
        self.spade_n_up = spade_n_up

        def srb(fin, fout):
            return SPADEResnetBlock(fin, fout, cond_nc,
                                    spade_use_spectral_norm,
                                    spade_param_free_norm)

        if no_z:
            self.fc = nn.Conv2d(cond_nc, nc, 3, padding=1)
        self.head_0 = srb(nc, nc)
        self.G_middle_0 = srb(nc, nc)
        self.G_middle_1 = srb(nc, nc)
        self.up_spades = nn.ModuleList([
            srb(nc // 2 ** i, nc // 2 ** (i + 1))
            for i in range(spade_n_up - 2)])
        final_nc = nc // 2 ** (spade_n_up - 2)
        if use_final_shortcut:
            self.final_shortcut_conv = SNConv(final_nc, 3, 1, spectral=True)
            self.final_shortcut_bn = BatchNorm2d(3)
        self.final_spade = srb(final_nc, final_nc)
        self.conv_img = nn.Conv2d(final_nc, 3, 3, padding=1)

    def forward(self, cond, update_sn: bool = False,
                z: Optional[torch.Tensor] = None):
        if isinstance(cond, Rows):
            return self.forward_rows(cond, update_sn, z)
        if z is None:
            if not hasattr(self, "fc"):
                raise ValueError("a painter built with no_z=False needs z")
            zh = cond.shape[2] // 2 ** self.spade_n_up
            zw = cond.shape[3] // 2 ** self.spade_n_up
            z = self.fc(resize(cond, (zh, zw), "nearest"))
        y = self.head_0(z, cond, update_sn)
        y = self.G_middle_0(upsample_nearest(y), cond, update_sn)
        y = self.G_middle_1(upsample_nearest(y), cond, update_sn)
        for block in self.up_spades:
            y = block(upsample_nearest(y), cond, update_sn)
        if hasattr(self, "final_shortcut_conv"):
            cond = lrelu(self.final_shortcut_bn(
                self.final_shortcut_conv(y, update_sn)))
        y = self.final_spade(y, cond, update_sn)
        return torch.tanh(self.conv_img(lrelu(y)))

    def forward_rows(self, cond: Rows, update_sn: bool = False,
                     z=None) -> Rows:
        """The forward on a row-sharded ``cond``; ``z`` (a painter with z)
        a tensor for the whole batch, split by the partition rule, or its
        ``Rows``. The first maps (H / 2^spade_n_up rows) may give a shard
        no rows. The final shortcut's conditioning is computed on the
        rows: a 1x1 conv and the batch norm (over every shard in train
        mode)."""
        if z is None:
            if not hasattr(self, "fc"):
                raise ValueError("a painter built with no_z=False needs z")
            zh = cond.h // 2 ** self.spade_n_up
            zw = cond.w // 2 ** self.spade_n_up
            z = spatial.conv2d(spatial.resize(cond, (zh, zw), "nearest"),
                               self.fc)
        elif not isinstance(z, Rows):
            z = spatial.split_rows(z, cond.devices)
        y = self.head_0.forward_rows(z, cond, update_sn)
        for block in (self.G_middle_0, self.G_middle_1, *self.up_spades):
            y = block.forward_rows(spatial.upsample_nearest(y), cond,
                                   update_sn)
        if hasattr(self, "final_shortcut_conv"):
            cond = self.final_shortcut_bn.forward_rows(spatial.conv2d(
                y, self.final_shortcut_conv, update_sn=update_sn)).map(lrelu)
        y = self.final_spade.forward_rows(y, cond, update_sn)
        return spatial.conv2d(y.map(lrelu), self.conv_img).map(torch.tanh)
