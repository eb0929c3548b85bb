"""Decoder building blocks (NCHW), named as the reference torch modules:
Conv2dBlock (``conv`` [+ ``norm``]), ResBlock(s) (``model`` Sequentials),
BaseDecoder (``proj_conv`` / ``low_level_conv`` / ``merge_feats_conv`` and
the ``model`` Sequential) and SPADEResnetBlock.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.models.norms import SNConv, SPADE, dual_spade, nhwc
from climategan_torch.ops.interpolate import resize, upsample_nearest

_PAD_MODES = {"zero": "constant", "reflect": "reflect", "replicate": "replicate"}


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return F.relu(x)
    if kind == "lrelu":
        return lrelu(x)
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "none":
        return x
    raise ValueError(f"Unsupported activation: {kind}")


class UpsampleNearest(nn.Module):
    """x2 nearest upsample (the reference InterpolateNearest2d slot)."""

    def forward(self, x):
        return upsample_nearest(x, 2)


class Conv2dBlock(nn.Module):
    """pad -> conv (optionally spectral) -> norm -> activation, with the
    reference bias rule: a non-spectral conv drops its bias before a batch
    norm."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 norm: str = "none", activation: str = "relu",
                 pad_type: str = "zero", bias: bool = True):
        super().__init__()
        use_spectral = norm == "spectral" or norm.startswith("spectral_")
        post_norm = norm.replace("spectral_", "") if norm.startswith(
            "spectral_") else ("none" if norm == "spectral" else norm)
        use_bias = bias if use_spectral or post_norm != "batch" else False
        if pad_type not in _PAD_MODES:
            raise ValueError(f"Unsupported padding type: {pad_type}")
        if activation not in ("relu", "lrelu", "tanh", "sigmoid", "none"):
            raise ValueError(f"Unsupported activation: {activation}")
        self.padding, self.pad_mode = padding, _PAD_MODES[pad_type]
        self.activation = activation
        self.conv = SNConv(input_dim, output_dim, kernel_size, stride,
                           dilation=dilation, bias=use_bias,
                           spectral=use_spectral)
        if post_norm == "batch":
            self.norm = nn.BatchNorm2d(output_dim)
        elif post_norm == "none":
            self.norm = None
        else:
            raise NotImplementedError(f"Conv2dBlock norm {post_norm!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding:
            p = self.padding
            x = F.pad(x, (p, p, p, p), mode=self.pad_mode)
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return activation(x, self.activation)


class ResBlock(nn.Module):
    def __init__(self, dim: int, norm: str, activ: str, pad_type: str):
        super().__init__()
        self.model = nn.Sequential(
            Conv2dBlock(dim, dim, 3, 1, 1, norm=norm, activation=activ,
                        pad_type=pad_type),
            Conv2dBlock(dim, dim, 3, 1, 1, norm=norm, activation="none",
                        pad_type=pad_type),
        )

    def forward(self, x):
        return x + self.model(x)


class ResBlocks(nn.Module):
    def __init__(self, num_blocks: int, dim: int, norm: str, activ: str,
                 pad_type: str):
        super().__init__()
        self.model = nn.Sequential(*[
            ResBlock(dim, norm, activ, pad_type) for _ in range(num_blocks)])

    def forward(self, x):
        return self.model(x)


class BaseDecoder(nn.Module):
    """proj 1x1 -> (merge low-level features) -> ResBlocks -> n_upsample x
    [nearest x2, 3x3 conv halving channels] -> output conv."""

    def __init__(self, n_upsample: int = 4, n_res: int = 4,
                 input_dim: int = 2048, proj_dim: int = 64,
                 output_dim: int = 3, norm: str = "batch", activ: str = "relu",
                 pad_type: str = "zero", output_activ: str = "tanh",
                 low_level_feats_dim: int = -1, use_dada: bool = False):
        super().__init__()
        self.use_dada = use_dada
        self.use_low_level = low_level_feats_dim > 0
        dim = proj_dim if proj_dim != -1 else input_dim
        self.proj_conv = None
        if proj_dim != -1:
            self.proj_conv = Conv2dBlock(input_dim, proj_dim, 1, 1, 0,
                                         norm=norm, activation=activ)
        if self.use_low_level:
            self.low_level_conv = Conv2dBlock(
                low_level_feats_dim, dim, 3, 1, 1, pad_type=pad_type,
                norm=norm, activation=activ)
            self.merge_feats_conv = Conv2dBlock(
                2 * dim, dim, 1, 1, 0, pad_type=pad_type, norm=norm,
                activation=activ)
        layers = [ResBlocks(n_res, dim, norm, activ, pad_type)]
        for _ in range(n_upsample):
            layers += [UpsampleNearest(),
                       Conv2dBlock(dim, dim // 2, 3, 1, 1, pad_type=pad_type,
                                   norm=norm, activation=activ)]
            dim //= 2
        layers.append(Conv2dBlock(dim, output_dim, 3, 1, 1, pad_type=pad_type,
                                  norm="none", activation=output_activ))
        self.model = nn.Sequential(*layers)

    def forward(self, z, z_depth: Optional[torch.Tensor] = None):
        low_level_feat = None
        if isinstance(z, (list, tuple)):
            if not self.use_low_level:
                z = z[0]
            else:
                z, low = z
                low = self.low_level_conv(low)
                low_level_feat = resize(low, z.shape[-2:], "bilinear",
                                        align_corners=False)
        if z_depth is not None and self.use_dada:
            z = z * z_depth
        if self.proj_conv is not None:
            z = self.proj_conv(z)
        if low_level_feat is not None:
            z = self.merge_feats_conv(torch.cat([low_level_feat, z], dim=1))
        return self.model(z)


class SPADEResnetBlock(nn.Module):
    """SPADE residual block with instance-norm SPADEs; with a learned
    shortcut, norm_s and norm_0 run as one dual ``spade_cond`` launch."""

    def __init__(self, fin: int, fout: int, cond_nc: int,
                 use_spectral_norm: bool = True):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        sn = use_spectral_norm
        self.conv_0 = SNConv(fin, fmiddle, 3, padding=1, spectral=sn)
        self.conv_1 = SNConv(fmiddle, fout, 3, padding=1, spectral=sn)
        if self.learned_shortcut:
            self.conv_s = SNConv(fin, fout, 1, bias=False, spectral=sn)
            self.norm_s = SPADE(fin, cond_nc)
        self.norm_0 = SPADE(fin, cond_nc)
        self.norm_1 = SPADE(fmiddle, cond_nc)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """``seg``: NCHW conditioning map at any size (nearest-resized)."""
        seg = nhwc(resize(seg, x.shape[-2:], "nearest").to(x.dtype))
        if self.learned_shortcut:
            x_s, dx = dual_spade(x, seg, self.norm_s, self.norm_0)
            x_s = self.conv_s(x_s)
        else:
            x_s, dx = x, self.norm_0(x, seg)
        dx = self.conv_0(lrelu(dx))
        dx = self.conv_1(lrelu(self.norm_1(dx, seg)))
        return x_s + dx
