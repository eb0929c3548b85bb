"""Decoder building blocks (NCHW), named as the reference torch modules:
Conv2dBlock (``conv`` [+ ``norm``]), ResBlock(s) (``model`` Sequentials),
BaseDecoder (``proj_conv`` / ``low_level_conv`` / ``merge_feats_conv`` and
the ``model`` Sequential) and SPADEResnetBlock. ``update_sn`` goes to every
spectral conv, as in the JAX modules: in train mode it stores the conv's
new power-iteration u and v.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.models.norms import (
    BatchNorm2d,
    LayerNorm,
    SNConv,
    SPADE,
    dual_spade,
    instance_norm,
    nhwc,
    pack_dual,
    pack_fits,
    spade_cond_rows,
    spade_windows,
)
from climategan_torch.ops.interpolate import resize, upsample_nearest
from climategan_torch.parallel import spatial
from climategan_torch.parallel.spatial import Rows

_PAD_MODES = {"zero": "constant", "reflect": "reflect", "replicate": "replicate"}


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """An activation without parameters by name (``prelu`` is ``PReLU``)."""
    if kind == "relu":
        return F.relu(x)
    if kind == "lrelu":
        return lrelu(x)
    if kind == "selu":
        return F.selu(x)
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "none":
        return x
    raise ValueError(f"Unsupported activation: {kind}")


ACTIVATIONS = ("relu", "lrelu", "prelu", "selu", "tanh", "sigmoid", "none")


class PReLU(nn.PReLU):
    """The reference's ``nn.PReLU()`` (one learned slope, key ``weight``,
    0.25 at first), computed as the JAX package computes it: ``x`` where
    it is >= 0, else the slope (in x's dtype, on x's device) times ``x``;
    the gradient at x == 0 is 1, where ``F.prelu`` takes the slope."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        slope = self.weight.to(device=x.device, dtype=x.dtype)
        return torch.where(x >= 0, x, slope * x)


def post_norm(norm: str) -> str:
    """The norm a ``Conv2dBlock`` of ``norm`` applies after its conv:
    ``spectral_<n>`` -> ``n``, ``spectral`` -> ``none``."""
    if norm.startswith("spectral_"):
        return norm[len("spectral_"):]
    return "none" if norm == "spectral" else norm


class UpsampleNearest(nn.Module):
    """x2 nearest upsample (the reference InterpolateNearest2d slot)."""

    def forward(self, x, update_sn: bool = False):
        return upsample_nearest(x, 2)

    def forward_rows(self, x: Rows, update_sn: bool = False) -> Rows:
        return spatial.upsample_nearest(x, 2)


def run_layers(layers: nn.Sequential, x: torch.Tensor,
               update_sn: bool) -> torch.Tensor:
    """A Sequential of update_sn-taking layers, in order."""
    for layer in layers:
        x = layer(x, update_sn=update_sn)
    return x


def run_layers_rows(layers: nn.Sequential, x: Rows,
                    update_sn: bool = False) -> Rows:
    """``run_layers`` on a row-sharded map."""
    for layer in layers:
        x = layer.forward_rows(x, update_sn)
    return x


class Conv2dBlock(nn.Module):
    """pad -> conv (optionally spectral) -> norm -> activation, with the
    reference bias rule: a non-spectral conv drops its bias before a batch
    norm. The norm (``spectral_``-prefixed or not): batch (``norm``, a
    ``BatchNorm2d``), instance (no parameters), layer (``norm``, a
    ``LayerNorm``) or none; a ``prelu`` activation is the module
    ``activation`` (key ``activation.weight``)."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 norm: str = "none", activation: str = "relu",
                 pad_type: str = "zero", bias: bool = True):
        super().__init__()
        use_spectral = norm == "spectral" or norm.startswith("spectral_")
        after = post_norm(norm)
        use_bias = bias if use_spectral or after != "batch" else False
        if pad_type not in _PAD_MODES:
            raise ValueError(f"Unsupported padding type: {pad_type}")
        if activation not in ACTIVATIONS:
            raise ValueError(f"Unsupported activation: {activation}")
        if after not in ("batch", "instance", "layer", "none"):
            raise ValueError(f"Unsupported normalization: {after}")
        self.padding, self.pad_mode = padding, _PAD_MODES[pad_type]
        self.activ = activation
        self.conv = SNConv(input_dim, output_dim, kernel_size, stride,
                           dilation=dilation, bias=use_bias,
                           spectral=use_spectral)
        self.norm = (BatchNorm2d(output_dim) if after == "batch" else
                     LayerNorm(output_dim) if after == "layer" else None)
        self.instance = after == "instance"
        self.activation = PReLU() if activation == "prelu" else None

    def _activate(self, x: torch.Tensor) -> torch.Tensor:
        if self.activation is None:
            return activation(x, self.activ)
        return self.activation(x)

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        if self.padding:
            p = self.padding
            x = F.pad(x, (p, p, p, p), mode=self.pad_mode)
        x = self.conv(x, update_sn)
        if self.norm is not None:
            x = self.norm(x)
        elif self.instance:
            x = instance_norm(x)
        return self._activate(x)

    def forward_rows(self, x: Rows, update_sn: bool = False) -> Rows:
        """The forward on a row-sharded map: the pad is applied where a
        window crosses the image's top or bottom. A PReLU's slope is read
        from the shard's replica in eval mode, else from the one
        parameter."""
        mode = "zero" if self.pad_mode == "constant" else self.pad_mode
        x = spatial.conv2d(x, self.conv, pad=self.padding, mode=mode,
                           update_sn=update_sn)
        if self.norm is not None:
            x = self.norm.forward_rows(x)
        elif self.instance:
            x = spatial.instance_norm(x)
        if self.activation is not None and not self.training:
            return x.map(lambda p: spatial.local(self.activation, p.device)(p))
        return x.map(self._activate)


class ResBlock(nn.Module):
    def __init__(self, dim: int, norm: str, activ: str, pad_type: str):
        super().__init__()
        self.model = nn.Sequential(
            Conv2dBlock(dim, dim, 3, 1, 1, norm=norm, activation=activ,
                        pad_type=pad_type),
            Conv2dBlock(dim, dim, 3, 1, 1, norm=norm, activation="none",
                        pad_type=pad_type),
        )

    def forward(self, x, update_sn: bool = False):
        return x + run_layers(self.model, x, update_sn)

    def forward_rows(self, x: Rows, update_sn: bool = False) -> Rows:
        return x.zip(run_layers_rows(self.model, x, update_sn), torch.add)


class ResBlocks(nn.Module):
    def __init__(self, num_blocks: int, dim: int, norm: str, activ: str,
                 pad_type: str):
        super().__init__()
        self.model = nn.Sequential(*[
            ResBlock(dim, norm, activ, pad_type) for _ in range(num_blocks)])

    def forward(self, x, update_sn: bool = False):
        return run_layers(self.model, x, update_sn)

    def forward_rows(self, x: Rows, update_sn: bool = False) -> Rows:
        return run_layers_rows(self.model, x, update_sn)


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

    def forward(self, z, z_depth: Optional[torch.Tensor] = None,
                update_sn: bool = False):
        low_level_feat = None
        if isinstance(z, (list, tuple)):
            if not self.use_low_level:
                z = z[0]
            else:
                z, low = z
                low = self.low_level_conv(low, update_sn)
                low_level_feat = resize(low, z.shape[-2:], "bilinear",
                                        align_corners=False)
        if z_depth is not None and self.use_dada:
            z = z * z_depth
        if self.proj_conv is not None:
            z = self.proj_conv(z, update_sn)
        if low_level_feat is not None:
            z = self.merge_feats_conv(torch.cat([low_level_feat, z], dim=1),
                                      update_sn)
        return run_layers(self.model, z, update_sn)

    def forward_rows(self, z, z_depth: Optional[Rows] = None,
                     update_sn: bool = False) -> Rows:
        """``forward`` on row-sharded maps: ``z`` a ``Rows`` or (high, low)
        ``Rows``."""
        low_level_feat = None
        if isinstance(z, (list, tuple)):
            if not self.use_low_level:
                z = z[0]
            else:
                z, low = z
                low = self.low_level_conv.forward_rows(low, update_sn)
                low_level_feat = spatial.resize(low, (z.h, z.w), "bilinear",
                                                align_corners=False)
        if z_depth is not None and self.use_dada:
            z = z.zip(z_depth, torch.mul)
        if self.proj_conv is not None:
            z = self.proj_conv.forward_rows(z, update_sn)
        if low_level_feat is not None:
            z = self.merge_feats_conv.forward_rows(low_level_feat.cat(z),
                                                   update_sn)
        return run_layers_rows(self.model, z, update_sn)


class SPADEResnetBlock(nn.Module):
    """SPADE residual block; its SPADEs normalize with an instance norm or
    (``param_free_norm="batch"``) each with its own batch norm. In eval
    mode, with a learned shortcut, norm_s and norm_0 run as one dual
    ``spade_cond`` launch, whatever the norm: they read the same
    conditioning input (the JAX package fuses the two only for instance
    norms; the values are the same). Packs are made on the first eval
    forward (or by ``pack_weights``) and again when the weights have moved
    to another device, or the conditioning comes in another dtype (f32
    weights under bf16 autocast pack in bf16); a mode switch and a weight
    load drop them.
    ``last_activation="lrelu"`` ends the block with a leaky relu (the SPADE
    mask decoder's blocks)."""

    def __init__(self, fin: int, fout: int, cond_nc: int,
                 use_spectral_norm: bool = True,
                 param_free_norm: str = "instance",
                 last_activation: Optional[str] = None):
        super().__init__()
        if last_activation not in (None, "lrelu"):
            raise NotImplementedError(
                f"Unsupported last_activation: {last_activation}")
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.last_activation = last_activation
        sn, pfn = use_spectral_norm, param_free_norm
        self.conv_0 = SNConv(fin, fmiddle, 3, padding=1, spectral=sn)
        self.conv_1 = SNConv(fmiddle, fout, 3, padding=1, spectral=sn)
        if self.learned_shortcut:
            self.conv_s = SNConv(fin, fout, 1, bias=False, spectral=sn)
            self.norm_s = SPADE(fin, cond_nc, param_free_norm=pfn)
        self.norm_0 = SPADE(fin, cond_nc, param_free_norm=pfn)
        self.norm_1 = SPADE(fmiddle, cond_nc, param_free_norm=pfn)
        self.shortcut_pack = None

    def pack_weights(self) -> None:
        """Packs the conditioning weights of this block's launches."""
        if self.learned_shortcut:
            self.shortcut_pack = pack_dual(self.norm_s, self.norm_0)
        else:
            self.norm_0.pack_weights()
        self.norm_1.pack_weights()

    def current_shortcut_pack(self, dtype: torch.dtype):
        """The dual pack of norm_s and norm_0 in ``dtype`` (a seg's)."""
        if not pack_fits(self.shortcut_pack, self.norm_s.mlp_shared[0].weight,
                         dtype):
            self.shortcut_pack = pack_dual(self.norm_s, self.norm_0, dtype)
        return self.shortcut_pack

    def train(self, mode: bool = True):
        super().train(mode)
        self.shortcut_pack = None
        return self

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.shortcut_pack = None

    def forward(self, x: torch.Tensor, seg: torch.Tensor,
                update_sn: bool = False) -> torch.Tensor:
        """``seg``: NCHW conditioning map at any size (nearest-resized)."""
        train = self.training
        seg = resize(seg, x.shape[-2:], "nearest").to(x.dtype)
        if not train:
            seg = nhwc(seg)

        def norm(spade, y):
            return spade.forward_train(y, seg) if train else spade(y, seg)

        if self.learned_shortcut:
            x_s, dx = dual_spade(x, seg, self.norm_s, self.norm_0,
                                 None if train else
                                 self.current_shortcut_pack(seg.dtype))
            x_s = self.conv_s(x_s, update_sn)
        else:
            x_s, dx = x, norm(self.norm_0, x)
        dx = self.conv_0(lrelu(dx), update_sn)
        dx = self.conv_1(lrelu(norm(self.norm_1, dx)), update_sn)
        out = x_s + dx
        return lrelu(out) if self.last_activation == "lrelu" else out

    def forward_rows(self, x: Rows, cond: Rows,
                     update_sn: bool = False) -> Rows:
        """The forward on a row-sharded ``x``; ``cond`` the row-sharded
        conditioning map at any size. Each SPADE normalizes through
        ``SPADE.normalize_rows``: an instance norm over the whole map, or
        its batch norm (eval: the running statistics on each shard; train:
        the statistics of every shard). In eval mode each shard's
        ``spade_cond`` launches run on the conditioning rows of its own
        rows with a 2-row halo (``norms.spade_windows``), norm_s and
        norm_0 as one dual launch; in train mode each SPADE's plain convs
        run on the conditioning rows (``SPADE.forward_train_rows``)."""
        if self.training:
            return self._train_rows(x, cond, update_sn)
        dtype = x.dtype
        seg = spatial.Resized(cond, (x.h, x.w), "nearest")
        wins = spade_windows(x, seg)
        normed = self._normalized_rows(x)
        if self.learned_shortcut:
            gbs = spade_cond_rows(wins, lambda d: spatial.local(
                self, d).current_shortcut_pack(dtype))
            x_s = spatial.conv2d(SPADE.modulate_rows(normed["s"], gbs, 0),
                                 self.conv_s)
            dx = SPADE.modulate_rows(normed["0"], gbs, 1)
        else:
            gbs = spade_cond_rows(wins, lambda d: spatial.local(
                self.norm_0, d).current_pack(dtype))
            x_s, dx = x, SPADE.modulate_rows(normed["0"], gbs, 0)
        dx = spatial.conv2d(dx.map(lrelu), self.conv_0)
        gbs = spade_cond_rows(wins, lambda d: spatial.local(
            self.norm_1, d).current_pack(dtype))
        dx = SPADE.modulate_rows(self.norm_1.normalize_rows(dx), gbs, 0)
        dx = spatial.conv2d(dx.map(lrelu), self.conv_1)
        out = x_s.zip(dx, torch.add)
        return out.map(lrelu) if self.last_activation == "lrelu" else out

    def _normalized_rows(self, x: Rows) -> dict:
        """x normalized for norm_s ("s", with a learned shortcut) and norm_0
        ("0"): one instance norm for both, or each SPADE's batch norm."""
        spades = {"0": self.norm_0}
        if self.learned_shortcut:
            spades = {"s": self.norm_s, **spades}
        if self.norm_0.param_free_norm is None:
            normed = spatial.instance_norm(x)
            return {key: normed for key in spades}
        return {key: spade.normalize_rows(x) for key, spade in spades.items()}

    def _train_rows(self, x: Rows, cond: Rows, update_sn: bool) -> Rows:
        """``forward`` in train mode on row-sharded maps, u/v stored in the
        same order (conv_s, conv_0, conv_1)."""
        seg = spatial.Resized(cond, (x.h, x.w), "nearest").rows(x.devices)
        seg = seg.map(lambda p: p.to(x.dtype))
        normed = self._normalized_rows(x)
        if self.learned_shortcut:
            x_s = spatial.conv2d(
                self.norm_s.forward_train_rows(x, seg, normed["s"]),
                self.conv_s, update_sn=update_sn)
        else:
            x_s = x
        dx = self.norm_0.forward_train_rows(x, seg, normed["0"])
        dx = spatial.conv2d(dx.map(lrelu), self.conv_0, update_sn=update_sn)
        dx = self.norm_1.forward_train_rows(dx, seg).map(lrelu)
        dx = spatial.conv2d(dx, self.conv_1, update_sn=update_sn)
        out = x_s.zip(dx, torch.add)
        return out.map(lrelu) if self.last_activation == "lrelu" else out


def pack_spade_weights(model: nn.Module) -> None:
    """Packs every SPADE block's conditioning weights into the kernels'
    layout now, on the model's device and in its dtype, rather than in the
    first eval forward."""
    for m in model.modules():
        if isinstance(m, SPADEResnetBlock):
            m.pack_weights()
