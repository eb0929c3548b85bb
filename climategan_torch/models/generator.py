"""OmniGenerator: ResNet encoder + {depth, seg, mask} heads + SPADE painter
(NCHW), with the reference module names (``encoder``, ``decoders.{d,s,m}``,
``painter``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from climategan_torch.kernels.masked_blend import MaskedBlend
from climategan_torch.models.deeplab import DeepLabV3Decoder
from climategan_torch.models.depth import DADADepthDecoder
from climategan_torch.models.masker import MaskBaseDecoder
from climategan_torch.models.norms import init_weights, nhwc
from climategan_torch.models.painter import PainterSpadeDecoder
from climategan_torch.models.resnet import ResNetEncoder
from climategan_torch.ops.interpolate import resize
from climategan_torch.ops.perlin import mix_noise


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """The generator hyperparameters of ``opts.gen`` that this port
    builds."""

    tasks: Tuple[str, ...] = ("d", "s", "m", "p")
    output_stride: int = 8
    encoder_layers: Tuple[int, ...] = (3, 4, 23, 3)
    d_upsample_featuremaps: bool = True
    d_target_size: int = 160
    s_num_classes: int = 11
    s_use_dada: bool = True
    s_target_size: Tuple[int, int] = (160, 160)
    m_use_dada: bool = False
    m_proj_dim: int = 64
    m_n_res: int = 3
    m_n_upsample: int = 3
    m_norm: str = "spectral"
    m_activ: str = "lrelu"
    m_pad_type: str = "reflect"
    m_use_low_level_feats: bool = True
    p_latent_dim: int = 640
    p_spade_n_up: int = 7
    p_paste_original_content: bool = True
    p_spade_use_spectral_norm: bool = True

    @classmethod
    def from_opts(cls, opts) -> "GenConfig":
        g = opts.gen
        unsupported = {
            "gen.encoder.architecture": (g.encoder.get("architecture", "deeplabv3"), "deeplabv3"),
            "gen.s.architecture": (g.s.get("architecture", "deeplabv3"), "deeplabv3"),
            "gen.deeplabv3.backbone": (g.deeplabv3.get("backbone", "resnet"), "resnet"),
            "gen.d.architecture": (g.d.get("architecture", "dada"), "dada"),
            "gen.d.classify.enable": (bool(g.d.get("classify", {}).get("enable")), False),
            "gen.m.use_spade": (bool(g.m.get("use_spade", False)), False),
            "gen.p.no_z": (bool(g.p.get("no_z", True)), True),
            "gen.p.use_final_shortcut": (bool(g.p.get("use_final_shortcut", False)), False),
            "gen.p.spade_param_free_norm": (g.p.get("spade_param_free_norm", "instance"), "instance"),
            "gen.p.spade_kernel_size": (int(g.p.get("spade_kernel_size", 3)), 3),
        }
        for key, (value, ported) in unsupported.items():
            if value != ported:
                raise NotImplementedError(
                    f"{key}={value!r} is not ported yet (only {ported!r})")
        sizes = {}
        for t in opts.data.get("transforms", []) or []:
            if t.get("name") == "resize" and isinstance(t.get("new_size"), dict):
                sizes = dict(t["new_size"])
        d_size = int(sizes.get("d", sizes.get("default", 640)))
        s_size = int(sizes.get("s", sizes.get("default", 640)))
        return cls(
            tasks=tuple(opts.tasks),
            output_stride=int(g.deeplabv3.get("output_stride", 8)),
            # the ResNet depths come from gen.deeplabv2.nblocks, as in the
            # JAX package
            encoder_layers=tuple(
                g.deeplabv2.get("nblocks", (3, 4, 23, 3)) or (3, 4, 23, 3)),
            d_upsample_featuremaps=bool(g.d.get("upsample_featuremaps", True)),
            d_target_size=d_size,
            s_num_classes=int(g.s.get("output_dim", 11)),
            s_use_dada=bool(g.s.get("use_dada", True)),
            s_target_size=(s_size, s_size),
            m_use_dada=bool(g.m.get("use_dada", False)),
            m_proj_dim=int(g.m.get("proj_dim", 64)),
            m_n_res=int(g.m.get("n_res", 3)),
            m_n_upsample=int(g.m.get("n_upsample", 3)),
            m_norm=g.m.get("norm", "spectral"),
            m_activ=g.m.get("activ", "lrelu"),
            m_pad_type=g.m.get("pad_type", "reflect"),
            m_use_low_level_feats=bool(g.m.get("use_low_level_feats", True)),
            p_latent_dim=int(g.p.get("latent_dim", 640)),
            p_spade_n_up=int(g.p.get("spade_n_up", 7)),
            p_paste_original_content=bool(
                g.p.get("paste_original_content", True)),
            p_spade_use_spectral_norm=bool(
                g.p.get("spade_use_spectral_norm", True)),
        )


def paste(x: torch.Tensor, fake: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x * (1 - m) + fake * m`` on NCHW tensors through the
    ``masked_blend`` kernel (which takes NHWC), with a gradient."""
    return MaskedBlend.apply(nhwc(x), nhwc(fake), nhwc(m)).permute(0, 3, 1, 2)


class OmniGenerator(nn.Module):
    """Built with uninitialized weights: load a state dict or call
    ``init_weights`` (``create_generator`` does the latter)."""

    def __init__(self, cfg: GenConfig = GenConfig()):
        super().__init__()
        self.cfg = c = cfg
        res_dim, low_dim = 2048, 256
        if any(t in c.tasks for t in "msd"):
            self.encoder = ResNetEncoder(c.encoder_layers, c.output_stride)
        decoders = {}
        if "d" in c.tasks:
            decoders["d"] = DADADepthDecoder(
                res_dim=res_dim,
                do_feat_fusion=c.m_use_dada or ("s" in c.tasks and c.s_use_dada),
                upsample_featuremaps=c.d_upsample_featuremaps,
                target_size=c.d_target_size)
        if "s" in c.tasks:
            decoders["s"] = DeepLabV3Decoder(c.s_num_classes, c.s_use_dada,
                                             c.s_target_size)
        if "m" in c.tasks:
            decoders["m"] = MaskBaseDecoder(
                input_dim=res_dim, n_upsample=c.m_n_upsample, n_res=c.m_n_res,
                proj_dim=c.m_proj_dim, norm=c.m_norm, activ=c.m_activ,
                pad_type=c.m_pad_type,
                low_level_feats_dim=low_dim if c.m_use_low_level_feats else -1,
                use_dada=c.m_use_dada)
        self.decoders = nn.ModuleDict(decoders)
        if "p" in c.tasks:
            self.painter = PainterSpadeDecoder(
                latent_dim=c.p_latent_dim, spade_n_up=c.p_spade_n_up,
                spade_use_spectral_norm=c.p_spade_use_spectral_norm)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (``norms.init_weights``)."""
        init_weights(self, generator)

    # ---- masker ---------------------------------------------------------
    def encode(self, x):
        return self.encoder(x)

    def depth(self, z, update_sn: bool = False):
        return self.decoders["d"](z, update_sn)

    def segmentation(self, z, z_depth=None):
        return self.decoders["s"](z, z_depth)

    def mask(self, z, z_depth=None, sigmoid: bool = True,
             update_sn: bool = False):
        logits = self.decoders["m"](
            z, z_depth if self.cfg.m_use_dada else None, update_sn)
        return torch.sigmoid(logits) if sigmoid else logits

    def infer_masker(self, x):
        """x -> (depth, seg logits, mask), the encoder shared by all heads."""
        z = self.encode(x)
        d, z_depth = self.depth(z)
        s = self.segmentation(z, z_depth)
        return d, s, self.mask(z, z_depth)

    # ---- painter --------------------------------------------------------
    def paint(self, m, x, no_paste: bool = False, update_sn: bool = False):
        """painter(x * (1 - m)), then the paste of x outside the mask; the
        gradient reaches the painter through the paste."""
        m = m.to(x.dtype)
        fake = self.painter(x * (1.0 - m), update_sn)
        if self.cfg.p_paste_original_content and not no_paste:
            return paste(x, fake, m)
        return fake

    def paint_cloudy(self, m, x, s, sky_idx: int = 9,
                     res: Tuple[int, int] = (8, 8), weight: float = 0.8,
                     uniform: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """Paint from a cloudy-sky probe (Perlin noise mixed into the sky of
        x), then paste the ORIGINAL x outside the mask."""
        s_up = resize(s, x.shape[-2:], "bilinear", align_corners=False)
        sky = (torch.argmax(s_up, dim=1, keepdim=True) == sky_idx).to(x.dtype)
        noised = mix_noise(x, sky, res=res, weight=weight, uniform=uniform,
                           generator=generator)
        m = m.to(x.dtype)
        fake = self.paint(m, noised.to(x.dtype), no_paste=True)
        return paste(x, fake, m)


def create_generator(opts, seed: int = 0) -> OmniGenerator:
    """The generator of ``opts`` with random weights from ``seed``."""
    G = OmniGenerator(GenConfig.from_opts(opts))
    G.init_weights(torch.Generator().manual_seed(seed))
    return G
