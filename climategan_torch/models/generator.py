"""OmniGenerator: encoder + {depth, seg, mask} heads + SPADE painter
(NCHW), with the reference module names (``encoder``, ``decoders.{d,s,m}``,
``painter``).

Encoders: the dilated ResNet (``deeplabv3``, the default), MobileNetV2
(``gen.deeplabv3.backbone: mobilenet``) or the DeepLab v2 ResNetMulti
(``gen.encoder.architecture: deeplabv2``). Depth: DADA (the default) or
the base decoder, in regression or bucket classification. Seg: DeepLabV3+
(ASPP, or the separable head with mobilenet) or the v2 decoder. Mask: the
base decoder (the default) or the SPADE decoder conditioned on
``make_m_cond``. Painter: ``no_z`` or a latent z, a final shortcut,
instance or batch SPADE norms.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from climategan_torch.kernels.masked_blend import MaskedBlend
from climategan_torch.models.deeplab import DeepLabV3Decoder
from climategan_torch.models.deeplab_v2 import DeeplabV2Encoder, DeepLabV2Decoder
from climategan_torch.models.depth import BaseDepthDecoder, DADADepthDecoder
from climategan_torch.models.masker import MaskBaseDecoder, MaskSpadeDecoder
from climategan_torch.models.mobilenet import MobileNetV2Encoder
from climategan_torch.models.norms import (
    init_weights,
    nhwc,
    running_statistics,
)
from climategan_torch.models.painter import PainterSpadeDecoder
from climategan_torch.models.resnet import ResNetEncoder
from climategan_torch.ops.image import normalize
from climategan_torch.ops.interpolate import resize
from climategan_torch.ops.perlin import blend_noise, mix_noise, shifted_noise
from climategan_torch.parallel import spatial
from climategan_torch.parallel.spatial import Rows

# the Perlin grid of paint_cloudy's sky probe: (8 + 1) x (8 + 1) uniforms
CLOUDY_RES = (8, 8)


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """The generator hyperparameters of ``opts.gen`` (the JAX package's
    ``GenConfig`` without its TPU layout switch)."""

    tasks: Tuple[str, ...] = ("d", "s", "m", "p")
    encoder_arch: str = "deeplabv3"  # deeplabv3 | deeplabv2
    s_architecture: str = "deeplabv3"
    backbone: str = "resnet"  # resnet | mobilenet
    output_stride: int = 8
    encoder_layers: Tuple[int, ...] = (3, 4, 23, 3)
    encoder_n_res: int = 0
    d_architecture: str = "dada"  # dada | base
    d_upsample_featuremaps: bool = True
    d_target_size: int = 160
    d_classify_buckets: int = 0
    s_num_classes: int = 11
    s_use_dada: bool = True
    s_target_size: Tuple[int, int] = (160, 160)
    m_use_spade: bool = False
    m_use_dada: bool = False
    m_spade_cond_nc: int = 15
    m_spade_latent_dim: int = 128
    m_spade_num_layers: int = 3
    m_spade_detach: bool = False
    m_use_proj: bool = True
    m_proj_dim: int = 64
    m_n_res: int = 3
    m_n_upsample: int = 3
    m_norm: str = "spectral"
    m_activ: str = "lrelu"
    m_pad_type: str = "reflect"
    m_use_low_level_feats: bool = True
    p_latent_dim: int = 640
    p_spade_n_up: int = 7
    p_no_z: bool = True
    p_use_final_shortcut: bool = False
    p_paste_original_content: bool = True
    p_spade_param_free_norm: str = "instance"
    p_spade_use_spectral_norm: bool = True

    @classmethod
    def from_opts(cls, opts) -> "GenConfig":
        g = opts.gen
        if int(g.p.get("spade_kernel_size", 3)) != 3:
            raise NotImplementedError(
                "gen.p.spade_kernel_size: the spade_cond kernel is 3x3 (the "
                "default); other sizes are not ported (ROADMAP A.10)")
        classify = bool(g.d.get("classify", {}).get("enable"))
        if classify and bool(g.m.get("use_spade", False)):
            raise ValueError(
                "gen.m.use_spade with gen.d.classify.enable: the mask "
                "decoder's conditioning would take the depth head's bucket "
                "logits, buckets + 14 channels wide, where the SPADEs take "
                "cond_nc (15 or 12) channels of one normalized depth map")
        sizes = {}
        for t in opts.data.get("transforms", []) or []:
            if t.get("name") == "resize" and isinstance(t.get("new_size"), dict):
                sizes = dict(t["new_size"])
        d_size = int(sizes.get("d", sizes.get("default", 640)))
        s_size = int(sizes.get("s", sizes.get("default", 640)))
        return cls(
            tasks=tuple(opts.tasks),
            encoder_arch=g.encoder.get("architecture", "deeplabv3"),
            s_architecture=g.s.get("architecture", "deeplabv3"),
            backbone=g.deeplabv3.get("backbone", "resnet"),
            output_stride=int(g.deeplabv3.get("output_stride", 8)),
            # the ResNet depths come from gen.deeplabv2.nblocks, as in the
            # JAX package
            encoder_layers=tuple(
                g.deeplabv2.get("nblocks", (3, 4, 23, 3)) or (3, 4, 23, 3)),
            encoder_n_res=int(g.encoder.get("n_res", 0) or 0),
            d_architecture=g.d.get("architecture", "dada"),
            d_upsample_featuremaps=bool(g.d.get("upsample_featuremaps", True)),
            d_target_size=d_size,
            d_classify_buckets=(int(g.d.classify.linspace.buckets)
                                if classify else 0),
            s_num_classes=int(g.s.get("output_dim", 11)),
            s_use_dada=bool(g.s.get("use_dada", True)),
            s_target_size=(s_size, s_size),
            m_use_spade=bool(g.m.get("use_spade", False)),
            m_use_dada=bool(g.m.get("use_dada", False)),
            m_spade_cond_nc=int(g.m.spade.get("cond_nc", 15)),
            m_spade_latent_dim=int(g.m.spade.get("latent_dim", 128)),
            m_spade_num_layers=int(g.m.spade.get("num_layers", 3)),
            m_spade_detach=bool(g.m.spade.get("detach", False)),
            m_use_proj=bool(g.m.get("use_proj", True)),
            m_proj_dim=int(g.m.get("proj_dim", 64)),
            m_n_res=int(g.m.get("n_res", 3)),
            m_n_upsample=int(g.m.get("n_upsample", 3)),
            m_norm=g.m.get("norm", "spectral"),
            m_activ=g.m.get("activ", "lrelu"),
            m_pad_type=g.m.get("pad_type", "reflect"),
            m_use_low_level_feats=bool(g.m.get("use_low_level_feats", True)),
            p_latent_dim=int(g.p.get("latent_dim", 640)),
            p_spade_n_up=int(g.p.get("spade_n_up", 7)),
            p_no_z=bool(g.p.get("no_z", True)),
            p_use_final_shortcut=bool(g.p.get("use_final_shortcut", False)),
            p_paste_original_content=bool(
                g.p.get("paste_original_content", True)),
            p_spade_param_free_norm=g.p.get("spade_param_free_norm",
                                            "instance"),
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
        v2 = c.encoder_arch == "deeplabv2"
        mobilenet = c.backbone == "mobilenet" and not v2
        res_dim = 320 if mobilenet else 2048
        low_dim = 24 if mobilenet else 256
        if any(t in c.tasks for t in "msd"):
            if v2:
                self.encoder = DeeplabV2Encoder(c.encoder_layers,
                                                c.encoder_n_res)
            elif mobilenet:
                self.encoder = MobileNetV2Encoder()
            else:
                self.encoder = ResNetEncoder(c.encoder_layers, c.output_stride)
        decoders = {}
        if "d" in c.tasks:
            if c.d_architecture == "dada":
                decoders["d"] = DADADepthDecoder(
                    res_dim=res_dim,
                    do_feat_fusion=c.m_use_dada or ("s" in c.tasks
                                                    and c.s_use_dada),
                    upsample_featuremaps=c.d_upsample_featuremaps,
                    target_size=c.d_target_size)
            else:
                decoders["d"] = BaseDepthDecoder(
                    res_dim, c.d_classify_buckets, c.d_upsample_featuremaps,
                    (c.d_target_size, c.d_target_size))
        if "s" in c.tasks:
            if v2 or c.s_architecture == "deeplabv2":
                decoders["s"] = DeepLabV2Decoder(c.s_num_classes, c.s_use_dada,
                                                 c.s_target_size, res_dim)
            else:
                decoders["s"] = DeepLabV3Decoder(
                    c.s_num_classes, c.s_use_dada, c.s_target_size,
                    "mobilenet" if mobilenet else "resnet")
        if "m" in c.tasks:
            if c.m_use_spade:
                decoders["m"] = MaskSpadeDecoder(
                    latent_dim=c.m_spade_latent_dim, cond_nc=c.m_spade_cond_nc,
                    num_layers=c.m_spade_num_layers, use_proj=c.m_use_proj,
                    proj_dim=c.m_proj_dim, input_dims=(res_dim, low_dim),
                    single_input=v2)
            else:
                # the v2 encoder gives one feature map: no low-level features
                low = low_dim if c.m_use_low_level_feats and not v2 else -1
                decoders["m"] = MaskBaseDecoder(
                    input_dim=res_dim, n_upsample=c.m_n_upsample,
                    n_res=c.m_n_res, proj_dim=c.m_proj_dim, norm=c.m_norm,
                    activ=c.m_activ, pad_type=c.m_pad_type,
                    low_level_feats_dim=low, use_dada=c.m_use_dada)
        self.decoders = nn.ModuleDict(decoders)
        if "p" in c.tasks:
            self.painter = PainterSpadeDecoder(
                latent_dim=c.p_latent_dim, spade_n_up=c.p_spade_n_up,
                spade_use_spectral_norm=c.p_spade_use_spectral_norm,
                spade_param_free_norm=c.p_spade_param_free_norm,
                no_z=c.p_no_z, use_final_shortcut=c.p_use_final_shortcut)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (``norms.init_weights``)."""
        init_weights(self, generator)

    # ---- masker ---------------------------------------------------------
    # encode, depth, segmentation, make_m_cond, mask, depth_map, paint and
    # paint_cloudy take row-sharded maps (``spatial.Rows``) as they take
    # tensors, in either mode, in every configuration
    def encode(self, x):
        if isinstance(x, Rows):
            return self.encoder.forward_rows(x)
        return self.encoder(x)

    def depth(self, z, update_sn: bool = False):
        if spatial.is_rows(z):
            return self.decoders["d"].forward_rows(z, update_sn)
        return self.decoders["d"](z, update_sn)

    def segmentation(self, z, z_depth=None):
        if spatial.is_rows(z):
            return self.decoders["s"].forward_rows(z, z_depth)
        return self.decoders["s"](z, z_depth)

    def make_m_cond(self, d, s, x=None):
        """The SPADE mask decoder's conditioning: ``cat(normalize(d),
        softmax(s)[, x bilinear (align_corners) to s's size])``, the
        gradient stopped at d and s with ``m_spade_detach``. On row-sharded
        maps the min-max of d is each image's over every shard."""
        rows = isinstance(d, Rows)
        if self.cfg.m_spade_detach:
            d, s = _detach(d), _detach(s)
        cats = [spatial.normalize(d) if rows else normalize(d),
                spatial.each(lambda t: torch.softmax(t, dim=1), s)]
        if self.cfg.m_spade_cond_nc == 15:
            if x is None:
                raise ValueError("cond_nc 15 needs x")
            cats.append(spatial.resize(x, (s.h, s.w), "bilinear",
                                       align_corners=True) if rows else
                        resize(x, s.shape[-2:], "bilinear",
                               align_corners=True))
        return cats[0].cat(*cats[1:]) if rows else torch.cat(cats, dim=1)

    def mask(self, z, z_depth=None, sigmoid: bool = True,
             update_sn: bool = False, cond=None, x=None):
        """Mask logits (or their sigmoid) from the encoder's features; the
        SPADE decoder takes ``cond``, or ``make_m_cond`` of the depth and
        seg heads on ``z`` and ``x``, detached."""
        rows = spatial.is_rows(z)
        if self.cfg.m_use_spade and cond is None:
            d, zd = self.depth(z)
            cond = _detach(self.make_m_cond(d, self.segmentation(z, zd), x))
        z_depth = z_depth if self.cfg.m_use_dada else None
        if rows:
            logits = self.decoders["m"].forward_rows(z, cond, z_depth,
                                                     update_sn)
            return logits.map(torch.sigmoid) if sigmoid else logits
        logits = self.decoders["m"](z, cond, z_depth, update_sn)
        return torch.sigmoid(logits) if sigmoid else logits

    def depth_map(self, d, largest: Optional[torch.Tensor] = None):
        """The depth head's output as one depth map: a classification
        head's bucket logits become their argmax, divided by the batch's
        largest (JAX ``depth_map``; on row-sharded logits the largest over
        every shard; ``largest``: the whole batch's where d is a part of
        it); a regression depth is returned as is."""
        channels = d.parts[0].shape[1] if isinstance(d, Rows) else d.shape[1]
        if channels == 1:
            return d
        idx = self.bucket_index(d)
        if largest is None:
            largest = self.bucket_max(idx)
        return spatial.each(lambda t: t / torch.clamp(
            largest.to(t.device), min=1e-12), idx)

    @staticmethod
    def bucket_index(d):
        """The argmax bucket of classification logits (a tensor or
        ``Rows``), as float."""
        return spatial.each(lambda t: torch.argmax(t, dim=1,
                                                   keepdim=True).float(), d)

    @staticmethod
    def bucket_max(idx) -> torch.Tensor:
        """The largest bucket index of a map of them (a tensor or
        ``Rows``: the largest over every shard, on the first one's
        device)."""
        if not isinstance(idx, Rows):
            return idx.max()
        return spatial.all_reduce([p.amax() if p.shape[2] else None
                                   for p in idx.parts], "max",
                                  idx.devices[:1])[0]

    def infer_masker(self, x):
        """x -> (depth, seg logits, mask), the encoder shared by all heads;
        depth is the depth head's raw output (bucket logits under
        classification: ``depth_map`` makes a depth map of them). On a
        row-sharded image, each as ``Rows``."""
        z = self.encode(x)
        d, z_depth = self.depth(z)
        s = self.segmentation(z, z_depth)
        cond = (_detach(self.make_m_cond(d, s, x)) if self.cfg.m_use_spade
                else None)
        return d, s, self.mask(z, z_depth, cond=cond)

    # ---- painter --------------------------------------------------------
    def sample_painter_z(self, batch_size: int, height: int, width: int,
                         dtype=torch.float32, device="cpu",
                         generator: Optional[torch.Generator] = None):
        """A normal draw of the painter's latent, (N, latent_dim, H /
        2^spade_n_up, W / 2^spade_n_up), from ``generator`` (on its device,
        then moved) or the device's default generator; None under
        ``no_z``."""
        c = self.cfg
        if c.p_no_z:
            return None
        shape = (batch_size, c.p_latent_dim, height // 2 ** c.p_spade_n_up,
                 width // 2 ** c.p_spade_n_up)
        where = device if generator is None else generator.device
        return torch.randn(shape, generator=generator, device=where,
                           dtype=torch.float32).to(device=device, dtype=dtype)

    def paint(self, m, x, no_paste: bool = False, update_sn: bool = False,
              z: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              frozen: bool = False):
        """painter(x * (1 - m)), then the paste of x outside the mask; the
        gradient reaches the painter through the paste. A painter with z
        takes ``z`` or draws it (``sample_painter_z``). ``frozen`` (pl4m):
        a train-mode painter runs with eval semantics (running statistics,
        no u/v stored) on its parameters detached, on the plain convs of
        train mode, so the gradient reaches m and x only."""
        if isinstance(x, Rows):
            return self.paint_rows(m, x, no_paste, update_sn, frozen, z,
                                   generator)
        m = m.to(x.dtype)
        if not self.cfg.p_no_z and z is None:
            z = self.sample_painter_z(x.shape[0], x.shape[2], x.shape[3],
                                      x.dtype, x.device, generator)
        z = None if z is None else z.to(x.dtype)
        if frozen and self.painter.training:
            params = {k: p.detach()
                      for k, p in self.painter.named_parameters()}
            with running_statistics(self.painter):
                fake = torch.func.functional_call(
                    self.painter, params, (x * (1.0 - m),), {"z": z})
        else:
            fake = self.painter(x * (1.0 - m), update_sn, z=z)
        if self.cfg.p_paste_original_content and not no_paste:
            return paste(x, fake, m)
        return fake

    def paint_cloudy(self, m, x, s, sky_idx: int = 9,
                     res: Tuple[int, int] = CLOUDY_RES, weight: float = 0.8,
                     uniform: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     z: Optional[torch.Tensor] = None):
        """Paint from a cloudy-sky probe (Perlin noise mixed into the sky of
        x), then paste the ORIGINAL x outside the mask."""
        s_up = resize(s, x.shape[-2:], "bilinear", align_corners=False)
        sky = (torch.argmax(s_up, dim=1, keepdim=True) == sky_idx).to(x.dtype)
        noised = mix_noise(x, sky, res=res, weight=weight, uniform=uniform,
                           generator=generator)
        m = m.to(x.dtype)
        fake = self.paint(m, noised.to(x.dtype), no_paste=True, z=z,
                          generator=generator)
        return paste(x, fake, m)

    # ---- row-sharded forwards ---------------------------------------------
    def paint_rows(self, m: Rows, x: Rows, no_paste: bool = False,
                   update_sn: bool = False, frozen: bool = False,
                   z: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Rows:
        """``paint`` on row-sharded maps, ``frozen`` as there; a painter
        with z takes ``z`` for the whole batch or draws it as ``paint``
        does, on the first shard's device, and splits its rows. The paste
        runs on each shard, with its gradient in train mode."""
        m = m.map(lambda p: p.to(x.dtype))
        if not self.cfg.p_no_z and z is None:
            z = self.sample_painter_z(x.parts[0].shape[0], x.h, x.w,
                                      x.dtype, x.devices[0], generator)
        z = None if z is None else z.to(x.dtype)
        cond = x.zip(m, lambda a, b: a * (1.0 - b))
        if frozen and self.painter.training:
            params = {k: p.detach()
                      for k, p in self.painter.named_parameters()}
            with running_statistics(self.painter):
                fake = torch.func.functional_call(self.painter, params,
                                                  (cond,), {"z": z})
        else:
            fake = self.painter.forward_rows(cond, update_sn, z)
        if self.cfg.p_paste_original_content and not no_paste:
            return paste_rows(x, fake, m)
        return fake

    def paint_cloudy_rows(self, m: Rows, x: Rows, s: Rows,
                          uniform: torch.Tensor, sky_idx: int = 9,
                          res: Tuple[int, int] = CLOUDY_RES,
                          weight: float = 0.8,
                          z: Optional[torch.Tensor] = None) -> Rows:
        """``paint_cloudy`` on row-sharded maps with the Perlin draws
        ``uniform`` (and ``z``, a painter's with z): each device computes
        the whole noise field (its minimum is the field's), each shard
        blends its rows."""
        s_up = spatial.resize(s, (x.h, x.w), "bilinear", align_corners=False)
        sky = s_up.map(lambda p: (torch.argmax(p, dim=1, keepdim=True)
                                  == sky_idx).to(x.dtype))
        fields = {}
        parts = []
        for i, (xp, sp) in enumerate(zip(x.parts, sky.parts)):
            if xp.device not in fields:
                fields[xp.device] = shifted_noise((x.h, x.w), res, uniform,
                                                  device=xp.device)
            lo, hi = x.bounds(i)
            parts.append(blend_noise(xp, sp, fields[xp.device][lo:hi],
                                     weight).to(x.dtype))
        m = m.map(lambda p: p.to(x.dtype))
        fake = self.paint_rows(m, Rows(parts), no_paste=True, z=z)
        return paste_rows(x, fake, m)


def _detach(t):
    """``t`` (a tensor or ``Rows``) detached."""
    return spatial.each(lambda p: p.detach(), t)


def paste_rows(x: Rows, fake: Rows, m: Rows) -> Rows:
    """``paste`` on each shard: one ``masked_blend`` launch per shard with
    rows."""
    return Rows([paste(a, b, c) if a.shape[2] else a
                 for a, b, c in zip(x.parts, fake.parts, m.parts)])


def create_generator(opts, seed: int = 0) -> OmniGenerator:
    """The generator of ``opts`` with random weights from ``seed``."""
    G = OmniGenerator(GenConfig.from_opts(opts))
    G.init_weights(torch.Generator().manual_seed(seed))
    return G
