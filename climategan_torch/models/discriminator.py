"""Discriminators (NCHW), as the JAX package's ``models/discriminator.py``:

  * ``NLayerDiscriminator``: a spectral-normed PatchGAN (4x4 convs) that
    returns every layer's output, for feature matching;
  * ``MultiscaleDiscriminator``: ``num_D`` PatchGANs over an image pyramid
    of 3x3 stride-2 average pools that do not count the padding;
  * ``FCDiscriminator``: ADVENT's five stride-2 4x4 convs over entropy
    maps, spectral-normed under ``WGAN_norm``;
  * ``OmniDiscriminator``: ``p`` (the painter's), ``m_advent`` and
    ``s_advent``.

Module names follow the JAX ones (``p.discriminator_{i}.conv{k}``,
``m_advent.conv{i}``), with the port's spectral-conv keys
(``.module.weight_bar`` etc.). Every spectral conv takes ``update_sn`` as
the generator's do.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.models.norms import SNConv, init_weights, instance_norm


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 4,
                 norm: str = "instance", use_sigmoid: bool = False,
                 get_intermediate_features: bool = True):
        super().__init__()
        if norm not in ("instance", "none"):
            raise ValueError(f"NLayerDiscriminator norm {norm!r}")
        self.n_layers, self.norm = n_layers, norm
        self.use_sigmoid = use_sigmoid
        self.get_intermediate_features = get_intermediate_features
        widths = [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]
        cin = input_nc
        for k, w in enumerate(widths):
            stride = 2 if k < n_layers else 1
            setattr(self, f"conv{k}", SNConv(cin, w, 4, stride, padding=1,
                                             spectral=True))
            cin = w
        self.conv_out = SNConv(cin, 1, 4, 1, padding=1, spectral=True)

    def forward(self, x: torch.Tensor, update_sn: bool = False):
        feats = []
        y = x
        for k in range(self.n_layers + 1):
            y = getattr(self, f"conv{k}")(y, update_sn)
            if k > 0 and self.norm == "instance":
                y = instance_norm(y)
            y = lrelu(y)
            feats.append(y)
        y = self.conv_out(y, update_sn)
        if self.use_sigmoid:
            y = torch.sigmoid(y)
        feats.append(y)
        return feats if self.get_intermediate_features else feats[-1]


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


class MultiscaleDiscriminator(nn.Module):
    def __init__(self, input_nc: int, num_D: int = 3, ndf: int = 64,
                 n_layers: int = 4, norm: str = "instance",
                 use_sigmoid: bool = False,
                 get_intermediate_features: bool = True):
        super().__init__()
        self.num_D = num_D
        self.get_intermediate_features = get_intermediate_features
        for i in range(num_D):
            setattr(self, f"discriminator_{i}", NLayerDiscriminator(
                input_nc, ndf, n_layers, norm, use_sigmoid,
                get_intermediate_features))

    def forward(self, x: torch.Tensor,
                update_sn: bool = False) -> List[List[torch.Tensor]]:
        result = []
        for i in range(self.num_D):
            out = getattr(self, f"discriminator_{i}")(x, update_sn)
            result.append(out if self.get_intermediate_features else [out])
            if i < self.num_D - 1:
                x = avg_pool_3x3_s2(x)
        return result


class FCDiscriminator(nn.Module):
    """ADVENT's entropy-map discriminator: 5 stride-2 4x4 convs."""

    def __init__(self, input_nc: int, ndf: int = 64, use_norm: bool = True):
        super().__init__()
        dims = (ndf, ndf * 2, ndf * 4, ndf * 8, 1)
        cin = input_nc
        for i, f in enumerate(dims):
            setattr(self, f"conv{i}", SNConv(cin, f, 4, 2, padding=1,
                                             spectral=use_norm))
            cin = f
        self.n = len(dims)

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"conv{i}")(x, update_sn)
            if i < self.n - 1:
                x = lrelu(x)
        return x


@dataclasses.dataclass(frozen=True)
class DisConfig:
    tasks: Tuple[str, ...] = ("d", "s", "m", "p")
    p_use_local: bool = False
    p_num_D: int = 3
    p_ndf: int = 64
    p_n_layers: int = 4
    p_norm: str = "instance"
    p_use_sigmoid: bool = False
    p_get_intermediate_features: bool = True
    m_use_advent: bool = True
    m_wgan_norm: bool = True
    s_use_advent: bool = True
    s_wgan_norm: bool = True
    s_num_classes: int = 11

    @classmethod
    def from_opts(cls, opts) -> "DisConfig":
        d = opts.dis
        return cls(
            tasks=tuple(opts.tasks),
            p_use_local=bool(d.p.get("use_local_discriminator", False)),
            p_num_D=int(d.p.get("num_D", 3)),
            p_ndf=int(d.p.get("ndf", 64)),
            p_n_layers=int(d.p.get("n_layers", 4)),
            p_norm=d.p.get("norm", "instance"),
            p_use_sigmoid=bool(d.p.get("use_sigmoid", False)),
            p_get_intermediate_features=bool(
                d.p.get("get_intermediate_features", True)),
            m_use_advent=bool(opts.gen.m.get("use_advent", True)),
            m_wgan_norm=d.m.get("gan_type", "WGAN_norm") == "WGAN_norm",
            s_use_advent=bool(opts.gen.s.get("use_advent", True)),
            s_wgan_norm=d.s.get("gan_type", "WGAN_norm") == "WGAN_norm",
            s_num_classes=int(opts.gen.s.get("output_dim", 11)),
        )


class OmniDiscriminator(nn.Module):
    """``p`` (the painter's, over [mask | image], 4 channels), ``m_advent``
    (2 channels) and ``s_advent`` (the seg classes), as the config asks.
    The local/global painter pair is not ported (``StepBuilder`` refuses
    it)."""

    def __init__(self, cfg: DisConfig = DisConfig()):
        super().__init__()
        self.cfg = c = cfg
        if "p" in c.tasks:
            if c.p_use_local:
                raise ValueError("dis.p.use_local_discriminator is not ported "
                                 "(ROADMAP A.8 remainder)")
            self.p = MultiscaleDiscriminator(
                4, c.p_num_D, c.p_ndf, c.p_n_layers, c.p_norm,
                c.p_use_sigmoid, c.p_get_intermediate_features)
        if "m" in c.tasks and c.m_use_advent:
            self.m_advent = FCDiscriminator(2, use_norm=c.m_wgan_norm)
        if "s" in c.tasks and c.s_use_advent:
            self.s_advent = FCDiscriminator(c.s_num_classes,
                                            use_norm=c.s_wgan_norm)

    def disc_p(self, x, update_sn: bool = False):
        return self.p(x, update_sn)

    def disc_m(self, x, update_sn: bool = False):
        return self.m_advent(x, update_sn)

    def disc_s(self, x, update_sn: bool = False):
        return self.s_advent(x, update_sn)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (``norms.init_weights``)."""
        init_weights(self, generator)


def create_discriminator(opts, seed: int = 1) -> OmniDiscriminator:
    """The discriminators of ``opts`` with random weights from ``seed``."""
    D = OmniDiscriminator(DisConfig.from_opts(opts))
    D.init_weights(torch.Generator().manual_seed(seed))
    return D
