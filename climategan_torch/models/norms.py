"""Convolutions with baked spectral norm, instance norm and SPADE (NCHW).

Parameter names follow the reference torch modules, so a reference state
dict loads with plain ``load_state_dict``:
  * a spectral conv keeps ``module.weight_bar`` / ``module.bias`` /
    ``module.weight_u`` / ``module.weight_v``; a plain conv ``weight`` /
    ``bias``;
  * ``SPADE`` keeps ``mlp_shared.0`` / ``mlp_gamma`` / ``mlp_beta``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.kernels.spade_cond import spade_cond


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # divide by (norm + eps), not rsqrt(sq + eps)
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_sigma(weight_bar: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """One power iteration from the stored ``u`` on the OIHW kernel
    flattened to (O, I*KH*KW), in f32; returns sigma."""
    w = weight_bar.detach().float().reshape(weight_bar.shape[0], -1)
    v = _l2normalize(w.t() @ u.float())
    u = _l2normalize(w @ v)
    return u @ (w @ v)


class _SpectralParams(nn.Module):
    """The reference's ``SpectralNorm(nn.Conv2d).module`` parameters."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool):
        super().__init__()
        self.weight_bar = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.register_buffer("weight_u", torch.empty(cout))
        self.register_buffer("weight_v", torch.empty(cin * k * k))


class SNConv(nn.Module):
    """2-D convolution, optionally spectral-normalized.

    A spectral conv runs with ``weight_bar / sigma``, baked into the
    non-persistent buffer ``weight`` whenever its weights are loaded or
    re-initialized (``bake``), so inference runs no power iteration. The
    baked kernel is computed in f32 from the loaded values and then takes
    the module's dtype.
    """

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True,
                 spectral: bool = False):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.spectral = spectral
        if spectral:
            self.module = _SpectralParams(cin, cout, k, bias)
            self.register_buffer("weight", torch.empty(cout, cin, k, k),
                                 persistent=False)
        else:
            self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
            self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    @torch.no_grad()
    def bake(self, weight_bar=None, u=None, v=None) -> None:
        if not self.spectral:
            return
        m = self.module
        weight_bar = m.weight_bar if weight_bar is None else weight_bar
        u = m.weight_u if u is None else u
        v = m.weight_v if v is None else v
        sigma = spectral_sigma(weight_bar, u.to(weight_bar.device),
                               v.to(weight_bar.device))
        baked = weight_bar.float() / sigma
        self.weight.copy_(baked.to(self.weight.device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        keys = [prefix + "module." + k for k in ("weight_bar", "weight_u",
                                                   "weight_v")]
        if self.spectral and all(k in state_dict for k in keys):
            self.bake(*(state_dict[k] for k in keys))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.module.bias if self.spectral else self.bias
        return F.conv2d(x, self.weight, bias, self.stride, self.padding,
                        self.dilation)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm without affine, biased variance; the statistics
    accumulate in f32 even for bf16 input."""
    mean = torch.mean(x, dim=(2, 3), keepdim=True, dtype=torch.float32)
    diff = x - mean.to(x.dtype)
    var = torch.mean(diff * diff, dim=(2, 3), keepdim=True,
                     dtype=torch.float32)
    return diff * torch.rsqrt(var + eps).to(x.dtype)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC, the layout of the conditioning kernel."""
    return x.permute(0, 2, 3, 1).contiguous()


class SPADE(nn.Module):
    """Spatially-adaptive instance norm: ``instance_norm(x) * (1 + gamma) +
    beta`` with [gamma|beta] from the ``spade_cond`` kernel over the
    conditioning map."""

    def __init__(self, norm_nc: int, cond_nc: int, nhidden: int = 128):
        super().__init__()
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(cond_nc, nhidden, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, 3, padding=1)

    def shared_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """mlp_shared as (HWIO kernel, bias)."""
        conv = self.mlp_shared[0]
        return conv.weight.permute(2, 3, 1, 0), conv.bias

    def branch(self):
        """(kg, bg, kb, bb) with HWIO kernels, a ``spade_cond`` branch."""
        return (self.mlp_gamma.weight.permute(2, 3, 1, 0).contiguous(),
                self.mlp_gamma.bias,
                self.mlp_beta.weight.permute(2, 3, 1, 0).contiguous(),
                self.mlp_beta.bias)

    @staticmethod
    def modulate(normalized: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
        nc = gb.shape[-1] // 2
        gamma = gb[..., :nc].permute(0, 3, 1, 2)
        beta = gb[..., nc:].permute(0, 3, 1, 2)
        return normalized * (1.0 + gamma) + beta

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """``seg``: NHWC conditioning map already at x's spatial size."""
        k1, b1 = self.shared_weights()
        (gb,) = spade_cond(seg, k1.contiguous(), b1, [self.branch()])
        return self.modulate(instance_norm(x), gb)


def dual_spade(x: torch.Tensor, seg: torch.Tensor, norm_a: SPADE,
               norm_b: SPADE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two SPADEs over the same (x, seg), as one ``spade_cond`` launch with
    the two mlp_shared convs concatenated (a SPADE block's norm_s and
    norm_0); the instance norm runs once."""
    ka, ba = norm_a.shared_weights()
    kb, bb = norm_b.shared_weights()
    gb_a, gb_b = spade_cond(seg, torch.cat([ka, kb], dim=-1).contiguous(),
                            torch.cat([ba, bb]),
                            [norm_a.branch(), norm_b.branch()])
    normalized = instance_norm(x)
    return SPADE.modulate(normalized, gb_a), SPADE.modulate(normalized, gb_b)
