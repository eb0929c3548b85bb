"""Convolutions with spectral norm, batch norm, instance norm and SPADE
(NCHW), in an inference mode and a training mode.

Parameter names follow the reference torch modules, so a reference state
dict loads with plain ``load_state_dict``:
  * a spectral conv keeps ``module.weight_bar`` / ``module.bias`` /
    ``module.weight_u`` / ``module.weight_v``; a plain conv ``weight`` /
    ``bias``;
  * ``BatchNorm2d`` keeps nn.BatchNorm2d's keys;
  * ``SPADE`` keeps ``mlp_shared.0`` / ``mlp_gamma`` / ``mlp_beta`` (and
    ``param_free_norm``'s running statistics with a batch norm).

In eval mode a spectral conv runs a baked kernel and SPADE runs the
``spade_cond`` kernel on packed weights. In train mode they compute as the
JAX package's training step does, on the live parameters and under
autograd: spectral norm runs its power iteration on every call, and SPADE's
conditioning runs as plain convs (the kernel has no backward). Switching
modes refreshes what the eval mode reads: ``train(False)`` re-bakes every
spectral kernel (a buffer, which then moves and casts with the module) and
either mode drops the SPADE packs; an eval-mode forward packs on first use
and again when the weights have moved to another device or dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.kernels.spade_cond import (
    SpadePack,
    pack_spade_cond,
    spade_cond_packed,
)


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # divide by (norm + eps), not rsqrt(sq + eps)
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_sigma(weight_bar: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One power iteration from the stored ``u`` on the detached OIHW
    kernel flattened to (O, I*KH*KW), in f32 with autocast off; returns
    ``(sigma, u, v)``. ``sigma = u @ (W @ v)`` carries the gradient into
    ``weight_bar``; u and v carry none. (``v`` is not read: the iteration
    starts from u, as the JAX package's does.)"""
    with torch.autocast(weight_bar.device.type, enabled=False):
        w = weight_bar.float().reshape(weight_bar.shape[0], -1)
        w_ng = w.detach()
        v = _l2normalize(w_ng.t() @ u.float())
        u = _l2normalize(w_ng @ v)
        return u @ (w @ v), u, v


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

    Eval mode: a spectral conv runs with ``weight_bar / sigma`` baked into
    the non-persistent buffer ``weight``, so inference runs no power
    iteration. It is baked whenever weights are loaded, at ``init_weights``
    and at ``train(False)``, in f32 from the current values, and then takes
    the module's dtype.

    Train mode: sigma comes from ``spectral_sigma`` on every call, and the
    conv output is multiplied by ``1 / sigma`` before the bias (the JAX
    package's order). ``update_sn=True`` stores the new u and v; without it
    they stay as they are.
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
        sigma, _, _ = spectral_sigma(weight_bar, u.to(weight_bar.device),
                                     v.to(weight_bar.device))
        baked = weight_bar.float() / sigma
        self.weight.copy_(baked.to(self.weight.device))

    def train(self, mode: bool = True):
        super().train(mode)
        if not mode:
            self.bake()
        return self

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        keys = [prefix + "module." + k for k in ("weight_bar", "weight_u",
                                                   "weight_v")]
        if self.spectral and all(k in state_dict for k in keys):
            self.bake(*(state_dict[k] for k in keys))

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        if not self.spectral:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            self.padding, self.dilation)
        m = self.module
        if not self.training:
            return F.conv2d(x, self.weight, m.bias, self.stride, self.padding,
                            self.dilation)
        sigma, u, v = spectral_sigma(m.weight_bar, m.weight_u, m.weight_v)
        if update_sn:
            with torch.no_grad():
                m.weight_u.copy_(u)
                m.weight_v.copy_(v)
        y = F.conv2d(x, m.weight_bar, None, self.stride, self.padding,
                     self.dilation)
        y = y * (1.0 / sigma).to(y.dtype)
        return y if m.bias is None else y + m.bias.to(y.dtype)[:, None, None]


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (momentum 0.1, eps 1e-5, the same keys) whose
    train-mode running variance takes the **biased** batch variance, as
    flax's BatchNorm (the JAX package's) does; nn.BatchNorm2d takes the
    unbiased one. The output normalizes by the batch statistics, with
    their gradient; eval mode is nn.BatchNorm2d's. The running statistics
    move by two ``lerp_``; ``num_batches_tracked`` keeps its key and is not
    advanced (nn.BatchNorm2d reads it only when momentum is None)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            # the batch variance from 1 / sqrt(var + eps), both f32
            var = invstd.float().pow(-2).sub_(self.eps)
            self.running_mean.lerp_(mean.float(), self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator`` (drawn on the CPU): conv kernels
    and biases uniform in +-1/sqrt(fan_in), unit spectral u/v, batch-norm
    affine and statistics near identity; spectral kernels re-baked."""
    def fill(t, lo, hi):
        r = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        t.copy_(lo + (hi - lo) * r)

    def unit(t):
        r = torch.randn(t.shape, generator=generator, dtype=torch.float32)
        t.copy_(r / r.norm())

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, _SpectralParams)) or (
                isinstance(mod, SNConv) and not mod.spectral):
            w = mod.weight_bar if isinstance(mod, _SpectralParams) else mod.weight
            bound = 1.0 / math.sqrt(w[0].numel())
            fill(w, -bound, bound)
            if mod.bias is not None:
                fill(mod.bias, -bound, bound)
            if isinstance(mod, _SpectralParams):
                unit(mod.weight_u)
                unit(mod.weight_v)
        elif isinstance(mod, nn.BatchNorm2d):
            if mod.affine:
                fill(mod.weight, 0.8, 1.2)
                fill(mod.bias, -0.1, 0.1)
            fill(mod.running_mean, -0.1, 0.1)
            fill(mod.running_var, 0.8, 1.2)
    for mod in model.modules():
        if isinstance(mod, SNConv):
            mod.bake()


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
    """Spatially-adaptive norm: ``normalize(x) * (1 + gamma) + beta``,
    [gamma|beta] from a conv MLP over the conditioning map; ``normalize``
    is an instance norm or (``param_free_norm="batch"``) a batch norm
    without affine parameters, whose running variance takes the biased
    batch variance in train mode, as flax's does.

    Eval mode (``forward``, NHWC ``seg``): the ``spade_cond`` kernel, on
    weights packed by ``pack_weights`` (``pack_spade_weights`` packs a
    whole model up front); without a pack that fits the weights' device
    and dtype, the forward packs and keeps the pack. A mode switch and a
    weight load drop it. Train mode (``forward_train``, NCHW ``seg``): the
    convs of ``mlp_shared``, ``mlp_gamma`` and ``mlp_beta`` on the live
    parameters."""

    def __init__(self, norm_nc: int, cond_nc: int, nhidden: int = 128,
                 param_free_norm: str = "instance"):
        super().__init__()
        if param_free_norm not in ("instance", "batch"):
            raise ValueError(f"Unknown SPADE param-free norm {param_free_norm}")
        self.param_free_norm = (BatchNorm2d(norm_nc, affine=False)
                                if param_free_norm == "batch" else None)
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(cond_nc, nhidden, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, 3, padding=1)
        self.pack = None

    def shared_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """mlp_shared as (HWIO kernel, bias), views of the parameters."""
        conv = self.mlp_shared[0]
        return conv.weight.permute(2, 3, 1, 0), conv.bias

    def branch(self):
        """(kg, bg, kb, bb) with HWIO kernels, a ``spade_cond`` branch."""
        return (self.mlp_gamma.weight.permute(2, 3, 1, 0), self.mlp_gamma.bias,
                self.mlp_beta.weight.permute(2, 3, 1, 0), self.mlp_beta.bias)

    def pack_weights(self) -> SpadePack:
        k1, b1 = self.shared_weights()
        self.pack = make_pack(pack_spade_cond, k1, b1, [self.branch()])
        return self.pack

    def current_pack(self) -> SpadePack:
        """The pack of the current weights, made if there is none that
        fits their device and dtype."""
        if not pack_fits(self.pack, self.mlp_shared[0].weight):
            self.pack_weights()
        return self.pack

    def train(self, mode: bool = True):
        super().train(mode)
        self.pack = None
        return self

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.pack = None

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        if self.param_free_norm is None:
            return instance_norm(x)
        return self.param_free_norm(x)

    @staticmethod
    def modulate(normalized: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
        nc = gb.shape[-1] // 2
        gamma = gb[..., :nc].permute(0, 3, 1, 2)
        beta = gb[..., nc:].permute(0, 3, 1, 2)
        return normalized * (1.0 + gamma) + beta

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """``seg``: NHWC conditioning map already at x's spatial size."""
        (gb,) = spade_cond_packed(seg, self.current_pack())
        return self.modulate(self.normalize(x), gb)

    def forward_train(self, x: torch.Tensor, seg: torch.Tensor,
                      normalized: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """``seg``: NCHW conditioning map already at x's spatial size;
        ``normalized``: ``self.normalize(x)`` when the caller has it."""
        actv = self.mlp_shared(seg)
        if normalized is None:
            normalized = self.normalize(x)
        return normalized * (1.0 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


def make_pack(pack_fn, *args) -> SpadePack:
    """``pack_fn(*args)`` outside inference mode, so that a pack made
    during an inference-mode forward can serve any later eval forward."""
    with torch.inference_mode(False):
        return pack_fn(*args)


def pack_fits(pack: Optional[SpadePack], weight: torch.Tensor) -> bool:
    """Whether ``pack`` exists and was made from weights on ``weight``'s
    device and in its dtype."""
    return (pack is not None and pack.args[0].device == weight.device
            and pack.args[0].dtype == weight.dtype)


def pack_dual(norm_a: SPADE, norm_b: SPADE) -> SpadePack:
    """One pack for two SPADEs over the same seg: the two mlp_shared convs
    concatenated, one branch each."""
    ka, ba = norm_a.shared_weights()
    kb, bb = norm_b.shared_weights()
    return make_pack(pack_spade_cond, torch.cat([ka, kb], dim=-1),
                     torch.cat([ba, bb]), [norm_a.branch(), norm_b.branch()])


def dual_spade(x: torch.Tensor, seg: torch.Tensor, norm_a: SPADE,
               norm_b: SPADE, pack: Optional[SpadePack] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two SPADEs over the same (x, seg) (a SPADE block's norm_s and
    norm_0): one instance norm, or each its own batch norm. Eval mode: one
    ``spade_cond`` launch with the two mlp_shared convs concatenated, from
    ``pack`` (``pack_dual``) or packed for this call, on an NHWC ``seg``.
    Train mode: each SPADE's ``forward_train`` on an NCHW ``seg``."""
    norm_a_x = norm_a.normalize(x)
    norm_b_x = (norm_a_x if norm_b.param_free_norm is None
                else norm_b.normalize(x))
    if norm_a.training:
        return (norm_a.forward_train(x, seg, norm_a_x),
                norm_b.forward_train(x, seg, norm_b_x))
    gb_a, gb_b = spade_cond_packed(seg, pack or pack_dual(norm_a, norm_b))
    return SPADE.modulate(norm_a_x, gb_a), SPADE.modulate(norm_b_x, gb_b)
