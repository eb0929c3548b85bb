"""Convolutions with spectral norm, batch norm, instance norm, the
reference's layer norm and SPADE (NCHW), in an inference mode and a
training mode.

Parameter names follow the reference torch modules, so a reference state
dict loads with plain ``load_state_dict``:
  * a spectral conv keeps ``module.weight_bar`` / ``module.bias`` /
    ``module.weight_u`` / ``module.weight_v``; a plain conv ``weight`` /
    ``bias``;
  * ``BatchNorm2d`` keeps nn.BatchNorm2d's keys, ``LayerNorm`` the
    reference's ``gamma`` / ``beta``;
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
and again when the weights have moved to another device or the
conditioning comes in another dtype (f32 weights under bf16 autocast pack
in bf16, as a bf16 model's do).
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.kernels.spade_cond import (
    SpadePack,
    pack_spade_cond,
    spade_cond_packed,
)
from climategan_torch.parallel import distributed, spatial
from climategan_torch.parallel.spatial import Rows

# rows of conditioning a spade_cond launch reads beyond its output rows on
# each side: two stacked 3x3 convs
SPADE_HALO = 2


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # divide by (norm + eps), not rsqrt(sq + eps)
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_sigma(weight_bar: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One power iteration from the stored ``u`` on the detached OIHW
    kernel flattened to (O, I*KH*KW), in f32 (float64 for a float64
    kernel) with autocast off; returns ``(sigma, u, v)``. ``sigma = u @ (W
    @ v)`` carries the gradient into ``weight_bar``; u and v carry none.
    (``v`` is not read: the iteration starts from u, as the JAX package's
    does.)"""
    st = torch.promote_types(weight_bar.dtype, torch.float32)
    with torch.autocast(weight_bar.device.type, enabled=False):
        w = weight_bar.to(st).reshape(weight_bar.shape[0], -1)
        w_ng = w.detach()
        v = _l2normalize(w_ng.t() @ u.to(st))
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

    def train_weights(self, update_sn: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                 torch.Tensor]:
        """A spectral conv's train-mode (``weight_bar``, bias, ``1 /
        sigma``) from one power iteration, storing the new u and v under
        ``update_sn``: one call per forward, whole or row-sharded."""
        m = self.module
        sigma, u, v = spectral_sigma(m.weight_bar, m.weight_u, m.weight_v)
        if update_sn:
            with torch.no_grad():
                m.weight_u.copy_(u)
                m.weight_v.copy_(v)
        return m.weight_bar, m.bias, 1.0 / sigma

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        if not self.spectral:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            self.padding, self.dilation)
        m = self.module
        if not self.training:
            return F.conv2d(x, self.weight, m.bias, self.stride, self.padding,
                            self.dilation)
        weight, bias, scale = self.train_weights(update_sn)
        y = F.conv2d(x, weight, None, self.stride, self.padding,
                     self.dilation)
        y = y * scale.to(y.dtype)
        return y if bias is None else y + bias.to(y.dtype)[:, None, None]


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (momentum 0.1, eps 1e-5, the same keys) whose
    train-mode running variance takes the **biased** batch variance, as
    flax's BatchNorm (the JAX package's) does; nn.BatchNorm2d takes the
    unbiased one. The output normalizes by the batch statistics, with
    their gradient; eval mode is nn.BatchNorm2d's. The running statistics
    move by two ``lerp_``; ``num_batches_tracked`` keeps its key and is not
    advanced (nn.BatchNorm2d reads it only when momentum is None).

    Inside a data-parallel step (``distributed.sharded_batch()`` over
    several ranks), and on a row-sharded map (``forward_rows``), the
    statistics are those of the whole global batch, as JAX's batch norm
    over a data x space mesh takes them (``_GlobalBatchNorm``: sums over
    the shards and then the ranks give the mean, then the variance of the
    deviations from it, two passes), with their gradient; the running
    statistics move once per call, by the same values on every rank."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if distributed.batch_world() > 1:
            return self._forward_global([x])[0]
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            # the batch variance from 1 / sqrt(var + eps), both f32
            var = invstd.to(self.running_var).pow(-2).sub_(self.eps)
            self.running_mean.lerp_(mean.to(self.running_mean),
                                    self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y

    def forward_rows(self, r: Rows) -> Rows:
        """The forward on a row-sharded map: eval mode on each row alone,
        train mode over every shard's rows (and every rank's)."""
        if not self.training:
            return spatial.apply(r, self)
        return Rows(self._forward_global(r.parts))

    def _forward_global(self, parts) -> list:
        *ys, mean, var = _GlobalBatchNorm.apply(self.weight, self.bias,
                                                self.eps, *parts)
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var), self.momentum)
        return ys


def _channel_sums(parts, ranks: bool) -> list:
    """For each shard (a tuple of (N, C, H, W) planes on its device), the
    per-channel sums of its planes accumulated in float64 and
    concatenated; summed over the shards on the first one's device and,
    with ``ranks``, over the ranks, then copied to each shard's device."""
    sums = [torch.cat([p.sum((0, 2, 3), dtype=torch.float64)
                       for p in planes]) for planes in parts]
    devices = [s.device for s in sums]
    with spatial.trace_range("spatial.collective"):
        whole = torch.stack([s.to(devices[0]) for s in sums]).sum(0)
    if ranks:
        torch.distributed.all_reduce(whole)
    return [whole.to(d) for d in devices]


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch norm over a batch split across row shards (the ``*xs``, one
    per shard, each on its device) and ranks: the mean, then the variance
    of the deviations from it, from per-channel sums over every shard's
    and rank's rows (accumulated in float64, so that they do not depend on
    how the batch is split); the backward sums the output gradient and its
    product with the normalized input over the shards and ranks
    (SyncBatchNorm's form). It saves the inputs and two per-channel
    vectors a shard, as ``native_batch_norm`` does; the affine gradients
    are this rank's, summed over its shards, and summed over the ranks
    with the other gradients after the backward. Returns the outputs (in
    their input's dtype) and the batch mean and biased variance (no
    gradient). The math runs in f32 (float64 for float64 inputs)."""

    @staticmethod
    def forward(ctx, weight, bias, eps, *xs):
        c = xs[0].shape[1]
        world = distributed.batch_world()
        # the backward may run outside the sharded batch's block
        ctx.ranks = world > 1
        count = sum(x.numel() for x in xs) // c * world
        st = torch.promote_types(xs[0].dtype, torch.float32)
        xfs = [x.to(st) for x in xs]
        means = [(s / count).to(st)[None, :, None, None]
                 for s in _channel_sums([(xf,) for xf in xfs], ctx.ranks)]
        ds = [xf - m for xf, m in zip(xfs, means)]
        vars_ = [(s / count).to(st)
                 for s in _channel_sums([(d * d,) for d in ds], ctx.ranks)]
        ys, invstds = [], []
        for x, d, v in zip(xs, ds, vars_):
            invstd = torch.rsqrt(v + eps)[None, :, None, None]
            y = d * invstd
            if weight is not None:
                y = (y * weight.to(x.device)[None, :, None, None]
                     + bias.to(x.device)[None, :, None, None])
            ys.append(y.to(x.dtype))
            invstds.append(invstd)
        ctx.save_for_backward(weight, *xs, *means, *invstds)
        ctx.count, ctx.k = count, len(xs)
        mean, var = means[0].reshape(-1), vars_[0]
        ctx.mark_non_differentiable(mean, var)
        return (*ys, mean, var)

    @staticmethod
    def backward(ctx, *grads):
        k = ctx.k
        weight, *saved = ctx.saved_tensors
        xs, means, invstds = saved[:k], saved[k:2 * k], saved[2 * k:]
        c = xs[0].shape[1]
        st = means[0].dtype
        xhats = [(x.to(st) - m) * i for x, m, i in zip(xs, means, invstds)]
        dyfs = [g.to(st) for g in grads[:k]]
        sums = [(s / ctx.count).to(st) for s in _channel_sums(
            [(dy, dy * xh) for dy, xh in zip(dyfs, xhats)], ctx.ranks)]
        dxs, dw, db = [], 0.0, 0.0
        for x, dy, xh, inv, s in zip(xs, dyfs, xhats, invstds, sums):
            scale = inv if weight is None else \
                inv * weight.to(x.device)[None, :, None, None]
            dx = scale * (dy - s[:c][None, :, None, None]
                          - xh * s[c:][None, :, None, None])
            dxs.append(dx.to(x.dtype))
            if weight is not None:
                dw = dw + (dy * xh).sum((0, 2, 3)).to(weight.device)
                db = db + dy.sum((0, 2, 3)).to(weight.device)
        if weight is None:
            return (None, None, None, *dxs)
        return (dw, db, None, *dxs)


class LayerNorm(nn.Module):
    """The reference's layer norm (the JAX package's ``LayerNormRef``):
    each sample normalized over all of C, H and W by its mean and its
    **unbiased** std, as ``(x - mean) / (std + eps)`` (the eps on the std,
    not the variance), then a per-channel ``gamma`` and ``beta`` (keys
    ``gamma``, ``beta``). The math runs in f32 (float64 for float64
    inputs), upcast explicitly whatever autocast does, and the output
    takes the input's dtype. No running statistics: train and eval modes
    compute alike."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(num_features).uniform_())
        self.beta = nn.Parameter(torch.zeros(num_features))

    def _affine(self, d: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
        """``d`` (the deviations from the mean, f32 or float64) over
        ``std + eps``, times gamma plus beta, read on d's device (in eval
        mode, from the replica there)."""
        own = self if self.training else spatial.local(self, d.device)
        gamma = own.gamma.to(device=d.device, dtype=d.dtype)
        beta = own.beta.to(device=d.device, dtype=d.dtype)
        return (d / (std + self.eps)) * gamma[None, :, None, None] \
            + beta[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st = torch.promote_types(x.dtype, torch.float32)
        flat = x.reshape(x.shape[0], -1).to(st)
        mean = flat.mean(1)[:, None, None, None]
        std = flat.std(1, correction=1)[:, None, None, None]
        return self._affine(x.to(st) - mean, std).to(x.dtype)

    def forward_rows(self, r: Rows) -> Rows:
        """The forward on a row-sharded map: each sample's sum from every
        shard's rows (float64, on the first shard's device through
        ``spatial.all_reduce``, which carries the gradient), the mean, then
        the squared deviations from it summed so: two passes, as
        ``spatial.instance_norm`` takes them. A shard with no rows gives
        nothing. Nothing is summed over data-parallel ranks: the norm is
        per sample. In eval mode each shard reads gamma and beta of its
        device's replica; in train mode the one parameter set."""
        n, c = r.parts[0].shape[:2]
        count = c * r.h * r.w
        st = torch.promote_types(r.dtype, torch.float32)
        xfs = [p.to(st) for p in r.parts]
        means = [(s / count).to(st) for s in _sample_sums(xfs, n, r.devices)]
        ds = [xf - m for xf, m in zip(xfs, means)]
        stds = [(s / (count - 1)).sqrt().to(st)
                for s in _sample_sums([d * d for d in ds], n, r.devices)]
        return Rows([self._affine(d, s).to(p.dtype)
                     for d, s, p in zip(ds, stds, r.parts)])


def _sample_sums(parts, n: int, devices) -> list:
    """Each sample's sum over the shards' (N, C, rows, W) ``parts``,
    accumulated in float64, (N, 1, 1, 1) on every shard's device, with
    the gradient to each part; a part without rows gives nothing."""
    return spatial.all_reduce(
        [p.sum((1, 2, 3), dtype=torch.float64).reshape(n, 1, 1, 1)
         if p.shape[2] else None for p in parts], "sum", devices)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator`` (drawn on the CPU): conv kernels
    and biases uniform in +-1/sqrt(fan_in), unit spectral u/v, batch-norm
    affine and statistics near identity, a layer norm's gamma uniform in
    [0, 1) and beta zero and a PReLU's slope 0.25 (as the JAX package
    initialises them); spectral kernels re-baked."""
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
        elif isinstance(mod, LayerNorm):
            fill(mod.gamma, 0.0, 1.0)
            mod.beta.zero_()
        elif isinstance(mod, nn.PReLU):
            mod.weight.fill_(0.25)
    for mod in model.modules():
        if isinstance(mod, SNConv):
            mod.bake()


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm without affine, biased variance; the statistics
    accumulate in f32 even for bf16 input (float64 in float64)."""
    st = torch.promote_types(x.dtype, torch.float32)
    mean = torch.mean(x, dim=(2, 3), keepdim=True, dtype=st)
    diff = x - mean.to(x.dtype)
    var = torch.mean(diff * diff, dim=(2, 3), keepdim=True, dtype=st)
    return diff * torch.rsqrt(var + eps).to(x.dtype)


class AdaptiveInstanceNorm(nn.Module):
    """AdaIN (reference climategan/norms.py:8-46): ``instance_norm`` of
    NCHW ``x``, then a per-channel ``weight`` and ``bias`` of shape (C,)
    passed in with each call (the reference assigns them to the module
    before it). The math runs in f32 (float64 for float64), one rounding to
    the output's dtype at the end (that of x, weight and bias promoted):
    the JAX package rounds a bf16 input's deviations and its normalized map
    to bf16 on the way. It has no parameters or buffers of its own, so the
    weights bridge (``utils/convert.state_dict_from_jax``) has nothing to
    map."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    @staticmethod
    def _affine(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        c = y.shape[1]
        w = weight.to(y.device, y.dtype).view(1, c, 1, 1)
        b = bias.to(y.device, y.dtype).view(1, c, 1, 1)
        return (y * w + b).to(dtype)

    @staticmethod
    def _dtypes(x_dtype, weight, bias):
        """(the compute dtype, the output dtype)."""
        out = torch.promote_types(
            x_dtype, torch.promote_types(weight.dtype, bias.dtype))
        return torch.promote_types(x_dtype, torch.float32), out

    def forward(self, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        st, out = self._dtypes(x.dtype, weight, bias)
        return self._affine(instance_norm(x.to(st), self.eps), weight, bias,
                            out)

    def forward_rows(self, r: Rows, weight: torch.Tensor,
                     bias: torch.Tensor) -> Rows:
        """The forward on a row-sharded map: ``spatial.instance_norm``'s
        statistics over every shard, then the affine on each shard's
        device, with the gradient of weight and bias summed over them."""
        st, out = self._dtypes(r.dtype, weight, bias)
        y = spatial.instance_norm(r.map(lambda p: p.to(st)), self.eps)
        return y.map(lambda p: self._affine(p, weight, bias, out))


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
    and the seg's dtype, the forward packs and keeps the pack. A mode switch and a
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

    def pack_weights(self, dtype: Optional[torch.dtype] = None) -> SpadePack:
        """Packs the weights, cast to ``dtype`` where it is given."""
        k1, b1 = self.shared_weights()
        self.pack = make_pack(pack_spade_cond, *cast_weights(
            dtype, k1, b1, [self.branch()]))
        return self.pack

    def current_pack(self, dtype: torch.dtype) -> SpadePack:
        """The pack of the current weights in ``dtype`` (a seg's), made if
        there is none that fits their device and that dtype."""
        if not pack_fits(self.pack, self.mlp_shared[0].weight, dtype):
            self.pack_weights(dtype)
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

    @staticmethod
    def modulate_rows(normalized: Rows, gbs, branch: int) -> Rows:
        """``modulate`` on each shard with branch ``branch`` of its
        ``spade_cond_rows`` outputs (a shard without rows passes)."""
        return Rows([p if gb is None else SPADE.modulate(p, gb[branch])
                     for p, gb in zip(normalized.parts, gbs)])

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """``seg``: NHWC conditioning map already at x's spatial size."""
        (gb,) = spade_cond_packed(seg, self.current_pack(seg.dtype))
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

    def normalize_rows(self, x: Rows) -> Rows:
        if self.param_free_norm is None:
            return spatial.instance_norm(x)
        return self.param_free_norm.forward_rows(x)

    def forward_train_rows(self, x: Rows, seg: Rows,
                           normalized: Optional[Rows] = None) -> Rows:
        """``forward_train`` on row-sharded maps: ``seg`` the conditioning
        rows split as x's; its three convs read their halos."""
        actv = spatial.conv2d(seg, self.mlp_shared[0]).map(F.relu)
        if normalized is None:
            normalized = self.normalize_rows(x)
        gamma = spatial.conv2d(actv, self.mlp_gamma)
        beta = spatial.conv2d(actv, self.mlp_beta)
        return spatial.each(lambda n, g, b: n * (1.0 + g) + b, normalized,
                            gamma, beta)


def make_pack(pack_fn, *args) -> SpadePack:
    """``pack_fn(*args)`` outside inference mode, so that a pack made
    during an inference-mode forward can serve any later eval forward."""
    with torch.inference_mode(False):
        return pack_fn(*args)


def cast_weights(dtype: Optional[torch.dtype], k1: torch.Tensor,
                 b1: torch.Tensor, branches):
    """``(k1, b1, branches)`` cast to ``dtype``, or as they are for None:
    f32 weights run in bf16 when an autocast forward gives a bf16 seg."""
    if dtype is None:
        return k1, b1, branches
    return (k1.to(dtype), b1.to(dtype),
            [tuple(t.to(dtype) for t in b) for b in branches])


def pack_fits(pack: Optional[SpadePack], weight: torch.Tensor,
              dtype: torch.dtype) -> bool:
    """Whether ``pack`` exists and was made from weights on ``weight``'s
    device, in ``dtype``."""
    return (pack is not None and pack.args[0].device == weight.device
            and pack.args[0].dtype == dtype)


def pack_dual(norm_a: SPADE, norm_b: SPADE,
              dtype: Optional[torch.dtype] = None) -> SpadePack:
    """One pack for two SPADEs over the same seg: the two mlp_shared convs
    concatenated, one branch each; cast to ``dtype`` where it is given."""
    ka, ba = norm_a.shared_weights()
    kb, bb = norm_b.shared_weights()
    return make_pack(pack_spade_cond, *cast_weights(
        dtype, torch.cat([ka, kb], dim=-1), torch.cat([ba, bb]),
        [norm_a.branch(), norm_b.branch()]))


def spade_windows(x: Rows, seg):
    """Per shard of ``x``: (the NHWC conditioning rows [lo - 2, hi + 2) of
    its rows [lo, hi), clipped to the image, in x's dtype; the offset of
    row lo in it), or None for a shard without rows. ``seg`` gives the
    conditioning map at x's size (``spatial.Resized``). ``spade_cond``'s
    convs zero-pad at the window's edge as at the image's, so its output
    rows [lo, hi) on the window are those of the whole map."""
    out = []
    for i, dev in enumerate(x.devices):
        lo, hi = x.bounds(i)
        if lo == hi:
            out.append(None)
            continue
        wlo, whi = max(lo - SPADE_HALO, 0), min(hi + SPADE_HALO, x.h)
        out.append((nhwc(seg.fetch(wlo, whi, dev).to(x.dtype)), lo - wlo,
                    hi - lo))
    return out


def spade_cond_rows(windows, pack_of):
    """``spade_cond_packed`` on each shard's window (``spade_windows``)
    with the pack ``pack_of(device)``, its outputs cropped to the shard's
    rows; None for a shard without rows."""
    outs = []
    for win in windows:
        if win is None:
            outs.append(None)
            continue
        seg, off, n = win
        gbs = spade_cond_packed(seg, pack_of(seg.device))
        outs.append([g[:, off:off + n] for g in gbs])
    return outs


@contextlib.contextmanager
def running_statistics(module: nn.Module) -> Iterator[None]:
    """Inside the block, the batch norms of ``module`` that are in train
    mode normalize by their running statistics and leave them as they are,
    as in eval mode, while every other layer stays in train mode: spectral
    convs run their power iteration on the live weights (storing nothing
    without ``update_sn``) and SPADEs their plain convs, all under
    autograd. The JAX step's painter for pl4m (``G.apply(..., train=False)``)
    computes this."""
    norms = [m for m in module.modules()
             if isinstance(m, nn.BatchNorm2d) and m.training]
    for m in norms:
        m.training = False
    try:
        yield
    finally:
        for m in norms:
            m.training = True


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
