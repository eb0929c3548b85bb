"""Losses of the training step, as plain functions on NCHW tensors.

The same functions as the JAX package's ``losses.py``, which re-designs the
reference ``climategan/losses.py``; each keeps the JAX package's formula,
its reductions and its quirks:
  * ``gan_loss`` takes its random draws, one soft label shift and one flip
    for every scale of the call, as arguments;
  * ``sigm_loss`` takes the median as numpy and JAX do (the mean of the two
    middle values of an even count; ``torch.median`` returns the lower
    one), and sums its gradient-matching term once per sample of the batch,
    as the reference's batch-wide Sobel kernels do;
  * ``feat_match_loss`` and ``vgg_loss`` detach the real side.

Each takes row-sharded maps (``parallel/spatial.Rows``) as it takes
tensors, with the same value and gradient as over the whole map: means
over the global pixel count, the terms that read across rows (``tv_loss``,
``sigm_loss``'s Sobel windows) with a halo from the next shard, the
medians, maxima and variance means over every shard.

Inside a data-parallel step (``distributed.sharded_batch()`` over several
ranks, each holding its rows of the global batch) every function returns
this rank's **share** of the loss of the global batch, so that the ranks'
shares sum to it and the sum of their gradients is its gradient: a mean
over this rank's rows divided by the ranks' count (``_share``); the batch
size where a loss counts it (``tv_loss``, ``sigm_loss``), the medians and
scales of ``sigm_loss``, the largest difference of ``dada_depth_loss`` and
the means of ``simse_loss`` and ``minent_loss``'s variance those of the
global batch. Outside it, or on one rank, each computes as before, with
no collective.

The discriminator outputs these functions read are those of
``models/discriminator.py``: a tensor, or a list per scale of the list of
a PatchGAN's layer outputs.
"""
from __future__ import annotations

import math
from typing import Callable, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.ops.interpolate import resize
from climategan_torch.parallel import distributed, spatial
from climategan_torch.parallel.spatial import Rows, each

# --------------------------------------------------------------------------
# reductions over the batch of a data-parallel step and over row shards
# --------------------------------------------------------------------------


def _share(mean: torch.Tensor) -> torch.Tensor:
    """A mean over this rank's rows as its share of the global batch's
    mean (equal shards)."""
    w = distributed.batch_world()
    return mean if w == 1 else mean / w


def _sum(x) -> torch.Tensor:
    """The sum of all values of a tensor, or of a row-sharded map (on its
    first shard's device, with its gradient to every shard)."""
    if isinstance(x, Rows):
        return spatial.total([p.sum() for p in x.parts], x.devices)
    return torch.sum(x)


def _numel(x) -> int:
    if isinstance(x, Rows):
        return sum(p.numel() for p in x.parts)
    return x.numel()


def _mean(x) -> torch.Tensor:
    """The mean of all values of a tensor or a row-sharded map."""
    if isinstance(x, Rows):
        return _sum(x) / _numel(x)
    return torch.mean(x)


def _shape(x):
    """(N, C, H, W) of a tensor or of the whole of a row-sharded map."""
    if isinstance(x, Rows):
        n, c, _, w = x.parts[0].shape
        return n, c, x.h, w
    return tuple(x.shape)


def _whole(x) -> torch.Tensor:
    """A row-sharded map gathered on its first shard's device, with its
    gradient to every shard; a tensor as it is."""
    return x.gather(x.devices[0]) if isinstance(x, Rows) else x


def _global_mean(x) -> torch.Tensor:
    """The mean of ``x`` over the global batch (and all rows), on every
    rank, with its gradient."""
    w = distributed.batch_world()
    if w == 1:
        return _mean(x)
    return distributed.all_reduce_sum_grad(_sum(x)) / (_numel(x) * w)

# --------------------------------------------------------------------------
# elementary criteria
# --------------------------------------------------------------------------


def mse_loss(pred, target) -> torch.Tensor:
    return _share(_mean(each(lambda p, t: (p - t) ** 2, pred, target)))


def l1_loss(pred, target) -> torch.Tensor:
    return _share(_mean(each(lambda p, t: torch.abs(p - t), pred, target)))


def bce_with_logits(logits, target) -> torch.Tensor:
    """BCEWithLogitsLoss, mean reduction, in the stable form."""
    loss = each(lambda x, t: (torch.clamp_min(x, 0) - x * t
                              + torch.log1p(torch.exp(-torch.abs(x)))),
                logits, target)
    return _share(_mean(loss))


def cross_entropy(logits, target) -> torch.Tensor:
    """CrossEntropyLoss over NCHW logits and NHW integer targets."""
    picked = each(lambda x, t: torch.gather(F.log_softmax(x, dim=1), 1,
                                            t[:, None].long()),
                  logits, target)
    return -_share(_mean(picked))


def _full_like(p, value: float):
    return each(lambda t: torch.full_like(t, value), p)


def upcast(p):
    """A tensor or a row-sharded map in f32, or kept in float64: the
    losses' compute dtype."""
    return each(lambda t: t.to(torch.promote_types(t.dtype, torch.float32)),
                p)


# --------------------------------------------------------------------------
# GAN losses
# --------------------------------------------------------------------------


def final_preds(pred) -> list:
    """The last layer's output of each scale of a discriminator result."""
    if isinstance(pred, (list, tuple)):
        return [p[-1] if isinstance(p, (list, tuple)) else p for p in pred]
    return [pred]


def gan_loss(pred, target_is_real: bool, soft: float = 0.0,
             flip: bool = False, use_lsgan: bool = False,
             real_label: float = 1.0, fake_label: float = 0.0
             ) -> torch.Tensor:
    """LSGAN (MSE) or vanilla (BCE-with-logits) GAN loss, averaged over the
    scales, with one-sided label smoothing by ``soft`` and, when ``flip``,
    the labels swapped: a real target becomes ``fake_label + soft``, a fake
    one ``real_label - soft``."""
    preds = final_preds(pred)
    real, fake = real_label - soft, fake_label + soft
    if flip:
        real, fake = fake, real
    t = real if target_is_real else fake
    total = 0.0
    for p in preds:
        pf = upcast(p)
        tgt = _full_like(pf, float(t))
        total = total + (mse_loss(pf, tgt) if use_lsgan
                         else bce_with_logits(pf, tgt))
    return total / len(preds)


def hinge_loss(pred, target_is_real: bool,
               for_discriminator: bool = True) -> torch.Tensor:
    """SPADE's hinge loss, averaged over the scales."""
    total = 0.0
    for p in final_preds(pred):
        p = upcast(p)
        if for_discriminator:
            sign = 1.0 if target_is_real else -1.0
            total = total - _share(_mean(each(
                lambda t: torch.clamp_max(sign * t - 1.0, 0.0), p)))
        else:
            if not target_is_real:
                raise ValueError("the generator's hinge loss aims for real")
            total = total - _share(_mean(p))
    return total / len(final_preds(pred))


def feat_match_loss(pred_real, pred_fake) -> torch.Tensor:
    """pix2pixHD feature matching: L1 over every intermediate output of
    every scale, the real side detached, divided by the number of
    scales."""
    num_d = len(pred_fake)
    total = 0.0
    for i in range(num_d):
        for j in range(len(pred_fake[i]) - 1):
            real = upcast(each(torch.Tensor.detach, pred_real[i][j]))
            total = total + l1_loss(upcast(pred_fake[i][j]), real) / num_d
    return total


# --------------------------------------------------------------------------
# task losses
# --------------------------------------------------------------------------


def _row_diffs_sum(x: Rows) -> torch.Tensor:
    """The sum of the squared differences of adjacent rows of a
    row-sharded map: each shard takes its rows' differences with the next
    row, its neighbour's first across the boundary (a 1-row halo)."""
    parts = []
    for i, dev in enumerate(x.devices):
        lo, hi = x.bounds(i)
        if hi - lo and lo < x.h - 1:
            win = x.fetch(lo, min(hi + 1, x.h), dev)
            parts.append(torch.sum((win[:, :, 1:] - win[:, :, :-1]) ** 2))
    return spatial.total(parts, x.devices)


def tv_loss(x) -> torch.Tensor:
    """Total variation of NCHW ``x`` (a tensor or a row-sharded map),
    divided by the (global) batch size."""
    n, c, h, w = _shape(x)
    n = n * distributed.batch_world()
    count_h = (h - 1) * w * c
    count_w = h * (w - 1) * c
    if isinstance(x, Rows):
        h_tv = _row_diffs_sum(x)
    else:
        h_tv = torch.sum((x[:, :, 1:, :] - x[:, :, :-1, :]) ** 2)
    w_tv = _sum(each(lambda t: (t[:, :, :, 1:] - t[:, :, :, :-1]) ** 2, x))
    return 2.0 * (h_tv / count_h + w_tv / count_w) / n


def entropy_map(prob):
    """Weighted self-information of NCHW probabilities."""
    c = _shape(prob)[1]
    return each(lambda p: -p * torch.log2(p + 1e-30) / math.log2(c), prob)


def minent_loss(prob, version: int = 1,
                lambda_var: float = 0.1) -> torch.Tensor:
    """Entropy minimization over NCHW probabilities; version 2 adds the
    entropy map's variance (about the mean over the whole global batch)."""
    n, c, h, w = _shape(prob)
    n = n * distributed.batch_world()
    ent = entropy_map(prob)
    if version == 1:
        return _sum(ent) / (n * h * w)
    mean = distributed.all_reduce_sum_grad(_sum(ent)) / (n * h * w)
    def term(e):
        demean = e - mean.to(e.device)
        return e + lambda_var * demean * demean

    return _sum(each(term, ent)) / (n * h * w)


def simse_loss(pred, target) -> torch.Tensor:
    d = each(torch.sub, pred, target)
    return _share(_mean(each(lambda t: t * t, d))) \
        - _share(_global_mean(d) ** 2)


_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def _sobel(x: torch.Tensor, k) -> torch.Tensor:
    """Valid 3x3 cross-correlation of (N, 1, H, W) ``x`` with ``k``."""
    kern = torch.tensor(k, dtype=x.dtype, device=x.device)[None, None]
    return F.conv2d(x, kern)


def _sobel_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(_sobel(x, _SOBEL_X))
                     + torch.abs(_sobel(x, _SOBEL_Y)))


def _sobel_sum_rows(x: Rows) -> torch.Tensor:
    """``_sobel_sum`` of the whole row-sharded map: each shard takes the
    valid outputs whose window starts on its rows, on its rows and the
    next shards' first two (a 2-row halo)."""
    parts = []
    for i, dev in enumerate(x.devices):
        lo, hi = x.bounds(i)
        top = min(hi, x.h - 2)  # the last valid output row + 1
        if top > lo:
            with spatial.whole_map(x.h, x.w):
                parts.append(_sobel_sum(x.fetch(lo, top + 2, dev)))
    return spatial.total(parts, x.devices)


def median(x: torch.Tensor) -> torch.Tensor:
    """The median of all values, as numpy and JAX take it: the mean of the
    two middle values when the count is even."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def sigm_loss(pred, target, gmweight: float = 0.5,
              scale: int = 4) -> torch.Tensor:
    """MiDaS scale-invariant loss plus the Sobel gradient-matching term over
    ``scale`` nearest-downsampled maps; pred and target (N, 1, H, W)
    tensors or row-sharded maps (the medians of the whole maps, gathered;
    the downsampled maps an exact row gather; the Sobel windows across the
    shards' boundaries)."""
    t_pred = median(distributed.gather_batch(_whole(pred)))
    t_targ = median(distributed.gather_batch(_whole(target)))

    def dev(v, t):
        return v.to(t.device)

    s_pred = _global_mean(each(lambda p: torch.abs(p - dev(t_pred, p)), pred))
    s_targ = _global_mean(each(lambda t: torch.abs(t - dev(t_targ, t)),
                               target))
    r = each(lambda p, t: ((p - dev(t_pred, p)) / dev(s_pred, p)
                           - (t - dev(t_targ, t)) / dev(s_targ, t)),
             pred, target)

    n, _, h0, w0 = _shape(pred)
    num_pix = h0 * w0
    gm = 0.0
    rk = r
    for k in range(scale):
        h, w = h0, w0
        if k > 0:
            # F.interpolate(scale_factor=1/2**k) from the base map
            h, w = int(h0 * (1 / 2 ** k)), int(w0 * (1 / 2 ** k))
            rk = (spatial.resize(r, (h, w), "nearest")
                  if isinstance(r, Rows) else resize(r, (h, w), "nearest"))
        if min(h, w) < 3:
            continue  # a valid 3x3 conv of a smaller map is empty: sums to 0
        gm = gm + (_sobel_sum_rows(rk) if isinstance(rk, Rows)
                   else _sobel_sum(rk))
    # the reference's Sobel kernels have batch_size identical output
    # channels, so the gradient term counts batch_size times (the global
    # batch's: the sums above are this rank's share)
    gm = gm * (n * distributed.batch_world())
    return (0.5 / num_pix * _sum(each(torch.abs, r))
            + gmweight / num_pix * gm)


def _max(x) -> torch.Tensor:
    """The largest value of a tensor or a row-sharded map (its gradient to
    the shard that holds it)."""
    if isinstance(x, Rows):
        return spatial.all_reduce([p.max() if p.numel() else None
                                   for p in x.parts], "max",
                                  x.devices[:1])[0]
    return torch.max(x)


def dada_depth_loss(pred, label) -> torch.Tensor:
    """berHu (reverse Huber) loss; the threshold is 0.2 of the global
    batch's largest difference (its gradient reaches the rank and the
    shard that hold it)."""
    adiff = each(lambda p, t: torch.abs(p - t), pred, label)
    largest = _max(adiff)
    if distributed.batch_world() > 1:
        largest = torch.max(distributed.gather_batch(largest.reshape(1)))
    batch_max = 0.2 * largest

    def t1(a):
        return torch.where(a <= batch_max.to(a.device), a,
                           torch.zeros_like(a))

    def t2(a):
        bm = batch_max.to(a.device)
        return torch.where(a > bm, (a * a + bm * bm) / (2.0 * bm + 1e-12),
                           torch.zeros_like(a))

    return (_sum(each(t1, adiff)) + _sum(each(t2, adiff))) / (
        _numel(pred) * distributed.batch_world())


def context_loss(input, target, mask) -> torch.Tensor:
    """L1 outside the mask."""
    return _share(_mean(each(lambda i, t, m: torch.abs((i - t) * (1.0 - m)),
                             input, target, mask)))


def reconstruction_loss(input, target, mask) -> torch.Tensor:
    """L1 inside the mask."""
    return _share(_mean(each(lambda i, t, m: torch.abs((i - t) * m),
                             input, target, mask)))


def ground_intersection_loss(pred, pseudo_ground) -> torch.Tensor:
    """The share of ground pixels missing from the flood mask (no
    gradient: a comparison)."""
    return _share(_mean(each(lambda p, g: ((g - p) > 0.5).to(p.dtype), pred,
                             pseudo_ground)))


# --------------------------------------------------------------------------
# ADVENT adversarial loss
# --------------------------------------------------------------------------


def custom_bce(prediction, target: float) -> torch.Tensor:
    """BCE-with-logits against a constant domain label."""
    return bce_with_logits(prediction, _full_like(prediction, target))


def wgan_domain_loss(x, y: float) -> torch.Tensor:
    """-mean(y x + (1 - y)(1 - x))."""
    return -_share(_mean(each(lambda t: y * t + (1.0 - y) * (1.0 - t), x)))


def advent_loss(prob, target: float, disc_fn: Callable,
                gan_type: str = "WGAN_norm",
                depth_preds=None) -> torch.Tensor:
    """ADVENT: the entropy map (times the depth under DADA) through the
    domain discriminator ``disc_fn``, then the domain loss; on tensors or
    row-sharded maps."""
    d_in = entropy_map(prob)
    if depth_preds is not None:
        d_in = each(torch.mul, d_in, depth_preds)
    d_out = disc_fn(d_in)
    if gan_type == "GAN":
        return custom_bce(d_out, target)
    return wgan_domain_loss(d_out, target)


def wgan_gp(disc_fn: Callable, x) -> torch.Tensor:
    """WGAN gradient penalty: the gradient of ``sum(disc_fn(x))`` with
    respect to ``x``, then the mean over samples of ``(||g||_2 - 1)^2``
    (the norm as ``sqrt(sum g^2 + 1e-12)``). ``x`` enters detached; the
    gradient keeps its graph, so the penalty is differentiable in the
    discriminator's parameters (reference tutils.py:487-501). On a
    row-sharded ``x`` the gradient is taken with respect to every shard,
    and each sample's sum of squares over all of them."""
    if isinstance(x, Rows):
        parts = [p.detach().requires_grad_(True) for p in x.parts]
        grads = torch.autograd.grad(_sum(disc_fn(Rows(parts))), parts,
                                    create_graph=True, allow_unused=True)
        n = parts[0].shape[0]
        squares = spatial.total([torch.sum(g.reshape(n, -1) ** 2, dim=1)
                                 for g in grads if g is not None], x.devices)
    else:
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
        squares = torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1)
    norms = torch.sqrt(squares + 1e-12)
    return _share(torch.mean((norms - 1.0) ** 2))


# --------------------------------------------------------------------------
# VGG19 perceptual loss
# --------------------------------------------------------------------------

_VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512)
# torchvision vgg19.features indices after which the reference's five
# slices end (relu1_1, relu2_1, relu3_1, relu4_1, relu5_1)
_VGG_SLICE_ENDS = (1, 6, 11, 20, 29)
_VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


class VGG19Features(nn.Module):
    """torchvision's ``vgg19().features`` up to relu5_1, under its keys
    (``features.{i}.weight``), so a torchvision state dict loads with
    ``strict=False``; returns the five relu slices pix2pixHD reads."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in _VGG19_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x) -> list:
        if isinstance(x, Rows):
            return self.forward_rows(x)
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _VGG_SLICE_ENDS:
                outs.append(x)
        return outs

    def forward_rows(self, x: Rows) -> List[Rows]:
        """``forward`` on a row-sharded map: the 3x3 convs read a one-row
        halo, a 2x2 pool of a shard with an odd row count its neighbour's
        row; each shard reads the weights on its device."""
        outs = []
        for i, layer in enumerate(self.features):
            if isinstance(layer, nn.Conv2d):
                x = spatial.conv2d(x, layer)
            elif isinstance(layer, nn.MaxPool2d):
                x = spatial.max_pool2d(x, 2, 2, 0)
            else:
                x = x.map(layer)
            if i in _VGG_SLICE_ENDS:
                outs.append(x)
        return outs


def _vgg_preprocess(batch: torch.Tensor) -> torch.Tensor:
    bgr = (batch.flip(1) + 1.0) * 255.0 * 0.5
    mean = torch.tensor([103.939, 116.779, 123.680], dtype=bgr.dtype,
                        device=bgr.device)
    return bgr - mean[None, :, None, None]


def vgg_preprocess(batch):
    """[-1, 1] RGB (NCHW, a tensor or a row-sharded map) -> caffe-style
    BGR in [0, 255] minus the ImageNet mean."""
    return each(_vgg_preprocess, batch)


def vgg_loss(vgg: VGG19Features, x, y) -> torch.Tensor:
    """pix2pixHD perceptual loss: weighted L1 over the five slices, y's
    side detached (in f32, float64 kept; tensors or row-sharded maps)."""
    total = 0.0
    for w, a, b in zip(_VGG_WEIGHTS, vgg(x), vgg(y)):
        total = total + w * l1_loss(upcast(a), upcast(_detach(b)))
    return total


def _detach(x):
    return each(torch.Tensor.detach, x)
