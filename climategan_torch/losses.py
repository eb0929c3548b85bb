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

The discriminator outputs these functions read are those of
``models/discriminator.py``: a tensor, or a list per scale of the list of
a PatchGAN's layer outputs.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.ops.interpolate import resize

# --------------------------------------------------------------------------
# elementary criteria
# --------------------------------------------------------------------------


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def bce_with_logits(logits: torch.Tensor, target) -> torch.Tensor:
    """BCEWithLogitsLoss, mean reduction, in the stable form."""
    loss = (torch.clamp_min(logits, 0) - logits * target
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.mean(loss)


def cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """CrossEntropyLoss over NCHW logits and NHW integer targets."""
    logp = F.log_softmax(logits, dim=1)
    picked = torch.gather(logp, 1, target[:, None].long())
    return -torch.mean(picked)


# --------------------------------------------------------------------------
# GAN losses
# --------------------------------------------------------------------------


def final_preds(pred) -> List[torch.Tensor]:
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
        pf = p.float()
        tgt = torch.full_like(pf, float(t))
        total = total + (mse_loss(pf, tgt) if use_lsgan
                         else bce_with_logits(pf, tgt))
    return total / len(preds)


def hinge_loss(pred, target_is_real: bool,
               for_discriminator: bool = True) -> torch.Tensor:
    """SPADE's hinge loss, averaged over the scales."""
    total = 0.0
    for p in final_preds(pred):
        p = p.float()
        if for_discriminator:
            if target_is_real:
                total = total - torch.mean(torch.clamp_max(p - 1.0, 0.0))
            else:
                total = total - torch.mean(torch.clamp_max(-p - 1.0, 0.0))
        else:
            if not target_is_real:
                raise ValueError("the generator's hinge loss aims for real")
            total = total - torch.mean(p)
    return total / len(final_preds(pred))


def feat_match_loss(pred_real, pred_fake) -> torch.Tensor:
    """pix2pixHD feature matching: L1 over every intermediate output of
    every scale, the real side detached, divided by the number of
    scales."""
    num_d = len(pred_fake)
    total = 0.0
    for i in range(num_d):
        for j in range(len(pred_fake[i]) - 1):
            real = pred_real[i][j].detach().float()
            total = total + l1_loss(pred_fake[i][j].float(), real) / num_d
    return total


# --------------------------------------------------------------------------
# task losses
# --------------------------------------------------------------------------


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Total variation of NCHW ``x``."""
    n, c, h, w = x.shape
    count_h = (h - 1) * w * c
    count_w = h * (w - 1) * c
    h_tv = torch.sum((x[:, :, 1:, :] - x[:, :, :-1, :]) ** 2)
    w_tv = torch.sum((x[:, :, :, 1:] - x[:, :, :, :-1]) ** 2)
    return 2.0 * (h_tv / count_h + w_tv / count_w) / n


def entropy_map(prob: torch.Tensor) -> torch.Tensor:
    """Weighted self-information of NCHW probabilities."""
    c = prob.shape[1]
    return -prob * torch.log2(prob + 1e-30) / math.log2(c)


def minent_loss(prob: torch.Tensor, version: int = 1,
                lambda_var: float = 0.1) -> torch.Tensor:
    """Entropy minimization over NCHW probabilities; version 2 adds the
    entropy map's variance."""
    n, c, h, w = prob.shape
    ent = entropy_map(prob)
    if version == 1:
        return torch.sum(ent) / (n * h * w)
    demean = ent - torch.sum(ent) / (n * h * w)
    return torch.sum(ent + lambda_var * demean * demean) / (n * h * w)


def simse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred - target
    return torch.mean(d * d) - torch.mean(d) ** 2


_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def _sobel(x: torch.Tensor, k) -> torch.Tensor:
    """Valid 3x3 cross-correlation of (N, 1, H, W) ``x`` with ``k``."""
    kern = torch.tensor(k, dtype=x.dtype, device=x.device)[None, None]
    return F.conv2d(x, kern)


def median(x: torch.Tensor) -> torch.Tensor:
    """The median of all values, as numpy and JAX take it: the mean of the
    two middle values when the count is even."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def sigm_loss(pred: torch.Tensor, target: torch.Tensor, gmweight: float = 0.5,
              scale: int = 4) -> torch.Tensor:
    """MiDaS scale-invariant loss plus the Sobel gradient-matching term over
    ``scale`` nearest-downsampled maps; pred and target (N, 1, H, W)."""
    t_pred = median(pred)
    t_targ = median(target)
    s_pred = torch.mean(torch.abs(pred - t_pred))
    s_targ = torch.mean(torch.abs(target - t_targ))
    r = (pred - t_pred) / s_pred - (target - t_targ) / s_targ

    num_pix = pred.shape[2] * pred.shape[3]
    gm = 0.0
    rk = r
    for k in range(scale):
        if k > 0:
            # F.interpolate(scale_factor=1/2**k) from the base map
            h = int(r.shape[2] * (1 / 2 ** k))
            w = int(r.shape[3] * (1 / 2 ** k))
            rk = resize(r, (h, w), "nearest")
        if min(rk.shape[2:]) < 3:
            continue  # a valid 3x3 conv of a smaller map is empty: sums to 0
        gm = gm + torch.sum(torch.abs(_sobel(rk, _SOBEL_X))
                            + torch.abs(_sobel(rk, _SOBEL_Y)))
    # the reference's Sobel kernels have batch_size identical output
    # channels, so the gradient term counts batch_size times
    gm = gm * pred.shape[0]
    return 0.5 / num_pix * torch.sum(torch.abs(r)) + gmweight / num_pix * gm


def dada_depth_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """berHu (reverse Huber) loss."""
    adiff = torch.abs(pred - label)
    batch_max = 0.2 * torch.max(adiff)
    t1 = torch.where(adiff <= batch_max, adiff, torch.zeros_like(adiff))
    t2 = torch.where(
        adiff > batch_max,
        (adiff * adiff + batch_max * batch_max) / (2.0 * batch_max + 1e-12),
        torch.zeros_like(adiff))
    return (torch.sum(t1) + torch.sum(t2)) / pred.numel()


def context_loss(input: torch.Tensor, target: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """L1 outside the mask."""
    return torch.mean(torch.abs((input - target) * (1.0 - mask)))


def reconstruction_loss(input: torch.Tensor, target: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """L1 inside the mask."""
    return torch.mean(torch.abs((input - target) * mask))


def ground_intersection_loss(pred: torch.Tensor,
                             pseudo_ground: torch.Tensor) -> torch.Tensor:
    """The share of ground pixels missing from the flood mask (no
    gradient: a comparison)."""
    return torch.mean(((pseudo_ground - pred) > 0.5).float())


# --------------------------------------------------------------------------
# ADVENT adversarial loss
# --------------------------------------------------------------------------


def custom_bce(prediction: torch.Tensor, target: float) -> torch.Tensor:
    """BCE-with-logits against a constant domain label."""
    return bce_with_logits(prediction, torch.full_like(prediction, target))


def wgan_domain_loss(x: torch.Tensor, y: float) -> torch.Tensor:
    """-mean(y x + (1 - y)(1 - x))."""
    return -torch.mean(y * x + (1.0 - y) * (1.0 - x))


def advent_loss(prob: torch.Tensor, target: float,
                disc_fn: Callable[[torch.Tensor], torch.Tensor],
                gan_type: str = "WGAN_norm",
                depth_preds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ADVENT: the entropy map (times the depth under DADA) through the
    domain discriminator ``disc_fn``, then the domain loss."""
    d_in = entropy_map(prob)
    if depth_preds is not None:
        d_in = d_in * depth_preds
    d_out = disc_fn(d_in)
    if gan_type == "GAN":
        return custom_bce(d_out, target)
    return wgan_domain_loss(d_out, target)


def wgan_gp(disc_fn: Callable[[torch.Tensor], torch.Tensor],
            x: torch.Tensor) -> torch.Tensor:
    """WGAN gradient penalty: the gradient of ``sum(disc_fn(x))`` with
    respect to ``x``, then the mean over samples of ``(||g||_2 - 1)^2``
    (the norm as ``sqrt(sum g^2 + 1e-12)``). ``x`` enters detached; the
    gradient keeps its graph, so the penalty is differentiable in the
    discriminator's parameters (reference tutils.py:487-501)."""
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
    norms = torch.sqrt(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1)
                       + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


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

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _VGG_SLICE_ENDS:
                outs.append(x)
        return outs


def vgg_preprocess(batch: torch.Tensor) -> torch.Tensor:
    """[-1, 1] RGB (NCHW) -> caffe-style BGR in [0, 255] minus the
    ImageNet mean."""
    bgr = (batch.flip(1) + 1.0) * 255.0 * 0.5
    mean = torch.tensor([103.939, 116.779, 123.680], dtype=bgr.dtype,
                        device=bgr.device)
    return bgr - mean[None, :, None, None]


def vgg_loss(vgg: VGG19Features, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """pix2pixHD perceptual loss: weighted L1 over the five slices, y's
    side detached."""
    total = 0.0
    for w, a, b in zip(_VGG_WEIGHTS, vgg(x), vgg(y)):
        total = total + w * l1_loss(a.float(), b.detach().float())
    return total
