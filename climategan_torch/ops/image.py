"""Elementwise image helpers (NCHW or NHWC: ``normalize`` reduces over all
non-batch dims), from ``climategan_tpu/ops/image.py``."""
from __future__ import annotations

import torch


def normalize(t: torch.Tensor, mini: float = 0.0,
              maxi: float = 1.0) -> torch.Tensor:
    """Per-sample min-max rescale to [mini, maxi] over all non-batch dims:
    the min is subtracted first, then the shifted max divides, then
    ``mini + (maxi - mini) * t``."""
    n = t.shape[0]
    view = (n,) + (1,) * (t.ndim - 1)
    t = t - t.reshape(n, -1).amin(dim=1).reshape(view)
    t = t / t.reshape(n, -1).amax(dim=1).reshape(view)
    return mini + (maxi - mini) * t


def srgb_decode(x: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear RGB of values already in [0, 1]."""
    lin = ((x + 0.055) / 1.055) ** 2.4
    return torch.where(x <= 0.04045, x / 12.92, lin)


def srgb2lrgb(x: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear RGB; the input is min-max normalized to [0, 1] first,
    as the reference does."""
    return srgb_decode(normalize(x))


def lrgb2srgb(x: torch.Tensor) -> torch.Tensor:
    """Linear RGB -> sRGB; the power's base is held at 1e-12 or above."""
    low = 12.92 * x
    high = 1.055 * torch.clamp(x, min=1e-12) ** (1.0 / 2.4) - 0.055
    return torch.where(x <= 0.0031308, low, high)


def retrieve_sky_mask(seg: torch.Tensor, sky_idx: int = 9) -> torch.Tensor:
    """Boolean sky mask from NCHW segmentation logits (N, C, H, W), as
    (N, 1, H, W), or from labels of any shape. The argmax takes the first
    maximal class on a tie, as ``jnp.argmax`` does."""
    if seg.ndim == 4:
        seg = torch.argmax(seg, dim=1, keepdim=True)
    return seg == sky_idx


def unit_range_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max normalize, then scale to 255 and truncate."""
    return (normalize(x) * 255.0).to(torch.uint8)
