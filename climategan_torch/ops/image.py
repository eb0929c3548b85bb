"""Elementwise image helpers (NCHW or NHWC: both reduce over all
non-batch dims)."""
from __future__ import annotations

import torch


def normalize(t: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max rescale to [0, 1] over all non-batch dims: the min
    is subtracted first, then the shifted max divides."""
    n = t.shape[0]
    view = (n,) + (1,) * (t.ndim - 1)
    t = t - t.reshape(n, -1).amin(dim=1).reshape(view)
    return t / t.reshape(n, -1).amax(dim=1).reshape(view)


def unit_range_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max normalize, then scale to 255 and truncate."""
    return (normalize(x) * 255.0).to(torch.uint8)
