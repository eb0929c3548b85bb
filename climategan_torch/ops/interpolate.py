"""Resizes with PyTorch's own interpolation rules (NCHW).

The JAX package re-implements ``F.interpolate``'s exact semantics as
matmuls; here ``F.interpolate`` is the definition itself. Non-nearest
modes compute in float32 and cast back, as the JAX resize does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize(x: torch.Tensor, size, mode: str = "bilinear",
           align_corners: bool = False) -> torch.Tensor:
    """Resize NCHW ``x`` to spatial ``size=(H, W)``.

    Modes: "nearest" (torch's floor rule, not "nearest-exact"), "bilinear"
    (``align_corners`` True or False) and "bicubic" (a=-0.75).
    """
    h, w = int(size[0]), int(size[1])
    if tuple(x.shape[-2:]) == (h, w):
        return x
    if mode == "nearest":
        return F.interpolate(x, size=(h, w), mode="nearest")
    if mode not in ("bilinear", "bicubic"):
        raise ValueError(f"Unsupported interpolation mode: {mode}")
    # at least f32 (float64 stays float64)
    y = F.interpolate(x.to(torch.promote_types(x.dtype, torch.float32)),
                      size=(h, w), mode=mode,
                      align_corners=align_corners)
    return y.to(x.dtype)


def resize_like(x, ref, mode: str = "bilinear",
                align_corners: bool = False):
    """``resize`` of ``x`` to ``ref``'s height and width. Either may be a
    row-sharded ``parallel.spatial.Rows``: a sharded ``x`` goes through
    ``spatial.resize`` (the result split as ``x``), a sharded ``ref`` gives
    its whole map's height and width."""
    from climategan_torch.parallel import spatial  # it imports this module

    size = ((ref.h, ref.w) if isinstance(ref, spatial.Rows)
            else tuple(ref.shape[-2:]))
    if isinstance(x, spatial.Rows):
        return spatial.resize(x, size, mode, align_corners)
    return resize(x, size, mode, align_corners)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Integer-factor nearest upsample of NCHW ``x``."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)
