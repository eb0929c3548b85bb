"""Smog event: the HazeRD distance-scaled haze filter (NCHW), from
``climategan_tpu/events/smog.py``.

transmission = exp(-(beta/vr) * d_norm); smog = t * linearRGB(x) +
(1 - t) * airlight; back to sRGB; yellow tint at alpha/255. The depth chain
(normalize to [0.3, 1], reciprocal, normalize to [0.1, 1]) and the bilinear
resize stay in plain PyTorch; the elementwise tail is the ``smog_tail``
kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch

from climategan_torch.kernels.smog_tail import smog_tail
from climategan_torch.ops.image import normalize
from climategan_torch.ops.interpolate import resize


def add_smog(x: torch.Tensor, d: torch.Tensor, airlight: float = 0.76,
             beta: float = 2.0, vr: float = 1.0,
             yellow_color: Sequence[float] = (224, 192, 29),
             alpha: float = 20.0) -> torch.Tensor:
    """x: (N, 3, H, W) image; d: (N, 1, h, w) raw depth prediction; both
    float32. Returns the smogged sRGB image in [0, 1], (N, 3, H, W)."""
    x01 = normalize(x)
    dd = normalize(d, 0.3, 1.0)
    dd = normalize(1.0 / dd, 0.1, 1.0)
    dd = resize(dd, x.shape[-2:], mode="bilinear", align_corners=True)
    return smog_tail(x01.contiguous(), dd.contiguous(), airlight, beta / vr,
                     tuple(yellow_color), alpha)
