"""``smog_tail``: the elementwise tail of the smog event.

Replaces the Pallas TPU kernel ``climategan_tpu/ops/pallas/events.py:
smog_tail``. The kernel is CUDA C++ for sm_90a in ``csrc/events.cu``, bound
through ``ctypes``. Its bound on an H100 is bytes: seven float32 planes
(x's three, the depth plane, the output's three) against about seventy
operations per pixel, 13 of them transcendental. A thread takes 4
consecutive pixels per turn: it issues the depth's and the three channels'
16-byte loads before any math, computes the transmission
``t = exp(-beta * d)`` once per pixel and stores 16 bytes per channel; the
grid fills the card once (SMs x resident blocks) and strides over the
planes. The powers are ``2^(k * log2 b)`` on the hardware's base-2 exp and
log; up to the last branch the rounding follows the plain version, so a
value at the curve's 2.5e-5 step (0.0031308) lands on the same side. A
scalar path in the same kernel takes H*W not a multiple of 4 or a base off
a 16-byte boundary.

Per channel: sRGB -> linear, ``t * lin + (1 - t) * airlight``, linear ->
sRGB (base held at 1e-12 or above before the power), then the yellow tint
``v * (1 - alpha/255) + yellow/255 * alpha/255``.

Layout: x01 (N, 3, H, W) min-max normalized sRGB; d (N, 1, H, W) normalized
inverse depth at the image's size; both float32. Returns (N, 3, H, W).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from climategan_torch.kernels import _events
from climategan_torch.ops.image import lrgb2srgb, srgb_decode


def _constants(beta: float, yellow: Sequence[float],
               alpha: float) -> Tuple[float, float, Tuple[float, ...]]:
    """(-beta, 1 - a, yellow_c / 255 * a) with a = alpha / 255, in Python
    floats as the JAX kernel folds them, each rounded to float32 once."""
    a = alpha / 255.0
    return -beta, 1.0 - a, tuple(y / 255.0 * a for y in yellow)


def smog_tail_plain(x01: torch.Tensor, d: torch.Tensor, airlight: float,
                    beta: float, yellow: Sequence[float],
                    alpha: float) -> torch.Tensor:
    """The same function in plain PyTorch, float32."""
    neg_beta, keep, tint = _constants(beta, yellow, alpha)
    t = torch.exp(d * neg_beta)
    smogged = lrgb2srgb(t * srgb_decode(x01) + (1.0 - t) * airlight)
    tint = torch.tensor(tint, dtype=torch.float32, device=x01.device)
    return smogged * keep + tint.view(1, 3, 1, 1)


def smog_tail(x01: torch.Tensor, d: torch.Tensor, airlight: float,
              beta: float, yellow: Sequence[float],
              alpha: float) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel,
    and anything it does not take raises."""
    _events.check("smog_tail", x01, d)
    if len(yellow) != 3:
        raise ValueError(f"smog_tail needs three yellow values, got {yellow}")
    if x01.device.type == "cpu":
        return smog_tail_plain(x01, d, airlight, beta, yellow, alpha)
    neg_beta, keep, tint = _constants(beta, yellow, alpha)
    out = torch.empty_like(x01)
    N, _, H, W = x01.shape
    _events.launch("smog_tail", x01, x01.data_ptr(), d.data_ptr(),
                   out.data_ptr(), N * H * W, H * W, neg_beta, airlight,
                   keep, *tint)
    return out
