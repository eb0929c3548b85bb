"""``fire_color_grade``: contrast and brightness of the wildfire event.

Replaces the Pallas TPU kernel ``climategan_tpu/ops/pallas/events.py:
fire_color_grade``. The kernel is CUDA C++ for sm_90a in ``csrc/events.cu``,
bound through ``ctypes``. Its bound on an H100 is bytes: three float32
planes in and three out against nine operations per value. A thread
issues two 16-byte loads (4 values each, a wave of the grid apart) before
any math and stores 16 bytes at a time; the grid fills the card once (SMs
x resident blocks) and strides over the values; a scalar path takes a base
off a 16-byte boundary and the last n % 4 values. The batch's gray mean is
read from the device once per thread, with no host round trip. Every
rounding is explicit and in the JAX order, since the value is floored
twice.

``floor(clip(contrast * x + (1 - contrast) * mean, 0, 255))``, then
``floor(clip(brightness * v, 0, 255))``: torchvision's contrast and
brightness on uint8, truncating after each. ``mean`` is ONE value over the
whole batch (the caller's grayscale mean), not one per image.

Layout: x255 (N, 3, H, W) float32 in [0, 255]; gray_mean a one-value
float32 tensor on x's device. Returns (N, 3, H, W).
"""
from __future__ import annotations

import torch

from climategan_torch.kernels import _events


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """torch ``.to(torch.uint8)`` semantics on [0, 255], kept in float:
    clip, then truncate."""
    return torch.floor(torch.clamp(x, 0.0, 255.0))


def fire_color_grade_plain(x255: torch.Tensor, gray_mean: torch.Tensor,
                           contrast: float = 1.5,
                           brightness: float = 0.73) -> torch.Tensor:
    """The same function in plain PyTorch, float32."""
    v = quantize_u8(contrast * x255 + (1.0 - contrast) * gray_mean.reshape(()))
    return quantize_u8(brightness * v)


def fire_color_grade(x255: torch.Tensor, gray_mean: torch.Tensor,
                     contrast: float = 1.5,
                     brightness: float = 0.73) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel,
    and anything it does not take raises."""
    _events.check("fire_color_grade", x255, scalar=gray_mean)
    if x255.device.type == "cpu":
        return fire_color_grade_plain(x255, gray_mean, contrast, brightness)
    out = torch.empty_like(x255)
    _events.launch("fire_color_grade", x255, x255.data_ptr(),
                   gray_mean.data_ptr(), out.data_ptr(), x255.numel(),
                   contrast, 1.0 - contrast, brightness)
    return out
