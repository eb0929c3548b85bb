"""``fire_paste``: the red-orange filter pasted through the wildfire's
blurred sky mask, then the last brightness.

Replaces the Pallas TPU kernel ``climategan_tpu/ops/pallas/events.py:
fire_paste``. The kernel is CUDA C++ for sm_90a in ``csrc/events.cu``,
bound through ``ctypes``. Its bound on an H100 is bytes: seven float32
planes (x's three, the sky plane, the output's three) against about twenty
operations per pixel. One thread per pixel reads its sky value once and
writes the pixel's three channels, in a grid-stride loop; the filter's
green value is read from the device once per thread.

``m = transparency/255 * sky``; per channel ``v = m * f_c + (1 - m) * x_c``
with ``f = (255, g, 0)``; ``floor(clip(v))``, then
``floor(clip(brightness * v))``. Every rounding is explicit, so a blend
never crosses a floor step by a fused multiply-add.

Layout: x255 (N, 3, H, W) float32 in [0, 255]; sky (N, 1, H, W) float32 in
[0, 1]; g_value a one-value float32 tensor on x's device. Returns
(N, 3, H, W).
"""
from __future__ import annotations

import torch

from climategan_torch.kernels import _events
from climategan_torch.kernels.fire_color_grade import quantize_u8


def paste_tensor(source: torch.Tensor, filter_: torch.Tensor,
                 mask: torch.Tensor, transparency: float) -> torch.Tensor:
    """``m * filter + (1 - m) * source`` with m = transparency/255 * mask
    (reference fire.py:130-133)."""
    m = (transparency / 255.0) * mask
    return m * filter_ + (1.0 - m) * source


def fire_paste_plain(x255: torch.Tensor, sky: torch.Tensor,
                     g_value: torch.Tensor, transparency: float = 200.0,
                     brightness: float = 0.8) -> torch.Tensor:
    """The same function in plain PyTorch, float32."""
    g = g_value.reshape(())
    filt = torch.stack([torch.full_like(g, 255.0), g, torch.zeros_like(g)])
    v = quantize_u8(paste_tensor(x255, filt.view(1, 3, 1, 1), sky, transparency))
    return quantize_u8(brightness * v)


def fire_paste(x255: torch.Tensor, sky: torch.Tensor, g_value: torch.Tensor,
               transparency: float = 200.0,
               brightness: float = 0.8) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel,
    and anything it does not take raises."""
    _events.check("fire_paste", x255, sky, g_value)
    if x255.device.type == "cpu":
        return fire_paste_plain(x255, sky, g_value, transparency, brightness)
    out = torch.empty_like(x255)
    N, _, H, W = x255.shape
    _events.launch("fire_paste", x255, x255.data_ptr(), sky.data_ptr(),
                   g_value.data_ptr(), out.data_ptr(), N * H * W, H * W,
                   transparency / 255.0, brightness)
    return out
