"""Wildfire event compositing (NCHW), from ``climategan_tpu/events/fire.py``.

  1. min-max rescale to [0, 255], warm colour shift (+40 R, -10 G, -20 B),
     truncate;
  2. contrast x1.5 around the batch's grayscale mean, brightness x0.73
     (torchvision semantics on uint8): the ``fire_color_grade`` kernel;
  3. sky mask from the seg logits' argmax == 9, bottom third cropped,
     nearest resize to the image's size, box dilation by 18%;
  4. 281-tap reflect Gaussian blur (two matrix products, ops/blur.py);
  5. paste a red-orange filter (G in 100..150) at transparency 200/255,
     then brightness x0.8: the ``fire_paste`` kernel;
  6. two range-pinning pixels.
Output in [0, 255], float32.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from climategan_torch.kernels.fire_color_grade import fire_color_grade, quantize_u8
from climategan_torch.kernels.fire_paste import fire_paste
from climategan_torch.ops.blur import box_dilate, gaussian_blur
from climategan_torch.ops.image import normalize, retrieve_sky_mask
from climategan_torch.ops.interpolate import resize


@functools.lru_cache(maxsize=None)
def _warm_shift(device: torch.device) -> torch.Tensor:
    """(+40 R, -10 G, -20 B) as a (1, 3, 1, 1) float32 tensor, made once
    per device: a host-to-device copy on every call would wait for the
    card."""
    return torch.tensor([40.0, -10.0, -20.0], device=device).view(1, 3, 1, 1)


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """torchvision rgb_to_grayscale on uint8 values: weighted sum, then
    truncation; (N, 3, H, W) -> (N, H, W)."""
    return torch.floor(0.2989 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2])


def increase_sky_mask(mask: torch.Tensor, p_w: float, p_h: float) -> torch.Tensor:
    """Box-dilate a 0/1 NCHW mask by (p_h*H, p_w*W) in each direction: the
    reference's shift-accumulate loops OR the mask over offsets 1..n-1,
    which is a box of radius n - 1."""
    n_h = int(p_h * mask.shape[-2])
    n_w = int(p_w * mask.shape[-1])
    if n_h <= 0 and n_w <= 0:
        return mask
    return box_dilate(mask, max(n_h - 1, 0), max(n_w - 1, 0))


def add_fire(x: torch.Tensor, seg_preds: torch.Tensor,
             g_value: Optional[Union[float, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None,
             kernel_size: int = 281, kernel_sigma: float = 140.5,
             crop_bottom_sky_mask: bool = True,
             transparency: float = 200.0) -> torch.Tensor:
    """x: (N, 3, H, W) image, seg_preds: (N, C, h, w) logits; both float32.

    ``g_value`` is the filter's green value. The JAX package draws it from
    its own PRNG, whose bits PyTorch cannot reproduce, so a caller that must
    match it passes it in; without it, it is drawn in 100..150 from
    ``generator`` on x's device.
    """
    wf = normalize(x, 0.0, 255.0)
    wf = quantize_u8(wf + _warm_shift(wf.device)).contiguous()

    # one mean over the whole batch, a 0-d device tensor (no host sync)
    gray_mean = _grayscale(wf).mean()
    wf = fire_color_grade(wf, gray_mean, 1.5, 0.73)

    sky = retrieve_sky_mask(seg_preds).to(torch.float32)
    if crop_bottom_sky_mask:
        sky[:, :, 2 * sky.shape[-2] // 3:] = 0.0
    sky = resize(sky, x.shape[-2:], mode="nearest")
    sky = increase_sky_mask(sky, 0.18, 0.18)
    sky = gaussian_blur(sky, kernel_size, kernel_sigma)

    if g_value is None:
        g_value = torch.randint(100, 151, (), generator=generator,
                                device=x.device)
    g_value = torch.as_tensor(g_value, device=x.device).to(torch.float32)
    wf = fire_paste(wf, sky.contiguous(), g_value.reshape(()).contiguous(),
                    transparency, 0.8)

    # dummy pixels to pin the [0, 255] range for downstream min-max scaling
    wf[:, :, 0, 0] = 255.0
    wf[:, :, -1, -1] = 0.0
    return wf
