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
from typing import Optional, Tuple, Union

import torch

from climategan_torch.kernels.fire_color_grade import fire_color_grade, quantize_u8
from climategan_torch.kernels.fire_paste import fire_paste
from climategan_torch.ops.blur import box_dilate, gaussian_blur
from climategan_torch.ops.image import normalize, retrieve_sky_mask
from climategan_torch.ops.interpolate import resize
from climategan_torch.parallel import spatial
from climategan_torch.parallel.spatial import Rows


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


def _warm(x: torch.Tensor) -> torch.Tensor:
    """Step 1: the min-max rescale and the warm shift, truncated."""
    wf = normalize(x, 0.0, 255.0)
    return quantize_u8(wf + _warm_shift(wf.device)).contiguous()


def warm_rows(x: Rows) -> Rows:
    """``_warm`` on a row-sharded image, with the whole image's min-max."""
    return spatial.normalize(x, 0.0, 255.0).map(
        lambda p: quantize_u8(p + _warm_shift(p.device)).contiguous())


def gray_sum_rows(wf: Rows) -> Tuple[torch.Tensor, int]:
    """``gray_sum``'s sum (float64, on the first shard's device) and count
    over the shards of a warmed image (``warm_rows``)."""
    sums = [_grayscale(p).sum(dtype=torch.float64) if p.shape[2] else None
            for p in wf.parts]
    total = spatial.all_reduce(sums, "sum", wf.devices[:1])[0]
    return total, wf.parts[0].shape[0] * wf.h * wf.w


def gray_sum(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The sum (float64, on x's device) and the count of the grayscale
    values whose mean is ``add_fire``'s batch gray mean: what a part of a
    batch split over replicas contributes to the mean of the whole."""
    g = _grayscale(_warm(x))
    return g.sum(dtype=torch.float64), g.numel()


def add_fire(x: torch.Tensor, seg_preds: torch.Tensor,
             g_value: Optional[Union[float, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None,
             kernel_size: int = 281, kernel_sigma: float = 140.5,
             crop_bottom_sky_mask: bool = True,
             transparency: float = 200.0,
             gray_mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (N, 3, H, W) image, seg_preds: (N, C, h, w) logits; both float32.

    ``g_value`` is the filter's green value. The JAX package draws it from
    its own PRNG, whose bits PyTorch cannot reproduce, so a caller that must
    match it passes it in; without it, it is drawn in 100..150 from
    ``generator`` on x's device. ``gray_mean``: the batch's gray mean where
    x is a part of the batch (a 0-d float32 tensor on x's device, from
    ``gray_sum`` of every part); without it, x's own.
    """
    wf = _warm(x)
    if gray_mean is None:
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


def sky_rows(seg_preds: Rows, size, crop_bottom_sky_mask: bool = True
             ) -> torch.Tensor:
    """The whole dilated sky mask at ``size`` on the first shard's device,
    from row-sharded seg logits (steps 3 of ``add_fire``): each shard's
    argmax, gathered; the crop's first row is the whole map's."""
    first = seg_preds.devices[0]
    sky = seg_preds.map(lambda p: retrieve_sky_mask(p).to(torch.float32))
    sky = sky.gather(first)
    if crop_bottom_sky_mask:
        sky[:, :, 2 * sky.shape[-2] // 3:] = 0.0
    sky = resize(sky, size, mode="nearest")
    return increase_sky_mask(sky, 0.18, 0.18)


def add_fire_rows(x: Rows, seg_preds: Rows,
                  g_value: Union[float, torch.Tensor],
                  kernel_size: int = 281, kernel_sigma: float = 140.5,
                  crop_bottom_sky_mask: bool = True,
                  transparency: float = 200.0,
                  gray_mean: Optional[torch.Tensor] = None) -> Rows:
    """``add_fire`` on a row-sharded image and seg logits (float32), with a
    given ``g_value``: the min-max and the gray mean (``gray_mean``, else
    from every shard's ``gray_sum``) are the whole image's, every shard
    gets the whole dilated sky mask and blurs its own rows, and the
    range-pinning pixels land on the shards of the first and the last
    row. One launch of each fire kernel per shard with rows."""
    wf = warm_rows(x)
    if gray_mean is None:
        total, count = gray_sum_rows(wf)
        gray_mean = (total / count).float()
    sky = sky_rows(seg_preds, (x.h, x.w), crop_bottom_sky_mask)
    g_value = torch.as_tensor(g_value).to(torch.float32).reshape(())
    parts = []
    for i, p in enumerate(wf.parts):
        lo, hi = wf.bounds(i)
        if lo == hi:
            parts.append(p)
            continue
        dev = p.device
        p = fire_color_grade(p, gray_mean.to(dev), 1.5, 0.73)
        blurred = gaussian_blur(sky.to(dev), kernel_size, kernel_sigma,
                                rows=(lo, hi))
        p = fire_paste(p, blurred.contiguous(), g_value.to(dev).contiguous(),
                       transparency, 0.8)
        if lo == 0:
            p[:, :, 0, 0] = 255.0
        if hi == wf.h:
            p[:, :, -1, -1] = 0.0
        parts.append(p)
    return Rows(parts)
