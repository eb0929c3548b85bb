"""DiffAugment's differentiable augmentations for the painter's
discriminator (NCHW), as the JAX package's ``ops/diff_aug.py`` computes
them (reference climategan/transforms.py:494-626, from data-efficient-gans).

The random draws are inputs: per-sample uniforms in [0, 1) for the color
jitter and integer offsets for the translation and the cutout. JAX's keys
cannot be reproduced in PyTorch, so a caller that holds the port to the JAX
package feeds JAX's draws in; ``DiffTransforms.draw`` draws them from a
torch ``Generator`` otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Draws = Dict[str, torch.Tensor]


def _per_sample(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return r.to(device=x.device, dtype=x.dtype).reshape(-1, 1, 1, 1)


def rand_brightness(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``x + (r - 0.5)`` with one uniform ``r`` per sample."""
    return x + (_per_sample(r, x) - 0.5)


def rand_saturation(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Each pixel's distance to its mean over the channels, scaled by
    ``2 r``."""
    mean = x.mean(dim=1, keepdim=True)
    return (x - mean) * (_per_sample(r, x) * 2.0) + mean


def rand_contrast(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Each sample's distance to its mean, scaled by ``r + 0.5``."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (_per_sample(r, x) + 0.5) + mean


def translation_shifts(h: int, w: int, ratio: float = 0.125):
    """The largest row and column shifts of ``rand_translation``."""
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def rand_translation(x: torch.Tensor, tx: torch.Tensor,
                     ty: torch.Tensor) -> torch.Tensor:
    """Each sample shifted by ``tx`` rows and ``ty`` columns (integers), the
    uncovered border zero: a gather from the image padded with one zero on
    each side, its indices clipped into the padding."""
    n, c, h, w = x.shape
    dev = x.device
    gx = torch.clamp(torch.arange(h, device=dev)[None, :]
                     + tx.to(dev).reshape(n, 1) + 1, 0, h + 1)
    gy = torch.clamp(torch.arange(w, device=dev)[None, :]
                     + ty.to(dev).reshape(n, 1) + 1, 0, w + 1)
    xp = F.pad(x, (1, 1, 1, 1))
    rows = torch.gather(xp, 2, gx[:, None, :, None].expand(n, c, h, w + 2))
    return torch.gather(rows, 3, gy[:, None, None, :].expand(n, c, h, w))


def cutout_sizes(h: int, w: int, ratio: float = 0.5):
    """The cutout's height and width for an (h, w) image."""
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def rand_cutout(x: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                ratio: float = 0.5) -> torch.Tensor:
    """Each sample with a (ch, cw) rectangle zeroed, its centre at row
    ``ox`` and column ``oy`` (``cutout_sizes``), cut by the border."""
    n, _, h, w = x.shape
    ch, cw = cutout_sizes(h, w, ratio)
    dev = x.device
    ox = ox.to(dev).reshape(n, 1) - ch // 2
    oy = oy.to(dev).reshape(n, 1) - cw // 2
    gx = torch.arange(h, device=dev)[None, :]
    gy = torch.arange(w, device=dev)[None, :]
    in_x = (gx >= ox) & (gx < ox + ch)
    in_y = (gy >= oy) & (gy < oy + cw)
    mask = 1.0 - (in_x[:, :, None] & in_y[:, None, :]).to(x.dtype)
    return x * mask[:, None]


@dataclasses.dataclass(frozen=True)
class DiffTransforms:
    """``gen.p.diff_aug``: color jitter (brightness, contrast, saturation),
    then a translation, then a cutout, each where it is on (reference
    transforms.py:609-626)."""

    do_color_jittering: bool = False
    do_cutout: bool = False
    do_translation: bool = False
    cutout_ratio: float = 0.5
    translation_ratio: float = 0.125

    @classmethod
    def from_opts(cls, diff_aug) -> "DiffTransforms":
        return cls(bool(diff_aug.get("do_color_jittering", False)),
                   bool(diff_aug.get("do_cutout", False)),
                   bool(diff_aug.get("do_translation", False)),
                   float(diff_aug.get("cutout_ratio", 0.5)),
                   float(diff_aug.get("translation_ratio", 0.125)))

    def draw(self, n: int, h: int, w: int,
             generator: Optional[torch.Generator] = None) -> Draws:
        """The draws of one call on n (h, w) images, on the CPU, those of
        the transforms that are on, in the order they apply: uniforms
        ``brightness``, ``contrast``, ``saturation``; row and column shifts
        ``tx``, ``ty`` in [-shift, shift]; the cutout's centre ``ox`` in
        [0, h + 1 - ch % 2), ``oy`` likewise."""
        out: Draws = {}
        if self.do_color_jittering:
            for k in ("brightness", "contrast", "saturation"):
                out[k] = torch.rand(n, generator=generator)
        if self.do_translation:
            sh, sw = translation_shifts(h, w, self.translation_ratio)
            out["tx"] = torch.randint(-sh, sh + 1, (n,), generator=generator)
            out["ty"] = torch.randint(-sw, sw + 1, (n,), generator=generator)
        if self.do_cutout:
            ch, cw = cutout_sizes(h, w, self.cutout_ratio)
            out["ox"] = torch.randint(0, h + (1 - ch % 2), (n,),
                                      generator=generator)
            out["oy"] = torch.randint(0, w + (1 - cw % 2), (n,),
                                      generator=generator)
        return out

    def __call__(self, x: torch.Tensor, draws: Draws) -> torch.Tensor:
        if self.do_color_jittering:
            x = rand_brightness(x, draws["brightness"])
            x = rand_contrast(x, draws["contrast"])
            x = rand_saturation(x, draws["saturation"])
        if self.do_translation:
            x = rand_translation(x, draws["tx"], draws["ty"])
        if self.do_cutout:
            x = rand_cutout(x, draws["ox"], draws["oy"], self.cutout_ratio)
        return x
