"""Perlin noise for paint_cloudy's synthetic cloudy sky.

The gradient angles come from ``uniform``, a (rh+1, rw+1) tensor of draws in
[0, 1), when it is given; otherwise they are drawn from ``generator``. The
JAX package draws them from its own PRNG, whose bits PyTorch cannot
reproduce, so a caller that must match it passes the JAX draws in.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _fade(t: torch.Tensor) -> torch.Tensor:
    return 6 * t ** 5 - 15 * t ** 4 + 10 * t ** 3


def _draws(res: Tuple[int, int], uniform: Optional[torch.Tensor],
           generator: Optional[torch.Generator], device) -> torch.Tensor:
    rh, rw = res
    if uniform is None:
        return torch.rand((rh + 1, rw + 1), generator=generator,
                          device=device, dtype=torch.float32)
    if tuple(uniform.shape) != (rh + 1, rw + 1):
        raise ValueError(f"uniform must be {(rh + 1, rw + 1)}, "
                         f"got {tuple(uniform.shape)}")
    return uniform.to(device=device, dtype=torch.float32)


def rand_perlin_2d(shape: Tuple[int, int], res: Tuple[int, int],
                   uniform: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> torch.Tensor:
    """(H, W) float32 Perlin noise on a gradient grid of ``res`` cells.
    ``shape`` must be divisible by ``res``."""
    H, W = shape
    rh, rw = res
    d0, d1 = H // rh, W // rw
    gy = (torch.arange(H, dtype=torch.float32, device=device) * (rh / H)) % 1.0
    gx = (torch.arange(W, dtype=torch.float32, device=device) * (rw / W)) % 1.0
    grid_y = gy[:, None].expand(H, W)
    grid_x = gx[None, :].expand(H, W)

    angles = 2 * math.pi * _draws(res, uniform, generator, device)
    gradients = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)

    def tile_grads(sy, sx):
        g = gradients[sy[0]:sy[1], sx[0]:sx[1]]
        g = g.repeat_interleave(d0, dim=0).repeat_interleave(d1, dim=1)
        return g[:H, :W]

    def dot(grad, shift):
        return ((grid_y + shift[0]) * grad[..., 0]
                + (grid_x + shift[1]) * grad[..., 1])

    n00 = dot(tile_grads((0, -1), (0, -1)), (0.0, 0.0))
    n10 = dot(tile_grads((1, None), (0, -1)), (-1.0, 0.0))
    n01 = dot(tile_grads((0, -1), (1, None)), (0.0, -1.0))
    n11 = dot(tile_grads((1, None), (1, None)), (-1.0, -1.0))

    ty, tx = _fade(grid_y), _fade(grid_x)

    def lerp(a, b, t):
        return a + t * (b - a)

    return math.sqrt(2.0) * lerp(lerp(n00, n10, ty), lerp(n01, n11, ty), tx)


def shifted_noise(shape: Tuple[int, int], res: Tuple[int, int],
                  uniform: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """The (H, W) Perlin field minus its minimum, ``mix_noise``'s noise."""
    noise = rand_perlin_2d(shape, res, uniform, generator, device=device)
    return noise - noise.min()


def blend_noise(x: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor,
                weight: float) -> torch.Tensor:
    """``noise`` (rows of ``shifted_noise``, as many as x's) blended into
    NCHW ``x`` where the (N,1,H,W) ``mask`` is 1."""
    noise = noise[None, None].to(x.dtype)
    mask = mask.to(x.dtype)
    return mask * (weight * noise + (1 - weight) * x) + (1 - mask) * x


def mix_noise(x: torch.Tensor, mask: torch.Tensor,
              res: Tuple[int, int] = (8, 3), weight: float = 0.1,
              uniform: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Blend min-shifted Perlin noise into NCHW ``x`` where the (N,1,H,W)
    ``mask`` is 1; one noise field is shared across the batch."""
    noise = shifted_noise(tuple(x.shape[-2:]), res, uniform, generator,
                          device=x.device)
    return blend_noise(x, mask, noise, weight)
