"""Large-kernel Gaussian blur and box dilation as two matrix products each
(NCHW), from ``climategan_tpu/ops/blur.py``.

A separable filter along one axis of a fixed size is a linear operator, so
the 281-tap reflect-border Gaussian of the wildfire sky mask folds into a
dense (H, H) and a (W, W) matrix, built once on the host in float64 and
cast to float32, and the blur is ``B_h @ x @ B_w^T``. The reflect folding
is kept in the matrix because the kernel may be wider than the image
(281 taps on a 64-px test image), which ``F.pad(mode="reflect")`` refuses.
The products run in full float32: the port leaves PyTorch's default
``allow_tf32 = False`` for matmuls as it is.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def gaussian_kernel_1d(kernel_size: int, sigma: float) -> np.ndarray:
    """Matches kornia get_gaussian_kernel1d: normalized gaussian over a
    centered window."""
    x = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float64)


def _reflect_index(i: np.ndarray, n: int) -> np.ndarray:
    """torch/kornia 'reflect' (no edge repeat) index folding."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


@functools.lru_cache(maxsize=None)
def _blur_matrix(size: int, kernel_size: int, sigma: float) -> np.ndarray:
    """(size, size) operator: out = B @ in, reflect-padded gaussian."""
    k = gaussian_kernel_1d(kernel_size, sigma)
    r = (kernel_size - 1) // 2
    B = np.zeros((size, size), dtype=np.float64)
    taps = np.arange(kernel_size) - r
    for out_i in range(size):
        src = _reflect_index(out_i + taps, size)
        np.add.at(B[out_i], src, k)
    return B.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _band_matrix(size: int, radius: int) -> np.ndarray:
    """(size, size) ones-band operator: out_i = sum(in[i-radius..i+radius])
    with zero boundary."""
    B = np.zeros((size, size), dtype=np.float32)
    for i in range(size):
        B[i, max(0, i - radius):min(size, i + radius + 1)] = 1.0
    return B


@functools.lru_cache(maxsize=None)
def _on_device(kind: str, size: int, a, b, device: torch.device) -> torch.Tensor:
    """The host matrix of ``kind`` as a float32 tensor on ``device``, kept
    per (kind, size, taps or radius, sigma, device)."""
    host = _blur_matrix(size, a, b) if kind == "blur" else _band_matrix(size, a)
    return torch.from_numpy(host).to(device)


def gaussian_blur(x: torch.Tensor, kernel_size: int,
                  sigma: float) -> torch.Tensor:
    """Separable reflect-border Gaussian blur of NCHW ``x`` in float32,
    returned in ``x``'s dtype."""
    H, W = x.shape[-2:]
    Bh = _on_device("blur", H, kernel_size, float(sigma), x.device)
    Bw = _on_device("blur", W, kernel_size, float(sigma), x.device)
    y = torch.matmul(Bh, x.float())
    return torch.matmul(y, Bw.t()).to(x.dtype)


def box_dilate(mask: torch.Tensor, radius_h: int, radius_w: int) -> torch.Tensor:
    """Binary box dilation of an NCHW 0/1 mask with zero boundary: for a
    0/1 mask the max over a (2r+1) box is (sum over the box > 0), and the
    separable box sums are two banded matrix products."""
    if radius_h <= 0 and radius_w <= 0:
        return mask
    H, W = mask.shape[-2:]
    y = mask.float()
    if radius_h > 0:
        y = torch.matmul(_on_device("band", H, radius_h, None, mask.device), y)
    if radius_w > 0:
        y = torch.matmul(y, _on_device("band", W, radius_w, None, mask.device).t())
    return (y > 0.0).to(mask.dtype)
