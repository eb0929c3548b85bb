"""FID of the painter (NCHW), the twin of the JAX package's ``fid.py``
(reference climategan/fid.py, a vendored pytorch-fid):

  * ``InceptionV3Features``: torchvision's inception_v3 trunk to pool3
    (2048 features) under torchvision's module names (``Conv2d_1a_3x3``,
    ``Mixed_5b.branch1x1``, ...), with pytorch-fid's patched blocks: every
    average pool leaves the padding out of its count and ``Mixed_7c`` pools
    by max; batch norms with eps 1e-3, always on their running statistics.
    A torchvision or pytorch-fid state dict loads into it
    (``utils/convert.load_inception_weights``), and the JAX package's
    ``load_inception_weights`` reads its ``state_dict()``.
  * ``activation_statistics``, ``_sqrtm_newton_schulz`` (30 Newton-Schulz
    iterations in float64, with ``torch.matmul`` on the tensors' device)
    and ``frechet_distance``.
  * ``FIDEvaluator``: images in [-1, 1], bilinearly resized to 299^2
    (``align_corners=False``, no antialias), real statistics kept once.

No FID-calibrated Inception weights are in the repository: without a file
(``opts.inception_weights``) the network has random weights from a seed,
He-normal so that the signal survives its depth, and the FID is a relative
measure only, as the JAX package says of its own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.ops.interpolate import resize

FEATURES = 2048
SIZE = 299


class BasicConv2d(nn.Module):
    """conv (no bias) -> batch norm (eps 1e-3, running statistics) ->
    relu, under torchvision's ``conv``/``bn`` keys."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean,
                                   bn.running_var, bn.weight, bn.bias,
                                   False, 0.0, bn.eps))


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average over the window's pixels inside the image."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """pytorch-fid's FIDInceptionE_1 (``pool="avg"``, Mixed_7b) and
    FIDInceptionE_2 (``pool="max"``, Mixed_7c)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = (F.max_pool2d(x, 3, 1, 1) if self.pool == "max"
              else avg_pool(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """torchvision's inception_v3 trunk to pool3: (N, 3, H, W) in [-1, 1]
    (callers resize to 299^2) -> (N, 2048). Always in eval semantics."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "InceptionV3Features":
        """Random weights from ``generator`` (drawn on the CPU): He-normal
        convs (std sqrt(2 / fan_in)), identity batch norms."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                std = (2.0 / m.weight[0].numel()) ** 0.5
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * std)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# statistics and the Frechet distance
# ---------------------------------------------------------------------------


def activation_statistics(feats: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, sigma) of (N, D) activations in float64 on their device; sigma
    the unbiased covariance, as ``np.cov(rowvar=False)``."""
    feats = feats.double()
    return feats.mean(dim=0), torch.cov(feats.t())


def _sqrtm_newton_schulz(A: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Matrix square root by coupled Newton-Schulz iterations in float64
    on A's device (the JAX package's replacement of scipy's sqrtm on the
    product sigma1 @ sigma2, which may be slightly non-symmetric)."""
    A = A.double()
    n = A.shape[0]
    norm = torch.linalg.matrix_norm(A, "fro")
    if float(norm) < 1e-12:
        return torch.zeros_like(A)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Y, Z = A / norm, eye
    for _ in range(iters):
        T = 0.5 * (3.0 * eye - Z @ Y)
        Y = Y @ T
        Z = T @ Z
    return Y * torch.sqrt(norm)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The Frechet distance between two Gaussians (reference
    fid.py:461-516), with ``eps`` on both covariances' diagonals."""
    mu1, mu2 = torch.as_tensor(mu1).double(), torch.as_tensor(mu2).double()
    sigma1 = torch.as_tensor(sigma1).double()
    sigma2 = torch.as_tensor(sigma2).double().to(sigma1.device)
    mu2 = mu2.to(mu1.device)
    diff = mu1 - mu2
    offset = torch.eye(sigma1.shape[0], dtype=sigma1.dtype,
                       device=sigma1.device) * eps
    covmean = _sqrtm_newton_schulz((sigma1 + offset) @ (sigma2 + offset))
    return float(diff @ diff + torch.trace(sigma1) + torch.trace(sigma2)
                 - 2.0 * torch.trace(covmean))


def compute_fid_from_features(real_feats, fake_feats) -> float:
    """The Frechet distance between the statistics of two (N, D) feature
    sets, tensors or arrays; computed on the real set's device."""
    real = torch.as_tensor(real_feats)
    fake = torch.as_tensor(fake_feats, device=real.device)
    mu1, s1 = activation_statistics(real)
    mu2, s2 = activation_statistics(fake)
    return frechet_distance(mu1, s1, mu2, s2)


class FIDEvaluator:
    """The painter's FID on the validation rf images (reference
    fid.py:334-434): real statistics kept by ``set_real``, then ``fid`` of
    painted images. ``model``: an Inception with weights (default: random
    from seed 0), moved to ``device`` in f32 eval mode: the card unless
    ``device="cpu"`` (an absent card raises, as ``resolve_device``)."""

    def __init__(self, model: Optional[InceptionV3Features] = None,
                 batch_size: int = 50, device="cuda"):
        from climategan_torch.inference import resolve_device

        self.device = resolve_device(device)
        if model is None:
            model = InceptionV3Features().init_weights(
                torch.Generator().manual_seed(0))
        self.model = model.to(self.device, torch.float32).eval()
        self.batch_size = int(batch_size)
        self._real_stats = None

    @torch.no_grad()
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """(N, 2048) features of NCHW images in [-1, 1] of any size,
        resized to 299^2, in batches of ``batch_size``."""
        out = []
        for i in range(0, images.shape[0], self.batch_size):
            chunk = images[i:i + self.batch_size].to(self.device,
                                                     torch.float32)
            out.append(self.model(resize(chunk, (SIZE, SIZE), "bilinear")))
        return torch.cat(out)

    def set_real(self, images: torch.Tensor) -> None:
        self._real_stats = activation_statistics(self.features(images))

    def fid(self, fake_images: torch.Tensor) -> float:
        if self._real_stats is None:
            raise RuntimeError("FIDEvaluator.fid: call set_real first")
        mu2, s2 = activation_statistics(self.features(fake_images))
        mu1, s1 = self._real_stats
        return frechet_distance(mu1, s1, mu2, s2)
