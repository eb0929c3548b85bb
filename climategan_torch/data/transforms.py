"""Host-side transforms of the training samples: dicts of numpy arrays
``{task: (1, H, W, C)}``, the port's own copy of the JAX package's
``data/transforms.py`` (a re-design of reference climategan/transforms.py).

They stay numpy on the host so that a batch is bit-equal to the JAX
package's: the same resize matrices through the same ``np.einsum`` calls,
and the same draws of one ``random.Random`` (the ``random`` module itself
when none is given, as there) in the same order. The draws of one loader
come from one generator: with ``num_workers > 0`` the loader's prefetch
threads share it, so their order is that of the threads, in the JAX
package too.

Interpolation per task (reference transforms.py:22-26): d, m and s
nearest, x bilinear with ``align_corners=True``.
"""
from __future__ import annotations

import functools
import random
from typing import Dict, Optional

import numpy as np

Arrays = Dict[str, np.ndarray]  # {task: (1, H, W, C) float32}


def _source_positions(in_size: int, out_size: int,
                      align_corners: bool) -> np.ndarray:
    """Fractional source coordinate of each output index (torch's rule)."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            return np.zeros(1, dtype=np.float64)
        return i * (in_size - 1) / (out_size - 1)
    scale = in_size / out_size
    return (i + 0.5) * scale - 0.5


@functools.lru_cache(maxsize=None)
def _linear_matrix(in_size: int, out_size: int,
                   align_corners: bool) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, torch-exact."""
    src = _source_positions(in_size, out_size, align_corners)
    if not align_corners:
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    t = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), (1.0 - t).astype(np.float32))
    np.add.at(mat, (rows, hi), t.astype(np.float32))
    return mat


@functools.lru_cache(maxsize=None)
def _nearest_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) 0/1 selection matrix, torch 'nearest' (floor)."""
    src = np.floor(np.arange(out_size, dtype=np.float64) * in_size / out_size)
    src = np.clip(src.astype(np.int64), 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    mat[np.arange(out_size), src] = 1.0
    return mat


def _axis_matrix(in_size: int, out_size: int, mode: str,
                 align_corners: bool) -> np.ndarray:
    if mode == "bilinear":
        return _linear_matrix(in_size, out_size, align_corners)
    if mode == "nearest":
        return _nearest_matrix(in_size, out_size)
    raise ValueError(f"Unsupported interpolation mode: {mode}")


def np_resize(arr: np.ndarray, size, mode: str, align_corners: bool = False):
    """Resize an (N, H, W, C) array with torch's semantics."""
    H, W = arr.shape[1], arr.shape[2]
    h, w = int(size[0]), int(size[1])
    if (H, W) == (h, w):
        return arr
    out = arr.astype(np.float32)
    if h != H:
        A = _axis_matrix(H, h, mode, align_corners)
        out = np.einsum("hH,NHWC->NhWC", A, out)
    if w != W:
        B = _axis_matrix(W, w, mode, align_corners)
        out = np.einsum("wW,NHWC->NHwC", B, out)
    return out


def _interp_kind(task: str):
    if task in ("d", "m", "s"):
        return "nearest", False
    return "bilinear", True


class Resize:
    """reference transforms.py:29-147."""

    def __init__(self, target_size, keep_aspect_ratio: bool = False):
        self.sizes = {}
        if isinstance(target_size, dict):
            assert not keep_aspect_ratio
            self.sizes = {k: (int(v), int(v)) for k, v in target_size.items()
                          if k != "default"}
            self.default = (int(target_size["default"]),) * 2
        elif isinstance(target_size, int):
            self.default = (target_size, target_size)
        else:
            self.default = (int(target_size[0]), int(target_size[1]))
        self.keep_aspect_ratio = keep_aspect_ratio

    def __call__(self, data: Arrays) -> Arrays:
        ref = data.get("x", next(iter(data.values())))
        if self.keep_aspect_ratio:
            h, w = ref.shape[1], ref.shape[2]
            if h < w:
                new = (self.default[0], int(self.default[0] * w / h))
            else:
                new = (int(self.default[0] * h / w), self.default[1])
            sizes = {t: new for t in data}
        else:
            sizes = {t: self.sizes.get(t, self.default) for t in data}
        out = {}
        for task, arr in data.items():
            mode, ac = _interp_kind(task)
            if task == "s" and arr.dtype != np.float32:
                out[task] = np_resize(arr.astype(np.float32), sizes[task],
                                      "nearest").astype(arr.dtype)
            else:
                out[task] = np_resize(arr, sizes[task], mode, ac)
        return out


class RandomCrop:
    """reference transforms.py:150-178."""

    def __init__(self, size, center: bool = False,
                 rng: Optional[random.Random] = None):
        self.h, self.w = (size, size) if isinstance(size, int) else size
        self.center = center
        self.rng = rng or random

    def __call__(self, data: Arrays) -> Arrays:
        ref = data.get("x", next(iter(data.values())))
        H, W = ref.shape[1], ref.shape[2]
        if self.center:
            top, left = (H - self.h) // 2, (W - self.w) // 2
        else:
            top = self.rng.randint(0, max(H - self.h - 1, 0)) if H > self.h else 0
            left = self.rng.randint(0, max(W - self.w - 1, 0)) if W > self.w else 0
        return {t: a[:, top: top + self.h, left: left + self.w, :]
                for t, a in data.items()}


class RandomHorizontalFlip:
    """reference transforms.py:181-189: flips with probability p."""

    def __init__(self, p: float = 0.5, rng=None):
        self.p = p
        self.rng = rng or random

    def __call__(self, data: Arrays) -> Arrays:
        if self.rng.random() > self.p:
            return data
        return {t: a[:, :, ::-1, :].copy() for t, a in data.items()}


def _pin_range(x: np.ndarray) -> np.ndarray:
    # pixels that keep the range under a later min-max scaling
    # (reference transforms.py:504-507)
    x[:, 0, 0, :] = 1.0
    x[:, -1, -1, :] = 0.0
    return x


def _blend(a: np.ndarray, b, factor: float) -> np.ndarray:
    return np.clip(factor * a + (1.0 - factor) * b, 0.0, 1.0)


class RandBrightness:
    """torchvision's adjust_brightness with a U(0.5, 1.5) factor on x in
    [0, 1]."""

    def __init__(self, rng=None):
        self.rng = rng or random

    def __call__(self, data: Arrays) -> Arrays:
        f = self.rng.uniform(0.5, 1.5)
        return {t: _pin_range(_blend(a, 0.0, f)) if t == "x" else a
                for t, a in data.items()}


class RandSaturation:
    def __init__(self, rng=None):
        self.rng = rng or random

    def __call__(self, data: Arrays) -> Arrays:
        f = self.rng.uniform(0.5, 1.5)
        out = {}
        for t, a in data.items():
            if t == "x":
                gray = (0.2989 * a[..., 0] + 0.587 * a[..., 1]
                        + 0.114 * a[..., 2])[..., None]
                out[t] = _pin_range(_blend(a, gray, f))
            else:
                out[t] = a
        return out


class RandContrast:
    def __init__(self, rng=None):
        self.rng = rng or random

    def __call__(self, data: Arrays) -> Arrays:
        f = self.rng.uniform(0.5, 1.5)
        out = {}
        for t, a in data.items():
            if t == "x":
                gray = 0.2989 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
                out[t] = _pin_range(_blend(a, float(gray.mean()), f))
            else:
                out[t] = a
        return out


class Normalize:
    """x: [0, 1] -> normalized by mean and std (reference
    transforms.py:213-239); the other tasks pass through."""

    def __init__(self, normalization: str = "default"):
        if normalization == "HRNet":
            self.mean = np.array([0.485, 0.456, 0.406], np.float32)
            self.std = np.array([0.229, 0.224, 0.225], np.float32)
        else:
            self.mean = np.array([0.5, 0.5, 0.5], np.float32)
            self.std = np.array([0.5, 0.5, 0.5], np.float32)

    def __call__(self, data: Arrays) -> Arrays:
        return {t: (a - self.mean) / self.std if t == "x" else a
                for t, a in data.items()}


class BucketizeDepth:
    """Log-depth buckets for the depth classification head (reference
    transforms.py:264-289)."""

    def __init__(self, opts, domain: str):
        self.enabled = bool(
            opts.gen.d.get("classify", {}).get("enable")
        ) and domain in {"s", "kitti"}
        if self.enabled:
            lin = opts.gen.d.classify.linspace
            self.buckets = np.linspace(lin["min"], lin["max"],
                                       int(lin["buckets"]) - 1)

    def __call__(self, data: Arrays) -> Arrays:
        if not self.enabled or "d" not in data:
            return data
        out = dict(data)
        out["d"] = np.searchsorted(self.buckets, data["d"],
                                   side="right").astype(np.int32)
        return out


class PrepareInference:
    """A path or an (H, W, 3 or 4) array -> a model-ready (1, t, t, 3)
    float32 array in [-1, 1] (reference transforms.py:292-360): values
    above 1.5 are taken as [0, 255], the short side is resized to
    ``t = target_size`` keeping the aspect ratio (bilinear, as ``np_resize``
    computes it), then the centre t x t is cropped; float16 with ``half``.
    A path is decoded as ``datasets._imread`` does (RGB order); a gray
    image is repeated over three channels and a 16-bit one cut to its high
    byte, as an 8-bit colour decode does."""

    def __init__(self, target_size: int = 640, half: bool = False):
        self.target_size = target_size
        self.half = half

    def __call__(self, x) -> np.ndarray:
        if isinstance(x, str) or hasattr(x, "__fspath__"):
            from climategan_torch.data.datasets import _imread  # imports us

            arr = _imread(str(x))
            if arr.dtype == np.uint16:
                arr = (arr >> 8).astype(np.uint8)
            if arr.ndim == 2:
                arr = np.repeat(arr[..., None], 3, axis=-1)
        else:
            arr = np.asarray(x)
        if arr.ndim == 3 and arr.shape[-1] == 4:
            arr = arr[..., :3]
        arr = arr.astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0

        h, w = arr.shape[:2]
        t = self.target_size
        if h < w:
            nh, nw = t, int(round(w * t / h))
        else:
            nh, nw = int(round(h * t / w)), t
        arr = np_resize(arr[None], (nh, nw), "bilinear", False)[0]
        top, left = (nh - t) // 2, (nw - t) // 2
        out = (arr[top:top + t, left:left + t] * 2.0 - 1.0)[None]
        return out.astype(np.float16) if self.half else out


class PrepareTest(PrepareInference):
    """``PrepareInference`` of each of ``xs``, as one (N, t, t, 3) batch
    (reference transforms.py:363-421)."""

    def __call__(self, xs) -> np.ndarray:
        return np.concatenate(
            [PrepareInference.__call__(self, x) for x in xs], axis=0)


def get_transforms(opts, mode: str, domain: str, rng=None):
    """The pipeline of ``opts.data.transforms`` (reference
    transforms.py:424-490): the colour jitters come last, in train mode
    and for painterless models only."""
    jitter_cls = {
        "brightness": RandBrightness,
        "saturation": RandSaturation,
        "contrast": RandContrast,
    }
    transforms = []
    for t in opts.data.get("transforms", []) or []:
        ignore = t.get("ignore", False)
        if ignore is True or ignore == mode:
            continue
        name = t["name"]
        if name in jitter_cls:
            continue
        if name == "crop":
            transforms.append(RandomCrop(
                (int(t["height"]), int(t["width"])),
                center=t.get("center") == mode, rng=rng))
        elif name == "resize":
            transforms.append(Resize(t["new_size"],
                                     t.get("keep_aspect_ratio", False)))
        elif name == "hflip":
            transforms.append(RandomHorizontalFlip(p=float(t.get("p", 0.5)),
                                                   rng=rng))
        else:
            raise ValueError(f"Unknown transform {name}")

    if "p" not in opts.tasks and mode == "train":
        for t in opts.data.get("transforms", []) or []:
            ignore = t.get("ignore", False)
            if ignore is True or ignore == mode:
                continue
            if t["name"] in jitter_cls:
                transforms.append(jitter_cls[t["name"]](rng=rng))

    transforms.append(Normalize(opts.data.get("normalization", "default")))
    transforms.append(BucketizeDepth(opts, domain))
    return transforms


def apply_transforms(data: Arrays, transforms) -> Arrays:
    for t in transforms:
        data = t(data)
    return data
