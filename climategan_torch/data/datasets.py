"""Datasets and loaders: JSON/YAML file lists -> prefetched NHWC numpy
batches -> the training step's NCHW tensors. The port's own copy of the
JAX package's ``data/datasets.py`` (a re-design of reference
climategan/data.py: ``OmniListDataset`` :402-503, ``tensor_loader``
:344-399, ``get_loader`` / ``get_all_loaders`` :506-539).

Decoding and transforms run on the host in numpy, as in the JAX package,
so that batches are bit-equal to its own: a ``Loader`` shuffles with its
own seeded ``random.Random``, drops the last partial batch and prefetches
on ``num_workers`` threads. ``to_step_batch`` turns a collated batch into
the step's tensors (NCHW images, masks and depth, (N, H, W) int64 seg
labels), through pinned memory and a ``non_blocking`` copy on the card.
"""
from __future__ import annotations

import json
import queue
import random
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import yaml

from climategan_torch.data.transforms import apply_transforms, get_transforms
from climategan_torch.utils.opts import env_expand

try:
    import cv2  # native decode

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    from PIL import Image

    _HAS_CV2 = False

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}


def _imread(path: str) -> np.ndarray:
    """RGB(A) uint8 / uint16 image through cv2, else PIL."""
    if _HAS_CV2:
        arr = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise FileNotFoundError(path)
        if arr.ndim == 3 and arr.shape[-1] >= 3:
            arr = arr[..., [2, 1, 0] + list(range(3, arr.shape[-1]))]  # BGR->RGB
        return arr
    return np.asarray(Image.open(path))


def decode_unity_depth(arr: np.ndarray, log: bool = True,
                       normalize: bool = False, far: float = 1000.0):
    """Unity's 3-channel depth encoding -> metric depth (reference
    tutils.py:237-294); ``log=False`` returns its inverse."""
    R = ((247.0 - arr[..., 0]) / 8.0).astype(np.int64)
    G = ((247.0 - arr[..., 1]) / 8.0).astype(np.int64)
    B = (255.0 - arr[..., 2]).astype(np.int64)
    depth = (R * 256 * 31 + G * 256 + B).astype(np.float32) / (256 * 31 * 31 - 1)
    depth = depth * far
    if not log:
        depth = 1.0 / depth
    if log:
        depth = np.log(depth)
    if normalize:
        depth = depth - depth.min()
        depth = depth / depth.max()
    return depth


def load_task(path: str, task: str, domain: str, opts) -> np.ndarray:
    """One sample file -> (1, H, W, C) float32 (int32 labels for s), as
    reference tensor_loader (data.py:344-399) decodes it."""
    path = env_expand(path)
    suffix = Path(path).suffix.lower()

    if task == "s":
        if domain == "kitti":
            from climategan_torch.data.palettes import process_kitti_seg

            labels = process_kitti_seg(_imread(path))
            return labels.astype(np.int32)[None, :, :, None]
        if suffix == ".npy":
            arr = np.load(path)
        elif suffix in (".pt", ".pth"):
            arr = np.asarray(torch.load(path, map_location="cpu",
                                        weights_only=True))
        else:
            arr = _imread(path)
        arr = np.squeeze(arr)
        if arr.ndim == 3:  # one-hot or RGB-coded: kept as channels
            return arr.astype(np.float32)[None]
        return arr.astype(np.int32)[None, :, :, None]

    if task == "d":
        arr = np.load(path) if suffix == ".npy" else _imread(path)
        arr = arr.astype(np.float32)
        log_depth = bool(opts.gen.d.get("classify", {}).get("enable"))
        norm = "d" in (opts.train.get("pseudo", {}).get("tasks", []) or [])
        if domain == "r":  # megadepth: min-max normalized
            arr = arr - arr.min()
            arr = arr / max(arr.max(), 1e-12)
        elif domain == "s":
            arr = decode_unity_depth(arr, log=log_depth, normalize=norm)
        elif domain == "kitti":
            arr = arr / 100.0
            if not log_depth:
                arr = 1.0 / arr
                if norm:
                    arr = arr - arr.min()
                    arr = arr / max(arr.max(), 1e-12)
            else:
                arr = np.log(arr)
        arr = np.squeeze(arr)
        return arr.astype(np.float32)[None, :, :, None]

    if suffix == ".npy":
        arr = np.load(path).astype(np.float32)
    elif suffix in IMG_EXTENSIONS:
        arr = _imread(path).astype(np.float32)
    else:
        raise ValueError(f"Unknown data type {path}")

    if arr.ndim == 3 and arr.shape[-1] == 4:
        arr = arr[..., :3]

    if task == "x":
        arr = arr - arr.min()
        arr = arr / max(arr.max(), 1e-12)
        return arr[None]
    if task == "m":
        if arr.max() > 127:
            arr = (arr > 127).astype(np.float32)
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr.astype(np.float32)[None, :, :, None]
    return arr[None]


class OmniListDataset(torch.utils.data.Dataset):
    """A JSON/YAML list of {task: path} samples (reference
    data.py:402-503); an item is ``{"data": {task: (1, H, W, C)}, "paths",
    "domain", "mode"}`` (kitti items are of domain "s")."""

    def __init__(self, mode: str, domain: str, opts, transforms=None):
        self.opts = opts
        self.mode = mode
        self.domain = domain
        self.tasks = set(opts.tasks) | {"x"}
        if "p" in self.tasks:
            self.tasks.add("m")

        flp = Path(str(opts.data.files[mode][domain]))
        if "/" not in str(flp):
            flp = Path(str(opts.data.files.get("base", ""))) / flp
        flp = Path(env_expand(flp))
        if flp.suffix == ".json":
            with open(flp) as f:
                self.samples_paths = json.load(f)
        elif flp.suffix in (".yaml", ".yml"):
            with open(flp) as f:
                self.samples_paths = yaml.safe_load(f)
        else:
            raise ValueError(f"Unknown file list type: {flp}")

        max_samples = opts.data.get("max_samples", -1)
        if max_samples and max_samples != -1:
            self.samples_paths = self.samples_paths[: int(max_samples)]

        # only the tasks the model reads (reference filter_samples)
        self.samples_paths = [{k: v for k, v in s.items() if k in self.tasks}
                              for s in self.samples_paths]
        self.file_list_path = str(flp)
        self.transforms = transforms

    def __len__(self):
        return len(self.samples_paths)

    def __getitem__(self, i: int) -> Dict:
        paths = self.samples_paths[i]
        data = {task: load_task(p, task, self.domain, self.opts)
                for task, p in paths.items()}
        if self.transforms:
            data = apply_transforms(data, self.transforms)
        return {
            "data": data,
            "paths": paths,
            "domain": "s" if self.domain == "kitti" else self.domain,
            "mode": self.mode,
        }


def _collate(items: List[Dict]) -> Dict:
    """Samples -> one {task: (B, ...)} batch; (B, H, W) int32 seg labels."""
    data = {}
    for t in items[0]["data"]:
        data[t] = np.concatenate([np.asarray(it["data"][t]) for it in items],
                                 axis=0)
        if t == "s" and data[t].ndim == 4 and data[t].shape[-1] == 1:
            data[t] = data[t][..., 0].astype(np.int32)
    return {
        "data": data,
        "domain": items[0]["domain"],
        "mode": items[0]["mode"],
        "paths": [it["paths"] for it in items],
    }


class Loader:
    """Shuffled, drop-last batches, prefetched on ``num_workers`` threads
    (``num_workers + 1`` batches ahead). Every ``iter()`` (and ``sample()``)
    draws a new shuffle from the loader's ``random.Random(seed)`` and
    advances ``epoch``. An iteration left early cancels the batches not
    started."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.rng = random.Random(seed)
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def _batch(self, indices: List[int]) -> Dict:
        return _collate([self.dataset[i] for i in indices])

    def sample(self) -> Optional[Dict]:
        """The first batch of a new iteration (None when there is none),
        decoded alone, its samples on the loader's threads: what
        ``next(iter(loader))`` returns, without decoding the batches that
        the iteration would prefetch after it."""
        self.epoch += 1
        batches = self._index_batches()
        if not batches:
            return None
        if self.num_workers == 0:
            return self._batch(batches[0])
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(self.num_workers, len(batches[0]))) as pool:
            return _collate(list(pool.map(self.dataset.__getitem__,
                                          batches[0])))

    def __iter__(self) -> Iterator[Dict]:
        self.epoch += 1
        batches = self._index_batches()
        if self.num_workers == 0:
            for b in batches:
                yield self._batch(b)
            return

        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(self.num_workers)
        try:
            futures = queue.Queue()
            pending = iter(batches)
            for b in pending:
                futures.put(pool.submit(self._batch, b))
                if futures.qsize() > self.num_workers:
                    break
            while not futures.empty():
                f = futures.get()
                b = next(pending, None)
                if b is not None:
                    futures.put(pool.submit(self._batch, b))
                yield f.result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


def get_loader(mode: str, domain: str, opts, seed: int = 0) -> Loader:
    if (domain != "kitti" or not opts.train.kitti.get("pretrain")
            or not opts.train.kitti.get("batch_size")):
        batch_size = int(opts.data.loaders.get("batch_size", 4))
    else:
        batch_size = int(opts.train.kitti.get("batch_size", 4))
    ds = OmniListDataset(mode, domain, opts,
                         transforms=get_transforms(opts, mode, domain))
    return Loader(ds, batch_size, shuffle=True,
                  num_workers=int(opts.data.loaders.get("num_workers", 2)),
                  seed=seed)


def get_all_loaders(opts, seed: int = 0) -> Dict[str, Dict[str, Loader]]:
    """``{"train" | "val": {domain: Loader}}`` for the domains with a file
    list."""
    loaders: Dict[str, Dict[str, Loader]] = {}
    for mode in ("train", "val"):
        loaders[mode] = {}
        for domain in opts.domains:
            files = opts.data.get("files", {})
            if mode in files and domain in files[mode]:
                loaders[mode][domain] = get_loader(mode, domain, opts, seed)
    return loaders


def to_step_batch(data: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A collated NHWC batch -> the training step's tensors on ``device``:
    NCHW float images, masks and depth, (N, H, W) int64 seg labels. For a
    card they are laid out in pinned host memory and copied with
    ``non_blocking``."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out = {}
    for task, arr in data.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if task == "s" and t.dim() == 3:
            t = t.long()
        else:
            t = t.permute(0, 3, 1, 2)
        if pin:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out[task] = host.copy_(t).to(device, non_blocking=True)
        else:
            out[task] = t.contiguous()
    return out
