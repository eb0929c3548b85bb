"""ctypes bindings for the native C++ host-preprocessing library
(``native/batch_pack.cpp``).

At first use the source is built with ``g++`` (``native/Makefile``'s flags)
into ``climategan_torch/_build/libbatch_pack-<hash>.so``, the hash of the
source and flags naming the file, as ``kernels/_build.py`` names the CUDA
libraries; nothing is written into ``native/``. Where the toolchain or the
library is missing, every function falls back to ``uint8_to_m11`` and
``resize_and_crop`` (numpy and cv2), the one plain path of the host prep:
callers treat the library as an optional fast path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "batch_pack.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def target() -> Path:
    """The library file that the current source and flags build to."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbatch_pack-{digest}.so"


def build() -> Path:
    """Compile the source unless its library exists; returns the library.
    Raises when the compiler is missing or fails."""
    so = target()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
        lib.pack_uint8_to_m11.argtypes = [u8p, f32p, ctypes.c_int64, ctypes.c_int]
        lib.pack_uint8_to_m11.restype = None
        lib.prepare_inference_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, f32p, ctypes.c_int]
        lib.prepare_inference_u8.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def uint8_to_m11(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 [-1, 1] as the library computes it (x / 127.5 - 1
    in float32), so the plain path equals the native one bit for bit."""
    return img.astype(np.float32) / np.float32(127.5) - np.float32(1)


def resize_and_crop(img: np.ndarray, to: int = 640) -> np.ndarray:
    """Resize keeping the aspect ratio so the smaller side is ``to``, then
    center-crop to ``to``^2 (cv2 bilinear; the reference's
    apply_events.py:211-241). An image already ``to``^2 is returned as it
    is, which is what cv2's resize to the same size gives."""
    h, w = img.shape[:2]
    if (h, w) == (to, to):
        return img
    import cv2

    if h < w:
        nh, nw = to, int(round(w * to / h))
    else:
        nh, nw = int(round(h * to / w)), to
    img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    top, left = (nh - to) // 2, (nw - to) // 2
    return img[top: top + to, left: left + to]


def pack_uint8_to_m11(img: np.ndarray, n_threads: int = 2) -> np.ndarray:
    """uint8 array -> float32 [-1, 1], native when possible."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if lib is None:
        return uint8_to_m11(img)
    out = np.empty(img.shape, np.float32)
    lib.pack_uint8_to_m11(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img.size, n_threads)
    return out


def prepare_inference(img: np.ndarray, target: int = 640) -> np.ndarray:
    """uint8 HWC -> float32 (target, target, C) in [-1, 1]: resize keeping
    the aspect ratio so the smaller side is ``target``, center crop, scale;
    all in C++ (fallback: ``resize_and_crop`` and ``uint8_to_m11``)."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    if lib is not None:
        out = np.empty((target, target, c), np.float32)
        rc = lib.prepare_inference_u8(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), target)
        if rc == 0:
            return out
    return uint8_to_m11(resize_and_crop(img, target))
