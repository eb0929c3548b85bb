"""The ``ctypes`` binding of ``csrc/events.cu`` and the checks shared by its
three wrappers (``smog_tail``, ``fire_color_grade``, ``fire_paste``).

The kernels take float32 NCHW planes: x (N, 3, H, W), an optional
(N, 1, H, W) plane and an optional one-value device tensor, all contiguous
on one device. The checks run on every device, so the CPU path rejects what
the card's would.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from climategan_torch.kernels import launches


def _lib():
    from climategan_torch.kernels import _build

    lib = _build.load("events")
    if not getattr(lib, "_typed", False):
        p, ll, f, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
        lib.smog_tail_launch.argtypes = [p, p, p, ll, ll, f, f, f, f, f, f, p]
        lib.fire_color_grade_launch.argtypes = [p, p, p, ll, f, f, f, p]
        lib.fire_paste_launch.argtypes = [p, p, p, p, ll, ll, f, f, p]
        for fn in (lib.smog_tail_launch, lib.fire_color_grade_launch,
                   lib.fire_paste_launch):
            fn.restype = i
        lib.events_error_string.argtypes = [i]
        lib.events_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def check(name: str, x: torch.Tensor, plane: Optional[torch.Tensor] = None,
          scalar: Optional[torch.Tensor] = None) -> None:
    """Raise TypeError on a dtype other than float32 and ValueError on a
    shape, device or layout the kernel does not take."""
    tensors = [t for t in (x, plane, scalar) if t is not None]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 tensors, got {t.dtype}")
    if x.ndim != 4 or x.shape[1] != 3:
        raise ValueError(f"{name} needs x as (N, 3, H, W), got {tuple(x.shape)}")
    if plane is not None and tuple(plane.shape) != (x.shape[0], 1) + tuple(x.shape[2:]):
        raise ValueError(f"{name} needs a (N, 1, H, W) plane beside x "
                         f"{tuple(x.shape)}, got {tuple(plane.shape)}")
    if scalar is not None and scalar.numel() != 1:
        raise ValueError(f"{name} needs a one-value tensor, got "
                         f"{tuple(scalar.shape)}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} needs its tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def launch(name: str, x: torch.Tensor, *args) -> None:
    """Call ``<name>_launch(*args, stream)`` on x's device and count the
    launch; a launch the runtime refuses raises."""
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"{name}_launch")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.events_error_string(err).decode())
    launches[name] += 1
