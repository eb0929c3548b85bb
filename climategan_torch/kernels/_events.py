"""The ``ctypes`` binding of ``csrc/events.cu`` and the checks shared by its
three wrappers (``smog_tail``, ``fire_color_grade``, ``fire_paste``).

The kernels take float32 NCHW planes: x (N, 3, H, W), an optional
(N, 1, H, W) plane and an optional one-value device tensor, all contiguous
on one device. The checks run on every device, so the CPU path rejects what
the card's would.

A call's host time is longer than the kernels' device time at 640^2, so
the launch path is kept short: each launch function is typed and bound
once, the device context is entered only when x is not on the current
device, and the current stream is read once, as a raw handle.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional

import torch

from climategan_torch.kernels import launches

_P, _LL, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
# argument types of <name>_launch, the stream last
_ARGTYPES = {
    "smog_tail": [_P, _P, _P, _LL, _LL, _F, _F, _F, _F, _F, _F, _P],
    "fire_color_grade": [_P, _P, _P, _LL, _F, _F, _F, _P],
    "fire_paste": [_P, _P, _P, _P, _LL, _LL, _F, _F, _P],
}
_FNS: Dict[str, Callable] = {}


def _bind(lib: Optional[ctypes.CDLL] = None) -> None:
    """Type the launch functions of ``lib`` once and launch through them;
    by default the library of ``csrc/events.cu``, built at first use."""
    if lib is None:
        from climategan_torch.kernels import _build

        lib = _build.load("events")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[name] = fn
    lib.events_error_string.argtypes = [ctypes.c_int]
    lib.events_error_string.restype = ctypes.c_char_p
    _FNS["error_string"] = lib.events_error_string


def check(name: str, x: torch.Tensor, plane: Optional[torch.Tensor] = None,
          scalar: Optional[torch.Tensor] = None) -> None:
    """Raise TypeError on a dtype other than float32 and ValueError on a
    shape, device or layout the kernel does not take."""
    tensors = [t for t in (x, plane, scalar) if t is not None]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 tensors, got {t.dtype}")
    shape = x.shape
    if len(shape) != 4 or shape[1] != 3:
        raise ValueError(f"{name} needs x as (N, 3, H, W), got {tuple(shape)}")
    if plane is not None and plane.shape != (shape[0], 1, shape[2], shape[3]):
        raise ValueError(f"{name} needs a (N, 1, H, W) plane beside x "
                         f"{tuple(shape)}, got {tuple(plane.shape)}")
    if scalar is not None and scalar.numel() != 1:
        raise ValueError(f"{name} needs a one-value tensor, got "
                         f"{tuple(scalar.shape)}")
    device = x.device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name} needs its tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")


def launch(name: str, x: torch.Tensor, *args) -> None:
    """Call ``<name>_launch(*args, stream)`` on x's device and its current
    stream, and count the launch; a launch the runtime refuses raises."""
    if not _FNS:
        _bind()
    index = x.get_device()
    if index == torch.cuda.current_device():
        err = _FNS[name](*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = _FNS[name](*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + _FNS["error_string"](err).decode())
    launches[name] += 1
