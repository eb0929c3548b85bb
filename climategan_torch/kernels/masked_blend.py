"""``masked_blend``: the flood paste ``x * (1 - m) + fake * m``.

Replaces the Pallas TPU kernel ``climategan_tpu/ops/pallas/events.py:
masked_blend``. The kernel is Triton. It is a pure elementwise pass, so its
bound on an H100 is bytes: every input is read once and the output written
once (about 10 values per pixel), with no reuse to stage and no tensor-core
work; one masked block load/store per program streams them at the card's
memory rate. ``m`` broadcasts over channels, the math is f32, and the output
has ``x``'s dtype.

Layout: x, fake (N, H, W, C); m (N, H, W, 1); all contiguous.
"""
from __future__ import annotations

import torch

from climategan_torch.kernels import launches

BLOCK = 1024

# bound to triton.language at the first launch, so that the module imports
# (and its plain version runs) on machines without triton
tl = None
_JIT = None


def _masked_blend_kernel(x_ptr, f_ptr, m_ptr, o_ptr, n_elem,
                         C: "tl.constexpr", BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    valid = offs < n_elem
    x = tl.load(x_ptr + offs, mask=valid).to(tl.float32)
    f = tl.load(f_ptr + offs, mask=valid).to(tl.float32)
    m = tl.load(m_ptr + offs // C, mask=valid).to(tl.float32)
    y = x * (1.0 - m) + f * m
    tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=valid)


def _compiled():
    global tl, _JIT
    if _JIT is None:
        import triton
        import triton.language

        tl = triton.language
        _JIT = triton.jit(_masked_blend_kernel)
    return _JIT


def masked_blend_plain(x: torch.Tensor, fake: torch.Tensor,
                       m: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch."""
    mf = m.float()
    return (x.float() * (1.0 - mf) + fake.float() * mf).to(x.dtype)


def masked_blend(x: torch.Tensor, fake: torch.Tensor,
                 m: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel, and anything it does not take raises."""
    if x.device.type == "cpu":
        return masked_blend_plain(x, fake, m)
    if x.device.type != "cuda":
        raise ValueError(f"masked_blend runs on cuda or cpu, not {x.device}")
    if x.ndim != 4 or fake.shape != x.shape or tuple(m.shape) != tuple(x.shape[:3]) + (1,):
        raise ValueError(f"masked_blend needs x, fake (N, H, W, C) and m "
                         f"(N, H, W, 1), got {tuple(x.shape)}, "
                         f"{tuple(fake.shape)}, {tuple(m.shape)}")
    for t in (x, fake, m):
        if t.device != x.device:
            raise ValueError("masked_blend needs its tensors on one device")
        if not t.is_contiguous():
            raise ValueError("masked_blend needs contiguous tensors")
        if t.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise TypeError(f"masked_blend takes floating tensors, got {t.dtype}")
    out = torch.empty_like(x)
    n = x.numel()
    kernel = _compiled()
    with torch.cuda.device(x.device):
        kernel[(-(-n // BLOCK),)](x, fake, m, out, n, C=x.shape[3],
                                         BLOCK=BLOCK, num_warps=4)
    launches["masked_blend"] += 1
    return out

