"""``masked_blend``: the flood paste ``x * (1 - m) + fake * m``.

Replaces the Pallas TPU kernel ``climategan_tpu/ops/pallas/events.py:
masked_blend``. The kernel is Triton. It is a pure elementwise pass, so its
bound on an H100 is bytes: every input is read once and the output written
once (about 10 values per pixel), with no reuse to stage and no tensor-core
work; one masked block load/store per program streams them at the card's
memory rate. ``m`` broadcasts over channels, the math is f32 (float64 for
float64 inputs, which a float64 training step on the card passes), and the
output has ``x``'s dtype.

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
                         C: "tl.constexpr", BLOCK: "tl.constexpr",
                         UPCAST: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    valid = offs < n_elem
    x = tl.load(x_ptr + offs, mask=valid)
    f = tl.load(f_ptr + offs, mask=valid)
    m = tl.load(m_ptr + offs // C, mask=valid)
    if UPCAST:  # all but float64 inputs compute in f32
        x = x.to(tl.float32)
        f = f.to(tl.float32)
        m = m.to(tl.float32)
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
    """The same function in plain PyTorch (in float64 for float64)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    mf = m.to(ct)
    return (x.to(ct) * (1.0 - mf) + fake.to(ct) * mf).to(x.dtype)


class MaskedBlend(torch.autograd.Function):
    """``masked_blend`` under autograd: the forward is ``masked_blend``
    (the kernel on CUDA tensors), the backward plain PyTorch in f32
    (float64 for float64 inputs):
    ``dx = g (1 - m)``, ``dfake = g m``, ``dm = sum_c g (fake - x)``, each
    only where its input needs it."""

    @staticmethod
    def forward(ctx, x, fake, m):
        ctx.save_for_backward(x, fake, m)
        return masked_blend(x, fake, m)

    @staticmethod
    def backward(ctx, g):
        x, fake, m = ctx.saved_tensors
        need_x, need_fake, need_m = ctx.needs_input_grad
        ct = torch.promote_types(g.dtype, torch.float32)
        g, mf = g.to(ct), m.to(ct)
        dx = (g * (1.0 - mf)).to(x.dtype) if need_x else None
        dfake = (g * mf).to(fake.dtype) if need_fake else None
        dm = None
        if need_m:
            dm = (g * (fake.to(ct) - x.to(ct))).sum(-1, keepdim=True)
            dm = dm.to(m.dtype)
        return dx, dfake, dm


def masked_blend(x: torch.Tensor, fake: torch.Tensor,
                 m: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel, and anything it does not take raises. No gradient: see
    ``MaskedBlend``."""
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
        if t.dtype not in (torch.float32, torch.bfloat16, torch.float16,
                           torch.float64):
            raise TypeError(f"masked_blend takes floating tensors, got {t.dtype}")
    out = torch.empty_like(x)
    n = x.numel()
    kernel = _compiled()
    with torch.cuda.device(x.device):
        kernel[(-(-n // BLOCK),)](x, fake, m, out, n, C=x.shape[3],
                                         BLOCK=BLOCK,
                                         UPCAST=x.dtype != torch.float64,
                                         num_warps=4)
    launches["masked_blend"] += 1
    return out

