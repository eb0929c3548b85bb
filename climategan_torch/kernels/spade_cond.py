"""``spade_cond``: the fused SPADE conditioning MLP.

Replaces the Pallas TPU kernel ``climategan_tpu/ops/pallas/spade.py:
spade_cond``. The kernel is CUDA C++ for sm_90a in ``csrc/spade_cond.cu``,
bound through ``ctypes``. Its bound on an H100 is operations (about 1,150
FLOP per output byte at the painter's shapes); this first version sums on
the CUDA cores in f32 and keeps the hid-channel activation of each 8x16
output tile in shared memory, so it never reaches device memory. Tensor-core
(wgmma) work is left for a later version.

Layout, as in the JAX function:
    seg  (N, H, W, cnc)              conditioning map at the SPADE's size
    k1   (3, 3, cnc, sum(hid_b))     concatenated mlp_shared kernels (HWIO)
    b1   (sum(hid_b),)
    branches: [(kg, bg, kb, bb)], kg/kb (3, 3, hid_b, nc_b), bg/bb (nc_b,);
              branch b reads channels [sum hid_<b, sum hid_<=b) of the
              shared activation
    returns [(N, H, W, 2 * nc_b)] per branch, channels [gamma | beta], in
    seg's dtype.
Both convs pad with zeros (the activation is 0 outside the image).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from climategan_torch.kernels import launches

Branch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90


def spade_cond_plain(seg: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
                     branches: Sequence[Branch]) -> List[torch.Tensor]:
    """The same function with ``F.conv2d``, in the inputs' dtype."""
    x = seg.permute(0, 3, 1, 2)
    act = F.relu(F.conv2d(x, k1.permute(3, 2, 0, 1), b1, padding=1))
    outs, off = [], 0
    for kg, bg, kb, bb in branches:
        hid = kg.shape[2]
        w = torch.cat([kg, kb], dim=-1).permute(3, 2, 0, 1)
        gb = F.conv2d(act[:, off:off + hid], w, torch.cat([bg, bb]), padding=1)
        outs.append(gb.permute(0, 2, 3, 1).contiguous())
        off += hid
    return outs


def _lib():
    from climategan_torch.kernels import _build

    lib = _build.load("spade_cond")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spade_cond_launch.argtypes = [
            i, p, p, p, i, i, i, i, i, i,
            ctypes.POINTER(i), ctypes.POINTER(i), ctypes.POINTER(i),
            ctypes.POINTER(p), ctypes.POINTER(p), ctypes.POINTER(p), p]
        lib.spade_cond_launch.restype = i
        lib.spade_cond_chunk.restype = i
        lib.spade_cond_max_branches.restype = i
        lib.spade_cond_smem_bytes.argtypes = [i, i]
        lib.spade_cond_smem_bytes.restype = ctypes.c_longlong
        lib.spade_cond_error_string.argtypes = [i]
        lib.spade_cond_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(seg, k1, b1, branches):
    dev, dt = seg.device, seg.dtype
    if dt not in _DTYPES:
        raise TypeError(f"spade_cond takes float32 or bfloat16, got {dt}")
    if seg.ndim != 4:
        raise ValueError(f"seg must be (N, H, W, cnc), got {tuple(seg.shape)}")
    cnc = seg.shape[3]
    hid_total = k1.shape[-1]
    if tuple(k1.shape) != (3, 3, cnc, hid_total) or tuple(b1.shape) != (hid_total,):
        raise ValueError(f"k1/b1 must be (3, 3, {cnc}, hid)/(hid,), got "
                         f"{tuple(k1.shape)}/{tuple(b1.shape)}")
    tensors = [seg, k1, b1]
    for kg, bg, kb, bb in branches:
        hid, nc = kg.shape[2], kg.shape[3]
        if (tuple(kg.shape) != (3, 3, hid, nc) or kb.shape != kg.shape
                or tuple(bg.shape) != (nc,) or tuple(bb.shape) != (nc,)):
            raise ValueError("branch weights must be kg/kb (3, 3, hid, nc) "
                             "and bg/bb (nc,)")
        tensors += [kg, bg, kb, bb]
    if sum(kg.shape[2] for kg, _, _, _ in branches) != hid_total:
        raise ValueError("branch hidden widths must sum to k1's channels")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError("spade_cond needs every tensor on one device "
                             f"in one dtype ({dev}, {dt})")
    if not seg.is_contiguous() or not k1.is_contiguous() or not b1.is_contiguous():
        raise ValueError("spade_cond needs contiguous seg, k1 and b1")


def spade_cond(seg: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
               branches: Sequence[Branch]) -> List[torch.Tensor]:
    """Per-branch [gamma | beta] maps; see the module docstring for the
    layout. CPU tensors take the plain version; CUDA tensors launch the
    kernel, and anything the kernel does not take raises."""
    if seg.device.type == "cpu":
        return spade_cond_plain(seg, k1, b1, branches)
    if seg.device.type != "cuda":
        raise ValueError(f"spade_cond runs on cuda or cpu, not {seg.device}")
    _check(seg, k1, b1, branches)
    lib = _lib()
    nb = len(branches)
    if not 1 <= nb <= lib.spade_cond_max_branches():
        raise ValueError(f"spade_cond takes 1..{lib.spade_cond_max_branches()} "
                         f"branches, got {nb}")
    N, H, W, cnc = seg.shape
    hids = [kg.shape[2] for kg, _, _, _ in branches]
    smem = lib.spade_cond_smem_bytes(max(hids), cnc)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"spade_cond: hid {max(hids)} with cnc {cnc} needs "
                         f"{smem} B of shared memory, more than {_SMEM_LIMIT}")
    chunk = lib.spade_cond_chunk()
    couts, cpads, w2s, b2s, outs = [], [], [], [], []
    for kg, bg, kb, bb in branches:
        cout = 2 * kg.shape[3]
        cpad = -(-cout // chunk) * chunk
        w2 = F.pad(torch.cat([kg, kb], dim=-1), (0, cpad - cout)).contiguous()
        couts.append(cout)
        cpads.append(cpad)
        w2s.append(w2)
        b2s.append(torch.cat([bg, bb]).contiguous())
        outs.append(torch.empty((N, H, W, cout), device=seg.device, dtype=seg.dtype))

    ints = ctypes.c_int * nb
    ptrs = ctypes.c_void_p * nb
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        err = lib.spade_cond_launch(
            _DTYPES[seg.dtype], seg.data_ptr(), k1.data_ptr(), b1.data_ptr(),
            N, H, W, cnc, k1.shape[-1], nb,
            ints(*hids), ints(*couts), ints(*cpads),
            ptrs(*[t.data_ptr() for t in w2s]),
            ptrs(*[t.data_ptr() for t in b2s]),
            ptrs(*[t.data_ptr() for t in outs]), stream)
    if err != 0:
        raise RuntimeError("spade_cond launch failed: "
                           + lib.spade_cond_error_string(err).decode())
    launches["spade_cond"] += 1
    return outs
