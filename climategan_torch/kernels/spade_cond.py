"""``spade_cond``: the fused SPADE conditioning MLP.

Replaces the Pallas TPU kernel ``climategan_tpu/ops/pallas/spade.py:
spade_cond``. The kernels are CUDA C++ for sm_90a in ``csrc/spade_cond.cu``,
bound through ``ctypes``. Their bound on an H100 is operations (about 1,150
FLOP per output byte at the painter's shapes). Both keep the hid-channel
activation of each 8x16 output tile in shared memory, so it never reaches
device memory:

* bf16 ("wgmma" route): both convs on the tensor cores, the second as an
  implicit GEMM on ``wgmma`` with the weights streamed through a ring of
  asynchronous bulk copies; the activation is rounded to bf16 before it, as
  the JAX kernel rounds it to its working dtype;
* f32 ("fma" route): the port's first, CUDA-core kernel, the correctness
  path (TF32 would not hold its 1e-4 bar).

The weights are packed once into the route's layout (``pack_spade_cond``),
when the model is built; ``spade_cond_packed`` runs on a pack.

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
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from climategan_torch.kernels import launches

Branch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
FMA_CHUNK = 64        # CHUNK in csrc/spade_cond.cu: the f32 kernel's N step
TILE = (8, 16)        # output tile of both kernels (TH, TW)
MIN_BLOCKS = 2 * 132  # the bf16 kernel: two resident blocks on each SM
MAX_BRANCHES = 4
MAX_CNC = 16          # the bf16 kernel's widest window pixel (CPT in csrc)


def taps_channels(cnc: int) -> Tuple[int, int]:
    """(taps, channels per tap) of the bf16 kernel's stage 1 for ``cnc``
    conditioning channels: (10, 8) up to 8, two taps a k16 step with a zero
    tenth; (9, 16) up to 16, one tap a step. K1 = taps x channels (80 or
    144), as ``k1_of`` in csrc/spade_cond.cu."""
    if cnc > MAX_CNC:
        raise ValueError(f"spade_cond: the bf16 kernel takes cnc <= {MAX_CNC}, "
                         f"got {cnc}")
    return (10, 8) if cnc <= 8 else (9, 16)


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


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def chunk_width(couts: Sequence[int]) -> int:
    """N of the bf16 kernel's wgmma: 40 when every branch has 2nc <= 40,
    else 80; a branch runs as ceil(2nc / N) chunks."""
    return 40 if max(couts) <= 40 else 80


def plan_groups(N: int, H: int, W: int, chunks: Sequence[int]) -> int:
    """Chunks per block of the bf16 kernel: all of a branch's chunks, halved
    until the grid has MIN_BLOCKS blocks or a block takes one chunk."""
    tiles = N * -(-H // TILE[0]) * -(-W // TILE[1])
    group = max(chunks)
    while group > 1 and tiles * sum(-(-c // group) for c in chunks) < MIN_BLOCKS:
        group = (group + 1) // 2
    return group


def block_chunks(chunks: Sequence[int], group: int) -> List[Tuple[int, int, int]]:
    """(branch, first chunk, end chunk) of each block along grid z within
    one image, decoded as the bf16 kernel decodes blockIdx.z."""
    out = []
    for b, c in enumerate(chunks):
        out += [(b, c0, min(c, c0 + group)) for c0 in range(0, c, group)]
    return out


@dataclass
class SpadePack:
    """The weights of one ``spade_cond`` call in a kernel's layout.

    ``args`` keeps (k1, b1, branches) in the JAX layout (views of the
    module's parameters where it can), for the plain version and checks.
    route "wgmma" (bf16 kernel): w1 flat, per branch (taps, cpt / 8,
    hid_pad, 8) with (taps, cpt) = ``taps_channels(cnc)``: element [tap, h,
    c, ci] is k1[tap // 3, tap % 3, 8 h + ci, c], zero for tap 9, channels
    >= cnc and c >= hid; b1 f32 (sum hid_pad,); per branch w2 (chunks, 9, hid_pad / 16,
    nt / 8, 2, 8, 8): element [c, tap, ks, g, h, r, e] is [kg|kb][tap,
    16 ks + 8 h + e, nt c + 8 g + r], zero-padded; b2 f32 (chunks * nt,).
    route "fma" (f32 kernel): w1 = k1 and b1 contiguous; per branch w2 =
    [kg|kb] (3, 3, hid, cpad) with cpad a multiple of FMA_CHUNK, b2 = [bg|bb].
    """
    route: str
    args: Tuple[torch.Tensor, torch.Tensor, List[Branch]]
    hids: List[int]
    couts: List[int]
    w1: torch.Tensor
    b1: torch.Tensor
    w2: List[torch.Tensor]
    b2: List[torch.Tensor]
    hid_pads: List[int]
    nt: int = 0
    chunks: Tuple[int, ...] = ()


def _check(seg, k1, b1, branches):
    dev, dt = seg.device, seg.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spade_cond takes float32 or bfloat16, got {dt}")
    if seg.ndim != 4:
        raise ValueError(f"seg must be (N, H, W, cnc), got {tuple(seg.shape)}")
    cnc = seg.shape[3]
    hid_total = k1.shape[-1]
    if tuple(k1.shape) != (3, 3, cnc, hid_total) or tuple(b1.shape) != (hid_total,):
        raise ValueError(f"k1/b1 must be (3, 3, {cnc}, hid)/(hid,), got "
                         f"{tuple(k1.shape)}/{tuple(b1.shape)}")
    if not 1 <= len(branches) <= MAX_BRANCHES:
        raise ValueError(f"spade_cond takes 1..{MAX_BRANCHES} branches, got "
                         f"{len(branches)}")
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
    if not seg.is_contiguous():
        raise ValueError("spade_cond needs a contiguous seg")


@torch.no_grad()
def pack_spade_cond(k1: torch.Tensor, b1: torch.Tensor,
                    branches: Sequence[Branch], route: str = None) -> SpadePack:
    """Packs the weights of one call for a kernel: route "wgmma" (default
    for bf16) or "fma" (default for f32). Zero-padding hid to a multiple of
    32 and each tap's cnc channels to 8 or 16 is exact; a "wgmma" pack
    takes cnc <= 16, and what the kernel cannot hold raises at launch."""
    route = route or ("wgmma" if k1.dtype == torch.bfloat16 else "fma")
    cnc = k1.shape[2]
    hids = [kg.shape[2] for kg, _, _, _ in branches]
    couts = [2 * kg.shape[3] for kg, _, _, _ in branches]
    args = (k1, b1, list(branches))
    w2s = [torch.cat([kg, kb], dim=-1) for kg, _, kb, _ in branches]
    b2s = [torch.cat([bg, bb]) for _, bg, _, bb in branches]
    if route == "fma":
        w2s = [F.pad(w, (0, _up(c, FMA_CHUNK) - c)).contiguous()
               for w, c in zip(w2s, couts)]
        return SpadePack(route, args, hids, couts, k1.contiguous(),
                         b1.contiguous(), w2s, [b.contiguous() for b in b2s],
                         hids)
    if route != "wgmma":
        raise ValueError(f"unknown spade_cond route {route!r}")
    taps, cpt = taps_channels(cnc)
    nt = chunk_width(couts)
    hid_pads = [_up(h, 32) for h in hids]
    chunks = tuple(-(-c // nt) for c in couts)
    w1s, b1s, off = [], [], 0
    for h, hp in zip(hids, hid_pads):
        w = F.pad(k1[..., off:off + h].reshape(9, cnc, h),
                  (0, hp - h, 0, cpt - cnc, 0, taps - 9))
        w1s.append(w.reshape(taps, cpt // 8, 8, hp).transpose(2, 3).reshape(-1))
        b1s.append(F.pad(b1[off:off + h].float(), (0, hp - h)))
        off += h
    packed_w2, packed_b2 = [], []
    for w, b, h, hp, c, nch in zip(w2s, b2s, hids, hid_pads, couts, chunks):
        w = F.pad(w, (0, nch * nt - c, 0, hp - h)).reshape(
            9, hp // 16, 2, 8, nch, nt // 8, 8)
        packed_w2.append(w.permute(4, 0, 1, 5, 2, 6, 3).contiguous())
        packed_b2.append(F.pad(b.float(), (0, nch * nt - c)))
    return SpadePack(route, args, hids, couts, torch.cat(w1s), torch.cat(b1s),
                     packed_w2, packed_b2, hid_pads, nt, chunks)


def spade_cond_packed_plain(seg: torch.Tensor, pack: SpadePack) -> List[torch.Tensor]:
    """The plain version of ``spade_cond_packed``. A "wgmma" pack is read as
    the kernel reads it: the 9 taps' 8- or 16-channel windows times the
    packed w1,
    the activation rounded to seg's dtype, then per tap a product with the
    unpacked w2, summed in f32; an "fma" pack is the f32 kernel's layout
    (``[kg|kb]`` padded), so its plain version is ``spade_cond_plain`` on the
    pack's own arguments."""
    if pack.route == "fma":
        return spade_cond_plain(seg, *pack.args)
    N, H, W, cnc = seg.shape
    dt = seg.dtype
    taps, cpt = taps_channels(cnc)
    k1 = taps * cpt
    x = F.pad(seg.float(), (0, cpt - cnc, 1, 1, 1, 1))
    cols = torch.cat([x[:, ky:ky + H, kx:kx + W] for ky in range(3)
                      for kx in range(3)], dim=-1)
    cols = F.pad(cols, (0, k1 - 9 * cpt))
    outs, off = [], 0
    for w2, b2, hp, cout in zip(pack.w2, pack.b2, pack.hid_pads, pack.couts):
        w1 = pack.w1[off * k1:(off + hp) * k1].float()
        w1 = w1.reshape(taps, cpt // 8, hp, 8).permute(2, 0, 1, 3).reshape(hp, k1)
        act = torch.relu(cols @ w1.t() + pack.b1[off:off + hp]).to(dt).float()
        a = F.pad(act, (0, 0, 1, 1, 1, 1))
        w = w2.float().permute(1, 2, 4, 6, 0, 3, 5).reshape(9, hp, -1)
        acc = sum(a[:, ky:ky + H, kx:kx + W] @ w[3 * ky + kx]
                  for ky in range(3) for kx in range(3))
        outs.append((acc + b2)[..., :cout].to(dt).contiguous())
        off += hp
    return outs


def _lib():
    from climategan_torch.kernels import _build

    lib = _build.load("spade_cond")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        ip, pp = ctypes.POINTER(i), ctypes.POINTER(p)
        lib.spade_cond_launch.argtypes = [
            p, p, p, i, i, i, i, i, i, ip, ip, ip, pp, pp, pp, p]
        lib.spade_cond_launch.restype = i
        lib.spade_cond_smem_bytes.argtypes = [i, i]
        lib.spade_cond_smem_bytes.restype = ctypes.c_longlong
        lib.spade_cond_tc_launch.argtypes = [
            p, p, p, i, i, i, i, i, i, ip, ip, ip, pp, pp, pp, i, p]
        lib.spade_cond_tc_launch.restype = i
        lib.spade_cond_tc_smem_bytes.argtypes = [i, i, i]
        lib.spade_cond_tc_smem_bytes.restype = ctypes.c_longlong
        lib.spade_cond_error_string.argtypes = [i]
        lib.spade_cond_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def spade_cond_packed(seg: torch.Tensor, pack: SpadePack) -> List[torch.Tensor]:
    """Per-branch [gamma | beta] maps from packed weights. CPU tensors take
    the plain version; a CUDA bf16 seg launches the tensor-core kernel on a
    "wgmma" pack and a CUDA f32 seg the CUDA-core kernel on an "fma" pack;
    anything else raises."""
    if seg.device.type == "cpu":
        return spade_cond_packed_plain(seg, pack)
    if seg.device.type != "cuda":
        raise ValueError(f"spade_cond runs on cuda or cpu, not {seg.device}")
    _check(seg, *pack.args)
    want = {torch.bfloat16: "wgmma", torch.float32: "fma"}[seg.dtype]
    if pack.route != want:
        raise ValueError(f"a {seg.dtype} seg needs a {want!r} pack, got "
                         f"{pack.route!r}")
    for t in [pack.w1, pack.b1, *pack.w2, *pack.b2]:
        if t.device != seg.device:
            raise ValueError("the pack lies on another device than seg")
    lib = _lib()
    N, H, W, cnc = seg.shape
    nb = len(pack.w2)
    if pack.route == "wgmma":
        if len(set(pack.hid_pads)) != 1 or pack.hid_pads[0] > 128:
            raise ValueError("spade_cond: the bf16 kernel takes branches of one "
                             f"hid padded to 32, at most 128; got {pack.hids}")
        smem = lib.spade_cond_tc_smem_bytes(max(pack.hid_pads), pack.nt, cnc)
    else:
        smem = lib.spade_cond_smem_bytes(max(pack.hids), cnc)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"spade_cond: hid {max(pack.hids)} with cnc {cnc} "
                         f"needs {smem} B of shared memory, more than "
                         f"{_SMEM_LIMIT}")
    outs = [torch.empty((N, H, W, c), device=seg.device, dtype=seg.dtype)
            for c in pack.couts]
    ints, ptrs = ctypes.c_int * nb, ctypes.c_void_p * nb
    w2p = ptrs(*[t.data_ptr() for t in pack.w2])
    b2p = ptrs(*[t.data_ptr() for t in pack.b2])
    outp = ptrs(*[t.data_ptr() for t in outs])
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        if pack.route == "wgmma":
            err = lib.spade_cond_tc_launch(
                seg.data_ptr(), pack.w1.data_ptr(), pack.b1.data_ptr(),
                N, H, W, cnc, pack.nt, nb, ints(*pack.hid_pads),
                ints(*pack.couts), ints(*pack.chunks), w2p, b2p, outp,
                plan_groups(N, H, W, pack.chunks), stream)
        else:
            err = lib.spade_cond_launch(
                seg.data_ptr(), pack.w1.data_ptr(), pack.b1.data_ptr(),
                N, H, W, cnc, sum(pack.hids), nb, ints(*pack.hids),
                ints(*pack.couts), ints(*[w.shape[-1] for w in pack.w2]),
                w2p, b2p, outp, stream)
    if err != 0:
        raise RuntimeError("spade_cond launch failed: "
                           + lib.spade_cond_error_string(err).decode())
    launches["spade_cond"] += 1
    return outs


def spade_cond(seg: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
               branches: Sequence[Branch]) -> List[torch.Tensor]:
    """The JAX signature: packs for seg's dtype, then ``spade_cond_packed``.
    CPU tensors take the plain version."""
    if seg.device.type == "cpu":
        return spade_cond_plain(seg, k1, b1, branches)
    _check(seg, k1, b1, branches)
    return spade_cond_packed(seg, pack_spade_cond(k1, b1, branches))
