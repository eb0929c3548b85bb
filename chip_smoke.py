#!/usr/bin/env python3
"""Smoke test of the PyTorch port (climategan_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero:
  1. print the card's name and power limit; build the kernels from the
     sources in the checkout (one nvcc per CUDA source, started together;
     Triton compiles at its first launch);
  2. drive one full-width 640^2 bf16 flood forward (default opts: ResNet-101
     os8, DADA depth, DeepLabV3+, base mask decoder, SPADE painter with
     latent 640 and 7 upsamplings; random weights from a seed) with each
     kernel wrapper recording its arguments, then hold each kernel to its
     plain PyTorch version on exactly those inputs: in f32 (cuDNN TF32 off)
     at atol = rtol = 1e-4, and in bf16 against the plain version in f32 on
     the same bf16 inputs within one bf16 ulp of each output's largest
     magnitude (the kernel sums in f32 and rounds once at the end);
  3. the main path: launch counts set to 0, one flood forward through
     build_infer_fn, counts read: 18 spade_cond launches and 1 masked_blend
     launch; outputs finite, of the expected shapes and dtypes;
  4. card vs CPU: the same model in f32 at 256^2 with device="cuda"
     (kernels) and device="cpu" (plain versions): masks within atol 1e-3,
     uint8 floods within 1 LSB on >= 99.9% of pixels (smooth masks);
  5. timings: flood latency and images/s, the masker's share, and per
     kernel its time over the main path's calls beside the plain version,
     one PyTorch library call computing the same function, and the bound.
The last three lines are the card's name and power limit, the kernels JSON
line, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BATCH = 2
SIZE = 640
SMALL = 256


def log(*args):
    print(*args, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(torch, fn, reps: int = 5) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_table(torch, fn, rows: int = 15) -> str:
    """torch.profiler over one call: the ops with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="self_device_time_total",
                                     row_limit=rows, max_name_column_width=60)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "climategan_torch" / "csrc").is_dir():
        print("chip_smoke: climategan_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    with torch.inference_mode():
        return run(torch)


def run(torch) -> int:
    import torch.nn.functional as F

    from climategan_torch import kernels
    from climategan_torch.inference import build_infer_fn
    from climategan_torch.kernels import _build
    from climategan_torch.kernels.masked_blend import (
        masked_blend,
        masked_blend_plain,
    )
    from climategan_torch.kernels.spade_cond import spade_cond, spade_cond_plain
    from climategan_torch.models import generator as generator_mod
    from climategan_torch.models import norms as norms_mod
    from climategan_torch.utils.opts import load_opts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    card = smi()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda)

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"nvcc build: {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    t0 = time.perf_counter()
    z = torch.zeros(1, 1, 1, 3, device=dev)
    masked_blend(z, z, z[..., :1])
    torch.cuda.synchronize()
    log(f"triton build (first launch): {time.perf_counter() - t0:.2f} s")

    opts = load_opts()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand(BATCH, SIZE, SIZE, 3, device=dev, generator=g) * 2 - 1
    uniform = torch.rand(9, 9, device=dev, generator=g)
    t0 = time.perf_counter()
    G, infer = build_infer_fn(opts, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in G.parameters())
    log(f"full-width model: {n_params / 1e6:.1f}M params, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 2. kernels vs plain on the main path's own inputs --------------
    calls = {"spade_cond": [], "masked_blend": []}

    def record_spade(seg, k1, b1, branches):
        calls["spade_cond"].append((seg, k1, b1, list(branches)))
        return spade_cond(seg, k1, b1, branches)

    def record_blend(x_, fake, m):
        calls["masked_blend"].append((x_, fake, m))
        return masked_blend(x_, fake, m)

    norms_mod.spade_cond, generator_mod.masked_blend = record_spade, record_blend
    try:
        infer(x, uniform=uniform)
    finally:
        norms_mod.spade_cond, generator_mod.masked_blend = spade_cond, masked_blend
    torch.cuda.synchronize()
    log(f"recorded {len(calls['spade_cond'])} spade_cond and "
        f"{len(calls['masked_blend'])} masked_blend calls")

    def f32(args):
        seg, k1, b1, branches = args
        return (seg.float(), k1.float(), b1.float(),
                [tuple(t.float() for t in b) for b in branches])

    err = {"spade_cond": [0.0, 0.0], "masked_blend": [0.0, 0.0]}
    for i, args in enumerate(calls["spade_cond"]):
        seg, _, _, branches = args
        shape = (f"{tuple(seg.shape)} nc={[b[0].shape[3] for b in branches]}")
        a32 = f32(args)
        for got, want in zip(spade_cond(*a32), spade_cond_plain(*a32)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            err["spade_cond"][0] = max(err["spade_cond"][0],
                                       (got - want).abs().max().item())
        for got, want in zip(spade_cond(*args), spade_cond_plain(*a32)):
            ulp = 2.0 ** (torch.floor(torch.log2(want.abs().max())).item() - 7)
            e = (got.float() - want).abs().max().item()
            if not e <= ulp:
                raise AssertionError(f"spade_cond bf16 call {i} {shape}: "
                                     f"max error {e} > one ulp {ulp}")
            err["spade_cond"][1] = max(err["spade_cond"][1], e)
    for xb, fb, mb in calls["masked_blend"]:
        a32 = (xb.float(), fb.float(), mb.float())
        e = (masked_blend(*a32) - masked_blend_plain(*a32)).abs().max().item()
        if not e <= 1e-6:
            raise AssertionError(f"masked_blend f32 max error {e}")
        err["masked_blend"][0] = max(err["masked_blend"][0], e)
        got, want = masked_blend(xb, fb, mb).float(), masked_blend_plain(*a32)
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().max())).item() - 7)
        e = (got - want).abs().max().item()
        if not e <= ulp:
            raise AssertionError(f"masked_blend bf16 max error {e} > {ulp}")
        err["masked_blend"][1] = max(err["masked_blend"][1], e)
    torch.cuda.synchronize()
    log(f"kernels vs plain: spade_cond max err f32 {err['spade_cond'][0]:.3e} "
        f"bf16 {err['spade_cond'][1]:.3e}; masked_blend f32 "
        f"{err['masked_blend'][0]:.3e} bf16 {err['masked_blend'][1]:.3e}")

    # ---- 3. the main path ----------------------------------------------
    kernels.reset_launches()
    out = infer(x, uniform=uniform)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    log(f"main path launches: {launches}")
    if launches != {"spade_cond": 18, "masked_blend": 1}:
        raise AssertionError(f"expected 18 spade_cond and 1 masked_blend "
                             f"launches, got {launches}")
    flood, mask = out["flood"], out["mask"]
    if flood.shape != (BATCH, SIZE, SIZE, 3) or flood.dtype != torch.uint8:
        raise AssertionError(f"flood {tuple(flood.shape)} {flood.dtype}")
    if mask.shape != (BATCH, SIZE, SIZE, 1) or mask.dtype != torch.bfloat16:
        raise AssertionError(f"mask {tuple(mask.shape)} {mask.dtype}")
    if not torch.isfinite(mask.float()).all() or not (0 <= mask.min() <= mask.max() <= 1):
        raise AssertionError("mask is not finite in [0, 1]")
    log(f"flood ok: uint8 range [{flood.min().item()}, {flood.max().item()}], "
        f"mask mean {mask.float().mean().item():.4f}")

    # ---- 4. card vs CPU at 256^2, f32 ------------------------------------
    xs = torch.rand(1, SMALL, SMALL, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    us = torch.rand(9, 9, generator=torch.Generator().manual_seed(3))
    res = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _, inf = build_infer_fn(opts, dtype=torch.float32, bin_value=-1,
                                device=where, seed=0)
        res[where] = {k: v.cpu() for k, v in inf(xs, uniform=us).items()}
        log(f"256^2 f32 flood on {where}: {time.perf_counter() - t0:.1f} s "
            f"(incl. model build)")
    mask_err = (res["cuda"]["mask"] - res["cpu"]["mask"]).abs().max().item()
    lsb = (res["cuda"]["flood"].int() - res["cpu"]["flood"].int()).abs()
    within = (lsb <= 1).float().mean().item()
    log(f"card vs CPU: mask max err {mask_err:.3e}, flood within 1 LSB on "
        f"{100 * within:.4f}% of pixels (max {lsb.max().item()} LSB)")
    if not mask_err <= 1e-3 or not within >= 0.999:
        raise AssertionError("card and CPU disagree")

    # ---- 5. timings ------------------------------------------------------
    flood_ms = cuda_ms(torch, lambda: infer(x, uniform=uniform), reps=3)
    xc = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()
    masker_ms = cuda_ms(torch, lambda: G.infer_masker(xc), reps=3)
    log(f"flood 640^2 bf16 batch {BATCH}: {flood_ms:.2f} ms per batch, "
        f"{1000 * BATCH / flood_ms:.3f} images/s; masker {masker_ms:.2f} ms, "
        f"painter + paste + quantize {flood_ms - masker_ms:.2f} ms")
    log(profile_table(torch, lambda: infer(x, uniform=uniform)))

    def library_spade(seg, k1, b1, branches):
        xs_ = seg.permute(0, 3, 1, 2)
        off, outs = 0, []
        for kg, bg, kb, bb in branches:
            hid = kg.shape[2]
            a = F.relu(F.conv2d(xs_, k1[..., off:off + hid].permute(3, 2, 0, 1),
                                b1[off:off + hid], padding=1))
            outs.append(F.conv2d(a, torch.cat([kg, kb], -1).permute(3, 2, 0, 1),
                                 torch.cat([bg, bb]), padding=1))
            off += hid
        return outs

    def bound_spade(seg, k1, b1, branches):
        N, H, W, cnc = seg.shape
        px = N * H * W
        flops = sum(2 * 9 * px * (cnc * kg.shape[2] + kg.shape[2] * 2 * kg.shape[3])
                    for kg, _, _, _ in branches)
        nbytes = sum(t.numel() * t.element_size() for t in
                     [seg, k1, b1] + [u for b in branches for u in b])
        nbytes += sum(px * 2 * kg.shape[3] * seg.element_size()
                      for kg, _, _, _ in branches)
        peak = PEAK_BF16_FLOPS if seg.dtype == torch.bfloat16 else PEAK_F32_FLOPS
        return flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3

    rows = []
    t_sc = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    ops_ms = bytes_ms = 0.0
    per_call = []
    for args in calls["spade_cond"]:
        k = cuda_ms(torch, lambda: spade_cond(*args))
        p = cuda_ms(torch, lambda: spade_cond_plain(*args))
        lib = cuda_ms(torch, lambda: library_spade(*args))
        t_ops, t_bytes = bound_spade(*args)
        b = max(t_ops, t_bytes)
        ops_ms += t_ops
        bytes_ms += t_bytes
        t_sc["ms"] += k
        t_sc["plain_ms"] += p
        t_sc["library_ms"] += lib
        t_sc["bound_ms"] += b
        seg = args[0]
        per_call.append(f"  spade_cond {tuple(seg.shape)} "
                        f"nc={[br[0].shape[3] for br in args[3]]}: kernel {k:.3f} "
                        f"plain {p:.3f} library {lib:.3f} bound {b:.4f} ms")
    for line in per_call:
        log(line)
    log(f"spade_cond bound terms summed over the calls: operations "
        f"{ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms")
    rows.append({
        "name": "spade_cond", "route": "cuda",
        "source": "climategan_torch/csrc/spade_cond.cu",
        "replaces": "climategan_tpu/ops/pallas/spade.py:119",
        "launches": launches["spade_cond"],
        "max_abs_err": err["spade_cond"][0],
        "max_abs_err_bf16": err["spade_cond"][1],
        "ms": t_sc["ms"], "plain_ms": t_sc["plain_ms"],
        "bound_ms": t_sc["bound_ms"],
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": t_sc["library_ms"],
        "note": "ms summed over the 18 calls of one batch-2 forward",
    })

    xb, fb, mb = calls["masked_blend"][0]
    nbytes = sum(t.numel() * t.element_size() for t in (xb, fb, mb)) \
        + xb.numel() * xb.element_size()
    b_bytes = nbytes / PEAK_BYTES
    b_ops = 3 * xb.numel() / PEAK_F32_FLOPS
    rows.append({
        "name": "masked_blend", "route": "triton",
        "source": "climategan_torch/kernels/masked_blend.py",
        "replaces": "climategan_tpu/ops/pallas/events.py:198",
        "launches": launches["masked_blend"],
        "max_abs_err": err["masked_blend"][0],
        "max_abs_err_bf16": err["masked_blend"][1],
        "ms": cuda_ms(torch, lambda: masked_blend(xb, fb, mb), reps=20),
        "plain_ms": cuda_ms(torch, lambda: masked_blend_plain(xb, fb, mb), reps=20),
        "bound_ms": max(b_bytes, b_ops) * 1e3,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": cuda_ms(torch, lambda: torch.lerp(xb, fb, mb), reps=20),
    })
    for r in rows:
        log(f"{r['name']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
            f"ms, library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']})")

    log(smi())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
