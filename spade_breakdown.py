#!/usr/bin/env python3
"""Where the bf16 ``spade_cond`` kernel spends its time, on one CUDA card.

    python3 spade_breakdown.py

Builds variants of ``climategan_torch/csrc/spade_cond.cu`` with one part of
the tensor-core kernel cut out (into ``climategan_torch/_build/breakdown/``)
and times each, device ms with a cold L2 as ``chip_smoke.py`` times kernels,
at four main-path shapes of the painter (batch 2, hid 128, random weights).
A variant's outputs are wrong by design; the difference from ``base`` is
what the part costs, overlap with the rest of the kernel included:
  no_window       the conditioning window is not loaded (zeros)
  no_stage1       no stage-1 products and epilogue
  no_stage2_math  the ring still streams the weights, no stage-2 wgmma
  no_epilogue2    the [gamma|beta] outputs are not stored
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms, smi  # noqa: E402
from climategan_torch.kernels import _build  # noqa: E402
from climategan_torch.kernels import spade_cond as sc  # noqa: E402

# (text in csrc/spade_cond.cu, its replacement)
VARIANTS = {
    "base": [],
    "no_window": [("if (i < SH && j < SW && y >= 0", "if (false && y >= 0")],
    "no_stage1": [("for (int mt = 0; mt < S1_TILES; ++mt) {",
                   "for (int mt = 0; mt < 0; ++mt) {")],
    "no_stage2_math": [("for (int ks = 0; ks < KPS; ++ks) {\n      Wgmma",
                        "for (int ks = 0; ks < 0; ++ks) {\n      Wgmma")],
    "no_epilogue2": [("if (y < H && x < W) {\n          __nv_bfloat16* o",
                      "if (y < 0) {\n          __nv_bfloat16* o")],
}
# (N, H, W, hids, ncs): the 640^2 nc 20 and dual (40, 40) calls, the 320^2
# dual (80, 80) call and head_0's 5^2 nc 640 call
SHAPES = [(2, 640, 640, (128,), (20,)), (2, 640, 640, (128, 128), (40, 40)),
          (2, 320, 320, (128, 128), (80, 80)), (2, 5, 5, (128,), (640,))]


def build(name, edits) -> ctypes.CDLL:
    src = (_build.CSRC / "spade_cond.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} is not in csrc/spade_cond.cu")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
                    str(out / f"{name}.cu")], check=True, capture_output=True)
    return ctypes.CDLL(str(out / f"{name}.so"))


def case(N, H, W, hids, ncs, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.3).bfloat16()

    branches = [(r(3, 3, h, nc), r(nc), r(3, 3, h, nc), r(nc))
                for h, nc in zip(hids, ncs)]
    seg = r(N, H, W, 3)
    return seg, sc.pack_spade_cond(r(3, 3, 3, sum(hids)), r(sum(hids)), branches)


def main() -> int:
    if not torch.cuda.is_available():
        print("spade_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(smi(), flush=True)
    libs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    cases = [case(*s) for s in SHAPES]
    typed = sc._lib()  # the real library, typed by the wrapper
    with torch.inference_mode():
        for name, lib in libs.items():
            for fn in ("spade_cond_tc_launch", "spade_cond_tc_smem_bytes",
                       "spade_cond_error_string"):
                getattr(lib, fn).argtypes = getattr(typed, fn).argtypes
                getattr(lib, fn).restype = getattr(typed, fn).restype
            sc._lib = lambda lib=lib: lib
            times = [device_ms(torch, lambda: sc.spade_cond_packed(seg, pack), reps=10)
                     for seg, pack in cases]
            print(f"{name:>15}: " + "  ".join(
                f"{H}^2 nc={list(ncs)} {t:.4f} ms"
                for (_, H, _, _, ncs), t in zip(SHAPES, times)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
