#!/usr/bin/env python3
"""What holds ``smog_tail`` and ``fire_color_grade`` back, on one CUDA card.

    python3 events_breakdown.py [--parent PATH/TO/events.cu]

Builds variants of ``climategan_torch/csrc/events.cu`` (into
``climategan_torch/_build/events_breakdown/``, one nvcc each, all started
together) and times both kernels in each, device ms with a cold L2 as
``chip_smoke.py`` times kernels, at the main path's size (batch 2, 640^2,
float32). A variant's outputs are wrong by design:
  base                the kernels as shipped
  copy_only           the same 16-byte loads and stores, no math: the
                      card's floor for these bytes at this size
  math_only           the same math on values made from the index; no
                      loads, the stores kept only under a condition that
                      never holds
  library_exp2_log2   smog_tail's powers on exp2f and __log2f (the same
                      hardware instructions, with subnormal scaling steps)
  accurate_exp2_log2  the same on exp2f and the accurate log2f
  branches            smog_tail's two curves as branches, not selects
  empty               both kernels return at once: the launch and timing
                      floor
  idx32               32-bit indices (valid below 2^31 elements), against
                      the shipped 64-bit ones
  data_grid           a grid sized to the data (one block per 256 threads'
                      work, as fire_paste's) in place of one wave of the
                      card, the same loops and loads
  parent              --parent's source, a version with the same C
                      interface
The variants are timed in turns (in order, then in reverse) after a pass
that warms the card. Then the host time of the event wrappers: us per call
of each part of a call at a tiny size (so that the device keeps up), among
them the device context and the stream object that the launch path no
longer uses; and, where the toolkit has ``cuobjdump``, the SASS
instructions of each kernel in ``base``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms, smi  # noqa: E402
from climategan_torch.kernels import _build, _events  # noqa: E402
from climategan_torch.kernels.fire_color_grade import fire_color_grade  # noqa: E402
from climategan_torch.kernels.fire_paste import fire_paste  # noqa: E402
from climategan_torch.kernels.smog_tail import _constants, smog_tail  # noqa: E402

SMOG = dict(airlight=0.76, beta=2.0, yellow=(224.0, 192.0, 29.0), alpha=20.0)
FAKE_LOAD = """
__device__ __forceinline__ float4 fake_ldg(const float4* p) {
  const float f =
      static_cast<float>(reinterpret_cast<std::uintptr_t>(p) & 0xffff) * 1.5e-5f;
  return make_float4(f, f + 0.1f, f + 0.2f, f + 0.3f);
}
"""
# (text in csrc/events.cu, its replacement)
VARIANTS = {
    "base": [],
    "copy_only": [
        ("float4& b, const SmogParams& p) {\n",
         "float4& b, const SmogParams& p) {\n"
         "  r.x += d.x; r.y += d.y; r.z += d.z; r.w += d.w;\n  return;\n"),
        ("float shift, float brightness) {\n  return make_float4(",
         "float shift, float brightness) {\n  return v;\n  return make_float4("),
    ],
    "math_only": [
        ("void st4(float4* p, float4 v) { *p = v; }",
         "void st4(float4* p, float4 v) {\n"
         "  if (v.x + v.y + v.z + v.w == -7.f) *p = v;\n}"
         + FAKE_LOAD),
        ("__ldg(", "fake_ldg("),
    ],
    "library_exp2_log2": [
        ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = exp2f(x);"),
        ('asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = __log2f(x);")],
    "accurate_exp2_log2": [
        ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = exp2f(x);"),
        ('asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = log2f(x);")],
    "branches": [
        ("  const float hi = ex2(2.4f * lg2((x + 0.055f) * kInv1055));\n"
         "  return x <= 0.04045f ? x * kInv1292 : hi;",
         "  if (x <= 0.04045f) return x * kInv1292;\n"
         "  return ex2(2.4f * lg2((x + 0.055f) * kInv1055));"),
        ("  const float base = x < 1e-12f",
         "  if (x <= 0.0031308f) return 12.92f * x;\n  const float base = x < 1e-12f"),
        ("  const float hi = 1.055f * ex2(lg2(base) * kInvGamma) - 0.055f;\n"
         "  return x <= 0.0031308f ? 12.92f * x : hi;",
         "  return 1.055f * ex2(lg2(base) * kInvGamma) - 0.055f;"),
    ],
    "empty": [("SmogParams p) {\n", "SmogParams p) {\n  return;\n"),
              ("float brightness) {\n  const float shift",
               "float brightness) {\n  return;\n  const float shift")],
    "idx32": [("using Index = unsigned long long;", "using Index = unsigned;")],
    "data_grid": [("int* blocks) {\n",
                   "int* blocks) {\n  *blocks = blocks_for(work);\n"
                   "  return cudaSuccess;\n")],
}
KERNELS = ("smog_tail", "fire_color_grade")


def sources(parent):
    src = (_build.CSRC / "events.cu").read_text()
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in csrc/events.cu")
            text = text.replace(old, new)
        out[name] = text
    if parent:
        out["parent"] = Path(parent).read_text()
    return out


def build(texts):
    """One nvcc per variant, all started together; {name: (lib, path)}."""
    out = _build.BUILD_DIR / "events_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        libs[name] = (ctypes.CDLL(str(out / f"{name}.so")), out / f"{name}.so")
    return libs


def inputs(N=2, H=640, W=640, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x01 = torch.rand(N, 3, H, W, generator=g, device="cuda")
    d = torch.rand(N, 1, H, W, generator=g, device="cuda") * 0.9 + 0.1
    x255 = torch.floor(torch.rand(N, 3, H, W, generator=g, device="cuda") * 256)
    mean = torch.tensor(97.3, device="cuda")
    sky = torch.rand(N, 1, H, W, generator=g, device="cuda")
    g_value = torch.tensor(120.0, device="cuda")
    return {"smog_tail": lambda: smog_tail(x01, d, **SMOG),
            "fire_color_grade": lambda: fire_color_grade(x255, mean, 1.5, 0.73),
            "fire_paste": lambda: fire_paste(x255, sky, g_value, 200.0, 0.8)}, \
        (x01, d, x255, mean)


def host_us(fn, n=2000):
    """Host us per call of ``fn`` over n calls, after a warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def host_parts():
    """us per call of the parts of an event wrapper's call, at (1, 8, 8)."""
    calls, (x, d, x255, mean) = inputs(1, 8, 8, seed=1)
    out = torch.empty_like(x)
    nb, keep, tint = _constants(SMOG["beta"], SMOG["yellow"], SMOG["alpha"])
    launch = _events._FNS["smog_tail"]
    raw = torch._C._cuda_getCurrentRawStream
    idx = x.get_device()

    def old_context():
        with torch.cuda.device(x.device):
            pass

    parts = {
        "smog_tail wrapper, whole": calls["smog_tail"],
        "fire_color_grade wrapper, whole": calls["fire_color_grade"],
        "fire_paste wrapper, whole": calls["fire_paste"],
        "check (smog_tail)": lambda: _events.check("smog_tail", x, d),
        "torch.empty_like": lambda: torch.empty_like(x),
        "_constants (smog_tail)": lambda: _constants(
            SMOG["beta"], SMOG["yellow"], SMOG["alpha"]),
        "torch.cuda.current_device": torch.cuda.current_device,
        "raw current stream (now)": lambda: raw(idx),
        "torch.cuda.current_stream(dev).cuda_stream (earlier launch path)":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "torch.cuda.device context, enter and exit (earlier launch path)": old_context,
        "ctypes launch, no work (px = 0)": lambda: launch(
            x.data_ptr(), d.data_ptr(), out.data_ptr(), 0, 64, nb,
            SMOG["airlight"], keep, *tint, raw(idx)),
        "ctypes launch with its kernel": lambda: launch(
            x.data_ptr(), d.data_ptr(), out.data_ptr(), 64, 64, nb,
            SMOG["airlight"], keep, *tint, raw(idx)),
    }
    for name, fn in parts.items():
        print(f"  host {host_us(fn):8.3f} us  {name}", flush=True)


def sass_counts(path):
    """Per kernel in the library: SASS instructions, of them MUFU."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("  cuobjdump not found: no SASS counts", flush=True)
        return
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True).stdout
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.splitlines()[0].strip()
        ins = [op for _, op in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)", block)
            if op != "NOP"]
        mufu = sum(1 for i in ins if i.startswith("MUFU"))
        print(f"  sass {len(ins):5d} instructions, {mufu:3d} MUFU: {name}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another events.cu with the same C "
                                     "interface, timed as 'parent'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("events_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(smi(), flush=True)
    t0 = time.perf_counter()
    libs = build(sources(args.parent))
    print(f"nvcc, {len(libs)} variants at once: {time.perf_counter() - t0:.1f} s",
          flush=True)
    with torch.inference_mode():
        calls, _ = inputs()
        names = list(libs)
        _events._bind(libs["base"][0])
        for k in KERNELS:  # a first pass that warms the card, not counted
            device_ms(torch, calls[k], reps=20)
        times = {n: {k: [] for k in KERNELS} for n in names}
        for name in names + names[::-1]:
            _events._bind(libs[name][0])
            for k in KERNELS:
                times[name][k].append(device_ms(torch, calls[k], reps=20))
        for name in names:
            print(f"{name:>10}: " + "  ".join(
                f"{k} {sum(t) / len(t):.5f} ms ({', '.join(f'{v:.5f}' for v in t)})"
                for k, t in times[name].items()), flush=True)
        _events._bind(libs["base"][0])
        host_parts()
    sass_counts(libs["base"][1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
