#!/usr/bin/env python
"""Benchmark of the port on one CUDA card: images/sec/chip of the fused
inference (Masker + Painter, and the events asked for) at 640x640 bf16,
under the root ``bench.py``'s metric name.

    python -m climategan_torch.bench [--batch 32] [--events all] [--config 4]
        [key=value ...]

The model is the default opts' with the ``key=value`` overrides (another
generator configuration, e.g. ``gen.m.use_spade=true``), random weights
from seed 0.

Prints ONE JSON line: ``metric``, ``value`` (images/s of the throughput
phase: every forward enqueued, one synchronise at the end), ``unit``, the
p50 batch latency (a synchronise after each forward),
``gflops_per_image`` (one untimed forward under
``torch.utils.flop_counter.FlopCounterMode``, which counts convolutions and
matrix products; ``spade_cond``'s plain version stands in for its kernel
there, since the counter cannot see a ctypes launch, and the run fails
unless it ran as often as a forward launches the kernel), the achieved
TFLOP/s, ``mfu`` against the H100's 989 TFLOP/s dense bf16 peak (bfloat16 only),
the device kind and the card's power limit. A card is required: without one
it raises, and nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Tuple

import torch

# NVIDIA H100 SXM data sheet, dense bf16 on the tensor cores
PEAK_BF16_TFLOPS = 989.0
CONFIGS = {  # the root bench.py's --config shortcuts
    1: {"batch": 1, "dtype": "float32", "events": "flood"},  # single-image flood fp32
    2: {"events": "smog"},                                   # smog only
    3: {"events": "wildfire"},                               # wildfire only
    4: {"events": "all", "dtype": "bfloat16"},               # batched bf16 all events
}
IGNORE = {"flood": ("wildfire", "smog"), "smog": ("wildfire", "flood"),
          "wildfire": ("smog", "flood"), "all": ()}
SCALE_OUT = "multi-GPU benchmarks (--mesh, --spatial, --hybrid) are not ported yet: ROADMAP A.11"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m climategan_torch.bench")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--stage", choices=["all", "masker", "painter"],
                    default="all", help="isolate a pipeline stage")
    ap.add_argument("--config", type=int, default=0, choices=[0, 1, 2, 3, 4],
                    help="config shortcut: 1=single-image flood fp32, 2=smog "
                         "only, 3=wildfire only, 4=batched bf16 all events")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--events", choices=["flood", "smog", "wildfire", "all"],
                    default="flood")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    ap.add_argument("--mesh", action="store_true", help="not ported: " + SCALE_OUT)
    ap.add_argument("--spatial", action="store_true", help="not ported: " + SCALE_OUT)
    ap.add_argument("--hybrid", type=int, default=0, metavar="SP",
                    help="not ported: " + SCALE_OUT)
    ap.add_argument("opts", nargs="*", metavar="key=value",
                    help="overrides of the default opts")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Flags with the ``--config`` shortcut applied."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mesh or args.spatial or args.hybrid:
        parser.error(SCALE_OUT)
    for k, v in CONFIGS.get(args.config, {}).items():
        setattr(args, k, v)
    return args


def metric_name(args) -> str:
    return (f"images/sec/chip at {args.size}x{args.size} {args.dtype} "
            f"{args.events} inference (Masker+Painter)")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def count_flops(fn) -> Tuple[int, int]:
    """(FLOPs of one call of ``fn`` as FlopCounterMode counts them, the
    ``spade_cond`` calls in it): the counter cannot see the kernel's ctypes
    launch, so each call runs the plain version, whose convolutions it
    counts. The caller holds the call count to the kernel's launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from climategan_torch.kernels.spade_cond import spade_cond_plain
    from climategan_torch.models import norms

    calls = 0

    def plain(seg, pack):
        nonlocal calls
        calls += 1
        return spade_cond_plain(seg, *pack.args)

    kernel = norms.spade_cond_packed
    norms.spade_cond_packed = plain
    try:
        with FlopCounterMode(display=False) as counter:
            fn()
    finally:
        norms.spade_cond_packed = kernel
    return counter.get_total_flops(), calls


@torch.inference_mode()
def run_bench(args) -> dict:
    from climategan_torch import kernels
    from climategan_torch.inference import build_infer_fn, resolve_device
    from climategan_torch.utils.opts import load_opts

    device = resolve_device("cuda")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    G, infer = build_infer_fn(load_opts(commandline_opts=args.opts),
                              dtype=dtype, device=device,
                              ignore_event=IGNORE[args.events], seed=0)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(args.batch, args.size, args.size, 3, device=device,
                   generator=gen) * 2 - 1
    xc = x.to(dtype).permute(0, 3, 1, 2).contiguous()
    if args.stage == "masker":
        def forward():
            return G.infer_masker(xc)[2]
    elif args.stage == "painter":
        mc = (xc[:, :1] > 0).to(dtype)

        def forward():
            return G.paint(mc, xc)
    else:
        def forward():
            return infer(x, generator=gen)

    flops, plain_calls = count_flops(forward)
    before = kernels.launches["spade_cond"]
    forward()
    torch.cuda.synchronize(device)
    launched = kernels.launches["spade_cond"] - before
    if plain_calls != launched:
        raise RuntimeError(
            f"the FLOP count ran spade_cond's plain version {plain_calls} "
            f"times, the forward launched the kernel {launched} times: the "
            f"count misses spade_cond's convolutions")
    for _ in range(args.warmup):
        forward()
    torch.cuda.synchronize(device)

    times = []  # latency: one batch in flight, a synchronise each time
    for _ in range(args.iters):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)

    t0 = time.perf_counter()  # throughput: all enqueued, one synchronise
    for _ in range(args.iters):
        forward()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    achieved = flops * args.iters / wall / 1e12
    result = {
        "metric": metric_name(args),
        "value": round(args.batch * args.iters / wall, 3),
        "unit": "images/sec/chip",
        "gflops_per_image": round(flops / args.batch / 1e9, 2),
        "achieved_tflops_per_chip": round(achieved, 2),
    }
    if args.dtype == "bfloat16":
        result["mfu"] = round(achieved / PEAK_BF16_TFLOPS, 4)
        result["peak_bf16_tflops_assumed"] = PEAK_BF16_TFLOPS
    result.update({
        "p50_batch_latency_s": round(p50, 4),
        "latency_imgs_per_sec": round(args.batch / p50, 3),
        "batch": args.batch,
        "stage": args.stage,
        "n_devices_visible": torch.cuda.device_count(),
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(device),
        "name_power_limit": power_limit(),
    })
    return result


def main(argv=None) -> int:
    print(json.dumps(run_bench(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
