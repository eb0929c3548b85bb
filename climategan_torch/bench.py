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

``--mesh`` splits the batch over one replica per visible card, on the
largest count that divides it (``inference.build_mesh_infer_fn``, the JAX
bench's rule): ``value`` and the TFLOP/s are then per card, beside the
aggregate images/s and ``n_devices``. ``--spatial`` splits each image's
rows over the largest count of cards that divides ``--size``
(``inference.build_spatial_infer_fn``), and ``--hybrid SP`` the batch over
dp data groups of SP cards each, dp the largest divisor of the batch up to
cards / SP (``build_hybrid_infer_fn``), both as the JAX bench does; the
line gives the layout as ``dp`` and ``sp``. Under them ``--stage masker``
times ``infer_masker`` and ``--stage painter`` ``paint_rows`` on
each data group's row-sharded images (and a mask made of them). With one
card they run the plain forward, as JAX's do. ``run_bench(args,
devices=...)`` takes the devices to use in place of the visible cards (a
device may repeat).
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
    ap.add_argument("--mesh", action="store_true",
                    help="split the batch over one replica per visible card")
    ap.add_argument("--spatial", action="store_true",
                    help="split each image's rows over the visible cards")
    ap.add_argument("--hybrid", type=int, default=0, metavar="SP",
                    help="SP-way row sharding x (cards / SP)-way batch "
                         "sharding")
    ap.add_argument("opts", nargs="*", metavar="key=value",
                    help="overrides of the default opts")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Flags with the ``--config`` shortcut applied."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mesh and args.stage != "all":
        parser.error("--mesh benches the whole forward (--stage all)")
    if args.hybrid < 0:
        parser.error("--hybrid takes a row shard count >= 1")
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


def layout(args, n: int) -> Tuple[int, int]:
    """(dp, sp) of the JAX bench's rules over ``n`` devices: ``--hybrid SP``
    (dp the largest divisor of the batch up to n / SP), ``--spatial`` (the
    largest count that divides the rows), ``--mesh`` (the largest count
    that divides the batch); one device runs the plain forward."""
    from climategan_torch.parallel.mesh import (
        hybrid_size,
        mesh_size,
        spatial_size,
    )

    if n == 1:
        return 1, 1
    if args.hybrid:
        return hybrid_size(args.batch, args.size, n, args.hybrid), args.hybrid
    if args.spatial:
        return 1, spatial_size(args.size, n)
    if args.mesh:
        return mesh_size(args.batch, n), 1
    return 1, 1


def stage_forward(args, G, infer, x, devices, dp: int, sp: int, dtype,
                  gen=None):
    """The call that ``args.stage`` times on the NHWC batch ``x``: the
    whole ``infer``; ``infer_masker``'s mask or ``paint`` (of a mask made
    of x) on the NCHW batch, or under row shards (sp > 1) on each of the
    dp data groups' images with their rows over the group's sp devices
    (``infer_masker`` on ``Rows``, ``paint_rows``). Returns the list of the
    groups' outputs (one without row shards)."""
    from climategan_torch.inference import _indexed
    from climategan_torch.parallel import spatial
    from climategan_torch.parallel.mesh import hybrid_groups

    if args.stage == "all":
        return lambda: [infer(x, generator=gen)]
    if sp > 1:
        groups = hybrid_groups([_indexed(d) for d in devices], dp, sp)
        per = x.shape[0] // dp
        xs = [spatial.shard_rows(x[g * per:(g + 1) * per], groups[g], dtype,
                                 dim=1) for g in range(dp)]
    else:
        xs = [x.to(dtype).permute(0, 3, 1, 2).contiguous()]
    if args.stage == "masker":
        return lambda: [G.infer_masker(xc)[2] for xc in xs]
    ms = [spatial.each(lambda t: (t[:, :1] > 0).to(dtype), xc) for xc in xs]
    return lambda: [G.paint(mc, xc) for mc, xc in zip(ms, xs)]


@torch.inference_mode()
def run_bench(args, devices=None) -> dict:
    from climategan_torch import kernels
    from climategan_torch.inference import (
        build_hybrid_infer_fn,
        build_infer_fn,
        build_mesh_infer_fn,
        build_spatial_infer_fn,
        resolve_device,
    )
    from climategan_torch.parallel.mesh import make_mesh
    from climategan_torch.utils.opts import load_opts

    resolve_device("cuda")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    opts = load_opts(commandline_opts=args.opts)
    kwargs = dict(dtype=dtype, ignore_event=IGNORE[args.events], seed=0)
    pool = make_mesh(devices=devices)
    if not (args.mesh or args.spatial or args.hybrid):
        pool = pool[:1]
    dp, sp = layout(args, len(pool))
    devices = pool[:dp * sp]
    device = devices[0]
    if len(devices) < len(pool):
        print(f"WARNING: dp{dp} x sp{sp} uses {len(devices)} of {len(pool)} "
              "devices", file=sys.stderr)
    if sp > 1 and dp > 1:
        G, infer = build_hybrid_infer_fn(opts, devices, sp, **kwargs)
    elif sp > 1:
        G, infer = build_spatial_infer_fn(opts, devices, **kwargs)
    elif dp > 1:
        G, infer = build_mesh_infer_fn(opts, devices, **kwargs)
    else:
        G, infer = build_infer_fn(opts, device=device, **kwargs)

    def sync():
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(args.batch, args.size, args.size, 3, device=device,
                   generator=gen) * 2 - 1
    forward = stage_forward(args, G, infer, x, devices, dp, sp, dtype, gen)

    flops, plain_calls = count_flops(forward)
    before = kernels.launches["spade_cond"]
    forward()
    sync()
    launched = kernels.launches["spade_cond"] - before
    if plain_calls != launched:
        raise RuntimeError(
            f"the FLOP count ran spade_cond's plain version {plain_calls} "
            f"times, the forward launched the kernel {launched} times: the "
            f"count misses spade_cond's convolutions")
    for _ in range(args.warmup):
        forward()
    sync()

    times = []  # latency: one batch in flight, a synchronise each time
    for _ in range(args.iters):
        t0 = time.perf_counter()
        forward()
        sync()
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)

    t0 = time.perf_counter()  # throughput: all enqueued, one synchronise
    for _ in range(args.iters):
        forward()
    sync()
    wall = time.perf_counter() - t0

    n = len(devices)
    achieved = flops * args.iters / wall / n / 1e12
    result = {
        "metric": metric_name(args),
        "value": round(args.batch * args.iters / wall / n, 3),
        "unit": "images/sec/chip",
        "aggregate_images_per_sec": round(args.batch * args.iters / wall, 3),
        "n_devices": n,
        "dp": dp,
        "sp": sp,
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
