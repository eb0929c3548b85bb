#!/usr/bin/env python
"""Training-step benchmark of the port on one CUDA card: the full G + D
update (the masker's ADVENT and the painter's GAN, ExtraAdam) at 640x640
on synthetic batches, under the root ``bench_train.py``'s metric name.

    python -m climategan_torch.bench_train [--batch 2] [--size 640]
        [--feat 160] [--iters 6] [--warmup 2] [key=value ...]

The default opts with the ``key=value`` overrides (another generator
configuration), with their bf16 policy; random weights from seed 0; the
root bench's synthetic batch (uniform images, 0.01-1 depth targets, or
bucket indices under ``gen.d.classify.enable``, and 11-class seg labels at
``--feat``, random binary masks). Prints ONE JSON
line: ``metric``, ``value`` (images/s per card, counting the 3 x batch
domain samples of a step once, from the p50 step time), the p50 and every
step's ms (a synchronise after each step), ``max_memory_allocated``, the
last step's ``g_loss`` and ``d_loss``, the device kind and the card's name
and power limit. A card is required: without one it raises, and nothing
falls back to the CPU. ``--mesh``, ``--remat`` and ``--remat_d`` exit with
the ROADMAP item that will port them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Dict

import numpy as np
import torch

from climategan_torch.bench import power_limit
from climategan_torch.inference import resolve_device

NOT_PORTED = {
    "mesh": "data-parallel training is not ported yet: ROADMAP A.11",
    "remat": "tpu.remat is not ported yet: ROADMAP A.8 remainder",
    "remat_d": "tpu.remat_d is not ported yet: ROADMAP A.8 remainder",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2, help="per-domain batch")
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--feat", type=int, default=160,
                    help="size of the depth and seg targets")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=2)
    for flag, why in NOT_PORTED.items():
        ap.add_argument(f"--{flag}", action="store_true",
                        help="not ported: " + why)
    ap.add_argument("opts", nargs="*", metavar="key=value",
                    help="overrides of the default opts")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, why in NOT_PORTED.items():
        if getattr(args, flag):
            parser.error(why)
    return args


def synthetic_batch(n: int, size: int, feat: int, device,
                    buckets: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """The root bench_train.py's batch, drawn as it draws it (numpy
    RandomState(0)), in the port's layout: NCHW images in [-1, 1],
    binary masks, depth targets (with ``buckets``, int64 bucket indices
    drawn after the rest) and int64 seg labels at ``feat``."""
    r = np.random.RandomState(0)

    def img(*s):
        return r.uniform(-1, 1, s).astype(np.float32)

    def mk():
        return (r.rand(n, size, size, 1) > 0.5).astype(np.float32)

    batch = {
        "r": {"x": img(n, size, size, 3), "m": mk()},
        "s": {
            "x": img(n, size, size, 3),
            "d": r.uniform(0.01, 1, (n, feat, feat, 1)).astype(np.float32),
            "s": r.randint(0, 11, (n, feat, feat)).astype(np.int32),
            "m": mk(),
        },
        "rf": {"x": img(n, size, size, 3), "m": mk()},
    }

    if buckets:
        batch["s"]["d"] = r.randint(0, buckets, (n, feat, feat, 1))

    def tensor(k, a):
        t = torch.from_numpy(a)
        t = t.long() if k == "s" else t.permute(0, 3, 1, 2).contiguous()
        return (t.long() if t.dtype != torch.float32 else t).to(device)

    return {dom: {k: tensor(k, a) for k, a in d.items()}
            for dom, d in batch.items()}


def metric_name(size: int) -> str:
    return (f"train images/sec/chip at {size}x{size} "
            "(G+D ExtraAdam step, 3 domains)")


def run_bench(args) -> dict:
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts

    device = resolve_device("cuda")
    builder = StepBuilder(load_opts(commandline_opts=args.opts))
    state = builder.init_state(0, device)
    batch = synthetic_batch(args.batch, args.size, args.feat, device,
                            state.G.cfg.d_classify_buckets)
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(args.warmup):
        state, metrics = builder.train_step(state, batch)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        state, metrics = builder.train_step(state, batch)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    return {
        "metric": metric_name(args.size),
        "value": round(3 * args.batch / p50, 3),
        "unit": "images/sec/chip",
        "p50_step_ms": round(p50 * 1e3, 2),
        "step_ms": [round(t * 1e3, 2) for t in times],
        "per_domain_batch": args.batch,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
        "g_loss": round(float(metrics["g_total"]), 4),
        "d_loss": round(float(metrics["d_total"]), 4),
        "n_devices": 1,
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(device),
        "name_power_limit": power_limit(),
    }


def main(argv=None) -> int:
    print(json.dumps(run_bench(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
