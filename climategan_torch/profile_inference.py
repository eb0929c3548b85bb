#!/usr/bin/env python
"""Profiling harness of the port: trace the inference forward (or the
G + D train step) with ``torch.profiler`` and print where the device time
goes, by pipeline stage and by op; the twin of the root
``profile_inference.py``. On the card unless ``--device cpu``.

    python -m climategan_torch.profile_inference --batch 24 --events flood
    python -m climategan_torch.profile_inference --train --batch 2 --size 256

Inference runs ``build_infer_fn`` at bf16 (spectral weights baked, as
``eval()`` always bakes them); ``--train`` profiles ``StepBuilder.
train_step`` with ``train.bf16`` and ``tpu.remat`` on, as the root sets
them. Below 128^2 (the full painter needs 2^spade_n_up = 128 pixels) both
run the tiny opts of the JAX package's ``tiny_opts(size)``, the root's CPU
smoke mode.

For the trace, the script installs forward pre- and post-hooks on the
generator's submodules that open and close ``torch.profiler.
record_function`` ranges named by the root's stage labels
(``masker/encoder``, ``masker/seg_decoder``, ``masker/depth_decoder``,
``masker/mask_decoder``, ``painter/<child>``), and wraps ``G.paint``
(``painter/other``) and ``G.infer_masker`` (``masker/other``); it removes
them all afterwards, so the models and the serving path run nothing of
it otherwise. A device kernel belongs to the innermost range around its
launch: the profiler links each kernel to the op or range that launched
it (its correlation id), and that event's nearest stage range, walking
up, names the stage; a backward op takes the stage of the forward op of
its sequence number. Anything outside the ranges is ``events+misc``. On
the CPU (no device) each op's own CPU time stands in for device time.

Two tables: device ms per iteration by stage (the stages sum to the
profiler's device total; what no launch links to is shown as
``(unlinked)``), then the top ``--top`` ops. The Chrome trace goes to
``--out``/trace.json. ``run(args)`` returns the numbers.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

STAGE_PREFIX = "stage:"
MASKER_DECODERS = {"s": "masker/seg_decoder", "d": "masker/depth_decoder",
                   "m": "masker/mask_decoder"}
UNLINKED = "(unlinked)"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m climategan_torch.profile_inference")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--events", choices=["flood", "all"], default="flood")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "climategan_torch_prof"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--train", action="store_true",
                    help="profile the full G+D train step instead of "
                         "inference (batch = per-domain batch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no card raises")
    return ap.parse_args(argv)


def tiny_opts(size: int):
    """The port's opts with the overrides of the JAX package's
    ``utils/testing.tiny_opts(size)`` (thin encoder, narrow painter, tiny
    targets)."""
    from climategan_torch.utils.opts import load_opts

    feat = max(size // 4, 32)
    return load_opts(commandline_opts={
        "gen": {"deeplabv2": {"nblocks": [1, 1, 1, 1]},
                "p": {"latent_dim": 32, "spade_n_up": 5},
                "m": {"proj_dim": 16, "n_res": 1}},
        "data": {"transforms": [
            {"name": "resize", "ignore": False, "new_size": size,
             "keep_aspect_ratio": True},
            {"name": "resize", "ignore": False,
             "new_size": {"default": size, "d": feat, "s": feat}}],
            "loaders": {"batch_size": 2, "num_workers": 0}},
        "dis": {"p": {"n_layers": 2, "ndf": 16, "num_D": 2}},
        "train": {"fid": {"n_images": 2, "batch_size": 2}},
    })


# ---- the stage ranges ----------------------------------------------------

def stage_modules(G) -> List:
    """(module, stage label) of the generator's parts the ranges go on."""
    out = []
    if hasattr(G, "encoder"):
        out.append((G.encoder, "masker/encoder"))
    for key, label in MASKER_DECODERS.items():
        if key in G.decoders:
            out.append((G.decoders[key], label))
    if hasattr(G, "painter"):
        for name, child in G.painter.named_children():
            if name == "up_spades":  # the JAX painter's up_spade{i}
                out += [(m, f"painter/up_spade{i}")
                        for i, m in enumerate(child)]
            else:
                out.append((child, f"painter/{name}"))
    return out


class StageRanges:
    """Context manager: while open, the generator's stage modules and its
    ``paint`` and ``infer_masker`` run inside ``record_function`` ranges
    named ``stage:<label>``; on exit every hook and wrapper is removed."""

    def __init__(self, G):
        self.G = G
        self.handles = []
        self.open: Dict[int, List] = collections.defaultdict(list)

    def _pre(self, label):
        def hook(module, args):
            rf = torch.profiler.record_function(STAGE_PREFIX + label)
            rf.__enter__()
            self.open[id(module)].append(rf)
        return hook

    def _post(self, module, args, output):
        stack = self.open.get(id(module))
        if stack:
            stack.pop().__exit__(None, None, None)

    def _wrap(self, name, label):
        method = getattr(self.G, name)

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(STAGE_PREFIX + label):
                return method(*args, **kwargs)
        setattr(self.G, name, wrapped)

    def __enter__(self):
        for module, label in stage_modules(self.G):
            self.handles.append(module.register_forward_pre_hook(
                self._pre(label)))
            self.handles.append(module.register_forward_hook(self._post))
        if hasattr(self.G, "painter"):
            self._wrap("paint", "painter/other")
        self._wrap("infer_masker", "masker/other")
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles.clear()
        for name in ("paint", "infer_masker"):
            self.G.__dict__.pop(name, None)
        return False


# ---- attribution ---------------------------------------------------------

class _Op:
    """A host event of the trace (an op or a range) in its thread's tree."""

    __slots__ = ("name", "start", "end", "thread", "seq", "fwd_thread",
                 "parent", "child_ns")

    def __init__(self, k):
        self.name = k.name()
        self.start = k.start_ns()
        self.end = self.start + k.duration_ns()
        self.thread = k.start_thread_id()
        self.seq = k.sequence_nr()
        self.fwd_thread = k.fwd_thread_id()
        self.parent, self.child_ns = None, 0


def _nest(ops) -> None:
    """Each op's innermost enclosing op on its thread (``parent``) and the
    time of its direct children (``child_ns``)."""
    by_thread = collections.defaultdict(list)
    for op in ops:
        by_thread[op.thread].append(op)
    for thread_ops in by_thread.values():
        thread_ops.sort(key=lambda o: (o.start, -o.end))
        stack = []
        for op in thread_ops:
            while stack and stack[-1].end <= op.start:
                stack.pop()
            if stack:
                op.parent = stack[-1]
                op.parent.child_ns += op.end - op.start
            stack.append(op)


def _stage_of(op: Optional[_Op], backward_stage: Dict) -> Optional[str]:
    """The innermost stage range at or above ``op``; a backward op takes
    the stage of the forward op of its sequence number."""
    while op is not None:
        if op.name.startswith(STAGE_PREFIX):
            return op.name[len(STAGE_PREFIX):]
        if op.seq >= 0 and op.name.startswith(
                "autograd::engine::evaluate_function"):
            stage = backward_stage.get((op.fwd_thread, op.seq))
            if stage is not None:
                return stage
        op = op.parent
    return None


def attribute(raw, on_device: bool):
    """(microseconds by stage, by op name, the total, [(op name, stage,
    microseconds)]) over the profiler's raw events
    (``prof.profiler.kineto_results.events()``, which skips the slow
    ``prof.events()``).

    On the card: each device event (kernel, copy, memset; the ranges'
    copies on the device track left out) has the correlation id of the
    runtime call that launched it, and that call the id of the op or
    range it was made in (its linked correlation id; a call that carries
    none, as the kernels' own libraries make them, is in the innermost op
    or range around it on its thread); that op's innermost stage range,
    walking up, names the stage. A device event whose launch is not in
    the trace is ``(unlinked)``; a launch outside every op is
    ``events+misc``. On the CPU: each op's own time (its duration less
    its children's)."""
    from torch.autograd import DeviceType

    ops, by_id, linked, device = [], {}, {}, []
    calls = {}  # runtime calls that carry no linked id, nested by time
    for k in raw:
        name = k.name()
        if k.device_type() == DeviceType.CUDA:
            if not (k.is_user_annotation() or name.startswith(STAGE_PREFIX)):
                device.append((name, k.correlation_id(),
                               k.duration_ns() / 1e3))
        elif k.linked_correlation_id() > 0:  # a runtime call inside an op
            linked[k.correlation_id()] = k.linked_correlation_id()
        elif name.startswith("cu") and "::" not in name:
            calls[k.correlation_id()] = _Op(k)
        else:
            op = _Op(k)
            ops.append(op)
            by_id[k.correlation_id()] = op
    _nest(ops + list(calls.values()))
    backward_stage = {}
    for op in ops:
        if op.seq >= 0 and not op.name.startswith("autograd::"):
            stage = _stage_of(op, {})
            if stage is not None:
                backward_stage.setdefault((op.thread, op.seq), stage)
    stages: Dict[str, float] = collections.Counter()
    names: Dict[str, float] = collections.Counter()
    rows = []

    def add(name, stage, us):
        stages[stage] += us
        names[name] += us
        rows.append((name, stage, us))

    if on_device:
        for name, corr, us in device:
            if corr in linked:
                within = by_id.get(linked[corr])
            elif corr in calls:
                within = calls[corr].parent
            else:
                add(name, UNLINKED, us)
                continue
            add(name, _stage_of(within, backward_stage) or "events+misc", us)
    else:
        for op in ops:
            if not op.name.startswith(STAGE_PREFIX):
                add(op.name, _stage_of(op, backward_stage) or "events+misc",
                    (op.end - op.start - op.child_ns) / 1e3)
    return stages, names, sum(us for _, _, us in rows), rows


def summarize(result: Dict, top: int, what: str = "device") -> None:
    iters = result["iters"]
    total = result["total_us"]
    print(f"\n{what} time by pipeline stage "
          f"({total / 1e3 / iters:.3f} ms/iter total; stages sum to "
          f"{sum(result['stages_us'].values()) / 1e3 / iters:.3f}):")
    for stage, us in sorted(result["stages_us"].items(), key=lambda kv: -kv[1]):
        print(f"{us / 1e3 / iters:10.3f} ms  {100 * us / max(total, 1e-9):5.1f}%  "
              f"{stage}")
    print(f"\ntop {top} {what} ops by total time:")
    for name, us in result["ops_us"].most_common(top):
        print(f"{us / 1e3:10.3f} ms  {name[:100]}")


# ---- the runs -------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inference_call(args, device):
    """(G, a call of one inference iteration)."""
    from climategan_torch.inference import build_infer_fn
    from climategan_torch.utils.opts import load_opts

    opts = load_opts() if args.size >= 128 else tiny_opts(args.size)
    ignore = ("wildfire", "smog") if args.events == "flood" else ()
    G, infer = build_infer_fn(opts, dtype=torch.bfloat16, ignore_event=ignore,
                              device=device, seed=0)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(args.batch, args.size, args.size, 3, device=device,
                   generator=g) * 2 - 1
    uniform = torch.rand(9, 9, device=device, generator=g)

    def call():
        return infer(x, uniform=uniform)
    return G, call


def train_call(args, device):
    """(G, a call of one train step), the state carried from call to call."""
    from climategan_torch.bench_train import synthetic_batch
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts

    opts = load_opts() if args.size >= 128 else tiny_opts(args.size)
    opts.train.bf16 = True
    opts.tpu.remat = True
    builder = StepBuilder(opts)
    holder = {"state": builder.init_state(0, device)}
    G = holder["state"].G
    batch = synthetic_batch(args.batch, args.size, G.cfg.d_target_size,
                            device, G.cfg.d_classify_buckets)

    def call():
        holder["state"], metrics = builder.train_step(holder["state"], batch)
        return metrics
    return G, call


def run(args) -> Dict:
    """Profile ``args.iters`` iterations after one warm-up; prints the two
    tables and returns ``{"stages_ms", "total_ms", "attributed_ms",
    "launches", "rows", "trace", ...}`` (ms per iteration; ``rows``: (op
    name, stage, microseconds) of every device event)."""
    if not args.train:
        return _run(args)
    # the state is built and stepped with autograd on, also when the
    # caller runs under inference mode
    with torch.inference_mode(False), torch.enable_grad():
        return _run(args)


def _run(args) -> Dict:
    from torch.profiler import ProfilerActivity, profile

    from climategan_torch import kernels
    from climategan_torch.inference import resolve_device

    device = resolve_device(args.device)
    on_device = device.type == "cuda"
    t0 = time.perf_counter()
    G, call = (train_call if args.train else inference_call)(args, device)
    call()
    _sync(device)
    print(f"built and warmed up in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_device else [])
    kernels.reset_launches()
    t0 = time.perf_counter()
    with StageRanges(G), profile(activities=activities) as prof:
        for _ in range(args.iters):
            call()
        _sync(device)
    wall = time.perf_counter() - t0
    launches = {k: v / args.iters for k, v in kernels.launches.items()}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "trace.json"
    prof.export_chrome_trace(str(trace))
    print(f"trace written to {trace}")
    t0 = time.perf_counter()
    stages, ops, total, rows = attribute(prof.profiler.kineto_results.events(),
                                         on_device)
    print(f"{args.iters} iterations profiled in {wall:.1f} s, the trace "
          f"read in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    summarize({"iters": args.iters, "stages_us": stages, "ops_us": ops,
               "total_us": total}, args.top,
              "device" if on_device else "CPU")
    n = args.iters * 1e3
    return {
        "device": str(device), "train": bool(args.train),
        "stages_ms": {k: v / n for k, v in stages.items()},
        "total_ms": total / n,
        "attributed_ms": sum(v for k, v in stages.items()
                             if k != UNLINKED) / n,
        "ops_ms": {k: v / n for k, v in ops.items()},
        "launches": launches, "rows": rows, "trace": str(trace),
        "wall_ms": wall * 1e3 / args.iters,
    }


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
