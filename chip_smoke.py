#!/usr/bin/env python3
"""Smoke test of the PyTorch port (climategan_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero:
  1. print the card's name and power limit; build the kernels from the
     sources in the checkout (one nvcc per CUDA source, started together,
     with each kernel's register and spill lines; Triton compiles at its
     first launch);
  2. drive one full-width 640^2 bf16 batch-2 forward of all three events
     (default opts: ResNet-101 os8, DADA depth, DeepLabV3+, base mask
     decoder, SPADE painter with latent 640 and 7 upsamplings; random
     weights from a seed) with each kernel wrapper recording its arguments,
     then hold each kernel to its plain PyTorch version on exactly those
     inputs: spade_cond (the CUDA-core kernel) and masked_blend in f32
     (cuDNN TF32 off) at atol = rtol = 1e-4 (masked_blend 1e-6), and in bf16
     (spade_cond: the tensor-core kernel on the packs the model was built
     with) against the plain version in f32 on the same bf16 inputs within
     one bf16 ulp of each output's largest magnitude (the kernels sum in f32;
     spade_cond rounds its activation and output to bf16); smog_tail within atol 1e-5; fire_color_grade and fire_paste
     within 1.0 and equal on >= 99.99% of values (the count that differs is
     printed);
  3. the main path: launch counts set to 0, one forward of all three events
     through build_infer_fn, counts read: 18 spade_cond and one launch of
     each other kernel; outputs finite, of the expected shapes and dtypes,
     the wildfire's range-pinning pixels 255 and 0;
  4. card vs CPU: the same model in f32 at 256^2 with device="cuda"
     (kernels) and device="cpu" (plain versions): masks within atol 1e-3,
     uint8 floods within 1 LSB on >= 99.9% of pixels (smooth masks); then
     the CPU run's own x, seg logits and depth with one fixed g_value
     through add_fire and add_smog on both devices: uint8 wildfire and smog
     within 1 LSB on >= 99.9% of values; the count of sky pixels on which
     the two devices' seg argmaxes disagree is printed;
  5. timings: flood-only and all-events latency and images/s (in turns),
     the masker's share, the events' own share (add_fire + add_smog alone),
     the device kernels of one forward with the SPADE weights packed once
     and packed per call (profiler), the 640^2 flood's uint8 agreement with
     the same forward through spade_cond_plain (information only), and per
     kernel its device time over the main path's calls (cold L2, host time
     not counted) beside its back-to-back call time, the plain version, one
     PyTorch library call computing the same function (where there is one;
     weights laid out before the timing) and the bound; spade_cond per call
     with its TFLOP/s and share of the bound;
  6. serving, at full width (default opts, --half, the random seed-0 model
     saved as a reference-layout {"G": state_dict} .pth under
     checkpoints/latest_ckpt.pth of a temp run dir with opts.yaml): the
     state dict that load_inference_state returns equals the saved one on
     every key; `python -m climategan_torch.apply_events` main() with -r on
     7 synthetic PNG photos (720x1280 and 1280x960, one 640^2 bucket) at
     -b 2, launch counts set to 0 before it and read after: batches x {18,
     1, 1, 1, 1}; the native prep library built; every output PNG uint8
     640x640x3 and bit-equal to infer on the same prepped, padded batches
     with one generator seeded as the CLI's; served images/s through
     render on a steady stream (the photos repeated to 64, 32 batches) with
     and without the overlap and without the PNG encodes, over the whole
     call and over the loop after the prep, the stage report, and the
     forward alone over as many batches in turns with them (information
     only); eval_masker's per-image path on
     2 photos at 640^2 equal to the metrics of a direct G.infer_masker;
     climategan_torch.bench
     with --events all at batch 2, 8 and 32, one JSON line each
     (gflops_per_image > 0, mfu <= 1.05);
  7. training (grad enabled), the default training step (g_step then
     d_step): (1) at tiny_opts(32)'s sizes in f32 (TF32 off), the card's
     g_step and then d_step against the CPU's plain path from the same
     state, batch and draws (each step from one state on both devices):
     losses within 1e-4 relative; each model held leaf by leaf by
     climategan_torch.utils.step_check.hold_state (the optimizer's first
     moments, every parameter value whose gradient is not rounding noise
     within 1e-6, >= 99.9% of values within 1e-6, the noise values counted;
     batch-norm statistics and spectral u/v within 1e-5; the model the step
     does not update unchanged); (2) masked_blend's autograd (the kernel forward, the
     plain backward) against masked_blend_plain under autograd at
     (2, 640, 640, 3), f32 within 1e-6 and bf16 within one bf16 ulp of the
     scale; (3) full width (default opts, 640^2, per-domain batch 2, the
     bf16 policy, random weights from seed 0): one counted step (launch
     counts set to 0 before it and read after: masked_blend 2, one paste
     per step, spade_cond 0), finite losses, every G and D parameter
     changed (any that did not is named) but the ADVENT Ds' output biases,
     whose gradient is exactly zero (their WGAN terms on r and s cancel),
     every spectral u/v (but a 1-channel conv's u, which is +-1) and
     batch-norm running statistic advanced, then 1 more warm step and 6 timed (p50
     step ms, images/s counting 3 x batch, peak memory); G.eval() and its
     f32 masker + cloudy flood forward bit-equal to that of a fresh G
     loaded from the trained state_dict() (information: g_step and d_step
     timed apart, one step under torch.profiler, its device busy share and
     top ops); (4) `python -m
     climategan_torch.bench_train`, its JSON line (value > 0);
  8. the trainer through its entry point: a synthetic dataset (16 train and
     4 val samples per domain r, s, rf as 720x960 PNGs; s with Unity-coded
     depth and integer seg labels) in a temp dir; `python -m
     climategan_torch.train` as a subprocess at the default opts (full
     width) with data.loaders.batch_size=2 for 1 epoch (8 steps, the
     evaluation, the checkpoint): 8 steps, spade_cond and masked_blend
     launched in the epoch (counted by the trainer per epoch into
     train.jsonl), finite validation metrics, checkpoints/latest_ckpt.pth,
     latest.json and opts.json written; then the same command with
     args.resume=true train.epochs=2: resumed from epoch 0 with a state
     whose sha256 (checkpoint.state_digest) equals the epoch-0 file's, 8
     more steps, the newest checkpoint at epoch 1, step 16; then
     apply_events main() with -r <run dir> on 2 photos (three uint8
     640x640x3 PNGs each) and Trainer.resume_from_path(run dir).infer_all,
     each with the main path's launches {18, 1, 1, 1, 1}; then one step at
     the default batch (6 per domain) and its peak memory (information:
     steps/s, img/s and the loader's share over steps 2-8 and the whole
     epoch, the evaluation's and the save's seconds, the checkpoint's
     bytes, the peak memory at batch 2 and 6, the launches over the phase);
  9. the other generator configurations: the painter's cnc-3 packs of
     phase 2 byte-equal to the (10 taps, hid_pad, 8) layout; the SPADE mask
     decoder (gen.m.use_spade, the default gen.m.spade: cond_nc 15, latent
     128, 3 blocks) at 640^2 bf16 batch 2 with all events: its 6 cnc-15
     spade_cond calls (a dual and a norm_1 call per block, at 80^2, 160^2,
     320^2) held to the plain version on the forward's own inputs, in f32
     (TF32 off, 1e-4) and in bf16 (one ulp); its path's launch counts set
     to 0 before a forward and read after: spade_cond 18 + 6, the others 1;
     ms/batch and img/s in turns with the default config; the 6 calls'
     device ms beside their bound, plain and library times; the card's f32
     path against the CPU at 256^2 (mask 1e-3, every event within 1 LSB on
     >= 99.9%); climategan_torch.bench on it (its FLOP count's plain
     spade_cond calls equal the launches); `python -m
     climategan_torch.apply_events -r <run dir>` with its opts.yaml on 2
     photos: launches {24, 1, 1, 1, 1}, PNGs bit-equal to infer; its
     training step at tiny_opts(32)'s sizes, card vs CPU (oneDNN off)
     under hold_state, and at full width (640^2, 2 per domain, bf16
     policy): finite losses, every mask-decoder parameter moved, p50 of 3
     steps and peak memory; then one full-width forward each of the
     MobileNetV2 backbone, DeepLab v2, depth classification, the painter
     with z (drawn on the card), the final shortcut and batch-norm SPADEs:
     launches {18, 1, 1, 1, 1}, outputs checked, ms/batch, and the card's
     f32 path against the CPU at 256^2 (z fed to both) with the same bars;
     `python -m climategan_torch.bench_train` on depth classification (its
     bucket targets), its JSON line (value > 0).
The last three lines are the card's name and power limit, the kernels JSON
line (each kernel's launches per configuration's path; spade_cond's with
the SPADE masker's numbers), and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import io
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
STREAM = 64  # photos of phase 6's steady-stream serving rates
G_VALUE = 120.0  # the wildfire filter's green value where it is fixed
MAIN_PATH_LAUNCHES = {"spade_cond": 18, "masked_blend": 1, "smog_tail": 1,
                      "fire_color_grade": 1, "fire_paste": 1}
EVENT_KERNELS = ("smog_tail", "fire_color_grade", "fire_paste")
# f32 operations per pixel (smog_tail, fire_paste) or per value
# (fire_color_grade) in csrc/events.cu's source, counting each compare,
# select, floor, exp, exp2 and log2 as one: smog_tail's powers are
# 2^(k * log2 b) on the hardware's exp2 and log2, three operations each. A
# lower bound of what the card runs (events_breakdown.py prints the SASS
# instruction counts); the bound of these kernels is bytes either way
EVENT_OPS = {"smog_tail": 4 + 3 * 22, "fire_color_grade": 9,
             "fire_paste": 2 + 3 * 10}
EVENT_DESIGN = {
    "smog_tail": "a thread per 4 consecutive pixels per turn, the depth's "
                 "and three channels' 16-byte loads issued before the math, "
                 "16-byte stores; a grid of SMs x resident blocks, "
                 "grid-stride, one image-index divide per 4 pixels; powers "
                 "on the hardware's exp2 "
                 "and log2, curves as selects; a scalar path for "
                 "H*W % 4 != 0 or a misaligned base",
    "fire_color_grade": "two 16-byte loads per thread per turn (a wave "
                        "apart) before the math, 16-byte stores; a grid of "
                        "SMs x resident blocks, grid-stride; every rounding "
                        "explicit in the JAX order; a scalar path for a "
                        "misaligned base and the last n % 4 values",
    "fire_paste": "a thread per pixel, grid-stride",
}


def log(*args):
    print(*args, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """ms per call of ``fn`` called back to back between two CUDA events:
    the device's time, or the host's where it enqueues more slowly."""
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


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device ms per call of ``fn`` with a cold L2: each call has its own
    pair of CUDA events and follows a 256 MB read that evicts the 50 MB L2
    (a read, so that no dirty line is left for ``fn`` to write back); a
    sleep kernel in front lets the host enqueue all calls before the device
    reaches them, so the wrapper's host time is not counted."""
    fn()
    flush = torch.ones(2 ** 26, dtype=torch.int32, device="cuda")
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # tens of ms of head start for the host
    for start, end in pairs:
        flush.amax()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def profile_table(torch, fn, rows: int = 15) -> str:
    """torch.profiler over one call: the ops with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="self_device_time_total",
                                     row_limit=rows, max_name_column_width=60)


def device_profile(torch, fn, rows: int = 20):
    """torch.profiler over one call of ``fn``: (the ops with the most
    device time, the device's busy ms summed over its kernels and copies,
    their count, the call's wall ms under the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in device) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=rows, max_name_column_width=60)
    return table, busy, len(device), wall * 1e3


def device_kernels(torch, fn) -> int:
    """Kernels and copies the device ran in one call of ``fn`` (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def library_weights(k1, b1, branches):
    """OIHW weights per branch for cuDNN, made before the timing."""
    import torch

    off, ws = 0, []
    for kg, bg, kb, bb in branches:
        hid = kg.shape[2]
        ws.append((k1[..., off:off + hid].permute(3, 2, 0, 1).contiguous(),
                   b1[off:off + hid].contiguous(),
                   torch.cat([kg, kb], -1).permute(3, 2, 0, 1).contiguous(),
                   torch.cat([bg, bb])))
        off += hid
    return ws


def library_spade(seg, ws):
    """cuDNN's two convolutions per branch: the library call of
    spade_cond."""
    import torch.nn.functional as F

    xs_ = seg.permute(0, 3, 1, 2)
    return [F.conv2d(F.relu(F.conv2d(xs_, w1, b1, padding=1)), w2, b2,
                     padding=1) for w1, b1, w2, b2 in ws]


def bound_spade(seg, k1, b1, branches):
    """(operations ms, bytes ms, FLOP) of one call at the card's peaks."""
    import torch

    N, H, W, cnc = seg.shape
    px = N * H * W
    flops = sum(2 * 9 * px * (cnc * kg.shape[2] + kg.shape[2] * 2 * kg.shape[3])
                for kg, _, _, _ in branches)
    nbytes = sum(t.numel() * t.element_size() for t in
                 [seg, k1, b1] + [u for b in branches for u in b])
    nbytes += sum(px * 2 * kg.shape[3] * seg.element_size()
                  for kg, _, _, _ in branches)
    peak = PEAK_BF16_FLOPS if seg.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3, flops


def time_spade_calls(torch, calls):
    """Per recorded spade_cond call (seg, pack): the kernel's, the plain
    version's and the library call's device ms (cold L2) and the bound;
    returns (summed row fields, per-call lines, operations ms, bytes ms)."""
    from climategan_torch.kernels.spade_cond import (
        spade_cond_packed,
        spade_cond_plain,
    )

    t = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
         "bound_ms": 0.0}
    ops_ms = bytes_ms = 0.0
    lines = []
    for seg, pack in calls:
        ws = library_weights(*pack.args)
        k = device_ms(torch, lambda: spade_cond_packed(seg, pack), reps=5)
        pl = device_ms(torch, lambda: spade_cond_plain(seg, *pack.args), reps=5)
        lib = device_ms(torch, lambda: library_spade(seg, ws), reps=5)
        t_ops, t_bytes, flops = bound_spade(seg, *pack.args)
        b = max(t_ops, t_bytes)
        ops_ms += t_ops
        bytes_ms += t_bytes
        t["ms"] += k
        t["call_ms"] += cuda_ms(torch, lambda: spade_cond_packed(seg, pack))
        t["plain_ms"] += pl
        t["library_ms"] += lib
        t["bound_ms"] += b
        lines.append(f"  spade_cond {tuple(seg.shape)} "
                     f"nc={[c // 2 for c in pack.couts]}: kernel {k:.4f} "
                     f"plain {pl:.4f} library {lib:.4f} bound {b:.4f} ms "
                     f"({'operations' if t_ops >= t_bytes else 'bytes'}); "
                     f"{flops / k / 1e9:.1f} TFLOP/s, {100 * b / k:.1f}% of "
                     f"the bound")
    return t, lines, ops_ms, bytes_ms


def lsb_agreement(a, b):
    """(share of values within 1 LSB, max LSB) of two uint8 tensors."""
    lsb = (a.int() - b.int()).abs()
    return (lsb <= 1).float().mean().item(), lsb.max().item()


def serving_phase(torch, opts, dev) -> None:
    """Phase 6: the serving surface at full width (see the module
    docstring). cv2 is installed on the card's machine, so the CLI's main()
    runs on PNG files; its absence is a failure."""
    import tempfile

    import cv2
    import numpy as np
    import yaml

    from climategan_torch import apply_events as cli
    from climategan_torch import bench
    from climategan_torch import eval_masker
    from climategan_torch import kernels
    from climategan_torch.eval_metrics import (
        edges_coherence_std_min,
        masker_classification_metrics,
    )
    from climategan_torch.models.generator import create_generator
    from climategan_torch.utils import native
    from climategan_torch.utils.serving import load_inference_state
    from climategan_torch.utils.timer import stores_report

    log("serving phase: main() on PNG files in a temp dir (cv2 is present)")
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    run = root / "run"
    (run / "checkpoints").mkdir(parents=True)
    with (run / "opts.yaml").open("w") as f:
        yaml.safe_dump(json.loads(json.dumps(opts)), f)
    saved = create_generator(opts, seed=0).state_dict()
    torch.save({"G": saved}, run / "checkpoints" / "latest_ckpt.pth")
    _, loaded = load_inference_state(run)
    if sorted(loaded) != sorted(saved) or not all(
            torch.equal(loaded[k], saved[k]) for k in saved):
        raise AssertionError("load_inference_state did not return the saved "
                             "state dict")
    log(f"-r {run}: the loaded state dict equals the saved one on all "
        f"{len(saved)} keys")

    rng = np.random.default_rng(6)
    shapes = [(720, 1280, 3)] * 4 + [(1280, 960, 3)] * 3
    (root / "imgs").mkdir()
    for i, shape in enumerate(shapes):
        cv2.imwrite(str(root / "imgs" / f"photo_{i}.png"),
                    rng.integers(0, 256, shape, np.uint8))
    flags = ["-i", str(root / "imgs"), "-r", str(run), "-b", str(BATCH),
             "--half"]
    if not native.available():
        raise AssertionError("the native host-prep library did not build")
    kernels.reset_launches()
    if cli.main([*flags, "-o", str(root / "out"), "--time"]) != 0:
        raise AssertionError("apply_events main() failed")
    torch.cuda.synchronize()
    served = dict(kernels.launches)
    batches = -(-len(shapes) // BATCH)
    want = {k: batches * n for k, n in MAIN_PATH_LAUNCHES.items()}
    log(f"served {len(shapes)} photos in {batches} batches of {BATCH} (the "
        f"last padded): launches {served}")
    if served != want:
        raise AssertionError(f"expected serving launches {want}, got {served}")

    # the same prepped, padded batches through infer directly, with one
    # generator seeded as the CLI's
    args = cli.parse_args(flags)
    infer = cli.load_model(args)
    paths = cli.find_images(root / "imgs")
    photos = [(p.stem, cv2.imread(str(p), cv2.IMREAD_COLOR)[..., ::-1])
              for p in paths]
    xs = [cli.prep(img, args, True) for _, img in photos]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n_png = 0
    for i in range(0, len(xs), BATCH):
        batch = cli.pad_batch(np.stack(xs[i:i + BATCH]), BATCH)
        out = infer(torch.from_numpy(batch), generator=gen)
        for j, (name, _) in enumerate(photos[i:i + BATCH]):
            for event in cli.WRITTEN_EVENTS:
                png = cv2.imread(str(root / "out" / f"{name}_{event}.png"))
                direct = out[event][j].cpu().numpy()
                if png is None or direct.shape != (SIZE, SIZE, 3) or \
                        direct.dtype != np.uint8 or \
                        not np.array_equal(png[..., ::-1], direct):
                    raise AssertionError(f"{name}_{event}.png differs from "
                                         f"infer on the same batch")
                n_png += 1
    log(f"all {n_png} served PNGs are uint8 {SIZE}x{SIZE}x3 and bit-equal to "
        f"infer on the same prepped, padded batches")

    # information: served images/s on a steady stream, the decoded photos
    # repeated to STREAM photos (STREAM / BATCH batches), in turns: with
    # and without the overlap, PNG writes included, then with a writer that
    # keeps nothing (the loop without the encodes); the loop's rate leaves
    # out the prep of every photo, which render runs before its first batch
    def write_png(name, event, img):
        cv2.imwrite(str(root / "out" / f"{name}_{event}.png"), img[..., ::-1])

    stream = [(f"{name}_{k}", img) for k in range(-(-STREAM // len(photos)))
              for name, img in photos][:STREAM]
    modes = {"overlap": ([], write_png), "no_overlap": (["--no_overlap"], write_png),
             "overlap, no PNG": ([], lambda name, event, img: None)}
    x0 = torch.from_numpy(cli.pad_batch(np.stack(xs[:BATCH]), BATCH)).to(dev)
    rates, fwd = {}, []
    for _ in range(2):
        for mode, (extra, write) in modes.items():
            stores = cli.new_stores()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):  # per-batch lines
                cli.render(stream, cli.parse_args(flags + extra), write,
                           infer=infer, stores=stores)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prep_s = sum(stores["data pre-processing"])
            rates.setdefault(mode, []).append(
                (len(stream) / wall, len(stream) / (wall - prep_s)))
            log(f"render, {mode}, {len(stream)} photos: {wall:.3f} s\n"
                f"{stores_report(stores)}")
        # the forward alone over as many batches, on one batch on the card
        t0 = time.perf_counter()
        for _ in range(len(stream) // BATCH):
            infer(x0, generator=gen)
        torch.cuda.synchronize()
        fwd.append(len(stream) / (time.perf_counter() - t0))
    log(f"served images/s at batch {BATCH}, {len(stream)} photos (two runs "
        f"each, whole call / loop after the prep): " + "; ".join(
            f"{m} " + ", ".join(f"{a:.2f} / {b:.2f}" for a, b in v)
            for m, v in rates.items())
        + f"; the forward alone, {len(stream) // BATCH} batches enqueued back "
        f"to back: " + ", ".join(f"{r:.2f}" for r in fwd))

    # eval_masker's per-image path on two in-memory photos and labels
    eargs = eval_masker.build_parser().parse_args(
        ["--images_dir", ".", "--labels_dir", ".", "-r", str(run)])
    G = eval_masker.load_masker(eargs)
    # cannot-flood, a may-flood band and a 64^2 must-flood square: few
    # must edges keep the edge coherence's pairwise distances small
    label = np.zeros((SIZE, SIZE), np.uint8)
    label[SIZE // 2:] = 2
    label[-96:-32, SIZE // 2 - 32: SIZE // 2 + 32] = 1
    per_image, direct = [], []
    for name, img in photos[:2]:
        img = img[:SIZE, :SIZE]
        metrics, _, _, _, _ = eval_masker.score_image(G, img, label, SIZE, 0.5)
        per_image.append({**metrics, "image": name})
        x = torch.from_numpy(cli.uint8_to_m11(np.ascontiguousarray(img)))
        pred = G.infer_masker(x[None].permute(0, 3, 1, 2).contiguous().to(dev))[2]
        pred = pred[0, 0].float().cpu().numpy()
        want_m, _ = masker_classification_metrics(pred, label)
        want_m["edge_coherence"] = edges_coherence_std_min(pred, label, bin_th=0.5)[0]
        direct.append({**want_m, "image": name})
    report = {"summary": eval_masker.summarize(per_image), "per_image": per_image}
    if report["per_image"] != direct or \
            report["summary"] != eval_masker.summarize(direct):
        raise AssertionError("eval_masker's report differs from the metrics "
                             "of a direct G.infer_masker")
    log("eval_masker on 2 photos at 640^2: "
        + json.dumps({k: report["summary"][k] for k in
                      eval_masker.KEY_METRICS + ["accuracy"]})
        + "; equal to the metrics of a direct G.infer_masker")
    del G, infer
    tmp.cleanup()

    for b in (2, 8, 32):
        result = bench.run_bench(bench.parse_args(["--events", "all",
                                                   "--batch", str(b)]))
        log(json.dumps(result))
        if not result["gflops_per_image"] > 0 or not result["mfu"] <= 1.05:
            raise AssertionError(f"bench at batch {b}: {result}")
    log(f"serving phase: {time.perf_counter() - t_phase:.1f} s")


# parameters whose gradient is exactly zero in the default step: the ADVENT
# Ds' output biases, as the D step's WGAN losses on r (label 1) and s
# (label 0) give them -1 and +1
ZERO_GRADIENT = ("D.m_advent.conv4.module.bias", "D.s_advent.conv4.module.bias")


def training_phase(torch, dev) -> dict:
    """Phase 7: the training step (see the module docstring). Returns the
    launches of each kernel in one full-width step."""
    import copy
    import statistics

    from climategan_torch import bench_train, kernels
    from climategan_torch.kernels.masked_blend import (
        MaskedBlend,
        masked_blend_plain,
    )
    from climategan_torch.models.generator import OmniGenerator
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import (
        STATS,
        TINY_OVERRIDES,
        TINY_SIZE,
        first_moments,
        hold_state,
    )

    t_phase = time.perf_counter()
    # ---- 7.1 the card's step against the CPU's, f32 -------------------
    opts = load_opts(commandline_opts=TINY_OVERRIDES)
    builder = StepBuilder(opts)
    cpu = builder.init_state(seed=0, device="cpu")
    card = builder.state_for(copy.deepcopy(cpu.G).to(dev),
                             copy.deepcopy(cpu.D).to(dev))
    batch_cpu = bench_train.synthetic_batch(2, TINY_SIZE, 32, "cpu")
    batch_dev = {d: {k: v.to(dev) for k, v in b.items()}
                 for d, b in batch_cpu.items()}
    draws = ((0.05, False), (0.1, False))
    for i, name in enumerate(("g_step", "d_step")):
        if name == "d_step":  # from the CPU's post-g_step state on both
            card.G.load_state_dict(cpu.G.state_dict())
            card.D.load_state_dict(cpu.D.state_dict())
        _, m_cpu = getattr(builder, name)(cpu, batch_cpu, draws=draws[i])
        _, m_dev = getattr(builder, name)(card, batch_dev, draws=draws[i])
        for k, v in m_cpu.items():
            a, b = float(m_dev[k]), float(v)
            if abs(a - b) > 1e-4 * abs(b) + 1e-9:
                raise AssertionError(f"{name} {k}: card {a} cpu {b}")
        # the stepped model against its moments, the other one unchanged
        stepped = "G" if name == "g_step" else "D"
        for net, lr in (("G", builder.g_lr), ("D", builder.d_lr)):
            opt = f"{net.lower()}_opt"
            got, want = getattr(card, net), getattr(cpu, net)
            if net != stepped:
                hold_state(got, want.state_dict(), what=f"{name} {net}")
                continue
            log(f"tiny {name}, card vs CPU (f32): {len(m_cpu)} losses "
                "within 1e-4; statistics and u/v within 1e-5; "
                + hold_state(got, want.state_dict(), lr,
                             first_moments(got, getattr(card, opt)),
                             first_moments(want, getattr(cpu, opt)),
                             what=net))
    del cpu, card

    # ---- 7.2 masked_blend's gradient on the card -----------------------
    g = torch.Generator(device=dev).manual_seed(7)
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, None)):
        ins = [torch.rand(2, SIZE, SIZE, c, device=dev, generator=g)
               .to(dtype) for c in (3, 3, 1)]
        up = torch.randn(2, SIZE, SIZE, 3, device=dev, generator=g).to(dtype)
        want_in = [t.clone().requires_grad_() for t in ins]
        got_in = [t.clone().requires_grad_() for t in ins]
        want = torch.autograd.grad((masked_blend_plain(*want_in).float()
                                    * up.float()).sum(), want_in)
        got = torch.autograd.grad((MaskedBlend.apply(*got_in).float()
                                   * up.float()).sum(), got_in)
        errs = []
        for a, b in zip(got, want):
            bar = tol if tol is not None else \
                b.float().abs().max().item() * 2.0 ** -8
            err = (a.float() - b.float()).abs().max().item()
            if err > bar:
                raise AssertionError(f"masked_blend {dtype} gradient: "
                                     f"{err} > {bar}")
            errs.append(err)
        log(f"masked_blend autograd {dtype} (2, {SIZE}, {SIZE}, 3): max "
            f"gradient errors (x, fake, m) {errs}")

    # ---- 7.3 full width ------------------------------------------------
    torch.backends.cudnn.benchmark = False
    opts = load_opts()
    builder = StepBuilder(opts)
    t0 = time.perf_counter()
    state = builder.init_state(seed=0, device=dev)
    batch = bench_train.synthetic_batch(BATCH, SIZE, 160, dev)
    log(f"full-width training state built in {time.perf_counter() - t0:.1f} s")
    before = {f"{n}.{k}": v.detach().clone()
              for n, mod in (("G", state.G), ("D", state.D))
              for k, v in mod.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    state, metrics = builder.train_step(state, batch)
    torch.cuda.synchronize()
    counted = dict(kernels.launches)
    log(f"one full-width training step: launches {counted}")
    if counted["masked_blend"] != 2 or counted["spade_cond"] != 0 or any(
            counted[k] for k in EVENT_KERNELS):
        raise AssertionError("a training step launches masked_blend twice "
                             f"(a paste per step) and nothing else: {counted}")
    bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
    if bad:
        raise AssertionError(f"non-finite losses: {bad}")
    unchanged, stale = [], []
    for n, mod in (("G", state.G), ("D", state.D)):
        params = {k for k, _ in mod.named_parameters()}
        for k, v in mod.state_dict().items():
            # a 1-channel conv's u is +-1: its power iteration cannot move it
            if k.endswith("num_batches_tracked") or (
                    k.endswith("weight_u") and v.numel() == 1):
                continue
            same = torch.equal(v, before[f"{n}.{k}"])
            if same and k in params and f"{n}.{k}" not in ZERO_GRADIENT:
                unchanged.append(f"{n}.{k}")
            elif same and k.rsplit(".", 1)[-1] in STATS:
                stale.append(f"{n}.{k}")
    n_params = sum(1 for mod in (state.G, state.D)
                   for _ in mod.named_parameters())
    log(f"after one step: {n_params - len(ZERO_GRADIENT) - len(unchanged)} "
        f"of {n_params} parameter tensors changed (not counted: "
        f"{', '.join(ZERO_GRADIENT)}, whose gradient is exactly zero); "
        f"statistics and u/v not advanced: {len(stale)}")
    if unchanged or stale:
        raise AssertionError(f"unchanged parameters {unchanged[:20]}; "
                             f"statistics or u/v not advanced {stale[:20]}")
    del before
    losses = {k: round(float(v), 4) for k, v in metrics.items()}
    log(f"losses: {losses}")
    state, _ = builder.train_step(state, batch)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = builder.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    log(f"full-width training step (default opts, {SIZE}^2, batch {BATCH} "
        f"per domain, bf16 policy): p50 {1e3 * p50:.2f} ms, "
        f"{3 * BATCH / p50:.3f} img/s; steps "
        + ", ".join(f"{1e3 * t:.2f}" for t in times)
        + f" ms; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; g_total {float(metrics['g_total']):.4f} d_total "
        f"{float(metrics['d_total']):.4f}")

    # information: where one step's time goes; g_step and d_step timed
    # apart (a synchronise between them)
    split = {"g_step": [], "d_step": []}
    for _ in range(3):
        for name in split:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = getattr(builder, name)(state, batch)
            torch.cuda.synchronize()
            split[name].append(1e3 * (time.perf_counter() - t0))
    log("g_step / d_step apart (ms): " + "; ".join(
        f"{k} " + ", ".join(f"{t:.2f}" for t in v) for k, v in split.items()))
    holder = [state]

    def one_step():
        holder[0], _ = builder.train_step(holder[0], batch)

    table, busy, n_dev, wall = device_profile(torch, one_step)
    state = holder[0]
    log(f"one training step under torch.profiler: {wall:.2f} ms wall, "
        f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%) over {n_dev} "
        f"kernels and copies\n{table}")

    # eval() re-bakes and re-packs: the trained model serves its weights
    G = state.G.eval()
    fresh = OmniGenerator(G.cfg)
    fresh.load_state_dict(G.state_dict())
    fresh = fresh.to(dev).eval()  # baked and packed on the card, as G
    x = batch["r"]["x"]
    uniform = torch.rand(9, 9, device=dev, generator=g)
    outs = []
    with torch.no_grad():
        for model in (G, fresh):
            d, s, m = model.infer_masker(x)
            flood = model.paint_cloudy((m > 0.5).float(), x, s,
                                       uniform=uniform)
            outs.append((d, s, m, flood))
    for a, b in zip(*outs):
        if not torch.equal(a, b):
            raise AssertionError("eval() after training differs from a fresh "
                                 "load of the trained weights")
    log("eval() after training: masker and cloudy flood bit-equal (f32) to a "
        "fresh load of the trained state_dict()")
    del state, G, fresh, outs, batch
    torch.cuda.empty_cache()

    # ---- 7.4 the bench -------------------------------------------------
    out = subprocess.run(
        [sys.executable, "-m", "climategan_torch.bench_train"],
        cwd=ROOT, check=True, capture_output=True, text=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    if not line["value"] > 0 or not line["max_memory_allocated"]:
        raise AssertionError(f"bench_train: {line}")
    log(json.dumps(line))
    log(f"training phase: {time.perf_counter() - t_phase:.1f} s")
    return {k: counted[k] for k in kernels.launches}


# phase 8: the synthetic dataset and the trainer's runs
TRAIN_SAMPLES, VAL_SAMPLES = 16, 4
PHOTO_HW = (720, 960)
TRAIN_BATCH, BIG_BATCH = 2, 6
TRAINER_TIMEOUT = 900


def write_training_dataset(root: Path) -> dict:
    """TRAIN_SAMPLES train and VAL_SAMPLES val samples per domain (r, s, rf)
    as PNGs at PHOTO_HW, in the layout of tests/test_trainer_integration.py
    (x and m everywhere; s adds Unity-coded depth and integer seg labels);
    returns the file lists {"train": {domain: json}, "val": {...}}."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np

    h, w = PHOTO_HW
    jobs, lists = [], {"train": {}, "val": {}}
    for mode, n in (("train", TRAIN_SAMPLES), ("val", VAL_SAMPLES)):
        for domain in ("r", "s", "rf"):
            d = root / mode / domain
            d.mkdir(parents=True)
            samples = []
            for i in range(n):
                e = {"x": str(d / f"x_{i}.png"), "m": str(d / f"m_{i}.png")}
                if domain == "s":
                    e["d"] = str(d / f"d_{i}.png")
                    e["s"] = str(d / f"s_{i}.png")
                samples.append(e)
                jobs.append((e, len(jobs)))
            lp = root / f"{mode}_{domain}.json"
            lp.write_text(json.dumps(samples))
            lists[mode][domain] = str(lp)

    def write(job):
        e, seed = job
        r = np.random.default_rng(seed)
        cv2.imwrite(e["x"], r.integers(0, 256, (h, w, 3), np.uint8))
        cv2.imwrite(e["m"], (r.random((h, w)) > 0.5).astype(np.uint8) * 255)
        if "d" in e:  # R, G in range: the decoded depth stays positive
            rgb = np.stack([np.full((h, w), 100, np.uint8),
                            np.full((h, w), 100, np.uint8),
                            r.integers(0, 254, (h, w), np.uint8)], -1)
            cv2.imwrite(e["d"], rgb[..., ::-1])
            cv2.imwrite(e["s"], r.integers(0, 11, (h, w), np.uint8))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    return lists


def train_cli(args) -> list:
    """`python -m climategan_torch.train` in a subprocess on the card; its
    train.jsonl records."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "climategan_torch.train",
                          *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=TRAINER_TIMEOUT)
    tail = "\n".join(out.stdout.splitlines()[-12:])
    log(f"python -m climategan_torch.train (rc {out.returncode}, "
        f"{time.perf_counter() - t0:.1f} s):\n{tail}")
    if out.returncode != 0:
        raise AssertionError(f"the trainer failed:\n{out.stderr[-4000:]}")
    run_dir = Path(next(a.split("=", 1)[1] for a in args
                        if a.startswith("output_path=")))
    return [json.loads(line) for line in
            (run_dir / "train.jsonl").read_text().splitlines()]


def epoch_record(records, epoch: int) -> dict:
    """The epoch's steps record merged with its launches record."""
    rec = {}
    for r in records:
        if r.get("epoch") == epoch:
            rec.update(r)
    if "steps" not in rec or "launches" not in rec:
        raise AssertionError(f"no record of epoch {epoch}: {records}")
    return rec


def trainer_phase(torch, dev) -> dict:
    """Phase 8: the trainer through its entry point (see the module
    docstring). Returns the launches of each kernel in the first run's
    epoch."""
    import os
    import tempfile

    import cv2
    import numpy as np

    from climategan_torch import apply_events as cli
    from climategan_torch import bench_train, kernels
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.trainer import Trainer
    from climategan_torch.utils.checkpoint import read_checkpoint, state_digest
    from climategan_torch.utils.opts import load_opts

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    t0 = time.perf_counter()
    lists = write_training_dataset(root / "data")
    log(f"trainer phase: wrote {3 * (TRAIN_SAMPLES + VAL_SAMPLES)} samples "
        f"at {PHOTO_HW[0]}x{PHOTO_HW[1]} in {time.perf_counter() - t0:.1f} s")
    run = root / "run"
    args = [f"data.files.train={json.dumps(lists['train'])}",
            f"data.files.val={json.dumps(lists['val'])}",
            f"data.loaders.batch_size={TRAIN_BATCH}", f"output_path={run}"]

    # ---- 8.1 one epoch at the default opts, full width -----------------
    records = train_cli(args + ["train.epochs=1"])
    first = epoch_record(records, 0)
    steps = TRAIN_SAMPLES // TRAIN_BATCH
    if first["steps"] != steps:
        raise AssertionError(f"epoch 0 took {first['steps']} steps, not "
                             f"{steps}")
    launches = first["launches"]
    if not launches["spade_cond"] > 0 or not launches["masked_blend"] > 0:
        raise AssertionError(f"the trainer's epoch did not launch spade_cond "
                             f"and masked_blend: {launches}")
    val = {k: v for r in records for k, v in r.items() if k.startswith("val")}
    if not val or not all(np.isfinite(v) for v in val.values()):
        raise AssertionError(f"validation metrics: {val}")
    ckpts = run / "checkpoints"
    for name in ("latest_ckpt.pth", "latest.json"):
        if not (ckpts / name).is_file():
            raise AssertionError(f"no checkpoints/{name}")
    if not (run / "opts.json").is_file():
        raise AssertionError("no opts.json")
    saved = ckpts / "saved_epoch_0.pth"  # the epoch-0 file, kept by a link
    os.link(ckpts / "latest_ckpt.pth", saved)
    walls = first["step_s"][1:]
    waits = first["loader_wait_s"][1:]
    n_img = 3 * TRAIN_BATCH * len(walls)
    log(f"trainer epoch (default opts, {SIZE}^2, batch {TRAIN_BATCH} per "
        f"domain, {steps} steps, PNGs at {PHOTO_HW[0]}x{PHOTO_HW[1]}): steps "
        f"2-{steps}: {len(walls) / sum(walls):.4f} steps/s, "
        f"{n_img / sum(walls):.3f} img/s; waiting on the loader "
        f"{100 * sum(waits) / sum(walls):.1f}% of those steps' time "
        "(per step: " + ", ".join(f"{100 * a / b:.1f}%"
                                  for a, b in zip(waits, walls)) + ")")
    # the loader prefetches num_workers + 1 batches per domain while the
    # first step waits, which covers most of a short epoch: the whole
    # epoch's rate is the one a long run sees
    log(f"trainer epoch whole: {steps} steps in {first['epoch_time_s']:.2f} "
        f"s, {steps / first['epoch_time_s']:.4f} steps/s, "
        f"{3 * TRAIN_BATCH * steps / first['epoch_time_s']:.3f} img/s; "
        f"waiting on the loader {sum(first['loader_wait_s']):.2f} s "
        f"({100 * sum(first['loader_wait_s']) / first['epoch_time_s']:.1f}%)")
    log("trainer step host seconds: " + ", ".join(
        f"{t:.3f}" for t in first["step_s"]) + "; loader waits: " + ", ".join(
        f"{t:.3f}" for t in first["loader_wait_s"]))
    log(f"trainer evaluation {first['eval_s']:.2f} s; checkpoint "
        f"{first['ckpt_bytes']:,} B written in {first['save_s']:.2f} s; peak "
        f"memory {first['max_memory_allocated']:,} B "
        f"({first['max_memory_allocated'] / 2**30:.2f} GiB) at batch "
        f"{TRAIN_BATCH}; launches over the epoch {launches}")
    log(f"validation: " + ", ".join(f"{k} {v:.4f}" for k, v in val.items()))

    # ---- 8.2 resume into epoch 1 ---------------------------------------
    records = train_cli(args + ["train.epochs=2", "args.resume=true"])
    resumed = [r for r in records if "resumed_from_epoch" in r]
    want = state_digest(read_checkpoint(saved))
    if len(resumed) != 1 or resumed[0]["resumed_from_epoch"] != 0 or \
            resumed[0]["state_digest"] != want:
        raise AssertionError(f"resume: {resumed}, saved state {want}")
    second = epoch_record(records, 1)
    latest = read_checkpoint(ckpts / "latest_ckpt.pth")
    if second["steps"] != steps or latest["epoch"] != 1 or \
            latest["step"] != 2 * steps:
        raise AssertionError(f"epoch 1: {second['steps']} steps, latest "
                             f"checkpoint epoch {latest['epoch']} step "
                             f"{latest['step']}")
    log(f"resumed at epoch 1 with the state of the epoch-0 checkpoint bit "
        f"for bit (sha256 {want[:16]}...); epoch 1: {second['steps']} "
        f"steps, launches {second['launches']}, evaluation "
        f"{second['eval_s']:.2f} s, save {second['save_s']:.2f} s")
    del latest
    saved.unlink()

    # ---- 8.3 serve the run dir -----------------------------------------
    rng = np.random.default_rng(8)
    (root / "imgs").mkdir()
    for i in range(2):
        cv2.imwrite(str(root / "imgs" / f"photo_{i}.png"),
                    rng.integers(0, 256, (720, 1280, 3), np.uint8))
    kernels.reset_launches()
    if cli.main(["-i", str(root / "imgs"), "-o", str(root / "out"), "-r",
                 str(run), "-b", "2", "--half"]) != 0:
        raise AssertionError("apply_events -r <run dir> failed")
    torch.cuda.synchronize()
    served = dict(kernels.launches)
    for i in range(2):
        for event in cli.WRITTEN_EVENTS:
            img = cv2.imread(str(root / "out" / f"photo_{i}_{event}.png"))
            if img is None or img.shape != (SIZE, SIZE, 3) or \
                    img.dtype != np.uint8:
                raise AssertionError(f"photo_{i}_{event}.png: "
                                     f"{None if img is None else img.shape}")
    if served != MAIN_PATH_LAUNCHES:
        raise AssertionError(f"serving the run dir launched {served}")
    trainer = Trainer.resume_from_path(run, device=dev)
    x = torch.rand(2, SIZE, SIZE, 3, device=dev) * 2 - 1
    kernels.reset_launches()
    out = trainer.infer_all(x, numpy=False)
    inferred = dict(kernels.launches)
    for event in cli.WRITTEN_EVENTS:
        if out[event].shape != (2, SIZE, SIZE, 3) or \
                out[event].dtype != torch.uint8:
            raise AssertionError(f"infer_all {event}: {out[event].shape}")
    if inferred != MAIN_PATH_LAUNCHES:
        raise AssertionError(f"infer_all launched {inferred}")
    log(f"apply_events -r <run dir>: 2 photos, 3 events each, uint8 "
        f"{SIZE}x{SIZE}x3, launches {served}; Trainer.resume_from_path + "
        f"infer_all: launches {inferred}")
    del trainer, out

    # ---- 8.4 one step at the default batch -----------------------------
    torch.cuda.empty_cache()
    builder = StepBuilder(load_opts())
    state = builder.init_state(seed=0, device=dev)
    batch = bench_train.synthetic_batch(BIG_BATCH, SIZE, 160, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = builder.train_step(state, batch)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not all(torch.isfinite(v).all() for v in metrics.values()):
        raise AssertionError("non-finite losses at the default batch")
    log(f"one step at the default batch ({BIG_BATCH} per domain, "
        f"{3 * BIG_BATCH} images, first step): {t_big:.2f} s, peak memory "
        f"{peak:,} B ({peak / 2**30:.2f} GiB)")
    del state, batch, metrics
    torch.cuda.empty_cache()
    total = {k: first["launches"][k] + second["launches"][k] + served[k]
             + inferred[k] for k in launches}
    log(f"launches over the trainer phase (two epochs, serving, infer_all): "
        f"{total}")
    log(f"trainer phase: {time.perf_counter() - t_phase:.1f} s")
    tmp.cleanup()
    return launches


# phase 9: the other generator configurations
SPADE_MASKER = ["gen.m.use_spade=true"]  # the default gen.m.spade: cond_nc 15
MASK_DECODER_CALLS = 6  # a dual and a norm_1 launch in each of 3 blocks
CONFIG_RUNS = {
    "mobilenet": ["gen.deeplabv3.backbone=mobilenet"],
    "deeplabv2": ["gen.encoder.architecture=deeplabv2",
                  "gen.s.architecture=deeplabv2"],
    "classification": ["gen.d.architecture=base", "gen.d.classify.enable=true",
                       "gen.m.use_dada=false", "gen.s.use_dada=false"],
    "painter_z": ["gen.p.no_z=false"],
    "final_shortcut": ["gen.p.use_final_shortcut=true"],
    "batch_spade": ["gen.p.spade_param_free_norm=batch"],
}


def narrow_w1(k1, hids):
    """The (10 taps, hid_pad, 8) w1 layout of cnc <= 8 as the parent
    revision packed it, built apart from pack_spade_cond."""
    import torch
    import torch.nn.functional as F

    cnc, out, off = k1.shape[2], [], 0
    for h in hids:
        w = k1[..., off:off + h].reshape(9, cnc, h).permute(0, 2, 1)
        out.append(F.pad(w, (0, 8 - cnc, 0, -(-h // 32) * 32 - h, 0, 1))
                   .reshape(-1))
        off += h
    return torch.cat(out)


def card_vs_cpu(torch, opts, what, z_shape=None):
    """The model of ``opts`` (seed 0) in f32 at SMALL^2 on the card and on
    the CPU with the same draws (and the same z, where the painter takes
    one): the smooth masks within atol 1e-3, every event within 1 LSB on
    >= 99.9% of values."""
    from climategan_torch.inference import build_infer_fn

    xs = torch.rand(1, SMALL, SMALL, 3,
                    generator=torch.Generator().manual_seed(2)) * 2 - 1
    us = torch.rand(9, 9, generator=torch.Generator().manual_seed(3))
    z = None
    if z_shape is not None:
        z = torch.randn(z_shape, generator=torch.Generator().manual_seed(4))
    res = {}
    for where in ("cuda", "cpu"):
        _, inf = build_infer_fn(opts, dtype=torch.float32, bin_value=-1,
                                device=where, seed=0)
        res[where] = {k: v.cpu() for k, v in inf(
            xs, uniform=us, g_value=G_VALUE,
            z=None if z is None else z.to(where)).items()}
    err = (res["cuda"]["mask"] - res["cpu"]["mask"]).abs().max().item()
    agree = {k: lsb_agreement(res["cuda"][k], res["cpu"][k])
             for k in ("flood", "wildfire", "smog")}
    log(f"{what}, card vs CPU at {SMALL}^2 f32: mask max err {err:.3e}; "
        + ", ".join(f"{k} within 1 LSB on {100 * a:.4f}% (max {m} LSB)"
                    for k, (a, m) in agree.items()))
    if not err <= 1e-3 or not all(a >= 0.999 for a, _ in agree.values()):
        raise AssertionError(f"{what}: card and CPU disagree")


def check_outputs(torch, out, what):
    for key in ("flood", "wildfire", "smog"):
        v = out[key]
        if v.shape != (BATCH, SIZE, SIZE, 3) or v.dtype != torch.uint8:
            raise AssertionError(f"{what} {key} {tuple(v.shape)} {v.dtype}")
    m = out["mask"].float()
    if m.shape != (BATCH, SIZE, SIZE, 1) or not torch.isfinite(m).all() \
            or not (0 <= m.min() <= m.max() <= 1):
        raise AssertionError(f"{what}: the mask is not finite in [0, 1]")


def spade_step_tiny(torch, dev) -> None:
    """The SPADE masker's g_step then d_step at tiny_opts(32)'s sizes, card
    vs CPU in f32 from the same seed-0 state: every loss within 1e-4
    relative, both models held by hold_state. The CPU side runs its convs
    with oneDNN off: with oneDNN on, one pre-activation of the painter's
    last leaky ReLU (final_spade's output at (1, 1, 27, 7)) comes out
    +5.96e-7 where float64 gives -9.40e-5 and oneDNN off -6.53e-6, and that
    one kink moves the G step's painter gradients up to 0.8% of a leaf's
    largest, more than hold_state's 1e-3."""
    import copy

    from climategan_torch import bench_train
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import (
        TINY_OVERRIDES,
        TINY_SIZE,
        first_moments,
        hold_state,
    )

    with torch.inference_mode(False), torch.enable_grad():
        tiny = load_opts(path=TINY_OVERRIDES, commandline_opts=[
            *SPADE_MASKER, "gen.m.spade.latent_dim=32"])
        builder = StepBuilder(tiny)
        cpu = builder.init_state(seed=0, device="cpu")
        card = builder.state_for(copy.deepcopy(cpu.G).to(dev),
                                 copy.deepcopy(cpu.D).to(dev))
        batch_cpu = bench_train.synthetic_batch(2, TINY_SIZE, 32, "cpu")
        batch_dev = {d: {k: v.to(dev) for k, v in b.items()}
                     for d, b in batch_cpu.items()}
        draws = ((0.05, False), (0.1, False))
        for i, name in enumerate(("g_step", "d_step")):
            if name == "d_step":
                card.G.load_state_dict(cpu.G.state_dict())
                card.D.load_state_dict(cpu.D.state_dict())
            with torch.backends.mkldnn.flags(enabled=False):
                _, m_cpu = getattr(builder, name)(cpu, batch_cpu,
                                                  draws=draws[i])
            _, m_dev = getattr(builder, name)(card, batch_dev, draws=draws[i])
            for k, v in m_cpu.items():
                a, b = float(m_dev[k]), float(v)
                if abs(a - b) > 1e-4 * abs(b) + 1e-9:
                    raise AssertionError(f"SPADE masker {name} {k}: card {a} "
                                         f"cpu {b}")
            net, lr = (("G", builder.g_lr) if name == "g_step"
                       else ("D", builder.d_lr))
            opt = f"{net.lower()}_opt"
            got = getattr(card, net)
            log(f"SPADE masker tiny {name}, card vs CPU (f32, oneDNN off): "
                + hold_state(got, getattr(cpu, net).state_dict(), lr,
                             first_moments(got, getattr(card, opt)),
                             first_moments(getattr(cpu, net),
                                           getattr(cpu, opt)),
                             what=net))


def configs_phase(torch, dev, x, uniform, infer_default, painter_calls) -> dict:
    """Phase 9: the SPADE mask decoder and the other generator
    configurations (see the module docstring). Returns the SPADE masker's
    kernel numbers and every configuration's launches."""
    import statistics
    import tempfile

    import cv2
    import numpy as np
    import yaml

    from climategan_torch import apply_events as cli
    from climategan_torch import bench, bench_train, kernels
    from climategan_torch.inference import build_infer_fn
    from climategan_torch.kernels.spade_cond import (
        spade_cond,
        spade_cond_packed,
        spade_cond_plain,
    )
    from climategan_torch.models import norms as norms_mod
    from climategan_torch.models.generator import create_generator
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts

    t_phase = time.perf_counter()
    g_dev = torch.tensor(G_VALUE, device=dev)
    paths = {}

    # ---- 9.1 the painter's cnc-3 packs keep their layout ----------------
    for seg, pack in painter_calls:
        if not torch.equal(pack.w1.view(torch.int16),
                           narrow_w1(pack.args[0], pack.hids).view(torch.int16)):
            raise AssertionError(f"spade_cond {tuple(seg.shape)}: the cnc-3 "
                                 "pack's w1 is not the (10, hid_pad, 8) layout")
    log(f"the painter's {len(painter_calls)} cnc-3 packs: w1 byte-equal to "
        "the (10 taps, hid_pad, 8) layout")

    # ---- 9.2 the SPADE masker: its cnc-15 calls vs plain ----------------
    opts = load_opts(commandline_opts=SPADE_MASKER)
    G, infer = build_infer_fn(opts, dtype=torch.bfloat16, device=dev, seed=0)
    calls = []

    def record(seg, pack):
        calls.append((seg, pack))
        return spade_cond_packed(seg, pack)

    norms_mod.spade_cond_packed = record
    try:
        infer(x, uniform=uniform, g_value=g_dev)
    finally:
        norms_mod.spade_cond_packed = spade_cond_packed
    torch.cuda.synchronize()
    mask_calls = [(seg, pack) for seg, pack in calls if seg.shape[3] == 15]
    if len(mask_calls) != MASK_DECODER_CALLS or \
            len(calls) != 18 + MASK_DECODER_CALLS:
        raise AssertionError(f"{len(calls)} spade_cond calls, "
                             f"{len(mask_calls)} at cnc 15")
    err = [0.0, 0.0]
    for seg, pack in mask_calls:
        a32 = (seg.float(), pack.args[0].float(), pack.args[1].float(),
               [tuple(t.float() for t in b) for b in pack.args[2]])
        plain = spade_cond_plain(*a32)
        for got, want in zip(spade_cond(*a32), plain):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            err[0] = max(err[0], (got - want).abs().max().item())
        for got, want in zip(spade_cond_packed(seg, pack), plain):
            ulp = 2.0 ** (torch.floor(torch.log2(want.abs().max())).item() - 7)
            e = (got.float() - want).abs().max().item()
            if not e <= ulp:
                raise AssertionError(f"spade_cond bf16 cnc 15 "
                                     f"{tuple(seg.shape)}: max error {e} > "
                                     f"one ulp {ulp}")
            err[1] = max(err[1], e)
    log(f"SPADE masker: {len(mask_calls)} cnc-15 spade_cond calls "
        + ", ".join(f"{tuple(s.shape)} nc={[c // 2 for c in p.couts]}"
                    for s, p in mask_calls)
        + f"; vs plain max err f32 {err[0]:.3e} bf16 {err[1]:.3e}")

    # ---- 9.3 its main path ----------------------------------------------
    kernels.reset_launches()
    out = infer(x, uniform=uniform, g_value=g_dev)
    torch.cuda.synchronize()
    paths["spade_masker"] = dict(kernels.launches)
    want = {**MAIN_PATH_LAUNCHES, "spade_cond": 18 + MASK_DECODER_CALLS}
    log(f"SPADE masker path launches: {paths['spade_masker']}")
    if paths["spade_masker"] != want:
        raise AssertionError(f"expected {want}")
    check_outputs(torch, out, "SPADE masker")
    fns = {"default": infer_default, "spade": infer}
    turns = [cuda_ms(torch, lambda: fns[k](x, uniform=uniform, g_value=g_dev),
                     reps=3) for k in ("default", "spade", "spade", "default")]
    default_ms, spade_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    log(f"all events {SIZE}^2 bf16 batch {BATCH}, in turns (default, SPADE "
        f"masker, SPADE masker, default): " + ", ".join(f"{t:.2f}" for t in turns)
        + f" ms; default {default_ms:.2f} ms ({1e3 * BATCH / default_ms:.3f} "
        f"img/s), SPADE masker {spade_ms:.2f} ms ({1e3 * BATCH / spade_ms:.3f} "
        f"img/s)")
    t_mask, lines, ops_ms, bytes_ms = time_spade_calls(torch, mask_calls)
    for line in lines:
        log(line)
    log(f"the mask decoder's {len(mask_calls)} spade_cond calls: kernel "
        f"{t_mask['ms']:.4f} ms, bound {t_mask['bound_ms']:.4f} ms "
        f"({100 * t_mask['bound_ms'] / t_mask['ms']:.1f}%), plain "
        f"{t_mask['plain_ms']:.4f} ms, library {t_mask['library_ms']:.4f} ms")
    spade_row = {"launches": paths["spade_masker"]["spade_cond"],
                 "mask_decoder_calls": len(mask_calls),
                 "mask_decoder_max_abs_err": err[0],
                 "mask_decoder_max_abs_err_bf16": err[1],
                 **{f"mask_decoder_{k}": v for k, v in t_mask.items()},
                 "mask_decoder_bound_by": ("operations" if ops_ms >= bytes_ms
                                           else "bytes"),
                 "forward_ms": spade_ms, "default_forward_ms": default_ms}
    del calls, mask_calls
    card_vs_cpu(torch, opts, "SPADE masker")
    result = bench.run_bench(bench.parse_args(
        ["--events", "all", "--batch", str(BATCH), "--iters", "3",
         *SPADE_MASKER]))
    log(json.dumps(result))

    # ---- 9.4 served from a run dir ---------------------------------------
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    run_dir = root / "run"
    (run_dir / "checkpoints").mkdir(parents=True)
    with (run_dir / "opts.yaml").open("w") as f:
        yaml.safe_dump(json.loads(json.dumps(opts)), f)
    torch.save({"G": create_generator(opts, seed=0).state_dict()},
               run_dir / "checkpoints" / "latest_ckpt.pth")
    rng = np.random.default_rng(7)
    (root / "imgs").mkdir()
    for i in range(BATCH):
        cv2.imwrite(str(root / "imgs" / f"photo_{i}.png"),
                    rng.integers(0, 256, (720, 960, 3), np.uint8))
    flags = ["-i", str(root / "imgs"), "-r", str(run_dir), "-b", str(BATCH),
             "--half"]
    kernels.reset_launches()
    if cli.main([*flags, "-o", str(root / "out")]) != 0:
        raise AssertionError("apply_events main() failed on the SPADE masker")
    torch.cuda.synchronize()
    if dict(kernels.launches) != want:
        raise AssertionError(f"served launches {dict(kernels.launches)}")
    args = cli.parse_args(flags)
    served = cli.load_model(args)
    photos = [(p.stem, cv2.imread(str(p), cv2.IMREAD_COLOR)[..., ::-1])
              for p in cli.find_images(root / "imgs")]
    batch = np.stack([cli.prep(img, args, True) for _, img in photos])
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    direct = served(torch.from_numpy(cli.pad_batch(batch, BATCH)), generator=gen)
    for j, (name, _) in enumerate(photos):
        for event in cli.WRITTEN_EVENTS:
            png = cv2.imread(str(root / "out" / f"{name}_{event}.png"))
            if png is None or not np.array_equal(
                    png[..., ::-1], direct[event][j].cpu().numpy()):
                raise AssertionError(f"{name}_{event}.png differs from infer")
    log(f"apply_events -r <run dir with gen.m.use_spade>: {len(photos)} "
        f"photos, launches {want}, every PNG bit-equal to infer")
    del served, direct, G, infer
    tmp.cleanup()

    # ---- 9.5 its training step -------------------------------------------
    spade_step_tiny(torch, dev)
    with torch.inference_mode(False), torch.enable_grad():
        builder = StepBuilder(opts)
        state = builder.init_state(seed=0, device=dev)
        batch = bench_train.synthetic_batch(BATCH, SIZE, 160, dev)
        before = {n: p.detach().clone()
                  for n, p in state.G.decoders["m"].named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        state, metrics = builder.train_step(state, batch)
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        still = [n for n, p in state.G.decoders["m"].named_parameters()
                 if torch.equal(p, before[n])]
        if bad or still:
            raise AssertionError(f"SPADE masker step: non-finite {bad}, "
                                 f"mask decoder unchanged {still[:10]}")
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = builder.train_step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        p50 = statistics.median(times[1:])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"SPADE masker full-width training step ({SIZE}^2, batch {BATCH} "
            f"per domain, bf16 policy): finite losses, every mask-decoder "
            f"parameter moved; p50 {1e3 * p50:.2f} ms ({3 * BATCH / p50:.3f} "
            f"img/s), steps " + ", ".join(f"{1e3 * t:.2f}" for t in times)
            + f" ms; peak memory {peak:.2f} GiB")
        spade_row.update(train_step_ms=1e3 * p50, train_peak_gib=peak)
        del state, batch, before
        torch.cuda.empty_cache()

    # ---- 9.6 one full-width forward of each other configuration ----------
    for name, overrides in CONFIG_RUNS.items():
        copts = load_opts(commandline_opts=overrides)
        Gc, inf = build_infer_fn(copts, dtype=torch.bfloat16, device=dev,
                                 seed=0)
        kernels.reset_launches()
        out = inf(x, uniform=uniform, g_value=g_dev)
        torch.cuda.synchronize()
        paths[name] = dict(kernels.launches)
        if paths[name] != MAIN_PATH_LAUNCHES:
            raise AssertionError(f"{name}: launches {paths[name]}")
        check_outputs(torch, out, name)
        ms = cuda_ms(torch, lambda: inf(x, uniform=uniform, g_value=g_dev),
                     reps=3)
        log(f"{name}: {SIZE}^2 bf16 batch {BATCH} all events {ms:.2f} ms "
            f"({1e3 * BATCH / ms:.3f} img/s), launches {paths[name]}")
        z_shape = None
        if not Gc.cfg.p_no_z:
            s = SMALL // 2 ** Gc.cfg.p_spade_n_up
            z_shape = (1, Gc.cfg.p_latent_dim, s, s)
        del Gc, inf, out
        card_vs_cpu(torch, copts, name, z_shape)

    # ---- 9.7 bench_train on depth classification (bucket targets) --------
    out = subprocess.run(
        [sys.executable, "-m", "climategan_torch.bench_train", "--warmup", "1",
         "--iters", "2", *CONFIG_RUNS["classification"]],
        cwd=ROOT, check=True, capture_output=True, text=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    if not line["value"] > 0 or not line["max_memory_allocated"]:
        raise AssertionError(f"bench_train classification: {line}")
    log("bench_train " + " ".join(CONFIG_RUNS["classification"]) + ": "
        + json.dumps(line))
    log(f"configurations phase: {time.perf_counter() - t_phase:.1f} s")
    return {"spade_cond": spade_row, "paths": paths}


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
    from climategan_torch.events import fire as fire_mod
    from climategan_torch.events import smog as smog_mod
    from climategan_torch.inference import build_infer_fn
    from climategan_torch.kernels import _build
    from climategan_torch.kernels.fire_color_grade import (
        fire_color_grade,
        fire_color_grade_plain,
    )
    from climategan_torch.kernels.fire_paste import fire_paste, fire_paste_plain
    from climategan_torch.kernels.masked_blend import (
        masked_blend,
        masked_blend_plain,
    )
    from climategan_torch.kernels.smog_tail import smog_tail, smog_tail_plain
    from climategan_torch.kernels.spade_cond import (
        spade_cond,
        spade_cond_packed,
        spade_cond_plain,
    )
    from climategan_torch.kernels import masked_blend as masked_blend_mod
    from climategan_torch.models import norms as norms_mod
    from climategan_torch.ops.image import retrieve_sky_mask, unit_range_to_uint8
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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
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
    g_dev = torch.tensor(G_VALUE, device=dev)
    t0 = time.perf_counter()
    G, infer = build_infer_fn(opts, dtype=torch.bfloat16, device=dev, seed=0,
                              ignore_event=())
    n_params = sum(p.numel() for p in G.parameters())
    log(f"full-width model: {n_params / 1e6:.1f}M params, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 2. kernels vs plain on the main path's own inputs --------------
    # (module, attribute, kernel): the modules call spade_cond_packed on the
    # weights packed when the model was built; a spade_cond call records
    # (seg, pack)
    patched = [(norms_mod, "spade_cond_packed", "spade_cond", spade_cond_packed),
               (masked_blend_mod, "masked_blend", "masked_blend", masked_blend),
               (smog_mod, "smog_tail", "smog_tail", smog_tail),
               (fire_mod, "fire_color_grade", "fire_color_grade", fire_color_grade),
               (fire_mod, "fire_paste", "fire_paste", fire_paste)]
    calls = {name: [] for _, _, name, _ in patched}

    def recorder(name, fn):
        def record(*args):
            calls[name].append(args)
            return fn(*args)
        return record

    for mod, attr, name, fn in patched:
        setattr(mod, attr, recorder(name, fn))
    try:
        infer(x, uniform=uniform, g_value=g_dev)
    finally:
        for mod, attr, _, fn in patched:
            setattr(mod, attr, fn)
    torch.cuda.synchronize()
    log("recorded calls: " + ", ".join(f"{len(v)} {k}" for k, v in calls.items()))

    def f32(args):
        seg, k1, b1, branches = args
        return (seg.float(), k1.float(), b1.float(),
                [tuple(t.float() for t in b) for b in branches])

    err = {name: [0.0, 0.0] for name in calls}
    for i, (seg, pack) in enumerate(calls["spade_cond"]):
        if pack.route != "wgmma":
            raise AssertionError(f"spade_cond call {i}: a {pack.route!r} pack")
        shape = (f"{tuple(seg.shape)} nc={[c // 2 for c in pack.couts]}")
        a32 = f32((seg, *pack.args))
        for got, want in zip(spade_cond(*a32), spade_cond_plain(*a32)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            err["spade_cond"][0] = max(err["spade_cond"][0],
                                       (got - want).abs().max().item())
        for got, want in zip(spade_cond_packed(seg, pack), spade_cond_plain(*a32)):
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
    log(f"kernels vs plain: spade_cond max err f32 {err['spade_cond'][0]:.3e} "
        f"bf16 {err['spade_cond'][1]:.3e}; masked_blend f32 "
        f"{err['masked_blend'][0]:.3e} bf16 {err['masked_blend'][1]:.3e}")

    event_fns = {"smog_tail": (smog_tail, smog_tail_plain),
                 "fire_color_grade": (fire_color_grade, fire_color_grade_plain),
                 "fire_paste": (fire_paste, fire_paste_plain)}
    for name, (kernel, plain) in event_fns.items():
        for args in calls[name]:
            diff = (kernel(*args) - plain(*args)).abs()
            e = diff.max().item()
            n_diff = int((diff > 0).sum().item())
            equal = 1.0 - n_diff / diff.numel()
            log(f"{name} {tuple(args[0].shape)} f32: max err {e:.3e}, "
                f"{n_diff} of {diff.numel()} values differ")
            ok = e <= 1e-5 if name == "smog_tail" else (e <= 1.0 and equal >= 0.9999)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version")
            err[name][0] = max(err[name][0], e)
    torch.cuda.synchronize()

    # ---- 3. the main path ----------------------------------------------
    kernels.reset_launches()
    out = infer(x, uniform=uniform)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    log(f"main path launches: {launches}")
    if launches != MAIN_PATH_LAUNCHES:
        raise AssertionError(f"expected launches {MAIN_PATH_LAUNCHES}, got "
                             f"{launches}")
    mask = out["mask"]
    for key in ("flood", "wildfire", "smog"):
        v = out[key]
        if v.shape != (BATCH, SIZE, SIZE, 3) or v.dtype != torch.uint8:
            raise AssertionError(f"{key} {tuple(v.shape)} {v.dtype}")
        log(f"{key} ok: uint8 range [{v.min().item()}, {v.max().item()}], "
            f"mean {v.float().mean().item():.3f}")
    if mask.shape != (BATCH, SIZE, SIZE, 1) or mask.dtype != torch.bfloat16:
        raise AssertionError(f"mask {tuple(mask.shape)} {mask.dtype}")
    if not torch.isfinite(mask.float()).all() or not (0 <= mask.min() <= mask.max() <= 1):
        raise AssertionError("mask is not finite in [0, 1]")
    wf = out["wildfire"]
    if not ((wf[:, 0, 0] == 255).all() and (wf[:, -1, -1] == 0).all()):
        raise AssertionError("wildfire range-pinning pixels are not 255 and 0")
    log(f"mask mean {mask.float().mean().item():.4f}")

    # ---- 4. card vs CPU at 256^2, f32 ------------------------------------
    xs = torch.rand(1, SMALL, SMALL, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    us = torch.rand(9, 9, generator=torch.Generator().manual_seed(3))
    res, masker_out = {}, {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        Gw, inf = build_infer_fn(opts, dtype=torch.float32, bin_value=-1,
                                 ignore_event=(), device=where, seed=0)
        res[where] = {k: v.cpu() for k, v in inf(xs, uniform=us,
                                                  g_value=G_VALUE).items()}
        d_w, s_w, _ = Gw.infer_masker(
            xs.to(where).permute(0, 3, 1, 2).contiguous())
        masker_out[where] = (d_w.cpu(), s_w.cpu())
        log(f"256^2 f32 all events on {where}: {time.perf_counter() - t0:.1f} s "
            f"(incl. model build)")
    mask_err = (res["cuda"]["mask"] - res["cpu"]["mask"]).abs().max().item()
    within, worst = lsb_agreement(res["cuda"]["flood"], res["cpu"]["flood"])
    log(f"card vs CPU: mask max err {mask_err:.3e}, flood within 1 LSB on "
        f"{100 * within:.4f}% of pixels (max {worst} LSB)")
    if not mask_err <= 1e-3 or not within >= 0.999:
        raise AssertionError("card and CPU disagree")
    sky = {w: retrieve_sky_mask(masker_out[w][1]) for w in masker_out}
    n_sky = int((sky["cuda"] != sky["cpu"]).sum().item())
    log(f"whole path: seg argmax sky disagrees on {n_sky} of "
        f"{sky['cpu'].numel()} seg pixels ({int(sky['cpu'].sum().item())} sky "
        f"on the CPU)")
    for key in ("wildfire", "smog"):
        within, worst = lsb_agreement(res["cuda"][key], res["cpu"][key])
        log(f"whole path {key}: within 1 LSB on {100 * within:.4f}% "
            f"(max {worst} LSB; not a bar: seg ties can flip sky pixels)")
    x_cpu = xs.permute(0, 3, 1, 2).contiguous()
    d_cpu, s_cpu = masker_out["cpu"]
    ev = {}
    for where in ("cuda", "cpu"):
        xw = x_cpu.to(where)
        ev[where] = {
            "wildfire": unit_range_to_uint8(fire_mod.add_fire(
                xw, s_cpu.to(where), g_value=G_VALUE)).cpu(),
            "smog": unit_range_to_uint8(smog_mod.add_smog(
                xw, d_cpu.to(where))).cpu()}
    for key in ("wildfire", "smog"):
        within, worst = lsb_agreement(ev["cuda"][key], ev["cpu"][key])
        log(f"card vs CPU on the CPU's x, seg, depth: {key} within 1 LSB on "
            f"{100 * within:.4f}% of values (max {worst} LSB)")
        if not within >= 0.999:
            raise AssertionError(f"card and CPU disagree on {key}")

    # ---- 5. timings ------------------------------------------------------
    _, infer_flood = build_infer_fn(opts, dtype=torch.bfloat16, device=dev,
                                    seed=0, ignore_event=("wildfire", "smog"))

    def run_flood():
        return infer_flood(x, uniform=uniform)

    def run_all():
        return infer(x, uniform=uniform, g_value=g_dev)

    # in turns (flood, all, all, flood), 3 forwards each time
    turns = [cuda_ms(torch, fn, reps=3)
             for fn in (run_flood, run_all, run_all, run_flood)]
    flood_ms, all_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    xc = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()
    masker_ms = cuda_ms(torch, lambda: G.infer_masker(xc), reps=3)
    d_m, s_m, _ = G.infer_masker(xc)
    xf, sf, df = xc.float(), s_m.float(), d_m.float()

    def run_fire():
        return fire_mod.add_fire(xf, sf, g_value=g_dev)

    def run_smog():
        return smog_mod.add_smog(xf, df)

    fire_ms, smog_ms = cuda_ms(torch, run_fire, 10), cuda_ms(torch, run_smog, 10)
    fire_dev, smog_dev = device_ms(torch, run_fire), device_ms(torch, run_smog)
    log(f"flood only 640^2 bf16 batch {BATCH}: {flood_ms:.2f} ms per batch, "
        f"{1000 * BATCH / flood_ms:.3f} images/s; masker {masker_ms:.2f} ms, "
        f"painter + paste + quantize {flood_ms - masker_ms:.2f} ms")
    log(f"all events 640^2 bf16 batch {BATCH}: {all_ms:.2f} ms per batch, "
        f"{1000 * BATCH / all_ms:.3f} images/s (turns: "
        + ", ".join(f"{t:.2f}" for t in turns) + " ms)")
    log(f"events alone, called back to back: add_fire {fire_ms:.3f} ms + "
        f"add_smog {smog_ms:.3f} ms = {fire_ms + smog_ms:.3f} ms; device "
        f"time with a cold L2: {fire_dev:.3f} + {smog_dev:.3f} = "
        f"{fire_dev + smog_dev:.3f} ms")
    log(profile_table(torch, run_all))
    # the packs built with the model vs packing in every call (the way of
    # the port's first versions): the difference is the weight copies
    packs = [(m, a, getattr(m, a)) for m in G.modules()
             for a in ("pack", "shortcut_pack") if getattr(m, a, None) is not None]
    n_packed = device_kernels(torch, run_all)
    for m, a, _ in packs:
        setattr(m, a, None)
    try:
        n_unpacked = device_kernels(torch, run_all)
    finally:
        for m, a, pk in packs:
            setattr(m, a, pk)
    log(f"device kernels and copies in one all-events forward (profiler): "
        f"{n_packed} with the {len(packs)} SPADE packs built with the model, "
        f"{n_unpacked} when every spade_cond call packs its weights")
    norms_mod.spade_cond_packed = lambda seg, pack: spade_cond_plain(seg, *pack.args)
    try:
        out_plain = infer(x, uniform=uniform)
    finally:
        norms_mod.spade_cond_packed = spade_cond_packed
    within, worst = lsb_agreement(out["flood"], out_plain["flood"])
    log(f"640^2 bf16 flood through spade_cond vs through spade_cond_plain "
        f"(information, not a bar): within 1 LSB on {100 * within:.4f}% of "
        f"values (max {worst} LSB)")
    log(profile_table(torch, lambda: (run_fire(), run_smog()), rows=25))

    rows = []
    t_sc, per_call, ops_ms, bytes_ms = time_spade_calls(torch,
                                                        calls["spade_cond"])
    for line in per_call:
        log(line)
    log(f"spade_cond over the {len(per_call)} calls: kernel {t_sc['ms']:.4f} ms, "
        f"bound {t_sc['bound_ms']:.4f} ms ({100 * t_sc['bound_ms'] / t_sc['ms']:.1f}%), "
        f"library {t_sc['library_ms']:.4f} ms; bound terms: operations "
        f"{ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms")
    if not t_sc["ms"] < t_sc["library_ms"]:
        log("spade_cond: NOTE the kernel is slower than the library call")
    rows.append({
        "name": "spade_cond", "route": "cuda",
        "design": "bf16: both convs on wgmma from shared memory, the 3x3 "
                  "im2col of the second folded into its A descriptors, weights "
                  "packed once and streamed by a cp.async.bulk ring; f32: CUDA "
                  "cores",
        "source": "climategan_torch/csrc/spade_cond.cu",
        "replaces": "climategan_tpu/ops/pallas/spade.py:119",
        "launches": launches["spade_cond"],
        "max_abs_err": err["spade_cond"][0],
        "max_abs_err_bf16": err["spade_cond"][1],
        "ms": t_sc["ms"], "call_ms": t_sc["call_ms"],
        "plain_ms": t_sc["plain_ms"], "bound_ms": t_sc["bound_ms"],
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
        "ms": device_ms(torch, lambda: masked_blend(xb, fb, mb)),
        "call_ms": cuda_ms(torch, lambda: masked_blend(xb, fb, mb), reps=20),
        "plain_ms": device_ms(torch, lambda: masked_blend_plain(xb, fb, mb)),
        "bound_ms": max(b_bytes, b_ops) * 1e3,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": device_ms(torch, lambda: torch.lerp(xb, fb, mb)),
    })

    replaces = {"smog_tail": "climategan_tpu/ops/pallas/events.py:69",
                "fire_color_grade": "climategan_tpu/ops/pallas/events.py:109",
                "fire_paste": "climategan_tpu/ops/pallas/events.py:152"}
    for name in EVENT_KERNELS:
        kernel, plain = event_fns[name]
        args = calls[name][0]
        x_in = args[0]
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        # each input read once, the (N, 3, H, W) output written once
        nbytes = sum(t.numel() * t.element_size() for t in tensors) \
            + x_in.numel() * x_in.element_size()
        units = x_in.numel() if name == "fire_color_grade" else x_in.numel() // 3
        b_bytes = nbytes / PEAK_BYTES
        b_ops = EVENT_OPS[name] * units / PEAK_F32_FLOPS
        rows.append({
            "name": name, "route": "cuda", "design": EVENT_DESIGN[name],
            "source": "climategan_torch/csrc/events.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": err[name][0],
            "ms": device_ms(torch, lambda: kernel(*args)),
            "call_ms": cuda_ms(torch, lambda: kernel(*args), reps=20),
            "plain_ms": device_ms(torch, lambda: plain(*args)),
            "bound_ms": max(b_bytes, b_ops) * 1e3,
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": None,
            "note": "no single PyTorch call computes this function",
        })
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
        log(f"{r['name']}: kernel {r['ms']:.4f} ms (back to back with its "
            f"host time {r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    serving_phase(torch, opts, dev)
    with torch.inference_mode(False), torch.enable_grad():
        train_launches = training_phase(torch, dev)
        trainer_launches = trainer_phase(torch, dev)
    configs = configs_phase(torch, dev, x, uniform, infer,
                            calls["spade_cond"])
    for r in rows:
        r["train_launches"] = train_launches[r["name"]]
        r["trainer_launches"] = trainer_launches[r["name"]]
        r["launches_by_path"] = {"default": r["launches"], **{
            path: n[r["name"]] for path, n in configs["paths"].items()}}
        if r["name"] == "spade_cond":
            r["spade_masker"] = configs["spade_cond"]

    log(smi())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
