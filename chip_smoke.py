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
     with --events all at batch 2 and 8, one JSON line each
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
     top ops); (4) climategan_torch.bench_train's main() in this process,
     its JSON line (value > 0);
  8. the trainer through its entry point: a synthetic dataset (8 train
     samples per domain r, s, rf as 640x853 PNGs and 4 val ones at 640x640;
     s with Unity-coded depth and integer seg labels) in a temp dir; `python -m
     torch.distributed.run --standalone --nproc_per_node 1 -m
     climategan_torch.train` (one NCCL rank), started as phase 15.b says
     through `python -m climategan_torch.launch`, in a subprocess
     at the default opts (full width) with data.loaders.batch_size=2 for 1
     epoch (4 steps, the evaluation, the checkpoint): 4 steps, spade_cond
     and masked_blend launched in the epoch (counted by the trainer per
     epoch into train.jsonl), finite validation metrics, the epoch
     record's world size 1 and state digest that of the checkpoint,
     checkpoints/latest_ckpt.pth, latest.json and opts.json written; then
     `climategan_torch.train.main` in this process (no process group) with
     args.resume=true train.epochs=2 tpu.spatial_shards=2, which the one
     card cannot give, on the first 2 samples of each list
     (data.max_samples=2): the JAX trainer's fallback message printed, the
     epoch unsharded, resumed from epoch 0 with a state
     whose sha256 (checkpoint.state_digest) equals the epoch-0 file's, 1
     more step, the newest checkpoint at epoch 1, step 5; then
     apply_events main() with -r <run dir> on 2 photos (three uint8
     640x640x3 PNGs each) and Trainer.resume_from_path(run dir).infer_all,
     each with the main path's launches {18, 1, 1, 1, 1} (information:
     steps/s, img/s and the loader's share over steps 2-4 and the whole
     epoch, the evaluation's and the save's seconds, the checkpoint's
     bytes, the peak memory at batch 2, the launches over the phase; the
     step at the default batch, 6 per domain, is phase 10.3's);
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
     with z (drawn on the card), the final shortcut, batch-norm SPADEs and
     the base mask decoder with layer norms and PReLUs
     (gen.m.norm=spectral_layer gen.m.activ=prelu, its ms/batch also in
     TURNS rounds with the default's): launches {18, 1, 1, 1, 1}, outputs
     checked, ms/batch, and the card's f32 path against the CPU at 256^2
     (z fed to both) with the same bars, there also with
     gen.m.norm=layer gen.m.activ=selu;
     climategan_torch.bench_train in this process on depth classification
     (its bucket targets), its JSON line (value > 0).
  10. the step's options and FID: (1) at tiny_opts(32)'s sizes in f32
     (TF32 off), g_step then d_step of the card against the CPU from one
     state with the same draws, losses within 1e-4 relative and both
     models held by hold_state, for the local painter D + WGAN_gp on m and
     s + diff-aug on draws fed to both, and for pl4m (the CPU with oneDNN
     off), train.grad_accumulation 2 (batch 4, batch seed 5) and
     tpu.remat + remat_d with each remat_policy ("", dots, small_convs;
     oneDNN on); all the options in one step are held against the JAX
     package on the CPU (tests/test_torch_port_step_options.py); (2) full width (640^2,
     2 per domain, 4 with grad_accumulation 2; default opts plus one option
     at a time: the local D, pl4m, WGAN_gp, diff-aug, grad_accumulation 2,
     remat + remat_d with each policy; one G, a fresh D and optimizer
     states per option): one counted train_step (masked_blend 2 a step,
     pl4m 3, grad_accumulation 4, remat 4: a rematerialized paste runs
     twice; spade_cond 0), finite losses, every parameter moved but the
     ADVENT output biases, one more step timed and the peak memory (phase
     13.e times every option at once at full width); (3) plain and remat
     ('') one after the other at the default batch (6 per domain): ms of
     one step after the counted one, and peak; (4) FID: the Inception's
     features of 4 images at 299^2
     on the card against the CPU (f32, TF32 off) within 1e-3 of the
     largest; the float64 Newton-Schulz square root of a 2048^2 covariance
     product on the card against the CPU's within 1e-9 of the largest;
     Trainer.compute_val_fid at 640^2 on phase 8's val set and on 57
     in-memory images, each with its seconds and launches (spade_cond and
     masked_blend both launched), the FID finite.
  11. data parallel over torch.distributed (climategan_torch/parallel/),
     the ranks of (b) and (c) processes started with the spawn method (a
     launch each, side by side), which run beside this process's own
     steps of (a), (b) and (c) and (d)'s serving checks: (a)
     NCCL at world size 1, this process the rank (phase 8's trainer and
     (d)'s bench_train --mesh start NCCL ranks of their own): the
     full-width default g_step and d_step (640^2, 2 per
     domain, bf16 policy), each from the seed-0 state, through the
     data-parallel path under PyTorch's deterministic algorithms, their
     states' sha256 equal to the plain steps' (where they differ, the plain
     steps run again to tell a non-reproducible step from the path), and
     masked_blend's launches per rank step counted (2), with the gradient
     all-reduce's ms once the gloo ranks are done; (b) two gloo ranks on
     cuda:0 at tiny_opts(32)'s sizes,
     batch 2 per domain, without DADA and with 8^2 depth targets (no
     bicubic resize: step_check.TINY_DP_OVERRIDES), deterministic
     algorithms on both sides: g_step and d_step, each from the seed-0
     state, held by hold_state against the card's one-process steps on the
     global batch, losses within 1e-4, the ranks' states equal (the same
     launch also takes phase 13.d's hybrid steps, then (c)'s); (c) two
     gloo ranks at full width, one image per rank per domain, in f32
     (train.bf16 false): every loss of (a)'s two steps within 1e-2
     relative of the one-process steps', the ranks' states equal, the
     gloo all-reduce's ms; (d) phase 8's run dir (its first epoch trained
     by one NCCL rank of `torch.distributed.run`) served by apply_events
     -r with and without --mesh (bit-equal PNGs, launches {18, 1, 1, 1, 1}
     per batch); render split over ["cuda:0", "cuda:0"] within 1 LSB on
     100% of values of the unsplit render (f32); climategan_torch.bench
     --mesh --batch 8 and bench_train --mesh --batch 2 (in this process;
     bench_train's rank in its own), their JSON lines; (e) with two cards
     or more, (a)'s steps over NCCL on every card, else one line saying it
     was not run.
  12. row-sharded (spatial) and hybrid inference (climategan_torch/
     parallel/spatial.py) at full width (default opts, 640^2, batch 2, the
     seed-0 model), the shards on one card repeated (["cuda:0"] * k: the
     machine shows one card, so these are the host's and the device's
     cost of the split, not scaling): (a) build_spatial_infer_fn for k = 2
     and 4 in f32 (TF32 off) against the unsharded forward on the card:
     flood, wildfire and smog within 1 LSB on >= 99.9% of values, the mask
     within SPATIAL_MASK_BAR, launch counts set to 0 before a forward and
     read after: spade_cond 18 k and k of each other kernel; ms per batch
     beside the unsharded forward's, and the host and device time inside
     the exchanges and collectives (profiler ranges); (b) in bf16 at k =
     4, each spade_cond window the forward passes to the kernel recorded
     and the kernel held against spade_cond_plain on exactly those inputs
     at phase 2's bars (f32 1e-4, bf16 one ulp), the events' agreement
     with the unsharded bf16 forward printed (information); (c) render of
     apply_events --spatial through load_model(args, devices=["cuda:0"] *
     2) on phase 6's 7 synthetic photos, f32, launches per batch {36, 2,
     2, 2, 2}, PNGs within 1 LSB of the unsharded render on >= 99.9% of
     values; (d) climategan_torch.bench --spatial on ["cuda:0"] * 2 and
     --hybrid 2 on ["cuda:0"] * 4 at batch 2, one JSON line each (mfu <=
     1.05, the layout's dp and sp).
  13. row-sharded and hybrid training (tpu.spatial_shards; the models'
     train-mode forward_rows, the losses on rows, StepBuilder's devices=)
     at full width (default opts, 640^2, 2 per domain, the seed-0 state),
     the shards on ["cuda:0"] * k: (a) g_step and d_step over k = 2 and
     4, each from the seed-0 state, against the unsharded steps: in
     float64, every loss within SPATIAL_TRAIN_BAR relative, the stepped
     model held by hold_state (first moments, parameters, statistics and
     u/v), the other one's statistics and u/v; in f32 (TF32 off), every
     loss within SPATIAL_TRAIN_BAR relative and the stepped model's first
     moments no farther from the float64 step's than SPATIAL_TRAIN_NOISE
     times the unsharded f32 step's distance (the card's own f32 noise,
     at least hold_state's 1e-3); (b) in bf16, the train_step's
     p50 ms over SPATIAL_TRAIN_TIMED steps at k = 1, 2 and 4 with the
     peak memory, launch counts set to 0 before a step and read after
     (masked_blend 2 k, the others 0), and at k = 2 the host ms inside
     the exchanges and collectives (the host's clock at the edges of their
     ranges, no profiler); (c) every
     masked_blend launch of one 4-shard bf16 step recorded and held
     against masked_blend_plain on the same shard at phase 2's bars; (d)
     in phase 11.b's launch, g_step and d_step with each gloo rank's rows
     over two row shards of cuda:0 (tiny, TINY_DP_OVERRIDES), held to the
     one-process steps on the global batch as 11.b holds its steps; (e)
     every step option at once on rows (the local painter D, pl4m,
     WGAN_gp on m and s, diff-aug with color, translation and cutout, a
     random VGG as under train.allow_random_vgg): (0) the painter D's 3x3
     stride-2 average pool on a channels-last float64 input (the paste's
     layout): the port's input gradient within 1e-12 of a contiguous
     input's (PyTorch's own pool's error printed); (1) at tiny_opts(32)'s
     sizes in float64 with remat and remat_d under small_convs, g_step and
     d_step on a batch of 2 per domain and on a KITTI pretraining batch
     (domain s alone) over k = 2 and 4 against the unsharded steps, every
     loss within TINY_OPTION_BAR relative and both models held by
     hold_state; (2) at full width with remat and remat_d, the f32 losses
     over 2 shards within SPATIAL_TRAIN_BAR relative of the unsharded
     ones; the bf16 train_step's p50 ms over SPATIAL_TRAIN_TIMED steps and
     peak memory at k = 1 and 2, with and without remat, launch counts set
     to 0 before a step and read after (2-shard steps launch twice the
     unsharded step's masked_blend, no spade_cond), and every masked_blend
     launch of one 2-shard remat step held against masked_blend_plain at
     phase 2's bars.
  14. every other generator configuration on row shards (the eight of
     phase 9: the SPADE masker, MobileNetV2, DeepLab v2, depth
     classification, the painter with z, the final shortcut, batch-norm
     SPADEs, the layer-norm and PReLU mask decoder), the shards on
     ["cuda:0"] * k: (a) each at full width (640^2, batch 2, seed-0
     weights) in f32 through build_spatial_infer_fn over 2 shards against
     its unsharded forward on the same model
     (``infer.unsharded``; the painter's z drawn once and fed to both):
     every event within 1 LSB on >= 99.9% of values, the mask within
     SPATIAL_MASK_BAR, launch counts set to 0 before the sharded forward
     and read after: spade_cond 18 k (24 k with the SPADE masker) and k of
     each other kernel; (b) the SPADE masker in bf16 over 4 shards: every
     spade_cond window recorded (96, 24 of them at cnc 15) and held
     against spade_cond_plain at phase 2's bars; (c) g_step and d_step of
     groups A, B and C of tests/torch_port_common.py at tiny_opts(32)'s
     sizes in float64 over 2 shards against the unsharded steps (DeepLab
     v2's dropout from one seed on both sides): every loss within
     TINY_OPTION_BAR relative and both models held by hold_state; (d) the
     SPADE masker's and DeepLab v2's full-width bf16 train_step at k = 1
     and 2: p50 ms of SPATIAL_CONFIG_TIMED steps and the peak memory
     (information), launches masked_blend 2 k and nothing else; (e)
     apply_events --spatial -r <a run dir of depth classification> on
     phase 6's 7 photos (f32) within 1 LSB of the unsharded serve on >=
     99.9% of values, launches per batch {18 k, k, k, k, k}, and
     climategan_torch.bench --spatial --stage masker on the SPADE masker,
     its JSON line; (f) the layer-norm and PReLU mask decoder's full-width
     bf16 train_step, unsharded in TURNS rounds with the default's, then
     over 2 shards: finite losses, every gamma, beta and alpha of the mask
     decoder moved, launches masked_blend 2 k and nothing else, p50 ms and
     peak memory (information).
  15. the tools (at most 40 s; each part's seconds on standard error): (a)
     climategan_torch.profile_inference's run() in this process at 640^2
     bf16 batch 2, --events all --iters 2: the stages sum to the
     profiler's device total within 1% (every kernel linked to the range
     around its launch), masker/encoder, seg_decoder, depth_decoder and
     mask_decoder and a painter/* stage nonzero, every spade_cond kernel
     in a painter/* stage, per iteration the main path's launches {18, 1,
     1, 1, 1}; then --train at 256^2 batch 1 for one iteration, its stages
     summing to its total within 1%; (b) phase 8.1's trainer run was
     started by `python -m climategan_torch.launch -e <yaml>
     --nproc_per_node 1 --submit bash` with 8.1's arguments as the YAML's
     base_overrides: one script written, its command the one 8.1 ran
     (torch.distributed.run, one rank, the same overrides), one trainer run;
     (c) climategan_torch.compare_maskers on the card over phase 8's run
     dir and a dir whose latest_ckpt.pth links phase 8's epoch-0 file, on
     phase 8's 4 val photos with their masks as labels: 4 panels of 640 x
     3 * 640, metrics.json with both models, run on cuda; (d) the f32
     default generator of phase 4 (its CPU copy, moved to the card) with
     seeded batch-norm statistics:
     fold_generator_bns's forward (depth, seg, mask) within 1e-5 of the
     unfolded forward on the card; (e) at 640^2 batch 2 with 64 channels:
     AdaptiveInstanceNorm in f32 on the card within 1e-5 of the CPU, over
     2 row shards of the card (forward_rows) within 1e-5 of the card's
     forward, in bf16 within one bf16 ulp of each value of its f32 path
     on the same input; resize_like to a 480 x 853 reference, nearest and
     bilinear, a tensor on the card within 1e-5 of the CPU (nearest
     exactly) and a 2-shard Rows within 1e-5 of the card's tensor.
Work that does not wait for other work runs beside it, the script's
limit being 1,200 s: phase 9 runs in this process while phase 8's first
trainer run trains in its own (the trainer's seconds and phase 9's are
then information only); the checks that hold the card to a reference by
bars that what runs beside them cannot move, and time nothing (phase 9's
card against the CPU, 13.e's pool check and 13.e(a), 14.c), run in a
process of their own (``side_main``), started after 10.1 and run beside
phases 10.2-11, its lines printed before phase 12's; phase 11's gloo
ranks run beside this process's own steps. The f32 step holds of the
card against the CPU (9.5's SPADE masker step, run after phase 8, and
10.1) run with nothing beside them (ROADMAP C). Each log line's second
on the script's clock goes to standard error.
The last three lines are the card's name and power limit, the kernels JSON
line (each kernel's launches per configuration's path; spade_cond's with
the SPADE masker's numbers; ``ddp_train_launches``: per rank step of
phase 11; phase 10's launches per pl4m and accumulated
step and per FID evaluation; ``spatial_launches``: per row-sharded forward
of phase 12.a by shard count; ``spatial_train_launches``: per row-sharded
train step of phase 13.b by shard count; ``spatial_option_train_launches``:
per train step with every option of phase 13.e by remat and shard count;
``spatial_config_launches``: per 2-shard forward of phase 14.a by
configuration), and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import io
import json
import subprocess
import sys
import time
import warnings
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


T_START = time.perf_counter()
# the side process's log lines, which its parent prints (side_main)
_SINK = None


def log(*args):
    print(*args, flush=True)
    # the script's clock at each line, on standard error: where a run's
    # seconds went
    first = " ".join(map(str, args)).split("\n", 1)[0]
    print(f"[{time.perf_counter() - T_START:7.1f} s] {first[:100]}",
          file=sys.stderr, flush=True)
    if _SINK is not None:
        _SINK.append(" ".join(map(str, args)))


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
    log(f"served images/s at batch {BATCH}, {len(stream)} photos (whole "
        f"call / loop after the prep): " + "; ".join(
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

    for b in (2, 8):
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
    # its main() in this process: a process of its own took about 10 s more
    # to start (phase 8's trainer and 11.d's ranks start processes)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if bench_train.main([]) != 0:
            raise AssertionError("bench_train main() failed")
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    if not line["value"] > 0 or not line["max_memory_allocated"]:
        raise AssertionError(f"bench_train: {line}")
    log(json.dumps(line))
    log(f"training phase: {time.perf_counter() - t_phase:.1f} s")
    return {k: counted[k] for k in kernels.launches}


# phase 8: the synthetic dataset and the trainer's runs
# 8 train samples per domain: the script's time limit also holds phase 11
TRAIN_SAMPLES, VAL_SAMPLES = 8, 4
# the loader's numpy resizes (data/transforms.np_resize, an einsum with a
# dense interpolation matrix) take seconds per map of a 720x960 photo,
# which made about 31 s of the first step of each of the trainer's runs
# and about 41 s of each evaluation on the H100's host: the train photos are
# 3:4 at the model's height, so the aspect-preserving resize keeps their
# size, and the crop and the resize after it run as on any photo; the val
# photos are at the model's square size
PHOTO_HW = (SIZE, SIZE * 4 // 3)
VAL_HW = (SIZE, SIZE)
TRAIN_BATCH, BIG_BATCH = 2, 6
EPOCH0_RUN = "run_epoch0"  # phase 8's epoch-0 checkpoint as a run dir
TRAINER_TIMEOUT = 900


def write_training_dataset(root: Path) -> dict:
    """TRAIN_SAMPLES train and VAL_SAMPLES val samples per domain (r, s, rf)
    as PNGs at PHOTO_HW (the val ones at VAL_HW), in the layout of
    tests/test_trainer_integration.py
    (x and m everywhere; s adds Unity-coded depth and integer seg labels);
    returns the file lists {"train": {domain: json}, "val": {...}}."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np

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
                jobs.append((e, len(jobs),
                             PHOTO_HW if mode == "train" else VAL_HW))
            lp = root / f"{mode}_{domain}.json"
            lp.write_text(json.dumps(samples))
            lists[mode][domain] = str(lp)

    def write(job):
        e, seed, (h, w) = job
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


# one NCCL rank of a `torch.distributed.run` launch
TORCHRUN = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            "1"]


def launch_cli(args, root: Path) -> tuple:
    """`python -m climategan_torch.train` as one NCCL rank (TORCHRUN) in a
    subprocess on the card, started by `python -m climategan_torch.launch
    -e <yaml> --nproc_per_node 1 --submit bash` with ``args`` as the
    YAML's base_overrides (phase 15.b): the one script it writes must hold
    exactly that command. Returns the trainer's train.jsonl records and a
    line of the exit code, seconds and output's tail (for the caller to
    log: it may run in a thread)."""
    import shlex

    import yaml

    t0 = time.perf_counter()
    experiment = root / "experiment.yaml"
    experiment.write_text(yaml.safe_dump(
        {"runs": 1, "base_overrides": dict(a.split("=", 1) for a in args)},
        sort_keys=False))
    scripts = root / "launch_scripts"
    out = subprocess.run([sys.executable, "-m", "climategan_torch.launch",
                          "-e", str(experiment), "--nproc_per_node", "1",
                          "--submit", "bash", "--scripts_dir", str(scripts)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=TRAINER_TIMEOUT)
    tail = "\n".join(out.stdout.splitlines()[-12:])
    line = (f"python -m climategan_torch.launch --nproc_per_node 1 --submit "
            f"bash (rc {out.returncode}, {time.perf_counter() - t0:.1f} s):"
            f"\n{tail}")
    if out.returncode != 0:
        raise AssertionError(f"{line}\nthe launched trainer failed:\n"
                             f"{out.stderr[-4000:]}")
    written = sorted(scripts.glob("*.sh"))
    want = [sys.executable, *TORCHRUN, "-m", "climategan_torch.train", *args]
    got = shlex.split(written[0].read_text().splitlines()[-1]) if written \
        else None
    if len(written) != 1 or got != want:
        raise AssertionError(f"the launcher wrote {written}: {got}, not "
                             f"{want}")
    run_dir = Path(next(a.split("=", 1)[1] for a in args
                        if a.startswith("output_path=")))
    records = [json.loads(rec) for rec in
               (run_dir / "train.jsonl").read_text().splitlines()]
    epochs = [r for r in records if "steps" in r]
    if len(epochs) != 1:
        raise AssertionError(f"the launch trained {len(epochs)} epochs, not "
                             f"one run of one: {epochs}")
    return records, line + f"\n15.b: the launcher wrote one script, " \
        f"{written[0].name}, whose command is 8.1's: {' '.join(got[1:7])} " \
        f"... ({len(args)} overrides)"


def train_in_process(args) -> tuple:
    """``climategan_torch.train.main(args)`` in this process (no process
    group): its train.jsonl records and its standard output."""
    from climategan_torch import train as train_mod

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_mod.main(args)
    text = out.getvalue()
    tail = "\n".join(text.splitlines()[-12:])
    log(f"climategan_torch.train.main in this process (rc {rc}, "
        f"{time.perf_counter() - t0:.1f} s):\n{tail}")
    if rc != 0:
        raise AssertionError(f"the trainer failed:\n{text[-4000:]}")
    run_dir = Path(next(a.split("=", 1)[1] for a in args
                        if a.startswith("output_path=")))
    return [json.loads(line) for line in
            (run_dir / "train.jsonl").read_text().splitlines()], text


def epoch_record(records, epoch: int) -> dict:
    """The epoch's steps record merged with its launches record."""
    rec = {}
    for r in records:
        if r.get("epoch") == epoch:
            rec.update(r)
    if "steps" not in rec or "launches" not in rec:
        raise AssertionError(f"no record of epoch {epoch}: {records}")
    return rec


def trainer_phase(torch, dev, beside=None) -> tuple:
    """Phase 8: the trainer through its entry point (see the module
    docstring), ``beside()`` run in this process while the first run's
    process trains. Returns the launches of each kernel in the first run's
    epoch, the temp dir of the dataset (for phase 10's FID on its val set;
    the caller cleans it up), the dataset's lists and what ``beside``
    returned."""
    import os
    import tempfile

    import cv2
    import numpy as np

    from climategan_torch import apply_events as cli
    from climategan_torch import kernels
    from climategan_torch.parallel.mesh import fallback_message
    from climategan_torch.trainer import Trainer
    from climategan_torch.utils.checkpoint import read_checkpoint, state_digest

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    t0 = time.perf_counter()
    lists = write_training_dataset(root / "data")
    log(f"trainer phase: wrote {3 * (TRAIN_SAMPLES + VAL_SAMPLES)} samples "
        f"(train {PHOTO_HW[0]}x{PHOTO_HW[1]}, val {VAL_HW[0]}x{VAL_HW[1]}) "
        f"in {time.perf_counter() - t0:.1f} s")
    run = root / "run"
    args = [f"data.files.train={json.dumps(lists['train'])}",
            f"data.files.val={json.dumps(lists['val'])}",
            f"data.loaders.batch_size={TRAIN_BATCH}", f"output_path={run}"]

    # ---- 8.1 one epoch at the default opts, full width -----------------
    # its process runs beside ``beside`` (phase 9), which this process runs
    # meanwhile: the trainer's seconds are information only
    first_run = _in_thread("the trainer's first run, beside phase 9",
                           lambda: launch_cli(args + ["train.epochs=1"],
                                              root))
    beside_result = beside() if beside is not None else None
    records, line = first_run()
    log(line)
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
    # NCCL at world size 1: the epoch record holds the ranks' digest, the
    # checkpoint's
    saved_digest = state_digest(read_checkpoint(saved))
    if first.get("world_size") != 1 or \
            first.get("state_digest") != saved_digest:
        raise AssertionError(f"the epoch under torch.distributed.run: {first}")
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
    # in this process, with tpu.spatial_shards: 2, which one card cannot
    # give: the trainer prints the JAX trainer's message and trains
    # unsharded (JAX's rule, parallel/mesh.spatial_devices); on the first
    # TRAIN_BATCH samples of each list (data.max_samples): one step, a
    # quarter of the epoch's train decodes and half of its evaluation's
    # (the resume is held by the state)
    records, text = train_in_process(args + [
        "train.epochs=2", "args.resume=true", "tpu.spatial_shards=2",
        f"data.max_samples={TRAIN_BATCH}"])
    if (torch.cuda.device_count() < 2
            and fallback_message(2, torch.cuda.device_count()) not in text):
        raise AssertionError("tpu.spatial_shards=2 on one card: no fallback "
                             "message")
    resumed = [r for r in records if "resumed_from_epoch" in r]
    want = saved_digest
    if len(resumed) != 1 or resumed[0]["resumed_from_epoch"] != 0 or \
            resumed[0]["state_digest"] != want:
        raise AssertionError(f"resume: {resumed}, saved state {want}")
    second = epoch_record(records, 1)
    latest = read_checkpoint(ckpts / "latest_ckpt.pth")
    if second["steps"] != 1 or latest["epoch"] != 1 or \
            latest["step"] != steps + 1:
        raise AssertionError(f"epoch 1: {second['steps']} steps, latest "
                             f"checkpoint epoch {latest['epoch']} step "
                             f"{latest['step']}")
    log(f"resumed at epoch 1 with the state of the epoch-0 checkpoint bit "
        f"for bit (sha256 {want[:16]}...); epoch 1: {second['steps']} "
        f"steps, launches {second['launches']}, evaluation "
        f"{second['eval_s']:.2f} s, save {second['save_s']:.2f} s")
    del latest
    # the epoch-0 file as the checkpoint of a second run dir (phase 15.c)
    kept = root / EPOCH0_RUN
    (kept / "checkpoints").mkdir(parents=True)
    os.link(saved, kept / "checkpoints" / "latest_ckpt.pth")
    (kept / "opts.json").write_text((run / "opts.json").read_text())
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

    # (the step at the default batch, 6 per domain, and its peak memory:
    # phase 10.3)
    torch.cuda.empty_cache()
    total = {k: first["launches"][k] + second["launches"][k] + served[k]
             + inferred[k] for k in launches}
    log(f"launches over the trainer phase (two epochs, serving, infer_all): "
        f"{total}")
    log(f"trainer phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, tmp, lists, beside_result


# phase 9: the other generator configurations
SPADE_MASKER = ["gen.m.use_spade=true"]  # the default gen.m.spade: cond_nc 15
MASK_DECODER_CALLS = 6  # a dual and a norm_1 launch in each of 3 blocks
# the base mask decoder's layer norms and PReLUs
MASK_LAYER_PRELU = ["gen.m.norm=spectral_layer", "gen.m.activ=prelu"]
CONFIG_RUNS = {
    "mobilenet": ["gen.deeplabv3.backbone=mobilenet"],
    "deeplabv2": ["gen.encoder.architecture=deeplabv2",
                  "gen.s.architecture=deeplabv2"],
    "classification": ["gen.d.architecture=base", "gen.d.classify.enable=true",
                       "gen.m.use_dada=false", "gen.s.use_dada=false"],
    "painter_z": ["gen.p.no_z=false"],
    "final_shortcut": ["gen.p.use_final_shortcut=true"],
    "batch_spade": ["gen.p.spade_param_free_norm=batch"],
    "mask_layer_prelu": MASK_LAYER_PRELU,
}
# held only by the card against the CPU at SMALL^2 (config_cpu_checks)
CPU_CHECK_RUNS = {"mask_layer_selu": ["gen.m.norm=layer", "gen.m.activ=selu"]}
TURNS = 3  # rounds of 9.6's and 14.f's timings in turns with the default


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


def config_cpu_checks(torch, dev) -> None:
    """Phase 9's card against the CPU at SMALL^2 (``card_vs_cpu``): the
    SPADE masker and each configuration of CONFIG_RUNS and CPU_CHECK_RUNS,
    z fed to both where the painter takes one."""
    from climategan_torch.models.generator import GenConfig
    from climategan_torch.utils.opts import load_opts

    card_vs_cpu(torch, load_opts(commandline_opts=SPADE_MASKER),
                "SPADE masker")
    for name, overrides in {**CONFIG_RUNS, **CPU_CHECK_RUNS}.items():
        copts = load_opts(commandline_opts=overrides)
        cfg = GenConfig.from_opts(copts)
        z_shape = None
        if not cfg.p_no_z:
            s = SMALL // 2 ** cfg.p_spade_n_up
            z_shape = (1, cfg.p_latent_dim, s, s)
        card_vs_cpu(torch, copts, name, z_shape)


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
    # (the card against the CPU runs in the side process: config_cpu_checks)
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
    # (its tiny step, card against CPU: spade_step_tiny, run with nothing
    # beside it before phase 10)
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
        if name == "mask_layer_prelu":
            turns = [[cuda_ms(torch, lambda: f(x, uniform=uniform,
                                                g_value=g_dev), reps=3)
                      for f in (infer_default, inf)] for _ in range(TURNS)]
            log(f"{name} in turns with the default config ({TURNS} rounds "
                f"of 3 forwards each): ms/batch " + "; ".join(
                    f"default {a:.2f}, {name} {b:.2f}" for a, b in turns))
        del Gc, inf, out

    # ---- 9.7 bench_train on depth classification (bucket targets) --------
    # in this process, as phase 7 runs its main()
    with torch.inference_mode(False), torch.enable_grad():
        line = bench_train.run_bench(bench_train.parse_args(
            ["--warmup", "1", "--iters", "2",
             *CONFIG_RUNS["classification"]]))
    torch.cuda.empty_cache()
    if not line["value"] > 0 or not line["max_memory_allocated"]:
        raise AssertionError(f"bench_train classification: {line}")
    log("bench_train " + " ".join(CONFIG_RUNS["classification"]) + ": "
        + json.dumps(line))
    log(f"configurations phase: {time.perf_counter() - t_phase:.1f} s")
    return {"spade_cond": spade_row, "paths": paths}


# phase 10: the step's options and FID
DIFF_AUG = ["gen.p.diff_aug.use=true", "gen.p.diff_aug.do_color_jittering=true",
            "gen.p.diff_aug.do_cutout=true", "gen.p.diff_aug.do_translation=true"]
PL4M = ["gen.m.use_pl4m=true"]
COMBINED_WITHOUT_PL4M = ["dis.p.use_local_discriminator=true",
                         "dis.m.gan_type=WGAN_gp", "dis.s.gan_type=WGAN_gp",
                         *DIFF_AUG]
REMAT = {policy: ["tpu.remat=true", "tpu.remat_d=true",
                  f"tpu.remat_policy={policy!r}"]
         for policy in ("", "dots", "small_convs")}
# option: (overrides, per-domain batch, masked_blend launches of a
# train_step: a paste per painter forward, pl4m's and each micro-batch's
# included, a rematerialized one twice)
FULL_OPTIONS = {
    "local_discriminator": (["dis.p.use_local_discriminator=true"], BATCH, 2),
    "pl4m": (PL4M, BATCH, 3),
    "WGAN_gp": (["dis.m.gan_type=WGAN_gp", "dis.s.gan_type=WGAN_gp"], BATCH,
                2),
    "diff_aug": (DIFF_AUG, BATCH, 2),
    "grad_accumulation": (["train.grad_accumulation=2"], 2 * BATCH, 4),
    **{f"remat {policy!r}": (o, BATCH, 4) for policy, o in REMAT.items()},
}
FID_IMAGES, FID_FEATURE_TOL = 57, 1e-3
# the float64 Newton-Schulz root of a rank-57 2048^2 product, card vs CPU:
# its near-zero eigenvalues amplify rounding over 30 iterations (a first
# run measured 7.1e-9 of the largest entry); FID reads only the trace
NS_ENTRY_TOL, NS_TRACE_TOL = 1e-7, 1e-9
# parameters whose gradient is zero in exact arithmetic, so that a step
# may leave them as they are: the ADVENT Ds' output biases under either gan
# type (spectral or not), and the depth head's output bias (the
# scale-invariant depth loss ignores a constant shift; phase 7's single
# step happens to move it by rounding noise)
ZERO_GRADIENT_ANY = ZERO_GRADIENT + tuple(
    k.replace(".module.", ".") for k in ZERO_GRADIENT) + (
    "G.decoders.d.upsample.2.bias",)


def hold_tiny_step(torch, dev, overrides, n, what, seed: int = 0,
                   onednn: bool = True) -> None:
    """g_step then d_step of ``overrides`` at tiny_opts(32)'s sizes on the
    synthetic batch of ``seed``, the card against the CPU (f32, TF32 off;
    the CPU's convs with oneDNN on or off) from one state with the same
    draws (the diff-aug draws fed to both): every loss within 1e-4
    relative, both models held by hold_state."""
    import copy

    from climategan_torch import bench_train
    from climategan_torch.train_step import StepBuilder, split_micro
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import (
        TINY_OVERRIDES,
        TINY_SIZE,
        first_moments,
        hold_state,
    )

    builder = StepBuilder(load_opts(path=TINY_OVERRIDES,
                                    commandline_opts=overrides))
    cpu = builder.init_state(seed=0, device="cpu")
    card = builder.state_for(copy.deepcopy(cpu.G).to(dev),
                             copy.deepcopy(cpu.D).to(dev))
    batch_cpu = bench_train.synthetic_batch(n, TINY_SIZE, 32, "cpu",
                                            seed=seed)
    batch_dev = {d: {k: v.to(dev) for k, v in b.items()}
                 for d, b in batch_cpu.items()}
    micro = split_micro(batch_cpu, builder.grad_accumulation)[0]
    draws = ((0.05, False), (0.1, False))
    for i, name in enumerate(("g_step", "d_step")):
        if name == "d_step":
            card.G.load_state_dict(cpu.G.state_dict())
            card.D.load_state_dict(cpu.D.state_dict())
        aug = builder.aug_draws(cpu, micro)
        with torch.backends.mkldnn.flags(enabled=onednn):
            _, m_cpu = getattr(builder, name)(cpu, batch_cpu, draws=draws[i],
                                              aug=aug)
        _, m_dev = getattr(builder, name)(card, batch_dev, draws=draws[i],
                                          aug=aug)
        if set(m_cpu) != set(m_dev):
            raise AssertionError(f"{what} {name}: losses {sorted(m_dev)} vs "
                                 f"{sorted(m_cpu)}")
        for k, v in m_cpu.items():
            a, b = float(m_dev[k]), float(v)
            if abs(a - b) > 1e-4 * abs(b) + 1e-9:
                raise AssertionError(f"{what} {name} {k}: card {a} cpu {b}")
        net, lr = ("G", builder.g_lr) if i == 0 else ("D", builder.d_lr)
        other = "D" if i == 0 else "G"
        opt = f"{net.lower()}_opt"
        got = getattr(card, net)
        summary = hold_state(got, getattr(cpu, net).state_dict(), lr,
                             first_moments(got, getattr(card, opt)),
                             first_moments(getattr(cpu, net),
                                           getattr(cpu, opt)), what=net)
        hold_state(getattr(card, other), getattr(cpu, other).state_dict(),
                   what=f"{what} {name} {other}")
        log(f"tiny {what} {name}, card vs CPU (f32, oneDNN "
            f"{'on' if onednn else 'off'}, batch seed {seed}): "
            f"{len(m_cpu)} losses within 1e-4; {summary}")


def full_width_option(torch, dev, G, name, overrides, n, want_blends,
                      steps: int = 1) -> dict:
    """One counted train_step (launch counts set to 0 before it and read
    after: masked_blend ``want_blends``, spade_cond 0) of the default opts
    with ``overrides`` at SIZE^2 and ``n`` per domain, the bf16 policy, on
    ``G`` and a fresh seed-1 D and optimizer states: finite losses, every
    parameter moved but the ADVENT output biases (zero gradient); then
    ``steps`` timed steps (the counted one warmed them) and the peak
    memory over all of them. ``G`` is left trained and in train mode."""
    import statistics

    from climategan_torch import bench_train, kernels
    from climategan_torch.models.discriminator import create_discriminator
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts

    opts = load_opts(commandline_opts=overrides)
    builder = StepBuilder(opts)
    state = builder.state_for(G, create_discriminator(opts, 1).to(dev))
    batch = bench_train.synthetic_batch(n, SIZE, 160, dev)
    before = {f"{net}.{k}": v.detach().clone()
              for net, mod in (("G", state.G), ("D", state.D))
              for k, v in mod.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    state, metrics = builder.train_step(state, batch)
    torch.cuda.synchronize()
    counted = dict(kernels.launches)
    if counted["masked_blend"] != want_blends or any(
            v for k, v in counted.items() if k != "masked_blend"):
        raise AssertionError(f"{name}: a step launched {counted}, not "
                             f"masked_blend {want_blends} and nothing else")
    bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
    if bad:
        raise AssertionError(f"{name}: non-finite losses {bad}")
    after = {f"{net}.{k}": v
             for net, mod in (("G", state.G), ("D", state.D))
             for k, v in mod.named_parameters()}
    unchanged = [k for k, v in before.items()
                 if k not in ZERO_GRADIENT_ANY and torch.equal(v, after[k])]
    if unchanged:
        raise AssertionError(f"{name}: unchanged parameters {unchanged[:20]}")
    del before
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = builder.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    out = {"p50_ms": statistics.median(times), "ms": times,
           "peak": torch.cuda.max_memory_allocated(), "launches": counted,
           "g_total": float(metrics["g_total"]),
           "d_total": float(metrics["d_total"])}
    del state, batch, metrics
    torch.cuda.empty_cache()
    return out


def option_tiny_steps(torch, dev) -> None:
    """Phase 10.1 (see the module docstring): each option's tiny step,
    card vs CPU. These f32 holds, and the SPADE masker's tiny step in 9.5,
    run with nothing else on the card: the card's f32 convolutions sum in
    an order that depends on what else runs there, and at a kink that
    moves gradients past hold_state's bars (a side process beside 9.5 put
    encoder.bn1.bias 2.65e-05 off; H100 80GB HBM3)."""
    t_phase = time.perf_counter()
    # ---- 10.1 tiny steps, card vs CPU -----------------------------------
    # the tiny step's f32 gradients sit at kinks (leaky ReLUs; the feature
    # matching's L1 where the paste leaves a real and a painted patch equal)
    # for many batches, where two f32 implementations land on either side
    # and differ beyond hold_state's bars (ROADMAP C). Probed on an H100:
    # all the options at once missed the bars on every batch seed 0-6;
    # without pl4m, and pl4m alone, they hold on seed 0 against the CPU
    # with oneDNN on and off; accumulation holds on seed 5 and remat on
    # seed 0 with oneDNN on.
    hold_tiny_step(torch, dev, COMBINED_WITHOUT_PL4M, 2,
                   "local D + WGAN_gp + diff-aug", onednn=False)
    hold_tiny_step(torch, dev, PL4M, 2, "pl4m", onednn=False)
    hold_tiny_step(torch, dev, ["train.grad_accumulation=2"], 4,
                   "grad_accumulation 2", seed=5)
    for policy, overrides in REMAT.items():
        hold_tiny_step(torch, dev, overrides, 2, f"remat {policy!r}")
    log(f"phase 10 tiny steps: {time.perf_counter() - t_phase:.1f} s")


def step_options_phase(torch, dev, val_lists, after_tiny=None) -> dict:
    """Phase 10: the step's options and FID (see the module docstring).
    ``val_lists``: phase 8's dataset lists; ``after_tiny`` is called once
    10.1's tiny steps are done. Returns the launches of the pl4m and
    accumulated steps and of the FID evaluations."""
    from climategan_torch.models.generator import create_generator
    from climategan_torch.utils.opts import load_opts

    t_phase = time.perf_counter()
    option_tiny_steps(torch, dev)
    if after_tiny is not None:
        after_tiny()
    torch.cuda.empty_cache()
    G = create_generator(load_opts(), 0).to(dev)
    results = options_full_width(torch, dev, G)
    log(f"phase 10 full-width steps: {time.perf_counter() - t_phase:.1f} s")
    fid_launches = fid_checks(torch, dev, G.eval(), val_lists)
    del G
    torch.cuda.empty_cache()
    log(f"step options and FID phase: {time.perf_counter() - t_phase:.1f} s")
    return {"pl4m_step": results["pl4m"]["launches"],
            "grad_accumulation_step": results["grad_accumulation"]["launches"],
            "fid": fid_launches}


def options_full_width(torch, dev, G) -> dict:
    """Phase 10.2-10.3: each option's full-width step on ``G``, then plain
    and remat at the default batch. Returns each option's
    ``full_width_option`` result."""
    results = {}
    for name, (overrides, n, blends) in FULL_OPTIONS.items():
        r = results[name] = full_width_option(torch, dev, G, name, overrides,
                                              n, blends)
        log(f"full-width step, {name} ({SIZE}^2, {n} per domain, bf16 "
            f"policy): timed step " + ", ".join(
                f"{t:.2f}" for t in r["ms"]) + f" ms, peak {r['peak']:,} B "
            f"({r['peak'] / 2**30:.2f} GiB), launches {r['launches']}, "
            f"g_total {r['g_total']:.4f} d_total {r['d_total']:.4f}")
    log(f"masked_blend launches per train_step: pl4m "
        f"{results['pl4m']['launches']['masked_blend']}, grad_accumulation 2 "
        f"{results['grad_accumulation']['launches']['masked_blend']} "
        "(the default step: 2, PERF.md section 6)")
    for name, overrides in (("plain", []), ("remat ''", REMAT[""])):
        r = full_width_option(torch, dev, G, f"{name} batch {BIG_BATCH}",
                              overrides, BIG_BATCH, 4 if overrides else 2)
        log(f"batch {BIG_BATCH} per domain, {name}: timed step "
            + ", ".join(f"{t:.2f}" for t in r["ms"]) + " ms, peak "
            f"{r['peak']:,} B ({r['peak'] / 2**30:.2f} GiB)")
    torch.cuda.empty_cache()
    return results


def fid_checks(torch, dev, G, val_lists) -> dict:
    """Phase 10.4: the FID Inception's features and the Newton-Schulz root,
    card vs CPU; ``Trainer.compute_val_fid`` with ``G`` (eval mode) on
    phase 8's val set and on FID_IMAGES in-memory images. Returns the
    launches of each evaluation."""
    import numpy as np

    from climategan_torch import fid, kernels
    from climategan_torch.data.datasets import get_all_loaders
    from climategan_torch.trainer import Trainer
    from climategan_torch.utils.opts import load_opts

    # ---- 10.4 FID --------------------------------------------------------
    g = torch.Generator().manual_seed(12)
    images = torch.rand(4, 3, 256, 256, generator=g) * 2 - 1
    feats = {}
    for where in ("card", "cpu"):
        ev = fid.FIDEvaluator(fid.InceptionV3Features().init_weights(
            torch.Generator().manual_seed(0)), 4,
            dev if where == "card" else "cpu")
        feats[where] = ev.features(images).cpu()
    scale = feats["cpu"].abs().max().item()
    err = (feats["card"] - feats["cpu"]).abs().max().item()
    log(f"FID Inception features (4 images at 299^2, f32, TF32 off), card vs "
        f"CPU: max error {err:.3e} of a largest {scale:.3e} "
        f"({err / scale:.3e}; bar {FID_FEATURE_TOL})")
    if not err <= FID_FEATURE_TOL * scale:
        raise AssertionError("FID features: card and CPU disagree")
    rs = np.random.default_rng(13)
    covs = []
    for shift in (0.0, 0.3):
        f = torch.from_numpy(rs.standard_normal((FID_IMAGES, fid.FEATURES))
                             + shift)
        covs.append(fid.activation_statistics(f)[1])
    eye = torch.eye(fid.FEATURES, dtype=torch.float64) * 1e-6
    prod = (covs[0] + eye) @ (covs[1] + eye)
    t0 = time.perf_counter()
    root_cpu = fid._sqrtm_newton_schulz(prod)
    t_cpu = time.perf_counter() - t0
    prod_dev = prod.to(dev)
    fid._sqrtm_newton_schulz(prod_dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    root_dev = fid._sqrtm_newton_schulz(prod_dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    err = ((root_dev.cpu() - root_cpu).abs().max()
           / root_cpu.abs().max()).item()
    tr_cpu = torch.trace(root_cpu).item()
    tr_err = abs(torch.trace(root_dev).item() - tr_cpu) / abs(tr_cpu)
    log(f"Newton-Schulz square root of a {fid.FEATURES}^2 covariance product "
        f"({FID_IMAGES} samples each), float64: card {1e3 * t_dev:.2f} ms, "
        f"CPU {1e3 * t_cpu:.1f} ms; card vs CPU {err:.3e} of the largest "
        f"entry (bar {NS_ENTRY_TOL}), trace {tr_err:.3e} relative (bar "
        f"{NS_TRACE_TOL})")
    if not (err <= NS_ENTRY_TOL and tr_err <= NS_TRACE_TOL):
        raise AssertionError("Newton-Schulz: card and CPU disagree")

    opts = load_opts(commandline_opts=[
        f"data.files.train={json.dumps(val_lists['train'])}",
        f"data.files.val={json.dumps(val_lists['val'])}",
        f"data.loaders.batch_size={TRAIN_BATCH}"])
    trainer = Trainer(opts, device=dev)
    trainer.loaders = get_all_loaders(opts)
    trainer.G = G
    fid_launches = {}
    for what, loader in (
            ("phase 8's val set", None),
            (f"{FID_IMAGES} images", [
                {"data": {"x": rs.uniform(-1, 1, (TRAIN_BATCH, SIZE, SIZE, 3))
                          .astype(np.float32),
                          "m": (rs.random((TRAIN_BATCH, SIZE, SIZE, 1)) > 0.5)
                          .astype(np.float32)}}
                for _ in range(-(-FID_IMAGES // TRAIN_BATCH))])):
        if loader is not None:
            trainer.loaders["val"]["rf"] = loader
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        value = trainer.compute_val_fid()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fid_launches[what] = dict(kernels.launches)
        if not np.isfinite(value):
            raise AssertionError(f"compute_val_fid on {what}: {value}")
        log(f"Trainer.compute_val_fid on {what} ({SIZE}^2, f32 paints in "
            f"batches of {opts.train.fid.get('paint_batch_size', 8)}): FID "
            f"{value:.4f} "
            f"(random Inception: relative only) in {seconds:.2f} s; launches "
            f"{fid_launches[what]}")
        if fid_launches[what]["spade_cond"] == 0 or \
                fid_launches[what]["masked_blend"] == 0:
            raise AssertionError("compute_val_fid did not paint through "
                                 "spade_cond and masked_blend")
    del trainer
    return fid_launches




# ---------------------------------------------------------------------------
# phase 11: data parallel over torch.distributed
DP_TIMEOUT = 300  # seconds a phase-11 launch may take, start and build included
DP_DRAWS = ((0.05, False), (0.1, False))


def dp_rank(device, payload) -> dict:
    """One rank of phase 11 (``parallel.spawn.run_ranks``, or this process
    in 11.a's group of one): each job, a
    step name, its draws and optionally a row shard count (phase 13.d:
    the rank's rows split again over that many shards of its device),
    from the seed-0 state (``replicate``d) on this rank's rows of the
    synthetic batch, with PyTorch's deterministic
    algorithms where ``deterministic``; per job the launches, the losses
    (summed over the ranks), the state's sha256 and, on rank 0 with
    ``models``, both models and their first moments on the CPU. A payload
    of ``groups`` runs each group's payload in turn in the same ranks (one
    process start) and returns their results in order; ``keep_state``
    returns the last job's state too."""
    if "groups" in payload:
        return [dp_rank(device, p) for p in payload["groups"]]
    import torch

    from climategan_torch import kernels
    from climategan_torch.parallel import distributed
    from climategan_torch.parallel.mesh import replicate, shard_batch
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.checkpoint import checkpoint_dict, state_digest
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import first_moments

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(payload["deterministic"],
                                      warn_only=True)
    builder = StepBuilder(load_opts(path=payload["config"]))
    batch = shard_batch(_dp_batch(payload, device), distributed.rank(),
                        distributed.world(), builder.grad_accumulation)
    out = {"backend": torch.distributed.get_backend(),
           "world": distributed.world(), "jobs": []}
    for name, draws, devices, state in _job_states(builder, device,
                                                   payload["jobs"]):
        replicate(state)
        kernels.reset_launches()
        _sync(torch, device)
        t0 = time.perf_counter()
        state, metrics = getattr(builder, name)(state, batch, draws=draws,
                                                devices=devices)
        _sync(torch, device)
        rec = {"launches": dict(kernels.launches),
               "step_s": time.perf_counter() - t0,
               "metrics": {k: float(v) for k, v in metrics.items()},
               "digest": state_digest(checkpoint_dict(state, 0))}
        if payload["models"] and distributed.is_main():
            def cpu(tree):
                return {k: v.detach().cpu() for k, v in tree.items()}

            rec.update(G=cpu(state.G.state_dict()),
                       D=cpu(state.D.state_dict()),
                       g_mu=cpu(first_moments(state.G, state.g_opt)),
                       d_mu=cpu(first_moments(state.D, state.d_opt)))
        out["jobs"].append(rec)
        if payload.get("time_reduce"):
            out["reduce_ms"] = _reduce_ms(torch, device, state)
    if payload.get("keep_state"):  # in this process: the last job's state
        out["state"] = state
    return out


def _job_states(builder, device, jobs):
    """(name, draws, row shards' devices or None, state) of each job (a
    step name, its draws and optionally a row shard count): a copy of the
    seed-0 models, built once, with fresh optimizer states and draws'
    generator, as ``init_state`` gives them."""
    import copy

    first = builder.init_state(0, device)
    for i, (name, draws, *shards) in enumerate(jobs):
        devices = [device] * shards[0] if shards and shards[0] > 1 else None
        if i == len(jobs) - 1:
            yield name, draws, devices, first
        else:
            yield name, draws, devices, builder.state_for(
                copy.deepcopy(first.G), copy.deepcopy(first.D), 0)


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _reduce_ms(torch, device, state) -> dict:
    """ms of ``all_reduce_grads`` over gradients shaped as G's and D's
    parameters (f32 on the card): the median of 5 after one warm call,
    each ended by a synchronise; with the bytes summed."""
    import statistics

    from climategan_torch.parallel import distributed

    grads = [torch.ones_like(p) for m in (state.G, state.D)
             for p in m.parameters()]
    times = []
    for _ in range(6):
        _sync(torch, device)
        distributed.barrier()
        t0 = time.perf_counter()
        distributed.all_reduce_grads(grads)
        _sync(torch, device)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"ms": statistics.median(times[1:]),
            "bytes": sum(g.numel() * g.element_size() for g in grads)}


def _dp_config(tiny: bool) -> dict:
    """The opts overrides of phase 11's steps: the default opts, or
    tiny_opts(32)'s sizes without a bicubic resize (``TINY_DP_OVERRIDES``:
    a step that is reproducible run to run on the card)."""
    from climategan_torch.utils.step_check import TINY_DP_OVERRIDES

    return TINY_DP_OVERRIDES if tiny else {}


def _dp_batch(payload, device):
    """The synthetic batch of a phase-11 payload."""
    from climategan_torch import bench_train

    return bench_train.synthetic_batch(payload["n"], payload["size"],
                                       payload["feat"], device,
                                       seed=payload["batch_seed"],
                                       depth=payload.get("depth"))


def _in_thread(what: str, call):
    """Start ``call()`` in a thread of this process; returns a function
    that waits for it, logs its seconds and returns what it returned (what
    it raised is raised there). The thread is not a daemon: if this
    process fails meanwhile, it still waits for the call, which ends or
    kills the processes it started."""
    import threading

    box, t0 = {}, time.perf_counter()

    def target():
        try:
            box["got"] = call()
        except BaseException as e:  # raised again by finish()
            box["error"] = e
        box["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=target)
    thread.start()

    def finish():
        thread.join()
        if "error" in box:
            raise box["error"]
        log(f"  {what}: {box['s']:.1f} s with their start")
        return box["got"]

    return finish


def _start_ranks(torch, world, payload, devices, backend):
    """Start ``dp_rank`` on ``world`` ranks from a thread of this process:
    their start, build and steps run beside what this process does next.
    Returns a function that waits for the ranks and returns what
    ``_launch`` returns (a failed launch raises there)."""
    from climategan_torch.parallel.spawn import run_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ranks = _in_thread(f"{world} {backend} rank(s) on {devices}",
                       lambda: run_ranks("chip_smoke:dp_rank", world, payload,
                                         devices=devices, backend=backend,
                                         timeout=DP_TIMEOUT))

    def finish() -> list:
        got = ranks()
        groups = ([[r[g] for r in got] for g in range(len(payload["groups"]))]
                  if "groups" in payload else [got])
        for ranks_ in groups:
            digests = [[j["digest"] for j in r["jobs"]] for r in ranks_]
            if any(d != digests[0] for d in digests):
                raise AssertionError(f"the ranks' states differ: {digests}")
        return groups if "groups" in payload else got

    return finish


def _launch(torch, world, payload, devices, backend) -> list:
    """``dp_rank`` on ``world`` ranks; every rank's state after each job
    must be rank 0's. Returns each rank's result, or for a payload of
    ``groups`` each group's results by rank."""
    return _start_ranks(torch, world, payload, devices, backend)()


@contextlib.contextmanager
def _nccl_world_one(torch, device):
    """A NCCL process group of this process alone (rank 0 of 1 on
    ``device``), left at the end."""
    from climategan_torch.parallel import distributed
    from climategan_torch.parallel.spawn import free_port

    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1, device_id=torch.device(device))
    try:
        yield
    finally:
        distributed.shutdown()


def _plain_steps(torch, dev, payload, jobs) -> list:
    """The jobs of ``dp_rank`` in this process on the whole batch."""
    from climategan_torch import kernels
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.checkpoint import checkpoint_dict, state_digest
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import first_moments

    builder = StepBuilder(load_opts(path=payload["config"]))
    batch = _dp_batch(payload, dev)
    out = []
    for name, draws, devices, state in _job_states(builder, dev, jobs):
        kernels.reset_launches()
        state, metrics = getattr(builder, name)(state, batch, draws=draws,
                                                devices=devices)
        _sync(torch, dev)
        out.append({"launches": dict(kernels.launches), "state": state,
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "digest": state_digest(checkpoint_dict(state, 0)),
                    "mu": (first_moments(state.G, state.g_opt),
                           first_moments(state.D, state.d_opt)),
                    "lr": (builder.g_lr, builder.d_lr)})
    return out


def tiny_payload() -> tuple:
    """Phase 11.b's payload, with phase 13.d's jobs: two gloo ranks on
    cuda:0 at tiny sizes, each step plain and hybrid (each rank's rows over
    two row shards); and the plain jobs, whose one-process steps on the
    global batch (``tiny_reference``) hold them."""
    from climategan_torch.utils.step_check import TINY_DP_DEPTH, TINY_SIZE

    plain_jobs = [("g_step", DP_DRAWS[0]), ("d_step", DP_DRAWS[1])]
    tiny = {"config": _dp_config(True), "n": 2, "size": TINY_SIZE,
            "feat": 32, "depth": TINY_DP_DEPTH, "batch_seed": 0,
            "models": True, "deterministic": True,
            "jobs": plain_jobs + [job + (2,) for job in plain_jobs]}
    return tiny, plain_jobs


def tiny_reference(torch, dev, tiny, plain_jobs) -> list:
    """The card's one-process steps of ``tiny_payload``'s plain jobs."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _plain_steps(torch, dev, tiny, plain_jobs)
    finally:
        torch.use_deterministic_algorithms(False)


def check_tiny_ranks(tiny, ranks, ref) -> None:
    """Phase 11.b and 13.d: the ranks' steps of ``tiny_payload`` held to
    the one-process steps."""
    import copy

    from climategan_torch.utils.step_check import hold_state

    for i, (name, _, *shards) in enumerate(tiny["jobs"]):
        mine, want_job = ranks[0]["jobs"][i], ref[i % 2]
        what = (f"13.d {name} on 2 ranks x 2 row shards" if shards
                else f"11.b {name}")
        for k, v in want_job["metrics"].items():
            if abs(mine["metrics"][k] - v) > 1e-4 * abs(v) + 1e-9:
                raise AssertionError(f"{what} {k}: {mine['metrics'][k]}, "
                                     f"one process {v}")
        st = want_job["state"]
        got_g, got_d = copy.deepcopy(st.G), copy.deepcopy(st.D)
        got_g.load_state_dict(mine["G"])
        got_d.load_state_dict(mine["D"])
        j = i % 2
        summary = hold_state((got_g, got_d)[j], (st.G, st.D)[j].state_dict(),
                             want_job["lr"][j],
                             (mine["g_mu"], mine["d_mu"])[j],
                             want_job["mu"][j], what=what)
        hold_state((got_d, got_g)[j], (st.D, st.G)[j].state_dict(),
                   what=f"{what}, the other model")
        if shards:
            if mine["launches"]["masked_blend"] != 2:
                raise AssertionError(f"{what}: launches {mine['launches']}")
            log(f"{what} on cuda:0 (tiny, TINY_DP_OVERRIDES, one image a "
                f"rank split over 2 row shards; in phase 11.b's launch) "
                f"against the one-process step on the global batch: "
                f"{len(mine['metrics'])} losses within 1e-4; {summary}; "
                f"digests equal; a rank's launches {mine['launches']}")
            continue
        log(f"11.b two gloo ranks on cuda:0 (tiny, batch 2 per domain, one "
            f"row per rank), {name} against the one-process step: "
            f"{len(mine['metrics'])} losses within 1e-4; {summary}; digests "
            f"equal")


def _serve_checks(torch, run_dir: Path) -> None:
    """Phase 11.d's serving checks: phase 8's run dir (its first epoch
    trained by one NCCL rank of ``torch.distributed.run``) served by
    apply_events -r with and without --mesh, bit-equal; render split over
    two replicas on cuda:0 within 1 LSB of the unsplit render."""
    import tempfile

    import cv2
    import numpy as np

    from climategan_torch import apply_events as cli
    from climategan_torch import kernels

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(11)
        (root / "imgs").mkdir()
        for i in range(2):
            cv2.imwrite(str(root / "imgs" / f"photo_{i}.png"),
                        rng.integers(0, 256, (720, 1280, 3), np.uint8))
        pngs = {}
        for flags in ([], ["--mesh"]):
            out = root / ("mesh" if flags else "one")
            kernels.reset_launches()
            if cli.main(["-i", str(root / "imgs"), "-o", str(out), "-r",
                         str(run_dir), "-b", "2", "--half", *flags]) != 0:
                raise AssertionError(f"apply_events -r {flags} failed")
            torch.cuda.synchronize()
            if dict(kernels.launches) != MAIN_PATH_LAUNCHES:
                raise AssertionError(f"apply_events {flags}: launches "
                                     f"{dict(kernels.launches)}")
            pngs[bool(flags)] = {p.name: cv2.imread(str(p))
                                 for p in sorted(out.glob("*.png"))}
        if len(pngs[False]) != 6 or pngs[True].keys() != pngs[False].keys() \
                or any(not np.array_equal(pngs[True][k], v)
                       for k, v in pngs[False].items()):
            raise AssertionError("apply_events --mesh on one card is not "
                                 "bit-equal to apply_events")
        log(f"11.d apply_events -r <phase 8's run dir> with and without "
            f"--mesh on one card: {len(pngs[False])} PNGs bit-equal, launches "
            f"{MAIN_PATH_LAUNCHES} each")

        photos = [(f"p{i}", rng.integers(0, 256, (720, 1280, 3), np.uint8))
                  for i in range(4)]
        args = cli.parse_args(["-i", ".", "-b", "2"])
        rendered = {}
        for what, devices in (("one", None), ("split", ["cuda:0", "cuda:0"])):
            got_imgs = {}
            cli.render(photos, args,
                       lambda n, e, img: got_imgs.__setitem__((n, e),
                                                              img.copy()),
                       infer=cli.load_model(args, devices))
            rendered[what] = got_imgs
        diffs = [np.abs(rendered["split"][k].astype(int) - v.astype(int))
                 for k, v in rendered["one"].items()]
        worst_lsb = max(int(d.max()) for d in diffs)
        if rendered["split"].keys() != rendered["one"].keys() or \
                len(diffs) != 12 or worst_lsb > 1:
            raise AssertionError(f"render split over two replicas: worst "
                                 f"{worst_lsb} LSB")
        share = np.mean([float((d == 0).mean()) for d in diffs])
        log(f"11.d render split over [cuda:0, cuda:0] (f32, 4 photos, -b 2): "
            f"within {worst_lsb} LSB of the unsplit render on 100% of values "
            f"({100 * share:.4f}% equal)")



def parallel_phase(torch, dev, run_dir: Path) -> dict:
    """Phase 11 (see the module docstring). ``run_dir``: phase 8's, written
    by one NCCL rank of ``torch.distributed.run``. Returns each kernel's
    launches per rank step of (a)."""
    from climategan_torch.parallel.mesh import mesh_size

    t_phase = time.perf_counter()
    # g_step and d_step, each from the seed-0 state: the d_step's losses
    # then come from the same G on both sides, not from a G update whose
    # noise values (ExtraAdam's +-lr) the split moves
    jobs = [("g_step", DP_DRAWS[0]), ("d_step", DP_DRAWS[1])]
    full = {"config": _dp_config(False), "n": BATCH, "size": SIZE,
            "feat": 160, "batch_seed": 0, "jobs": jobs, "models": False,
            "deterministic": True, "time_reduce": True}

    # ---- 11.b and 11.c: two launches of two gloo ranks on cuda:0 ----------
    # 11.b tiny (with phase 13.d's hybrid steps: each rank's rows over two
    # row shards of cuda:0) and 11.c at full width in f32: in bf16 a mean
    # of near-cancelling D outputs (s_advent_D_r, about 0.015 from outputs
    # of about 1) moves by 4.5% of itself between a forward of one row and
    # of two (H100 80GB HBM3, 700 W). Both launches run beside each other
    # and beside this process's own work below, 11.d's serving checks and
    # 11.a (one launch of both took 66-80 s alone); what the ranks time is
    # information only. 11.c's ranks start once this process's f32
    # reference steps are done and their memory is released: with those
    # steps beside them the card ran out of its 80 GB in two of four runs
    # (the ranks' f32 steps failed to allocate; H100 80GB HBM3)
    tiny, plain_jobs = tiny_payload()
    full32 = dict(full, config={"train": {"bf16": False}},
                  deterministic=False)
    gloo_tiny = _start_ranks(torch, 2, tiny, ["cuda:0", "cuda:0"], "gloo")
    want_metrics = [p["metrics"] for p in
                    _plain_steps(torch, dev, full32, full32["jobs"])]
    torch.cuda.empty_cache()
    gloo_full = _start_ranks(torch, 2, full32, ["cuda:0", "cuda:0"], "gloo")
    ref = tiny_reference(torch, dev, tiny, plain_jobs)
    _serve_checks(torch, run_dir)

    # ---- 11.a NCCL at world size 1, full width ---------------------------
    # bit equality needs a reproducible step: PyTorch's deterministic
    # algorithms (cuDNN's deterministic convolutions, no atomics in the
    # backward); any op without one is printed. The rank is this process
    # (phase 8's trainer and 11.d's bench_train --mesh start NCCL ranks of
    # their own); its all-reduce is timed once the gloo ranks are done
    with warnings.catch_warnings(record=True) as alerts:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            plain = _plain_steps(torch, dev, full, full["jobs"])
        finally:
            torch.use_deterministic_algorithms(False)
    for msg in sorted({str(a.message)[:200] for a in alerts
                       if "deterministic" in str(a.message)}):
        log(f"  no deterministic version: {msg}")
    want = [p["digest"] for p in plain]
    del plain
    with _nccl_world_one(torch, "cuda:0"):
        t0 = time.perf_counter()
        try:
            got = dp_rank("cuda:0", dict(full, time_reduce=False,
                                         keep_state=True))
        finally:
            torch.use_deterministic_algorithms(False)
        log(f"  1 nccl rank in this process on cuda:0: "
            f"{time.perf_counter() - t0:.1f} s")
        digests = [j["digest"] for j in got["jobs"]]
        if got["backend"] != "nccl" or digests != want:
            # is the plain step itself reproducible here?
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                again = [p["digest"] for p in
                         _plain_steps(torch, dev, full, full["jobs"])]
            finally:
                torch.use_deterministic_algorithms(False)
            raise AssertionError(f"NCCL at world size 1 ({got['backend']}): "
                                 f"states {digests} against the plain steps' "
                                 f"{want} (the plain steps again: {again})")
        tiny_got, ranks = gloo_tiny(), gloo_full()
        reduce_ms = _reduce_ms(torch, "cuda:0", got.pop("state"))
        torch.cuda.empty_cache()
    ddp = {k: sum(j["launches"][k] for j in got["jobs"])
           for k in got["jobs"][0]["launches"]}
    if ddp["masked_blend"] != 2 or ddp["spade_cond"] != 0:
        raise AssertionError(f"a rank's step launched {ddp}")
    log(f"11.a all_reduce_grads over NCCL at world size 1: "
        f"{reduce_ms['ms']:.2f} ms for {reduce_ms['bytes']:,} "
        f"B of G and D gradients")
    log(f"11.a NCCL at world size 1, full width ({SIZE}^2, {BATCH} per "
        f"domain, deterministic algorithms): the states after g_step and "
        f"d_step, each from the seed-0 state, bit-equal to the plain steps' "
        f"(sha256 {want[0][:16]}..., {want[1][:16]}...); launches per rank "
        f"step (g_step + d_step) {ddp}")

    check_tiny_ranks(tiny, tiny_got, ref)
    del ref, tiny_got
    got_metrics = [j["metrics"] for j in ranks[0]["jobs"]]
    worst = max(abs(got[k] - v) / max(abs(v), 1e-12)
                for got, want_job in zip(got_metrics, want_metrics)
                for k, v in want_job.items())
    if [set(m) for m in got_metrics] != [set(m) for m in want_metrics] \
            or worst > 1e-2:
        raise AssertionError(f"11.c losses: 2 ranks {got_metrics}, one "
                             f"process {want_metrics}")
    got_metrics = {k: v for m in got_metrics for k, v in m.items()}
    log(f"11.c two gloo ranks on cuda:0, full width (one image per rank per "
        f"domain, f32): {len(got_metrics)} losses within {worst:.2e} "
        f"relative of the one-process steps' (bar 1e-2); digests equal; g_step "
        f"{ranks[0]['jobs'][0]['step_s']:.2f} s, d_step "
        f"{ranks[0]['jobs'][1]['step_s']:.2f} s (first calls, beside this "
        f"process's steps); all_reduce_grads "
        f"over gloo: {ranks[0]['reduce_ms']['ms']:.1f} ms for "
        f"{ranks[0]['reduce_ms']['bytes']:,} B")

    # ---- 11.d the benches' --mesh, after the ranks --------------------------
    from climategan_torch import bench, bench_train

    for mod, argv in ((bench, ["--mesh", "--batch", "8", "--events", "all",
                               "--iters", "3", "--warmup", "1"]),
                      (bench_train, ["--mesh", "--batch", "2", "--iters", "2",
                                     "--warmup", "1"])):
        t0 = time.perf_counter()
        line = mod.run_bench(mod.parse_args(argv))
        torch.cuda.empty_cache()
        if line.get("n_devices") != mesh_size(int(argv[2]),
                                              torch.cuda.device_count()) \
                or not line["value"] > 0:
            raise AssertionError(f"{mod.__name__} {argv}: {line}")
        log(f"11.d {mod.__name__} {' '.join(argv)} "
            f"({time.perf_counter() - t0:.1f} s): {json.dumps(line)}")

    # ---- 11.e several cards ------------------------------------------------
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        devices = [f"cuda:{i}" for i in range(n_cards)]
        wide = dict(full, n=n_cards)
        got = _launch(torch, n_cards, wide, devices, "nccl")
        log(f"11.e NCCL over {n_cards} cards, full width, one image per card "
            f"per domain: digests equal, losses "
            f"{got[0]['jobs'][0]['metrics']}")
    else:
        log("11.e not run: this machine shows one card "
            "(torch.cuda.device_count() == 1); NCCL over several cards "
            "needs two or more")
    log(f"data-parallel phase: {time.perf_counter() - t_phase:.1f} s")
    return ddp


# ---------------------------------------------------------------------------
# phase 12: row-sharded (spatial) and hybrid inference
SPATIAL_SHARDS = (2, 4)
SPATIAL_DEVICE = "cuda:0"  # the shards' device, repeated
# the f32 mask of a row-sharded forward against the unsharded one on the
# card: the same convolutions on row windows, which cuDNN may run with
# other algorithms than on the whole map (f32 rounding, set before the run)
SPATIAL_MASK_BAR = 1e-4


def _spatial_ranges(torch, fn):
    """One call of ``fn`` under torch.profiler: (the host ms and the device
    ms inside the outermost "spatial.exchange" and "spatial.collective"
    ranges, the call's wall ms, the device's busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = sum(e.device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    host = dev_ms = 0.0
    for e in events:
        if (e.device_type != DeviceType.CPU
                or not e.name.startswith("spatial.")):
            continue
        parent, nested = e.cpu_parent, False
        while parent is not None:
            nested |= parent.name.startswith("spatial.")
            parent = parent.cpu_parent
        if not nested:
            host += e.cpu_time_total / 1e3
            dev_ms += e.device_time_total / 1e3
    return host, dev_ms, wall, busy


def _spatial_host_ms(torch, fn):
    """One call of ``fn`` with the host's clock read at the edges of the
    outermost "spatial.exchange" and "spatial.collective" ranges
    (``spatial.trace_range``, replaced for the call): (the host ms inside
    them, the call's wall ms). A train step's ranges without a profiler:
    reading back a profile of a 2-shard step's host activity alone took
    about 25 s (H100 80GB HBM3 host)."""
    import threading

    from climategan_torch.parallel import spatial

    lock, clock = threading.Lock(), {"depth": 0, "t0": 0.0, "ms": 0.0}

    @contextlib.contextmanager
    def clocked(name):
        with lock:
            clock["depth"] += 1
            if clock["depth"] == 1:
                clock["t0"] = time.perf_counter()
        try:
            yield
        finally:
            with lock:
                clock["depth"] -= 1
                if clock["depth"] == 0:
                    clock["ms"] += (time.perf_counter() - clock["t0"]) * 1e3

    torch.cuda.synchronize()
    original, spatial.trace_range = spatial.trace_range, clocked
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        spatial.trace_range = original
    return clock["ms"], wall


def _hold_windows(torch, windows, what):
    """Each recorded (seg, pack) spade_cond call against spade_cond_plain
    at phase 2's bars: the f32 kernel within 1e-4, the bf16 kernel within
    one bf16 ulp of each output's largest magnitude. Returns the largest
    errors."""
    from climategan_torch.kernels.spade_cond import (
        spade_cond,
        spade_cond_packed,
        spade_cond_plain,
    )

    e32 = e16 = 0.0
    for i, (seg, pack) in enumerate(windows):
        a32 = (seg.float(), pack.args[0].float(), pack.args[1].float(),
               [tuple(t.float() for t in b) for b in pack.args[2]])
        ref = spade_cond_plain(*a32)
        for got, want in zip(spade_cond(*a32), ref):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            e32 = max(e32, (got - want).abs().max().item())
        for got, want in zip(spade_cond_packed(seg, pack), ref):
            ulp = 2.0 ** (torch.floor(torch.log2(want.abs().max())).item()
                          - 7)
            e = (got.float() - want).abs().max().item()
            if not e <= ulp:
                raise AssertionError(f"{what} spade_cond window {i} "
                                     f"{tuple(seg.shape)}: bf16 error {e} "
                                     f"> one ulp {ulp}")
            e16 = max(e16, e)
    return e32, e16


def spatial_phase(torch, dev) -> dict:
    """Phase 12 (see the module docstring): row-sharded inference on
    ["cuda:0"] * k at full width. The card's machine shows one card, so
    the shards share it: the numbers are the host's and the device's cost
    of the split, not scaling. Returns each kernel's launches per sharded
    forward by k."""
    import numpy as np

    from climategan_torch import apply_events as cli
    from climategan_torch import bench, kernels
    from climategan_torch.inference import (
        build_infer_fn,
        build_spatial_infer_fn,
    )
    from climategan_torch.models import norms as norms_mod
    from climategan_torch.models.blocks import SPADEResnetBlock
    from climategan_torch.utils.opts import load_opts

    t_phase = time.perf_counter()
    opts = load_opts()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand(BATCH, SIZE, SIZE, 3, device=dev, generator=g) * 2 - 1
    uniform = torch.rand(9, 9, device=dev, generator=g)
    g_dev = torch.tensor(G_VALUE, device=dev)

    def call(fn):
        return lambda: fn(x, uniform=uniform, g_value=g_dev)

    # ---- 12.a f32, the split against the unsharded forward ---------------
    G1, one = build_infer_fn(opts, dtype=torch.float32, device=dev, seed=0)
    want = one(x, uniform=uniform, g_value=g_dev)
    d = G1.depth_map(G1.infer_masker(
        x.permute(0, 3, 1, 2).contiguous())[0]).float()
    log("12.a the f32 depth's range per image (the smog min-max rescales "
        "it): " + ", ".join(f"[{lo:.6f}, {hi:.6f}]" for lo, hi in zip(
            d.amin((1, 2, 3)).tolist(), d.amax((1, 2, 3)).tolist())))
    del G1, d
    times = {1: cuda_ms(torch, call(one), reps=3)}
    launched = {}
    for k in SPATIAL_SHARDS:
        _, infer = build_spatial_infer_fn(opts, [SPATIAL_DEVICE] * k,
                                          dtype=torch.float32, seed=0)
        infer(x, uniform=uniform, g_value=g_dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = infer(x, uniform=uniform, g_value=g_dev)
        torch.cuda.synchronize()
        launched[k] = dict(kernels.launches)
        expect = {n: (18 * k if n == "spade_cond" else k)
                  for n in MAIN_PATH_LAUNCHES}
        if launched[k] != expect:
            raise AssertionError(f"{k} shards: launches {launched[k]}, "
                                 f"expected {expect}")
        for key in ("flood", "wildfire", "smog"):
            within, worst = lsb_agreement(got[key], want[key])
            equal = (got[key] == want[key]).float().mean().item()
            log(f"12.a {k} shards f32 {key}: within 1 LSB on "
                f"{100 * within:.4f}% of values (max {worst} LSB, "
                f"{100 * equal:.4f}% equal)")
            if not within >= 0.999:
                raise AssertionError(f"{k} shards: {key} disagrees")
        mask_err = (got["mask"] - want["mask"]).abs().max().item()
        log(f"12.a {k} shards f32 mask: max error {mask_err:.3e} (bar "
            f"{SPATIAL_MASK_BAR})")
        if not mask_err <= SPATIAL_MASK_BAR:
            raise AssertionError(f"{k} shards: mask error {mask_err}")
        times[k] = cuda_ms(torch, call(infer), reps=3)
        host, in_dev, wall, busy = _spatial_ranges(torch, call(infer))
        log(f"12.a {k} shards on one card, f32 640^2 batch {BATCH}: "
            f"{times[k]:.2f} ms per batch against {times[1]:.2f} unsharded; "
            f"under the profiler {wall:.2f} ms, of which exchanges and "
            f"collectives {host:.2f} ms of host time ({100 * host / wall:.1f}"
            f"%) and {in_dev:.3f} ms of device time ({100 * in_dev / busy:.1f}"
            f"% of {busy:.2f} busy ms)")
        del infer
        torch.cuda.empty_cache()
    del one

    # ---- 12.b bf16: the k = 4 forward's spade_cond windows ---------------
    _, one16 = build_infer_fn(opts, dtype=torch.bfloat16, device=dev, seed=0)
    want16 = one16(x, uniform=uniform, g_value=g_dev)
    times16 = {1: cuda_ms(torch, call(one16), reps=3)}
    del one16
    G16, infer16 = build_spatial_infer_fn(opts, [SPATIAL_DEVICE] * 4,
                                          dtype=torch.bfloat16, seed=0)
    # two launches per SPADE block and shard (18 at the default opts)
    n_windows = 4 * 2 * sum(isinstance(m, SPADEResnetBlock)
                            for m in G16.modules())
    windows = []
    kernel = norms_mod.spade_cond_packed

    def record(seg, pack):
        windows.append((seg, pack))
        return kernel(seg, pack)

    norms_mod.spade_cond_packed = record
    try:
        got16 = infer16(x, uniform=uniform, g_value=g_dev)
    finally:
        norms_mod.spade_cond_packed = kernel
    torch.cuda.synchronize()
    times16[4] = cuda_ms(torch, call(infer16), reps=3)
    for key in ("flood", "wildfire", "smog"):
        within, worst = lsb_agreement(got16[key], want16[key])
        log(f"12.b 4 shards bf16 {key} (information, not a bar): within 1 "
            f"LSB on {100 * within:.4f}% of values (max {worst} LSB)")
    log(f"12.b bf16 640^2 batch {BATCH}: 4 shards {times16[4]:.2f} ms per "
        f"batch against {times16[1]:.2f} unsharded")
    if len(windows) != n_windows:
        raise AssertionError(f"recorded {len(windows)} spade_cond windows")
    heights = sorted({seg.shape[1] for seg, _ in windows})
    e32, e16 = _hold_windows(torch, windows, "12.b")
    log(f"12.b the k = 4 forward's {len(windows)} spade_cond windows "
        f"(heights {heights}) against spade_cond_plain: f32 max error "
        f"{e32:.3e}, bf16 {e16:.3e} (within one ulp)")
    del G16, infer16, windows
    torch.cuda.empty_cache()

    # ---- 12.c apply_events --spatial -------------------------------------
    rng = np.random.default_rng(6)
    photos = [(f"photo_{i}", rng.integers(0, 256, shape, np.uint8))
              for i, shape in enumerate([(720, 1280, 3)] * 4
                                        + [(1280, 960, 3)] * 3)]
    rendered = {}
    for what, flags, devices in (("one", [], None),
                                 ("spatial", ["--spatial"],
                                  [SPATIAL_DEVICE] * 2)):
        args = cli.parse_args(["-i", ".", "-b", str(BATCH), *flags])
        imgs = {}
        kernels.reset_launches()
        n_batches = cli.render(
            photos, args, lambda n, e, img: imgs.__setitem__((n, e),
                                                             img.copy()),
            infer=cli.load_model(args, devices))
        torch.cuda.synchronize()
        k = 2 if flags else 1
        expect = {n: n_batches * (18 * k if n == "spade_cond" else k)
                  for n in MAIN_PATH_LAUNCHES}
        if dict(kernels.launches) != expect:
            raise AssertionError(f"render {flags}: launches "
                                 f"{dict(kernels.launches)}, expected "
                                 f"{expect}")
        rendered[what] = imgs
    if rendered["spatial"].keys() != rendered["one"].keys() \
            or len(rendered["one"]) != 3 * len(photos):
        raise AssertionError("apply_events --spatial wrote other images")
    diffs = [np.abs(rendered["spatial"][key].astype(int) - v.astype(int))
             for key, v in rendered["one"].items()]
    within = float(np.mean([np.mean(d <= 1) for d in diffs]))
    worst = max(int(d.max()) for d in diffs)
    log(f"12.c apply_events --spatial (load_model(args, devices=['cuda:0'] "
        f"* 2), f32, {len(photos)} photos, -b {BATCH}): {len(diffs)} PNGs "
        f"within 1 LSB of the unsharded serve on {100 * within:.4f}% of "
        f"values (max {worst} LSB)")
    if not within >= 0.999:
        raise AssertionError("apply_events --spatial disagrees")

    # ---- 12.d bench --spatial and --hybrid 2 -------------------------------
    for flags, devices in ((["--spatial"], [SPATIAL_DEVICE] * 2),
                           (["--hybrid", "2"], [SPATIAL_DEVICE] * 4)):
        argv = [*flags, "--batch", str(BATCH), "--events", "all", "--iters",
                "3", "--warmup", "1"]
        t0 = time.perf_counter()
        line = bench.run_bench(bench.parse_args(argv), devices=devices)
        torch.cuda.empty_cache()
        if not (line["value"] > 0 and line["mfu"] <= 1.05
                and line["n_devices"] == len(devices)):
            raise AssertionError(f"bench {argv}: {line}")
        log(f"12.d bench {' '.join(argv)} on {devices} "
            f"({time.perf_counter() - t0:.1f} s; one card: no scaling): "
            f"{json.dumps(line)}")
    log(f"row-sharded phase: {time.perf_counter() - t_phase:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# phase 13: row-sharded training
SPATIAL_TRAIN_SHARDS = (2, 4)
SPATIAL_TRAIN_BAR = 1e-4  # the f32 sharded step's losses, relative
# the f32 sharded step's first moments: their distance to the float64
# step's in multiples of the unsharded f32 step's (the largest over the
# leaves above hold_state's noise floor of a leaf's distance over its
# largest; the unsharded step's taken as at least hold_state's 1e-3)
SPATIAL_TRAIN_NOISE = 2.0
SPATIAL_TRAIN_TIMED = 1  # timed bf16 train steps per shard count


def _sharded_job(torch, builder, first, batch, i, devices):
    """Job i (0: g_step, 1: d_step) from a copy of ``first``, over
    ``devices`` (None: unsharded): (state, losses, the stepped model's
    first moments)."""
    import copy

    from climategan_torch.utils.step_check import first_moments

    name, draws = (("g_step", DP_DRAWS[0]), ("d_step", DP_DRAWS[1]))[i]
    state = builder.state_for(copy.deepcopy(first.G), copy.deepcopy(first.D),
                              0)
    state, metrics = getattr(builder, name)(state, batch, draws=draws,
                                            devices=devices)
    torch.cuda.synchronize()
    net, opt = (("G", state.g_opt), ("D", state.d_opt))[i]
    return (state, {k: float(v) for k, v in metrics.items()},
            first_moments(getattr(state, net), opt))


def _moment_distance(mu, truth, noise_floor):
    """The first moments ``mu`` against ``truth``'s: the largest over the
    leaves whose largest is above ``noise_floor`` times the model's of a
    leaf's largest distance over its largest, that leaf's name, how many
    of those leaves are beyond 1e-3 and how many there are."""
    tops = {key: v.abs().max().item() for key, v in truth.items()}
    floor = noise_floor * max(tops.values())
    far = [((mu[key].double() - v.double()).abs().max().item() / tops[key],
            key) for key, v in truth.items() if tops[key] > floor]
    worst = max(far)
    return worst[0], worst[1], sum(e > 1e-3 for e, _ in far), len(far)


def spatial_train_phase(torch, dev) -> dict:
    """Phase 13 (see the module docstring): row-sharded training of the
    default configuration at full width on ["cuda:0"] * k. Returns each
    kernel's launches per sharded train step by k, the bf16 step's p50 ms
    by k and masked_blend's largest errors against its plain version over
    a sharded step's launches."""
    import statistics

    from climategan_torch import bench_train, kernels
    from climategan_torch.kernels import masked_blend as masked_blend_mod
    from climategan_torch.kernels.masked_blend import (
        masked_blend,
        masked_blend_plain,
    )
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import NOISE_FLOOR, hold_state

    t_phase = time.perf_counter()
    batch = bench_train.synthetic_batch(BATCH, SIZE, 160, dev)

    # ---- 13.a the sharded steps against the unsharded ones ---------------
    torch.cuda.reset_peak_memory_stats(dev)
    # float64 first: the state held by hold_state, and the unsharded steps'
    # first moments are the truth of the f32 ones. In f32 the seed-0
    # model's full-depth backward is ill-conditioned, two f32 computations
    # of one step give first moments far beyond hold_state's 1e-3 apart
    # (ROADMAP C), so there the sharded step is held to the card's own f32
    # noise: the unsharded f32 step's distance to the float64 step
    builder = StepBuilder(load_opts(commandline_opts={"train": {
        "bf16": False}}))
    truth = {}
    for dtype in (torch.float64, torch.float32):
        t0 = time.perf_counter()
        first = builder.init_state(0, dev)
        first.G, first.D = first.G.to(dtype), first.D.to(dtype)
        on = {d: {key: v.to(dtype) if v.is_floating_point() else v
                  for key, v in b.items()} for d, b in batch.items()}
        worst, n_losses = {k: (0.0, "") for k in SPATIAL_TRAIN_SHARDS}, 0
        for i, (net, lr) in enumerate((("G", builder.g_lr),
                                       ("D", builder.d_lr))):
            ref, m_ref, mu_ref = _sharded_job(torch, builder, first, on, i,
                                              None)
            n_losses += len(m_ref)
            step_name = ("g_step", "d_step")[i]
            if dtype == torch.float64:
                truth[i] = mu_ref
            else:
                noise = _moment_distance(mu_ref, truth[i], NOISE_FLOOR)
                log(f"13.a f32 {step_name}, unsharded: the stepped model's "
                    f"first moments against the float64 step's: "
                    f"{noise[1]} {noise[0]:.4f} of its largest, "
                    f"{noise[2]} of {noise[3]} leaves beyond 1e-3 (the "
                    f"card's f32 noise)")
            for k in SPATIAL_TRAIN_SHARDS:
                st, m, mu = _sharded_job(torch, builder, first, on, i,
                                         [SPATIAL_DEVICE] * k)
                what = f"13.a {k} shards {str(dtype)[6:]} {step_name}"
                if set(m) != set(m_ref):
                    raise AssertionError(f"{what}: losses {sorted(m)}")
                for key, v in m_ref.items():
                    worst[k] = max(worst[k], (abs(m[key] - v)
                                              / max(abs(v), 1e-12), key))
                    if abs(m[key] - v) > SPATIAL_TRAIN_BAR * abs(v) + 1e-9:
                        raise AssertionError(f"{what} {key}: {m[key]} "
                                             f"against unsharded {v}")
                if dtype != torch.float64:
                    far = _moment_distance(mu, truth[i], NOISE_FLOOR)
                    bar = SPATIAL_TRAIN_NOISE * max(noise[0], 1e-3)
                    log(f"{what}: the stepped model's first moments against "
                        f"the float64 step's: {far[1]} {far[0]:.4f} of its "
                        f"largest, {far[2]} of {far[3]} leaves beyond 1e-3 "
                        f"(bar {bar:.4f}: {SPATIAL_TRAIN_NOISE:g} x the "
                        f"unsharded f32 step's)")
                    if not far[0] <= bar:
                        raise AssertionError(
                            f"{what}: first moments {far[0]:.4f} of a "
                            f"leaf's largest from the float64 step's, more "
                            f"than {SPATIAL_TRAIN_NOISE:g} x the unsharded "
                            f"f32 step's {noise[0]:.4f}")
                    continue
                other = "D" if net == "G" else "G"
                summary = hold_state(getattr(st, net),
                                     getattr(ref, net).state_dict(), lr, mu,
                                     mu_ref, what=f"{what} {net}")
                hold_state(getattr(st, other),
                           getattr(ref, other).state_dict(),
                           what=f"{what}, the other model {other}")
                log(f"{what} against the unsharded step from the same "
                    f"state: {summary}")
                del st
            del ref
        for k in SPATIAL_TRAIN_SHARDS:
            log(f"13.a {k} shards {str(dtype)[6:]} (640^2, {BATCH} per "
                f"domain): "
                f"{n_losses} losses of g_step and d_step within "
                f"{worst[k][0]:.3e} relative of the unsharded steps' "
                f"({worst[k][1]}; bar {SPATIAL_TRAIN_BAR})" + (
                    "; statistics and u/v within 1e-5"
                    if dtype == torch.float64 else ""))
        log(f"13.a {str(dtype)[6:]}: {time.perf_counter() - t0:.1f} s, "
            f"peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats(dev)
        del first, on
        torch.cuda.empty_cache()
    del builder, truth

    # ---- 13.b bf16: step ms, ranges, launches, peak -----------------------
    t_b = time.perf_counter()
    builder = StepBuilder(load_opts())
    state = builder.init_state(0, dev)
    launched, step_ms = {}, {}

    def step(devices):
        def fn():
            nonlocal state
            state, _ = builder.train_step(state, batch, devices=devices)
        return fn

    # 13.c's masked_blend launches are recorded in the last k's first step
    calls = []

    def record(*args):
        calls.append(args)
        return masked_blend(*args)

    for k in (1, *SPATIAL_TRAIN_SHARDS):
        t0 = time.perf_counter()
        devices = None if k == 1 else [SPATIAL_DEVICE] * k
        if k == SPATIAL_TRAIN_SHARDS[-1]:
            masked_blend_mod.masked_blend = record
        try:
            step(devices)()
        finally:
            masked_blend_mod.masked_blend = masked_blend
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(SPATIAL_TRAIN_TIMED):
            kernels.reset_launches()
            t0 = time.perf_counter()
            step(devices)()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launched[k] = dict(kernels.launches)
        step_ms[k] = statistics.median(times)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        expect = {n: (2 * k if n == "masked_blend" else 0)
                  for n in MAIN_PATH_LAUNCHES}
        if launched[k] != expect:
            raise AssertionError(f"13.b {k} shards: a train step launched "
                                 f"{launched[k]}, expected {expect}")
        line = (f"13.b bf16 train_step {k} shard(s) (640^2, {BATCH} per "
                f"domain): p50 {step_ms[k]:.2f} ms of {SPATIAL_TRAIN_TIMED} "
                f"({', '.join(f'{t:.2f}' for t in times)}; the first step "
                f"{first_ms:.2f}), peak "
                f"{peak:.2f} GiB, launches per step {launched[k]}")
        if k == SPATIAL_TRAIN_SHARDS[0]:
            # one more step with the host's clock at the ranges' edges (no
            # profiler; phase 12.a traces the exchanges on the card)
            host, wall = _spatial_host_ms(torch, step(devices))
            line += (f"; one more step {wall:.2f} ms, exchanges and "
                     f"collectives {host:.2f} ms of host time "
                     f"({100 * host / wall:.1f}%, the host's clock at the "
                     f"ranges' edges)")
        log(line)
    log(f"13.b: {time.perf_counter() - t_b:.1f} s with the state's build")

    # ---- 13.c every masked_blend launch of one sharded step ---------------
    k = SPATIAL_TRAIN_SHARDS[-1]
    if len(calls) != 2 * k:
        raise AssertionError(f"13.c recorded {len(calls)} masked_blend "
                             f"launches, expected {2 * k}")
    e32 = e16 = 0.0
    for xb, fb, mb in calls:
        a32 = (xb.float(), fb.float(), mb.float())
        e = (masked_blend(*a32) - masked_blend_plain(*a32)).abs().max().item()
        if not e <= 1e-6:
            raise AssertionError(f"13.c masked_blend f32 max error {e}")
        e32 = max(e32, e)
        got16, want16 = masked_blend(xb, fb, mb).float(), \
            masked_blend_plain(*a32)
        ulp = 2.0 ** (torch.floor(torch.log2(want16.abs().max())).item() - 7)
        e = (got16 - want16).abs().max().item()
        if not e <= ulp:
            raise AssertionError(f"13.c masked_blend bf16 error {e} > {ulp}")
        e16 = max(e16, e)
    log(f"13.c the {k}-shard bf16 step's {len(calls)} masked_blend launches "
        f"(shards {sorted({tuple(c[0].shape) for c in calls})}) against "
        f"masked_blend_plain on the same inputs: f32 max error {e32:.3e}, "
        f"bf16 {e16:.3e} (within one ulp)")
    del state, builder, calls
    torch.cuda.empty_cache()
    log(f"row-sharded training phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {k: launched[k] for k in SPATIAL_TRAIN_SHARDS},
            "step_ms": step_ms, "masked_blend_err": (e32, e16)}


# phase 13.e: every step option at once on rows
SPATIAL_OPTIONS = {
    "dis": {"p": {"use_local_discriminator": True},
            "m": {"gan_type": "WGAN_gp"}, "s": {"gan_type": "WGAN_gp"}},
    "gen": {"m": {"use_pl4m": True},
            "p": {"diff_aug": {"use": True, "do_color_jittering": True,
                               "do_cutout": True, "do_translation": True}}},
    "train": {"allow_random_vgg": True},
}
REMAT_ON = {"tpu": {"remat": True, "remat_d": True}}
# the tiny step's small_convs area (as tests/test_torch_port_spatial_train
# .py): a 16^2 map over it, a 2-shard window of it under it
TINY_REMAT_AREA = 200
TINY_OPTION_BAR = 1e-6  # the float64 tiny steps' losses, relative


def _option_opts(*overrides):
    from climategan_torch.utils.opts import load_opts, merge

    opts = load_opts()
    for over in overrides:
        merge(over, opts)
    return opts


def _random_vgg(torch, dev, dtype=None):
    """The perceptual loss's VGG under train.allow_random_vgg, as the
    trainer builds it: random weights from torch's seed 0."""
    from climategan_torch.losses import VGG19Features

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        vgg = VGG19Features()
    return vgg.to(device=dev, dtype=dtype)


def option_rows_tiny(torch, dev) -> None:
    """Phase 13.e's pool check and 13.e(a) (see the module docstring): the
    painter D's pool on a channels-last input; every option at once at
    tiny_opts(32)'s sizes in float64 over 2 and 4 shards against the
    unsharded steps."""
    import torch.nn.functional as F

    from climategan_torch import bench_train
    from climategan_torch.models.discriminator import avg_pool_3x3_s2
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.step_check import (
        TINY_OVERRIDES,
        TINY_SIZE,
        hold_state,
    )

    t_phase = time.perf_counter()
    # ---- the painter D's pool on the paste's NHWC-strided output ---------
    # PyTorch's CUDA backward of an overlapping average pool is wrong for a
    # channels-last input (information); the port's pool, which makes its
    # input contiguous, must equal the contiguous input's gradient
    x = torch.rand(2, 3, 32, 32, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    up = torch.rand(2, 3, 16, 16, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    errs = {}
    for name, pool in (("F.avg_pool2d", lambda t: F.avg_pool2d(
            t, 3, 2, 1, count_include_pad=False)),
                       ("avg_pool_3x3_s2", avg_pool_3x3_s2)):
        grads = []
        for t in (x.clone(), x.permute(0, 2, 3, 1).contiguous().permute(
                0, 3, 1, 2)):
            t.requires_grad_(True)
            grads.append(torch.autograd.grad((pool(t) * up).sum(), t)[0])
        errs[name] = (grads[0] - grads[1]).abs().max().item()
        top = grads[0].abs().max().item()
    log(f"13.e the painter D's 3x3/2 average pool, input gradient of a "
        f"channels-last (2, 3, 32, 32) float64 input against a contiguous "
        f"one: PyTorch's F.avg_pool2d {errs['F.avg_pool2d']:.3e}, the "
        f"port's avg_pool_3x3_s2 {errs['avg_pool_3x3_s2']:.3e} (of "
        f"{top:.3e})")
    if not errs["avg_pool_3x3_s2"] <= 1e-12:
        raise AssertionError("13.e the port's pool on a channels-last input")

    # ---- 13.e (a) tiny, float64: every option, remat under small_convs ----
    opts = _option_opts(TINY_OVERRIDES, SPATIAL_OPTIONS, REMAT_ON, {
        "tpu": {"remat_policy": f"small_convs:{TINY_REMAT_AREA}"}})
    builder = StepBuilder(opts, vgg=_random_vgg(torch, dev, torch.float64))
    first = builder.init_state(0, dev)
    first.G, first.D = first.G.double(), first.D.double()
    tiny = {d: {key: v.double() if v.is_floating_point() else v
                for key, v in b.items()}
            for d, b in bench_train.synthetic_batch(2, TINY_SIZE, 32, dev,
                                                    seed=0).items()}
    # a KITTI pretraining batch: domain s items alone
    for what, batch in (("2 per domain", tiny), ("kitti", {"s": tiny["s"]})):
        for i, (net, lr) in enumerate((("G", builder.g_lr),
                                       ("D", builder.d_lr))):
            ref, m_ref, mu_ref = _sharded_job(torch, builder, first, batch,
                                              i, None)
            step_name = ("g_step", "d_step")[i]
            for k in SPATIAL_TRAIN_SHARDS:
                st, m, mu = _sharded_job(torch, builder, first, batch, i,
                                         [SPATIAL_DEVICE] * k)
                name = f"13.e(a) {what}, {k} shards, {step_name}"
                if set(m) != set(m_ref):
                    raise AssertionError(f"{name}: losses {sorted(m)}")
                worst = 0.0
                for key, v in m_ref.items():
                    worst = max(worst, abs(m[key] - v) / max(abs(v), 1e-12))
                    if abs(m[key] - v) > TINY_OPTION_BAR * abs(v) + 1e-12:
                        raise AssertionError(f"{name} {key}: {m[key]} "
                                             f"against unsharded {v}")
                other = "D" if net == "G" else "G"
                summary = hold_state(getattr(st, net),
                                     getattr(ref, net).state_dict(), lr, mu,
                                     mu_ref, what=f"{name} {net}")
                hold_state(getattr(st, other),
                           getattr(ref, other).state_dict(),
                           what=f"{name}, the other model {other}")
                log(f"{name} (tiny float64, every option, remat small_convs:"
                    f"{TINY_REMAT_AREA}): {len(m)} losses within "
                    f"{worst:.2e} relative of the unsharded step's; "
                    f"{summary}")
            del ref
    del builder, first, tiny
    log(f"13.e(a): {time.perf_counter() - t_phase:.1f} s")


def spatial_options_phase(torch, dev) -> dict:
    """Phase 13.e (see the module docstring): every step option at once on
    row shards of the one card. Returns masked_blend's launches per bf16
    train_step by remat and shard count and its largest errors against the
    plain version over a 2-shard step's launches."""
    import statistics

    from climategan_torch import bench_train, kernels
    from climategan_torch.kernels import masked_blend as masked_blend_mod
    from climategan_torch.kernels.masked_blend import (
        masked_blend,
        masked_blend_plain,
    )
    from climategan_torch.train_step import StepBuilder

    t_phase = time.perf_counter()
    # (13.e's pool check and 13.e(a) run in the side process:
    # option_rows_tiny)

    # ---- 13.e (b) full width: f32 losses, bf16 time and peak --------------
    t_b = time.perf_counter()
    batch = bench_train.synthetic_batch(BATCH, SIZE, 160, dev)
    builder = StepBuilder(_option_opts(SPATIAL_OPTIONS, REMAT_ON, {
        "train": {"bf16": False}}), vgg=_random_vgg(torch, dev))
    first = builder.init_state(0, dev)
    losses = {}
    for k in (1, 2):
        devices = None if k == 1 else [SPATIAL_DEVICE] * k
        losses[k] = {}
        for i in (0, 1):
            _, m, _ = _sharded_job(torch, builder, first, batch, i, devices)
            losses[k].update(m)
    if set(losses[2]) != set(losses[1]):
        raise AssertionError(f"13.e(b) f32 losses: {sorted(losses[2])} "
                             f"against {sorted(losses[1])}")
    worst = (0.0, "")
    for key, v in losses[1].items():
        worst = max(worst, (abs(losses[2][key] - v) / max(abs(v), 1e-12),
                            key))
        if abs(losses[2][key] - v) > SPATIAL_TRAIN_BAR * abs(v) + 1e-9:
            raise AssertionError(f"13.e(b) f32 2 shards {key}: "
                                 f"{losses[2][key]} against unsharded {v}")
    log(f"13.e(b) f32 (640^2, {BATCH} per domain, every option, remat and "
        f"remat_d, a random VGG): {len(losses[1])} losses of g_step and "
        f"d_step over 2 shards within {worst[0]:.3e} relative of the "
        f"unsharded steps' ({worst[1]}; bar {SPATIAL_TRAIN_BAR})")
    del builder, first
    torch.cuda.empty_cache()

    vgg = _random_vgg(torch, dev)
    launched, step_ms, peaks, calls = {}, {}, {}, []

    def record(*args):
        # detached: a kept input that requires grad would keep its graph,
        # and a rematerialized step's recomputed activations, alive
        calls.append(tuple(a.detach() for a in args))
        return masked_blend(*args)

    for remat in (False, True):
        builder = StepBuilder(_option_opts(
            SPATIAL_OPTIONS, REMAT_ON if remat else {}), vgg=vgg)
        state = builder.init_state(0, dev)
        for k in (1, 2):
            devices = None if k == 1 else [SPATIAL_DEVICE] * k
            key = (remat, k)
            if key == (True, 2):
                masked_blend_mod.masked_blend = record
            try:
                state, _ = builder.train_step(state, batch, devices=devices)
            finally:
                masked_blend_mod.masked_blend = masked_blend
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            times = []
            for _ in range(SPATIAL_TRAIN_TIMED):
                kernels.reset_launches()
                t0 = time.perf_counter()
                state, metrics = builder.train_step(state, batch,
                                                    devices=devices)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            if not all(torch.isfinite(v).all() for v in metrics.values()):
                raise AssertionError(f"13.e(b) {key}: non-finite losses")
            launched[key] = dict(kernels.launches)
            step_ms[key] = statistics.median(times)
            peaks[key] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            log(f"13.e(b) bf16 train_step, every option, "
                f"{'remat + remat_d' if remat else 'no remat'}, {k} "
                f"shard(s) (640^2, {BATCH} per domain): p50 "
                f"{step_ms[key]:.2f} ms of {SPATIAL_TRAIN_TIMED} ("
                f"{', '.join(f'{t:.2f}' for t in times)}), peak "
                f"{peaks[key]:.2f} GiB, launches per step {launched[key]}")
        del builder, state
        torch.cuda.empty_cache()
    for remat in (False, True):
        one, two = launched[(remat, 1)], launched[(remat, 2)]
        want = {n: 2 * one[n] for n in one}
        if two != want or not one["masked_blend"] or one["spade_cond"]:
            raise AssertionError(f"13.e(b) launches, remat {remat}: 1 shard "
                                 f"{one}, 2 shards {two}")
    if len(calls) != launched[(True, 2)]["masked_blend"]:
        raise AssertionError(f"13.e(b) recorded {len(calls)} masked_blend "
                             f"launches of a 2-shard step")
    e32 = e16 = 0.0
    for xb, fb, mb in calls:
        a32 = (xb.float(), fb.float(), mb.float())
        e = (masked_blend(*a32) - masked_blend_plain(*a32)).abs().max().item()
        if not e <= 1e-6:
            raise AssertionError(f"13.e(b) masked_blend f32 max error {e}")
        e32 = max(e32, e)
        got16, want16 = masked_blend(xb, fb, mb).float(), \
            masked_blend_plain(*a32)
        ulp = 2.0 ** (torch.floor(torch.log2(want16.abs().max())).item() - 7)
        e = (got16 - want16).abs().max().item()
        if not e <= ulp:
            raise AssertionError(f"13.e(b) masked_blend bf16 error {e} > "
                                 f"{ulp}")
        e16 = max(e16, e)
    log(f"13.e(b) the 2-shard remat bf16 step's {len(calls)} masked_blend "
        f"launches (pl4m's and the painter's pastes, each recomputed once; "
        f"shards {sorted({tuple(c[0].shape) for c in calls})}) against "
        f"masked_blend_plain on the same inputs: f32 max error {e32:.3e}, "
        f"bf16 {e16:.3e} (within one ulp)")
    log(f"13.e(b) remat at 2 shards: p50 {step_ms[(True, 2)]:.2f} ms against "
        f"{step_ms[(False, 2)]:.2f} without ("
        f"{step_ms[(True, 2)] / step_ms[(False, 2)]:.2f}x), peak "
        f"{peaks[(True, 2)]:.2f} GiB against {peaks[(False, 2)]:.2f}; "
        f"{time.perf_counter() - t_b:.1f} s")
    del calls, batch, vgg
    torch.cuda.empty_cache()
    log(f"row-sharded options phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launched, "step_ms": step_ms, "peak_gib": peaks,
            "masked_blend_err": (e32, e16)}


# ---------------------------------------------------------------------------
# phase 14: every other generator configuration on row shards
SPATIAL_CONFIGS = {"spade_masker": SPADE_MASKER, **CONFIG_RUNS}
SPATIAL_CONFIG_SHARDS = 2
SPATIAL_CONFIG_TIMED = 1  # timed bf16 train steps per shard count
# groups A, B and C of tests/torch_port_common.py (tests/test_torch_port_
# configs*.py) as overrides of tiny_opts(32)'s sizes
TINY_GROUPS = {
    "A": ["gen.m.use_spade=true", "gen.m.spade.cond_nc=15",
          "gen.m.spade.latent_dim=32", "gen.d.architecture=base",
          "gen.p.use_final_shortcut=true"],
    "B": ["gen.m.use_spade=true", "gen.m.spade.cond_nc=12",
          "gen.m.spade.latent_dim=32", "gen.deeplabv3.backbone=mobilenet",
          "gen.p.no_z=false"],
    "C": ["gen.encoder.architecture=deeplabv2", "gen.s.architecture=deeplabv2",
          "gen.s.use_dada=false", "gen.d.architecture=base",
          "gen.d.classify.enable=true", "gen.d.classify.linspace.min=0.35",
          "gen.d.classify.linspace.max=6.95",
          "gen.d.classify.linspace.buckets=8", "gen.m.use_dada=false",
          "gen.p.spade_param_free_norm=batch"],
}


def config_rows_tiny(torch, dev) -> None:
    """Phase 14.c (see the module docstring): groups A, B and C's tiny
    float64 g_step and d_step over 2 shards against the unsharded steps."""
    from climategan_torch import bench_train
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import (
        TINY_OVERRIDES,
        TINY_SIZE,
        hold_state,
    )

    k = SPATIAL_CONFIG_SHARDS
    t0 = time.perf_counter()
    for group, overrides in TINY_GROUPS.items():
        builder = StepBuilder(load_opts(path=TINY_OVERRIDES,
                                        commandline_opts=overrides))
        first = builder.init_state(0, dev)
        first.G, first.D = first.G.double(), first.D.double()
        buckets = 8 if builder.cfg.d_classify else 0
        batch = {d: {key: v.double() if v.is_floating_point() else v
                     for key, v in b.items()}
                 for d, b in bench_train.synthetic_batch(
                     2, TINY_SIZE, 32, dev, buckets=buckets).items()}
        for i, (net, lr) in enumerate((("G", builder.g_lr),
                                       ("D", builder.d_lr))):
            jobs = []
            for devices in (None, [SPATIAL_DEVICE] * k):
                torch.manual_seed(11)  # DeepLab v2's dropout draws
                jobs.append(_sharded_job(torch, builder, first, batch, i,
                                         devices))
            (ref, m_ref, mu_ref), (st, m, mu) = jobs
            name = f"14.c {group}, {k} shards, {('g_step', 'd_step')[i]}"
            if set(m) != set(m_ref):
                raise AssertionError(f"{name}: losses {sorted(m)}")
            worst = 0.0
            for key, v in m_ref.items():
                worst = max(worst, abs(m[key] - v) / max(abs(v), 1e-12))
                if abs(m[key] - v) > TINY_OPTION_BAR * abs(v) + 1e-12:
                    raise AssertionError(f"{name} {key}: {m[key]} "
                                         f"against unsharded {v}")
            other = "D" if net == "G" else "G"
            summary = hold_state(getattr(st, net),
                                 getattr(ref, net).state_dict(), lr, mu,
                                 mu_ref, what=f"{name} {net}")
            hold_state(getattr(st, other),
                       getattr(ref, other).state_dict(),
                       what=f"{name}, the other model {other}")
            log(f"{name} (tiny float64): {len(m)} losses within "
                f"{worst:.2e} relative of the unsharded step's; "
                f"{summary}")
            del jobs, ref, st
        del builder, first, batch
    log(f"14.c: {time.perf_counter() - t0:.1f} s")


def mask_norm_steps(torch, dev) -> None:
    """Phase 14.f: the layer-norm and PReLU mask decoder's full-width bf16
    train_step (640^2, BATCH per domain) unsharded, in turns with the
    default configuration's, then over SPATIAL_CONFIG_SHARDS shards:
    finite losses, launches masked_blend 2 k and nothing else, every
    gamma, beta and alpha of the mask decoder moved by the unsharded
    steps and again by the sharded ones (ExtraAdam's second step of a pair
    may put a value back where the pair began); p50 ms and peak memory
    (information)."""
    import statistics

    from climategan_torch import bench_train, kernels
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts

    t0 = time.perf_counter()
    k = SPATIAL_CONFIG_SHARDS
    batch = bench_train.synthetic_batch(BATCH, SIZE, 160, dev)
    builders = {name: StepBuilder(load_opts(commandline_opts=overrides))
                for name, overrides in (("default", []),
                                        ("mask_layer_prelu",
                                         MASK_LAYER_PRELU))}
    states = {name: b.init_state(0, dev) for name, b in builders.items()}

    def norm_values():
        return {n: p.detach().clone() for n, p in
                states["mask_layer_prelu"].G.decoders["m"].named_parameters()
                if n.endswith((".gamma", ".beta", ".activation.weight"))}

    def unmoved(before):
        return [n for n, v in norm_values().items()
                if torch.equal(v, before[n])]

    first = norm_values()
    # a layer norm in every Conv2dBlock but the output conv, a PReLU in
    # every one but the output conv and each ResBlock's second
    c = states["mask_layer_prelu"].G.cfg
    blocks = 3 + 2 * c.m_n_res + c.m_n_upsample
    if len(first) != 2 * blocks + blocks - c.m_n_res:
        raise AssertionError(f"14.f mask decoder: {sorted(first)}")

    def step(name, devices=None) -> float:
        """One train_step of ``name`` with its checks; its ms."""
        kernels.reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        states[name], metrics = builders[name].train_step(
            states[name], batch, devices=devices)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        shards = len(devices or [dev])
        want = {n: (2 * shards if n == "masked_blend" else 0)
                for n in MAIN_PATH_LAUNCHES}
        if dict(kernels.launches) != want:
            raise AssertionError(f"14.f {name}, {shards} shard(s): "
                                 f"launches {dict(kernels.launches)}")
        if not all(torch.isfinite(v).all() for v in metrics.values()):
            raise AssertionError(f"14.f {name}: non-finite losses")
        return ms

    for name in states:
        step(name)  # each model's first step
    torch.cuda.reset_peak_memory_stats(dev)
    turns = [{name: step(name) for name in states} for _ in range(TURNS)]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if unmoved(first):
        raise AssertionError(f"14.f: {unmoved(first)} unmoved")
    p50 = {name: statistics.median(t[name] for t in turns) for name in states}
    log(f"14.f mask_layer_prelu bf16 train_step ({SIZE}^2, {BATCH} per "
        f"domain), {TURNS} in turns with the default's: p50 "
        f"{p50['mask_layer_prelu']:.2f} ms against the default's "
        f"{p50['default']:.2f} (" + "; ".join(
            f"{t['default']:.2f}, {t['mask_layer_prelu']:.2f}"
            for t in turns) + f"); peak {peak:.2f} GiB with both states; "
        f"finite losses; all {len(first)} gamma, beta and alpha moved")
    del states["default"], builders["default"]
    torch.cuda.empty_cache()
    devices = [SPATIAL_DEVICE] * k
    before = norm_values()
    step("mask_layer_prelu", devices)  # the first sharded step
    torch.cuda.reset_peak_memory_stats(dev)
    ms = step("mask_layer_prelu", devices)
    if unmoved(before):
        raise AssertionError(f"14.f, {k} shards: {unmoved(before)} unmoved")
    log(f"14.f mask_layer_prelu bf16 train_step over {k} shards: {ms:.2f} "
        f"ms, peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} "
        f"GiB, finite losses, every gamma, beta and alpha moved over its "
        f"two steps; {time.perf_counter() - t0:.1f} s")
    del states, builders, batch
    torch.cuda.empty_cache()


def _config_launches(name: str, k: int) -> dict:
    """Each kernel's launches in a k-shard forward of configuration
    ``name`` with all three events."""
    spade = 18 + (MASK_DECODER_CALLS if name == "spade_masker" else 0)
    return {n: (spade * k if n == "spade_cond" else k)
            for n in MAIN_PATH_LAUNCHES}


def spatial_configs_phase(torch, dev) -> dict:
    """Phase 14 (see the module docstring): the seven other generator
    configurations on row shards of the one card. Returns each kernel's
    launches per 2-shard forward by configuration."""
    import statistics
    import tempfile

    import numpy as np
    import yaml

    from climategan_torch import apply_events as cli
    from climategan_torch import bench, bench_train, kernels
    from climategan_torch.inference import build_spatial_infer_fn
    from climategan_torch.models import norms as norms_mod
    from climategan_torch.models.generator import create_generator
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand(BATCH, SIZE, SIZE, 3, device=dev, generator=g) * 2 - 1
    uniform = torch.rand(9, 9, device=dev, generator=g)
    g_dev = torch.tensor(G_VALUE, device=dev)
    k = SPATIAL_CONFIG_SHARDS

    # ---- 14.a f32, each configuration over 2 shards against unsharded ----
    launched = {}
    for name, overrides in SPATIAL_CONFIGS.items():
        opts = load_opts(commandline_opts=overrides)
        G, infer = build_spatial_infer_fn(opts, [SPATIAL_DEVICE] * k,
                                          dtype=torch.float32, seed=0)
        z = G.sample_painter_z(BATCH, SIZE, SIZE, torch.float32, dev,
                               torch.Generator(device=dev).manual_seed(4))

        def call(fn):
            return fn(x, uniform=uniform, g_value=g_dev, z=z)

        times, outs = {}, {}
        for what, fn in (("unsharded", infer.unsharded), ("sharded", infer)):
            call(fn)  # a first call, then the counted and timed one
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            outs[what] = call(fn)
            torch.cuda.synchronize()
            times[what] = (time.perf_counter() - t0) * 1e3
        launched[name] = dict(kernels.launches)
        want, got = outs["unsharded"], outs["sharded"]
        if launched[name] != _config_launches(name, k):
            raise AssertionError(f"14.a {name}: launches {launched[name]}, "
                                 f"expected {_config_launches(name, k)}")
        agree = {}
        for key in ("flood", "wildfire", "smog"):
            agree[key] = lsb_agreement(got[key], want[key])
            if not agree[key][0] >= 0.999:
                raise AssertionError(f"14.a {name}: {key} disagrees "
                                     f"{agree[key]}")
        mask_err = (got["mask"] - want["mask"]).abs().max().item()
        if not mask_err <= SPATIAL_MASK_BAR:
            raise AssertionError(f"14.a {name}: mask error {mask_err}")
        log(f"14.a {name}, {k} shards f32 (640^2 batch {BATCH}): "
            + ", ".join(f"{key} within 1 LSB on {100 * a:.4f}% (max {m} LSB)"
                        for key, (a, m) in agree.items())
            + f"; mask max error {mask_err:.3e} (bar {SPATIAL_MASK_BAR}); "
            f"launches {launched[name]}; {times['sharded']:.2f} ms per batch "
            f"against {times['unsharded']:.2f} unsharded")
        del G, infer, outs, want, got
        torch.cuda.empty_cache()
    log(f"14.a: {time.perf_counter() - t_phase:.1f} s")

    # ---- 14.b bf16: the SPADE masker's spade_cond windows over 4 shards ---
    t0 = time.perf_counter()
    _, infer16 = build_spatial_infer_fn(load_opts(commandline_opts=SPADE_MASKER),
                                        [SPATIAL_DEVICE] * 4,
                                        dtype=torch.bfloat16, seed=0)
    windows = []
    kernel = norms_mod.spade_cond_packed

    def record(seg, pack):
        windows.append((seg, pack))
        return kernel(seg, pack)

    norms_mod.spade_cond_packed = record
    try:
        infer16(x, uniform=uniform, g_value=g_dev)
    finally:
        norms_mod.spade_cond_packed = kernel
    torch.cuda.synchronize()
    del infer16
    wide = [w for w in windows if w[0].shape[3] == 15]
    if len(windows) != _config_launches("spade_masker", 4)["spade_cond"] \
            or len(wide) != 4 * MASK_DECODER_CALLS:
        raise AssertionError(f"14.b recorded {len(windows)} windows, "
                             f"{len(wide)} at cnc 15")
    e32, e16 = _hold_windows(torch, windows, "14.b")
    log(f"14.b the SPADE masker's 4-shard bf16 forward: {len(windows)} "
        f"spade_cond windows ({len(wide)} at cnc 15, heights "
        f"{sorted({s.shape[1] for s, _ in wide})}) against spade_cond_plain: "
        f"f32 max error {e32:.3e}, bf16 {e16:.3e} (within one ulp); "
        f"{time.perf_counter() - t0:.1f} s")
    del windows, wide
    torch.cuda.empty_cache()

    with torch.inference_mode(False), torch.enable_grad():
        # (14.c runs in the side process: config_rows_tiny)

        # ---- 14.d full-width bf16 train steps, 2 shards beside 1 ---------
        t0 = time.perf_counter()
        batch = bench_train.synthetic_batch(BATCH, SIZE, 160, dev)
        step_ms, peaks = {}, {}
        for name in ("spade_masker", "deeplabv2"):
            builder = StepBuilder(load_opts(
                commandline_opts=SPATIAL_CONFIGS[name]))
            state = builder.init_state(0, dev)
            for shards in (1, k):
                devices = None if shards == 1 else [SPATIAL_DEVICE] * shards
                state, _ = builder.train_step(state, batch, devices=devices)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                times = []
                for _ in range(SPATIAL_CONFIG_TIMED):
                    kernels.reset_launches()
                    t1 = time.perf_counter()
                    state, metrics = builder.train_step(state, batch,
                                                        devices=devices)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t1) * 1e3)
                if not all(torch.isfinite(v).all() for v in metrics.values()):
                    raise AssertionError(f"14.d {name}: non-finite losses")
                counted = dict(kernels.launches)
                want = {n: (2 * shards if n == "masked_blend" else 0)
                        for n in MAIN_PATH_LAUNCHES}
                if counted != want:
                    raise AssertionError(f"14.d {name}, {shards} shards: "
                                         f"launches {counted}, not {want}")
                step_ms[(name, shards)] = statistics.median(times)
                peaks[(name, shards)] = \
                    torch.cuda.max_memory_allocated(dev) / 2 ** 30
                log(f"14.d {name} bf16 train_step, {shards} shard(s) (640^2, "
                    f"{BATCH} per domain): p50 {step_ms[(name, shards)]:.2f} "
                    f"ms of {SPATIAL_CONFIG_TIMED} ("
                    + ", ".join(f"{t:.2f}" for t in times) + f"), peak "
                    f"{peaks[(name, shards)]:.2f} GiB, launches {counted}")
            del builder, state, metrics
            torch.cuda.empty_cache()
        del batch
        log(f"14.d: {time.perf_counter() - t0:.1f} s")

    # ---- 14.e apply_events --spatial and bench --spatial --stage masker ---
    t0 = time.perf_counter()
    opts = load_opts(commandline_opts=CONFIG_RUNS["classification"])
    tmp = tempfile.TemporaryDirectory()
    run_dir = Path(tmp.name) / "run"
    (run_dir / "checkpoints").mkdir(parents=True)
    with (run_dir / "opts.yaml").open("w") as f:
        yaml.safe_dump(json.loads(json.dumps(opts)), f)
    torch.save({"G": create_generator(opts, seed=0).state_dict()},
               run_dir / "checkpoints" / "latest_ckpt.pth")
    rng = np.random.default_rng(6)  # phase 6's photos
    photos = [(f"photo_{i}", rng.integers(0, 256, shape, np.uint8))
              for i, shape in enumerate([(720, 1280, 3)] * 4
                                        + [(1280, 960, 3)] * 3)]
    rendered = {}
    for what, flags, devices in (("one", [], None),
                                 ("spatial", ["--spatial"],
                                  [SPATIAL_DEVICE] * k)):
        args = cli.parse_args(["-i", ".", "-b", str(BATCH), "-r",
                               str(run_dir), *flags])
        imgs = {}
        infer = cli.load_model(args, devices)
        kernels.reset_launches()
        n_batches = cli.render(
            photos, args, lambda n, e, img: imgs.__setitem__((n, e),
                                                             img.copy()),
            infer=infer)
        torch.cuda.synchronize()
        expect = {n: n_batches * v for n, v in _config_launches(
            "classification", k if flags else 1).items()}
        if dict(kernels.launches) != expect:
            raise AssertionError(f"14.e render {flags}: launches "
                                 f"{dict(kernels.launches)}, expected "
                                 f"{expect}")
        rendered[what] = imgs
        del infer
    tmp.cleanup()
    if rendered["spatial"].keys() != rendered["one"].keys() \
            or len(rendered["one"]) != 3 * len(photos):
        raise AssertionError("14.e apply_events --spatial wrote other images")
    diffs = [np.abs(rendered["spatial"][key].astype(int) - v.astype(int))
             for key, v in rendered["one"].items()]
    within = float(np.mean([np.mean(d <= 1) for d in diffs]))
    log(f"14.e apply_events --spatial -r <run dir of depth classification> "
        f"on ['cuda:0'] * {k} (f32, {len(photos)} photos, -b {BATCH}): "
        f"{len(diffs)} PNGs within 1 LSB of the unsharded serve on "
        f"{100 * within:.4f}% of values (max "
        f"{max(int(d.max()) for d in diffs)} LSB)")
    if not within >= 0.999:
        raise AssertionError("14.e apply_events --spatial disagrees")
    argv = ["--spatial", "--stage", "masker", "--batch", str(BATCH),
            "--iters", "3", "--warmup", "1", *SPADE_MASKER]
    line = bench.run_bench(bench.parse_args(argv),
                           devices=[SPATIAL_DEVICE] * k)
    torch.cuda.empty_cache()
    if not (line["value"] > 0 and line["mfu"] <= 1.05 and line["sp"] == k
            and line["stage"] == "masker"):
        raise AssertionError(f"14.e bench {argv}: {line}")
    log(f"14.e bench {' '.join(argv)} on {[SPATIAL_DEVICE] * k} (one card: "
        f"no scaling): {json.dumps(line)}")
    log(f"14.e: {time.perf_counter() - t0:.1f} s")
    with torch.inference_mode(False), torch.enable_grad():
        mask_norm_steps(torch, dev)
    log(f"row-sharded configurations phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# the side process: the checks that hold the card to a reference and time
# nothing, in a process of their own beside phases 9-11
SIDE_TIMEOUT = 900  # seconds the side process may take, its start included


def side_main(path: str, threads: int) -> None:
    """The side process (``python -c``, started by ``_start_side``): phase
    9's card against the CPU (``config_cpu_checks``), 13.e's pool check and
    13.e(a) (``option_rows_tiny``) and 14.c (``config_rows_tiny``): bars
    that what runs beside them on the card cannot move (1 LSB, float64),
    each in the grad mode it has in its phase, on the parent's number of
    torch threads (so that the CPU's f32 results are the parent's) with
    TF32 off; writes its log lines to ``path`` (JSON). A failed check
    exits non-zero."""
    global _SINK
    import torch

    _SINK = []
    torch.set_num_threads(threads)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    for fn, grad in ((config_cpu_checks, False), (option_rows_tiny, True),
                     (config_rows_tiny, True)):
        with torch.inference_mode(not grad), torch.set_grad_enabled(grad):
            fn(torch, dev)
    torch.cuda.synchronize()
    Path(path).write_text(json.dumps(_SINK))


def _start_side(torch):
    """Start ``side_main`` in a process of its own from a thread of this
    process; returns a function that waits for it and returns its log
    lines."""
    import tempfile

    threads = torch.get_num_threads()

    def call() -> list:
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "side.json"
            proc = subprocess.run(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke."
                 f"side_main({str(out)!r}, {threads})"], cwd=ROOT,
                capture_output=True, text=True, timeout=SIDE_TIMEOUT)
            if proc.returncode != 0:
                raise AssertionError(
                    f"the side process failed (rc {proc.returncode}):\n"
                    f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
            return json.loads(out.read_text())

    return _in_thread("the side process on cuda:0", call)


# ---------------------------------------------------------------------------
# phase 15: the profiler, the launcher (in phase 8.1), compare_maskers and
# the batch-norm fold
PROFILE_ITERS = 2
TRAIN_PROFILE_SIZE = 256
STAGE_SUM_BAR = 0.01  # the stages' sum against the profiler's device total
MASKER_STAGES = ("masker/encoder", "masker/seg_decoder",
                 "masker/depth_decoder", "masker/mask_decoder")
FOLD_BAR = 1e-5  # the folded f32 forward against the unfolded, relative


def check_profile(res, what) -> None:
    """The stages sum to the profiler's device total within STAGE_SUM_BAR
    and the masker's four stages and a painter stage are nonzero."""
    total, attributed = res["total_ms"], res["attributed_ms"]
    if not abs(attributed - total) <= STAGE_SUM_BAR * total:
        raise AssertionError(f"{what}: the stages sum to {attributed} ms of "
                             f"the device's {total} ms: {res['stages_ms']}")
    stages = res["stages_ms"]
    zero = [st for st in MASKER_STAGES if not stages.get(st, 0.0) > 0]
    if zero or not any(v > 0 for k, v in stages.items()
                       if k.startswith("painter/")):
        raise AssertionError(f"{what}: stages {zero} or every painter "
                             f"stage without device time: {stages}")
    log(f"{what}: {total:.3f} ms of device time per iteration, the stages "
        f"sum to {attributed:.3f} ms; " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(stages.items(),
                                              key=lambda kv: -kv[1])))


def profiler_checks(torch, out: Path) -> None:
    """15.a (see the module docstring)."""
    from climategan_torch import profile_inference as prof

    t0 = time.perf_counter()
    res = prof.run(prof.parse_args([
        "--batch", str(BATCH), "--size", str(SIZE), "--events", "all",
        "--iters", str(PROFILE_ITERS), "--top", "10", "--out",
        str(out / "infer")]))
    check_profile(res, f"15.a profile_inference {SIZE}^2 bf16 batch {BATCH}")
    spade = [stage for name, stage, _ in res["rows"] if "spade_cond" in name]
    if len(spade) != MAIN_PATH_LAUNCHES["spade_cond"] * PROFILE_ITERS or \
            not all(st.startswith("painter/") for st in spade):
        raise AssertionError(f"15.a spade_cond kernels in the trace: "
                             f"{collections.Counter(spade)}")
    if res["launches"] != MAIN_PATH_LAUNCHES:
        raise AssertionError(f"15.a launches per iteration {res['launches']}")
    log(f"15.a every spade_cond kernel of the trace ({len(spade)}) in a "
        f"painter stage; launches per iteration {res['launches']}; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = prof.run(prof.parse_args([
        "--train", "--batch", "1", "--size", str(TRAIN_PROFILE_SIZE),
        "--iters", "1", "--top", "10", "--out", str(out / "train")]))
    check_profile(res, f"15.a profile_inference --train "
                       f"{TRAIN_PROFILE_SIZE}^2 batch 1")
    log(f"15.a --train: {time.perf_counter() - t0:.1f} s")


def compare_checks(torch, root: Path, lists) -> None:
    """15.c (see the module docstring)."""
    import os

    import cv2
    import numpy as np

    from climategan_torch import compare_maskers

    t0 = time.perf_counter()
    work = root / "compare"
    (work / "imgs").mkdir(parents=True)
    (work / "labels").mkdir()
    samples = json.loads(Path(lists["val"]["r"]).read_text())
    for e in samples:  # the masks as must (1) / cannot (0) labels
        name = Path(e["x"]).name
        os.symlink(e["x"], work / "imgs" / name)
        cv2.imwrite(str(work / "labels" / name),
                    (cv2.imread(e["m"], cv2.IMREAD_GRAYSCALE) > 127
                     ).astype(np.uint8))
    runs = [root / "run", root / EPOCH0_RUN]
    with contextlib.redirect_stdout(io.StringIO()):
        res = compare_maskers.compare(compare_maskers.parse_args(
            ["-i", str(work / "imgs"), "-r", *map(str, runs), "-l",
             str(work / "labels"), "-o", str(work / "out")]))
    panels = [cv2.imread(str(p)) for p in res["panels"]]
    shapes = {None if p is None else p.shape for p in panels}
    want = (SIZE, SIZE * (1 + len(runs)), 3)
    metrics = json.loads((work / "out" / "metrics.json").read_text())
    if len(panels) != len(samples) or shapes != {want}:
        raise AssertionError(f"15.c panels: {len(panels)} of shapes {shapes}")
    if sorted(metrics) != sorted(r.name for r in runs) or not all(
            np.isfinite(v) for m in metrics.values() for v in m.values()):
        raise AssertionError(f"15.c metrics.json: {metrics}")
    if res["device"] != "cuda":
        raise AssertionError(f"15.c ran on {res['device']}")
    log(f"15.c compare_maskers on {res['device']}: {len(panels)} panels "
        f"{want}, metrics " + "; ".join(
            f"{k}: " + ", ".join(f"{n} {v:.4f}" for n, v in m.items())
            for k, m in metrics.items())
        + f"; {time.perf_counter() - t0:.1f} s")


def fold_checks(torch, G32) -> None:
    """15.d (see the module docstring)."""
    import copy

    from climategan_torch.models.norms import BatchNorm2d
    from climategan_torch.utils.bn_fold import fold_generator_bns, folded_blocks

    t0 = time.perf_counter()
    G = copy.deepcopy(G32).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(15)
    for m in G.modules():  # trained-like statistics and affine
        if isinstance(m, BatchNorm2d):
            c = m.num_features
            m.running_mean.copy_(torch.randn(c, device="cuda", generator=g) * 0.1)
            m.running_var.copy_(torch.rand(c, device="cuda", generator=g) + 0.5)
            m.weight.copy_(torch.rand(c, device="cuda", generator=g) * 0.4 + 0.8)
            m.bias.copy_(torch.randn(c, device="cuda", generator=g) * 0.1)
    x = torch.rand(1, 3, SIZE, SIZE, device="cuda", generator=g) * 2 - 1
    want = G.infer_masker(x)
    n = len(folded_blocks(G))
    got = fold_generator_bns(G).infer_masker(x)
    errs = [((a - b).abs().max() / b.abs().max().clamp(min=1)).item()
            for a, b in zip(got, want)]
    if not max(errs) <= FOLD_BAR:
        raise AssertionError(f"15.d folded forward: errors {errs}")
    log(f"15.d fold_generator_bns ({n} conv + batch-norm blocks) f32 "
        f"{SIZE}^2: depth, seg, mask within {', '.join(f'{e:.2e}' for e in errs)} "
        f"of the unfolded forward; {time.perf_counter() - t0:.1f} s")
    del G


def adain_resize_checks(torch) -> None:
    """15.e (see the module docstring)."""
    from climategan_torch.models.norms import AdaptiveInstanceNorm
    from climategan_torch.ops.interpolate import resize_like
    from climategan_torch.parallel import spatial

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(16)
    x = torch.randn(BATCH, 64, SIZE, SIZE, generator=g) * 3 + 1
    w = torch.rand(64, generator=g) + 0.5
    b = torch.randn(64, generator=g) * 0.5
    xd, wd, bd = (t.to("cuda") for t in (x, w, b))
    norm = AdaptiveInstanceNorm()
    want = norm(xd, wd, bd)
    errs = {"f32 card vs cpu": (want.cpu() - norm(x, w, b)).abs().max().item(),
            "2 shards vs card": (norm.forward_rows(
                spatial.shard_rows(xd, ["cuda", "cuda"]), wd, bd)
                .gather("cuda") - want).abs().max().item()}
    if not max(errs.values()) <= 1e-5:
        raise AssertionError(f"15.e AdaptiveInstanceNorm: {errs}")
    x16, w16, b16 = (t.bfloat16() for t in (xd, wd, bd))
    got, ref = norm(x16, w16, b16), norm(x16.float(), w16.float(), b16.float())
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    ulps = ((got.float() - ref).abs() / ulp).max().item()
    if got.dtype != torch.bfloat16 or not ulps <= 1.0:
        raise AssertionError(f"15.e AdaIN bf16: {ulps} ulp, {got.dtype}")
    del want, got, ref, x16
    ref_map = torch.zeros(1, 3, 480, 853, device="cuda")
    for mode in ("nearest", "bilinear"):
        want = resize_like(xd, ref_map, mode)
        cpu = (want.cpu() - resize_like(x, ref_map.cpu(), mode)).abs().max()
        rows = (resize_like(spatial.shard_rows(xd, ["cuda", "cuda"]),
                            ref_map, mode).gather("cuda") - want).abs().max()
        errs[f"resize_like {mode} card vs cpu"] = cpu.item()
        errs[f"resize_like {mode} 2 shards vs card"] = rows.item()
        if want.shape[-2:] != (480, 853) or not max(cpu, rows) <= (
                0.0 if mode == "nearest" else 1e-5):
            raise AssertionError(f"15.e resize_like {mode}: {errs}")
    log(f"15.e AdaptiveInstanceNorm and resize_like at {SIZE}^2 batch "
        f"{BATCH}, 64 channels: " + ", ".join(f"{k} {v:.2e}"
                                               for k, v in errs.items())
        + f", bf16 {ulps:.3f} ulp; {time.perf_counter() - t0:.1f} s")


def tools_phase(torch, dev, root: Path, lists, G32) -> None:
    """Phase 15 (see the module docstring); 15.b ran in phase 8.1."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        profiler_checks(torch, Path(out))
    compare_checks(torch, root, lists)
    fold_checks(torch, G32)
    adain_resize_checks(torch)
    torch.cuda.empty_cache()
    log(f"tools phase: {time.perf_counter() - t_phase:.1f} s")


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
    # nvcc's processes in a thread, Triton's first compile beside them
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(_build.build_all)
        z = torch.zeros(1, 1, 1, 3, device=dev)
        masked_blend(z, z, z[..., :1])
        torch.cuda.synchronize()
        t_triton = time.perf_counter() - t0
        logs = building.result()
    log(f"nvcc build: {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")
    log(f"triton build (first launch, beside nvcc): {t_triton:.2f} s")

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
    G32 = Gw  # the CPU's f32 model: phase 15.d folds a copy on the card
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
    def phase_9():
        with torch.inference_mode():
            return configs_phase(torch, dev, x, uniform, infer,
                                 calls["spade_cond"])

    with torch.inference_mode(False), torch.enable_grad():
        train_launches = training_phase(torch, dev)
        # phase 9 runs while phase 8's first trainer run trains in its own
        # process
        trainer_launches, data_dir, lists, configs = trainer_phase(
            torch, dev, beside=phase_9)
    # the f32 card-against-CPU step holds (9.5 here, then 10.1) run with
    # nothing else on the card
    spade_step_tiny(torch, dev)
    with torch.inference_mode(False), torch.enable_grad():
        # the checks that time nothing run beside phases 10.2-11
        # (side_main), started once 10.1's f32 holds are done; their lines
        # come before phase 12's
        sides = []
        options = step_options_phase(
            torch, dev, lists, lambda: sides.append(_start_side(torch)))
        ddp_launches = parallel_phase(torch, dev,
                                      Path(data_dir.name) / "run")
    lines = sides[0]()
    log("the side process's checks (phase 9's card against the CPU, 13.e's "
        "pool and 13.e(a), 14.c):")
    for line in lines:
        log(line)
    spatial_launches = spatial_phase(torch, dev)
    with torch.inference_mode(False), torch.enable_grad():
        spatial_train = spatial_train_phase(torch, dev)
        spatial_options = spatial_options_phase(torch, dev)
    spatial_configs = spatial_configs_phase(torch, dev)
    tools_phase(torch, dev, Path(data_dir.name), lists, G32)
    data_dir.cleanup()
    for r in rows:
        r["train_launches"] = train_launches[r["name"]]
        r["ddp_train_launches"] = ddp_launches[r["name"]]
        r["trainer_launches"] = trainer_launches[r["name"]]
        r["launches_by_path"] = {"default": r["launches"], **{
            path: n[r["name"]] for path, n in configs["paths"].items()}}
        r["spatial_launches"] = {f"{k} shards": n[r["name"]]
                                 for k, n in spatial_launches.items()}
        r["spatial_train_launches"] = {
            f"{k} shards": n[r["name"]]
            for k, n in spatial_train["launches"].items()}
        r["spatial_option_train_launches"] = {
            f"{'remat, ' if remat else ''}{k} shard{'s' if k > 1 else ''}":
                n[r["name"]]
            for (remat, k), n in spatial_options["launches"].items()}
        r["spatial_config_launches"] = {
            f"{name}, {SPATIAL_CONFIG_SHARDS} shards": n[r["name"]]
            for name, n in spatial_configs.items()}
        if r["name"] == "spade_cond":
            r["spade_masker"] = configs["spade_cond"]
        r["step_option_launches"] = {
            "pl4m_train_step": options["pl4m_step"][r["name"]],
            "grad_accumulation_2_train_step":
                options["grad_accumulation_step"][r["name"]],
            **{f"compute_val_fid ({what})": n[r["name"]]
               for what, n in options["fid"].items()}}

    log(smi())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
