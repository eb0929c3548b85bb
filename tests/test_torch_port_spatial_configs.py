"""Row sharding of every generator configuration against the port's
unsharded forwards and steps, on the CPU with shards on ``["cpu"] * k``;
no JAX (tests/test_torch_port_configs_infer.py holds the 2-shard
``build_spatial_infer_fn`` of groups A, B and C to the JAX package's).

- the three primitives the other configurations add: a grouped conv at
  MobileNetV2's strides and dilations, the DeepLab v2 stem's ceil-mode max
  pool on odd and even heights, the whole-map mean of the v2 image-pool
  branch; values and gradients;
- DeepLab v2's dropout on rows (one mask for the whole map, sliced) and
  its ASPP's pooled branch run once per image in train mode;
- each of the seven configurations of chip_smoke.py (the SPADE masker,
  MobileNetV2, DeepLab v2, depth classification, the painter with z, the
  final shortcut, batch-norm SPADEs) through ``build_spatial_infer_fn``
  over 2 and 3 shards and ``build_hybrid_infer_fn`` over 2 x 2 against
  the plain forward;
- groups A, B and C of tests/torch_port_common.py: ``g_step`` and
  ``d_step`` over 2 shards against the unsharded steps, in float64;
- the bench's masker and painter stages under ``--spatial`` and
  ``--hybrid``.

Bars: as tests/test_torch_port_spatial.py (the JAX package's 1 uint8 LSB
on >= 99.9% of event values, 1e-5 for the f32 mask; float64 primitives
within 1e-12, selections exact) and tests/test_torch_port_spatial_train.py
(float64 steps: every loss within 1e-6 relative, the models held by
``step_check.hold_state``).
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch import bench, bench_train
from climategan_torch.inference import (
    build_hybrid_infer_fn,
    build_infer_fn,
    build_spatial_infer_fn,
)
from climategan_torch.models.deeplab_v2 import ASPPV2, dropout
from climategan_torch.models.discriminator import create_discriminator
from climategan_torch.models.generator import create_generator
from climategan_torch.models.norms import init_weights
from climategan_torch.parallel import spatial
from climategan_torch.train_step import StepBuilder
from climategan_torch.utils.opts import load_opts, merge
from climategan_torch.utils.step_check import (
    TINY_OVERRIDES,
    first_moments,
    hold_state,
)
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    CONFIGS,
    one_thread,
    port_tiny_opts,
)

CPUS = {k: ["cpu"] * k for k in (2, 3, 4)}
# the seven configurations of chip_smoke.py's phases 9 and 14 (the SPADE
# masker's latent cut to 32 at this size)
SEVEN = {
    "spade_masker": {"gen": {"m": {"use_spade": True,
                                   "spade": {"latent_dim": 32}}}},
    "mobilenet": {"gen": {"deeplabv3": {"backbone": "mobilenet"}}},
    "deeplabv2": {"gen": {"encoder": {"architecture": "deeplabv2"},
                          "s": {"architecture": "deeplabv2"}}},
    "classification": {"gen": {"d": {"architecture": "base",
                                     "classify": {"enable": True}},
                               "m": {"use_dada": False},
                               "s": {"use_dada": False}}},
    "painter_z": {"gen": {"p": {"no_z": False}}},
    "final_shortcut": {"gen": {"p": {"use_final_shortcut": True}}},
    "batch_spade": {"gen": {"p": {"spade_param_free_norm": "batch"}}},
}


def _rand(*shape, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g, dtype=torch.float64) * 2 - 1
            ).to(dtype)


def _check(fn, x, k, params=()):
    """``fn`` of x and of its rows over k shards: the outputs (gathered)
    within 1e-12 and the gradients of a random projection of them with
    respect to x and ``params``."""
    leaf = x.clone().requires_grad_(True)

    def run(rows):
        out = fn(spatial.split_rows(leaf, CPUS[k]) if rows else leaf)
        out = out.gather("cpu") if isinstance(out, spatial.Rows) else out
        obj = (out * _rand(*out.shape, seed=9)).sum()
        return out.detach(), torch.autograd.grad(obj, [leaf, *params])

    (want, want_g), (got, got_g) = run(False), run(True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


# ---- the primitives --------------------------------------------------------

def test_grouped_conv_at_mobilenet_strides_and_dilations():
    """MobileNetV2's depthwise 3x3 convs (groups = channels; stride 1 and
    2, dilation 1 and 2 with padding = dilation) and a two-group conv, on
    maps of 2-40 rows over 2, 3 and 4 shards, with their gradients."""
    for groups, cin in ((6, 6), (2, 4)):
        for s, d in ((1, 1), (2, 1), (1, 2)):
            torch.manual_seed(s + d)
            conv = nn.Conv2d(cin, 6, 3, s, d, d, groups, bias=False).double()
            for h in (2, 5, 13, 40):
                x = _rand(2, cin, h, 7, seed=h)
                for k in (2, 3, 4):
                    _check(lambda t: spatial.conv2d(t, conv)
                           if isinstance(t, spatial.Rows) else conv(t),
                           x, k, [conv.weight])


def test_ceil_max_pool_on_odd_and_even_heights():
    """The DeepLab v2 stem's F.max_pool2d(3, 2, 0, ceil_mode=True): its
    last window runs past the bottom on even heights (and the right edge
    on even widths); -inf rows stand for the overhang. Exact, with the
    gradient."""
    for h in (3, 4, 5, 6, 13, 14, 40, 81):
        for w in (7, 8):
            x = _rand(2, 3, h, w, seed=h)
            want = F.max_pool2d(x, 3, 2, 0, ceil_mode=True)
            assert spatial.pool_rows(h, 3, 2, 0, True) == want.shape[2]
            for k in (2, 3, 4):
                got = spatial.max_pool2d(spatial.shard_rows(x, CPUS[k]), 3, 2,
                                         0, ceil_mode=True)
                assert torch.equal(got.gather("cpu"), want), (h, w, k)
                _check(lambda t: spatial.max_pool2d(t, 3, 2, 0, True)
                       if isinstance(t, spatial.Rows)
                       else F.max_pool2d(t, 3, 2, 0, ceil_mode=True), x, k)


def test_whole_map_mean():
    """The per-image, per-channel mean over every shard (the v2 ASPP's
    image pool) against nn.AdaptiveAvgPool2d(1), with the gradient to
    every shard; maps whose 3- and 4-shard splits leave shards empty."""
    pool = nn.AdaptiveAvgPool2d(1)
    for h in (2, 5, 40):
        x = _rand(2, 4, h, 6, seed=h)
        for k in (2, 3, 4):
            _check(lambda t: spatial.mean(t) if isinstance(t, spatial.Rows)
                   else pool(t), x, k)


# ---- DeepLab v2's dropout and pooled branch ---------------------------------

def test_dropout_masks_sliced_equal_to_the_whole_maps():
    """One draw for the whole map on the first shard's device, sliced by
    rows: the same values as the unsharded draw from the same seed."""
    x = _rand(2, 5, 9, 6)
    for k in (2, 3, 4):
        torch.manual_seed(3)
        want = dropout(x, 0.5, True)
        torch.manual_seed(3)
        got = dropout(spatial.shard_rows(x, CPUS[k]), 0.5, True)
        assert torch.equal(got.gather("cpu"), want)
        assert 0 < (want == 0).double().mean() < 1
    assert dropout(x, 0.5, False) is x


def test_aspp_v2_train_forward_rows_pools_once():
    """ASPPV2 in train mode (float64): forward_rows over 2 and 3 shards
    against forward from the same dropout seed: the output, the gradients
    of the input and of every parameter (the pooled branch's conv and
    batch norm taken once, not once per shard), the running statistics."""
    aspp = ASPPV2(cin=8, planes=4)
    init_weights(aspp, torch.Generator().manual_seed(2))
    aspp = aspp.double().train()
    x = _rand(2, 8, 7, 5, seed=1)
    params = list(aspp.parameters())
    for k in (2, 3):
        runs = []
        for rows in (False, True):
            a = copy.deepcopy(aspp)
            torch.manual_seed(4)
            leaf = x.clone().requires_grad_(True)
            y = a.forward_rows(spatial.split_rows(leaf, CPUS[k])).gather(
                "cpu") if rows else a(leaf)
            obj = (y * _rand(*y.shape, seed=5)).sum()
            grads = torch.autograd.grad(obj, [leaf, *a.parameters()])
            stats = [b.clone() for n, b in a.named_buffers()
                     if "running" in n]
            runs.append((y.detach(), grads, stats))
        (y0, g0, s0), (y1, g1, s1) = runs
        torch.testing.assert_close(y1, y0, rtol=0, atol=1e-12)
        assert len(g0) == len(params) + 1
        for a, b in zip(g1 + tuple(s1), g0 + tuple(s0)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


# ---- each configuration's eval forward --------------------------------------

def _agree(got, want, what):
    for key in ("flood", "wildfire", "smog"):
        diff = (got[key].int() - want[key].int()).abs()
        assert (diff <= 1).float().mean() >= 0.999, (what, key)
    torch.testing.assert_close(got["mask"], want["mask"], rtol=0, atol=1e-5,
                               msg=what)


@pytest.mark.parametrize("name", list(SEVEN))
def test_row_sharded_infer_matches_the_unsharded(name):
    """build_spatial_infer_fn over 2 and 3 shards (uneven) and
    build_hybrid_infer_fn over 2 data groups x 2 shards, f32 at 64^2, with
    all three events, against the plain forward (``infer.unsharded``,
    build_infer_fn's) on the same weights and draws. The painter with z
    draws it from the generator on both sides; depth classification's smog
    divides by the whole batch's largest bucket."""
    opts = port_tiny_opts(64, **copy.deepcopy(SEVEN[name]))
    x = _rand(2, 64, 64, 3, seed=1, dtype=torch.float32)
    u = torch.rand(9, 9, generator=torch.Generator().manual_seed(2))
    kw = dict(dtype=torch.float32, seed=3)

    def call(infer):
        return infer(x, uniform=u, g_value=120.0,
                     generator=torch.Generator().manual_seed(5))

    infers = {k: build_spatial_infer_fn(opts, CPUS[k], **kw)[1]
              for k in (2, 3)}
    # the plain forward on the 2-shard builder's own model
    want = call(infers[2].unsharded)
    for k, infer in infers.items():
        _agree(call(infer), want, f"{name}, {k} shards")
    _agree(call(build_hybrid_infer_fn(opts, CPUS[4], 2, **kw)[1]), want,
           f"{name}, 2 x 2")


# ---- the float64 steps of groups A, B and C ---------------------------------

STEPS = ("g_step", "d_step")
DRAWS = ((0.05, False), (0.1, False))


@pytest.mark.parametrize("name", ["A", "B", "C"])
def test_row_sharded_steps_of_the_configurations(name):
    """g_step and d_step of group ``name`` at tiny_opts(32), batch 2 a
    domain, in float64 over 2 shards against the unsharded steps, each from
    the seed-0 state with the same draws (and C's dropout from the same
    seed): every loss within 1e-6 relative, the stepped model held by
    hold_state, the other's statistics and u/v. A: the SPADE masker at
    cond_nc 15, the base depth decoder, the final shortcut; B: cond_nc 12,
    MobileNetV2, the painter with z (drawn from the state's generator); C:
    DeepLab v2, depth classification on bucket targets, batch-norm
    SPADEs."""
    opts = load_opts(commandline_opts=TINY_OVERRIDES)
    merge(copy.deepcopy(CONFIGS[name]), opts)
    builder = StepBuilder(opts)
    buckets = 8 if builder.cfg.d_classify else 0
    batch = bench_train.synthetic_batch(2, 32, 32, "cpu", buckets=buckets)
    batch = {d: {k: v.double() if v.is_floating_point() else v
                 for k, v in b.items()} for d, b in batch.items()}
    G0 = create_generator(opts, 0).double()
    D0 = create_discriminator(opts, 1).double()
    runs = {}
    for devices in (None, CPUS[2]):
        out = []
        for i, step in enumerate(STEPS):
            st = builder.state_for(copy.deepcopy(G0), copy.deepcopy(D0))
            torch.manual_seed(11)
            st, metrics = getattr(builder, step)(st, batch, draws=DRAWS[i],
                                                 devices=devices)
            out.append((st, metrics, first_moments(
                (st.G, st.D)[i], (st.g_opt, st.d_opt)[i])))
        runs[devices is None] = out
    for i, step in enumerate(STEPS):
        (got, gm, gmu), (want, wm, wmu) = runs[False][i], runs[True][i]
        assert set(gm) == set(wm)
        for key, v in wm.items():
            np.testing.assert_allclose(float(gm[key]), float(v), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{step} {key}")
        for j, net in enumerate(("G", "D")):
            what = f"{name} 2 shards {step} {net}"
            if j == i:
                print(hold_state(getattr(got, net),
                                 getattr(want, net).state_dict(),
                                 (builder.g_lr, builder.d_lr)[i], gmu, wmu,
                                 what=what))
            else:
                hold_state(getattr(got, net), getattr(want, net).state_dict(),
                           what=what)


# ---- the bench's stages -----------------------------------------------------

@pytest.mark.parametrize("stage", ["masker", "painter"])
def test_bench_stages_on_rows(stage):
    """``--spatial`` (2 shards) and ``--hybrid 2`` (2 x 2) with ``--stage
    masker|painter`` parse and time the stage on row-sharded images:
    bench.stage_forward's outputs, gathered, against the unsharded
    stage's (the SPADE masker at 64^2, f32)."""
    opts = port_tiny_opts(64, **copy.deepcopy(SEVEN["spade_masker"]))
    x = _rand(2, 64, 64, 3, seed=6, dtype=torch.float32)
    kw = dict(dtype=torch.float32, seed=3)
    G1, one = build_infer_fn(opts, device="cpu", **kw)
    args = bench.parse_args(["--stage", stage, "--size", "64"])
    (want,) = bench.stage_forward(args, G1, one, x, ["cpu"], 1, 1,
                                  torch.float32)()
    for flags, dp, sp in ((["--spatial"], 1, 2), (["--hybrid", "2"], 2, 2)):
        args = bench.parse_args([*flags, "--stage", stage, "--size", "64",
                                 "--batch", "2"])
        assert args.stage == stage and bench.layout(args, dp * sp) == (dp,
                                                                       sp)
        build = (build_hybrid_infer_fn(opts, CPUS[4], 2, **kw) if dp > 1
                 else build_spatial_infer_fn(opts, CPUS[2], **kw))
        outs = bench.stage_forward(args, build[0], build[1], x,
                                   CPUS[dp * sp], dp, sp, torch.float32)()
        assert len(outs) == dp and all(isinstance(o, spatial.Rows)
                                       for o in outs)
        got = torch.cat([o.gather("cpu") for o in outs])
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5,
                                   msg=str(flags))
