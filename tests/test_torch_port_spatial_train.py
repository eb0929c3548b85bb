"""Row-sharded training (``tpu.spatial_shards``) against the port's
unsharded step, on the CPU with shards on ``["cpu"] * k``; no JAX except
the trainer's dataset helper (tests/test_torch_port_train.py holds the
2-shard step to the JAX package's, and the hybrid step of two gloo ranks
x two shards to one process).

- train-mode ``conv2d`` (a spectral conv's u/v advanced once a call),
  ``instance_norm``, batch norm and ``avg_pool_3x3_s2`` on rows: values and
  input and weight gradients equal to the unsharded ones, over 2 and 3
  shards, on maps whose 3-shard split leaves a shard without rows;
- each loss on rows against the whole map, value and gradient;
- the step options' pieces on rows (each diff-aug transform, the gradient
  penalty, ``VGG19Features`` and the VGG loss), value and gradient;
- the three discriminators' row forwards with their features;
- ``g_step`` and ``d_step`` over 2 and 3 shards against the unsharded
  step, ``train.grad_accumulation: 2`` over 2 shards; each step option
  alone over 2 shards, all of them together over 3, remat under each
  policy over 2 (saving the convolutions the unsharded step saves);
- a trainer epoch on two shards through the CLI, resumed unsharded; a
  KITTI pretraining epoch and a normal one on two shards against the
  unsharded trainer's;
- JAX's fallback rule and message, and what is still refused (the mesh
  axes).

Bars: float64 throughout, so the sharded and unsharded ops differ only by
the order of float64 sums: ops and losses within 1e-10 relative (1e-12
absolute); the steps (float64 models and batch; the spectral sigma, the
paste's dtype and the optimizer's moments stay f32 on both sides) losses
within 1e-6 relative and the models held by ``step_check.hold_state``.
The maps are 7 rows high (3 shards: 2, 2, 3) except where an op needs
more: the VGG's four 2x2 pools (19 rows: the deepest slice is one row, so
two of three shards hold none) and the ADVENT D's five stride-2 convs (35
rows).
"""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn

from climategan_torch import bench_train
from climategan_torch import losses as L
from climategan_torch.models.blocks import Conv2dBlock
from climategan_torch.models.discriminator import (
    DisConfig,
    FCDiscriminator,
    MultiscaleDiscriminator,
    NLayerDiscriminator,
    avg_pool_3x3_s2,
    create_discriminator,
)
from climategan_torch.models.generator import GenConfig, create_generator
from climategan_torch.models.norms import (
    BatchNorm2d,
    SNConv,
    init_weights,
    instance_norm,
)
from climategan_torch.ops import diff_aug
from climategan_torch.parallel import distributed, spatial
from climategan_torch.parallel.mesh import (
    fallback_message,
    spatial_devices,
)
from climategan_torch.train_step import _CONVS, StepBuilder
from climategan_torch.trainer import Trainer, refuse_unported_trainer
from climategan_torch.utils.opts import load_opts, merge
from climategan_torch.utils.step_check import (
    TINY_OVERRIDES,
    first_moments,
    hold_state,
)
from tests.torch_port_common import one_thread  # noqa: F401 (a fixture)

SHARDS = (2, 3)
DRAWS = ((0.05, False), (0.1, False))


def _rand(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1.0, 1.0, shape))


def _rows(t, k):
    return spatial.split_rows(t, ["cpu"] * k)


def _whole(y):
    return y.gather("cpu") if isinstance(y, spatial.Rows) else y


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12, msg=what)


def _check(fn, inputs, params=(), what=""):
    """``fn`` of the whole inputs and of their rows over 2 and 3 shards:
    the outputs (a tensor or a list, gathered) and the gradients of a
    random projection of them with respect to the inputs and ``params``."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]

    def run(k):
        args = leaves if k == 1 else [_rows(t, k) for t in leaves]
        out = fn(*args)
        outs = [_whole(o) for o in (out if isinstance(out, (list, tuple))
                                    else [out])]
        obj = sum((o * _rand(*o.shape, seed=7 + i)).sum()
                  for i, o in enumerate(outs))
        grads = torch.autograd.grad(obj, leaves + list(params),
                                    allow_unused=True)
        return [o.detach() for o in outs], grads

    want, want_g = run(1)
    for k in SHARDS:
        got, got_g = run(k)
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{what} output {i}, {k} shards")
        for i, (a, b) in enumerate(zip(got_g, want_g)):
            assert (a is None) == (b is None), (what, i)
            if a is not None:
                _close(a, b, f"{what} gradient {i}, {k} shards")


# ---- the train-mode primitives ---------------------------------------------

def _conv_cases():
    torch.manual_seed(0)
    return {
        # the discriminators': spectral 4x4 stride 2 pad 1
        "sn_4x4_s2": SNConv(3, 5, 4, 2, padding=1, spectral=True),
        # the mask decoder's: reflect pad, spectral 3x3
        "block_reflect_sn_3x3": Conv2dBlock(3, 5, 3, 1, 1, norm="spectral",
                                            activation="none",
                                            pad_type="reflect"),
        # the encoder's dilated 3x3 and the painter's plain conv
        "conv_3x3_dilated": nn.Conv2d(3, 5, 3, 1, 2, 2),
    }


@pytest.mark.parametrize("h", [7, 2])
def test_train_conv2d_matches_and_advances_uv_once(h):
    """Each conv in train mode on maps of 7 and 2 rows (3 shards of 2 rows:
    one without rows): output, input and weight gradients; a spectral
    conv's u/v after the sharded call equal those after the unsharded call
    (one power iteration, stored under update_sn)."""
    for name, mod in _conv_cases().items():
        mod = mod.double().train()
        init_weights(mod, torch.Generator().manual_seed(1))
        sn = mod.conv if isinstance(mod, Conv2dBlock) else mod
        start = {k: v.clone() for k, v in mod.state_dict().items()}
        uv = {}

        def fn(x):
            mod.load_state_dict(start)
            if isinstance(x, spatial.Rows):
                y = (mod.forward_rows(x, update_sn=True)
                     if isinstance(mod, Conv2dBlock)
                     else spatial.conv2d(x, mod, update_sn=True))
            else:
                y = (mod(x) if isinstance(mod, nn.Conv2d)
                     else mod(x, update_sn=True))
            if getattr(sn, "spectral", False):
                uv[x.k if isinstance(x, spatial.Rows) else 1] = (
                    sn.module.weight_u.clone(), sn.module.weight_v.clone())
            return y

        _check(fn, [_rand(2, 3, h, 6, seed=h)], list(mod.parameters()), name)
        if uv:
            assert not torch.equal(uv[1][0], start["conv.module.weight_u"
                                   if "conv.module.weight_u" in start
                                   else "module.weight_u"])
            for k in SHARDS:
                _close(uv[k][0], uv[1][0], f"{name} u, {k} shards")
                _close(uv[k][1], uv[1][1], f"{name} v, {k} shards")


@pytest.mark.parametrize("h", [7, 2])
def test_train_norms_and_avg_pool_match(h):
    """Instance norm, a train-mode batch norm (statistics over every
    shard's rows, the running statistics moved once a call) and the
    discriminators' count_include_pad=False pool on rows."""
    x = _rand(2, 4, h, 5, seed=h)
    _check(lambda t: spatial.instance_norm(t) if isinstance(
        t, spatial.Rows) else instance_norm(t), [x], what="instance_norm")
    _check(avg_pool_3x3_s2, [x], what="avg_pool_3x3_s2")
    bn = BatchNorm2d(4).double().train()
    init_weights(bn, torch.Generator().manual_seed(2))
    start = copy.deepcopy(bn.state_dict())
    stats = {}

    def fn(t):
        bn.load_state_dict(start)
        y = bn.forward_rows(t) if isinstance(t, spatial.Rows) else bn(t)
        stats[t.k if isinstance(t, spatial.Rows) else 1] = (
            bn.running_mean.clone(), bn.running_var.clone())
        return y

    _check(fn, [x], list(bn.parameters()), "batch norm")
    assert not torch.equal(stats[1][0], start["running_mean"])
    for k in SHARDS:
        for a, b in zip(stats[k], stats[1]):
            _close(a, b, f"batch norm running statistics, {k} shards")


# ---- the losses -------------------------------------------------------------

def _prob(*shape, seed):
    return torch.softmax(_rand(*shape, seed=seed) * 3, dim=1)


def _scales(seed):
    """A multiscale discriminator's outputs: per scale, a feature map and
    the final patch map."""
    return [[_rand(4, 3, h, 5, seed=seed + h), _rand(4, 1, h - 1, 4,
                                                     seed=seed + 2 * h)]
            for h in (7, 3)]


LOSSES = {
    "tv_loss": (L.tv_loss, lambda: [_rand(2, 2, 7, 5, seed=1)]),
    "sigm_loss": (L.sigm_loss, lambda: [_rand(2, 1, 13, 11, seed=2),
                                        _rand(2, 1, 13, 11, seed=3)]),
    "minent_loss_v1": (L.minent_loss, lambda: [_prob(2, 3, 7, 5, seed=4)]),
    "minent_loss_v2": (lambda p: L.minent_loss(p, version=2),
                       lambda: [_prob(2, 2, 7, 5, seed=5)]),
    "dada_depth_loss": (L.dada_depth_loss,
                        lambda: [_rand(2, 1, 7, 5, seed=6),
                                 _rand(2, 1, 7, 5, seed=7)]),
    "bce_with_logits": (L.bce_with_logits,
                        lambda: [_rand(2, 1, 7, 5, seed=8),
                                 (_rand(2, 1, 7, 5, seed=9) > 0).double()]),
    "wgan_domain_loss": (lambda x: L.wgan_domain_loss(x, 1.0),
                         lambda: [_rand(2, 1, 2, 3, seed=10)]),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_on_rows_matches_the_whole_map(name):
    fn, make = LOSSES[name]
    _check(fn, make(), what=name)


def test_cross_entropy_and_ground_intersection_on_rows():
    """The integer labels split as the logits; the ground term has no
    gradient (a comparison)."""
    labels = torch.from_numpy(np.random.default_rng(11).integers(
        0, 11, (2, 7, 5)))
    _check(lambda x: L.cross_entropy(
        x, _rows(labels, x.k) if isinstance(x, spatial.Rows) else labels),
        [_rand(2, 11, 7, 5, seed=12)], what="cross_entropy")
    pred, ground = _rand(2, 1, 7, 5, seed=13), _rand(2, 1, 7, 5, seed=14)
    want = L.ground_intersection_loss(pred, ground)
    for k in SHARDS:
        _close(L.ground_intersection_loss(_rows(pred, k), _rows(ground, k)),
               want, f"ground_intersection_loss, {k} shards")


def test_gan_and_feature_matching_losses_on_patch_maps():
    """``gan_loss`` (soft labels, flipped) and ``feat_match_loss`` over two
    scales of patch maps split by rows, ``divide_pred``'s halves."""
    from climategan_torch.train_step import divide_pred

    fake, real = _scales(20), _scales(40)
    flat = [t for s in fake + real for t in s]

    def fn(*ts):
        f, r = [list(ts[0:2]), list(ts[2:4])], [list(ts[4:6]),
                                                list(ts[6:8])]
        halves = divide_pred(f)
        return [L.gan_loss(f, True, 0.1, False), L.gan_loss(f, False, 0.2,
                                                             True),
                L.feat_match_loss(r, f), L.gan_loss(halves[1], True, 0.0)]

    _check(fn, flat, what="gan and feature matching")


# ---- the step options' pieces -----------------------------------------------

# diff-aug draws for 3 samples of 7 x 6: translations up to 4 rows (more
# than a shard's 2 or 3 rows), cutouts of 4 x 3
AUG = diff_aug.DiffTransforms(True, True, True, translation_ratio=0.5)
AUG_DRAWS = AUG.draw(3, 7, 6, torch.Generator().manual_seed(5))


def _vgg():
    torch.manual_seed(6)
    return L.VGG19Features().double().eval().requires_grad_(False)


def _fc_d():
    D = FCDiscriminator(2, 8, use_norm=False).double()
    init_weights(D, torch.Generator().manual_seed(8))
    return D


def _aug_case(fn, seed):
    return lambda: (fn, [_rand(3, 3, 7, 6, seed=seed)], ())


def _wgan_gp_case():
    D = _fc_d()
    return ((lambda x: L.wgan_gp(D, x)), [_rand(2, 2, 35, 32, seed=36).abs()],
            list(D.parameters()))


def _vgg_loss_case():
    vgg = _vgg()
    return ((lambda x, y: L.vgg_loss(vgg, L.vgg_preprocess(x),
                                     L.vgg_preprocess(y))),
            [_rand(2, 3, 19, 16, seed=38), _rand(2, 3, 19, 16, seed=39)], ())


# name: () -> (fn, inputs, the parameters whose gradients are held too)
OPTION_OPS = {
    "brightness": _aug_case(lambda x: diff_aug.rand_brightness(
        x, AUG_DRAWS["brightness"]), 30),
    "contrast": _aug_case(lambda x: diff_aug.rand_contrast(
        x, AUG_DRAWS["contrast"]), 31),
    "saturation": _aug_case(lambda x: diff_aug.rand_saturation(
        x, AUG_DRAWS["saturation"]), 32),
    "translation": _aug_case(lambda x: diff_aug.rand_translation(
        x, AUG_DRAWS["tx"], AUG_DRAWS["ty"]), 33),
    "cutout": _aug_case(lambda x: diff_aug.rand_cutout(
        x, AUG_DRAWS["ox"], AUG_DRAWS["oy"]), 34),
    "DiffTransforms": _aug_case(lambda x: AUG(x, AUG_DRAWS), 35),
    "wgan_gp": _wgan_gp_case,
    "VGG19Features": lambda: (_vgg(), [_rand(2, 3, 19, 16, seed=37)], ()),
    "vgg_loss": _vgg_loss_case,
}


@pytest.mark.parametrize("name", list(OPTION_OPS))
def test_step_option_op_on_rows_matches_the_whole_map(name):
    """Each diff-aug transform (and all of them in turn), the gradient
    penalty (its gradient in the ADVENT D's weights: a second-order
    product through every shard), the VGG's five slices and the VGG loss
    on rows: values and gradients against the whole map's."""
    fn, inputs, params = OPTION_OPS[name]()
    _check(fn, inputs, params, name)


# ---- the discriminators -----------------------------------------------------

DISCS = {
    "NLayerDiscriminator": (lambda: NLayerDiscriminator(4, 8, 2), (2, 4, 24,
                                                                   20)),
    "MultiscaleDiscriminator": (lambda: MultiscaleDiscriminator(4, 2, 8, 2),
                                (2, 4, 32, 24)),
    "FCDiscriminator": (lambda: FCDiscriminator(2, 8), (2, 2, 32, 32)),
}


@pytest.mark.parametrize("name", list(DISCS))
def test_discriminator_forward_rows_matches_forward(name):
    """Train mode with update_sn: every output (the features for feature
    matching too), the input and weight gradients, and the u/v."""
    make, shape = DISCS[name]
    torch.manual_seed(0)
    D = make().double().train()
    init_weights(D, torch.Generator().manual_seed(3))
    start = copy.deepcopy(D.state_dict())
    after = {}

    def fn(x):
        D.load_state_dict(start)
        out = D(x, update_sn=True)
        after[x.k if isinstance(x, spatial.Rows) else 1] = copy.deepcopy(
            D.state_dict())
        if isinstance(out, list):
            return [t for scale in out
                    for t in (scale if isinstance(scale, list) else [scale])]
        return out

    _check(fn, [_rand(*shape, seed=4)], list(D.parameters()), name)
    for k in SHARDS:
        for key, v in after[1].items():
            _close(after[k][key], v, f"{name} {key}, {k} shards")


# ---- the step ---------------------------------------------------------------

def _f64(batch):
    return {d: {k: v.double() if v.is_floating_point() else v
                for k, v in b.items()} for d, b in batch.items()}


STEPS = ("g_step", "d_step")


# the float64 seed-0 models by configuration, built once for the module
_SEED0 = {}


@pytest.fixture(autouse=True, scope="module")
def _drop_seed0_models():
    yield
    _SEED0.clear()


def _seed0(opts):
    """``init_state(0)``'s G and D of ``opts`` in float64, each built once
    a configuration."""
    for key, make in ((GenConfig.from_opts(opts), create_generator),
                      (DisConfig.from_opts(opts), create_discriminator)):
        if key not in _SEED0:
            seed = 0 if make is create_generator else 1
            _SEED0[key] = make(opts, seed).double().train()
    return (_SEED0[GenConfig.from_opts(opts)],
            _SEED0[DisConfig.from_opts(opts)])


def _steps(opts, batch, devices=None, names=STEPS, vgg=None, policy=None):
    """Each step of ``names`` (g_step, d_step) from the seed-0 state in
    float64; ``vgg``: the perceptual loss's; ``policy``: a remat policy in
    place of the opts'. Returns the builder and, of each step, (name, G, D,
    metrics, the stepped model's first moments): the optimizer states'
    other moments are dropped (a float64 state is about 1 GB)."""
    builder = StepBuilder(opts, vgg=vgg)
    if policy is not None:
        builder.remat_policy = policy
    G0, D0 = _seed0(opts)
    out = []
    for name in names:
        i = STEPS.index(name)
        st = builder.state_for(copy.deepcopy(G0), copy.deepcopy(D0))
        st, metrics = getattr(builder, name)(st, batch, draws=DRAWS[i],
                                             devices=devices)
        mu = first_moments((st.G, st.D)[i], (st.g_opt, st.d_opt)[i])
        out.append((name, st.G, st.D, metrics, mu))
    return builder, out


@pytest.fixture(scope="module")
def unsharded():
    opts = load_opts(commandline_opts=TINY_OVERRIDES)
    batch = _f64(bench_train.synthetic_batch(2, 32, 32, "cpu", seed=0))
    return opts, batch, _steps(opts, batch)


def _hold_steps(builder, got, want, what):
    for (name, gG, gD, gm, gmu), (wname, wG, wD, wm, wmu) in zip(got, want):
        assert name == wname
        assert set(gm) == set(wm)
        for key, v in wm.items():
            np.testing.assert_allclose(float(gm[key]), float(v), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{what} {key}")
        i = STEPS.index(name)
        for j, (m, mod, ref) in enumerate((("G", gG, wG), ("D", gD, wD))):
            if j == i:
                print(hold_state(mod, ref.state_dict(),
                                 (builder.g_lr, builder.d_lr)[i], gmu, wmu,
                                 what=f"{what} {name} {m}"))
            else:
                hold_state(mod, ref.state_dict(), what=f"{what} {name} {m}")


@pytest.mark.parametrize("k", SHARDS)
def test_row_sharded_steps_match_the_unsharded(unsharded, k):
    """The default configuration at tiny_opts(32), batch 2 a domain: the
    os8 maps have 4 rows (3 shards: 1, 1, 2), the painter's first map 1
    (shards without rows); every loss within 1e-6, both models held
    (statistics and u/v too)."""
    opts, batch, want = unsharded
    builder, got = _steps(opts, batch, ["cpu"] * k)
    _hold_steps(builder, got, want[1], f"{k} shards")


def test_grad_accumulation_over_two_shards():
    """``train.grad_accumulation: 2`` splits the batch into micro-batches,
    then each micro-batch's rows over the shards."""
    opts = load_opts(commandline_opts={**TINY_OVERRIDES, "train": {
        **TINY_OVERRIDES["train"], "grad_accumulation": 2}})
    batch = _f64(bench_train.synthetic_batch(2, 32, 32, "cpu", seed=1))
    _, want = _steps(opts, batch)
    builder, got = _steps(opts, batch, ["cpu"] * 2)
    _hold_steps(builder, got, want, "accumulated")


# ---- the step options on rows ----------------------------------------------

DIFF_AUG = {"use": True, "do_color_jittering": True, "do_cutout": True,
            "do_translation": True}
# option: (overrides, the steps it changes: pl4m and the VGG loss are terms
# of the G step only, whose D step is the default's)
OPTIONS = {
    "use_local_discriminator": (
        {"dis": {"p": {"use_local_discriminator": True}}}, STEPS),
    "use_pl4m": ({"gen": {"m": {"use_pl4m": True}}}, ("g_step",)),
    "WGAN_gp": ({"dis": {"m": {"gan_type": "WGAN_gp"},
                         "s": {"gan_type": "WGAN_gp"}}}, STEPS),
    "diff_aug": ({"gen": {"p": {"diff_aug": DIFF_AUG}}}, STEPS),
    "VGG": ({}, ("g_step",)),
}


def _option_opts(*overrides):
    opts = load_opts(commandline_opts=TINY_OVERRIDES)
    for over in overrides:
        merge(copy.deepcopy(over), opts)
    return opts


@pytest.mark.parametrize("option", list(OPTIONS))
def test_step_option_over_two_shards_matches_the_unsharded(option):
    """Each step option alone at tiny_opts(32), batch 2 a domain: the
    local painter D (p_global and p_local on rows, JAX's order of D calls),
    pl4m (the frozen painter on rows, its paste per shard), WGAN-GP on both
    ADVENT Ds (each sample's gradient norm over both shards), diff-aug (the
    step's draws from the state's generator) and the VGG loss (a random
    float64 VGG on rows): the steps it changes over 2 shards against the
    unsharded ones, every loss within 1e-6 and both models held."""
    over, names = OPTIONS[option]
    opts = _option_opts(over)
    vgg = _vgg() if option == "VGG" else None
    batch = _f64(bench_train.synthetic_batch(2, 32, 32, "cpu", seed=0))
    _, want = _steps(opts, batch, names=names, vgg=vgg)
    builder, got = _steps(opts, batch, ["cpu"] * 2, names=names, vgg=vgg)
    assert {"use_pl4m": "m_pl4m", "VGG": "p_vgg", "WGAN_gp": "m_gp_s"}.get(
        option, "g_total") in {k for _, _, _, m, _ in got for k in m}
    _hold_steps(builder, got, want, option)


# remat's small_convs area at 32^2: a 16 x 16 map (256) is over it, the
# 10 x 16 window of a 3x3 conv on one of its 2 shards (160) under it
REMAT_AREA = 200
REMAT = {"tpu": {"remat": True, "remat_d": True}}
_CONVS_OP = next(iter(_CONVS))


def test_all_step_options_over_three_shards_match_the_unsharded():
    """Every option at once over 3 shards (uneven: the os8 maps 1, 1 and 2
    rows, the painter's first map 0, 0 and 1): the local painter D, pl4m,
    WGAN-GP, diff-aug, the VGG loss, and remat and remat_d under
    small_convs."""
    opts = _option_opts(*(o for o, _ in OPTIONS.values()), REMAT, {
        "tpu": {"remat_policy": f"small_convs:{REMAT_AREA}"}})
    vgg = _vgg()
    batch = _f64(bench_train.synthetic_batch(2, 32, 32, "cpu", seed=0))
    _, want = _steps(opts, batch, vgg=vgg)
    builder, got = _steps(opts, batch, ["cpu"] * 3, vgg=vgg)
    _hold_steps(builder, got, want, "all options, 3 shards")


def _recording(policy, seen):
    """``policy`` that records (the conv's weight shape, the area it
    decided by, the input's own area, its decision) for every
    convolution."""
    def decide(op, *args):
        keep = policy(op, *args)
        if op in _CONVS:
            h, w = args[0].shape[-2:]
            whole = spatial.whole_area()
            seen.add((tuple(args[1].shape), h * w if whole is None else whole,
                      h * w, keep))
        return keep
    return decide


@pytest.fixture(scope="module")
def remat_convs():
    """The convolutions of the unsharded remat g_step and d_step: (weight
    shape, input area)."""
    from climategan_torch.train_step import make_remat_policy

    seen = set()
    opts = _option_opts(REMAT, {"tpu": {"remat_policy": "dots"}})
    batch = _f64(bench_train.synthetic_batch(2, 32, 32, "cpu", seed=0))
    _steps(opts, batch, policy=_recording(make_remat_policy("dots"), seen))
    return {(shape, area) for shape, area, _, _ in seen}


@pytest.mark.parametrize("policy", ["", "dots", f"small_convs:{REMAT_AREA}"])
def test_remat_over_two_shards_saves_the_unsharded_convs(unsharded,
                                                         remat_convs, policy):
    """``tpu.remat`` and ``tpu.remat_d`` over 2 shards under each policy:
    the steps held to the unsharded (plain) steps, which a remat step
    equals; the policy decides each convolution by the whole map's area,
    so the sharded step saves exactly the convolutions the unsharded one
    saves (under small_convs some windows fall under the area where their
    whole maps do not)."""
    from climategan_torch.train_step import make_remat_policy

    _, batch, (_, want) = unsharded
    opts = _option_opts(REMAT, {"tpu": {"remat_policy": policy}})
    pol = make_remat_policy(policy)
    seen = set()
    builder, got = _steps(opts, batch, ["cpu"] * 2, policy=None if pol is None
                          else _recording(pol, seen))
    assert builder.remat and builder.remat_d
    _hold_steps(builder, got, want, f"remat {policy!r}, 2 shards")
    if pol is None:
        return  # nothing saved, sharded or not
    saved = {(shape, area, keep) for shape, area, _, keep in seen}
    assert saved == {(shape, area, pol(_CONVS_OP, torch.empty(1, 1, area, 1)))
                     for shape, area in remat_convs}
    if policy.startswith("small_convs"):
        assert any(keep != pol(_CONVS_OP, torch.empty(1, 1, own, 1))
                   for _, _, own, keep in seen)


# ---- the trainer ------------------------------------------------------------

def test_trainer_epoch_on_two_shards_then_resume_unsharded(tmp_path,
                                                           capsys):
    """``python -m climategan_torch.train --device cpu
    tpu.spatial_shards=2`` trains an epoch on ["cpu"] * 2 (each step with
    the shards' devices); ``args.resume=true`` without shards restores its
    checkpoint bit for bit and trains the next epoch."""
    import json

    import yaml

    from climategan_torch import train as train_cli
    from climategan_torch.utils.checkpoint import read_checkpoint, state_digest
    from tests.torch_port_common import opts_pair, write_dataset

    lists = write_dataset(tmp_path / "data")
    _, topts = opts_pair(lists, bf16=False)
    topts.train.lambdas.G.p.vgg = 0
    topts.data.max_samples = 2
    topts.output_path = str(tmp_path / "run")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(topts.to_dict()))
    seen = []
    real = StepBuilder.train_step

    def record(self, *args, **kwargs):
        seen.append(kwargs.get("devices"))
        return real(self, *args, **kwargs)

    StepBuilder.train_step = record
    try:
        assert train_cli.main(["--device", "cpu", f"args.config={cfg}",
                               "tpu.spatial_shards=2", "train.epochs=1"]) == 0
        assert seen == [[torch.device("cpu")] * 2]
        seen.clear()
        epoch0 = state_digest(read_checkpoint(
            tmp_path / "run" / "checkpoints" / "latest_ckpt.pth"))
        assert train_cli.main(["--device", "cpu", f"args.config={cfg}",
                               "args.resume=true", "train.epochs=2",
                               f"output_path={tmp_path / 'run'}"]) == 0
    finally:
        StepBuilder.train_step = real
    assert seen == [None]
    records = [json.loads(line) for line in
               (tmp_path / "run" / "train.jsonl").read_text().splitlines()]
    resumed = [r for r in records if "resumed_from_epoch" in r]
    assert [r["state_digest"] for r in resumed] == [epoch0]
    assert [r["epoch"] for r in records if "steps" in r] == [0, 1]
    assert "does not divide" not in capsys.readouterr().out


def _trainer_run(opts, devices):
    """``Trainer.train`` on ``opts`` with the state and every batch in
    float64 (its evaluation and checkpoint, which read f32, left out):
    the step builder, G, D and their first moments, and each step's
    (domains, devices, metrics)."""
    trainer = Trainer(opts, device="cpu").setup()
    assert trainer.shard_devices == devices
    st = trainer.state
    trainer.state = trainer.builder.state_for(st.G.double(), st.D.double(),
                                              0)
    real, seen = trainer.builder.train_step, []

    def step(state, batch, *args, **kwargs):
        state, metrics = real(state, _f64(batch), *args, **kwargs)
        seen.append((sorted(batch), kwargs.get("devices"), metrics))
        return state, metrics

    ckpt = opts.output_path + ".ckpt"
    open(ckpt, "w").close()
    trainer.builder.train_step = step
    trainer.run_evaluation = dict
    trainer.save = lambda: Path(ckpt)
    trainer.train()
    st = trainer.state
    return (trainer.builder, st.G, st.D, first_moments(st.G, st.g_opt),
            first_moments(st.D, st.d_opt)), seen


def test_kitti_pretraining_epoch_on_two_shards_matches_the_unsharded(
        tmp_path):
    """``train.kitti.pretrain`` (one KITTI epoch, then a normal one) with
    ``tpu.spatial_shards: 2``: the KITTI batch (domain s items) splits by
    rows as any domain's; both epochs' steps equal the unsharded trainer's
    (losses within 1e-6, G and D held by ``hold_state`` after the second
    epoch), in float64 on the trainer's own batches (the transforms' draws
    from the global ``random``, seeded alike before each run)."""
    import random

    from tests.torch_port_common import opts_pair, write_dataset

    lists = write_dataset(tmp_path / "data", kitti=2)
    _, topts = opts_pair(lists, bf16=False, kitti={
        "pretrain": True, "epochs": 1, "batch_size": 2})
    topts.domains = list(topts.domains) + ["kitti"]
    topts.train.lambdas.G.p.vgg = 0
    topts.data.max_samples = 2
    topts.train.epochs = 2
    runs = {}
    for k in (1, 2):
        opts = copy.deepcopy(topts)
        opts.tpu.spatial_shards = k
        opts.output_path = str(tmp_path / f"run{k}")
        random.seed(0)
        runs[k] = _trainer_run(opts, None if k == 1
                               else [torch.device("cpu")] * 2)
    (want, want_seen), (got, got_seen) = runs[1], runs[2]
    assert [s[:2] for s in got_seen] == [
        (["s"], [torch.device("cpu")] * 2),
        (["r", "rf", "s"], [torch.device("cpu")] * 2)]
    for (_, _, gm), (_, _, wm) in zip(got_seen, want_seen):
        assert set(gm) == set(wm)
        for key, v in wm.items():
            np.testing.assert_allclose(float(gm[key]), float(v), rtol=1e-6,
                                       atol=1e-12, err_msg=key)
    (b, gG, gD, g_mu, d_mu), (_, wG, wD, wg_mu, wd_mu) = got, want
    print(hold_state(gG, wG.state_dict(), b.g_lr, g_mu, wg_mu,
                     what="kitti G"))
    print(hold_state(gD, wD.state_dict(), b.d_lr, d_mu, wd_mu,
                     what="kitti D"))


def test_fallback_rule_and_message(monkeypatch, capsys):
    """JAX's rule over the cards a rank owns: rank r of a node owns cards
    [r k, (r + 1) k) and shards there when all k exist; else the trainer
    prints JAX's message and trains unsharded; the CPU holds any k."""
    assert spatial_devices("cuda", 2, 0, n_cards=4) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    assert spatial_devices("cuda", 2, 1, n_cards=4) == [
        torch.device("cuda", 2), torch.device("cuda", 3)]
    assert spatial_devices("cuda", 2, 1, n_cards=3) is None
    assert spatial_devices("cuda", 2, 0, n_cards=1) is None
    assert spatial_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert spatial_devices("cuda", 1, 0, n_cards=4) is None
    assert fallback_message(2, 1) == ("tpu.spatial_shards=2 does not divide "
                                      "the 1-device mesh; falling back to "
                                      "pure DP")
    opts = load_opts(commandline_opts={"tpu": {"spatial_shards": 2}})
    trainer = Trainer(opts, device="cpu")
    trainer.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    trainer._place_shards()
    assert trainer.shard_devices is None
    assert trainer.device == torch.device("cuda")
    assert fallback_message(2, 1) in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(distributed, "local_rank", lambda: 1)
    trainer._place_shards()
    assert trainer.shard_devices == [torch.device("cuda", 2),
                                     torch.device("cuda", 3)]
    assert trainer.device == torch.device("cuda", 2)
    assert "does not divide" not in capsys.readouterr().out


def test_refusals(tmp_path):
    """Each step option and KITTI pretraining (ROADMAP A.11b-2b) is taken
    under row shards: ``refuse_unported_trainer`` accepts each, sharded or
    not, and ``g_step(devices=...)`` takes every step option at once; so
    is every generator configuration (here a painter with z: the others'
    steps are held in tests/test_torch_port_spatial_configs.py); a
    tpu.mesh.space other than tpu.spatial_shards raises."""
    base = {"tpu": {"spatial_shards": 2}}
    taken = {
        "use_local_discriminator": {"dis": {"p": {
            "use_local_discriminator": True}}},
        "use_pl4m": {"gen": {"m": {"use_pl4m": True}}},
        "WGAN_gp": {"dis": {"m": {"gan_type": "WGAN_gp"}}},
        "diff_aug": {"gen": {"p": {"diff_aug": {"use": True}}}},
        "tpu.remat": {"tpu": {"spatial_shards": 2, "remat": True}},
        "tpu.remat_d": {"tpu": {"spatial_shards": 2, "remat_d": True}},
        "VGG": {"train": {"allow_random_vgg": True}},
        "kitti.pretrain": {"train": {"kitti": {"pretrain": True}}},
    }
    for name, over in taken.items():
        opts = load_opts(commandline_opts={**base, **over})
        refuse_unported_trainer(opts)
        opts.tpu.spatial_shards = 1
        refuse_unported_trainer(opts)
    opts = _option_opts(*(o for o, _ in OPTIONS.values()), REMAT)
    torch.manual_seed(6)
    builder = StepBuilder(opts, vgg=L.VGG19Features())
    state = builder.init_state(0, "cpu")
    batch = bench_train.synthetic_batch(2, 32, 32, "cpu", seed=0)
    _, metrics = builder.g_step(state, batch, devices=["cpu"] * 2)
    assert {"m_pl4m", "p_vgg", "p_gan"} <= set(metrics)
    assert all(torch.isfinite(v) for v in metrics.values())
    opts = load_opts(commandline_opts={**base,
                                       "gen": {"p": {"no_z": False}}})
    refuse_unported_trainer(opts)
    for space, ok in ((2, True), (-1, True), (4, False)):
        opts = load_opts(commandline_opts={"tpu": {
            "spatial_shards": 2, "mesh": {"data": -1, "space": space}}})
        if ok:
            refuse_unported_trainer(opts)
        else:
            with pytest.raises(ValueError, match="disagrees"):
                refuse_unported_trainer(opts)
