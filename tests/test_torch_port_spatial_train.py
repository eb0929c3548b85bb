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
- the three discriminators' row forwards with their features;
- ``g_step`` and ``d_step`` over 2 and 3 shards against the unsharded
  step, ``train.grad_accumulation: 2`` over 2 shards;
- a trainer epoch on two shards through the CLI, resumed unsharded;
- JAX's fallback rule and message, and every refusal (ROADMAP A.11b-2b).

Bars: float64 throughout, so the sharded and unsharded ops differ only by
the order of float64 sums: ops and losses within 1e-10 relative (1e-12
absolute); the steps (float64 models and batch; the spectral sigma, the
paste's dtype and the optimizer's moments stay f32 on both sides) losses
within 1e-6 relative and the models held by ``step_check.hold_state``.
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn as nn

from climategan_torch import bench_train
from climategan_torch import losses as L
from climategan_torch.models.blocks import Conv2dBlock
from climategan_torch.models.discriminator import (
    FCDiscriminator,
    MultiscaleDiscriminator,
    NLayerDiscriminator,
    avg_pool_3x3_s2,
)
from climategan_torch.models.norms import (
    BatchNorm2d,
    SNConv,
    init_weights,
    instance_norm,
)
from climategan_torch.parallel import distributed, spatial
from climategan_torch.parallel.mesh import (
    fallback_message,
    spatial_devices,
)
from climategan_torch.train_step import StepBuilder
from climategan_torch.trainer import Trainer, refuse_unported_trainer
from climategan_torch.utils.opts import load_opts
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


def _steps(opts, batch, devices=None):
    """g_step, then d_step, each from the seed-0 state in float64."""
    builder = StepBuilder(opts)
    state = builder.init_state(0, "cpu")
    G0, D0 = state.G.double(), state.D.double()
    out = []
    for name, draws in zip(("g_step", "d_step"), DRAWS):
        st = builder.state_for(copy.deepcopy(G0), copy.deepcopy(D0))
        st, metrics = getattr(builder, name)(st, batch, draws=draws,
                                             devices=devices)
        out.append((st, metrics))
    return builder, out


@pytest.fixture(scope="module")
def unsharded():
    opts = load_opts(commandline_opts=TINY_OVERRIDES)
    batch = _f64(bench_train.synthetic_batch(2, 32, 32, "cpu", seed=0))
    return opts, batch, _steps(opts, batch)


def _hold_steps(builder, got, want, what):
    for i, ((gs, gm), (ws, wm)) in enumerate(zip(got, want)):
        assert set(gm) == set(wm)
        for key, v in wm.items():
            np.testing.assert_allclose(float(gm[key]), float(v), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{what} {key}")
        stepped = ("G", "D")[i]
        for m in ("G", "D"):
            mod, ref = getattr(gs, m), getattr(ws, m)
            if m == stepped:
                opt = "g_opt" if m == "G" else "d_opt"
                print(hold_state(mod, ref.state_dict(),
                                 (builder.g_lr, builder.d_lr)[i],
                                 first_moments(mod, getattr(gs, opt)),
                                 first_moments(ref, getattr(ws, opt)),
                                 what=f"{what} {m}"))
            else:
                hold_state(mod, ref.state_dict(), what=f"{what} {m}")


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
    """Each step option that row shards do not take, and KITTI
    pretraining, raises at the trainer's setup naming ROADMAP A.11b-2b;
    the step refuses them too; another generator configuration raises
    A.11b-3; a tpu.mesh.space other than tpu.spatial_shards raises."""
    base = {"tpu": {"spatial_shards": 2}}
    refused = {
        "use_local_discriminator": {"dis": {"p": {
            "use_local_discriminator": True}}},
        "use_pl4m": {"gen": {"m": {"use_pl4m": True}}},
        "WGAN_gp": {"dis": {"m": {"gan_type": "WGAN_gp"}}},
        "diff_aug": {"gen": {"p": {"diff_aug": {"use": True}}}},
        "tpu.remat yet": {"tpu": {"spatial_shards": 2, "remat": True}},
        "tpu.remat_d": {"tpu": {"spatial_shards": 2, "remat_d": True}},
        "VGG": {"train": {"allow_random_vgg": True}},
        "kitti.pretrain": {"train": {"kitti": {"pretrain": True}}},
    }
    for name, over in refused.items():
        opts = load_opts(commandline_opts={**base, **over})
        with pytest.raises(ValueError, match="A.11b-2b") as err:
            refuse_unported_trainer(opts)
        assert name in str(err.value), (name, str(err.value))
        opts.tpu.spatial_shards = 1
        refuse_unported_trainer(opts)  # unsharded, each option is ported
    opts = load_opts(commandline_opts={**TINY_OVERRIDES,
                                       "gen": {"m": {"use_pl4m": True}}})
    builder = StepBuilder(opts)
    state = builder.init_state(0, "cpu")
    batch = bench_train.synthetic_batch(2, 32, 32, "cpu", seed=0)
    with pytest.raises(ValueError, match="gen.m.use_pl4m"):
        builder.g_step(state, batch, devices=["cpu"] * 2)
    opts = load_opts(commandline_opts={**base,
                                       "gen": {"p": {"no_z": False}}})
    with pytest.raises(NotImplementedError, match="A.11b-3"):
        refuse_unported_trainer(opts)
    for space, ok in ((2, True), (-1, True), (4, False)):
        opts = load_opts(commandline_opts={"tpu": {
            "spatial_shards": 2, "mesh": {"data": -1, "space": space}}})
        if ok:
            refuse_unported_trainer(opts)
        else:
            with pytest.raises(ValueError, match="disagrees"):
                refuse_unported_trainer(opts)
