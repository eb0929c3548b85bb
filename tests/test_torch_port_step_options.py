"""The options of the training step against the JAX package's, on the CPU
in f32 at ``tiny_opts(32)``: the local/global painter D, pl4m, WGAN-GP on
both ADVENT Ds and DiffAugment in one step, and gradient accumulation in
another (the two JAX step compiles of this file, each of g_step then
d_step under one ``jax.jit`` at XLA opt level 0, with the exact TPU
rewrites off as in tests/test_torch_port_train.py); then the pieces alone
(each diff-aug function on fed draws, the gradient penalty) and the
port's own remat, whose step must equal the plain one.

The accumulated step runs on ``seeded_batch(4, 2)``: on ``_batch(4,
32)`` (seed 0) one micro-batch puts a pre-activation at a leaky-ReLU kink,
where the port with oneDNN on (4 threads) lands on XLA's side and with one
thread or oneDNN off on the other, 1.9% of a leaf's largest first moment
apart, and the JAX package's batch norm (flax's one-pass variance
E[x^2] - E[x]^2) moves the depth head's f32 gradients by more there
(ROADMAP C).

JAX's draws reach the port through ``draws=`` and ``aug=``: the (soft,
flip) pair of each step, and the diff-aug uniforms and integer offsets
drawn here with ``jax.random`` from the step's key as the JAX step draws
them (``fold_in(rng, 7)``, split into the painter output's and the real
image's keys, each split in five).

The combined step also runs row-sharded over two shards (ROADMAP
A.11b-2b) against the same JAX states; tests/test_torch_port_spatial_train
.py holds each option on rows to the unsharded step in float64.

Bars: every loss of the metrics within 1e-4 relative; the models after
each step held to JAX's by ``hold_state`` (see tests/test_torch_port_train
.py); diff-aug outputs within 1e-6; the gradient penalty and its gradient
within 1e-5 relative; a remat step's losses and parameters within 1e-6 of
the plain step's and its statistics and u/v bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climategan_tpu.models.norms as jax_norms
from climategan_tpu.ops import diff_aug as jax_aug
from climategan_tpu.train_step import StepBuilder as JaxStepBuilder
from climategan_tpu.train_step import TrainState as JaxTrainState
from climategan_tpu.utils.opts import Opts, merge
from climategan_tpu.utils.testing import tiny_opts
from climategan_torch.bench_train import synthetic_batch
from climategan_torch.models.discriminator import (
    DisConfig,
    FCDiscriminator,
    OmniDiscriminator,
)
from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.ops import diff_aug
from climategan_torch.parallel.spawn import run_ranks
from climategan_torch.train_step import (
    STATE_BUFFERS,
    StepBuilder,
    make_remat_policy,
)
from climategan_torch.utils.convert import (
    d_state_dict_from_jax,
    state_dict_from_jax,
)
from climategan_torch.utils.opts import load_opts
from climategan_torch.utils.step_check import first_moments, hold_state
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    ABOVE_THE_KINK,
    jax_d_variables,
    jax_variables,
    moments_only,
    once_per_session,
    one_thread,
    port_batch,
    step_draws,
)

SIZE = 32
DIFF_AUG = {"use": True, "do_color_jittering": True, "do_cutout": True,
            "do_translation": True}
COMBINED = {"dis": {"p": {"use_local_discriminator": True},
                    "m": {"gan_type": "WGAN_gp"},
                    "s": {"gan_type": "WGAN_gp"}},
            "gen": {"m": {"use_pl4m": True}, "p": {"diff_aug": DIFF_AUG}}}
ACCUMULATED = {"train": {"grad_accumulation": 2}}


def jax_aug_draws(key, n, h, w, cutout_ratio=0.5, translation_ratio=0.125):
    """The draws of one JAX ``DiffTransforms`` call from ``key``, as the
    port's ``DiffTransforms.draw`` names them."""
    keys = jax.random.split(key, 5)
    out = {}
    for k, name in zip(keys[:3], ("brightness", "contrast", "saturation")):
        out[name] = jax.random.uniform(k, (n, 1, 1, 1)).reshape(n)
    sh, sw = diff_aug.translation_shifts(h, w, translation_ratio)
    k1, k2 = jax.random.split(keys[3])
    out["tx"] = jax.random.randint(k1, (n, 1, 1), -sh, sh + 1).reshape(n)
    out["ty"] = jax.random.randint(k2, (n, 1, 1), -sw, sw + 1).reshape(n)
    ch, cw = diff_aug.cutout_sizes(h, w, cutout_ratio)
    k1, k2 = jax.random.split(keys[4])
    out["ox"] = jax.random.randint(k1, (n, 1, 1), 0,
                                   h + (1 - ch % 2)).reshape(n)
    out["oy"] = jax.random.randint(k2, (n, 1, 1), 0,
                                   w + (1 - cw % 2)).reshape(n)
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in out.items()}


def step_aug_draws(rng, n, h, w):
    """The (painter output's, real image's) draws of the JAX g_step and
    d_step from TrainState.rng ``rng``."""
    k_g, rest = jax.random.split(rng)
    k_d, _ = jax.random.split(rest)
    return tuple(tuple(jax_aug_draws(k, n, h, w) for k in jax.random.split(
        jax.random.fold_in(key, 7))) for key in (k_g, k_d))


def seeded_batch(n, seed):
    """tests/test_train_step.py's ``_batch(n, SIZE)`` drawn from
    ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    feat = max(SIZE // 4, 32)

    def img(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    def mask():
        return (rng.rand(n, SIZE, SIZE, 1) > 0.5).astype(np.float32)

    return {
        "r": {"x": img(n, SIZE, SIZE, 3), "m": mask()},
        "s": {"x": img(n, SIZE, SIZE, 3),
              "d": rng.uniform(0.01, 1, (n, feat, feat, 1)).astype(np.float32),
              "s": rng.randint(0, 11, (n, feat, feat)).astype(np.int32),
              "m": mask()},
        "rf": {"x": img(n, SIZE, SIZE, 3), "m": mask()},
    }


def _split(variables):
    return (variables["params"],
            {k: v for k, v in variables.items() if k != "params"})


def _jopts(overrides):
    jopts = tiny_opts(SIZE)
    jopts.train.bf16 = False
    jopts.tpu.painter_s2d = False
    merge(Opts(overrides), jopts)
    return jopts


def _run_jax(overrides, n, seed=0):
    """JAX's states before, between and after g_step and d_step, their
    metrics, the batch, the draws and the port's opts."""
    jopts = _jopts(overrides)
    prev = jax_norms.FUSED_REFLECT
    jax_norms.FUSED_REFLECT = False
    try:
        jb = JaxStepBuilder(jopts)
        _, gvars = jax_variables(jopts, SIZE, seed=0)
        _, dvars = jax_d_variables(jopts, SIZE, seed=1)
        gp, gs = _split(gvars)
        dp, ds = _split(dvars)
        key = jax.random.PRNGKey(3)
        state0 = JaxTrainState(gp, gs, dp, ds, jb.g_opt_init(gp),
                               jb.d_opt_init(dp), jnp.zeros((), jnp.int32),
                               key)
        batch = seeded_batch(n, seed)

        def both(state, batch):
            state1, gm = jb.g_step(state, batch, 1.0)
            state2, dm = jb.d_step(state1, batch, 1.0)
            return state1, gm, state2, dm

        compiled = jax.jit(both).lower(state0, batch).compile(
            compiler_options={"xla_backend_optimization_level": 0,
                              "xla_llvm_disable_expensive_passes": True})
        out = jax.tree_util.tree_map(np.asarray, compiled(state0, batch))
    finally:
        jax_norms.FUSED_REFLECT = prev
    state1, gm, state2, dm = out
    k = int(jopts.train.get("grad_accumulation", 1) or 1)
    return dict(
        topts=load_opts(default=jopts.to_dict()), batch=batch,
        states=tuple(moments_only(st) for st in (
            jax.tree_util.tree_map(np.asarray, state0), state1, state2)),
        metrics=(gm, dm),
        draws=step_draws(key, jb.cfg.soft_shift, jb.cfg.flip_prob),
        aug=(step_aug_draws(key, n // k, SIZE, SIZE)
             if jb.cfg.p_diff_aug_use else (None, None)),
        lr=(jb.g_lr, jb.d_lr))


# each JAX run's numpy results are computed once per test session and
# shared by the xdist workers (``once_per_session``)
@pytest.fixture(scope="module")
def combined(tmp_path_factory):
    return once_per_session(tmp_path_factory, "torch_port_combined",
                            lambda: _run_jax(COMBINED, 2))


@pytest.fixture(scope="module")
def accumulated(tmp_path_factory):
    return once_per_session(tmp_path_factory, "torch_port_accumulated",
                            lambda: _run_jax(ACCUMULATED, 4, seed=2))


def _models(topts, jstate):
    G = OmniGenerator(GenConfig.from_opts(topts))
    G.load_state_dict(state_dict_from_jax(
        {"params": jstate.g_params, **jstate.g_state}, G.cfg))
    D = OmniDiscriminator(DisConfig.from_opts(topts))
    D.load_state_dict(d_state_dict_from_jax(
        {"params": jstate.d_params, **jstate.d_state}, D.cfg))
    return G, D


def _moments(topts, jstate):
    G, D = _models(topts, jstate)
    return (state_dict_from_jax({"params": jstate.g_opt.mu,
                                 **jstate.g_state}, G.cfg),
            d_state_dict_from_jax({"params": jstate.d_opt.mu,
                                   **jstate.d_state}, D.cfg))


def _check_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   atol=1e-9, err_msg=k)


def _hold_step(run, name, devices=None, held=None):
    """The port's ``name`` step from JAX's state before it (over the row
    shards' ``devices``, if given), held to JAX's state after it: the
    stepped model by its moments (its parameters ``held``, default all),
    the other one's statistics and u/v advanced and its parameters
    untouched."""
    i = 0 if name == "g_step" else 1
    G, D = _models(run["topts"], run["states"][i])
    builder = StepBuilder(run["topts"])
    state, metrics = getattr(builder, name)(
        builder.state_for(G, D), port_batch(run["batch"]),
        draws=run["draws"][i], aug=run["aug"][i], devices=devices)
    _check_metrics(metrics, run["metrics"][i])
    want = _models(run["topts"], run["states"][i + 1])
    mu = _moments(run["topts"], run["states"][i + 1])[i]
    got = (G, D)
    opt = (state.g_opt, state.d_opt)[i]
    what = f"{name} {'GD'[i]}" + ("" if devices is None
                                    else f" over {len(devices)} shards")
    print(hold_state(got[i], want[i].state_dict(), run["lr"][i],
                     first_moments(got[i], opt), mu, what=what, held=held))
    hold_state(got[1 - i], want[1 - i].state_dict(),
               what=f"{name} {'GD'[1 - i]}")
    return metrics


@pytest.mark.parametrize("name", ["g_step", "d_step"])
def test_combined_options_match_jax(combined, name):
    """Local D + pl4m + WGAN-GP (m and s) + DiffAugment: each step's
    losses (pl4m's, the penalties) and models against JAX's."""
    metrics = _hold_step(combined, name)
    assert {"g_step": "m_pl4m", "d_step": "m_gp_s"}[name] in metrics


@pytest.mark.parametrize("name", ["g_step", "d_step"])
def test_combined_options_over_two_shards_match_jax(combined, name):
    """The same steps row-sharded (ROADMAP A.11b-2b), each image's rows
    over ["cpu"] * 2: the local Ds, pl4m's frozen painter, the penalties'
    norms and the augmentation on rows, held to JAX's states at the same
    bars: all of D, and G above the layer3.0 ReLU kink that the split's
    batch norms (float64 sums over the shards) cross on this seed-0 batch
    as on tests/test_torch_port_train.py's (layer3.0's bn3 and downsample
    first moments 4.7-5.5% of their largest from JAX's; every other leaf
    of G within 6e-3). tests/test_torch_port_spatial_train.py holds all of
    G against the unsharded step in float64."""
    held = (lambda k: k.startswith(ABOVE_THE_KINK)) if name == "g_step" \
        else None
    metrics = _hold_step(combined, name, devices=["cpu"] * 2, held=held)
    assert {"g_step": "m_pl4m", "d_step": "m_gp_s"}[name] in metrics


@pytest.mark.parametrize("name", ["g_step", "d_step"])
def test_grad_accumulation_matches_jax(accumulated, name):
    """train.grad_accumulation: 2 at batch 4: two micro-batches, each from
    the step's initial statistics and u/v, averaged."""
    _hold_step(accumulated, name)


def test_two_gloo_ranks_accumulate_as_jax_does_on_the_global_batch(
        accumulated):
    """Data parallel with ``train.grad_accumulation: 2`` at batch 4: two
    gloo ranks on the CPU, each on its row of each global micro-batch
    (``shard_batch(..., micro=2)``), take ``g_step`` and ``d_step`` from
    JAX's states before each; both are held to JAX's steps on the global
    batch as the one-process steps are (each micro-batch's batch norms
    over both ranks' rows, the gradients averaged over the micro-batches
    and summed over the ranks), and both ranks end with the same state.
    In the same ranks, the same two steps with ``tpu.remat`` and
    ``tpu.remat_d``: each held by ``hold_state`` to the one-process remat
    step from the same state on the global batch, so the rematerialized
    forwards' batch norms take their collectives as the first forwards
    do; and those remat steps hybrid, each rank's rows over two row
    shards (ROADMAP A.11b-2b), held to the same one-process steps."""
    run = accumulated
    remat_opts = load_opts(default=_jopts({**ACCUMULATED, "tpu": {
        "remat": True, "remat_d": True}}).to_dict())
    jobs = []
    for extra, rows in (((), {}), ((remat_opts,), {}),
                        ((remat_opts,), {"devices": ["cpu", "cpu"]})):
        for i, name in enumerate(("g_step", "d_step")):
            G, D = _models(run["topts"], run["states"][i])
            jobs.append((name, G.state_dict(), D.state_dict(),
                         {"draws": run["draws"][i], "aug": run["aug"][i],
                          **rows}, *extra))
    got = run_ranks("tests.torch_port_ranks:steps", 2,
                    {"opts": run["topts"], "batch": port_batch(run["batch"]),
                     "jobs": jobs},
                    devices=["cpu", "cpu"], backend="gloo", timeout=240)
    assert [r["digest"] for r in got[1]] == [r["digest"] for r in got[0]]
    _hold_remat_ranks(run, remat_opts, {"2 ranks": got[0][2:4],
                                        "2 ranks x 2 shards": got[0][4:6]})
    for i, (name, res) in enumerate(zip(("g_step", "d_step"), got[0])):
        _check_metrics(res["metrics"], run["metrics"][i])
        G, D = _models(run["topts"], run["states"][i])
        G.load_state_dict(res["G"])
        D.load_state_dict(res["D"])
        want = _models(run["topts"], run["states"][i + 1])
        mu = _moments(run["topts"], run["states"][i + 1])[i]
        got_mu = (res["g_mu"], res["d_mu"])[i]
        stepped, other = ((G, D), (D, G))[i]
        print(hold_state(stepped, want[i].state_dict(), run["lr"][i], got_mu,
                         mu, what=f"{name} on 2 ranks"))
        hold_state(other, want[1 - i].state_dict(),
                   what=f"{name} on 2 ranks, the other model")


def _hold_remat_ranks(run, remat_opts, results):
    """The ranks' remat g_step and d_step (rank 0's, by layout in
    ``results``), each from JAX's state before it, against the one-process
    remat steps from the same states on the global batch: losses within
    1e-4 relative, the stepped model by ``hold_state`` with its first
    moments, the other one by ``hold_state`` without."""
    builder = StepBuilder(remat_opts)
    assert builder.remat and builder.remat_d
    for i, name in enumerate(("g_step", "d_step")):
        G, D = _models(run["topts"], run["states"][i])
        state, metrics = getattr(builder, name)(
            builder.state_for(G, D), port_batch(run["batch"]),
            draws=run["draws"][i], aug=run["aug"][i])
        want = (G, D)
        mu = first_moments(want[i], (state.g_opt, state.d_opt)[i])
        for layout, pair in results.items():
            res = pair[i]
            _check_metrics(res["metrics"],
                           {k: float(v) for k, v in metrics.items()})
            got = _models(run["topts"], run["states"][i])
            got[0].load_state_dict(res["G"])
            got[1].load_state_dict(res["D"])
            print(hold_state(got[i], want[i].state_dict(), run["lr"][i],
                             (res["g_mu"], res["d_mu"])[i], mu,
                             what=f"remat {name} on {layout}"))
            hold_state(got[1 - i], want[1 - i].state_dict(),
                       what=f"remat {name} on {layout}, the other model")


# ---- the pieces alone --------------------------------------------------

def _images(n=3, h=24, w=40, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, h, w, 3)) \
        .astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("fn", ["brightness", "contrast", "saturation",
                                "translation", "cutout", "all"])
def test_diff_aug_matches_jax(fn):
    """Each augmentation (and DiffTransforms with all three on) on fed
    draws against JAX's on the same key, at a non-square size, where the
    row and column ranges differ."""
    x = _images()
    n, h, w, _ = x.shape
    key = jax.random.PRNGKey(5)
    draws = jax_aug_draws(key, n, h, w)
    keys = jax.random.split(key, 5)
    if fn == "all":
        want = jax_aug.DiffTransforms(DIFF_AUG)(key, jnp.asarray(x))
        got = diff_aug.DiffTransforms.from_opts(DIFF_AUG)(_nchw(x), draws)
    elif fn in ("brightness", "contrast", "saturation"):
        i = ("brightness", "contrast", "saturation").index(fn)
        want = getattr(jax_aug, f"rand_{fn}")(keys[i], jnp.asarray(x))
        got = getattr(diff_aug, f"rand_{fn}")(_nchw(x), draws[fn])
    elif fn == "translation":
        want = jax_aug.rand_translation(keys[3], jnp.asarray(x))
        got = diff_aug.rand_translation(_nchw(x), draws["tx"], draws["ty"])
    else:
        want = jax_aug.rand_cutout(keys[4], jnp.asarray(x))
        got = diff_aug.rand_cutout(_nchw(x), draws["ox"], draws["oy"])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-6)


def test_diff_aug_draws_lie_in_jax_ranges():
    """The port's own draws take JAX's ranges: shifts in [-sh, sh] rows and
    [-sw, sw] columns, cutout centres in [0, h + 1 - ch % 2)."""
    t = diff_aug.DiffTransforms.from_opts(DIFF_AUG)
    d = t.draw(4000, 24, 40, torch.Generator().manual_seed(0))
    sh, sw = diff_aug.translation_shifts(24, 40)
    ch, cw = diff_aug.cutout_sizes(24, 40)
    assert (d["tx"].min(), d["tx"].max()) == (-sh, sh)
    assert (d["ty"].min(), d["ty"].max()) == (-sw, sw)
    assert (d["ox"].min(), d["ox"].max()) == (0, 24 - ch % 2)
    assert (d["oy"].min(), d["oy"].max()) == (0, 40 - cw % 2)
    assert all(0 <= d[k].min() and d[k].max() < 1
               for k in ("brightness", "contrast", "saturation"))


def test_wgan_gp_matches_jax():
    """``losses.wgan_gp`` on one FC discriminator (no spectral norm, as
    under WGAN_gp) against JAX's ``_wgan_gp``: the penalty, and its
    gradient in the discriminator's weights (a second-order product)."""
    from climategan_tpu.models.discriminator import (
        FCDiscriminator as JaxFC,
    )
    from climategan_tpu.train_step import _wgan_gp
    from climategan_torch import losses as L
    from tests.torch_port_common import fill_like

    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 2)) \
        .astype(np.float32)
    jd = JaxFC(use_norm=False)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct(x.shape, jnp.float32))
    variables = fill_like(shapes, 4)

    def penalty(params):
        return _wgan_gp(lambda v: jd.apply({"params": params}, v),
                        jnp.asarray(x))

    want, want_g = jax.value_and_grad(penalty)(variables["params"])
    td = FCDiscriminator(2, use_norm=False)
    sd = d_state_dict_from_jax(
        {"params": {"m_advent": variables["params"]}},
        DisConfig(tasks=("m",), m_wgan_norm=False, s_use_advent=False))
    td.load_state_dict({k[len("m_advent."):]: v for k, v in sd.items()})
    got = L.wgan_gp(td, _nchw(x))
    got_g = dict(zip([n for n, _ in td.named_parameters()],
                     torch.autograd.grad(got, list(td.parameters()),
                                         allow_unused=True)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for i in range(5):
        np.testing.assert_allclose(
            got_g[f"conv{i}.weight"].permute(2, 3, 1, 0).numpy(),
            np.asarray(want_g[f"conv{i}"]["kernel"]), rtol=1e-5,
            atol=1e-5 * float(np.abs(want_g[f"conv{i}"]["kernel"]).max()),
            err_msg=f"conv{i}")


def test_remat_policy_predicates():
    """The twin of tests/test_train_step.py's: ``small_convs`` saves a
    convolution by its input's area, every policy saves the matrix
    products, "" and "full" save nothing, an unknown name raises."""
    aten = torch.ops.aten
    assert make_remat_policy("") is None
    assert make_remat_policy("full") is None
    with pytest.raises(ValueError):
        make_remat_policy("bogus")
    small, mid = torch.zeros(1, 3, 8, 8), torch.zeros(1, 3, 160, 160)
    big = torch.zeros(1, 3, 64, 64)
    pol = make_remat_policy("small_convs:100")
    assert pol(aten.convolution.default, small)
    assert not pol(aten.convolution.default, big)
    assert pol(aten.mm.default, small)
    assert not pol(aten.add.Tensor, small)
    assert make_remat_policy("small_convs")(aten.convolution.default, mid)
    dots = make_remat_policy("dots")
    assert dots(aten.convolution.default, big) and dots(aten.addmm.default)
    assert not dots(aten.relu.default, big)


def _state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("policy", ["", "dots", "small_convs"])
def test_remat_step_equals_the_plain_step(policy):
    """tpu.remat + tpu.remat_d (with the combined options, so that pl4m,
    the local Ds and the penalties run in rematerialized forwards): the
    step's losses and parameters within 1e-6 of the plain step's, every
    statistic and u/v bit-equal to the plain step's, advanced once."""
    plain_opts = load_opts(default=_jopts(COMBINED).to_dict())
    remat_opts = load_opts(default=_jopts({**COMBINED, "tpu": {
        "remat": True, "remat_d": True, "remat_policy": policy}}).to_dict())
    batch = synthetic_batch(2, SIZE, 32, "cpu")
    out = {}
    for what, opts in (("plain", plain_opts), ("remat", remat_opts)):
        builder = StepBuilder(opts)
        assert builder.remat == builder.remat_d == (what == "remat")
        state = builder.init_state(seed=0, device="cpu")
        before = _state(state.G)
        state, metrics = builder.train_step(state, batch)
        out[what] = (metrics, _state(state.G), _state(state.D))
    (pm, pg, pd), (rm, rg, rd) = out["plain"], out["remat"]
    assert set(pm) == set(rm)
    for k in pm:
        np.testing.assert_allclose(float(rm[k]), float(pm[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    advanced = 0
    for want, got in ((pg, rg), (pd, rd)):
        for k, v in want.items():
            if k.rsplit(".", 1)[-1] in STATE_BUFFERS:
                assert torch.equal(got[k], v), k
                advanced += k in before and not torch.equal(v, before[k])
            else:
                torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6,
                                           msg=k)
    assert advanced > 0


def test_pl4m_gradient_reaches_the_mask_not_the_painter(monkeypatch):
    """pl4m's loss gives the mask decoder a nonzero gradient and the
    painter none; its paint never calls spade_cond (no backward) and
    writes no statistic or u/v of the painter."""
    from climategan_torch.models import norms

    def refuse(*args):
        raise AssertionError("pl4m's paint reached spade_cond")

    monkeypatch.setattr(norms, "spade_cond_packed", refuse)
    opts = load_opts(default=_jopts(
        {"gen": {"m": {"use_pl4m": True},
                 "p": {"spade_param_free_norm": "batch"}}}).to_dict())
    builder = StepBuilder(opts)
    state = builder.init_state(seed=0, device="cpu")
    G, D = state.G, state.D
    painter_state = _state(G.painter)
    batch = synthetic_batch(2, SIZE, 32, "cpu")
    _, metrics = builder._masker_losses(G, D, batch["r"], "r", "G",
                                        (0.1, False), True)
    for k, v in _state(G.painter).items():
        assert torch.equal(v, painter_state[k]), k
    names = [n for n, _ in G.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(
        metrics["m_pl4m"], list(G.parameters()), allow_unused=True)))
    mask = [n for n in names if n.startswith("decoders.m.")]
    assert mask and all(grads[n] is not None for n in mask)
    assert max(float(grads[n].abs().max()) for n in mask) > 0
    assert all(grads[n] is None for n in names if n.startswith("painter."))
