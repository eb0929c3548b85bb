"""The port's training step against the JAX package's, on the CPU in f32.

One module-scope fixture runs the JAX ``g_step`` and then ``d_step`` (one
``train_step``) at ``tiny_opts(32)`` with ``train.bf16: false``, from
weights drawn with numpy, under one ``jax.jit``. The JAX package's exact
TPU rewrites are off there (``tpu.painter_s2d`` and ``FUSED_REFLECT``,
which ``tests/test_s2d.py`` shows give the same values); the port has
neither, and the graph then compiles in about 30 s instead of 65. The JAX
draws come from splitting the state's key as the two steps do, and reach
the port through ``draws=``. Its numpy results are computed once per test
session and shared by the xdist workers (``once_per_session``).

Bars: every loss of the metrics within 1e-4 relative; the models after
each step held to JAX's by ``climategan_torch.utils.step_check.hold_state``
(its docstring gives the bars and why: the optimizers' first moments leaf
by leaf, every value whose gradient is not rounding noise within 1e-6, at
least 99.9% of each model's values within 1e-6, the noise values within
2 lr and counted, the batch-norm running statistics and the spectral u/v
within 1e-5). Each step is held from the same state on both sides: the u/v
that a step advances from weights the other step updated inherit the
noise values' differences.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climategan_tpu.models.norms as jax_norms
from climategan_tpu import optim as JO
from climategan_tpu.train_step import StepBuilder as JaxStepBuilder
from climategan_tpu.train_step import TrainState as JaxTrainState
from climategan_tpu.utils.testing import tiny_opts
from climategan_torch.models.discriminator import DisConfig, OmniDiscriminator
from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.optim import build_lr_scales
from climategan_torch.parallel.spawn import run_ranks
from climategan_torch.train_step import StepBuilder
from climategan_torch.utils.convert import (
    d_state_dict_from_jax,
    state_dict_from_jax,
)
from climategan_torch.utils.opts import load_opts
from climategan_torch.utils.step_check import first_moments, hold_state
from tests.test_torch_port_step_options import seeded_batch
from tests.test_train_step import _batch
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    ABOVE_THE_KINK,
    gan_draws,
    jax_d_variables,
    jax_variables,
    moments_only,
    once_per_session,
    one_thread,
    port_batch,
    step_draws,
)

SIZE = 32


def _split(variables):
    return (variables["params"],
            {k: v for k, v in variables.items() if k != "params"})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX states before, between and after the two steps, their
    metrics, the draws, the batch, the port's opts and ``seeded``: the
    compiled steps' outputs from the same state on ``seeded_batch(2, 2)``;
    numpy trees, computed once per session (``once_per_session``)."""
    return once_per_session(tmp_path_factory, "torch_port_train_run",
                            _jax_run)


def _jax_run():
    jopts = tiny_opts(SIZE)
    jopts.train.bf16 = False
    jopts.tpu.painter_s2d = False
    prev = jax_norms.FUSED_REFLECT
    jax_norms.FUSED_REFLECT = False
    try:
        jb = JaxStepBuilder(jopts)
        _, gvars = jax_variables(jopts, SIZE, seed=0)
        _, dvars = jax_d_variables(jopts, SIZE, seed=1)
        gp, gs = _split(gvars)
        dp, ds = _split(dvars)
        key = jax.random.PRNGKey(0)
        state0 = JaxTrainState(gp, gs, dp, ds, jb.g_opt_init(gp),
                               jb.d_opt_init(dp), jnp.zeros((), jnp.int32),
                               key)
        batch = _batch(2, SIZE)

        def both(state, batch):
            state1, gm = jb.g_step(state, batch, 1.0)
            state2, dm = jb.d_step(state1, batch, 1.0)
            return state1, gm, state2, dm, jb.eval_losses(state, batch)

        compiled = jax.jit(both).lower(state0, batch).compile(
            compiler_options={"xla_backend_optimization_level": 0,
                              "xla_llvm_disable_expensive_passes": True})

        def steps(batch):
            state1, gm, state2, dm, val = jax.tree_util.tree_map(
                np.asarray, compiled(state0, batch))
            return (moments_only(state1), gm, moments_only(state2), dm, val)

        out = steps(batch)
        seeded = steps(seeded_batch(2, 2))
    finally:
        jax_norms.FUSED_REFLECT = prev
    state1, gm, state2, dm, val = out
    topts = load_opts(default=jopts.to_dict())
    return dict(
        topts=topts, batch=batch,
        states=(jax.tree_util.tree_map(np.asarray, state0), state1, state2),
        seeded=seeded,
        metrics=(gm, dm, val),
        eval_draws=gan_draws(jax.random.PRNGKey(0), jb.cfg.soft_shift,
                             jb.cfg.flip_prob),
        draws=step_draws(key, jb.cfg.soft_shift, jb.cfg.flip_prob),
        lr=(jb.g_lr, jb.d_lr))


def _models(topts, jstate):
    """Port G and D holding a JAX TrainState's parameters and
    collections."""
    G = OmniGenerator(GenConfig.from_opts(topts))
    G.load_state_dict(state_dict_from_jax(
        {"params": jstate.g_params, **jstate.g_state}, G.cfg))
    D = OmniDiscriminator(DisConfig.from_opts(topts))
    D.load_state_dict(d_state_dict_from_jax(
        {"params": jstate.d_params, **jstate.d_state}, D.cfg))
    return G, D


def _check_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   atol=1e-9, err_msg=k)


def _moments(topts, jstate):
    """JAX's first moments of G and D under the port's parameter names."""
    G, D = _models(topts, jstate)
    return (state_dict_from_jax({"params": jstate.g_opt.mu,
                                 **jstate.g_state}, G.cfg),
            d_state_dict_from_jax({"params": jstate.d_opt.mu,
                                   **jstate.d_state}, D.cfg))


def test_g_step_matches_jax(run):
    state0, state1, _ = run["states"]
    G, D = _models(run["topts"], state0)
    builder = StepBuilder(run["topts"])
    state, metrics = builder.g_step(builder.state_for(G, D),
                                    port_batch(run["batch"]),
                                    draws=run["draws"][0])
    _check_metrics(metrics, run["metrics"][0])
    want_g, want_d = _models(run["topts"], state1)
    print(hold_state(G, want_g.state_dict(), run["lr"][0],
                     first_moments(G, state.g_opt),
                     _moments(run["topts"], state1)[0], what="G"))
    # D: its u/v advanced, its parameters untouched
    hold_state(D, want_d.state_dict(), what="D")


def test_d_step_matches_jax(run):
    _, state1, state2 = run["states"]
    G, D = _models(run["topts"], state1)
    builder = StepBuilder(run["topts"])
    state, metrics = builder.d_step(builder.state_for(G, D),
                                    port_batch(run["batch"]),
                                    draws=run["draws"][1])
    assert state.step == 1
    _check_metrics(metrics, run["metrics"][1])
    want_g, want_d = _models(run["topts"], state2)
    print(hold_state(D, want_d.state_dict(), run["lr"][1],
                     first_moments(D, state.d_opt),
                     _moments(run["topts"], state2)[1], what="D"))
    # G: statistics and u/v advanced by the D step's forwards, parameters
    # untouched
    hold_state(G, want_g.state_dict(), what="G")


def test_train_step_matches_jax(run):
    state0, _, state2 = run["states"]
    G, D = _models(run["topts"], state0)
    builder = StepBuilder(run["topts"])
    state, metrics = builder.train_step(builder.state_for(G, D),
                                        port_batch(run["batch"]),
                                        draws=run["draws"])
    _check_metrics(metrics, {**run["metrics"][0], **run["metrics"][1]})
    want_g, want_d = _models(run["topts"], state2)
    g_mu, d_mu = _moments(run["topts"], state2)
    print(hold_state(G, want_g.state_dict(), run["lr"][0],
                     first_moments(G, state.g_opt), g_mu, stats=False,
                     what="G"))
    print(hold_state(D, want_d.state_dict(), run["lr"][1],
                     first_moments(D, state.d_opt), d_mu, stats=False,
                     what="D"))




def test_two_shard_train_step_matches_jax(run):
    """Row-sharded (ROADMAP A.11b-2): the port's ``train_step`` with each
    image's rows over ["cpu"] * 2 (the os8 maps 2 rows a shard, the
    painter's first map one row on the second shard) against JAX's
    ``train_step`` from the same state at ``test_train_step_matches_jax``'s
    bars, all of G and D held. It runs on ``seeded_batch(2, 2)``: on the
    fixture's batch the shards' batch norms, whose statistics come from
    float64 sums over the shards as the data-parallel ranks' do, put a
    layer3.0 pre-activation on the other side of its ReLU kink and
    encoder.conv1's first moment 1.4e-3 of its largest from JAX's
    (ROADMAP C)."""
    batch = seeded_batch(2, 2)
    _, gm, state2, dm, _ = run["seeded"]
    G, D = _models(run["topts"], run["states"][0])
    builder = StepBuilder(run["topts"])
    state, metrics = builder.train_step(builder.state_for(G, D),
                                        port_batch(batch),
                                        draws=run["draws"],
                                        devices=["cpu"] * 2)
    _check_metrics(metrics, {**gm, **dm})
    want_g, want_d = _models(run["topts"], state2)
    g_mu, d_mu = _moments(run["topts"], state2)
    print(hold_state(G, want_g.state_dict(), run["lr"][0],
                     first_moments(G, state.g_opt), g_mu, stats=False,
                     what="2 shards: G"))
    print(hold_state(D, want_d.state_dict(), run["lr"][1],
                     first_moments(D, state.d_opt), d_mu, stats=False,
                     what="2 shards: D"))


def test_two_gloo_ranks_step_as_jax_does_on_the_global_batch(run):
    """Data parallel: two gloo ranks on the CPU, one row of each domain per
    rank, take ``g_step`` and ``d_step`` from JAX's states before each, on
    their rows (the batch norms' statistics, the losses' medians and shares
    over the global batch; the gradients summed over the ranks; the
    spectral u/v from equal weights), and both ranks end each step with
    the same state. Every loss is within 1e-4 of JAX's; ``d_step`` is held
    to JAX's in full by ``hold_state``, ``g_step``'s statistics, u/v and D
    too. This batch puts one pre-activation at a ReLU kink: layer3.0's
    output on s, 8.8e-7 in float64, 9.0e-7 in JAX and in one process,
    -6.0e-7 on two ranks, whose convolutions run on one row (oneDNN's f32
    rounding depends on the batch size). The kink moves the gradients of
    the encoder below layer4 by up to 5.5% of a leaf's largest, so
    ``g_step``'s parameters are held above it (ROADMAP C). The same two
    ranks also take each step hybrid (ROADMAP A.11b-2): each rank's rows
    split again over two row shards, held to JAX's steps on the global
    batch at the same bars."""
    jobs = []
    for i, name in enumerate(("g_step", "d_step")):
        G, D = _models(run["topts"], run["states"][i])
        jobs.append((name, G.state_dict(), D.state_dict(),
                     {"draws": run["draws"][i]}))
        # hybrid: each rank's rows split again over two row shards
        jobs.append((name, G.state_dict(), D.state_dict(),
                     {"draws": run["draws"][i], "devices": ["cpu", "cpu"]}))
    got = run_ranks("tests.torch_port_ranks:steps", 2,
                    {"opts": run["topts"], "batch": port_batch(run["batch"]),
                     "jobs": jobs},
                    devices=["cpu", "cpu"], backend="gloo", timeout=120)
    assert [r["digest"] for r in got[1]] == [r["digest"] for r in got[0]]
    g_res, hybrid_g, d_res, hybrid_d = got[0]
    for i, res in enumerate(got[0]):
        _check_metrics(res["metrics"], run["metrics"][i // 2])
    want_g1, want_d1 = _models(run["topts"], run["states"][1])
    want_g2, want_d2 = _models(run["topts"], run["states"][2])
    g_mu = _moments(run["topts"], run["states"][1])[0]
    d_mu = _moments(run["topts"], run["states"][2])[1]

    G, D = _models(run["topts"], run["states"][1])
    for res, what in ((d_res, "d_step on 2 ranks"),
                      (hybrid_d, "d_step on 2 ranks x 2 shards")):
        G.load_state_dict(res["G"])
        D.load_state_dict(res["D"])
        print(hold_state(D, want_d2.state_dict(), run["lr"][1], res["d_mu"],
                         d_mu, what=f"{what}: D"))
        hold_state(G, want_g2.state_dict(), what=f"{what}: G")

    for res, what in ((g_res, "g_step on 2 ranks"),
                      (hybrid_g, "g_step on 2 ranks x 2 shards")):
        G.load_state_dict(res["G"])
        D.load_state_dict(res["D"])
        hold_state(D, want_d1.state_dict(), what=f"{what}: D")
        print(hold_state(G, want_g1.state_dict(), run["lr"][0], res["g_mu"],
                         g_mu, what=f"{what}: G above the kink",
                         held=lambda k: k.startswith(ABOVE_THE_KINK)))


def test_hold_state_catches_a_leaf_stepped_the_wrong_way(run):
    """The step's bars see one small leaf gone wrong: a leaf whose update
    is reversed, or whose gradient has the wrong sign, fails
    ``hold_state`` (the painter's output conv, a batch-norm bias of the
    encoder, an ADVENT output conv, a painter-D input bias)."""
    state0, _, state2 = run["states"]
    G, D = _models(run["topts"], state0)
    before = {**{"G." + k: v.detach().clone() for k, v in G.named_parameters()},
              **{"D." + k: v.detach().clone() for k, v in D.named_parameters()}}
    builder = StepBuilder(run["topts"])
    state, _ = builder.train_step(builder.state_for(G, D),
                                  port_batch(run["batch"]),
                                  draws=run["draws"])
    want_g, want_d = _models(run["topts"], state2)
    g_mu, d_mu = _moments(run["topts"], state2)
    cases = (("G", G, state.g_opt, want_g, g_mu, run["lr"][0],
              ["painter.conv_img.bias", "encoder.bn1.bias"]),
             ("D", D, state.d_opt, want_d, d_mu, run["lr"][1],
              ["s_advent.conv4.module.weight_bar",
               "p.discriminator_0.conv0.module.bias"]))
    for net, module, opt, want, want_mu, lr, names in cases:
        params = dict(module.named_parameters())
        for name in names:
            p = params[name]
            stepped = p.detach().clone()
            with torch.no_grad():
                p.copy_(2 * before[f"{net}.{name}"] - stepped)
            with pytest.raises(AssertionError, match=name):
                hold_state(module, want.state_dict(), lr,
                           first_moments(module, opt), want_mu, stats=False)
            with torch.no_grad():
                p.copy_(stepped)
            flipped = dict(first_moments(module, opt))
            flipped[name] = -flipped[name]
            with pytest.raises(AssertionError, match=name):
                hold_state(module, want.state_dict(), lr, flipped, want_mu,
                           stats=False)
        hold_state(module, want.state_dict(), lr, first_moments(module, opt),
                   want_mu, stats=False)


def test_eval_losses_match_jax(run):
    """Validation losses in eval mode (running statistics, baked spectral
    kernels, packed SPADEs), with JAX's fixed draws; the models go back to
    train mode."""
    G, D = _models(run["topts"], run["states"][0])
    builder = StepBuilder(run["topts"])
    state = builder.state_for(G, D)
    got = builder.eval_losses(state, port_batch(run["batch"]),
                              draws=run["eval_draws"])
    _check_metrics(got, run["metrics"][2])
    assert G.training and D.training


# the painter's validation losses in bf16 against JAX's, relative: the
# painter runs in bf16 on both sides (XLA's bf16 convs; the port's bf16
# spade_cond packs, their plain version here), so the losses differ by the
# two painters' bf16 roundings (unit roundoff 3.9e-3): measured 1.47e-3 on
# p_gan, 6.1e-4 on p_featmatch, 4.6e-4 on the total (CPU, one thread)
BF16_EVAL_RTOL = 1e-2


def test_eval_losses_bf16_match_jax(run):
    """With ``train.bf16`` the validation painter runs in bf16, as JAX's
    ``eval_losses`` casts it (the masker stays f32): the rf losses against
    JAX's at a bf16 tolerance, and not equal to the f32 painter's."""
    jopts = tiny_opts(SIZE)
    jopts.train.bf16 = True
    jopts.tpu.painter_s2d = False
    prev = jax_norms.FUSED_REFLECT
    jax_norms.FUSED_REFLECT = False
    try:
        jb = JaxStepBuilder(jopts)
        rf = {"rf": run["batch"]["rf"]}
        want = jax.tree_util.tree_map(np.asarray, jax.jit(jb.eval_losses)(
            run["states"][0], rf))
    finally:
        jax_norms.FUSED_REFLECT = prev
    topts = load_opts(default=jopts.to_dict())
    G, D = _models(topts, run["states"][0])
    builder = StepBuilder(topts)
    assert builder.cfg.bf16
    got = builder.eval_losses(builder.state_for(G, D), port_batch(rf),
                              draws=run["eval_draws"])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v),
                                   rtol=BF16_EVAL_RTOL, err_msg=k)
    f32 = run["metrics"][2]
    assert float(got["val_p_featmatch"]) != float(f32["val_p_featmatch"])
    assert G.training and D.training


@pytest.mark.parametrize("flag", ["--mesh", "--remat", "--remat_d"])
def test_bench_train_refuses_what_is_not_ported(flag, capsys):
    """``--mesh`` (data parallel over the cards) parses without a card and
    keeps the step's opts; ``--remat`` and ``--remat_d`` parse into
    ``tpu.remat`` and ``tpu.remat_d``, with ``--policy`` into
    ``tpu.remat_policy``."""
    from climategan_torch import bench_train

    if flag == "--mesh":
        args = bench_train.parse_args([flag, "--batch", "4"])
        assert args.mesh and args.batch == 4
        assert not bench_train.step_opts(args).tpu.remat
        assert capsys.readouterr().err == ""
        return
    opts = bench_train.step_opts(bench_train.parse_args(
        [flag, "--policy", "dots"]))
    assert opts.tpu.remat == (flag == "--remat")
    assert opts.tpu.remat_d == (flag == "--remat_d")
    assert opts.tpu.remat_policy == "dots"
    builder = StepBuilder(opts)
    assert (builder.remat, builder.remat_d) == (opts.tpu.remat,
                                                opts.tpu.remat_d)


def test_bench_train_batch_is_the_root_benchs():
    """The port bench's synthetic batch is the root bench_train.py's (and
    the JAX step tests' ``_batch``): the same numpy draws in NCHW."""
    from climategan_torch.bench_train import synthetic_batch

    want = port_batch(_batch(2, 64))
    got = synthetic_batch(2, 64, 32, "cpu")
    for dom in want:
        for k in want[dom]:
            assert torch.equal(got[dom][k], want[dom][k]), (dom, k)


def _jax_params_scales(jtree, rules):
    """JAX build_lr_scales as full arrays, for the weights map."""
    scales = JO.build_lr_scales(jtree, rules)
    return jax.tree_util.tree_map(lambda p, s: np.full(p.shape, s, np.float32),
                                  jtree, scales)


def test_lr_groups_match_jax(run):
    """Per-task learning rates: each port parameter gets the multiplier
    JAX gives the same parameter, for G and D."""
    jopts = tiny_opts(SIZE)
    jopts.gen.opt.lr = {"default": 1e-4, "m": 2e-4, "d": 3e-4, "s": 5e-5, "p": 1e-5}
    jopts.dis.opt.lr = {"default": 2e-5, "p": 4e-5, "m": 1e-5}
    jb = JaxStepBuilder(jopts)
    tb = StepBuilder(load_opts(default=jopts.to_dict()))
    state0 = run["states"][0]
    G, D = _models(run["topts"], state0)
    want_g = state_dict_from_jax(
        {"params": _jax_params_scales(state0.g_params, jb.g_lr_rules),
         **state0.g_state}, G.cfg)
    want_d = d_state_dict_from_jax(
        {"params": _jax_params_scales(state0.d_params, jb.d_lr_rules),
         **state0.d_state}, D.cfg)
    for module, rules, want in ((G, tb.g_lr_rules, want_g),
                                (D, tb.d_lr_rules, want_d)):
        names = [n for n, _ in module.named_parameters()]
        got = build_lr_scales(names, rules)
        assert len(set(got)) > 1
        for n, s in zip(names, got):
            assert np.allclose(want[n].numpy(), s), n


def test_gradients_reach_the_painter_and_the_spectral_weights(run):
    """The painter's SPADE conditioning, its spectral weight_bar and the
    mask decoder's get a nonzero gradient from the G losses (through the
    paste's autograd on the card, through the plain blend here)."""
    G, D = _models(run["topts"], run["states"][0])
    builder = StepBuilder(run["topts"])
    state = builder.state_for(G, D)
    batch = port_batch(run["batch"])
    soft_flip = run["draws"][0]
    p_loss, _ = builder._painter_losses(G, D, batch["rf"], soft_flip, True)
    m_loss, _ = builder._masker_losses(G, D, batch["r"], "r", "G", soft_flip,
                                       True)
    names = ["painter.final_spade.norm_0.mlp_shared.0.weight",
             "painter.final_spade.conv_1.module.weight_bar",
             "painter.conv_img.weight",
             "decoders.m.proj_conv.conv.module.weight_bar"]
    params = dict(G.named_parameters())
    grads = torch.autograd.grad(p_loss + m_loss, [params[n] for n in names])
    for n, g in zip(names, grads):
        assert g.abs().max() > 0, n
    assert state.step == 0


def test_eval_after_a_step_rebakes_and_repacks(run):
    """After a step, eval() serves the trained weights: its forward equals
    that of a fresh model loaded from the trained state dict."""
    G, D = _models(run["topts"], run["states"][0])
    builder = StepBuilder(run["topts"])
    state, _ = builder.train_step(builder.state_for(G, D),
                                  port_batch(run["batch"]),
                                  draws=run["draws"])
    G.eval()
    fresh = OmniGenerator(G.cfg)
    fresh.load_state_dict(G.state_dict())
    fresh.eval()
    x = port_batch(run["batch"])["r"]["x"]
    with torch.no_grad():
        for a, b in zip(G.infer_masker(x), fresh.infer_masker(x)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        m = (x[:, :1] > 0).float()
        torch.testing.assert_close(G.paint(m, x), fresh.paint(m, x),
                                   rtol=0, atol=0)
    # and the trained model's eval forward is not the untrained one's
    before, _ = _models(run["topts"], run["states"][0])
    with torch.no_grad():
        assert not torch.equal(before.eval().paint(m, x), G.paint(m, x))
