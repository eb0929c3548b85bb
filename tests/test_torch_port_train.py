"""The port's training step against the JAX package's, on the CPU in f32.

One module-scope fixture runs the JAX ``g_step`` and then ``d_step`` (one
``train_step``) at ``tiny_opts(32)`` with ``train.bf16: false``, from
weights drawn with numpy, under one ``jax.jit``. The JAX package's exact
TPU rewrites are off there (``tpu.painter_s2d`` and ``FUSED_REFLECT``,
which ``tests/test_s2d.py`` shows give the same values); the port has
neither, and the graph then compiles in about 30 s instead of 65. The JAX
draws come from splitting the state's key as the two steps do, and reach
the port through ``draws=``.

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
from climategan_torch.train_step import StepBuilder
from climategan_torch.utils.convert import (
    d_state_dict_from_jax,
    state_dict_from_jax,
)
from climategan_torch.utils.opts import load_opts
from climategan_torch.utils.step_check import first_moments, hold_state
from tests.test_train_step import _batch
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    gan_draws,
    jax_d_variables,
    jax_variables,
    one_thread,
    port_batch,
    step_draws,
)

SIZE = 32


def _split(variables):
    return (variables["params"],
            {k: v for k, v in variables.items() if k != "params"})


@pytest.fixture(scope="module")
def run():
    """The JAX states before, between and after the two steps, their
    metrics, the draws, the batch and the port's opts."""
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
        out = jax.tree_util.tree_map(np.asarray, compiled(state0, batch))
    finally:
        jax_norms.FUSED_REFLECT = prev
    state1, gm, state2, dm, val = out
    topts = load_opts(default=jopts.to_dict())
    return dict(
        topts=topts, batch=batch, states=(state0, state1, state2),
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


@pytest.mark.parametrize("flag", ["--mesh", "--remat", "--remat_d"])
def test_bench_train_refuses_what_is_not_ported(flag, capsys):
    from climategan_torch import bench_train

    with pytest.raises(SystemExit):
        bench_train.parse_args([flag])
    assert "ROADMAP A." in capsys.readouterr().err


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
