"""The port's training step with the SPADE mask decoder (cond_nc 15, the
"SPADE masker cond_nc 15" entry of tests/test_scenarios.py) against the
JAX package's, on the CPU in f32 at tiny_opts(32).

As tests/test_torch_port_train.py does for the default configuration: one
module-scope fixture runs the JAX ``g_step`` and then ``d_step`` from
numpy-drawn weights under one ``jax.jit`` (``tpu.painter_s2d`` and
``FUSED_REFLECT`` off, XLA opt level 0; its numpy results computed once
per test session and shared by the xdist workers), the draws from the
state's key reach the port through ``draws=``, and each step is held from
the same state on both sides: every loss within 1e-4 relative, the models by
``climategan_torch.utils.step_check.hold_state`` (first moments leaf by
leaf, values whose gradient is not rounding noise within 1e-6, the
batch-norm statistics, the SPADEs' batch-norm statistics included, and the
spectral u/v within 1e-5). The mask loss runs on its conditioning
``make_m_cond(d, s, x)``, with the depth and seg heads' gradient in the G
step and stopped in the D step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import climategan_tpu.models.norms as jax_norms
from climategan_tpu.train_step import StepBuilder as JaxStepBuilder
from climategan_tpu.train_step import TrainState as JaxTrainState
from climategan_tpu.utils.opts import Opts, merge
from climategan_tpu.utils.testing import tiny_opts
from climategan_torch.models.discriminator import DisConfig, OmniDiscriminator
from climategan_torch.models.generator import GenConfig, OmniGenerator
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
    moments_only,
    once_per_session,
    one_thread,
    port_batch,
    step_draws,
)

SIZE = 32
SPADE_MASKER = {"gen": {"m": {"use_spade": True,
                              "spade": {"cond_nc": 15, "latent_dim": 32}}}}


def _split(variables):
    return (variables["params"],
            {k: v for k, v in variables.items() if k != "params"})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX states before, between and after the two steps, their
    metrics, the draws, the batch and the port's opts; numpy trees,
    computed once per session (``once_per_session``)."""
    return once_per_session(tmp_path_factory, "torch_port_spade_step",
                            _jax_run)


def _jax_run():
    jopts = tiny_opts(SIZE)
    merge(Opts(SPADE_MASKER), jopts)
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
    return dict(
        topts=load_opts(default=jopts.to_dict()), batch=batch,
        states=tuple(moments_only(st) for st in (
            jax.tree_util.tree_map(np.asarray, state0), state1, state2)),
        metrics=(gm, dm, val),
        eval_draws=gan_draws(key, jb.cfg.soft_shift, jb.cfg.flip_prob),
        draws=step_draws(key, jb.cfg.soft_shift, jb.cfg.flip_prob),
        lr=(jb.g_lr, jb.d_lr))


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


def test_g_step_matches_jax(run):
    state0, state1, _ = run["states"]
    G, D = _models(run["topts"], state0)
    assert G.cfg.m_use_spade and G.cfg.m_spade_cond_nc == 15
    builder = StepBuilder(run["topts"])
    state, metrics = builder.g_step(builder.state_for(G, D),
                                    port_batch(run["batch"]),
                                    draws=run["draws"][0])
    _check_metrics(metrics, run["metrics"][0])
    want_g, want_d = _models(run["topts"], state1)
    print(hold_state(G, want_g.state_dict(), run["lr"][0],
                     first_moments(G, state.g_opt),
                     _moments(run["topts"], state1)[0], what="G"))
    hold_state(D, want_d.state_dict(), what="D")


def test_d_step_matches_jax(run):
    _, state1, state2 = run["states"]
    G, D = _models(run["topts"], state1)
    builder = StepBuilder(run["topts"])
    state, metrics = builder.d_step(builder.state_for(G, D),
                                    port_batch(run["batch"]),
                                    draws=run["draws"][1])
    _check_metrics(metrics, run["metrics"][1])
    want_g, want_d = _models(run["topts"], state2)
    print(hold_state(D, want_d.state_dict(), run["lr"][1],
                     first_moments(D, state.d_opt),
                     _moments(run["topts"], state2)[1], what="D"))
    hold_state(G, want_g.state_dict(), what="G")


def test_eval_losses_match_jax(run):
    """Eval mode: running statistics, baked spectral kernels, the mask
    decoder's SPADEs on their packs (cnc 15) through the plain version."""
    G, D = _models(run["topts"], run["states"][0])
    builder = StepBuilder(run["topts"])
    got = builder.eval_losses(builder.state_for(G, D),
                              port_batch(run["batch"]),
                              draws=run["eval_draws"])
    _check_metrics(got, run["metrics"][2])
