"""The base mask decoder's layer norm, PReLU and SELU (``gen.m.norm: layer
| spectral_layer``, ``gen.m.activ: prelu | selu``) in the port, against
the JAX package on the CPU.

* ``norms.LayerNorm`` against JAX's ``LayerNormRef`` in f32 and float64
  (JAX computes in f32 whatever the input; the port's float64 is also held
  to the formula in float64), at an odd H; in bf16 against its own f32.
* ``Conv2dBlock`` for {layer, spectral_layer} x {prelu, selu} in train
  mode: the forward and the input and parameter gradients against
  ``jax.grad``.
* The tiny G (``tiny_opts(32)``, spectral_layer + prelu) built from JAX's
  variables through ``state_dict_from_jax`` with ``strict=True``: its mask
  logits, ``infer``'s events and one ``g_step``. JAX's side is compiled
  once per test session (``once_per_session``).
* The mask decoder's ``forward_rows`` over 2 and 3 row shards against its
  forward, in float64, with the gradients.
* The weights bridge for every norm and activation of the base mask
  decoder; the ``spectral_batch`` mask decoder from JAX's variables;
  ``fold_generator_bns`` leaving the layer-norm blocks unfolded;
  ``init_weights``; the orbax converter's scalar slope.

Bars: rtol = atol = 1e-4 (``tests/test_torch_port_configs.py``'s TOL),
events within 1 uint8 LSB, the step at ``hold_state``'s bars.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climategan_tpu.models.norms as jax_norms
from climategan_tpu.inference import build_infer_fn as jax_build_infer_fn
from climategan_tpu.models.blocks import Conv2dBlock as JaxConv2dBlock
from climategan_tpu.models.masker import MaskBaseDecoder as JaxMaskBaseDecoder
from climategan_tpu.models.norms import LayerNormRef, frozen_spectral
from climategan_tpu.train_step import StepBuilder as JaxStepBuilder
from climategan_tpu.train_step import TrainState as JaxTrainState
from climategan_tpu.utils.bn_fold import bake_spectral_norm
from climategan_tpu.utils.opts import Opts, merge
from climategan_tpu.utils.testing import tiny_opts
from climategan_torch.inference import build_infer_fn
from climategan_torch.models.blocks import Conv2dBlock, PReLU
from climategan_torch.models.discriminator import DisConfig, OmniDiscriminator
from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.models.masker import MaskBaseDecoder
from climategan_torch.models.norms import LayerNorm, init_weights
from climategan_torch.parallel import spatial
from climategan_torch.train_step import StepBuilder
from climategan_torch.utils.bn_fold import fold_generator_bns, folded_blocks
from climategan_torch.utils.convert import (
    _conv2dblock,
    _mask,
    d_state_dict_from_jax,
    state_dict_from_entries,
    state_dict_from_jax,
)
from climategan_torch.utils.opts import load_opts
from climategan_torch.utils.step_check import first_moments, hold_state
from tests.test_train_step import _batch
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    compiled,
    fill_like,
    gan_draws,
    jax_d_variables,
    jax_variables,
    moments_only,
    nchw,
    once_per_session,
    one_thread,
    port_batch,
    to_nhwc,
)

TOL = dict(rtol=1e-4, atol=1e-4)
SIZE = 32
MASK = {"norm": "spectral_layer", "activ": "prelu"}
NORMS = ["batch", "spectral_batch", "instance", "spectral_instance", "layer",
         "spectral_layer"]
ACTIVS = ["lrelu", "relu", "prelu", "selu"]


def _assert_close(got, want, what: str = ""):
    want = np.asarray(want)
    got = to_nhwc(got) if got.ndim == 4 else got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    print(f"{what}: max abs error {np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)


def _norm_values(variables, seed: int):
    """``variables`` with every layer norm's gamma uniform in [0, 1), as
    JAX initialises it, its beta small, and every PReLU slope drawn in
    [0.1, 0.4] (``fill_like`` draws them in +-0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "gamma":
            return rng.uniform(0, 1, leaf.shape).astype(np.float32)
        if name == "alpha":
            return np.float32(rng.uniform(0.1, 0.4))
        return leaf

    return jax.tree_util.tree_map_with_path(fill, variables)


def _mask_opts(**mask):
    jopts = tiny_opts(SIZE)
    merge(Opts({"gen": {"m": mask or MASK}}), jopts)
    return jopts


# ---- the layer norm alone -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_layer_norm_matches_jax(dtype):
    """A std of 0.02, so that the eps on the std (not the variance) shows
    at 1e-2 relative."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 7, 5, 6)) * 0.02 + 0.5).astype(dtype)
    gamma = rng.uniform(0, 1, 6).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, 6).astype(np.float32)
    with jax.enable_x64(dtype == "float64"):
        want = LayerNormRef(6).apply(
            {"params": {"gamma": gamma, "beta": beta}}, jnp.asarray(x))
    ln = LayerNorm(6)
    ln.load_state_dict({"gamma": torch.from_numpy(gamma),
                        "beta": torch.from_numpy(beta)})
    got = ln.to(getattr(torch, dtype))(
        torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got.float(), np.asarray(want, np.float32), f"{dtype}")
    if dtype == "float64":
        flat = x.reshape(2, -1)
        mean = flat.mean(1)[:, None, None, None]
        std = flat.std(1, ddof=1)[:, None, None, None]
        exact = (x - mean) / (std + 1e-5) * gamma + beta
        np.testing.assert_allclose(to_nhwc(got), exact, rtol=1e-12,
                                   atol=1e-12)


def test_layer_norm_bf16_within_one_ulp_of_its_f32():
    """A bf16 input and a bf16-autocast conv's output: the statistics and
    the affine in f32, one rounding at the end."""
    rng = np.random.default_rng(1)
    ln = LayerNorm(8)
    init_weights(ln, torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((2, 8, 9, 5)) * 4 + 2).float()
    conv = torch.nn.Conv2d(8, 8, 1)
    for what, y in (("bf16 input", x.bfloat16()),
                    ("autocast conv", None)):
        if y is None:
            with torch.autocast("cpu", dtype=torch.bfloat16):
                y = conv(x)
                got = ln(y)
        else:
            got = ln(y)
        assert got.dtype == torch.bfloat16
        want = ln(y.float())
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                      - 7)
        err = (got.float() - want).abs()
        print(f"{what}: max error {(err / ulp).max():.3f} ulp")
        assert bool((err <= ulp).all()), what


# ---- Conv2dBlock ------------------------------------------------------------

@pytest.mark.parametrize("activ", ["prelu", "selu"])
@pytest.mark.parametrize("norm", ["layer", "spectral_layer"])
def test_conv2dblock_forward_and_gradients_match_jax(norm, activ):
    blk = JaxConv2dBlock(6, 3, 1, 1, norm=norm, activation=activ,
                         pad_type="reflect")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 7, 4)).astype(np.float32)
    V = _norm_values(fill_like(
        jax.eval_shape(blk.init, jax.random.PRNGKey(0), x), 3), 4)
    r = rng.standard_normal((2, 9, 7, 6)).astype(np.float32)

    def loss(params, x):
        y = blk.apply({**V, "params": params}, x, train=True)
        return (y * r).sum(), y

    grad = jax.value_and_grad(loss, (0, 1), has_aux=True)
    (_, want), (gp, gx) = compiled(grad, V["params"], x)(V["params"], x)
    items = list(_conv2dblock("b", (), norm, activ))
    sd = state_dict_from_entries(V, items)
    tb = Conv2dBlock(4, 6, 3, 1, 1, norm=norm, activation=activ,
                     pad_type="reflect")
    tb.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    assert isinstance(tb.norm, LayerNorm)
    assert (tb.activation is not None) == (activ == "prelu")
    tx = nchw(x).requires_grad_(True)
    y = tb.train()(tx)
    _assert_close(y, want, "forward")
    (y * nchw(r)).sum().backward()
    _assert_close(tx.grad, gx, "input gradient")
    grads = state_dict_from_entries({**V, "params": gp}, items)
    for name, p in tb.named_parameters():
        want = grads[f"b.{name}"].numpy()
        print(f"{name}: max abs error {np.abs(p.grad.numpy() - want).max():.2e}")
        np.testing.assert_allclose(p.grad.numpy(), want, err_msg=name, **TOL)


# ---- the tiny G against JAX ------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's variables of the tiny G with spectral_layer + prelu, its mask
    logits and encoder features on ``x``, its ``infer`` of all three
    events, and one g_step (``tpu.painter_s2d`` and ``FUSED_REFLECT`` off,
    XLA opt level 0); numpy, once per session."""
    return once_per_session(tmp_path_factory, "torch_port_mask_norms",
                            _jax_run)


def _split(variables):
    return (variables["params"],
            {k: v for k, v in variables.items() if k != "params"})


def _jax_run():
    jopts = _mask_opts()
    jopts.train.bf16 = False
    jopts.tpu.painter_s2d = False
    G, V = jax_variables(jopts, SIZE, seed=3)
    V = _norm_values(V, 5)
    x = np.random.default_rng(4).uniform(-1, 1, (2, SIZE, SIZE, 3)) \
        .astype(np.float32)

    rng = jax.random.PRNGKey(5)
    rng_fire, rng_cloud, _ = jax.random.split(rng, 3)
    _, jinfer = jax_build_infer_fn(jopts, dtype=jnp.float32, ignore_event=(),
                                   donate=False, freeze_spectral=True)

    def forward(V, x, rng):
        """The encoder's features, the depth head's, the mask logits
        (on the baked spectral kernels, as ``infer`` reads them) and
        ``infer``, in one graph that computes the masker once."""
        baked = bake_spectral_norm(V)
        with frozen_spectral():
            z = G.apply(baked, x, method="encode")
            _, zd = G.apply(baked, z, method="depth")
            logits = G.apply(baked, z, None, zd, method="mask_logits")
        return z, zd, logits, jinfer(baked, x, rng)

    z, zd, logits, infer = compiled(forward, V, x, rng)(V, x, rng)

    prev = jax_norms.FUSED_REFLECT
    jax_norms.FUSED_REFLECT = False
    try:
        jb = JaxStepBuilder(jopts)
        _, dvars = jax_d_variables(jopts, SIZE, seed=1)
        key = jax.random.PRNGKey(0)
        # the models of the state before the step; the optimizers' first
        # state is made inside the compiled step
        state0 = JaxTrainState(*_split(V), *_split(dvars), None, None,
                               None, None)
        batch = _batch(2, SIZE)

        def g_step(state, batch):
            return jb.g_step(state._replace(
                g_opt=jb.g_opt_init(state.g_params),
                d_opt=jb.d_opt_init(state.d_params),
                step=jnp.zeros((), jnp.int32), rng=key), batch, 1.0)

        state1, metrics = compiled(g_step, state0, batch)(state0, batch)
    finally:
        jax_norms.FUSED_REFLECT = prev
    k_g, _ = jax.random.split(key)
    out = jax.tree_util.tree_map(np.asarray, dict(
        V=V, x=x, z=list(z), zd=zd, logits=logits, infer=dict(infer),
        uniform=jax.random.uniform(rng_cloud, (9, 9)),
        g_value=jax.random.randint(rng_fire, (), 100, 151),
        batch=batch, states=(state0, moments_only(state1)),
        metrics=metrics))
    return dict(out, opts=jopts.to_dict(), lr=jb.g_lr,
                draws=gan_draws(k_g, jb.cfg.soft_shift, jb.cfg.flip_prob))


@pytest.fixture(scope="module")
def tiny(jax_run):
    """(port opts, the port's state dict of JAX's variables, the port G
    loaded from it strictly, in eval mode)."""
    topts = load_opts(default=jax_run["opts"])
    cfg = GenConfig.from_opts(topts)
    assert (cfg.m_norm, cfg.m_activ) == ("spectral_layer", "prelu")
    sd = state_dict_from_jax(jax_run["V"], cfg)
    G = OmniGenerator(cfg)
    G.load_state_dict(sd, strict=True)
    return topts, sd, G.eval()


def test_tiny_generator_mask_logits_match_jax(jax_run, tiny):
    """41 parameter leaves of JAX's mask decoder, each in the port's state
    dict; the logits on JAX's encoder features."""
    _, sd, G = tiny
    leaves = jax.tree_util.tree_leaves(jax_run["V"]["params"]["mask_decoder"])
    names = [n for n, _ in G.decoders["m"].named_parameters()]
    assert len(leaves) == len(names) == 41
    assert sum(n.endswith((".norm.gamma", ".norm.beta")) for n in names) == 16
    assert sum(n.endswith(".activation.weight") for n in names) == 7
    with torch.no_grad():
        got = G.decoders["m"]([nchw(a) for a in jax_run["z"]], None,
                              nchw(jax_run["zd"]))
    _assert_close(got, jax_run["logits"], "mask logits")


def test_infer_matches_jax(jax_run, tiny):
    """``build_infer_fn`` of the port's state dict: the mask within 1e-4,
    each event within 1 uint8 LSB of JAX's ``infer``."""
    topts, sd, _ = tiny
    _, infer = build_infer_fn(topts, dtype=torch.float32, ignore_event=(),
                              device="cpu", state_dict=sd)
    got = infer(torch.from_numpy(jax_run["x"]),
                uniform=torch.from_numpy(jax_run["uniform"]),
                g_value=float(jax_run["g_value"]))
    want = jax_run["infer"]
    assert sorted(got) == sorted(want) == ["flood", "mask", "smog",
                                           "wildfire"]
    np.testing.assert_allclose(got["mask"].numpy(), want["mask"], rtol=0,
                               atol=1e-4)
    for event in ("flood", "wildfire", "smog"):
        diff = np.abs(got[event].numpy().astype(int)
                      - want[event].astype(int))
        print(f"{event}: max {diff.max()} LSB")
        assert diff.max() <= 1, event


def _models(topts, jstate):
    G = OmniGenerator(GenConfig.from_opts(topts))
    G.load_state_dict(state_dict_from_jax(
        {"params": jstate.g_params, **jstate.g_state}, G.cfg), strict=True)
    D = OmniDiscriminator(DisConfig.from_opts(topts))
    D.load_state_dict(d_state_dict_from_jax(
        {"params": jstate.d_params, **jstate.d_state}, D.cfg))
    return G, D


def test_g_step_matches_jax(jax_run, tiny):
    """One g_step from the same state: every loss within 1e-4 relative, G
    held by ``hold_state`` (the gamma, beta and alpha of the mask decoder
    among its leaves), D's parameters untouched."""
    topts = tiny[0]
    state0, state1 = jax_run["states"]
    G, D = _models(topts, state0)
    builder = StepBuilder(topts)
    state, metrics = builder.g_step(builder.state_for(G, D),
                                    port_batch(jax_run["batch"]),
                                    draws=jax_run["draws"])
    assert set(metrics) == set(jax_run["metrics"])
    for k, v in jax_run["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    want_mu = state_dict_from_jax({"params": state1.g_opt.mu,
                                   **state1.g_state}, G.cfg)
    print(hold_state(G, state_dict_from_jax(
        {"params": state1.g_params, **state1.g_state}, G.cfg),
        jax_run["lr"], first_moments(G, state.g_opt), want_mu, what="G"))
    hold_state(D, d_state_dict_from_jax(
        {"params": state1.d_params, **state1.d_state}, D.cfg), what="D")
    moved = [k for k in want_mu if k.startswith("decoders.m.")
             and k.endswith((".gamma", ".beta", ".activation.weight"))]
    assert moved and all(want_mu[k].abs().max() > 0 for k in moved)


def test_fold_leaves_the_layer_norm_blocks(tiny):
    """``fold_generator_bns`` folds the encoder and depth decoder's batch
    norms and leaves every layer-norm block of the mask decoder as it is;
    the mask is unchanged."""
    _, sd, tG = tiny
    G = OmniGenerator(tG.cfg)
    G.load_state_dict(sd, strict=True)
    G.eval()
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (1, 3, SIZE, SIZE)).astype(np.float32))

    def layer_norms():
        return {n: m.norm for n, m in G.decoders["m"].named_modules()
                if isinstance(m, Conv2dBlock) and m.norm is not None}

    with torch.no_grad():
        before = G.infer_masker(x)[2]
        names = [n for n, _ in folded_blocks(G)]
        fold_generator_bns(G)
        after = G.infer_masker(x)[2]
    assert names and not any(n.startswith("decoders.m.") for n in names)
    assert len(layer_norms()) == 8
    for name, norm in layer_norms().items():
        assert isinstance(norm, LayerNorm), name
        for k in ("gamma", "beta"):
            assert torch.equal(getattr(norm, k),
                               sd[f"decoders.m.{name}.norm.{k}"])
    torch.testing.assert_close(after, before, rtol=1e-5, atol=1e-5)


# ---- row shards --------------------------------------------------------------

def _decoder(norm="spectral_layer", activ="prelu"):
    dec = MaskBaseDecoder(input_dim=32, n_upsample=2, n_res=1, proj_dim=16,
                          norm=norm, activ=activ, low_level_feats_dim=16)
    init_weights(dec, torch.Generator().manual_seed(7))
    return dec


@pytest.mark.parametrize("k", [2, 3])
def test_forward_rows_matches_the_forward(k):
    """Float64, train mode (the layer norm's float64 sums through
    ``spatial.all_reduce`` carry the gradient) and eval mode: the logits
    and, in train mode, the input and parameter gradients."""
    dec = _decoder().double()
    rng = np.random.default_rng(8)
    zh = torch.from_numpy(rng.standard_normal((2, 32, 5, 6)))
    zl = torch.from_numpy(rng.standard_normal((2, 16, 10, 12)))
    r = torch.from_numpy(rng.standard_normal((2, 1, 20, 24)))
    devices = ["cpu"] * k
    for mode in ("train", "eval"):
        dec.train(mode == "train")
        ins = [t.clone().requires_grad_(True) for t in (zh, zl)]
        want = dec(ins)
        (want * r).sum().backward()
        grads = {n: p.grad.clone() for n, p in dec.named_parameters()
                 if p.grad is not None}
        dec.zero_grad()
        rows = [t.clone().requires_grad_(True) for t in (zh, zl)]
        got = dec.forward_rows([spatial.shard_rows(t, devices) for t in rows])
        assert [p.shape[2] for p in got.parts] == [
            b - a for a, b in spatial.split(20, k)]
        got = got.gather("cpu")
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
        if mode == "eval":
            continue
        (got * r).sum().backward()
        for t, u in zip(rows, ins):
            torch.testing.assert_close(t.grad, u.grad, rtol=1e-9, atol=1e-11)
        assert any("norm.gamma" in n for n in grads)
        for n, p in dec.named_parameters():
            if n in grads:
                torch.testing.assert_close(p.grad, grads[n], rtol=1e-9,
                                           atol=1e-11, msg=n)
        dec.zero_grad()


# ---- the weights bridge ----------------------------------------------------

# the tiny G's base mask decoder (tiny_opts(32)): z_high 2048 channels at
# 4^2, z_low 256 at 8^2
DECODER = dict(input_dim=2048, n_upsample=3, n_res=1, proj_dim=16,
               low_level_feats_dim=256)


def _decoder_inputs():
    rng = np.random.default_rng(9)
    return [rng.standard_normal((2, 4, 4, 2048)).astype(np.float32),
            rng.standard_normal((2, 8, 8, 256)).astype(np.float32)]


@functools.lru_cache(maxsize=None)
def _decoder_variables(norm: str, prelu: bool):
    """Numpy-drawn variables of JAX's base mask decoder alone at the tiny
    G's widths, under the G's ``mask_decoder`` scope; the activation
    changes them only by PReLU's slopes."""
    dec = JaxMaskBaseDecoder(norm=norm, activ="prelu" if prelu else "relu",
                             **DECODER)
    V = _norm_values(fill_like(jax.eval_shape(
        dec.init, jax.random.PRNGKey(0), _decoder_inputs()), 10), 11)
    return {c: {"mask_decoder": t} for c, t in V.items()}


@pytest.mark.parametrize("norm", NORMS)
def test_every_norm_and_activation_loads_strict(norm):
    """For each activation, the bridge of the G's mask decoder
    (``convert._mask``) gives exactly the port decoder's keys (a strict
    load): a batch post-norm (batch, spectral_batch) its batch norms, a
    layer one its gamma and beta, prelu a slope of shape (1,). With prelu,
    the eval logits match JAX's."""
    for activ in ACTIVS:
        V = _decoder_variables(norm, activ == "prelu")
        cfg = GenConfig(tasks=("m",), m_norm=norm, m_activ=activ,
                        m_n_res=1, m_proj_dim=16)
        sd = {k[len("decoders.m."):]: v
              for k, v in state_dict_from_entries(V, _mask(cfg)).items()}
        tdec = MaskBaseDecoder(norm=norm, activ=activ, **DECODER)
        tdec.load_state_dict(sd, strict=True)
        assert ("proj_conv.norm.running_var" in sd) == norm.endswith("batch")
        assert ("proj_conv.norm.gamma" in sd) == norm.endswith("layer")
        if activ == "prelu":
            assert sd["proj_conv.activation.weight"].shape == (1,)
        if activ == "prelu":
            dec = JaxMaskBaseDecoder(norm=norm, activ=activ, **DECODER)
            own = {c: t["mask_decoder"] for c, t in V.items()}
            z = _decoder_inputs()
            want = compiled(lambda z: dec.apply(own, z), z)(z)
            with torch.no_grad():
                got = tdec.eval()([nchw(a) for a in z])
            _assert_close(got, want, f"{norm} {activ}")


def test_spectral_batch_generator_loads_strict(jax_run):
    """The whole G's bridge with ``gen.m.norm: spectral_batch`` (the tiny
    G's variables with a spectral_batch mask decoder): the mask decoder's
    batch norms are there, so the strict load takes them (the G is built
    on the meta device: the keys and shapes are checked)."""
    dec_vars = _decoder_variables("spectral_batch", False)
    V = {c: {**jax_run["V"].get(c, {}), **dec_vars.get(c, {})}
         for c in ("params", "batch_stats", "spectral")}
    jopts = _mask_opts(norm="spectral_batch", activ="lrelu")
    cfg = GenConfig.from_opts(load_opts(default=jopts.to_dict()))
    sd = state_dict_from_jax(V, cfg)
    assert "decoders.m.proj_conv.norm.running_var" in sd
    with torch.device("meta"):
        G = OmniGenerator(cfg)
    G.load_state_dict(sd, strict=True, assign=True)


def test_init_weights_fills_gamma_beta_and_alpha():
    dec = MaskBaseDecoder(input_dim=32, n_upsample=2, n_res=1, proj_dim=16,
                          norm="layer", activ="prelu", low_level_feats_dim=16)
    with torch.no_grad():
        for p in dec.parameters():
            p.fill_(float("nan"))
    init_weights(dec, torch.Generator().manual_seed(0))
    lns = [m for m in dec.modules() if isinstance(m, LayerNorm)]
    prelus = [m for m in dec.modules() if isinstance(m, PReLU)]
    assert len(lns) == 7 and len(prelus) == 6
    for m in lns:
        assert 0 <= m.gamma.min() and m.gamma.max() < 1
        assert m.gamma.unique().numel() > 1 and not m.beta.any()
    assert all(m.weight.item() == 0.25 for m in prelus)
    assert all(torch.isfinite(p).all() for p in dec.parameters())


def test_orbax_converter_gives_a_slope_moment_its_shape():
    """``scripts/orbax_to_pth.py``: a JAX optimizer moment of the scalar
    PReLU slope takes the port parameter's shape (1,), as the weights
    bridge gives the slope itself."""
    from scripts.orbax_to_pth import opt_state

    params = {"m.activation.weight": torch.zeros(1), "m.conv.bias":
              torch.zeros(3)}
    leaves = {"a": np.float32(0.5), "b": np.arange(3, dtype=np.float32)}
    out = opt_state({"count": 1, "mu": leaves, "nu": leaves},
                    {"m.activation.weight": 0, "m.conv.bias": 1}, params,
                    ["mu", "nu"])
    assert out["mu"]["m.activation.weight"].shape == (1,)
    assert float(out["mu"]["m.activation.weight"]) == 0.5
    assert out["nu"]["m.conv.bias"].shape == (3,)
