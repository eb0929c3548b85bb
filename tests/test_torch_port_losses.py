"""The port's losses, discriminators, spectral norm, batch norm, paste
gradient and optimizers against the JAX package's, on the CPU in f32.

Every case feeds the same numpy-seeded inputs (and weights) to both and
holds values and gradients at f32 noise: 1e-5 relative, gradients to 1e-5
of their largest value. Looser bars are stated where they are used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climategan_tpu import losses as JL
from climategan_tpu import optim as JO
from climategan_tpu.models.norms import BatchNorm as JaxBatchNorm
from climategan_tpu.models.norms import SNConv as JaxSNConv
from climategan_tpu.train_step import vgg_preprocess as jax_vgg_preprocess
from climategan_tpu.utils.testing import tiny_opts
from climategan_torch import losses as TL
from climategan_torch import optim as TO
from climategan_torch.kernels.masked_blend import MaskedBlend, masked_blend_plain
from climategan_torch.models.discriminator import DisConfig, OmniDiscriminator
from climategan_torch.models.norms import BatchNorm2d, SNConv
from climategan_torch.utils.convert import (
    d_state_dict_from_jax,
    vgg_state_dict_from_jax,
)
from climategan_torch.utils.opts import load_opts
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    fill_like,
    jax_d_variables,
    nchw,
    one_thread,
    to_nhwc,
)

RTOL = 1e-5


def _close(got, want, rtol=RTOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rtol * scale, f"{what}: max err {err:.3g} vs scale {scale:.3g}"


def _leaf(t):
    return nchw(t).clone().requires_grad_()


def _vg(fn, **kw):
    """JAX's value and gradient of ``fn``, compiled: a jitted call costs
    a fraction of the op-by-op dispatch of these graphs on the CPU."""
    return jax.jit(jax.value_and_grad(fn, **kw))


# ---- losses ---------------------------------------------------------------

def _prob(rng, shape):
    p = rng.uniform(0.01, 1.0, shape).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


def _disc_weights(c):
    return np.linspace(-1.0, 1.0, c, dtype=np.float32)


def _jax_disc(w):
    return lambda e: jnp.sum(e * w, axis=-1, keepdims=True) - 0.3


def _port_disc(w):
    wt = torch.from_numpy(w)[None, :, None, None]
    return lambda e: torch.sum(e * wt, dim=1, keepdim=True) - 0.3


# name -> (make inputs from rng (NHWC numpy, the first gets the gradient),
#          JAX function, port function)
LOSSES = {
    "mse": (lambda r: (r.standard_normal((2, 5, 6, 3)), r.standard_normal((2, 5, 6, 3))),
            JL.mse_loss, TL.mse_loss),
    "l1": (lambda r: (r.standard_normal((2, 5, 6, 3)), r.standard_normal((2, 5, 6, 3))),
           JL.l1_loss, TL.l1_loss),
    "bce_with_logits": (
        lambda r: (3 * r.standard_normal((2, 6, 6, 1)), (r.random((2, 6, 6, 1)) > 0.5)),
        JL.bce_with_logits, TL.bce_with_logits),
    "simse": (lambda r: (r.standard_normal((2, 5, 6, 1)), r.standard_normal((2, 5, 6, 1))),
              JL.simse_loss, TL.simse_loss),
    "tv": (lambda r: (r.standard_normal((3, 6, 5, 2)),), JL.tv_loss, TL.tv_loss),
    "minent_v1": (lambda r: (_prob(r, (2, 5, 4, 3)),),
                  lambda p: JL.minent_loss(p, 1), lambda p: TL.minent_loss(p, 1)),
    "minent_v2": (lambda r: (_prob(r, (2, 5, 4, 2)),),
                  lambda p: JL.minent_loss(p, 2, 0.1),
                  lambda p: TL.minent_loss(p, 2, 0.1)),
    # 2 x 16 x 16: an even count, where the median is the mean of the two
    # middle values
    "sigm_even": (lambda r: (r.uniform(0.1, 1, (2, 16, 16, 1)), r.uniform(0.1, 1, (2, 16, 16, 1))),
                  lambda p, t: JL.sigm_loss(p, t, 0.5),
                  lambda p, t: TL.sigm_loss(p, t, 0.5)),
    "sigm_odd": (lambda r: (r.uniform(0.1, 1, (1, 17, 15, 1)), r.uniform(0.1, 1, (1, 17, 15, 1))),
                 lambda p, t: JL.sigm_loss(p, t, 0.5),
                 lambda p, t: TL.sigm_loss(p, t, 0.5)),
    "dada_depth": (lambda r: (r.standard_normal((2, 6, 6, 1)), r.standard_normal((2, 6, 6, 1))),
                   JL.dada_depth_loss, TL.dada_depth_loss),
    "context": (lambda r: (r.standard_normal((2, 6, 6, 3)), r.standard_normal((2, 6, 6, 3)),
                           (r.random((2, 6, 6, 1)) > 0.5)),
                JL.context_loss, TL.context_loss),
    "reconstruction": (lambda r: (r.standard_normal((2, 6, 6, 3)), r.standard_normal((2, 6, 6, 3)),
                                  (r.random((2, 6, 6, 1)) > 0.5)),
                       JL.reconstruction_loss, TL.reconstruction_loss),
    "ground_intersection": (lambda r: (r.random((2, 6, 6, 1)), (r.random((2, 6, 6, 1)) > 0.5)),
                            JL.ground_intersection_loss, TL.ground_intersection_loss),
    "custom_bce": (lambda r: (r.standard_normal((2, 3, 3, 1)),),
                   lambda x: JL.custom_bce(x, 1.0), lambda x: TL.custom_bce(x, 1.0)),
    "wgan_domain": (lambda r: (r.standard_normal((2, 3, 3, 1)),),
                    lambda x: JL.wgan_domain_loss(x, 0.0),
                    lambda x: TL.wgan_domain_loss(x, 0.0)),
    "advent_wgan_dada": (
        lambda r: (_prob(r, (2, 8, 8, 3)), r.uniform(0, 1, (2, 8, 8, 1))),
        lambda p, d: JL.advent_loss(p, 1.0, _jax_disc(_disc_weights(3)), "WGAN_norm", d),
        lambda p, d: TL.advent_loss(p, 1.0, _port_disc(_disc_weights(3)), "WGAN_norm", d)),
    "advent_gan": (
        lambda r: (_prob(r, (2, 8, 8, 2)),),
        lambda p: JL.advent_loss(p, 0.0, _jax_disc(_disc_weights(2)), "GAN"),
        lambda p: TL.advent_loss(p, 0.0, _port_disc(_disc_weights(2)), "GAN")),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_its_gradient_match_jax(name):
    make, jfn, tfn = LOSSES[name]
    args = [np.asarray(a, np.float32) for a in make(np.random.default_rng(7))]
    jval, jgrad = _vg(lambda a0: jfn(a0, *args[1:]))(args[0])
    targs = [_leaf(args[0])] + [nchw(a) for a in args[1:]]
    tval = tfn(*targs)
    _close(float(tval.detach()), float(jval), what="value")
    if tval.requires_grad:
        tval.backward()
        _close(to_nhwc(targs[0].grad), jgrad, what="gradient")
    else:  # a comparison: no gradient on either side
        assert not np.asarray(jgrad).any()


def test_cross_entropy_and_its_gradient_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 4, 5, 6)).astype(np.float32)
    target = rng.integers(0, 6, (2, 4, 5)).astype(np.int32)
    jval, jgrad = _vg(JL.cross_entropy)(logits, target)
    t = _leaf(logits)
    tval = TL.cross_entropy(t, torch.from_numpy(target).long())
    tval.backward()
    _close(float(tval.detach()), float(jval))
    _close(to_nhwc(t.grad), jgrad)


def _multiscale(rng, n_scales=2, n_layers=3):
    return [[rng.standard_normal((2, 6 - s, 6 - s, 4 if j < n_layers - 1 else 1))
             .astype(np.float32) for j in range(n_layers)] for s in range(n_scales)]


@pytest.mark.parametrize("lsgan", [False, True])
@pytest.mark.parametrize("target_is_real", [False, True])
@pytest.mark.parametrize("flip", [False, True])
def test_gan_loss_with_its_draws_matches_jax(lsgan, target_is_real, flip):
    """The JAX loss draws (soft, flip) from a key; the port takes them.
    A key whose flip draw lands on the asked side is searched for."""
    soft_shift, flip_prob = 0.2, 0.5
    for i in range(64):
        key = jax.random.PRNGKey(i)
        k1, k2 = jax.random.split(key)
        if bool(jax.random.uniform(k2, ()) < flip_prob) == flip:
            break
    soft = float(jax.random.uniform(k1, ()) * soft_shift)
    preds = _multiscale(np.random.default_rng(2))
    jval, jgrad = _vg(lambda p: JL.gan_loss(
        p, target_is_real, key, lsgan, soft_shift, flip_prob))(preds)
    tp = [[_leaf(a) for a in s] for s in preds]
    tval = TL.gan_loss(tp, target_is_real, soft, flip, lsgan)
    tval.backward()
    _close(float(tval.detach()), float(jval))
    for s in range(len(preds)):
        _close(to_nhwc(tp[s][-1].grad), jgrad[s][-1])


@pytest.mark.parametrize("case", ["d_real", "d_fake", "g"])
def test_hinge_loss_matches_jax(case):
    real = case != "d_fake"
    for_d = case != "g"
    preds = _multiscale(np.random.default_rng(3))
    jval, jgrad = _vg(
        lambda p: JL.hinge_loss(p, real, for_d))(preds)
    tp = [[_leaf(a) for a in s] for s in preds]
    tval = TL.hinge_loss(tp, real, for_d)
    tval.backward()
    _close(float(tval.detach()), float(jval))
    _close(to_nhwc(tp[1][-1].grad), jgrad[1][-1])


def test_feat_match_loss_matches_jax_and_detaches_the_real_side():
    rng = np.random.default_rng(4)
    real, fake = _multiscale(rng), _multiscale(rng)
    jval, (jr, jf) = _vg(JL.feat_match_loss, argnums=(0, 1))(real, fake)
    tr = [[_leaf(a) for a in s] for s in real]
    tf = [[_leaf(a) for a in s] for s in fake]
    tval = TL.feat_match_loss(tr, tf)
    tval.backward()
    _close(float(tval.detach()), float(jval))
    for s in range(2):
        for j in range(2):
            _close(to_nhwc(tf[s][j].grad), jf[s][j])
            assert tr[s][j].grad is None and not np.asarray(jr[s][j]).any()


def test_vgg_features_and_loss_match_jax_on_random_weights():
    """VGG19Features through the weights map, and vgg_loss with its
    preprocessing; the JAX weights are numpy draws (no pretrained VGG)."""
    model = JL.VGG19Features()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    variables = fill_like(shapes, seed=5)
    vgg = TL.VGG19Features()
    missing = vgg.load_state_dict(vgg_state_dict_from_jax(variables), strict=True)
    assert not missing.missing_keys
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jfeats = jax.jit(model.apply)(variables, x)
    tfeats = vgg(nchw(x))
    assert len(tfeats) == 5
    for a, b in zip(tfeats, jfeats):
        _close(to_nhwc(a.detach()), b, rtol=2e-5, what="features")
    jval, jgrad = _vg(lambda a: JL.vgg_loss(
        variables, jax_vgg_preprocess(a), jax_vgg_preprocess(y)))(x)
    t = _leaf(x)
    tval = TL.vgg_loss(vgg, TL.vgg_preprocess(t), TL.vgg_preprocess(nchw(y)))
    tval.backward()
    _close(float(tval.detach()), float(jval))
    # the L1 of thirteen stacked random convs: its gradient sums many
    # terms of both signs, so it is held to 1e-4 of its largest value
    _close(to_nhwc(t.grad), jgrad, rtol=1e-4)


# ---- the paste's gradient ------------------------------------------------

@pytest.mark.parametrize("needs", ["all", "fake_only"])
def test_masked_blend_autograd_matches_plain(needs):
    rng = np.random.default_rng(8)
    x, fake = (torch.from_numpy(rng.standard_normal((2, 5, 7, 3)).astype(np.float32))
               for _ in range(2))
    m = torch.from_numpy(rng.random((2, 5, 7, 1)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 5, 7, 3)).astype(np.float32))
    want_in = [t.clone().requires_grad_(needs == "all" or i == 1)
               for i, t in enumerate((x, fake, m))]
    got_in = [t.clone().requires_grad_(needs == "all" or i == 1)
              for i, t in enumerate((x, fake, m))]
    (masked_blend_plain(*want_in) * g).sum().backward()
    out = MaskedBlend.apply(*got_in)
    torch.testing.assert_close(out, masked_blend_plain(x, fake, m), rtol=0, atol=0)
    (out * g).sum().backward()
    for a, b in zip(got_in, want_in):
        if b.grad is None:
            assert a.grad is None
        else:
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


# ---- spectral norm and batch norm in train mode --------------------------

@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (4, 2, 1), (1, 1, 0)])
def test_snconv_train_mode_matches_jax(k, stride, pad):
    """Output, the weight_bar / bias / input gradients, and u/v after
    update_sn, from the same kernel, bias, u and v."""
    cin, cout = 6, 5
    conv = JaxSNConv(cout, (k, k), strides=(stride, stride), padding=(pad, pad),
                     spectral=True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 9, 9, cin)).astype(np.float32)
    shapes = jax.eval_shape(conv.init, jax.random.PRNGKey(0), x)
    variables = fill_like(shapes, seed=10)
    r = rng.standard_normal(jax.eval_shape(conv.apply, variables, x).shape
                            ).astype(np.float32)

    def loss(params, x):
        y, st = conv.apply({"params": params, "spectral": variables["spectral"]},
                           x, update_sn=True, mutable=["spectral"])
        return jnp.sum(y * r), (y, st)

    (_, (jy, jst)), (jgp, jgx) = _vg(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], x)
    t = SNConv(cin, cout, k, stride, pad, spectral=True)
    t.load_state_dict({
        "module.weight_bar": torch.from_numpy(np.ascontiguousarray(
            variables["params"]["kernel"].transpose(3, 2, 0, 1))),
        "module.bias": torch.from_numpy(variables["params"]["bias"]),
        "module.weight_u": torch.from_numpy(variables["spectral"]["u"]),
        "module.weight_v": torch.from_numpy(variables["spectral"]["v"])})
    t.train()
    tx = _leaf(x)
    ty = t(tx, update_sn=True)
    (ty * nchw(r)).sum().backward()
    _close(to_nhwc(ty.detach()), jy, what="output")
    _close(to_nhwc(tx.grad), jgx, what="input gradient")
    _close(t.module.weight_bar.grad.permute(2, 3, 1, 0).numpy(), jgp["kernel"],
           what="weight_bar gradient")
    _close(t.module.bias.grad.numpy(), jgp["bias"], what="bias gradient")
    _close(t.module.weight_u.numpy(), jst["spectral"]["u"], what="u")
    _close(t.module.weight_v.numpy(), jst["spectral"]["v"], what="v")
    # without update_sn u/v stay; eval() bakes the current weight_bar, u
    # and v into the kernel the eval forward runs
    u = t.module.weight_u.clone()
    with torch.no_grad():
        y_train = t(tx)
        assert torch.equal(t.module.weight_u, u)
        t.eval()
        torch.testing.assert_close(t(tx), y_train, rtol=1e-5, atol=1e-5)


def test_batch_norm_train_mode_matches_flax():
    """Output, input/scale gradients and the running statistics after one
    train-mode forward: the running variance takes the biased batch
    variance (torch's nn.BatchNorm2d takes the unbiased one)."""
    rng = np.random.default_rng(11)
    x = (3 * rng.standard_normal((2, 4, 4, 16)) + 1).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    bn = JaxBatchNorm()
    shapes = jax.eval_shape(bn.init, jax.random.PRNGKey(0), x)
    v = fill_like(shapes, seed=12)

    def loss(params, x):
        y, st = bn.apply({"params": params, "batch_stats": v["batch_stats"]},
                         x, train=True, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, st)

    (_, (jy, jst)), (jgp, jgx) = _vg(
        loss, argnums=(0, 1), has_aux=True)(v["params"], x)
    p, s = v["params"]["BatchNorm_0"], v["batch_stats"]["BatchNorm_0"]
    t = BatchNorm2d(16)
    t.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                       "bias": torch.from_numpy(p["bias"]),
                       "running_mean": torch.from_numpy(s["mean"]),
                       "running_var": torch.from_numpy(s["var"]),
                       "num_batches_tracked": torch.tensor(0)})
    t.train()
    tx = _leaf(x)
    ty = t(tx)
    (ty * nchw(r)).sum().backward()
    _close(to_nhwc(ty.detach()), jy, what="output")
    _close(to_nhwc(tx.grad), jgx, what="input gradient")
    _close(t.weight.grad.numpy(), jgp["BatchNorm_0"]["scale"], what="scale gradient")
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   jst["batch_stats"]["BatchNorm_0"][key],
                                   rtol=0, atol=1e-6, err_msg=name)
    unbiased = torch.nn.BatchNorm2d(16)
    unbiased.load_state_dict(t.state_dict())
    unbiased.running_var.copy_(torch.from_numpy(s["var"]))
    unbiased.train()(nchw(x))
    assert (unbiased.running_var - t.running_var).abs().max() > 1e-3


# ---- discriminators ---------------------------------------------------------

@pytest.fixture(scope="module")
def discs():
    jopts = tiny_opts(32)
    D, variables = jax_d_variables(jopts, 32, seed=13)
    tD = OmniDiscriminator(DisConfig.from_opts(load_opts(default=jopts.to_dict())))
    tD.load_state_dict(d_state_dict_from_jax(variables, tD.cfg), strict=True)
    return D, variables, tD.train()


@pytest.mark.parametrize("method,shape", [("disc_p", (2, 32, 32, 4)),
                                          ("disc_m", (2, 32, 32, 2)),
                                          ("disc_s", (2, 32, 32, 11))])
def test_discriminator_outputs_input_gradients_and_uv_match_jax(discs, method, shape):
    """Every layer output of every scale, the input gradient of a weighted
    sum of the last layers, and u/v after update_sn, at tiny_opts' D widths
    (painter D ndf 16, 2 layers, 2 scales; ADVENT Ds ndf 64)."""
    D, variables, tD = discs
    tD.load_state_dict(d_state_dict_from_jax(variables, tD.cfg))
    x = np.random.default_rng(14).uniform(-1, 1, shape).astype(np.float32)

    def loss(x):
        out, st = D.apply(variables, x, method=method, update_sn=True,
                          mutable=["spectral"])
        last = JL._final_preds(out)
        return sum(jnp.sum(p * (i + 1.0)) for i, p in enumerate(last)), (out, st)

    (_, (jout, jst)), jgx = _vg(loss, has_aux=True)(x)
    tx = _leaf(x)
    tout = getattr(tD, method)(tx, update_sn=True)
    sum((p * (i + 1.0)).sum() for i, p in enumerate(TL.final_preds(tout))).backward()
    flat_j = jax.tree_util.tree_leaves(jout)
    flat_t = (tout if isinstance(tout, torch.Tensor)
              else [a for s in tout for a in s])
    flat_t = [flat_t] if isinstance(flat_t, torch.Tensor) else flat_t
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        _close(to_nhwc(a.detach()), b, rtol=2e-5, what="output")
    _close(to_nhwc(tx.grad), jgx, rtol=2e-5, what="input gradient")
    want = d_state_dict_from_jax({**variables, "spectral": jst["spectral"]}, tD.cfg)
    got = tD.state_dict()
    prefix = {"disc_p": "p.", "disc_m": "m_advent.", "disc_s": "s_advent."}[method]
    for k, v in want.items():
        if k.startswith(prefix) and k.rsplit(".", 1)[-1] in ("weight_u", "weight_v"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)


# ---- optimizers, lr groups and schedules ---------------------------------

@pytest.mark.parametrize("name", ["ExtraAdam", "Adam", "RMSprop", "RAdam", "NovoGrad"])
def test_optimizer_over_three_calls_matches_jax(name):
    """extrapolate, step, extrapolate (ExtraAdam's even/odd phases) with
    per-tensor lr scales, on the same gradients."""
    rng = np.random.default_rng(15)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 3))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in params]
             for _ in range(3)]
    scales = [1.0, 0.5, 2.0]
    jinit, jstep = JO.make_optimizer(name, 0.5)
    tinit, tstep = TO.make_optimizer(name, 0.5)
    jp, js = list(params), jinit(list(params))
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = tinit(tp)
    for i, g in enumerate(grads):
        extrapolate = i % 2 == 0
        jp, js = jstep(g, js, jp, lr=1e-3, extrapolate=jnp.asarray(extrapolate),
                       lr_scales=scales)
        ts = tstep([torch.from_numpy(a) for a in g], ts, tp, 1e-3, extrapolate,
                   scales)
        for a, b in zip(tp, jp):
            _close(a.numpy(), b, what=f"{name} call {i}")
        assert int(ts["count"]) == int(js.count)


@pytest.mark.parametrize("conf", [
    {}, {"lr_policy": "constant"},
    {"lr_policy": "step", "lr_step_size": 5, "lr_gamma": 0.5},
    {"lr_policy": "multi_step", "lr_milestones": 15, "lr_step_size": 5},
    {"lr_policy": "multi_step", "lr_milestones": [3, 10, 11], "lr_gamma": 0.1},
])
def test_lr_schedule_matches_jax(conf):
    j, t = JO.make_lr_schedule(conf), TO.make_lr_schedule(conf)
    for epoch in range(60):
        assert t(epoch) == pytest.approx(j(epoch), rel=1e-12), epoch


def test_clamp_params_matches_jax():
    rng = np.random.default_rng(16)
    p = rng.standard_normal((4, 5)).astype(np.float32) * 0.02
    want = JO.clamp_params({"a": p}, -0.01, 0.01)["a"]
    t = torch.from_numpy(p.copy())
    TO.clamp_params([t], -0.01, 0.01)
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))
