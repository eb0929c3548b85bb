"""The other generator configurations of the port against the JAX package,
module by module, f32 on the CPU at tiny_opts(32) widths.

* ``spade_cond``'s bf16 layout for 9..16 conditioning channels (16 a
  window pixel, one tap a k16 step), read back by its packed plain twin,
  against the Pallas kernel in interpret mode; the layout for cnc <= 8
  unchanged.
* The modules, in three configurations that between them set every switch
  the port took up (the same numpy-drawn weights on both sides through
  ``state_dict_from_jax``; each port module fed the JAX module's own
  inputs):
    A: the SPADE mask decoder at cond_nc 15, the base depth decoder in
       regression, the painter's final shortcut;
    B: the SPADE mask decoder at cond_nc 12, the MobileNetV2 encoder and
       its separable seg head, the painter with z (JAX's draw fed in);
    C: the DeepLab v2 encoder and seg decoder, depth classification (8
       buckets), batch-norm SPADEs in the painter;
  and a batch-norm SPADE block alone, in eval and in train mode.
* The classification and berHu depth losses on a depth head's output.

Bars: f32 noise, rtol = atol = 1e-4 (the JAX package's own for the heads);
the kernel layouts as tests/test_torch_port_kernels.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from climategan_tpu import losses as JL
from climategan_tpu.models.blocks import SPADEResnetBlock as JaxSPADEBlock
from climategan_tpu.ops.pallas.spade import spade_cond as jax_spade_cond
from climategan_torch import losses as L
from climategan_torch.kernels.spade_cond import (
    pack_spade_cond,
    spade_cond_packed_plain,
)
from climategan_torch.models.blocks import SPADEResnetBlock
from climategan_torch.models.generator import GenConfig
from climategan_torch.utils.convert import _spade_block, state_dict_from_entries
from climategan_torch.utils.opts import load_opts
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    SIZE,
    fill_like,
    nchw,
    one_thread,
    pair,
    to_nhwc,
)

TOL = dict(rtol=1e-4, atol=1e-4)
def _assert_close(got: torch.Tensor, want, what: str = ""):
    want = np.asarray(want)
    got = to_nhwc(got) if got.ndim == 4 else got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    print(f"{what}: max abs error {np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)


# ---- spade_cond: the wide window ---------------------------------------

def _spade_case(cnc, hids=(128, 128), ncs=(16, 32), H=8, W=16, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    return (r(2, H, W, cnc), r(3, 3, cnc, sum(hids)), r(sum(hids)),
            [(r(3, 3, h, nc) / np.sqrt(h), r(nc), r(3, 3, h, nc) / np.sqrt(h),
              r(nc)) for h, nc in zip(hids, ncs)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cnc", [12, 15, 16])
def test_wide_window_pack_matches_the_pallas_kernel(cnc, dtype):
    """A dual call at the mask decoder's widths (hid 128 + 128): in f32
    within 2e-5 of the Pallas kernel; in bf16 (both round the activation
    and the output to bf16) within one bf16 ulp of each output's scale."""
    seg, k1, b1, branches = _spade_case(cnc)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    pack = pack_spade_cond(t(k1), t(b1), [tuple(map(t, b)) for b in branches],
                           route="wgmma")
    assert pack.w1.numel() == 2 * 128 * 9 * 16  # 9 taps x 16 channels
    got = spade_cond_packed_plain(t(seg), pack)
    want = jax_spade_cond(jnp.asarray(seg, jdt), jnp.asarray(k1, jdt),
                          jnp.asarray(b1, jdt),
                          [tuple(jnp.asarray(a, jdt) for a in b)
                           for b in branches], interpret=True)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max()
        bar = (2e-5 * (1 + np.abs(w).max()) if dtype == "float32"
               else 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7))
        print(f"cnc {cnc} {dtype}: max abs error {err:.2e} (bar {bar:.2e})")
        assert err <= bar


@pytest.mark.parametrize("cnc", [3, 8])
def test_narrow_window_pack_keeps_its_layout(cnc):
    """cnc <= 8 keeps the (10 taps, hid_pad, 8) w1 of the painter's calls,
    tap 9 and the channels past cnc zero, byte for byte."""
    _, k1, b1, branches = _spade_case(cnc, hids=(128, 24), ncs=(20, 8))
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    k1t = bf(k1)
    pack = pack_spade_cond(k1t, bf(b1), [tuple(map(bf, b)) for b in branches])
    want, off = [], 0
    for h in (128, 24):
        w = k1t[..., off:off + h].reshape(9, cnc, h).permute(0, 2, 1)
        want.append(F.pad(w, (0, 8 - cnc, 0, -(-h // 32) * 32 - h, 0, 1))
                    .reshape(-1))
        off += h
    assert torch.equal(pack.w1.view(torch.int16),
                       torch.cat(want).view(torch.int16))


# ---- a batch-norm SPADE block alone --------------------------------------

@pytest.fixture(scope="module")
def spade_block():
    """A JAX SPADE block (fin 16 -> fout 8, cond_nc 15, batch param-free
    norms, a closing leaky relu: the mask decoder's) and its numpy-drawn
    variables; x at 8^2, the conditioning at 16^2."""
    blk = JaxSPADEBlock(fin=16, fout=8, cond_nc=15, param_free_norm="batch",
                        last_activation="lrelu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    seg = rng.uniform(0, 1, (2, 16, 16, 15)).astype(np.float32)
    shapes = jax.eval_shape(blk.init, jax.random.PRNGKey(0), x, seg)
    return blk, fill_like(shapes, 4), x, seg


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_batch_norm_spade_block(spade_block, mode):
    """Eval: running statistics, norm_s and norm_0 in one (plain) dual
    spade_cond call. Train: the batch statistics, the conditioning on the
    live convs; the running statistics advance as flax's (momentum 0.9,
    the biased batch variance)."""
    blk, V, x, seg = spade_block
    sd = state_dict_from_entries(V, _spade_block("b", (), True, True))
    tb = SPADEResnetBlock(16, 8, 15, True, "batch", "lrelu")
    tb.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    if mode == "eval":
        want = blk.apply(V, x, seg, train=False)
        with torch.no_grad():
            got = tb.eval()(nchw(x), nchw(seg))
        _assert_close(got, want, "eval block")
        return
    want, new = blk.apply(V, x, seg, train=True, mutable=["batch_stats"])
    got = tb.train()(nchw(x), nchw(seg))
    _assert_close(got, want, "train block")
    for n in ("norm_s", "norm_0", "norm_1"):
        bn = getattr(tb, n).param_free_norm
        stats = new["batch_stats"][n]["param_free_norm"]
        for ours, theirs in ((bn.running_mean, stats["mean"]),
                             (bn.running_var, stats["var"])):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       rtol=1e-5, atol=1e-6, err_msg=n)


# ---- the three configurations --------------------------------------------

def _t(z):
    """JAX encoder output (an array or a pair) as the port's."""
    return [nchw(a) for a in z] if isinstance(z, (list, tuple)) else nchw(z)


@pytest.mark.parametrize("name", ["A", "B"])
def test_mask_spade_decoder(name):
    """make_m_cond (cond_nc 15: with x; 12: without) and the SPADE mask
    decoder's logits on JAX's z and cond."""
    G, V, tG, x, z, call = pair(name)
    d, zd = call(z, method="depth")
    s = call(z, zd, method="segmentation")
    cond = call(d, s, x, method="make_m_cond")
    want = call(z, cond, method="mask_logits")
    assert cond.shape[-1] == G.cfg.m_spade_cond_nc
    with torch.no_grad():
        _assert_close(tG.make_m_cond(nchw(d), nchw(s), nchw(x)), cond, "cond")
        _assert_close(tG.decoders["m"](_t(z), nchw(cond)), want, "logits")


@pytest.mark.parametrize("name", ["A", "C"])
def test_base_depth_decoder(name):
    """Regression (A, one channel) and classification (C, bucket logits,
    and depth_map's normalized argmax)."""
    G, V, tG, x, z, call = pair(name)
    d, zd = call(z, method="depth")
    assert zd is None
    with torch.no_grad():
        td, tzd = tG.depth(_t(z))
        assert tzd is None
        _assert_close(td, d, "depth")
        if name == "C":
            assert d.shape[-1] == 8
            want = call(x, method="depth_map")
            _assert_close(tG.depth_map(nchw(d)), want, "depth_map")


def test_mobilenet_encoder_and_seg_head():
    G, V, tG, x, z, call = pair("B")
    d, zd = call(z, method="depth")
    want = call(z, zd, method="segmentation")
    with torch.no_grad():
        tz = tG.encode(nchw(x))
        _assert_close(tz[0], z[0], "z_high (320 ch)")
        _assert_close(tz[1], z[1], "z_low (24 ch)")
        _assert_close(tG.segmentation(_t(z), nchw(zd)), want, "seg")


def test_deeplab_v2_encoder_and_decoder():
    G, V, tG, x, z, call = pair("C")
    want = call(z, None, method="segmentation")
    with torch.no_grad():
        _assert_close(tG.encode(nchw(x)), z, "z (2048 ch)")
        _assert_close(tG.segmentation(nchw(z)), want, "seg")


@pytest.mark.parametrize("name,what", [("B", "z"), ("A", "final shortcut"),
                                       ("C", "batch norms")])
def test_painter(name, what):
    """paint(m, x): with z, JAX's draw from the key is fed to the port."""
    G, V, tG, x, _, call = pair(name)
    m = (np.random.default_rng(7).uniform(size=(2, SIZE, SIZE, 1)) > 0.5) \
        .astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = call(m, x, key, method="paint")
    z = None
    if what == "z":
        z = G.apply(V, key, 2, SIZE, SIZE, method="sample_painter_z")
        z = nchw(z)
    with torch.no_grad():
        _assert_close(tG.paint(nchw(m), nchw(x), z=z), want, f"paint ({what})")


# ---- depth losses ----------------------------------------------------------

@pytest.mark.parametrize("loss", ["classification", "dada"])
def test_depth_loss_matches_jax(loss):
    """The bucket cross-entropy on C's depth logits and berHu on A's
    regression depth, against random targets."""
    G, V, tG, x, z, call = pair("C" if loss == "classification" else "A")
    d, _ = call(z, method="depth")
    rng = np.random.default_rng(9)
    if loss == "classification":
        target = rng.integers(0, 8, d.shape[:3]).astype(np.int32)
        want = JL.cross_entropy(d, target)
        got = L.cross_entropy(nchw(d), torch.from_numpy(target).long())
    else:
        target = rng.uniform(0.01, 1, d.shape).astype(np.float32)
        want = JL.dada_depth_loss(d, target)
        got = L.dada_depth_loss(nchw(d), nchw(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_classification_with_the_spade_masker_is_refused():
    """A cond of bucket logits would be buckets + 14 channels wide: the
    port refuses it with that reason; a SPADE kernel size other than 3 is
    not ported."""
    opts = load_opts(commandline_opts=["gen.m.use_spade=true",
                                       "gen.d.classify.enable=true"])
    with pytest.raises(ValueError, match=r"buckets \+ 14"):
        GenConfig.from_opts(opts)
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        GenConfig.from_opts(load_opts(commandline_opts=[
            "gen.p.spade_kernel_size=5"]))
