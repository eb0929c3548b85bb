"""The port's FID (``climategan_torch/fid.py``) against the JAX package's
``fid.py`` on the CPU.

One module fixture gives both sides the same Inception weights: the
port's network re-initialized as tests/test_fid.py re-initializes its
torch twin (He-normal convs, so that images do not collapse to one
feature vector) with batch-norm statistics and affine values drawn near
identity, saved as a torchvision-layout ``.pth`` and read by JAX's
``load_inception_weights``. The images are 4 + 4 structured 64^2 scenes
(tests/test_fid.py's: i.i.d. noise images are indistinguishable to any
network), resized to 299^2 by each side.

Bars: features within 1e-4 of their largest magnitude; the Newton-Schulz
square root and the Frechet distance (float64) within 1e-9 relative; the
end-to-end FID within 1e-3 relative (f32 features through a 2048-wide
covariance of 4 samples, the ill-conditioned regime FID lives in).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climategan_tpu import fid as jax_fid
from climategan_tpu.utils.convert import (
    load_inception_weights as jax_load_inception_weights,
)
from climategan_torch import fid
from climategan_torch.utils.convert import (
    inception_state_dict_from_jax,
    load_inception_weights,
)
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    once_per_session,
    one_thread,
    zeros_like_tree,
)


def scenes(seed, kind, n=4, size=64):
    """tests/test_fid.py's structured scenes: a horizon or stripes of a
    per-image color, with a little noise, NHWC in [-1, 1]."""
    rs = np.random.RandomState(seed)
    out = np.zeros((n, size, size, 3), np.float32)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for i in range(n):
        base = rs.uniform(-0.8, 0.8, 3)
        if kind == "horizon":
            img = np.where((yy < rs.uniform(0.3, 0.7))[..., None], base, -base)
        else:
            img = base * np.sin(2 * np.pi * rs.uniform(2, 10) * xx
                                + rs.uniform(0, 6))[..., None]
        out[i] = np.clip(img + rs.normal(0, 0.05, (size, size, 3)), -1, 1)
    return out


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(port evaluator, the JAX side's results on the same weights, the
    .pth, real and fake NHWC images). The JAX side (``_jax_side``) is
    computed once per test session."""
    g = torch.Generator().manual_seed(11)
    model = fid.InceptionV3Features().init_weights(g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(0.8 + 0.4 * torch.rand(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.05 * torch.randn(n, generator=g))
                m.running_var.copy_(0.8 + 0.4 * torch.rand(n, generator=g))
    path = tmp_path_factory.mktemp("inception") / "pt_inception.pth"
    torch.save(model.state_dict(), str(path))
    ev = fid.FIDEvaluator(load_inception_weights(
        str(path), fid.InceptionV3Features()), batch_size=4, device="cpu")
    real, fake = scenes(5, "horizon"), scenes(6, "stripes")
    jax_side = once_per_session(tmp_path_factory, "torch_port_fid_jax",
                                lambda: _jax_side(path, real, fake))
    return ev, jax_side, path, real, fake


def _jax_side(path, real, fake):
    """JAX's evaluator on the .pth's weights: its variables (numpy), the
    real images' features, and ``set_real`` then ``fid`` of the fakes."""
    # JAX's variables as the loader's template: zeros of the init's shapes
    # (an eager init at 299^2 takes most of a minute on one core), every
    # leaf then read from the .pth
    shapes = jax.eval_shape(jax_fid.InceptionV3Features().init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 299, 299, 3), jnp.float32))
    jev = jax_fid.FIDEvaluator(variables=jax_load_inception_weights(
        str(path), zeros_like_tree(shapes)), batch_size=4)
    features = jev.features(jnp.asarray(real))
    jev.set_real(jnp.asarray(real))
    return {"variables": jax.tree_util.tree_map(np.asarray, jev.variables),
            "features": features, "fid": jev.fid(jnp.asarray(fake))}


def test_features_match_jax(pair):
    """(4, 2048) features of the same images, resized to 299^2 on each
    side, within 1e-4 of their largest; not collapsed to one vector."""
    ev, jax_side, _, real, _ = pair
    got = ev.features(_nchw(real)).numpy()
    want = jax_side["features"]
    assert got.shape == want.shape == (4, fid.FEATURES)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    assert want.std(axis=0).max() > 1e-3 * scale


def test_inception_state_dict_round_trips_through_jax(pair):
    """JAX's ``load_inception_weights`` reads the port's state dict, and
    ``inception_state_dict_from_jax`` gives it back, key for key."""
    ev, jax_side, _, _, _ = pair
    back = inception_state_dict_from_jax(jax_side["variables"])
    own = ev.model.state_dict()
    assert set(back) == set(own)
    for k, v in own.items():
        assert torch.equal(back[k].to(v.dtype), v), k


def test_load_inception_weights_takes_a_torchvision_file(tmp_path, pair):
    """A torchvision-layout file with a classifier and an auxiliary head
    loads (those keys unread); a file without a trunk key raises."""
    ev = pair[0]
    sd = dict(ev.model.state_dict())
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    full = tmp_path / "tv.pth"
    torch.save(sd, str(full))
    got = load_inception_weights(str(full), fid.InceptionV3Features())
    assert torch.equal(got.Mixed_7c.branch_pool.conv.weight,
                       ev.model.Mixed_7c.branch_pool.conv.weight)
    del sd["Mixed_6b.branch1x1.bn.running_var"]
    part = tmp_path / "part.pth"
    torch.save(sd, str(part))
    with pytest.raises(KeyError, match="Inception keys missing"):
        load_inception_weights(str(part), fid.InceptionV3Features())


@pytest.mark.parametrize("n,d", [(300, 64), (8, 256)])
def test_sqrtm_and_frechet_match_jax(n, d):
    """The float64 Newton-Schulz square root of a covariance product and
    the Frechet distance against JAX's (numpy), well-conditioned and
    rank-deficient (n < d)."""
    rs = np.random.RandomState(7)
    f1 = rs.randn(n, d) * 0.5 + 0.1
    f2 = rs.randn(n, d) * 0.7 - 0.2
    m1, s1 = jax_fid.activation_statistics(f1)
    m2, s2 = jax_fid.activation_statistics(f2)
    tm1, ts1 = fid.activation_statistics(torch.from_numpy(f1))
    tm2, ts2 = fid.activation_statistics(torch.from_numpy(f2))
    np.testing.assert_allclose(ts1.numpy(), s1, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tm2.numpy(), m2, rtol=1e-12, atol=1e-12)
    prod = (s1 + 1e-6 * np.eye(d)) @ (s2 + 1e-6 * np.eye(d))
    want = jax_fid._sqrtm_newton_schulz(prod)
    got = fid._sqrtm_newton_schulz(torch.from_numpy(prod)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    np.testing.assert_allclose(
        fid.frechet_distance(tm1, ts1, tm2, ts2),
        jax_fid.frechet_distance(m1, s1, m2, s2), rtol=1e-9)
    assert fid.frechet_distance(tm1, ts1, tm1, ts1) < 1e-4


def test_fid_from_features_matches_jax():
    """``compute_fid_from_features`` on two seeded (64, 32) float64 feature
    sets, as arrays and as tensors, against JAX's to a relative 1e-6."""
    rs = np.random.RandomState(13)
    real = rs.randn(64, 32)
    fake = rs.randn(64, 32) * 1.2 + 0.3
    want = jax_fid.compute_fid_from_features(real, fake)
    assert want > 1.0
    for a, b in ((real, fake), (torch.from_numpy(real), torch.from_numpy(fake))):
        np.testing.assert_allclose(fid.compute_fid_from_features(a, b), want,
                                   rtol=1e-6)


def test_fid_end_to_end_matches_jax(pair):
    """``FIDEvaluator.set_real`` then ``fid`` on the same weights and
    images as JAX's: the same, and far from 0 (distinct scenes)."""
    ev, jax_side, _, real, fake = pair
    ev.set_real(_nchw(real))
    got = ev.fid(_nchw(fake))
    want = jax_side["fid"]
    assert np.isfinite(got) and want > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-3)
    with pytest.raises(RuntimeError, match="set_real"):
        fid.FIDEvaluator(ev.model, batch_size=4, device="cpu").fid(_nchw(fake))
