"""Port modules vs the JAX package at tiny_opts(64) widths, f32 on the CPU.

The same numpy-drawn weights go to both sides (the port's through
state_dict_from_jax); each port method is compared with the matching
``G.apply(..., method=...)``. Bar: rtol = atol = 1e-4; the largest error
measured when these tests were written was 1.1e-5 (paint).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climategan_tpu.models.norms import AdaptiveInstanceNorm as JaxAdaIN
from climategan_tpu.ops.image import normalize as jax_normalize
from climategan_tpu.ops.image import uint8_to_unit_range as jax_to_unit
from climategan_tpu.ops.image import unit_range_to_uint8 as jax_to_uint8
from climategan_tpu.ops.interpolate import resize as jax_resize
from climategan_tpu.ops.interpolate import resize_like as jax_resize_like
from climategan_tpu.ops.perlin import mix_noise as jax_mix_noise
from climategan_torch.models.norms import AdaptiveInstanceNorm
from climategan_torch.ops.image import (
    normalize,
    uint8_to_unit_range,
    unit_range_to_uint8,
)
from climategan_torch.ops.interpolate import resize, resize_like
from climategan_torch.ops.perlin import mix_noise
from climategan_torch.parallel import spatial
from climategan_torch.utils.native import uint8_to_m11
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    compiled,
    nchw,
    once_per_session,
    one_thread,
    tiny_pair,
    to_nhwc,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    m = (rng.uniform(size=(2, 64, 64, 1)) > 0.5).astype(np.float32)
    return x, m


def _jax_outputs(G, V):
    """JAX's modules on ``_inputs()``, numpy: one graph, compiled with
    ``OPT0`` (op-by-op dispatch of the same calls took about a minute on
    one core)."""
    x, m = _inputs()

    def outputs(V, x, m):
        z = G.apply(V, x, method="encode")
        d, z_depth = G.apply(V, z, method="depth")
        return {
            "z_high": z[0], "z_low": z[1], "depth": d, "z_depth": z_depth,
            "seg": G.apply(V, z, z_depth, method="segmentation"),
            "mask": G.apply(V, x=None, z=z, method="mask"),
            "paint": G.apply(V, m, x, method="paint"),
        }

    return jax.tree_util.tree_map(np.asarray,
                                  compiled(outputs, V, x, m)(V, x, m))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One pass of both models over the same input; every test reads it.
    JAX's outputs are computed once per session (``once_per_session``)."""
    _, _, G, V, tG = tiny_pair(64)
    x, m = _inputs()
    out = {"jax": once_per_session(tmp_path_factory, "torch_port_modules",
                                   lambda: _jax_outputs(G, V))}
    with torch.no_grad():
        tz = tG.encode(nchw(x))
        td, tz_depth = tG.depth(tz)
        out["torch"] = {
            "z_high": tz[0], "z_low": tz[1], "depth": td, "z_depth": tz_depth,
            "seg": tG.segmentation(tz, tz_depth),
            "mask": tG.mask(tz),
            "paint": tG.paint(nchw(m), nchw(x)),
        }
    return out


@pytest.mark.parametrize("name", ["z_high", "z_low", "depth", "z_depth",
                                  "seg", "mask", "paint"])
def test_module_matches_jax(run, name):
    want = np.asarray(run["jax"][name])
    got = to_nhwc(run["torch"][name])
    assert got.shape == want.shape
    print(f"{name}: max abs error {np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size,mode,align_corners", [
    ((32, 48), "nearest", False),   # integer upsample
    ((4, 6), "nearest", False),     # integer downsample
    ((13, 7), "nearest", False),    # non-integer ratio
    ((37, 29), "bilinear", False),
    ((37, 29), "bilinear", True),
    ((384, 384), "bicubic", False),
])
def test_resize_matches_jax(size, mode, align_corners):
    x = np.random.default_rng(3).standard_normal((2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jax_resize(x, size, mode, align_corners=align_corners))
    got = to_nhwc(resize(nchw(x), size, mode, align_corners=align_corners))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_normalize_and_uint8_match_jax():
    x = np.random.default_rng(4).uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_normalize(x)), rtol=1e-6,
                               atol=1e-6)
    got = unit_range_to_uint8(torch.from_numpy(x)).numpy().astype(int)
    want = np.asarray(jax_to_uint8(x)).astype(int)
    assert np.abs(got - want).max() <= 1


def test_mix_noise_matches_jax_on_the_same_draws():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    sky = (rng.uniform(size=(2, 64, 64, 1)) > 0.3).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jax_mix_noise(key, x, sky, res=(8, 8), weight=0.8))
    uniform = torch.from_numpy(np.array(jax.random.uniform(key, (9, 9))))
    got = to_nhwc(mix_noise(nchw(x), nchw(sky), res=(8, 8), weight=0.8,
                            uniform=uniform))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_uint8_to_unit_range_matches_jax_exactly():
    x = np.random.default_rng(7).integers(0, 256, (2, 9, 11, 3),
                                          dtype=np.uint8)
    x.flat[:2] = (0, 255)
    got = uint8_to_unit_range(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_to_unit(x)))
    np.testing.assert_array_equal(got.numpy(), uint8_to_m11(x))
    assert got.min() == -1.0 and got.max() == 1.0


RESIZE_LIKE = [("nearest", False), ("bilinear", False), ("bilinear", True),
               ("bicubic", False), ("bicubic", True)]


@pytest.mark.parametrize("mode,align_corners", RESIZE_LIKE)
def test_resize_like_matches_jax(mode, align_corners):
    """To a larger and to a smaller reference, on values in the images'
    range [-1, 1]: 1e-6, bicubic 1e-5 as test_resize_matches_jax (JAX's
    f32 operator holds weights computed in float64, torch computes them in
    f32; the bicubic ones differ by up to 1.7e-6 here, and the error grows
    with the values: 2.3e-6 for bilinear on a standard normal draw)."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, 13, 10, 3)).astype(np.float32)
    tol = 1e-5 if mode == "bicubic" else 1e-6
    for ref_hw in ((29, 17), (6, 7)):
        ref = np.zeros((1,) + ref_hw + (5,), np.float32)
        want = np.asarray(jax_resize_like(x, ref, mode, align_corners))
        got = resize_like(nchw(x), nchw(ref), mode, align_corners)
        assert got.shape[-2:] == ref_hw
        np.testing.assert_allclose(to_nhwc(got), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("mode,align_corners", RESIZE_LIKE)
def test_resize_like_on_rows(mode, align_corners, k):
    """A sharded ``x`` goes through ``spatial.resize`` to the reference's
    whole height and width, the same tensors bit for bit; a sharded
    reference gives its whole map's size. Against the unsharded resize,
    which interpolates the rows with ``F.interpolate`` and not the rows'
    operator: nearest exactly, the others within the bar of
    tests/test_torch_port_spatial.py (1e-5)."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn((2, 3, 13, 10), generator=g)
    ref = torch.zeros((1, 5, 29, 17))
    devices = ["cpu"] * k
    xr, rr = spatial.shard_rows(x, devices), spatial.shard_rows(ref, devices)
    want = resize_like(x, ref, mode, align_corners)
    direct = spatial.resize(xr, (29, 17), mode, align_corners)
    for r in (ref, rr):
        got = resize_like(xr, r, mode, align_corners)
        assert isinstance(got, spatial.Rows) and got.starts == direct.starts
        for a, b in zip(got.parts, direct.parts):
            assert torch.equal(a, b)
        if mode == "nearest":
            assert torch.equal(got.gather("cpu"), want)
        else:
            torch.testing.assert_close(got.gather("cpu"), want, rtol=0,
                                       atol=1e-5)
    assert torch.equal(resize_like(x, rr, mode, align_corners), want)


def _adain_inputs(dtype, seed=10):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 7, 5, 6)) * 3 + 1).astype(dtype)
    w = rng.uniform(0.5, 1.5, 6).astype(dtype)
    b = rng.uniform(-0.5, 0.5, 6).astype(dtype)
    cot = rng.standard_normal((2, 7, 5, 6)).astype(dtype)
    return x, w, b, cot


def _adain_port(x, w, b, cot, k=0):
    """The port's output (NHWC numpy) and gradients of (x, weight, bias)
    under the cotangent ``cot``: ``forward``, or ``forward_rows`` over
    ``k`` CPU shards."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    norm = AdaptiveInstanceNorm()
    if k:
        out = norm.forward_rows(spatial.shard_rows(xt, ["cpu"] * k), wt,
                                bt).gather("cpu")
    else:
        out = norm(xt, wt, bt)
    out.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    return (to_nhwc(out.detach()), to_nhwc(xt.grad), wt.grad.numpy(),
            bt.grad.numpy())


def _adain_f64(x, w, b, eps=1e-5):
    """AdaIN's formula with its statistics in float64 (the JAX package's
    module keeps them in f32 whatever the input's dtype)."""
    mean = x.mean(axis=(1, 2), keepdims=True)
    var = ((x - mean) ** 2).mean(axis=(1, 2), keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * w + b


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_adain_forward_and_gradients_match_jax(dtype):
    """The output and the gradients of x, weight and bias under one
    cotangent against ``jax.vjp`` of the JAX package's module: 1e-5 in
    f32; in float64 1e-6 against the module (its statistics are f32) and
    1e-12 against the same formula with float64 statistics."""
    x, w, b, cot = _adain_inputs(dtype)
    refs = [(lambda *a: JaxAdaIN().apply({}, *a), 1e-5 if dtype == "float32"
             else 1e-6)]
    if dtype == "float64":
        refs.append((_adain_f64, 1e-12))
    got = _adain_port(x, w, b, cot)
    assert got[0].dtype == np.dtype(dtype)
    for fn, tol in refs:
        with jax.enable_x64(dtype == "float64"):
            out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b))
            want = [np.asarray(v) for v in (out, *vjp(jnp.asarray(cot)))]
        for name, g, v in zip(("out", "dx", "dweight", "dbias"), got, want):
            np.testing.assert_allclose(g, v, rtol=tol, atol=tol,
                                       err_msg=f"{name} at {tol}")
    assert not list(AdaptiveInstanceNorm().state_dict())


@pytest.mark.parametrize("k", [2, 3])
def test_adain_forward_rows_matches_forward(k):
    """float64 over 2 and 3 row shards (of 7 rows: uneven), the output
    and the three gradients."""
    args = _adain_inputs("float64", seed=11)
    for name, g, v in zip(("out", "dx", "dweight", "dbias"),
                          _adain_port(*args, k=k), _adain_port(*args)):
        np.testing.assert_allclose(g, v, rtol=1e-12, atol=1e-12,
                                   err_msg=name)


def test_adain_bf16_within_one_ulp_of_its_f32():
    """bf16 x, weight and bias: one rounding of the f32 math at the end,
    so each value within one bf16 ulp of the f32 path on the same input
    (JAX's module rounds on the way: 2.07 ulp of the largest value on
    a 2 x 64 x 64^2 draw)."""
    x, w, b, _ = _adain_inputs("float32", seed=12)
    x16, w16, b16 = (torch.from_numpy(a).bfloat16() for a in (x, w, b))
    norm = AdaptiveInstanceNorm()
    got = norm(x16.permute(0, 3, 1, 2), w16, b16)
    want = norm(x16.float().permute(0, 3, 1, 2), w16.float(), b16.float())
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert bool(((got.float() - want).abs() <= ulp).all())
