"""Port modules vs the JAX package at tiny_opts(64) widths, f32 on the CPU.

The same numpy-drawn weights go to both sides (the port's through
state_dict_from_jax); each port method is compared with the matching
``G.apply(..., method=...)``. Bar: rtol = atol = 1e-4; the largest error
measured when these tests were written was 1.1e-5 (paint).
"""
import jax
import numpy as np
import pytest
import torch

from climategan_tpu.ops.image import normalize as jax_normalize
from climategan_tpu.ops.image import unit_range_to_uint8 as jax_to_uint8
from climategan_tpu.ops.interpolate import resize as jax_resize
from climategan_tpu.ops.perlin import mix_noise as jax_mix_noise
from climategan_torch.ops.image import normalize, unit_range_to_uint8
from climategan_torch.ops.interpolate import resize
from climategan_torch.ops.perlin import mix_noise
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
