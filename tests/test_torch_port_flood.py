"""The port's flood inference vs the JAX package's, end to end, f32 on the
CPU at tiny_opts(64).

JAX runs ``build_infer_fn(..., freeze_spectral=True)`` on
``bake_spectral_norm(variables)``; the port runs its ``build_infer_fn`` on
``state_dict_from_jax(variables)`` (baking spectral kernels itself) with the
Perlin draws of JAX's ``jax.random.split(rng, 3)[1]``. Bars: the smooth mask
within atol 1e-4, the uint8 flood within 1 LSB everywhere (PARITY.md, "Round
3 additions"), and at bin_value=0.5 the binarized masks agree on >= 99.9% of
pixels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climategan_tpu.inference import build_infer_fn as jax_build_infer_fn
from climategan_tpu.utils.bn_fold import bake_spectral_norm
from climategan_torch.inference import build_infer_fn
from climategan_torch.models.generator import GenConfig
from climategan_torch.utils.convert import state_dict_from_jax
from tests.torch_port_common import tiny_pair

BIN_VALUES = (-1.0, 0.5)


@pytest.fixture(scope="module")
def runs():
    jopts, topts, _, V, _ = tiny_pair(64, seed=3)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    uniform = torch.from_numpy(np.array(
        jax.random.uniform(jax.random.split(rng, 3)[1], (9, 9))))
    baked = bake_spectral_norm(V)
    sd = state_dict_from_jax(V, GenConfig.from_opts(topts))
    out = {}
    for bin_value in BIN_VALUES:
        _, jinfer = jax_build_infer_fn(
            jopts, dtype=jnp.float32, bin_value=bin_value,
            ignore_event=("wildfire", "smog"), donate=False,
            freeze_spectral=True)
        want = {k: np.asarray(v) for k, v in jinfer(baked, x, rng).items()}
        _, infer = build_infer_fn(topts, dtype=torch.float32,
                                  bin_value=bin_value,
                                  ignore_event=("wildfire", "smog"),
                                  device="cpu", state_dict=sd)
        got = {k: v.numpy() for k, v in infer(torch.from_numpy(x),
                                              uniform=uniform).items()}
        out[bin_value] = (want, got)
    return out


@pytest.mark.parametrize("bin_value", BIN_VALUES)
def test_outputs_have_the_jax_keys_shapes_and_dtypes(runs, bin_value):
    want, got = runs[bin_value]
    assert sorted(got) == sorted(want) == ["flood", "mask"]
    for k in want:
        assert got[k].shape == want[k].shape
        assert got[k].dtype == want[k].dtype


def test_smooth_mask_matches(runs):
    want, got = runs[-1.0]
    print(f"mask: max abs error {np.abs(got['mask'] - want['mask']).max():.2e}")
    np.testing.assert_allclose(got["mask"], want["mask"], rtol=0, atol=1e-4)


def test_flood_uint8_within_one_lsb(runs):
    want, got = runs[-1.0]
    diff = np.abs(got["flood"].astype(int) - want["flood"].astype(int))
    print(f"flood: max {diff.max()} LSB, {100 * np.mean(diff > 0):.4f}% of "
          f"values differ")
    assert diff.max() <= 1, diff.max()


def test_binarized_masks_agree(runs):
    want, got = runs[0.5]
    agree = np.mean((got["mask"] > 0.5) == (want["mask"] > 0.5))
    assert agree >= 0.999, agree


def test_flood_where_the_binarized_masks_agree(runs):
    want, got = runs[0.5]
    if np.array_equal(got["mask"] > 0.5, want["mask"] > 0.5):
        diff = np.abs(got["flood"].astype(int) - want["flood"].astype(int))
        assert diff.max() <= 1, diff.max()
