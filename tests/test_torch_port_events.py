"""The port's wildfire and smog events vs the JAX package's, f32 on the CPU.

- the plain twins of ``smog_tail``, ``fire_color_grade`` and ``fire_paste``
  vs the JAX Pallas kernels (interpret mode) at (2, 32, 128), and the first
  two on the branch-point and floor-step values that the card tests
  (tests/test_torch_port_cuda.py) hold the kernels to;
- the ops the events use (normalize, sRGB<->linear, sky mask, blur, box
  dilation);
- ``add_smog`` and ``add_fire`` vs JAX's (``use_pallas=True``) on the same
  x, seg logits and depth, with JAX's ``g_value``;
- ``build_infer_fn(ignore_event=())`` at tiny_opts(64) vs the JAX ``infer``
  on the same converted weights, Perlin draws and ``g_value``, and the
  same model row-sharded over 2, 3 and 4 CPU shards
  (``build_spatial_infer_fn``; at 64^2, 3 shards split the maps unevenly
  and 4 give the encoder 2-row shards under layer4's 16-row dilation) vs
  the same JAX ``infer`` and vs the unsharded port;
- the kernel wrappers' CPU dispatch and checks.

Bars: ``smog_tail`` rtol = atol = 1e-5 (the JAX package's own Pallas-vs-jnp
bar); the fire kernels within 1.0 and equal on >= 99.9% of values (a floor
step crossed by the CPU's own multiply-add contraction); events within 1
uint8 LSB (PARITY.md, "Round 3 additions"); mask within 1e-4. The
row-sharded forward: within 1 LSB of JAX's, the mask within 1e-4 (the JAX
package's own bar for its row-sharded forward against its single one,
tests/test_mesh_equivalence.py); against the unsharded port within 1 LSB
on >= 99.9% of values, the mask within 1e-5. The measured errors print
under ``pytest -s``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climategan_tpu.events.fire import add_fire as jax_add_fire
from climategan_tpu.events.fire import increase_sky_mask as jax_increase_sky_mask
from climategan_tpu.events.smog import add_smog as jax_add_smog
from climategan_tpu.inference import build_infer_fn as jax_build_infer_fn
from climategan_tpu.models.norms import frozen_spectral
from climategan_tpu.ops import image as jax_image
from climategan_tpu.ops.blur import box_dilate as jax_box_dilate
from climategan_tpu.ops.blur import gaussian_blur as jax_gaussian_blur
from climategan_tpu.ops.pallas import events as jax_events
from climategan_tpu.utils.bn_fold import bake_spectral_norm
from climategan_torch.events.fire import add_fire, increase_sky_mask
from climategan_torch.events.smog import add_smog
from climategan_torch.inference import (
    build_infer_fn,
    build_spatial_infer_fn,
)
from climategan_torch.kernels import launches, reset_launches
from climategan_torch.kernels.fire_color_grade import (
    fire_color_grade,
    fire_color_grade_plain,
)
from climategan_torch.kernels.fire_paste import fire_paste, fire_paste_plain
from climategan_torch.kernels.smog_tail import smog_tail, smog_tail_plain
from climategan_torch.models.generator import GenConfig
from climategan_torch.ops import image
from climategan_torch.ops.blur import box_dilate, gaussian_blur
from climategan_torch.utils.convert import state_dict_from_jax
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    GRADE_MEANS,
    grade_edge_planes,
    nchw,
    once_per_session,
    one_thread,
    smog_edge_planes,
    tiny_pair,
    to_nhwc,
)

SMOG = dict(airlight=0.76, beta=2.0, yellow=(224.0, 192.0, 29.0), alpha=20.0)
G_VALUE = 123.0


def _planes(seed, shape=(2, 32, 128)):
    """x255 (integers in [0, 255], as after the warm shift), x01, d and sky
    in NHWC numpy."""
    rng = np.random.default_rng(seed)
    n, h, w = shape
    return {
        "x255": np.floor(rng.uniform(0, 256, (n, h, w, 3))).astype(np.float32),
        "x01": rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32),
        "d": rng.uniform(0.1, 1, (n, h, w, 1)).astype(np.float32),
        "sky": rng.uniform(0, 1, (n, h, w, 1)).astype(np.float32),
    }


def _floor_bar(name, got, want, share=0.999):
    diff = np.abs(got - want)
    equal = np.mean(diff == 0)
    print(f"{name}: max abs error {diff.max():.3g}, {100 * equal:.4f}% equal")
    assert diff.max() <= 1.0 and equal >= share, (diff.max(), equal)


# ---- kernel twins vs the JAX Pallas kernels ------------------------------

def test_smog_tail_plain_matches_jax_kernel():
    p = _planes(0)
    want = np.asarray(jax_events.smog_tail(
        p["x01"], p["d"], SMOG["airlight"], SMOG["beta"], SMOG["yellow"],
        SMOG["alpha"]))
    got = to_nhwc(smog_tail_plain(nchw(p["x01"]), nchw(p["d"]), **SMOG))
    print(f"smog_tail: max abs error {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fire_color_grade_plain_matches_jax_kernel():
    p = _planes(1)
    mean = np.float32(np.floor(p["x255"] @ np.float32([0.2989, 0.587, 0.114])).mean())
    want = np.asarray(jax_events.fire_color_grade(p["x255"], jnp.asarray(mean),
                                                  1.5, 0.73))
    got = to_nhwc(fire_color_grade_plain(nchw(p["x255"]), torch.tensor(mean),
                                         1.5, 0.73))
    _floor_bar("fire_color_grade", got, want)


def test_smog_tail_plain_matches_jax_kernel_at_branch_points():
    """The card tests' edge values (tests/test_torch_port_cuda.py): sRGB at
    and beside 0.04045, linear values at and beside 0.0031308 and below
    1e-12, d in {0, 1}."""
    x, d = smog_edge_planes()
    want = np.asarray(jax_events.smog_tail(
        x.transpose(0, 2, 3, 1), d.transpose(0, 2, 3, 1), SMOG["airlight"],
        SMOG["beta"], SMOG["yellow"], SMOG["alpha"]))
    got = to_nhwc(smog_tail_plain(torch.from_numpy(x), torch.from_numpy(d),
                                  **SMOG))
    print(f"smog_tail edges: max abs error {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mean", GRADE_MEANS)
def test_fire_color_grade_plain_matches_jax_kernel_at_floor_steps(mean):
    """The card tests' edge values: 1.5 x - 0.5 mean on an integer for half
    of x, and both clamps met exactly."""
    x = grade_edge_planes()
    want = np.asarray(jax_events.fire_color_grade(
        x.transpose(0, 2, 3, 1), jnp.float32(mean), 1.5, 0.73))
    got = to_nhwc(fire_color_grade_plain(torch.from_numpy(x),
                                         torch.tensor(mean), 1.5, 0.73))
    _floor_bar(f"fire_color_grade edges, mean {mean}", got, want)


def test_fire_paste_plain_matches_jax_kernel():
    p = _planes(2)
    want = np.asarray(jax_events.fire_paste(
        p["x255"], p["sky"], jnp.float32(G_VALUE), 200.0, 0.8))
    got = to_nhwc(fire_paste_plain(nchw(p["x255"]), nchw(p["sky"]),
                                   torch.tensor(G_VALUE), 200.0, 0.8))
    _floor_bar("fire_paste", got, want)


# ---- ops -----------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.3, 1.0), (0.0, 255.0)])
def test_normalize_with_a_range_matches_jax(lo, hi):
    x = np.random.default_rng(3).uniform(-1, 1, (2, 3, 8, 8)).astype(np.float32)
    want = np.asarray(jax_image.normalize(x, lo, hi))
    got = image.normalize(torch.from_numpy(x), lo, hi).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * hi)


@pytest.mark.parametrize("name", ["srgb2lrgb", "lrgb2srgb"])
def test_srgb_conversions_match_jax(name):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1 if name == "srgb2lrgb" else 0, 1,
                    (2, 8, 8, 3)).astype(np.float32)
    x[0, 0, :4, 0] = [0.0, 0.04045, 0.0031308, 1e-13]  # the branch points
    want = np.asarray(getattr(jax_image, name)(x))
    got = to_nhwc(getattr(image, name)(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_retrieve_sky_mask_matches_jax_with_ties():
    rng = np.random.default_rng(5)
    seg = rng.standard_normal((2, 6, 7, 11)).astype(np.float32)
    seg[0, 0, 0, [3, 9]] = 10.0   # tie with a lower class: not sky
    seg[0, 0, 1, [9, 10]] = 10.0  # tie with a higher class: sky
    seg[1, 2, 3, 9] = 10.0
    want = np.asarray(jax_image.retrieve_sky_mask(seg))[..., None]
    got = to_nhwc(image.retrieve_sky_mask(nchw(seg)))
    assert not got[0, 0, 0, 0] and got[0, 0, 1, 0] and got[1, 2, 3, 0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 64, 64, 1), (1, 8, 640, 1)])
def test_gaussian_blur_281_taps_matches_jax(shape):
    x = (np.random.default_rng(6).uniform(size=shape) > 0.7).astype(np.float32)
    want = np.asarray(jax_gaussian_blur(x, 281, 140.5))
    got = to_nhwc(gaussian_blur(nchw(x), 281, 140.5))
    print(f"gaussian_blur {shape}: max abs error {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_box_dilate_and_increase_sky_mask_match_jax():
    mask = (np.random.default_rng(7).uniform(size=(2, 40, 56, 1)) > 0.97
            ).astype(np.float32)
    np.testing.assert_array_equal(to_nhwc(box_dilate(nchw(mask), 3, 5)),
                                  np.asarray(jax_box_dilate(mask, 3, 5)))
    np.testing.assert_array_equal(
        to_nhwc(increase_sky_mask(nchw(mask), 0.18, 0.18)),
        np.asarray(jax_increase_sky_mask(mask, 0.18, 0.18)))


# ---- events --------------------------------------------------------------

@pytest.fixture(scope="module")
def events():
    """add_fire and add_smog of both packages on the same inputs; the seg
    logits favour the sky class in the top rows, so the sky is not empty."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    seg = rng.standard_normal((2, 32, 32, 11)).astype(np.float32)
    seg[:, :12, :, 9] += 2.0
    depth = rng.uniform(0.05, 2.0, (2, 32, 32, 1)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    g_value = float(jax.random.randint(key, (), 100, 151))
    want = {"wildfire": jax_add_fire(x, seg, key, use_pallas=True),
            "smog": jax_add_smog(x, depth, use_pallas=True)}
    got = {"wildfire": add_fire(nchw(x), nchw(seg), g_value=g_value),
           "smog": add_smog(nchw(x), nchw(depth))}
    return {"want": {k: np.asarray(v) for k, v in want.items()},
            "want_u8": {k: np.asarray(jax_image.unit_range_to_uint8(v))
                        for k, v in want.items()},
            "got": {k: to_nhwc(v) for k, v in got.items()},
            "got_u8": {k: to_nhwc(image.unit_range_to_uint8(v))
                       for k, v in got.items()}}


def test_add_smog_floats_match_jax(events):
    got, want = events["got"]["smog"], events["want"]["smog"]
    print(f"add_smog: max abs error {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("event", ["wildfire", "smog"])
def test_events_uint8_within_one_lsb_of_jax(events, event):
    got = events["got_u8"][event].astype(int)
    want = events["want_u8"][event].astype(int)
    diff = np.abs(got - want)
    print(f"{event}: max {diff.max()} LSB, {100 * np.mean(diff > 0):.4f}% of "
          f"values differ")
    assert diff.max() <= 1, diff.max()


def test_add_fire_renders_sky_and_pins_the_range(events):
    wf = events["got"]["wildfire"]
    assert wf.min() >= 0 and wf.max() <= 255
    assert np.all(wf[:, 0, 0] == 255) and np.all(wf[:, -1, -1] == 0)
    # the sky rows took the red filter: red above green above blue
    top = wf[:, 1:20].reshape(-1, 3).mean(0)
    assert top[0] > top[1] > top[2], top


# ---- the slice as a whole ------------------------------------------------

SHARDS = (2, 3, 4)


@pytest.fixture(scope="module")
def infer_runs(tmp_path_factory):
    """JAX's ``infer`` of all three events and the port's, whole and over
    2, 3 and 4 row shards, with the sky masks: numpy, computed once per
    session (``once_per_session``)."""
    return once_per_session(tmp_path_factory, "torch_port_infer_runs",
                            _infer_runs)


def _infer_runs():
    jopts, topts, G, V, _ = tiny_pair(64, seed=3)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    rng_fire, rng_cloud, _ = jax.random.split(rng, 3)
    uniform = torch.from_numpy(np.array(jax.random.uniform(rng_cloud, (9, 9))))
    g_value = float(jax.random.randint(rng_fire, (), 100, 151))
    baked = bake_spectral_norm(V)
    _, jinfer = jax_build_infer_fn(jopts, dtype=jnp.float32, ignore_event=(),
                                   donate=False, freeze_spectral=True)
    want = {k: np.asarray(v) for k, v in jinfer(baked, x, rng).items()}
    with frozen_spectral():
        jseg = np.asarray(G.apply(baked, x, method="infer_masker")[1])
    state_dict = state_dict_from_jax(V, GenConfig.from_opts(topts))
    tG, infer = build_infer_fn(
        topts, dtype=torch.float32, ignore_event=(), device="cpu",
        state_dict=state_dict)
    got = {k: v.numpy() for k, v in infer(torch.from_numpy(x), uniform=uniform,
                                          g_value=g_value).items()}
    with torch.no_grad():
        tseg = to_nhwc(tG.infer_masker(nchw(x))[1])
    spatial = {}
    for k in SHARDS:
        _, sinfer = build_spatial_infer_fn(
            topts, ["cpu"] * k, dtype=torch.float32, ignore_event=(),
            state_dict=state_dict)
        spatial[k] = {key: v.numpy() for key, v in sinfer(
            torch.from_numpy(x), uniform=uniform, g_value=g_value).items()}
    return {"want": want, "got": got, "spatial": spatial,
            "sky": (np.asarray(jax_image.retrieve_sky_mask(jseg)),
                    np.asarray(jax_image.retrieve_sky_mask(tseg)))}


def test_infer_sky_masks_agree(infer_runs):
    want, got = infer_runs["sky"]
    print(f"sky pixels: {int(want.sum())} of {want.size}")
    np.testing.assert_array_equal(got, want)


def test_infer_outputs_have_the_jax_keys_and_dtypes(infer_runs):
    want, got = infer_runs["want"], infer_runs["got"]
    assert sorted(got) == sorted(want) == ["flood", "mask", "smog", "wildfire"]
    for k in want:
        assert got[k].shape == want[k].shape
        assert got[k].dtype == want[k].dtype


def test_infer_mask_matches(infer_runs):
    want, got = infer_runs["want"]["mask"], infer_runs["got"]["mask"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("event", ["flood", "wildfire", "smog"])
def test_infer_event_uint8_within_one_lsb(infer_runs, event):
    want = infer_runs["want"][event].astype(int)
    got = infer_runs["got"][event].astype(int)
    diff = np.abs(got - want)
    print(f"infer {event}: max {diff.max()} LSB, "
          f"{100 * np.mean(diff > 0):.4f}% of values differ")
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("event", ["flood", "wildfire", "smog"])
def test_spatial_event_uint8_within_one_lsb_of_jax(infer_runs, event, k):
    want = infer_runs["want"][event].astype(int)
    diff = np.abs(infer_runs["spatial"][k][event].astype(int) - want)
    print(f"{k} shards {event}: max {diff.max()} LSB of JAX's")
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("k", SHARDS)
def test_spatial_mask_matches_jax(infer_runs, k):
    np.testing.assert_allclose(infer_runs["spatial"][k]["mask"],
                               infer_runs["want"]["mask"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("k", SHARDS)
def test_spatial_matches_the_unsharded_port(infer_runs, k):
    """The same outputs, keys and dtypes as the unsharded port; every event
    within 1 LSB on >= 99.9% of values, the mask within 1e-5."""
    got, want = infer_runs["spatial"][k], infer_runs["got"]
    assert sorted(got) == sorted(want)
    for key in ("flood", "wildfire", "smog"):
        assert got[key].dtype == want[key].dtype
        diff = np.abs(got[key].astype(int) - want[key].astype(int))
        print(f"{k} shards {key}: max {diff.max()} LSB, "
              f"{100 * np.mean(diff == 0):.4f}% equal")
        assert np.mean(diff <= 1) >= 0.999, key
    np.testing.assert_allclose(got["mask"], want["mask"], rtol=0, atol=1e-5)


# ---- the wrappers on the CPU ---------------------------------------------

def _wrapper_args(name):
    p = {k: nchw(v).contiguous() for k, v in _planes(10, (1, 4, 6)).items()}
    if name == "smog_tail":
        return smog_tail, smog_tail_plain, (p["x01"], p["d"]), SMOG
    if name == "fire_color_grade":
        return (fire_color_grade, fire_color_grade_plain,
                (p["x255"], torch.tensor(100.5)), {})
    return (fire_paste, fire_paste_plain,
            (p["x255"], p["sky"], torch.tensor(G_VALUE)), {})


KERNELS = ["smog_tail", "fire_color_grade", "fire_paste"]


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_takes_the_plain_version_on_cpu_and_counts_no_launch(name):
    wrapper, plain, args, kw = _wrapper_args(name)
    reset_launches()
    assert torch.equal(wrapper(*args, **kw), plain(*args, **kw))
    assert launches == dict.fromkeys(launches, 0)


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_rejects_other_dtypes_and_shapes(name):
    wrapper, _, args, kw = _wrapper_args(name)
    x, rest = args[0], args[1:]
    with pytest.raises(TypeError):
        wrapper(x.double(), *rest, **kw)
    with pytest.raises(TypeError):
        wrapper(x.bfloat16(), *rest, **kw)
    with pytest.raises(ValueError):
        wrapper(x[:, :2], *rest, **kw)          # two channels
    with pytest.raises(ValueError):
        wrapper(x.permute(0, 2, 3, 1), *rest, **kw)  # NHWC
    if len(rest) > 0 and rest[0].ndim == 4:
        with pytest.raises(ValueError):
            wrapper(x, rest[0][:, :, 1:], *rest[1:], **kw)
    else:
        with pytest.raises(ValueError):
            wrapper(x, torch.zeros(2), **kw)
