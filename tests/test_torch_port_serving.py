"""The port's serving helpers against the JAX package's, on the CPU:
checkpoint resolution (the cases of tests/test_serving_resolve.py), loading
a reference .pth in four wrapper forms into the state dict the JAX loader
produces (exactly, zeros included), the partial-group refusal, the opts a
run dir's opts.yaml gives, and the native host-prep library.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from climategan_torch.models.generator import GenConfig
from climategan_torch.utils import native
from climategan_torch.utils import serving
from climategan_torch.utils.convert import state_dict_from_jax
from climategan_torch.utils.opts import load_opts as torch_load_opts
from climategan_tpu.utils import native as jax_native
from climategan_tpu.utils import serving as jax_serving
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    jax_cfg,
    jax_variables,
    one_thread,
    write_run_dir,
    zeros_like_tree,
)


# ---- checkpoint resolution ----------------------------------------------

def _orbax_run(root):
    (root / "checkpoints").mkdir()
    (root / "checkpoints" / "latest.json").write_text("{}")
    return [root, root / "checkpoints"]


def _bare_pth(root):
    f = root / "model.pth"
    f.write_bytes(b"x")
    return [f]


def _run_dir_newest_pth(root):
    (root / "checkpoints").mkdir()
    (root / "checkpoints" / "epoch_5_ckpt.pth").write_bytes(b"x")
    (root / "checkpoints" / "epoch_10_ckpt.pt").write_bytes(b"x")
    return [root, root / "checkpoints"]


def _run_dir_latest(root):
    _run_dir_newest_pth(root)
    (root / "checkpoints" / "latest_ckpt.pth").write_bytes(b"x")
    return [root]


def _pth_beside_opts(root):
    (root / "opts.yaml").write_text("{}")
    (root / "a.pth").write_bytes(b"x")
    (root / "b.pth").write_bytes(b"x")
    return [root]


def _missing(root):
    return [root / "nope"]


def _not_a_checkpoint(root):
    f = root / "file.txt"
    f.write_text("x")
    return [f, root]


def _orbax_beats_stray_pth(root):
    _orbax_run(root)
    (root / "checkpoints" / "latest_ckpt.pth").write_bytes(b"x")
    return [root]


TREES = [_orbax_run, _bare_pth, _run_dir_newest_pth, _run_dir_latest,
         _pth_beside_opts, _missing, _not_a_checkpoint, _orbax_beats_stray_pth]


def _answers(mod, queries):
    """Each query's (resolve_checkpoint, run_dir_of, find_torch_ckpt) answer,
    an exception as its type and whether the message names the flavors."""
    out = []
    for q in queries:
        try:
            kind, p = mod.resolve_checkpoint(q)
            out.append((kind, p, mod.run_dir_of(kind, p)))
        except FileNotFoundError as e:
            out.append((FileNotFoundError, "orbax" in str(e) and ".pth" in str(e)))
        out.append(mod.find_torch_ckpt(q) if q.is_dir() else None)
    return out


@pytest.mark.parametrize("tree", TREES, ids=[t.__name__.strip("_") for t in TREES])
def test_resolution_matches_jax(tmp_path, tree):
    queries = tree(tmp_path)
    want = _answers(jax_serving, queries)
    assert _answers(serving, queries) == want
    if tree is _missing:
        assert want[0] == (FileNotFoundError, True)


def test_orbax_run_dir_is_refused_with_the_reason(tmp_path):
    _orbax_run(tmp_path)
    with pytest.raises(ValueError, match="orbax.*JAX package"):
        serving.load_inference_state(tmp_path)


# ---- reference .pth -> state dict ---------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(JAX opts, run-dir maker, reference state dict, JAX variables) of a
    tiny model.

    The JAX loader's structure donor ``init_generator_variables`` is given
    the zeros of the same tree, made once (``zeros_like_tree``)."""
    from climategan_tpu.utils.testing import tiny_opts

    jopts = tiny_opts(64)
    _, V = jax_variables(jopts, 64, seed=7)
    zeros = zeros_like_tree(V)
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_serving, "init_generator_variables",
                  lambda opts, G=None, rng_seed=0: zeros)
    cfg = GenConfig.from_opts(torch_load_opts(default=jopts.to_dict()))
    sd = state_dict_from_jax(V, cfg)
    root = tmp_path_factory.mktemp("runs")

    def run_dir(name, ckpt):
        return write_run_dir(root / name, jopts, ckpt)

    yield jopts, run_dir, sd, V
    patch.undo()


FORMS = {
    "G_wrapper": lambda sd: {"G": sd, "g_opt": {}},
    "G_prefix": lambda sd: {f"G.{k}": v for k, v in sd.items()},
    "unknown_key": lambda sd: {**sd, "decoders.x.unknown.weight": torch.ones(3)},
    "masker_only": lambda sd: {k: v for k, v in sd.items()
                               if not k.startswith("painter.")},
}


def _both(run):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jopts, jv = jax_serving.load_inference_variables(run)
        topts, got = serving.load_inference_state(run)
    cfg = GenConfig.from_opts(topts)
    return jopts, topts, state_dict_from_jax(jv, cfg), got


@pytest.mark.parametrize("form", sorted(FORMS))
def test_pth_loads_into_the_jax_loaders_state_dict(reference, form):
    _, run_dir, sd, _ = reference
    _, _, want, got = _both(run_dir(form, FORMS[form](sd)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    painter = [k for k in got if k.startswith("painter.")]
    zero = all(not got[k].any() for k in painter)
    assert zero == (form == "masker_only")


@pytest.mark.parametrize("part", ["masker", "painter"])
def test_groups_outside_parts_come_from_into(reference, part):
    """load_state(parts=(part,), into=...) as the JAX load_variables: the
    other half keeps ``into``'s values."""
    jopts, run_dir, sd, V = reference
    run = run_dir(f"into_{part}", {"G": sd})
    topts = serving.discover_opts(run)
    cfg = GenConfig.from_opts(topts)
    other = jax.tree_util.tree_map(lambda a: a + np.float32(0.25), V)
    jv = jax_serving.load_variables(run, jopts, parts=(part,), into=other)
    got = serving.load_state(run, topts, parts=(part,),
                             into=state_dict_from_jax(other, cfg))
    want = state_dict_from_jax(jv, cfg)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    kept = "painter." if part == "masker" else "encoder."
    assert not any(torch.equal(got[k], sd[k]) for k in got
                   if k.startswith(kept) and "num_batches" not in k)


def test_a_checkpoint_without_the_painter_serves_only_without_flood(reference):
    """The lenient load keeps a missing painter as zeros, which cannot run:
    the CLI refuses the flood on it and serves the other events, and
    eval_masker, which runs only the masker, takes it."""
    from climategan_torch import apply_events, eval_masker

    _, run_dir, sd, _ = reference
    run = run_dir("no_painter", FORMS["masker_only"](sd))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, got = serving.load_inference_state(run)
        assert serving.zero_filled_parts(got) == ("painter",)
        assert serving.zero_filled_parts(sd) == ()
        flags = ["-i", ".", "-r", str(run), "--device", "cpu"]
        with pytest.raises(ValueError, match="no painter.*--ignore_event flood"):
            apply_events.load_model(apply_events.parse_args(flags))
        assert callable(apply_events.load_model(apply_events.parse_args(
            [*flags, "--ignore_event", "flood"])))
        eval_masker.load_masker(eval_masker.build_parser().parse_args(
            ["--images_dir", ".", "--labels_dir", ".", "-r", str(run),
             "--device", "cpu"]))


def test_partial_group_raises_in_both(reference):
    _, run_dir, sd, _ = reference
    cut = dict(sd)
    del cut["encoder.layer1.0.conv2.weight"]
    run = run_dir("partial", cut)
    with pytest.raises(KeyError):
        jax_serving.load_inference_variables(run)
    with pytest.raises(KeyError, match="encoder is only partly"):
        serving.load_inference_state(run)


def test_opts_yaml_gives_equal_gen_configs(reference):
    _, run_dir, sd, _ = reference
    jopts, topts, _, _ = _both(run_dir("opts", {"G": sd}))
    cfg, jcfg = GenConfig.from_opts(topts), jax_cfg(jopts)
    assert cfg.p_latent_dim == 32 and cfg.encoder_layers == (1, 1, 1, 1)
    for f in dataclasses.fields(cfg):
        want = getattr(jcfg, f.name)
        got = getattr(cfg, f.name)
        assert (tuple(got) if isinstance(got, (list, tuple)) else got) == \
            (tuple(want) if isinstance(want, (list, tuple)) else want), f.name


# ---- native host prep ---------------------------------------------------

IMAGE_SHAPES = [(97, 145, 3), (145, 97, 3), (64, 64, 3), (720, 1280, 3)]


@pytest.fixture(scope="module")
def libs():
    if not native.available() or not jax_native.available():
        pytest.fail("the native library did not build with g++")
    return native, jax_native


@pytest.mark.parametrize("shape", IMAGE_SHAPES)
def test_native_matches_the_jax_packages_native(libs, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    for target in (64, 640):
        a = native.prepare_inference(img, target)
        assert a.shape == (target, target, 3) and a.dtype == np.float32
        assert np.array_equal(a, jax_native.prepare_inference(img, target))
    b = native.pack_uint8_to_m11(img)
    assert np.array_equal(b, jax_native.pack_uint8_to_m11(img))


@pytest.mark.parametrize("shape", IMAGE_SHAPES)
def test_fallback_agrees_with_the_native_path(libs, shape, monkeypatch):
    """Without the library (cv2's bilinear resize, then the pack) the prep
    is within 1/127.5 of the native path: one uint8 step of the resize; the
    pack is the library's formula, so it is equal."""
    img = np.random.default_rng(sum(shape) + 1).integers(0, 256, shape, np.uint8)
    want = jax_native.prepare_inference(img, 64), jax_native.pack_uint8_to_m11(img)
    monkeypatch.setattr(native, "_load", lambda: None)
    got = native.prepare_inference(img, 64), native.pack_uint8_to_m11(img)
    assert np.abs(got[0] - want[0]).max() <= 1 / 127.5 + 1e-6
    assert np.array_equal(got[1], want[1])
