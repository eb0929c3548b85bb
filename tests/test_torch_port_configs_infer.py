"""The other generator configurations of the port end to end against the
JAX package, f32 on the CPU at tiny_opts(32): ``build_infer_fn`` with all
three events, the weights in and out, and the pretrained backbones.

The configurations are those of tests/test_torch_port_configs.py (A: the
SPADE masker at cond_nc 15, the base depth decoder, the painter's final
shortcut; B: the SPADE masker at cond_nc 12, MobileNetV2, the painter with
z; C: DeepLab v2, depth classification, batch-norm SPADEs in the painter).
Two faults of the JAX package show here, and the port does not copy them:
  * with depth classification, JAX's ``build_infer_fn`` hands the bucket
    logits to ``add_smog`` and fails; its smog is held against JAX's
    ``depth_map`` followed by ``add_smog`` (C runs JAX's infer without
    smog);
  * with a painter that takes z, JAX's ``paint_cloudy`` calls ``paint``
    without a key and fails; B runs both sides with ``cloudy=False``,
    JAX's z (its draw from the infer key's third split) fed to the port.
Bars: the smooth mask within atol 1e-4, uint8 events within 1 LSB
(PARITY.md, "Round 3 additions").
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climategan_tpu.events.smog import add_smog as jax_add_smog
from climategan_tpu.inference import build_infer_fn as jax_build_infer_fn
from climategan_tpu.ops.image import unit_range_to_uint8 as jax_to_uint8
from climategan_tpu.utils import convert as jconvert
from climategan_tpu.utils.bn_fold import bake_spectral_norm
from climategan_torch.inference import build_infer_fn
from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.utils.convert import (
    maybe_load_pretrained_backbone,
    state_dict_from_jax,
    state_dict_from_reference,
)
from climategan_torch.utils.opts import load_opts
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    SIZE,
    config_opts,
    jax_cfg,
    jax_variables,
    nchw,
    one_thread,
    pair,
)

EVENTS = ("flood", "wildfire", "smog")


@functools.lru_cache(maxsize=None)
def infer_run(name):
    """{"want": JAX's outputs, "got": the port's} of configuration
    ``name`` on the same weights, input and draws."""
    G, V, _, x, _, call = pair(name)
    jopts = config_opts(name)
    topts = load_opts(default=jopts.to_dict())
    rng = jax.random.PRNGKey(5)
    rng_fire, rng_cloud, rng_paint = jax.random.split(rng, 3)
    cloudy = name != "B"
    ignore = ("smog",) if name == "C" else ()
    baked = bake_spectral_norm(V)
    _, jinfer = jax_build_infer_fn(jopts, dtype=jnp.float32, cloudy=cloudy,
                                   ignore_event=ignore, donate=False,
                                   freeze_spectral=True)
    want = {k: np.asarray(v) for k, v in jinfer(baked, x, rng).items()}
    if name == "C":
        d = call(x, method="depth_map")
        want["smog"] = np.asarray(jax_to_uint8(jax_add_smog(x, d)))
    z = None
    if name == "B":
        z = nchw(G.apply(V, rng_paint, 2, SIZE, SIZE,
                         method="sample_painter_z"))
    _, infer = build_infer_fn(
        topts, dtype=torch.float32, cloudy=cloudy, device="cpu",
        state_dict=state_dict_from_jax(V, GenConfig.from_opts(topts)))
    uniform = torch.from_numpy(np.array(jax.random.uniform(rng_cloud, (9, 9))))
    g_value = float(jax.random.randint(rng_fire, (), 100, 151))
    got = {k: v.numpy() for k, v in infer(torch.from_numpy(x),
                                          uniform=uniform, g_value=g_value,
                                          z=z).items()}
    return {"want": want, "got": got}


@pytest.mark.parametrize("output", ("mask",) + EVENTS)
@pytest.mark.parametrize("name", ["A", "B", "C"])
def test_infer_matches_jax(name, output):
    run = infer_run(name)
    want, got = run["want"][output], run["got"][output]
    assert got.shape == want.shape and got.dtype == want.dtype
    if output == "mask":
        print(f"{name} mask: max abs error {np.abs(got - want).max():.2e}")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        return
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"{name} {output}: max {diff.max()} LSB, "
          f"{100 * np.mean(diff > 0):.4f}% of values differ")
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("fault", ["classification smog", "cloudy with z"])
def test_the_jax_infer_faults_the_port_does_not_copy(fault):
    """JAX's build_infer_fn fails where the port's serves: depth
    classification reaches add_smog as (N, H, W, buckets) logits; a
    painter with z is called without a key from paint_cloudy."""
    name, error, match = {
        "classification smog": ("C", TypeError, "incompatible shapes"),
        "cloudy with z": ("B", AssertionError, "requires an rng")}[fault]
    _, V, _, x, _, _ = pair(name)
    _, jinfer = jax_build_infer_fn(config_opts(name), dtype=jnp.float32,
                                   donate=False, freeze_spectral=True)
    with pytest.raises(error, match=match):
        jinfer(bake_spectral_norm(V), x, jax.random.PRNGKey(5))


# ---- weights --------------------------------------------------------------

# what the JAX converter cannot take in each configuration, and how the
# round trip goes around it
ROUND_TRIP = {
    # it reads no base depth decoder and no final shortcut: those leaves
    # stay as they were
    "A": dict(parts=("masker", "painter"), untouched=(
        "['depth_decoder']", "['final_shortcut_conv']",
        "['final_shortcut_bn']")),
    # it asks a painter with z for `fc`, which such a painter does not have
    "B": dict(parts=("masker",), untouched=("['painter']",)),
    # it asks the v2 masker for low-level convs, which the v2 encoder gives
    # no input: it is told there are none
    "C": dict(parts=("masker", "painter"), untouched=("['depth_decoder']",),
              cfg=dict(m_use_low_level_feats=False)),
}


@pytest.mark.parametrize("name", ["A", "B", "C"])
def test_round_trip_through_the_jax_converter(name):
    """state_dict_from_jax, then the JAX package's convert_generator: every
    leaf it reads comes back equal; the rest stay blank."""
    _, V, _, _, _, _ = pair(name)
    how = ROUND_TRIP[name]
    cfg = jax_cfg(config_opts(name))
    cfg = dataclasses.replace(cfg, **how.get("cfg", {}))
    sd = state_dict_from_jax(V, GenConfig.from_opts(
        load_opts(default=config_opts(name).to_dict())))
    blank = jax.tree_util.tree_map(jnp.zeros_like, V)
    back = convert_generator_numpy(blank, sd, cfg, how["parts"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    n_same = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(V):
        key = jax.tree_util.keystr(path)
        if any(u in key for u in how["untouched"]):
            assert not np.asarray(got[path]).any(), key
            continue
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=key)
        n_same += 1
    assert n_same > 0


def convert_generator_numpy(blank, sd, cfg, parts):
    return jconvert.convert_generator(
        blank, {k: v.numpy() for k, v in sd.items()}, cfg, parts=parts)


@pytest.mark.parametrize("name", ["A", "B", "C"])
def test_state_dict_from_reference_strips_the_prefix_and_unknown_keys(name):
    """A merged G state dict in the reference's form (``G.`` prefix, an
    unknown key), made of the port model's own keys, gives exactly the port
    model's state dict. The keys are the port's: ROADMAP C names those no
    JAX-side table checks."""
    _, _, tG, _, _, _ = pair(name)
    own = tG.state_dict()
    ref = {"G." + k: v for k, v in own.items()
           if not k.endswith("num_batches_tracked")}
    ref["G.unknown.weight"] = torch.zeros(1)
    got = state_dict_from_reference(ref, tG.cfg)
    assert list(got) == list(own)
    for k, v in own.items():
        assert torch.equal(got[k], v), k


# ---- pretrained backbones ---------------------------------------------------

@pytest.mark.parametrize("backbone", ["mobilenet", "deeplabv2"])
def test_pretrained_backbone_loads_as_jax_does(backbone, tmp_path):
    """A pretrained file into the encoder (and, for the mobilenet DeepLab,
    its seg head; its 19-class classifier skipped): the port's G equals the
    JAX package's maybe_load_pretrained_backbone on the same random
    weights. The v2 file's keys carry a first component that is dropped,
    and its layer5 is skipped."""
    name = "B" if backbone == "mobilenet" else "C"
    _, dst, _, _, _, _ = pair(name)
    jopts = config_opts(name)
    _, src = jax_variables(jopts, SIZE, seed=11)
    cfg = GenConfig.from_opts(load_opts(default=jopts.to_dict()))
    src_sd = state_dict_from_jax(src, cfg)
    if backbone == "mobilenet":
        pre = {k[len("encoder."):]: v for k, v in src_sd.items()
               if k.startswith("encoder.")}
        pre.update({k[len("decoders.s."):]: v for k, v in src_sd.items()
                    if k.startswith("decoders.s.head.")})
        pre["head.block.2.weight"] = torch.zeros(19, 256, 1, 1)
        pre["head.block.2.bias"] = torch.zeros(19)
        jopts.gen.deeplabv3.use_pretrained = True
        jopts.gen.deeplabv3.pretrained_model = {"mobilenet": str(tmp_path / "p.pth")}
    else:
        pre = {"Scale." + k[len("encoder.model."):]: v
               for k, v in src_sd.items() if k.startswith("encoder.model.")}
        pre["Scale.layer5.conv2d_list.0.weight"] = torch.zeros(11, 2048, 3, 3)
        jopts.gen.deeplabv2.use_pretrained = True
        jopts.gen.deeplabv2.pretrained_model = str(tmp_path / "p.pth")
    torch.save(pre, tmp_path / "p.pth")
    topts = load_opts(default=jopts.to_dict())
    want_vars, loaded = jconvert.maybe_load_pretrained_backbone(jopts, dst)
    assert loaded
    want = state_dict_from_jax(want_vars, cfg)
    G = OmniGenerator(cfg)
    G.load_state_dict(state_dict_from_jax(dst, cfg))
    assert maybe_load_pretrained_backbone(topts, G)
    got = G.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    conv1 = "encoder.conv1.conv.weight" if name == "B" else "encoder.model.conv1.weight"
    assert torch.equal(got[conv1], src_sd[conv1])
