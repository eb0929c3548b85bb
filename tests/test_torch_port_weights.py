"""The port's weights, config and package rules.

* state_dict_from_jax loads strictly and round-trips through the JAX
  package's reference -> JAX converter, leaf for leaf;
* at full width (default opts, 640^2) its keys and shapes equal those of the
  port's OmniGenerator;
* the port's YAML copies equal the JAX package's files byte for byte;
* no module of the port, and not chip_smoke.py, imports JAX;
* the entry points default to the card and raise without one.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climategan_tpu.models.generator import create_generator
from climategan_tpu.utils.convert import convert_generator
from climategan_tpu.utils.opts import load_opts as jax_load_opts
from climategan_torch.inference import build_infer_fn
from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.utils.convert import state_dict_from_jax
from climategan_torch.utils.opts import load_opts
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    jax_cfg,
    one_thread,
    tiny_pair,
)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "climategan_tpu"}


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair(64)


def test_state_dict_from_jax_loads_strictly(tiny):
    jopts, topts, _, V, _ = tiny
    cfg = GenConfig.from_opts(topts)
    G = OmniGenerator(cfg)
    result = G.load_state_dict(state_dict_from_jax(V, cfg), strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_round_trip_through_the_jax_converter(tiny):
    jopts, topts, _, V, _ = tiny
    sd = state_dict_from_jax(V, GenConfig.from_opts(topts))
    blank = jax.tree_util.tree_map(jnp.zeros_like, V)
    back = convert_generator(blank, {k: v.numpy() for k, v in sd.items()},
                             jax_cfg(jopts))
    want = jax.tree_util.tree_leaves_with_path(V)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_full_width_keys_and_shapes_match_the_port_model():
    jopts = jax_load_opts()
    shapes = jax.eval_shape(
        create_generator(jopts).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 640, 640, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    cfg = GenConfig.from_opts(load_opts())
    sd = state_dict_from_jax(zeros, cfg)
    with torch.device("meta"):
        G = OmniGenerator(cfg)
    want = {k: tuple(v.shape) for k, v in G.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    n_params = sum(v.numel() for k, v in sd.items()
                   if not k.endswith(("running_mean", "running_var",
                                      "num_batches_tracked", "weight_u",
                                      "weight_v")))
    assert n_params == sum(p.numel() for p in G.parameters())


@pytest.mark.parametrize("name", ["defaults.yaml", "events.yaml"])
def test_config_copies_equal_the_jax_package(name):
    ours = ROOT / "climategan_torch" / "config" / name
    theirs = ROOT / "climategan_tpu" / "config" / name
    assert ours.read_bytes() == theirs.read_bytes()


def _sources():
    files = sorted((ROOT / "climategan_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_build_infer_fn_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    opts = load_opts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_infer_fn(opts)
