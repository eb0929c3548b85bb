"""Shared set-up of the port's parity tests (tests/test_torch_port_*.py).

JAX variables are made by filling ``jax.eval_shape(G.init, ...)`` with numpy
draws from a seed (an eager ``G.init`` of the tiny model takes about a
minute on one CPU core); the port gets the same weights through
``climategan_torch.utils.convert.state_dict_from_jax``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from climategan_tpu.models.generator import GenConfig as JaxGenConfig
from climategan_tpu.models.generator import create_generator
from climategan_tpu.utils.testing import tiny_opts
from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.utils.convert import state_dict_from_jax
from climategan_torch.utils.opts import load_opts as torch_load_opts


def jax_variables(opts, image_size: int, seed: int = 0):
    """Variables of the JAX generator, filled from numpy draws: kernels
    normal with std 1/sqrt(fan_in), small biases, batch-norm statistics near
    identity (variances positive), unit spectral u/v."""
    G = create_generator(opts)
    x = jax.ShapeDtypeStruct((1, image_size, image_size, 3), jnp.float32)
    shapes = jax.eval_shape(G.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        coll, name, shape = names[0], names[-1], leaf.shape
        if coll == "spectral":
            v = rng.standard_normal(shape)
            v = v / np.linalg.norm(v)
        elif coll == "batch_stats":
            v = (rng.uniform(0.5, 1.5, shape) if name == "var"
                 else rng.uniform(-0.1, 0.1, shape))
        elif name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return np.asarray(v, dtype=np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    return G, variables


def tiny_pair(image_size: int = 64, seed: int = 0):
    """(JAX opts, port opts, JAX G, JAX variables, port G with the same
    weights, in f32 eval mode on the CPU)."""
    jopts = tiny_opts(image_size)
    topts = torch_load_opts(default=jopts.to_dict())
    G, variables = jax_variables(jopts, image_size, seed)
    cfg = GenConfig.from_opts(topts)
    tG = OmniGenerator(cfg)
    tG.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jopts, topts, G, variables, tG.eval()


def jax_cfg(opts) -> JaxGenConfig:
    return JaxGenConfig.from_opts(opts)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()
