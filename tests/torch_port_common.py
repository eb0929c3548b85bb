"""Shared set-up of the port's parity tests (tests/test_torch_port_*.py).

JAX variables are made by filling ``jax.eval_shape(G.init, ...)`` with numpy
draws from a seed (an eager ``G.init`` of the tiny model takes about a
minute on one CPU core); the port gets the same weights through
``climategan_torch.utils.convert.state_dict_from_jax``.

JAX and the JAX package are imported inside the functions that use them,
so the card-only tests (tests/test_torch_port_cuda.py) import the event
kernels' edge values from here on a machine without JAX.
"""
from __future__ import annotations

import functools
import json

import numpy as np
import pytest
import torch

from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.utils.convert import state_dict_from_jax
from climategan_torch.utils.opts import load_opts as torch_load_opts


def jax_variables(opts, image_size: int, seed: int = 0):
    """Variables of the JAX generator, filled from numpy draws: kernels
    normal with std 1/sqrt(fan_in), small biases, batch-norm statistics near
    identity (variances positive), unit spectral u/v."""
    import jax
    import jax.numpy as jnp

    from climategan_tpu.models.generator import create_generator

    G = create_generator(opts)
    x = jax.ShapeDtypeStruct((1, image_size, image_size, 3), jnp.float32)
    shapes = jax.eval_shape(G.init, jax.random.PRNGKey(0), x)
    return G, fill_like(shapes, seed)


def tiny_pair(image_size: int = 64, seed: int = 0):
    """(JAX opts, port opts, JAX G, JAX variables, port G with the same
    weights, in f32 eval mode on the CPU)."""
    from climategan_tpu.utils.testing import tiny_opts

    jopts = tiny_opts(image_size)
    topts = torch_load_opts(default=jopts.to_dict())
    G, variables = jax_variables(jopts, image_size, seed)
    cfg = GenConfig.from_opts(topts)
    tG = OmniGenerator(cfg)
    tG.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jopts, topts, G, variables, tG.eval()


def zeros_like_tree(variables):
    """The variable tree with every leaf zero: what the JAX package's
    ``serving.init_generator_variables`` returns for the same generator
    (there through a ``jax.eval_shape`` of about 4 s a call on one CPU
    core), so tests of its loader patch it in."""
    import jax

    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), variables)


def write_run_dir(d, jopts, ckpt):
    """A reference-style run dir: ``opts.yaml`` of the JAX opts and
    ``ckpt`` saved as ``checkpoints/latest_ckpt.pth``."""
    import yaml

    (d / "checkpoints").mkdir(parents=True)
    with (d / "opts.yaml").open("w") as f:
        yaml.safe_dump(jopts.to_dict(), f)
    torch.save(ckpt, d / "checkpoints" / "latest_ckpt.pth")
    return d


def jax_cfg(opts):
    from climategan_tpu.models.generator import GenConfig as JaxGenConfig

    return JaxGenConfig.from_opts(opts)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---- edge values of the event kernels (CPU twins and card tests) -------

GRADE_MEANS = [0.0, 97.0, 100.0, 255.0]


def _around(v, k):
    """float32 v and its k nearest float32 neighbours on each side."""
    v = lo = hi = np.float32(v)
    out = [v]
    for _ in range(k):
        lo, hi = np.nextafter(lo, np.float32(-1)), np.nextafter(hi, np.float32(2))
        out += [lo, hi]
    return out


def smog_edge_planes():
    """x01 (2, 3, 4, 32) and d (2, 1, 4, 32), float32 numpy.

    Each channel holds, rolled by its index: sRGB values at and beside the
    decode's branch point 0.04045; values whose decoded linear value
    (x * float32(1/12.92), as PyTorch divides by a scalar on the card)
    lands at and beside the encode's branch point 0.0031308; zero, values
    at and below 1e-12 and 1.0; then a ramp over [0, 1]. d is 0 on image 0
    (t = 1, so the linear value reaches the encode unchanged) and 1 on
    image 1."""
    f32 = np.float32
    x_thr = f32(0.0031308) * f32(12.92)
    vals = (_around(0.04045, 8) + _around(x_thr, 8)
            + [f32(v) for v in (0.0, 1e-13, 1e-12, 2e-12, 1e-11, 1.0)])
    plane = np.concatenate([np.array(vals, f32),
                            np.linspace(0, 1, 128 - len(vals), dtype=f32)])
    x = np.stack([np.roll(plane, c) for c in range(3)]).reshape(3, 4, 32)
    d = np.stack([np.zeros((1, 4, 32), f32), np.ones((1, 4, 32), f32)])
    return np.stack([x, x]), d


def grade_edge_planes():
    """x255 (1, 3, 8, 32), float32 numpy: the integers 0..255 in each
    channel, rolled by the channel's index. With the means of GRADE_MEANS,
    1.5 x - 0.5 mean lands exactly on an integer for half of them (odd x
    for an odd mean, even x for an even one), and the clamps at 0 and 255
    are reached and met exactly (mean 255: x = 85 gives 0; mean 0: x = 170
    gives 255)."""
    ints = np.arange(256, dtype=np.float32)
    return np.stack([np.roll(ints, 7 * c) for c in range(3)]).reshape(1, 3, 8, 32)


# ---- the training step (tests/test_torch_port_train.py, _losses.py) ----

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """For the modules that import it: their CPU tests run small tensors,
    and under the suite's parallel workers torch's default of a thread per
    core oversubscribes the host many times over (a 2 s step took 79 s in
    the full suite), so each of their tests runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def fill_like(shapes, seed: int):
    """Numpy values for a tree of ShapeDtypeStructs: kernels normal with
    std 1/sqrt(fan_in), other params small, unit spectral u/v, batch-norm
    statistics near identity (variances positive)."""
    import jax

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

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_d_variables(jopts, image_size: int, seed: int = 1):
    """(JAX discriminators, their variables from numpy draws)."""
    import jax
    import jax.numpy as jnp

    from climategan_tpu.models.discriminator import create_discriminator

    D = create_discriminator(jopts)
    s = D.cfg.s_num_classes
    shapes = jax.eval_shape(
        D.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, image_size, image_size, 4), jnp.float32),
        jax.ShapeDtypeStruct((1, image_size, image_size, 2), jnp.float32),
        jax.ShapeDtypeStruct((1, 32, 32, s), jnp.float32))
    return D, fill_like(shapes, seed)


def gan_draws(key, soft_shift: float, flip_prob: float):
    """The (soft, flip) pair the JAX package's gan_loss draws from
    ``key``."""
    import jax

    k1, k2 = jax.random.split(key)
    return (float(jax.random.uniform(k1, ()) * soft_shift),
            bool(jax.random.uniform(k2, ()) < flip_prob))


def step_draws(rng, soft_shift: float, flip_prob: float):
    """The draws of the JAX g_step and then d_step from TrainState.rng
    ``rng``: each step splits its own key off the state's."""
    import jax

    k_g, rest = jax.random.split(rng)
    k_d, _ = jax.random.split(rest)
    return (gan_draws(k_g, soft_shift, flip_prob),
            gan_draws(k_d, soft_shift, flip_prob))


def port_batch(batch):
    """A JAX NHWC numpy batch as the port's: NCHW float tensors, int64 seg
    labels."""
    return {dom: {k: (torch.from_numpy(np.asarray(v)).long() if k == "s"
                      else nchw(v).contiguous()) for k, v in d.items()}
            for dom, d in batch.items()}


# ---- the data pipeline and the trainer (tests/test_torch_port_data.py,
# _trainer.py): a dataset in the layout of tests/test_trainer_integration.py

DATA_SIZE = 32
H, W = 72, 96
TRANSFORMS = [
    {"name": "hflip", "ignore": "val", "p": 0.5},
    {"name": "resize", "ignore": False, "new_size": DATA_SIZE + 8,
     "keep_aspect_ratio": True},
    {"name": "crop", "ignore": False, "center": "val", "height": DATA_SIZE,
     "width": DATA_SIZE},
    {"name": "resize", "ignore": False,
     "new_size": {"default": DATA_SIZE, "d": DATA_SIZE, "s": DATA_SIZE}},
]


def write_dataset(root, n: int = 4, kitti: int = 0):
    """Synthetic samples and their JSON lists (train and val list the same
    samples); returns {"train": {domain: list}, "val": {...}}."""
    import cv2

    rng = np.random.RandomState(0)
    lists = {"train": {}, "val": {}}
    domains = ("r", "s", "rf") + (("kitti",) if kitti else ())
    for domain in domains:
        d = root / domain
        d.mkdir(parents=True, exist_ok=True)
        samples = []
        for i in range(kitti if domain == "kitti" else n):
            x = rng.randint(0, 255, (H, W, 3), np.uint8)
            entry = {"x": str(d / f"x_{i}.png")}
            cv2.imwrite(entry["x"], x[..., ::-1])
            m = (rng.rand(H, W) > 0.5).astype(np.uint8) * 255
            entry["m"] = str(d / f"m_{i}.png")
            cv2.imwrite(entry["m"], m)
            if domain == "s":
                dd = np.stack([np.full((H, W), 100, np.uint8),
                               np.full((H, W), 100, np.uint8),
                               rng.randint(0, 254, (H, W)).astype(np.uint8)],
                              axis=-1)
                entry["d"] = str(d / f"d_{i}.npy")
                np.save(entry["d"], dd)
                entry["s"] = str(d / f"s_{i}.npy")
                np.save(entry["s"], rng.randint(0, 11, (H, W)).astype(np.uint8))
            if domain == "kitti":
                from climategan_tpu.data.palettes import CLASSES

                colors = np.array(list(CLASSES["kitti"].values()), np.uint8)
                seg = colors[rng.randint(0, len(colors), (H, W))]
                entry["s"] = str(d / f"s_{i}.png")
                cv2.imwrite(entry["s"], seg[..., ::-1])
                depth = rng.randint(100, 8000, (H, W)).astype(np.uint16)
                entry["d"] = str(d / f"d_{i}.png")
                cv2.imwrite(entry["d"], depth)
            samples.append(entry)
        for mode in ("train", "val"):
            lp = root / f"{mode}_{domain}.json"
            lp.write_text(json.dumps(samples))
            lists[mode][domain] = str(lp)
    return lists


def opts_pair(lists, **train):
    """(JAX opts, port opts) of the tiny model over the dataset's lists."""
    from climategan_tpu.utils.testing import tiny_opts

    jopts = tiny_opts(DATA_SIZE)
    jopts.data.files = {"base": "", "train": lists["train"],
                        "val": lists["val"]}
    jopts.data.loaders = {"batch_size": 2, "num_workers": 0}
    jopts.data.transforms = TRANSFORMS
    for k, v in train.items():
        jopts.train[k] = v
    return jopts, torch_load_opts(default=jopts.to_dict())


# ---- the other generator configurations (tests/test_torch_port_configs*.py)

SIZE = 32
CONFIGS = {
    "A": {"gen": {"m": {"use_spade": True,
                        "spade": {"cond_nc": 15, "latent_dim": 32}},
                  "d": {"architecture": "base"},
                  "p": {"use_final_shortcut": True}}},
    "B": {"gen": {"m": {"use_spade": True,
                        "spade": {"cond_nc": 12, "latent_dim": 32}},
                  "deeplabv3": {"backbone": "mobilenet"},
                  "p": {"no_z": False}}},
    "C": {"gen": {"encoder": {"architecture": "deeplabv2"},
                  "s": {"architecture": "deeplabv2", "use_dada": False},
                  "d": {"architecture": "base",
                        "classify": {"enable": True,
                                     "linspace": {"min": 0.35, "max": 6.95,
                                                  "buckets": 8}}},
                  "m": {"use_dada": False},
                  "p": {"spade_param_free_norm": "batch"}}},
}


def config_opts(name, size=SIZE):
    """tiny_opts(size) with configuration ``name`` of CONFIGS."""
    from climategan_tpu.utils.opts import Opts, merge
    from climategan_tpu.utils.testing import tiny_opts

    opts = tiny_opts(size)
    merge(Opts(CONFIGS[name]), opts)
    return opts


@functools.lru_cache(maxsize=None)
def pair(name):
    """(JAX G, JAX variables, port G in eval mode, x, JAX encode(x), jitted
    JAX method caller) of configuration ``name``."""
    import jax

    jopts = config_opts(name)
    G, V = jax_variables(jopts, SIZE, seed=5)
    cfg = GenConfig.from_opts(torch_load_opts(default=jopts.to_dict()))
    tG = OmniGenerator(cfg)
    tG.load_state_dict(state_dict_from_jax(V, cfg), strict=True)
    x = np.random.default_rng(6).uniform(-1, 1, (2, SIZE, SIZE, 3)) \
        .astype(np.float32)

    @functools.partial(jax.jit, static_argnames=("method",))
    def call(*args, method):
        return G.apply(V, *args, method=method)

    return G, V, tG.eval(), x, call(x, method="encode"), call


