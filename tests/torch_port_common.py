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
import hashlib
import json
import os
import pickle
from typing import Any, NamedTuple

import numpy as np
import pytest
import torch

from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.utils.convert import state_dict_from_jax
from climategan_torch.utils.opts import load_opts as torch_load_opts


# the parts of G above the layer3.0 ReLU kink that a split of the seed-0
# batch over two ranks or two row shards crosses (ROADMAP C); the encoder
# below layer4 is held in full by tests/test_torch_port_step_options.py's
# two-rank steps on another batch and by tests/test_torch_port_spatial_train
# .py's float64 steps
ABOVE_THE_KINK = ("encoder.layer4.", "decoders.", "painter.")


# XLA:CPU options of the port tests' JAX compiles: the tiny graphs compile
# several times faster at backend opt level 0 than at the default, and
# still run in well under a second
OPT0 = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    """``fn`` (a function, or a ``jax.jit`` of one) compiled for ``args``
    with OPT0."""
    import jax

    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return jitted.lower(*args).compile(compiler_options=OPT0)


# what ``one_thread`` keeps of the session: its ``tmp_path_factory``
_SESSION = {}


def once_per_session(tmp_path_factory, name: str, make):
    """``make()`` computed once per test session: under pytest-xdist the
    first worker that takes the lock computes it and pickles it into the
    session's base temp dir, and every other worker loads it (the
    plugin's own recipe); without xdist, ``make()``. For the JAX results
    of a module fixture, as numpy trees, which ``--dist load`` would
    otherwise compute again in every worker that takes a test of its
    file. ``tmp_path_factory`` None: the session's, as ``one_thread``
    keeps it (for a helper that is not a fixture; ``make()`` outside a
    port test module)."""
    factory = tmp_path_factory or _SESSION.get("tmp_path_factory")
    if factory is None or not os.environ.get("PYTEST_XDIST_WORKER"):
        return make()
    from filelock import FileLock

    path = factory.getbasetemp().parent / f"{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        value = make()
        path.write_bytes(pickle.dumps(value))
    return value


def digest(*parts) -> str:
    """A short hash of JSON-able ``parts`` (opts dicts, sizes, seeds), to
    name a value ``once_per_session`` keeps."""
    text = json.dumps(parts, sort_keys=True, default=repr)
    return hashlib.sha1(text.encode()).hexdigest()[:16]


class FirstMoments(NamedTuple):
    """What the tests read of a JAX optimizer state: the first moments."""

    mu: Any


def moments_only(state):
    """A JAX TrainState (numpy) with each optimizer state cut to its first
    moments, which ``hold_state`` holds the port's to: the second moments
    and ExtraAdam's saved parameters are each as large as the model, and
    a test worker keeps its fixtures' states for the whole file."""
    return state._replace(g_opt=FirstMoments(state.g_opt.mu),
                          d_opt=FirstMoments(state.d_opt.mu))


# ``_init_shapes``' trees in this process
_SHAPES = {}


def _init_shapes(kind: str, opts, image_size: int):
    """The ShapeDtypeStruct tree of the JAX generator's (``kind`` "G") or
    discriminators' ("D") variables for ``opts``: a ``jax.eval_shape`` of
    the model's init (3-8 s on one CPU core), once per process and once
    per session (``once_per_session``), keyed by the opts' values. The
    trace-time switches of ``models/norms.py`` change no variable, so they
    are not part of the key."""
    import jax
    import jax.numpy as jnp

    key = (kind, json.dumps(opts.to_dict(), sort_keys=True, default=repr),
           image_size)
    if key in _SHAPES:
        return _SHAPES[key]

    def make():
        if kind == "G":
            from climategan_tpu.models.generator import create_generator

            return jax.eval_shape(
                create_generator(opts).init, jax.random.PRNGKey(0),
                jax.ShapeDtypeStruct((1, image_size, image_size, 3),
                                     jnp.float32))
        from climategan_tpu.models.discriminator import create_discriminator

        D = create_discriminator(opts)
        s = D.cfg.s_num_classes
        return jax.eval_shape(
            D.init, jax.random.PRNGKey(0),
            jax.ShapeDtypeStruct((1, image_size, image_size, 4), jnp.float32),
            jax.ShapeDtypeStruct((1, image_size, image_size, 2), jnp.float32),
            jax.ShapeDtypeStruct((1, 32, 32, s), jnp.float32))

    _SHAPES[key] = once_per_session(
        None, f"torch_port_shapes_{kind}_{digest(*key)}", make)
    return _SHAPES[key]


def jax_variables(opts, image_size: int, seed: int = 0):
    """Variables of the JAX generator, filled from numpy draws: kernels
    normal with std 1/sqrt(fan_in), small biases, batch-norm statistics near
    identity (variances positive), unit spectral u/v. The tree's shapes
    come from ``_init_shapes``."""
    from climategan_tpu.models.generator import create_generator

    shapes = _init_shapes("G", opts, image_size)
    return create_generator(opts), fill_like(shapes, seed)


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


def port_tiny_opts(image_size: int = 64, **overrides):
    """The port's opts with the overrides of the JAX package's
    ``tiny_opts(image_size)`` (thin encoder, narrow painter, tiny targets)
    and ``overrides`` merged on top, without JAX."""
    from climategan_torch.utils.opts import merge

    feat = max(image_size // 4, 32)
    opts = torch_load_opts(commandline_opts={
        "gen": {"deeplabv2": {"nblocks": [1, 1, 1, 1]},
                "p": {"latent_dim": 32, "spade_n_up": 5},
                "m": {"proj_dim": 16, "n_res": 1}},
        "data": {"transforms": [
            {"name": "resize", "ignore": False, "new_size": image_size,
             "keep_aspect_ratio": True},
            {"name": "resize", "ignore": False,
             "new_size": {"default": image_size, "d": feat, "s": feat}}]},
    })
    if overrides:
        merge(overrides, opts)
    return opts


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
def one_thread(tmp_path_factory):
    """For the modules that import it: their CPU tests run small tensors,
    and under the suite's parallel workers torch's default of a thread per
    core oversubscribes the host many times over (a 2 s step took 79 s in
    the full suite), so each of their tests runs on one thread. After the
    module, the memory its fixtures held goes back to the system
    (``release_memory``). It keeps the session's ``tmp_path_factory`` for
    ``once_per_session(None, ...)``."""
    _SESSION["tmp_path_factory"] = tmp_path_factory
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


# a test process past this resident size after a module also drops JAX's
# compiled and traced functions (``release_memory``)
RESIDENT_LIMIT_GIB = 3.0


def release_memory():
    """Hand what a finished module's fixtures held back to the system: the
    suite's worker processes run one test module after another, and grew
    to 7-12 GB each until one ran out of memory. Collect the garbage and
    trim glibc's heap (it keeps freed chunks below its mmap threshold,
    which it raises up to 32 MB); past RESIDENT_LIMIT_GIB also clear JAX's
    caches of compiled and traced functions, most of what stays (about 2
    GB after five port modules), at the cost of tracing again what a later
    module calls."""
    import ctypes
    import gc
    import sys

    def trim():
        gc.collect()
        try:
            ctypes.CDLL("libc.so.6").malloc_trim(0)
        except (OSError, AttributeError):  # not glibc
            pass

    trim()
    if "jax" in sys.modules and _resident_gib() > RESIDENT_LIMIT_GIB:
        sys.modules["jax"].clear_caches()
        trim()


def _resident_gib() -> float:
    """This process's resident memory (0 where /proc cannot say)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, ValueError, IndexError):
        return 0.0
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 30

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
    from climategan_tpu.models.discriminator import create_discriminator

    shapes = _init_shapes("D", jopts, image_size)
    return create_discriminator(jopts), fill_like(shapes, seed)


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
    """(JAX G, JAX variables, port G in eval mode, x, JAX encode(x), JAX
    method caller) of configuration ``name``. The caller's results are
    numpy trees, each computed once per test session (``once_per_session``
    keyed by the method and a hash of its arguments): the configurations'
    tests call the same methods from several xdist workers."""
    import jax

    jopts = config_opts(name)
    G, V = jax_variables(jopts, SIZE, seed=5)
    cfg = GenConfig.from_opts(torch_load_opts(default=jopts.to_dict()))
    tG = OmniGenerator(cfg)
    tG.load_state_dict(state_dict_from_jax(V, cfg), strict=True)
    x = np.random.default_rng(6).uniform(-1, 1, (2, SIZE, SIZE, 3)) \
        .astype(np.float32)

    @functools.partial(jax.jit, static_argnames=("method",))
    def jitted(*args, method):
        return G.apply(V, *args, method=method)

    def call(*args, method):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = digest(name, method, str(tree), *(
            (np.asarray(a).dtype.str, np.asarray(a).shape,
             hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest())
            for a in leaves))
        return once_per_session(
            None, f"torch_port_pair_{key}",
            lambda: jax.tree_util.tree_map(
                np.asarray, jitted(*args, method=method)))

    return G, V, tG.eval(), x, call(x, method="encode"), call
