"""The port's data pipeline against the JAX package's, on the CPU: every
transform on the same arrays with the same seeded ``random.Random``, the
file decoders, and every batch of ``get_all_loaders`` (train and val, after
the first train batch that the trainers draw before their first epoch),
bit for bit after NHWC -> NCHW (``to_step_batch``).

The dataset is 4 samples per domain (r, s, rf) at 72x96, in the layout of
tests/test_trainer_integration.py, plus 2 KITTI samples; the loaders run
with ``num_workers: 0``: with prefetch threads the transforms' draws from
the shared ``random`` module come in the threads' order, in the JAX package
as in the port.
"""
import json
import random

import numpy as np
import pytest
import torch

from climategan_tpu.data import datasets as JD
from climategan_tpu.data import palettes as JP
from climategan_tpu.data import transforms as JT
from climategan_tpu.utils.testing import tiny_opts
from climategan_torch.data import datasets as TD
from climategan_torch.data import palettes as TP
from climategan_torch.data import transforms as TT
from climategan_torch.utils.opts import load_opts
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    DATA_SIZE as SIZE,
    one_thread,
    opts_pair,
    write_dataset,
)

# defaults.yaml's pipeline with its sizes cut by 20x (640 -> 32)
DEFAULT_TRANSFORMS_SMALL = [
    {"name": "hflip", "ignore": "val", "p": 0.5},
    {"name": "resize", "ignore": False, "new_size": 32,
     "keep_aspect_ratio": True},
    {"name": "crop", "ignore": False, "center": "val", "height": 30,
     "width": 30},
    {"name": "brightness", "ignore": "val"},
    {"name": "saturation", "ignore": "val"},
    {"name": "contrast", "ignore": "val"},
    {"name": "resize", "ignore": False,
     "new_size": {"default": 32, "d": 8, "s": 8}},
]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("data"), kitti=2)


def _arrays(seed: int = 0, h: int = 40, w: int = 52):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32),
            "m": (rng.uniform(0, 1, (1, h, w, 1)) > 0.5).astype(np.float32),
            "d": rng.uniform(0.1, 5.0, (1, h, w, 1)).astype(np.float32),
            "s": rng.integers(0, 11, (1, h, w, 1)).astype(np.int32)}


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


TRANSFORM_CASES = {
    "resize_keep_aspect": lambda m: m.Resize(33, keep_aspect_ratio=True),
    "resize_tall": lambda m: m.Resize((50, 20)),
    "resize_per_task": lambda m: m.Resize({"default": 24, "d": 12, "s": 10}),
    "crop_random": lambda m: m.RandomCrop((20, 30), rng=random.Random(3)),
    "crop_center": lambda m: m.RandomCrop(16, center=True),
    "hflip": lambda m: m.RandomHorizontalFlip(0.5, rng=random.Random(1)),
    "brightness": lambda m: m.RandBrightness(rng=random.Random(2)),
    "saturation": lambda m: m.RandSaturation(rng=random.Random(4)),
    "contrast": lambda m: m.RandContrast(rng=random.Random(5)),
    "normalize": lambda m: m.Normalize(),
    "normalize_hrnet": lambda m: m.Normalize("HRNet"),
}


@pytest.mark.parametrize("name", sorted(TRANSFORM_CASES))
def test_transform_matches_jax(name):
    """Each transform, applied 4 times in a row (its rng draws each time),
    equals the JAX package's bit for bit."""
    make = TRANSFORM_CASES[name]
    jt, tt = make(JT), make(TT)
    for seed in range(4):
        _equal(tt(_arrays(seed)), jt(_arrays(seed)))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("size", [(17, 23), (72, 40), (40, 52)])
def test_np_resize_matches_jax(mode, size):
    a = _arrays(7)["x"]
    for ac in (False, True):
        np.testing.assert_array_equal(TT.np_resize(a, size, mode, ac),
                                      JT.np_resize(a, size, mode, ac))


@pytest.mark.parametrize("half", [False, True])
def test_prepare_inference_and_test_match_jax(tmp_path, half):
    """``PrepareInference`` on arrays at 37 x 53 and 61 x 29 (wide and
    tall), in [0, 255] and in [0, 1], and on PNGs (colour, gray, 16-bit
    colour: the port decodes them unchanged and converts them as JAX's
    8-bit colour decode does); ``PrepareTest`` on the batch of them.
    target_size 32: within 1e-6, float16 exactly."""
    import cv2

    rng = np.random.default_rng(14)
    u8 = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    pngs = {"photo": rng.integers(0, 256, (61, 29, 3), dtype=np.uint8),
            "gray": rng.integers(0, 256, (40, 45), dtype=np.uint8),
            "deep": rng.integers(0, 2 ** 16, (33, 50, 3), dtype=np.uint16)}
    for name, img in pngs.items():
        cv2.imwrite(str(tmp_path / f"{name}.png"), img)
    inputs = [u8, u8.astype(np.float32) / 255.0,
              rng.uniform(size=(61, 29, 3)).astype(np.float32),
              rng.integers(0, 256, (61, 29, 4)).astype(np.float32),
              *(tmp_path / f"{name}.png" for name in pngs)]
    got_all = TT.PrepareTest(32, half)(inputs)
    want_all = JT.PrepareTest(32, half)(inputs)
    assert got_all.shape == (7, 32, 32, 3)
    for got, want in ((got_all, want_all),
                      *((TT.PrepareInference(32, half)(x),
                         JT.PrepareInference(32, half)(x)) for x in inputs)):
        assert got.dtype == want.dtype == (np.float16 if half else np.float32)
        if half:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert -1.0 <= got_all.min() and got_all.max() <= 1.0


def test_bucketize_depth_matches_jax():
    opts = {"gen": {"d": {"classify": {"enable": True, "linspace": {
        "min": 0.35, "max": 6.95, "buckets": 256}}}}}
    jopts = tiny_opts(SIZE)
    jopts.gen.d.classify.enable = True
    topts = load_opts(commandline_opts=opts)
    for domain in ("s", "r"):
        _equal(TT.BucketizeDepth(topts, domain)(_arrays(3)),
               JT.BucketizeDepth(jopts, domain)(_arrays(3)))


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("tasks", [("d", "s", "m", "p"), ("d", "s", "m")])
def test_get_transforms_pipeline_matches_jax(mode, tasks):
    """The pipeline of defaults.yaml's transforms at a smaller size (the
    jitters only without the painter, in train mode), its draws from the
    global ``random``."""
    jopts = tiny_opts(SIZE, tasks=tasks)
    jopts.data.transforms = DEFAULT_TRANSFORMS_SMALL
    topts = load_opts(default=jopts.to_dict())
    outs = []
    for mod, opts in ((JT, jopts), (TT, topts)):
        pipe = mod.get_transforms(opts, mode, "s")
        random.seed(11)
        outs.append([mod.apply_transforms(_arrays(s, 90, 120), pipe)
                     for s in range(3)])
        outs[-1].append([type(t).__name__ for t in pipe])
    for a, b in zip(*outs[::-1]):
        if isinstance(a, list):
            assert a == b
        else:
            _equal(a, b)


def test_palettes_and_kitti_labels_match_jax():
    rng = np.random.default_rng(0)
    colors = np.array(list(JP.CLASSES["kitti"].values()), np.uint8)
    seg = colors[rng.integers(0, len(colors), (30, 40))]
    seg[0, :5] = (1, 2, 3)  # a colour of no class: the default label
    np.testing.assert_array_equal(TP.process_kitti_seg(seg),
                                  JP.process_kitti_seg(seg))
    for dom in ("s", "r", "flood"):
        pal = np.array(list(JP.CLASSES[dom].values()), np.uint8)
        rgb = pal[rng.integers(0, len(pal), (8, 9))]
        np.testing.assert_array_equal(
            TP.encode_exact_segmap(rgb, TP.CLASSES[dom], 7),
            JP.encode_exact_segmap(rgb, JP.CLASSES[dom], 7))
    assert TP.CLASSES == JP.CLASSES
    assert TP.KITTI_TO_CLIMATEGAN == JP.KITTI_TO_CLIMATEGAN


@pytest.mark.parametrize("log,normalize", [(True, False), (False, False),
                                           (True, True)])
def test_decode_unity_depth_matches_jax(log, normalize):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 248, (10, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TD.decode_unity_depth(arr, log=log, normalize=normalize),
        JD.decode_unity_depth(arr, log=log, normalize=normalize))


def test_load_task_matches_jax(dataset):
    jopts, topts = opts_pair(dataset)
    for domain in ("r", "s", "rf", "kitti"):
        sample = json.loads(open(dataset["train"][domain]).read())[0]
        for task, path in sample.items():
            a = TD.load_task(path, task, domain, topts)
            b = JD.load_task(path, task, domain, jopts)
            assert a.dtype == b.dtype and a.shape == b.shape, (domain, task)
            np.testing.assert_array_equal(a, b, err_msg=f"{domain} {task}")


def _all_batches(mod, opts, seed: int):
    """Every batch of a fresh set of loaders, as a trainer draws them:
    the first train batch of each domain, then the train epoch zipped, then
    the val loaders zipped."""
    random.seed(seed)
    loaders = mod.get_all_loaders(opts)
    out = [next(iter(loader))["data"] for loader in loaders["train"].values()]
    for mode in ("train", "val"):
        for tup in zip(*[v for k, v in loaders[mode].items() if k != "kitti"]):
            out += [(item["domain"], item["data"]) for item in tup]
    return loaders, out


def test_every_batch_matches_jax(dataset):
    """Train and val batches of get_all_loaders, in the trainers' order,
    bit-equal to the JAX package's after to_step_batch's NHWC -> NCHW; seg
    labels (N, H, W) int64."""
    jopts, topts = opts_pair(dataset)
    jl, want = _all_batches(JD, jopts, 0)
    tl, got = _all_batches(TD, topts, 0)
    assert len(got) == len(want) == 3 + 2 * 3 + 2 * 3
    assert {m: set(v) for m, v in tl.items()} == \
        {m: set(v) for m, v in jl.items()}
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            assert g[0] == w[0]
            g, w = g[1], w[1]
        t = TD.to_step_batch(g, "cpu")
        assert set(t) == set(w)
        for k, v in w.items():
            ref = torch.from_numpy(v)
            if k == "s":
                assert t[k].dtype == torch.int64 and t[k].dim() == 3
                ref = ref.long()
            else:
                assert t[k].is_contiguous()
                ref = ref.permute(0, 3, 1, 2)
            assert torch.equal(t[k], ref), k
    for mode in ("train", "val"):
        for k in jl[mode]:
            assert tl[mode][k].epoch == jl[mode][k].epoch


def test_kitti_loader_matches_jax(dataset):
    jopts, topts = opts_pair(dataset, kitti={"pretrain": True, "epochs": 1,
                                             "batch_size": 2})
    jopts.domains = list(jopts.domains) + ["kitti"]
    topts.domains = list(topts.domains) + ["kitti"]
    random.seed(3)
    want = list(JD.get_loader("train", "kitti", jopts))
    random.seed(3)
    got = list(TD.get_loader("train", "kitti", topts))
    assert len(got) == len(want) == 1
    assert got[0]["domain"] == want[0]["domain"] == "s"
    _equal(got[0]["data"], want[0]["data"])


def test_prefetch_threads_give_the_same_val_batches(dataset):
    """With no random transform (val), two prefetch threads give the
    batches of num_workers 0; an iteration left early stops its workers and
    a later one starts a new epoch."""
    _, topts = opts_pair(dataset)
    loader = TD.get_loader("val", "r", topts)
    threaded = TD.get_loader("val", "r", topts)
    threaded.num_workers = 2
    for a, b in zip(loader, threaded):
        _equal(a["data"], b["data"])
    next(iter(threaded))
    assert threaded.epoch == 2
    assert len(list(threaded)) == len(threaded) == 2


@pytest.mark.parametrize("workers", [0, 2])
def test_sample_is_the_first_batch_of_an_iteration(dataset, workers):
    """``sample()`` returns what ``next(iter(loader))`` returns and leaves
    the loader (its epoch and shuffle) as that does."""
    _, topts = opts_pair(dataset)
    a, b = TD.get_loader("val", "s", topts), TD.get_loader("val", "s", topts)
    b.num_workers = workers
    for _ in range(2):
        _equal(b.sample()["data"], next(iter(a))["data"])
        assert a.epoch == b.epoch
    for x, y in zip(a, b):
        _equal(x["data"], y["data"])
