"""The port's CLIs against the root ones, f32 on the CPU, on one tiny
reference-style run dir (opts.yaml + checkpoints/latest_ckpt.pth):

  * ``python -m climategan_torch.apply_events`` against ``apply_events.py``
    on 3 PNGs at 128^2 (``--keep_ratio_128 -b 2 --no_cloudy``): flood and
    smog within 1 uint8 LSB; the wildfire draws its green value from each
    framework's own RNG, so it is held to its shape, the file count and a
    non-constant image;
  * ``python -m climategan_torch.eval_masker`` against ``eval_masker.py`` on
    2 labeled 64^2 images: the same report keys, and metrics within bounds
    derived from the largest difference of the two smooth masks;
  * ``climategan_torch.bench``'s argument handling, with no model build.
"""
import json
import sys
import warnings

import numpy as np
import pytest
import torch

from climategan_torch import apply_events as port_cli
from climategan_torch import bench as port_bench
from climategan_torch import eval_metrics as port_metrics
from climategan_torch import eval_masker as port_eval
from climategan_torch.models.generator import GenConfig
from climategan_torch.utils.convert import state_dict_from_jax
from climategan_torch.utils.opts import load_opts as torch_load_opts
from climategan_tpu import eval_metrics as jax_metrics
from climategan_tpu.utils import serving as jax_serving
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    jax_variables,
    once_per_session,
    one_thread,
    write_run_dir,
    zeros_like_tree,
)

EVENTS = ("flood", "wildfire", "smog")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(run dir, root dir of the photos and labels), with the JAX loader's
    structure donor patched to the zeros of the same tree (see
    ``zeros_like_tree``)."""
    import cv2

    from climategan_tpu.utils.testing import tiny_opts

    root = tmp_path_factory.mktemp("cli")
    jopts = tiny_opts(64)
    _, V = jax_variables(jopts, 64, seed=11)
    cfg = GenConfig.from_opts(torch_load_opts(default=jopts.to_dict()))
    run = write_run_dir(root / "run", jopts, {"G": state_dict_from_jax(V, cfg)})
    rs = np.random.RandomState(0)
    (root / "imgs").mkdir()
    for i in range(3):
        cv2.imwrite(str(root / "imgs" / f"im_{i}.png"),
                    rs.randint(0, 255, (128, 128, 3), np.uint8))
    (root / "eimgs").mkdir()
    (root / "labels").mkdir()
    for i in range(2):
        cv2.imwrite(str(root / "eimgs" / f"im_{i}.png"),
                    rs.randint(0, 255, (64, 64, 3), np.uint8))
        cv2.imwrite(str(root / "labels" / f"im_{i}.png"),
                    rs.randint(0, 3, (64, 64)).astype(np.uint8))
    zeros = zeros_like_tree(V)
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_serving, "init_generator_variables",
                  lambda opts, G=None, rng_seed=0: zeros)
    yield run, root
    patch.undo()


def _root_main(module, argv):
    """A root CLI's main() with ``argv`` as its command line."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", argv)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert module.main() in (0, None)


# ---- apply_events -------------------------------------------------------

@pytest.fixture(scope="module")
def served(setup, tmp_path_factory):
    """{PNG name: (the root CLI's image, the port's)} as cv2 reads them, and
    the port's names; computed once per test session."""
    return once_per_session(tmp_path_factory, "torch_port_cli_served",
                            lambda: _serve(*setup))


def _serve(run, root):
    import cv2

    import apply_events

    flags = ["-i", str(root / "imgs"), "-r", str(run), "--keep_ratio_128",
             "-b", "2", "--no_cloudy"]
    _root_main(apply_events, ["apply_events.py", *flags, "-o", str(root / "jax")])
    assert port_cli.main([*flags, "-o", str(root / "port"), "--device", "cpu"]) == 0
    names = sorted(p.name for p in (root / "jax").glob("*.png"))
    return {n: (cv2.imread(str(root / "jax" / n)), cv2.imread(str(root / "port" / n)))
            for n in names}, sorted(p.name for p in (root / "port").glob("*.png"))


def test_cli_writes_every_event_of_every_image(served):
    pngs, port_names = served
    assert port_names == sorted(pngs) and len(port_names) == 9
    for event in EVENTS:
        assert sum(n.endswith(f"_{event}.png") for n in port_names) == 3


@pytest.mark.parametrize("event", ("flood", "smog"))
def test_cli_matches_the_root_cli_within_one_lsb(served, event):
    pngs, _ = served
    for name, (want, got) in pngs.items():
        if name.endswith(f"_{event}.png"):
            diff = np.abs(got.astype(int) - want.astype(int))
            assert diff.max() <= 1, (name, diff.max())


def test_cli_wildfire_has_the_shape_and_varies(served):
    pngs, _ = served
    for name, (want, got) in pngs.items():
        if name.endswith("_wildfire.png"):
            assert got.shape == want.shape == (128, 128, 3)
            assert got.std() > 0


def test_cli_refuses_multi_gpu_flags(setup, served, capsys):
    """``--spatial`` parses (and with ``--mesh`` exits: rows or batch); on
    one device it serves one shard and says so; over ``["cpu", "cpu"]``
    (``load_model(args, devices=...)``) it serves PNGs within 1 LSB of the
    unsharded CLI's. ``--mesh`` on one device serves the same PNGs as
    without it, bit for bit."""
    import cv2

    run, root = setup
    with pytest.raises(SystemExit):
        port_cli.parse_args(["-i", ".", "--spatial", "--mesh"])
    assert "exclusive" in capsys.readouterr().err
    args = port_cli.parse_args(["-i", str(root / "imgs"), "-r", str(run),
                                "--keep_ratio_128", "-b", "2", "--no_cloudy",
                                "--spatial", "--device", "cpu"])
    assert args.spatial
    assert port_cli.mesh_devices(args) == [torch.device("cpu")]
    port_cli.load_model(args)
    assert "one shard" in capsys.readouterr().err
    images = [(p.stem, cv2.imread(str(p))[..., ::-1])
              for p in port_cli.find_images(root / "imgs")]
    split = {}
    port_cli.render(images, args,
                    lambda name, event, img: split.__setitem__(
                        f"{name}_{event}.png", img),
                    infer=port_cli.load_model(args, devices=["cpu", "cpu"]))
    pngs, names = served
    assert sorted(split) == names
    for name, got in split.items():
        want = pngs[name][1][..., ::-1]
        diff = np.abs(got.astype(int) - want.astype(int))
        assert np.mean(diff <= 1) >= 0.999, (name, diff.max())
    args = port_cli.parse_args(["-i", ".", "--mesh", "--device", "cpu"])
    assert port_cli.mesh_devices(args) == [torch.device("cpu")]
    assert port_cli.main(["-i", str(root / "imgs"), "-r", str(run),
                          "--keep_ratio_128", "-b", "2", "--no_cloudy",
                          "--mesh", "-o", str(root / "mesh"),
                          "--device", "cpu"]) == 0
    assert sorted(p.name for p in (root / "mesh").glob("*.png")) == names
    for n in names:
        assert np.array_equal(cv2.imread(str(root / "mesh" / n)),
                              pngs[n][1]), n


def test_padding_repeats_the_last_image():
    batch = np.arange(3 * 2, dtype=np.float32).reshape(3, 1, 1, 2)
    padded = port_cli.pad_batch(batch, 5)
    assert padded.shape == (5, 1, 1, 2)
    assert np.array_equal(padded[3], batch[2]) and np.array_equal(padded[4], batch[2])
    assert port_cli.pad_batch(batch, 3) is batch


# ---- eval_masker --------------------------------------------------------

@pytest.fixture(scope="module")
def evaluated(setup, tmp_path_factory):
    """Both reports, and each image's two smooth masks (the JAX one from
    the root CLI's own jitted ``infer_masker``) with its label; computed
    once per test session."""
    return once_per_session(tmp_path_factory, "torch_port_cli_evaluated",
                            lambda: _evaluate(*setup))


def _evaluate(run, root):
    import cv2
    import jax

    import eval_masker
    from climategan_tpu.models.generator import create_generator

    flags = ["--images_dir", str(root / "eimgs"), "--labels_dir",
             str(root / "labels"), "-r", str(run), "--size", "64"]
    _root_main(eval_masker, ["eval_masker.py", *flags, "--output",
                             str(root / "jax.json")])
    assert port_eval.main([*flags, "--output", str(root / "port.json"),
                           "--device", "cpu"]) == 0
    reports = [json.loads((root / f).read_text()) for f in ("jax.json", "port.json")]

    jopts, jv = jax_serving.load_inference_variables(run)
    jG = create_generator(jopts)
    infer_mask = jax.jit(lambda v, x: jG.apply(v, x, method="infer_masker")[2])
    G = port_eval.load_masker(port_eval.build_parser().parse_args([*flags, "--device", "cpu"]))
    preds = {}
    for p in sorted((root / "eimgs").glob("*.png")):
        img = cv2.imread(str(p), cv2.IMREAD_COLOR)[..., ::-1]
        label = cv2.imread(str(root / "labels" / p.name), cv2.IMREAD_GRAYSCALE)
        _, _, pred, _, label = port_eval.score_image(G, img, label, 64, 0.5)
        x = port_cli.uint8_to_m11(np.ascontiguousarray(img))[None]
        preds[p.name] = (np.asarray(infer_mask(jv, x))[0, ..., 0], pred, label)
    return reports, preds


def test_eval_report_has_the_root_reports_keys(evaluated):
    (want, got), _ = evaluated
    assert sorted(got) == sorted(want) == ["per_image", "summary"]
    assert sorted(got["summary"]) == sorted(want["summary"])
    assert got["summary"]["pass"] == want["summary"]["pass"]
    assert [sorted(m) for m in got["per_image"]] == [sorted(m) for m in want["per_image"]]
    assert [m["image"] for m in got["per_image"]] == [m["image"] for m in want["per_image"]]


def test_eval_metrics_within_the_masks_agreement(evaluated):
    """With d the largest |mask difference|: every rate is a mean of the
    mask (or 1 - mask) over a fixed pixel set, so it moves by <= d;
    precision A / B (B the mask's sum over must and cannot pixels, b its
    mean there) by <= 2 d / (b - d); F0.5 = 1.25 P R / (0.25 P + R) by
    <= 1.25 dP + 5 dR. Edge coherence reads the masks binarized at 0.5,
    which agree, so it is equal to f64 rounding."""
    (want, got), preds = evaluated
    d = max(np.abs(j - t).max() for j, t, _ in preds.values())
    print(f"largest mask difference {d:.3e}")
    assert d <= 1e-4
    for (jp, tp, label), w, g in zip(preds.values(), want["per_image"], got["per_image"]):
        assert np.array_equal(jp > 0.5, tp > 0.5)
        mc = (label == 0) | (label == 1)
        b = tp[mc].mean()
        bound = {"precision": 2 * d / (b - d) + 1e-12}
        bound["f05"] = 1.25 * bound["precision"] + 5 * d + 1e-12
        bound["edge_coherence"] = 1e-12
        for k, v in w.items():
            if k != "image":
                assert abs(g[k] - v) <= bound.get(k, d + 1e-12), (k, g[k], v)


@pytest.mark.parametrize("pred_kind", ["soft", "binary"])
def test_error_maps_and_f1_match_jax(pred_kind):
    """``f1_score``, ``pred_cannot``, ``missed_must`` and ``may_flood`` on
    random {0, 1, 2} labels at 61 x 47: the maps exactly equal, the rates
    within 1e-12."""
    rng = np.random.default_rng(12)
    label = rng.integers(0, 3, (61, 47))
    pred = rng.uniform(size=(61, 47))
    if pred_kind == "binary":
        pred = (pred > 0.5).astype(np.float32)
    for fn in ("pred_cannot", "missed_must"):
        got_map, got_rate = getattr(port_metrics, fn)(pred, label)
        want_map, want_rate = getattr(jax_metrics, fn)(pred, label)
        np.testing.assert_array_equal(got_map, want_map, err_msg=fn)
        assert abs(got_rate - want_rate) <= 1e-12, fn
        assert 0.0 < got_rate < 1.0, fn
    for got, want in zip(port_metrics.may_flood(pred, label),
                         jax_metrics.may_flood(pred, label)):
        np.testing.assert_array_equal(got, want)
    gt = (label == 1).astype(np.float32)
    assert abs(port_metrics.f1_score(pred, gt)
               - jax_metrics.f1_score(pred, gt)) <= 1e-12
    assert port_metrics.f1_score(gt, gt) == 1.0
    assert port_metrics.f1_score(np.zeros(3), np.zeros(3)) == 0.0


# ---- bench argument handling --------------------------------------------

@pytest.mark.parametrize("config, want", [
    (0, (32, "bfloat16", "flood")),
    (1, (1, "float32", "flood")),
    (2, (32, "bfloat16", "smog")),
    (3, (32, "bfloat16", "wildfire")),
    (4, (32, "bfloat16", "all")),
])
def test_bench_config_shortcuts_as_the_root_bench(config, want):
    """bench.py:210-217 maps --config 1-4 so; the metric name is its own."""
    args = port_bench.parse_args(["--config", str(config)])
    assert (args.batch, args.dtype, args.events) == want
    assert port_bench.metric_name(args) == (
        f"images/sec/chip at 640x640 {want[1]} {want[2]} inference "
        f"(Masker+Painter)")


def test_bench_defaults_match_the_root_bench():
    import bench

    root, port = vars(bench.build_parser().parse_args([])), vars(port_bench.parse_args([]))
    shared = set(root) & set(port)
    assert {"batch", "events", "dtype", "size", "stage", "config", "iters",
            "warmup", "mesh", "spatial", "hybrid"} <= shared
    assert {k: port[k] for k in shared} == {k: root[k] for k in shared}


@pytest.mark.parametrize("flags", (["--mesh"], ["--spatial"], ["--hybrid", "2"]))
def test_bench_refuses_multi_gpu_flags(flags, capsys):
    """``--mesh``, ``--spatial`` and ``--hybrid 2`` parse without a card;
    ``--mesh`` benches the whole forward only (another stage exits), the
    row-sharded layouts take ``--stage masker`` and ``--stage painter``
    too (tests/test_torch_port_spatial_configs.py runs them)."""
    args = port_bench.parse_args(flags)
    assert (args.mesh, args.spatial, args.hybrid) == (
        flags == ["--mesh"], flags == ["--spatial"],
        2 if flags == ["--hybrid", "2"] else 0)
    if flags == ["--mesh"]:
        with pytest.raises(SystemExit):
            port_bench.parse_args(flags + ["--stage", "masker"])
        assert "--stage all" in capsys.readouterr().err
        return
    for stage in ("masker", "painter"):
        args = port_bench.parse_args(flags + ["--stage", stage])
        assert args.stage == stage and (args.spatial or args.hybrid == 2)


def test_bench_flop_count_holds_every_spade_cond_call(monkeypatch):
    """count_flops runs spade_cond's plain version in each call of a tiny
    painter forward and counts its two convolutions: the total exceeds the
    forward's with a stand-in that does no work by exactly 2 * 9 * pixels *
    (cnc * hidden + hidden * cout) summed over the calls."""
    from torch.utils.flop_counter import FlopCounterMode

    from climategan_torch.models import norms
    from climategan_torch.models.generator import OmniGenerator
    from climategan_tpu.utils.testing import tiny_opts

    torch.manual_seed(0)
    G = OmniGenerator(GenConfig.from_opts(
        torch_load_opts(default=tiny_opts(64).to_dict()))).eval()
    x = torch.rand(1, 3, 64, 64) * 2 - 1
    m = (x[:, :1] > 0).float()

    def paint():
        with torch.no_grad():
            return G.paint(m, x)

    flops, calls = port_bench.count_flops(paint)
    want, n = 0, 0

    def no_work(seg, pack):
        nonlocal want, n
        n += 1
        N, H, W, cnc = seg.shape
        want += 2 * 9 * N * H * W * (cnc * sum(pack.hids) + sum(
            h * c for h, c in zip(pack.hids, pack.couts)))
        return [seg.new_zeros(N, H, W, c) for c in pack.couts]

    monkeypatch.setattr(norms, "spade_cond_packed", no_work)
    with FlopCounterMode(display=False) as counter:
        paint()
    assert calls == n > 0
    assert flops - counter.get_total_flops() == want


def test_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_bench.run_bench(port_bench.parse_args(["--batch", "1"]))
