"""The port's tools against the JAX package's, on the CPU at tiny size:

  * ``climategan_torch.launch``: the same runs as the root ``launch.py``
    (``expand`` on the showcase, a cartesian and a sequential experiment,
    seeds 0-2), the root's ``#SBATCH`` headers, the port's command (with
    torchrun under ``--nproc_per_node``), a run through ``--submit bash``;
  * ``climategan_torch.profile_inference`` at 32^2, ``--iters 1``, with and
    without ``--train``: stage labels the root's ``_STAGES`` can give, the
    stages summing to the total, the masker's four stages nonzero, the
    hooks gone afterwards;
  * ``scripts/orbax_to_pth.py`` on two JAX orbax run dirs of
    ``tiny_opts(64)`` with the MobileNetV2 backbone (a fifth of the ResNet
    encoder's 29M generator values, whose save, conversion and JAX
    compiles would take this file past its minute), written by the JAX
    package's ``save_checkpoint`` once per session: the whole generator
    with its discriminators under ExtraAdam, and a masker without
    discriminators under Adam whose run dir was moved (its ``latest.json``
    names a path that is gone): every converted tensor bit-equal to the
    JAX state's leaf, the served PNGs within 1 LSB of the root
    ``apply_events.py -r <orbax dir>``, the port's trainer resuming at the
    JAX epoch and step;
  * ``climategan_torch.compare_maskers`` on the two converted dirs: the
    root script's fixed 640^2 takes minutes on one CPU core, so the port's
    script runs at 64^2 (its ``SIZE``) and is held to the root script's
    computation at 64^2 (``G.apply(..., method="infer_masker")`` of the
    JAX variables, root ``apply_events``' resize and pack, the JAX
    package's metrics): panels within 1 LSB, metrics within 1e-6;
  * ``climategan_torch.utils.bn_fold`` against ``climategan_tpu.utils.
    bn_fold`` on the same seeded variables (relative 1e-6) and the folded
    forward against the unfolded one (1e-5).
"""
import copy
import json
import os
import shutil
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import launch as root_launch
import profile_inference as root_profile
from climategan_torch import compare_maskers
from climategan_torch import launch as port_launch
from climategan_torch import profile_inference as port_profile
from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.utils.bn_fold import (
    fold_conv_bn,
    fold_generator_bns,
    folded_blocks,
)
from climategan_torch.utils.convert import state_dict_from_jax
from climategan_torch.utils.opts import load_opts as torch_load_opts
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    fill_like,
    jax_d_variables,
    once_per_session,
    one_thread,
)

ROOT = Path(__file__).resolve().parent.parent
SHOWCASE = ROOT / "climategan_tpu" / "config" / "experiment_showcase.yaml"
EXPERIMENTS = {
    "showcase": yaml.safe_load(SHOWCASE.read_text()),
    "cartesian": {"cartesian": True, "base_overrides": {"train.epochs": 3},
                  "searches": {"gen.opt.lr.default": {"from": [1e-4, 5e-5]},
                               "tasks": {"from": ["[m]", "[m,s,d,p]"]}}},
    "sequential": {"runs": 2, "base_overrides": {"output_path": "/r/run_{i}"},
                   "searches": {
                       "gen.opt.optimizer": {"sample": "sequential",
                                             "from": ["ExtraAdam", "Adam",
                                                      "RAdam"]},
                       "dis.opt.lr.default": {"sample": "range",
                                              "from": [1e-6, 1e-3]},
                       "train.epochs": {"sample": "uniform",
                                        "from": [10, 50]}}},
}
SIZE = 64


# ---- the launcher -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_launch_expand_matches_the_root_launcher(name):
    for seed in range(3):
        want = root_launch.expand(EXPERIMENTS[name], seed)
        assert port_launch.expand(EXPERIMENTS[name], seed) == want, seed


@pytest.mark.parametrize("nproc", [None, 2])
def test_launch_scripts_have_the_root_headers_and_the_port_command(
        tmp_path, nproc, capsys):
    flags = ["-e", str(SHOWCASE), "--scripts_dir", str(tmp_path / "s"),
             "--seed", "1", "--device", "cpu"]
    if nproc:
        flags += ["--nproc_per_node", str(nproc)]
    assert port_launch.main(flags) == 0
    exp = EXPERIMENTS["showcase"]
    runs = root_launch.expand(exp, 1)
    scripts = sorted((tmp_path / "s").glob("run_*.sh"))
    assert len(scripts) == len(runs) == 4
    for i, (sh, cfg) in enumerate(zip(scripts, runs)):
        *header, line = sh.read_text().splitlines()
        want = root_launch.render_script("CMD", i, exp["slurm"]).splitlines()
        assert header == want[:-1] and want[-1] == "CMD"
        assert any(h.startswith("#SBATCH --job-name=climategan_tpu_") for h in header)
        head = [sys.executable]
        if nproc:
            head += ["-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", "2"]
        head += ["-m", "climategan_torch.train", "--device", "cpu"]
        import shlex

        assert shlex.split(line) == head + [f"{k}={v}" for k, v in cfg.items()]
    assert port_launch.main(["-e", str(SHOWCASE), "--dry"]) == 0
    out = capsys.readouterr().out
    assert "-m climategan_torch.train " in out and "4 runs" in out


def test_launch_submit_bash_runs_each_command(tmp_path):
    """``--submit bash`` runs the written scripts one after the other; a
    ``script:`` key names a file to run in place of the trainer."""
    probe = tmp_path / "probe.py"
    probe.write_text("import sys, pathlib\n"
                     "out = [a for a in sys.argv if a.startswith('output_path=')]\n"
                     "pathlib.Path(out[0].split('=', 1)[1]).write_text("
                     "' '.join(sys.argv[1:]))\n")
    exp = {"script": str(probe), "base_overrides": {
        "output_path": str(tmp_path / "out_{i}")},
        "searches": {"train.epochs": {"sample": "sequential",
                                      "from": [1, 2]}}}
    (tmp_path / "e.yaml").write_text(yaml.safe_dump(exp))
    assert port_launch.main(["-e", str(tmp_path / "e.yaml"), "--submit",
                             "bash", "--scripts_dir",
                             str(tmp_path / "s")]) == 0
    for i in range(2):
        assert (tmp_path / f"out_{i}").read_text() == (
            f"output_path={tmp_path / f'out_{i}'} train.epochs={i + 1}")


# ---- the profiler -----------------------------------------------------------

def _root_can_label(stage: str) -> bool:
    """A label the root profiler's ``_STAGES`` can give."""
    fixed = {label for _, label in root_profile._STAGES if label}
    return (stage in fixed | {"events+misc", "(no source)"}
            or (stage.startswith("painter/") and len(stage) > 8))


@pytest.mark.parametrize("train", [False, True])
def test_profiler_stages_on_the_cpu(tmp_path, train, one_thread):
    flags = ["--device", "cpu", "--size", "32", "--batch", "1", "--iters",
             "1", "--events", "all", "--out", str(tmp_path)]
    res = port_profile.run(port_profile.parse_args(
        flags + (["--train"] if train else [])))
    stages = res["stages_ms"]
    assert all(_root_can_label(s) for s in stages), sorted(stages)
    assert res["attributed_ms"] == pytest.approx(res["total_ms"], rel=1e-2)
    assert sum(stages.values()) == pytest.approx(res["total_ms"], rel=1e-2)
    for s in ("masker/encoder", "masker/seg_decoder", "masker/depth_decoder",
              "masker/mask_decoder"):
        assert stages.get(s, 0) > 0, (s, stages)
    assert any(v > 0 for k, v in stages.items() if k.startswith("painter/"))
    assert (tmp_path / "trace.json").stat().st_size > 0
    if not train:  # the script's hooks and wrappers are gone
        G = OmniGenerator(GenConfig.from_opts(port_profile.tiny_opts(32)))
        with port_profile.StageRanges(G):
            assert G._forward_pre_hooks or G.encoder._forward_pre_hooks
        assert not G.encoder._forward_pre_hooks
        assert not G.encoder._forward_hooks
        assert "paint" not in G.__dict__ and "infer_masker" not in G.__dict__


# ---- orbax run dirs ---------------------------------------------------------

MOBILENET = {"deeplabv3": {"backbone": "mobilenet"}}
# name: (seed, opts overrides, the Ds?, epoch, step)
JAX_RUNS = {
    "full": (0, {"gen": MOBILENET}, True, 3, 7),
    "masker": (1, {"tasks": ["d", "s", "m"],
                   "gen": {**MOBILENET, "m": {"use_advent": False},
                           "s": {"use_advent": False},
                           "opt": {"optimizer": "Adam"}}}, False, 5, 12),
}


def _jax_opt(params, optimizer, seed):
    """A JAX optimizer state over ``params`` whose every moment is drawn."""
    import jax

    from climategan_tpu.optim import AdamState, ExtraAdamState

    def draw(s):
        rng = np.random.default_rng(s)
        return jax.tree_util.tree_map(
            lambda a: rng.random(np.shape(a), dtype=np.float32) - 0.5, params)

    if optimizer == "ExtraAdam":
        return ExtraAdamState(np.int32(5), draw(seed), draw(seed + 1),
                              draw(seed + 2))
    return AdamState(np.int32(5), draw(seed), draw(seed + 1))


def _jax_run(run: Path, name: str, shapes) -> dict:
    """The JAX trainer's run dir of ``JAX_RUNS[name]``: opts.yaml and an
    orbax checkpoint of a TrainState, written by the JAX package's
    ``save_checkpoint`` (what ``Trainer.save`` calls). ``shapes``: the
    generator variables' shapes (a masker-only run takes the whole
    generator's less the painter). Returns the state saved, as orbax
    restores it (the NamedTuples as dicts of their fields)."""
    import jax

    from climategan_tpu.train_step import TrainState
    from climategan_tpu.utils.checkpoint import save_checkpoint
    from climategan_tpu.utils.opts import Opts, merge
    from climategan_tpu.utils.testing import tiny_opts

    seed, overrides, with_d, epoch, step = JAX_RUNS[name]
    jopts = tiny_opts(SIZE)
    merge(Opts(overrides), jopts)
    if "p" not in jopts.tasks:
        shapes = {coll: {k: v for k, v in tree.items() if k != "painter"}
                  for coll, tree in shapes.items()}
    V = fill_like(shapes, seed)
    DV = jax_d_variables(jopts, SIZE, seed + 1)[1] if with_d else {}
    state = TrainState(
        V["params"], {k: v for k, v in V.items() if k != "params"},
        DV.get("params", {}), {k: v for k, v in DV.items() if k != "params"},
        _jax_opt(V["params"], jopts.gen.opt.optimizer, seed + 10),
        _jax_opt(DV.get("params", {}), jopts.dis.opt.optimizer, seed + 20),
        np.int32(step), np.asarray(jax.random.PRNGKey(seed)))
    save_checkpoint(run / "checkpoints", state, epoch, jopts)
    with (run / "opts.yaml").open("w") as f:
        yaml.safe_dump(jopts.to_dict(), f)
    return {k: v._asdict() if hasattr(v, "_asdict") else v
            for k, v in state._asdict().items()}


def _make_runs(base: Path) -> dict:
    import jax
    import jax.numpy as jnp

    from climategan_tpu.models.generator import create_generator
    from climategan_tpu.utils.opts import Opts, merge
    from climategan_tpu.utils.testing import tiny_opts
    from scripts import orbax_to_pth

    jopts = tiny_opts(SIZE)
    merge(Opts(JAX_RUNS["full"][1]), jopts)
    shapes = jax.eval_shape(
        create_generator(jopts).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, SIZE, SIZE, 3), jnp.float32))
    out = {}
    for name in JAX_RUNS:
        src = base / f"{name}_jax"
        state = _jax_run(src, name, shapes)
        if name == "masker":  # a moved run dir
            moved = base / f"{name}_moved"
            src.rename(moved)
            src = moved
        orbax_to_pth.main(["-i", str(src), "-o", str(base / name)])
        out[name] = (str(src), str(base / name), state)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (the JAX orbax run dir, its conversion, the JAX state
    saved)}, made once per session, in the session's base temp dir (under
    xdist its parent, which every worker of the session shares)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    base = base / "torch_port_tools_runs"

    def make():
        if base.exists():
            shutil.rmtree(base)
        base.mkdir(parents=True)
        return _make_runs(base)

    return {k: (Path(src), Path(conv), state) for k, (src, conv, state) in
            once_per_session(tmp_path_factory, "torch_port_tools_runs",
                             make).items()}


def _port_opts(run: Path):
    return torch_load_opts(path=run / "opts.yaml")


def _bit_equal(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), (what, k)


@pytest.mark.parametrize("name", sorted(JAX_RUNS))
def test_converted_state_is_the_jax_state(runs, name):
    """G, D and every optimizer moment bit-equal to the JAX state's leaves
    mapped by ``state_dict_from_jax`` / ``d_state_dict_from_jax``; the
    counts, epoch and step; no D in a config without discriminators."""
    from climategan_torch.models.discriminator import DisConfig
    from climategan_torch.utils.checkpoint import read_checkpoint
    from climategan_torch.utils.convert import d_state_dict_from_jax

    src, conv, jax_state = runs[name]
    _, _, with_d, epoch, step = JAX_RUNS[name]
    ckpt = read_checkpoint(conv / "checkpoints" / "latest_ckpt.pth")
    assert json.loads((conv / "checkpoints" / "latest.json").read_text()) == {
        "epoch": epoch, "latest": "latest_ckpt.pth"}
    assert (ckpt["epoch"], ckpt["step"]) == (epoch, step)
    assert torch.equal(ckpt["generator"],
                       torch.Generator().manual_seed(0).get_state())
    named = Path(json.loads((src / "checkpoints" / "latest.json")
                            .read_text())["latest"])
    assert named.exists() == (name == "full")  # the moved run's is gone
    topts = _port_opts(conv)
    cfg, dcfg = GenConfig.from_opts(topts), DisConfig.from_opts(topts)
    g_vars = {"params": jax_state["g_params"], **jax_state["g_state"]}
    _bit_equal(ckpt["G"], state_dict_from_jax(g_vars, cfg), "G")
    names = [n for n, _ in OmniGenerator(cfg).named_parameters()]
    moments = ("mu", "nu", "saved") if name == "full" else ("mu", "nu")
    assert sorted(k for k in ckpt["g_opt"] if k != "count") == sorted(moments)
    assert ckpt["g_opt"]["count"] == 5
    for key in moments:
        want = state_dict_from_jax({**g_vars, "params":
                                    jax_state["g_opt"][key]}, cfg)
        _bit_equal(ckpt["g_opt"][key], {n: want[n] for n in names},
                   f"g_opt {key}")
    if not with_d:
        assert ckpt["D"] == {}
        assert all(v == {} for k, v in ckpt["d_opt"].items() if k != "count")
        return
    d_vars = {"params": jax_state["d_params"], **jax_state["d_state"]}
    _bit_equal(ckpt["D"], d_state_dict_from_jax(d_vars, dcfg), "D")
    for key in moments:
        want = d_state_dict_from_jax({**d_vars, "params":
                                      jax_state["d_opt"][key]}, dcfg)
        _bit_equal(ckpt["d_opt"][key],
                   {n: want[n] for n in ckpt["d_opt"][key]}, f"d_opt {key}")
        assert set(ckpt["d_opt"][key]) == {
            k for k in want if not k.endswith(("weight_u", "weight_v"))}


def test_converted_run_dir_serves_as_the_root_cli(runs, tmp_path, one_thread):
    """``python -m climategan_torch.apply_events -r <converted> --device
    cpu`` against root ``apply_events.py -r <orbax dir>`` on 2 photos:
    flood and smog within 1 LSB, the wildfire (each framework's own draw of
    its green value) of the same shape."""
    import cv2

    import apply_events
    from climategan_torch import apply_events as port_cli

    src, conv, _ = runs["full"]
    rs = np.random.RandomState(3)
    (tmp_path / "imgs").mkdir()
    for i in range(2):
        cv2.imwrite(str(tmp_path / "imgs" / f"im_{i}.png"),
                    rs.randint(0, 255, (128, 128, 3), np.uint8))
    flags = ["-i", str(tmp_path / "imgs"), "--keep_ratio_128", "-b", "2",
             "--no_cloudy"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["apply_events.py", *flags, "-r", str(src),
                                 "-o", str(tmp_path / "jax")])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert apply_events.main() in (0, None)
    assert port_cli.main([*flags, "-r", str(conv), "-o",
                          str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert len(names) == 6
    for n in names:
        want = cv2.imread(str(tmp_path / "jax" / n)).astype(int)
        got = cv2.imread(str(tmp_path / "port" / n)).astype(int)
        assert got.shape == want.shape
        if not n.endswith("_wildfire.png"):
            assert np.abs(got - want).max() <= 1, n


def test_port_trainer_resumes_the_converted_run(runs, tmp_path, one_thread):
    """The trainer's resume restores the converted state: the JAX run's
    epoch (the next epoch is epoch + 1) and step, the weights as saved."""
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.trainer import Trainer
    from climategan_torch.utils.checkpoint import read_checkpoint

    _, conv, _ = runs["full"]
    _, _, _, epoch, step = JAX_RUNS["full"]
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    for f in ("opts.yaml", "opts.json", "checkpoints/latest.json",
              "checkpoints/latest_ckpt.pth"):
        os.link(conv / f, run / f)
    opts = _port_opts(run)
    opts.output_path = str(run)
    opts.train.lambdas.G.p.vgg = 0
    trainer = Trainer(opts, device="cpu")
    trainer.state = StepBuilder(opts).init_state(0, "cpu")
    assert trainer.resume()
    assert trainer.current_epoch == epoch + 1
    assert trainer.state.step == step
    saved = read_checkpoint(conv / "checkpoints" / "latest_ckpt.pth")
    for k, v in trainer.state.G.state_dict().items():
        assert torch.equal(v, saved["G"][k]), k


def test_orbax_refusal_names_the_converter(runs):
    from climategan_torch.utils import serving

    with pytest.raises(ValueError, match="orbax.*orbax_to_pth"):
        serving.load_inference_state(runs["full"][0])


# ---- compare_maskers ----------------------------------------------------------

def _jax_masks(run, images, size: int):
    """The root compare_maskers.py's masks of ``images`` (uint8 RGB at
    ``size``^2) from a JAX run (``runs``' value: its dir and state)."""
    import jax
    import jax.numpy as jnp

    from apply_events import uint8_to_m11
    from climategan_tpu.models.generator import create_generator
    from climategan_tpu.utils.opts import load_opts

    orbax_dir, _, state = run
    variables = {"params": state["g_params"], **state["g_state"]}
    G = create_generator(load_opts(path=orbax_dir / "opts.json"))
    fn = jax.jit(lambda v, x: G.apply(v, x, method="infer_masker")[2])
    return [np.asarray(fn(variables, jnp.asarray(uint8_to_m11(img))[None]))
            [0, ..., 0] for img in images]


def test_compare_maskers_matches_the_root_script(runs, tmp_path, one_thread):
    import cv2

    from apply_events import resize_and_crop
    from climategan_tpu.eval_metrics import masker_classification_metrics

    rs = np.random.RandomState(4)
    for d in ("imgs", "labels"):
        (tmp_path / d).mkdir()
    for i in range(3):
        cv2.imwrite(str(tmp_path / "imgs" / f"p{i}.png"),
                    rs.randint(0, 255, (72, 96, 3), np.uint8))
        cv2.imwrite(str(tmp_path / "labels" / f"p{i}.png"),
                    rs.randint(0, 3, (72, 96)).astype(np.uint8))
    names = sorted(JAX_RUNS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compare_maskers, "SIZE", SIZE)
        res = compare_maskers.compare(compare_maskers.parse_args([
            "-i", str(tmp_path / "imgs"), "-r",
            *(str(runs[n][1]) for n in names), "-l", str(tmp_path / "labels"),
            "-o", str(tmp_path / "out"), "--limit", "2", "--device", "cpu"]))
    assert res["device"] == "cpu" and len(res["panels"]) == 2
    images = [resize_and_crop(cv2.imread(str(tmp_path / "imgs" / f"p{i}.png"))
                              [..., ::-1], SIZE) for i in range(2)]
    labels = [cv2.resize(cv2.imread(str(tmp_path / "labels" / f"p{i}.png"),
                                    cv2.IMREAD_GRAYSCALE), (SIZE, SIZE),
                         interpolation=cv2.INTER_NEAREST) for i in range(2)]
    masks = {n: _jax_masks(runs[n], images, SIZE) for n in names}
    for i in range(2):
        want = np.concatenate([images[i]] + [
            np.repeat((masks[n][i] * 255).astype(np.uint8)[..., None], 3, -1)
            for n in names], axis=1)
        got = cv2.imread(str(tmp_path / "out" / f"p{i}_panel.png"))[..., ::-1]
        assert got.shape == want.shape == (SIZE, 3 * SIZE, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    metrics = json.loads((tmp_path / "out" / "metrics.json").read_text())
    assert sorted(metrics) == names
    for n in names:
        ms = [masker_classification_metrics(masks[n][i], labels[i])[0]
              for i in range(2)]
        want = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
        assert metrics[n].keys() == want.keys()
        for k, v in want.items():
            assert metrics[n][k] == pytest.approx(v, abs=1e-6), (n, k)


def test_compare_maskers_random_weights_without_a_checkpoint(
        tmp_path, capsys, one_thread):
    import cv2

    (tmp_path / "imgs").mkdir()
    (tmp_path / "empty").mkdir()
    with (tmp_path / "empty" / "opts.yaml").open("w") as f:
        yaml.safe_dump(port_profile.tiny_opts(32).to_dict(), f)
    cv2.imwrite(str(tmp_path / "imgs" / "a.jpg"),
                np.full((40, 50, 3), 90, np.uint8))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compare_maskers, "SIZE", 32)
        assert compare_maskers.main([
            "-i", str(tmp_path / "imgs"), "-r", str(tmp_path / "empty"),
            "-o", str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert "WARNING: random weights for empty" in capsys.readouterr().err
    assert cv2.imread(str(tmp_path / "out" / "a_panel.png")).shape == (32, 64, 3)
    assert not (tmp_path / "out" / "metrics.json").exists()


# ---- batch-norm folding -------------------------------------------------------

def test_fold_conv_bn_matches_jax():
    import jax.numpy as jnp

    from climategan_tpu.utils.bn_fold import fold_conv_bn as jax_fold

    r = np.random.default_rng(7)
    k = r.standard_normal((3, 3, 8, 16)).astype(np.float32)
    b, g, beta, mean = (r.standard_normal(16).astype(np.float32)
                        for _ in range(4))
    var = r.uniform(0.2, 2.0, 16).astype(np.float32)
    for bias in (b, None):
        wk, wb = jax_fold(jnp.asarray(k), None if bias is None else
                          jnp.asarray(bias), jnp.asarray(g), jnp.asarray(beta),
                          jnp.asarray(mean), jnp.asarray(var))
        tk, tb = fold_conv_bn(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                              None if bias is None else torch.from_numpy(bias),
                              torch.from_numpy(g), torch.from_numpy(beta),
                              torch.from_numpy(mean), torch.from_numpy(var))
        np.testing.assert_allclose(tk.numpy(), np.asarray(wk).transpose(3, 2, 0, 1),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(tb.numpy(), np.asarray(wb), rtol=1e-6,
                                   atol=1e-7)


@pytest.fixture(scope="module")
def folded(runs):
    """(the full run's JAX generator variables, drawn with batch-norm
    statistics away from identity, JAX's fold of them, the port's G with
    the same weights, the port's folded G)."""
    from climategan_tpu.utils.bn_fold import fold_generator_bns as jax_fold

    state = runs["full"][2]
    V = {"params": state["g_params"], **state["g_state"]}
    cfg = GenConfig.from_opts(_port_opts(runs["full"][1]))
    G = OmniGenerator(cfg)
    G.load_state_dict(state_dict_from_jax(V, cfg), strict=True)
    G.eval()
    return V, jax_fold(V), cfg, G, fold_generator_bns(copy.deepcopy(G))


def test_fold_generator_bns_matches_jax(folded):
    """Every folded block's tensors equal JAX's fold of the same variables
    (relative 1e-6); the batch norms outside the folded blocks keep their
    statistics, which JAX resets (ROADMAP C)."""
    V, jax_folded, cfg, G, F = folded
    want = state_dict_from_jax(jax_folded, cfg)
    before = state_dict_from_jax(V, cfg)
    got = F.state_dict()
    blocks = [name for name, _ in folded_blocks(F)]
    assert blocks == ["decoders.d.enc4_1", "decoders.d.enc4_2",
                      "decoders.d.enc4_3", "decoders.d.upsample.1"]
    kept = 0
    for k, v in got.items():
        stat = k.endswith(("running_mean", "running_var"))
        if stat and not any(k.startswith(b + ".") for b in blocks):
            assert torch.equal(v, before[k]), k
            kept += 1
            continue
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert kept > 0


def test_folded_forward_matches_the_unfolded(folded, one_thread):
    from climategan_torch.models.blocks import Conv2dBlock

    _, _, _, G, F = folded
    x = torch.from_numpy(np.random.default_rng(10).uniform(
        -1, 1, (2, 3, SIZE, SIZE)).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(F.infer_masker(x), G.infer_masker(x)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        # a spectral conv with a batch norm (the SPADE mask decoder's)
        torch.manual_seed(0)
        block = Conv2dBlock(4, 8, 3, 1, 1, norm="spectral_batch",
                            activation="lrelu", pad_type="reflect")
        for t in (block.conv.module.weight_bar, block.conv.module.bias,
                  block.norm.weight, block.norm.bias):
            t.data.normal_()
        block.conv.module.weight_u.normal_()
        block.norm.running_mean.normal_()
        block.norm.running_var.uniform_(0.5, 2.0)
        block.eval()
        xb = torch.randn(2, 4, 12, 12)
        want = block(xb)
        fold_generator_bns(block)
        torch.testing.assert_close(block(xb), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="train mode"):
        fold_generator_bns(G.train())
    G.eval()
