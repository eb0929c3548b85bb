"""The port's trainer on the CPU at the tiny sizes (``tiny_opts(32)``,
f32, a dataset of 4 samples per domain at 72x96, ``num_workers: 0``; the
trainer's own runs read 2 of them).

The training step itself is held to the JAX package's by
tests/test_torch_port_train.py; here the trainer is held to the port's own
``StepBuilder`` and the new modules to the JAX package where that is cheap:

  * two epochs of ``run_epoch`` (a step each) with an evaluation between
    equal ``StepBuilder.train_step`` on the same batches from the same
    state, bit for bit, and those batches equal a fresh set of loaders'
    (after the first train batch that ``_sample_batch`` draws);
  * ``run_evaluation``'s accuracy and mIOU equal the JAX package's
    ``eval_metrics`` on the same predictions, its losses the average of
    ``eval_losses``; the panels paint with the weights of the step before;
    a failure in the panels, the image grids or the losses raises;
  * a checkpoint restores bit-equal in a fresh trainer; a keep epoch
    writes both files and ``-r`` resolves the newest; partial loads take
    the JAX trainer's groups; the port's ``latest_ckpt.pth`` loads into
    the JAX generator, whose masker then equals the port's within 1e-5;
  * with ``train.fid.enable`` the evaluation logs the painter's FID;
  * the options not ported raise, naming their ROADMAP item; the CLI runs
    one epoch.
"""
import copy
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from climategan_tpu import eval_metrics as JM
from climategan_tpu.trainer import Trainer as JaxTrainer
from climategan_torch import train as train_cli
from climategan_torch.data import datasets as TD
from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.train_step import StepBuilder, TrainState
from climategan_torch.trainer import Trainer
from climategan_torch.utils.checkpoint import (
    checkpoint_dict,
    read_checkpoint,
    save_checkpoint,
    state_digest,
)
from climategan_torch.utils.convert import state_dict_from_jax
from climategan_torch.utils.serving import resolve_checkpoint
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    DATA_SIZE,
    fill_like,
    jax_cfg,
    jax_variables,
    one_thread,
    opts_pair,
    write_dataset,
)


def _opts(lists, out, **train):
    jopts, topts = opts_pair(lists, bf16=False, **train)
    jopts.train.lambdas.G.p.vgg = 0
    topts.train.lambdas.G.p.vgg = 0
    topts.output_path = str(out)
    return jopts, topts


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("data"))


@pytest.fixture(scope="module")
def run(data, tmp_path_factory):
    """A trainer through epoch 0, an evaluation and epoch 1 (2 samples per
    domain: a step an epoch, ExtraAdam's extrapolation then its update),
    with the batches each step received and the evaluation's metrics, and
    the same steps replayed by a ``StepBuilder`` from the same initial
    state."""
    jopts, topts = _opts(data, tmp_path_factory.mktemp("run"))
    jopts.data.max_samples = topts.data.max_samples = 2
    random.seed(0)
    trainer = Trainer(topts, device="cpu").setup(seed=0)
    steps = []
    real_step = trainer.builder.train_step

    def record(state, batch, *scales):
        steps.append((copy.deepcopy(batch), scales))
        return real_step(state, batch, *scales)

    trainer.builder.train_step = record
    paints = []
    G = trainer.state.G
    real_paint = G.paint

    def paint(m, x, *a, **k):
        out = real_paint(m, x, *a, **k)
        if not G.training:  # the evaluation's
            paints.append((m.clone(), x.clone(), out.clone()))
        return out

    G.paint = paint
    trainer.run_epoch()
    digests = [state_digest(checkpoint_dict(trainer.state, 0))]
    weights = copy.deepcopy(G.state_dict())
    metrics = trainer.run_evaluation()
    G.paint = real_paint
    trainer.current_epoch = 1
    trainer.run_epoch()
    digests.append(state_digest(checkpoint_dict(trainer.state, 1)))
    trainer.builder.train_step = real_step

    builder = StepBuilder(topts)
    ref = builder.init_state(seed=0, device="cpu")
    ref_digests, ref_metrics = [], None
    for i, (batch, scales) in enumerate(steps):
        ref, _ = builder.train_step(ref, batch, *scales)
        if i == 0:  # epoch 0 done; its evaluation on copies of the models
            ref_digests.append(state_digest(checkpoint_dict(ref, 0)))
            ref_metrics = _reference_metrics(
                builder, TrainState(copy.deepcopy(ref.G),
                                    copy.deepcopy(ref.D), {}, {}), topts)
    ref_digests.append(state_digest(checkpoint_dict(ref, 1)))
    return SimpleNamespace(
        jopts=jopts, topts=topts, trainer=trainer, steps=steps,
        digests=digests, ref_digests=ref_digests, metrics=metrics,
        ref_metrics=ref_metrics, paints=paints, weights=weights)


@pytest.fixture(scope="module")
def jax_gen(run):
    """The JAX generator of the tiny opts and two of its variable trees
    (numpy draws from seeds 0 and 1)."""
    import jax

    JG, dst = jax_variables(run.jopts, DATA_SIZE, seed=0)
    shapes = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), dst)
    return JG, dst, fill_like(shapes, seed=1)


def _reference_metrics(builder, state, topts):
    """The evaluation of a fresh set of val loaders' first pass: JAX's
    accuracy and mIOU on the port's predictions, the port's eval_losses;
    averaged over the batches."""
    loaders = TD.get_all_loaders(topts)["val"]
    accum, n = {}, 0
    for tup in zip(*loaders.values()):
        state.G.eval()
        with torch.no_grad():
            for item in tup:
                if item["domain"] == "rf" or "s" not in item["data"]:
                    continue
                x = TD.to_step_batch(item["data"], "cpu")["x"]
                pred = state.G.infer_masker(x)[1].argmax(1).numpy()
                for name, fn in (("acc", JM.accuracy), ("mIOU", JM.mIOU)):
                    key = f"val/{name}_{item['domain']}"
                    accum[key] = accum.get(key, 0.0) + fn(pred,
                                                          item["data"]["s"])
        state.G.train()
        batch = {item["domain"]: TD.to_step_batch(item["data"], "cpu")
                 for item in tup}
        for k, v in builder.eval_losses(state, batch, 0.0).items():
            accum[k] = accum.get(k, 0.0) + float(v)
        n += 1
    return {k: v / n for k, v in accum.items()}


def test_run_epoch_equals_step_builder(run):
    """Two epochs of a step, an evaluation between: the state after each
    epoch bit-equal to StepBuilder.train_step's on the same batches with no
    evaluation between (models, optimizer states, step, draws)."""
    assert len(run.steps) == 2
    assert run.trainer.global_step == 2
    assert run.digests == run.ref_digests


def test_the_steps_get_the_loaders_batches(run):
    """The batches of the two steps are a fresh set of loaders' after
    ``_sample_batch``'s draw: epoch 0 zipped, then (the val passes draw
    nothing) epoch 1; scales per epoch."""
    random.seed(0)
    loaders = TD.get_all_loaders(run.topts)
    for loader in loaders["train"].values():
        next(iter(loader))
    want = []
    for _ in range(2):
        want += [{item["domain"]: TD.to_step_batch(item["data"], "cpu")
                  for item in tup} for tup in zip(*loaders["train"].values())]
    for (got, scales), w in zip(run.steps, want):
        assert list(got) == list(w) == ["r", "s", "rf"]
        for dom in w:
            for k in w[dom]:
                assert torch.equal(got[dom][k], w[dom][k]), (dom, k)
        assert scales == (1.0, 1.0, 0.0)


def test_run_evaluation_matches_jax_metrics_and_eval_losses(run):
    assert set(run.metrics) == set(run.ref_metrics)
    assert {"val/acc_s", "val/mIOU_s", "val_g_total"} <= set(run.metrics)
    for k, v in run.ref_metrics.items():
        assert run.metrics[k] == v, k


def test_panels_paint_with_the_weights_after_the_steps(run):
    """Every paint of the evaluation (its losses, panels and grids) equals
    a fresh model loaded from the weights after epoch 0's steps."""
    fresh = OmniGenerator(GenConfig.from_opts(run.topts))
    fresh.load_state_dict(run.weights)
    fresh.eval()
    # the losses of the val batch, the panel, the r, s and rf grids
    assert len(run.paints) == 5
    with torch.no_grad():
        for m, x, out in run.paints:
            assert torch.equal(fresh.paint(m, x), out)


@pytest.mark.parametrize("where", ["panels", "images", "eval_losses"])
def test_a_failure_in_the_evaluation_raises(run, where, monkeypatch):
    trainer = run.trainer

    def boom(*a, **k):
        raise RuntimeError("kernel failed")

    if where == "eval_losses":
        monkeypatch.setattr(trainer.builder, "eval_losses", boom)
        call = trainer.run_evaluation
    else:
        monkeypatch.setattr(trainer.state.G, "paint", boom)
        call = (trainer._log_eval_panels if where == "panels"
                else trainer.log_eval_images)
    with pytest.raises(RuntimeError, match="kernel failed"):
        call()
    assert trainer.state.G.training


@pytest.mark.parametrize("policy", [
    {"lr_policy": "step", "lr_step_size": 3, "lr_gamma": 0.5},
    {"lr_policy": "multi_step", "lr_milestones": 5, "lr_step_size": 4},
    {"lr_policy": "multi_step", "lr_milestones": [2, 7], "lr_gamma": 0.1},
    {"lr_policy": None},
])
def test_lr_and_pseudo_scales_match_jax(data, tmp_path, policy):
    jopts, topts = _opts(data, tmp_path / "t",
                         pseudo={"tasks": ["s"], "epochs": 4})
    for opts in (jopts, topts):
        opts.gen.opt.update(policy)
        opts.dis.opt.update(policy)
        opts.output_path = str(tmp_path / "run")
    jt, tt = JaxTrainer(jopts), Trainer(topts, device="cpu")
    for epoch in range(30):
        assert tt.g_sched(epoch) == jt.g_sched(epoch)
        assert tt.d_sched(epoch) == jt.d_sched(epoch)
        assert tt.pseudo_scale(epoch) == jt.pseudo_scale(epoch)


def test_kitti_pretraining_swaps_the_loaders(data, tmp_path, monkeypatch):
    """train() sets the KITTI epochs as the JAX trainer does, and
    _epoch_loaders takes KITTI alone then."""
    _, topts = _opts(data, tmp_path, kitti={"pretrain": True, "epochs": 2})
    topts.train.epochs = 3
    trainer = Trainer(topts, device="cpu")
    loaders = {"train": {"r": "R", "s": "S", "rf": "RF", "kitti": "K"}}
    trainer.loaders = loaders
    trainer.is_setup = True
    seen = []
    monkeypatch.setattr(trainer, "run_epoch",
                        lambda: seen.append(trainer._epoch_loaders()))
    monkeypatch.setattr(trainer, "run_evaluation", lambda: None)
    monkeypatch.setattr(trainer, "save", lambda: tmp_path)
    trainer.train()
    jt = SimpleNamespace(loaders=loaders)
    want = []
    for pretrain in (True, True, False):
        jt.kitti_pretrain = pretrain
        want.append(JaxTrainer._epoch_loaders(jt))
    assert seen == want
    assert list(want[0]) == ["kitti"] and "kitti" not in want[2]


def test_checkpoint_round_trip_is_bit_equal(run, tmp_path):
    """save(), then resume() in a fresh, set-up trainer: models, optimizer
    states, step, the draws' generator and the epoch bit-equal."""
    trainer = run.trainer
    trainer.save()
    fresh = Trainer(run.topts, device="cpu").setup(seed=3)
    assert fresh.resume()
    assert fresh.current_epoch == trainer.current_epoch + 1
    got = checkpoint_dict(fresh.state, 1)
    want = checkpoint_dict(trainer.state, 1)
    digest = state_digest(want)
    assert state_digest(got) == digest
    for part in ("G", "D"):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    for part in ("g_opt", "d_opt"):
        assert got[part]["count"] == want[part]["count"]
        for key in ("mu", "nu", "saved"):
            for k, v in want[part][key].items():
                assert torch.equal(got[part][key][k], v), (part, key, k)
    assert got["step"] == want["step"] == 2
    assert torch.equal(got["generator"], want["generator"])
    record = json.loads((trainer.logger.metrics_path).read_text()
                        .splitlines()[-1])
    assert record == {"resumed_from_epoch": 1, "state_digest": digest}


def test_a_keep_epoch_writes_both_files_and_r_takes_the_newest(tmp_path):
    """Epoch 0 kept (min_save_epoch 0, save_n_epochs 2): latest_ckpt.pth
    and epoch_0.pth; epoch 1 only latest_ckpt.pth, which -r resolves."""
    state = TrainState(torch.nn.Linear(2, 3), torch.nn.Linear(3, 1),
                       {"count": torch.tensor(0), "mu": [torch.ones(3, 2),
                                                         torch.ones(3)]},
                       {"count": torch.tensor(0), "mu": [torch.ones(1, 3),
                                                         torch.ones(1)]})
    opts = {"train": {"min_save_epoch": 0, "save_n_epochs": 2}}
    from climategan_torch.utils.opts import Opts

    opts = Opts(opts)
    ckpts = tmp_path / "checkpoints"
    save_checkpoint(ckpts, state, 0, opts)
    assert sorted(p.name for p in ckpts.iterdir()) == [
        "epoch_0.pth", "latest.json", "latest_ckpt.pth"]
    with torch.no_grad():
        state.G.weight.add_(1.0)
    state.step = 1
    save_checkpoint(ckpts, state, 1, opts)
    assert not (ckpts / "epoch_1.pth").exists()
    assert read_checkpoint(ckpts / "epoch_0.pth")["epoch"] == 0
    kind, p = resolve_checkpoint(tmp_path)
    assert (kind, p) == ("torch", (ckpts / "latest_ckpt.pth").resolve())
    newest = read_checkpoint(p)
    assert newest["epoch"] == 1 and newest["step"] == 1
    assert torch.equal(newest["G"]["weight"], state.G.weight)
    assert json.loads((tmp_path / "opts.json").read_text()) == opts


@pytest.mark.parametrize("which,parts", [("m", ("masker",)),
                                         ("p", ("painter",)),
                                         ("pm", ("masker", "painter"))])
def test_partial_loads_take_the_jax_groups(run, jax_gen, tmp_path, which,
                                            parts):
    """load_paths.m / .p / .pm through resume() change exactly the values
    that the JAX trainer's _load_part (convert_generator with ``parts``)
    changes."""
    from climategan_tpu.utils.convert import convert_generator

    jopts = run.jopts
    _, dst, src = jax_gen
    cfg = GenConfig.from_opts(run.topts)
    src_sd = state_dict_from_jax(src, cfg)
    path = tmp_path / "src.pth"
    torch.save({"G": src_sd}, path)
    want = state_dict_from_jax(convert_generator(
        dst, src_sd, jax_cfg(jopts), parts=parts, lenient=True), cfg)

    opts = copy.deepcopy(run.topts)
    opts.load_paths = {"m": "none", "p": "none", "pm": "none", which: str(path)}
    opts.output_path = str(tmp_path / "out")
    trainer = Trainer(opts, device="cpu")
    builder = StepBuilder(opts)
    G = OmniGenerator(cfg)
    G.load_state_dict(state_dict_from_jax(dst, cfg))
    trainer.state = builder.state_for(G, run.trainer.state.D)
    assert trainer.resume()
    got = trainer.state.G.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_a_port_checkpoint_loads_into_the_jax_generator(run, jax_gen):
    """latest_ckpt.pth through the JAX package's load_torch_state_dict and
    convert_generator: JAX's infer_masker equals the port's within 1e-5."""
    import jax
    import jax.numpy as jnp

    from climategan_tpu.utils.convert import (
        convert_generator,
        load_torch_state_dict,
    )

    trainer = run.trainer
    path = trainer.save()
    JG, template, _ = jax_gen
    variables = convert_generator(template, load_torch_state_dict(str(path)),
                                  jax_cfg(run.jopts))
    x = np.random.default_rng(5).uniform(
        -1, 1, (2, DATA_SIZE, DATA_SIZE, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: JG.apply(v, x, method="infer_masker"))(
        variables, jnp.asarray(x))
    G = trainer.state.G.eval()
    try:
        with torch.no_grad():
            got = G.infer_masker(torch.from_numpy(x).permute(0, 3, 1, 2))
    finally:
        G.train()
    for name, a, b in zip("dsm", got, want):
        err = np.abs(a.permute(0, 2, 3, 1).numpy() - np.asarray(b)).max()
        assert err <= 1e-5, (name, err)


def test_evaluation_logs_the_painters_fid(run, monkeypatch):
    """With ``train.fid.enable`` the evaluation logs a finite ``val/fid``:
    ``compute_val_fid`` hands its evaluator the first
    ``train.fid.n_images`` val rf images (2 here) and the eval G's paints
    of them, and logs what the evaluator returns."""
    from climategan_torch import fid

    trainer = run.trainer
    monkeypatch.setitem(trainer.opts.train.fid, "enable", True)
    seen, logged = {}, []
    real_set, real_fid = fid.FIDEvaluator.set_real, fid.FIDEvaluator.fid

    def set_real(self, images):
        seen["real"] = images.clone()
        return real_set(self, images)

    def fid_of(self, images):
        seen["fake"] = images.clone()
        seen["fid"] = real_fid(self, images)
        return seen["fid"]

    monkeypatch.setattr(fid.FIDEvaluator, "set_real", set_real)
    monkeypatch.setattr(fid.FIDEvaluator, "fid", fid_of)
    monkeypatch.setattr(trainer.logger, "log_metrics", logged.append)
    metrics = trainer.run_evaluation()
    assert np.isfinite(metrics["val/fid"]) and metrics["val/fid"] > 0
    assert metrics["val/fid"] == seen["fid"]
    assert any(rec.get("val/fid") == seen["fid"] for rec in logged)
    item = next(iter(trainer.loaders["val"]["rf"]))
    x = torch.from_numpy(item["data"]["x"][:2]).permute(0, 3, 1, 2)
    m = torch.from_numpy(item["data"]["m"][:2]).permute(0, 3, 1, 2)
    assert torch.equal(seen["real"], x)
    with trainer._eval_G(val_painter=True) as G:
        torch.testing.assert_close(seen["fake"], G.paint(m, x), rtol=0,
                                   atol=1e-6)
    assert trainer.state.G.training


@pytest.mark.parametrize("option,item", [
    pytest.param({"tpu": {"spatial_shards": 2}, "gen": {"p": {"no_z": False}}},
                 None, id="option0-ROADMAP A.11b"),
    pytest.param({"tpu": {"mesh": {"data": 2}}}, "world size is 1",
                 id="option1-world size is 1"),
])
def test_unported_options_are_refused(data, tmp_path, option, item):
    """A data axis of 2 in one process (world size 1) says how to start
    the ranks; row-sharded training of another generator configuration
    (here a painter with z) is not refused: the trainer sets up on two
    shards of the CPU."""
    from climategan_torch.utils.opts import merge

    _, topts = _opts(data, tmp_path)
    merge(option, topts)
    if item is None:
        trainer = Trainer(topts, device="cpu").setup()
        assert trainer.shard_devices == [torch.device("cpu")] * 2
        return
    with pytest.raises((ValueError, NotImplementedError), match=item):
        Trainer(topts, device="cpu").setup()


def test_an_orbax_run_dir_is_refused(run, tmp_path):
    """Resuming from (or loading) a JAX orbax run dir names ROADMAP A.11
    (A.11d)."""
    (tmp_path / "checkpoints").mkdir()
    (tmp_path / "checkpoints" / "latest.json").write_text(
        json.dumps({"epoch": 0, "latest": str(tmp_path / "ckpt")}))
    opts = copy.deepcopy(run.topts)
    opts.output_path = str(tmp_path)
    trainer = Trainer(opts, device="cpu")
    trainer.state = run.trainer.state
    with pytest.raises(ValueError, match="orbax.*ROADMAP A.11"):
        trainer.resume()
    with pytest.raises(ValueError, match="orbax.*ROADMAP A.11"):
        Trainer(opts, device="cpu").setup(inference=True)


def test_cli_runs_one_epoch_on_the_cpu(data, tmp_path):
    """main() at the tiny opts on 2 samples per domain: one step, the
    evaluation, the checkpoint and the run dir's files."""
    out = tmp_path / "run"
    args = [f"data.files.train={json.dumps(data['train'])}",
            f"data.files.val={json.dumps(data['val'])}",
            f"output_path={out}", "train.epochs=1", "train.bf16=false",
            "train.lambdas.G.p.vgg=0", "data.loaders.num_workers=0",
            "data.max_samples=2",
            "data.loaders.batch_size=2",
            "gen.deeplabv2.nblocks=[1,1,1,1]", "gen.p.latent_dim=32",
            "gen.p.spade_n_up=5", "gen.m.proj_dim=16", "gen.m.n_res=1",
            "dis.p.n_layers=2", "dis.p.ndf=16", "dis.p.num_D=2",
            f"data.transforms={json.dumps(opts_pair(data)[1].data.transforms)}",
            "--device", "cpu"]
    assert train_cli.main(args) == 0
    records = [json.loads(line) for line in
               (out / "train.jsonl").read_text().splitlines()]
    epoch = [r for r in records if "launches" in r]
    assert len(epoch) == 1 and epoch[0]["epoch"] == 0
    assert [r["steps"] for r in records if "steps" in r] == [1]
    assert [r for r in records if "lr/G" in r] == [{"lr/G": 5e-05,
                                                   "lr/D": 2e-05}]
    assert (out / "opts.json").exists() and (out / "opts.yaml").exists()
    assert resolve_checkpoint(out) == (
        "torch", (out / "checkpoints" / "latest_ckpt.pth").resolve())


@pytest.mark.parametrize("name", ["fresh", "taken", "taken (1)"])
def test_opts_helpers_match_jax(tmp_path, name, monkeypatch):
    from climategan_tpu.utils import opts as JO
    from climategan_torch.utils import opts as TO

    (tmp_path / "taken").mkdir()
    (tmp_path / "taken (1)").mkdir()
    assert TO.get_increased_path(tmp_path / name) == \
        JO.get_increased_path(tmp_path / name)
    monkeypatch.setenv("CG_TEST_DIR", str(tmp_path))
    assert TO.env_expand(f"$CG_TEST_DIR/{name}") == \
        JO.env_expand(f"$CG_TEST_DIR/{name}")
    jopts = JO.load_opts()
    assert TO.flatten_opts(TO.load_opts()) == JO.flatten_opts(jopts)


def test_pretrained_backbone_loads_as_jax_does(run, jax_gen, tmp_path,
                                               monkeypatch):
    """A DeepLabv3+ pretrained file (``backbone.*``, ``aspp.*``,
    ``decoder.*`` with a 19-class classifier) into the encoder and seg
    decoder: the port's G equals the JAX package's
    maybe_load_pretrained_backbone on the same weights. (The JAX function
    maps the encoder at ResNet-101's depths, whatever the model's; here its
    converter is given the tiny model's.)"""
    import functools

    from climategan_tpu.utils import convert as jconvert
    from climategan_torch.utils.convert import maybe_load_pretrained_backbone

    monkeypatch.setattr(jconvert, "convert_resnet_encoder", functools.partial(
        jconvert.convert_resnet_encoder,
        layers=tuple(run.jopts.gen.deeplabv2.nblocks)))
    jax_load = jconvert.maybe_load_pretrained_backbone

    _, dst, src = jax_gen
    cfg = GenConfig.from_opts(run.topts)
    src_sd = state_dict_from_jax(src, cfg)
    pre = {"backbone." + k[len("encoder."):]: v for k, v in src_sd.items()
           if k.startswith("encoder.")}
    pre.update({k[len("decoders.s."):]: v for k, v in src_sd.items()
                if k.startswith("decoders.s.")})
    pre["decoder.conv_out.weight"] = torch.zeros(19, 256, 1, 1)
    path = tmp_path / "deeplab.pth"
    torch.save({"state_dict": pre}, path)
    jopts, topts = copy.deepcopy(run.jopts), copy.deepcopy(run.topts)
    for opts in (jopts, topts):
        opts.gen.deeplabv3.use_pretrained = True
        opts.gen.deeplabv3.pretrained_model = {"resnet": str(path)}
    want_vars, loaded = jax_load(jopts, dst)
    assert loaded
    want = state_dict_from_jax(want_vars, cfg)
    G = OmniGenerator(cfg)
    G.load_state_dict(state_dict_from_jax(dst, cfg))
    assert maybe_load_pretrained_backbone(topts, G)
    got = G.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(got["encoder.conv1.weight"], src_sd["encoder.conv1.weight"])


def test_vgg19_weights_load_as_jax_does(tmp_path):
    """A torchvision vgg19 state dict (its classifier too) into
    VGG19Features equals the JAX package's load_vgg19_weights."""
    import jax

    from climategan_tpu.losses import init_vgg
    from climategan_tpu.utils.convert import load_vgg19_weights as jax_load
    from climategan_torch.losses import VGG19Features
    from climategan_torch.utils.convert import (
        load_vgg19_weights,
        vgg_state_dict_from_jax,
    )

    torch.manual_seed(1)
    sd = VGG19Features().state_dict()
    sd["classifier.0.weight"] = torch.zeros(2, 2)
    path = tmp_path / "vgg19.pth"
    torch.save(sd, path)
    shapes = jax.eval_shape(lambda: init_vgg(jax.random.PRNGKey(0), 32))
    want = vgg_state_dict_from_jax(jax_load(str(path), fill_like(shapes, 2)))
    got = load_vgg19_weights(path, VGG19Features()).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("layout", ["G_prefixed", "painter_only"])
def test_the_val_painter_takes_the_painter_keys(run, tmp_path, layout,
                                                monkeypatch):
    """val.val_painter: the painter of a full (``G.``-prefixed) G state
    dict or a bare painter state dict; the evaluation's grids paint with
    it, the training state keeps its own."""
    from climategan_torch.models.generator import create_generator

    trainer = run.trainer
    other = create_generator(run.topts, seed=7)
    sd = other.state_dict()
    if layout == "G_prefixed":
        sd = {"G." + k: v for k, v in sd.items()}
    else:
        sd = {k[len("painter."):]: v for k, v in sd.items()
              if k.startswith("painter.")}
    torch.save({"G": sd}, tmp_path / "val.pth")
    monkeypatch.setitem(trainer.opts.val, "val_painter",
                        str(tmp_path / "val.pth"))
    monkeypatch.setattr(trainer, "val_painter", None)
    assert trainer.load_val_painter()
    for k, v in other.painter.state_dict().items():
        assert torch.equal(trainer.val_painter.state_dict()[k], v), k
    own = copy.deepcopy(trainer.state.G.painter.state_dict())
    G = trainer.state.G
    paints, real_paint = [], G.paint

    def paint(m, x):
        out = real_paint(m, x)
        paints.append((m.clone(), x.clone(), out.clone()))
        return out

    monkeypatch.setattr(G, "paint", paint, raising=False)
    monkeypatch.setattr(trainer.logger, "log_images", lambda *a, **k: None)
    trainer.log_eval_images()
    assert G.painter is not trainer.val_painter
    for k, v in G.painter.state_dict().items():
        assert torch.equal(v, own[k]), k
    other.eval()
    assert len(paints) == 3  # the r, s and rf grids
    with torch.no_grad():
        for m, x, out in paints:
            assert torch.equal(other.paint(m, x), out)


@pytest.mark.parametrize("resolution,hw", [("approx", (32, 64)),
                                           ("exact", (40, 70))])
def test_paint_and_mask(run, resolution, hw):
    """Masks given or inferred; approx works at the painter's multiple of
    2^spade_n_up (32), exact resizes back: equal to G.mask and G.paint on
    the resized batch."""
    from climategan_torch.ops.interpolate import resize

    trainer = run.trainer
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 40, 70, 3)).astype(np.float32)
    m = (rng.uniform(0, 1, (2, 40, 70, 1)) > 0.5).astype(np.float32)
    given = trainer.paint_and_mask(x, m, resolution)
    inferred = trainer.paint_and_mask(x, None, resolution)
    assert given.shape == inferred.shape == (2, *hw, 3)
    G = trainer.state.G.eval()
    try:
        with torch.no_grad():
            xw = resize(torch.from_numpy(x).permute(0, 3, 1, 2), (32, 64))
            mw = resize(torch.from_numpy(m).permute(0, 3, 1, 2), (32, 64),
                        "nearest")
            z = G.encode(xw)
            want = [G.paint(mw, xw), G.paint(G.mask(z), xw)]
    finally:
        G.train()
    for got, w in zip((given, inferred), want):
        if resolution == "exact":
            w = resize(w, hw)
        assert torch.equal(got, w.permute(0, 2, 3, 1))


def test_infer_all_from_a_run_dir(run):
    """Trainer.resume_from_path (inference mode) on the run dir the
    trainer saved: infer_all's three events and mask, as build_infer_fn
    gives them on the same state dict; a second call reuses the model."""
    from climategan_torch.inference import build_infer_fn

    run.trainer.save()
    trainer = Trainer.resume_from_path(run.topts.output_path, device="cpu")
    x = np.random.default_rng(2).uniform(
        -1, 1, (2, DATA_SIZE, DATA_SIZE, 3)).astype(np.float32)
    out = trainer.infer_all(x, rng_seed=4)
    _, infer = build_infer_fn(trainer.opts, device="cpu",
                              state_dict=run.trainer.state.G.state_dict())
    want = infer(x, generator=torch.Generator().manual_seed(4))
    assert set(out) == set(want) == {"flood", "wildfire", "smog", "mask"}
    assert want["mask"].dtype == torch.bfloat16  # tpu.inference_dtype
    for k, v in want.items():
        np.testing.assert_array_equal(out[k], v.float().numpy(), err_msg=k)
    again = trainer.infer_all(x, rng_seed=4)
    assert len(trainer._infer_fns) == 1
    for k in want:
        np.testing.assert_array_equal(again[k], out[k], err_msg=k)
