"""The port's data-parallel layer (``climategan_torch/parallel/``) on the
CPU: the process group's triggers, the batch split, and two gloo ranks
(separate processes, ``parallel.spawn.run_ranks``; the ranks' code is
tests/torch_port_ranks.py) against one process on the global batch.

  * ``maybe_init_distributed`` starts nothing in a plain process, under
    the kill switch or a single SLURM task, and names the rendezvous a
    SLURM job lacks; without a group every collective helper returns its
    input;
  * ``mesh_size`` is the JAX package's rule; ``shard_batch`` gives each
    rank its rows of each global micro-batch; the train loader's rank
    shards make the one-process batches;
  * on two ranks: train-mode batch norm (outputs, input and parameter
    gradients, running statistics), ``sigm_loss``, ``dada_depth_loss`` and
    ``simse_loss`` (the summed shares and the gradients) equal one
    process's on the global batch, f32 within 1e-6 of the largest value;
    ``save_on_main`` writes on rank 0 alone with every rank's digest that
    of the file; ``python -m torch.distributed.run`` trains one epoch of
    the tiny model on two ranks; one rank's step is the plain step bit for
    bit;
  * ``--mesh`` serving split over two CPU replicas is within 1 LSB of the
    unsplit forward, with the same draws.

The data-parallel step against the JAX step: tests/test_torch_port_train.py
and tests/test_torch_port_step_options.py.
"""
import copy
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from climategan_torch.data.datasets import Loader
from climategan_torch.inference import build_infer_fn, build_mesh_infer_fn
from climategan_torch.models.norms import BatchNorm2d
from climategan_torch.parallel import distributed as dist
from climategan_torch.parallel.mesh import make_mesh, mesh_size, shard_batch
from climategan_torch.parallel.spawn import child_env, run_ranks
from climategan_torch.train_step import split_micro
from climategan_torch.trainer import check_data_axis
from climategan_torch.utils.checkpoint import read_checkpoint, state_digest
from climategan_torch.utils.opts import Opts, load_opts, merge
from climategan_torch.utils.step_check import TINY_OVERRIDES
from tests.torch_port_common import (  # noqa: F401 (one_thread: a fixture)
    TRANSFORMS,
    one_thread,
    write_dataset,
)
from tests.torch_port_ranks import LOSSES

LAUNCH = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_NTASKS", "SLURM_PROCID",
          "SLURM_LOCALID", "MASTER_ADDR", "MASTER_PORT", dist.KILL_SWITCH)


@pytest.fixture
def clean_env(monkeypatch):
    for var in LAUNCH:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _close(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * max(scale, 1.0), f"{what}: {err:.3g} of {scale:.3g}"


# ---- the process group's triggers -----------------------------------------

def test_a_plain_process_starts_no_group(clean_env):
    assert dist.maybe_init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (dist.rank(), dist.world(), dist.is_main()) == (0, 1, True)


def test_the_kill_switch_beats_a_launcher(clean_env):
    for k, v in {"RANK": "0", "WORLD_SIZE": "2", "SLURM_NTASKS": "4",
                 dist.KILL_SWITCH: "0"}.items():
        clean_env.setenv(k, v)
    assert dist.maybe_init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


def test_a_single_slurm_task_starts_no_group(clean_env):
    clean_env.setenv("SLURM_NTASKS", "1")
    clean_env.setenv("SLURM_PROCID", "0")
    assert dist.maybe_init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


def test_a_slurm_job_names_the_rendezvous_it_lacks(clean_env):
    clean_env.setenv("SLURM_NTASKS", "2")
    clean_env.setenv("SLURM_PROCID", "1")
    clean_env.setenv("MASTER_PORT", "1234")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        dist.maybe_init_distributed("cpu")
    assert not torch.distributed.is_initialized()


def test_without_a_group_the_collectives_return_their_input():
    """One process: no collective, the same tensors back (so the
    single-process step, forward and checkpoints are the parent's)."""
    x = torch.arange(6.0).reshape(2, 3)
    grads = [x, None]
    metrics = {"a": x[0, 0]}
    with dist.sharded_batch():
        assert dist.batch_world() == 1 and dist.batch_rank() == 0
        assert dist.gather_batch(x) is x
        assert dist.all_reduce_sum_grad(x) is x
    assert dist.all_reduce_grads(grads) == grads
    assert dist.all_reduce_metrics(metrics) is metrics
    assert dist.broadcast_object("run") == "run"
    assert dist.gather_objects(3) == [3]
    dist.broadcast_([x])
    dist.barrier()


# ---- the batch split --------------------------------------------------------

def test_mesh_size_is_the_jax_rule():
    """bench.py:297, bench_train.py:88 and climategan_tpu/trainer.py:97-101
    take the largest device count up to n that divides the batch."""
    for batch in range(1, 17):
        for n in range(1, 9):
            jax_bench = max(d for d in range(1, n + 1) if batch % d == 0)
            jax_trainer = next(d for d in range(min(n, batch), 0, -1)
                               if batch % d == 0)
            assert mesh_size(batch, n) == jax_bench == jax_trainer


@pytest.mark.parametrize("micro", [1, 2])
def test_shard_batch_gives_each_rank_its_rows_of_each_micro_batch(micro):
    """The ranks' shards, split into ``micro`` contiguous parts as the step
    splits them, hold global micro-batch i's rows in rank order."""
    batch = {"r": {"x": torch.arange(8.0)[:, None].repeat(1, 3)},
             "s": {"s": np.arange(8)}}
    world = 2
    shards = [shard_batch(batch, r, world, micro) for r in range(world)]
    global_micro = split_micro(batch, micro)
    for i in range(micro):
        rows = torch.cat([split_micro(s, micro)[i]["r"]["x"] for s in shards])
        assert torch.equal(rows, global_micro[i]["r"]["x"])
        labels = np.concatenate([split_micro(s, micro)[i]["s"]["s"]
                                 for s in shards])
        assert np.array_equal(labels, global_micro[i]["s"]["s"])
    assert shard_batch(batch, 0, 1) is batch
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(batch, 0, 3)


def test_make_mesh_keeps_the_given_devices():
    assert make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert make_mesh(1, devices=["cpu", "cpu"]) == [torch.device("cpu")]


class _Rows:
    """A draw-free dataset: sample i is the row i."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return {"data": {"x": np.full((1, 2, 2, 3), i, np.float32)},
                "paths": {"x": str(i)}, "domain": "r", "mode": "train"}


@pytest.mark.parametrize("micro", [1, 2])
def test_the_loaders_rank_shards_make_the_one_process_batches(micro):
    """Every rank draws the loader's shuffle and decodes only its rows;
    with draw-free transforms the ranks' rows of each global micro-batch
    are the one-process batch's."""
    whole = [b["data"]["x"] for b in Loader(_Rows(), 4, num_workers=0,
                                            seed=3)]
    ranks = [[b["data"]["x"] for b in Loader(_Rows(), 4, num_workers=0,
                                             seed=3, rank=r, world=2,
                                             micro=micro)]
             for r in range(2)]
    assert len(whole) == 2 and all(len(r) == 2 for r in ranks)
    for k, want in enumerate(whole):
        shards = [torch.from_numpy(r[k]) for r in ranks]
        for i, part in enumerate(np.split(want, micro)):
            got = torch.cat([s.chunk(micro)[i] for s in shards])
            assert np.array_equal(got.numpy(), part)
    with pytest.raises(ValueError, match="does not split"):
        Loader(_Rows(), 4, rank=0, world=3)


def test_the_data_axis_must_be_the_group_and_divide_the_batch():
    opts = load_opts()
    opts.data.loaders.batch_size = 4
    check_data_axis(opts, 2)
    check_data_axis(opts, 4)
    with pytest.raises(ValueError, match="does not split over the world "
                                         "size 3"):
        check_data_axis(opts, 3)
    opts.train.grad_accumulation = 4
    with pytest.raises(ValueError, match="micro-batch"):
        check_data_axis(opts, 2)
    check_data_axis(opts, 1)  # one process splits as it did
    opts.train.grad_accumulation = 1
    opts.tpu.mesh = {"data": 2}
    with pytest.raises(ValueError, match="world size is 4"):
        check_data_axis(opts, 4)
    opts.tpu.mesh = {"data": -1, "space": 2}
    with pytest.raises(ValueError, match="disagrees with "
                                         "tpu.spatial_shards=1"):
        check_data_axis(opts, 1)


# ---- two gloo ranks against one process -----------------------------------

@pytest.fixture(scope="module")
def pieces():
    """The inputs, one process's batch norm, and two ranks' results."""
    r = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    bn = BatchNorm2d(3)
    with torch.no_grad():
        bn.weight.copy_(t(r.uniform(0.5, 1.5, 3)))
        bn.bias.copy_(t(r.uniform(-1, 1, 3)))
    payload = {"x": t(r.normal(2.0, 3.0, (4, 3, 5, 5))),
               "c": t(r.normal(size=(4, 3, 5, 5))),
               "bn": copy.deepcopy(bn.state_dict()),
               "pred": t(r.uniform(0.1, 2.0, (4, 1, 12, 12))),
               "target": t(r.uniform(0.1, 2.0, (4, 1, 12, 12)))}
    got = run_ranks("tests.torch_port_ranks:pieces", 2, payload,
                    devices=["cpu", "cpu"], backend="gloo", timeout=120)
    return payload, bn, got


def test_batch_norm_over_two_ranks_is_the_global_batchs(pieces):
    payload, bn, got = pieces
    x = payload["x"].clone().requires_grad_(True)
    y = bn(x)
    gx, gw, gb = torch.autograd.grad((y * payload["c"]).sum(),
                                     [x, bn.weight, bn.bias])
    _close(torch.cat([g["bn"]["y"] for g in got]), y.detach(), "output")
    _close(torch.cat([g["bn"]["x_grad"] for g in got]), gx, "input gradient")
    for g in got:  # summed over the ranks: every rank holds the whole
        _close(g["bn"]["w_grads"][0], gw, "weight gradient")
        _close(g["bn"]["w_grads"][1], gb, "bias gradient")
        _close(g["bn"]["running"][0], bn.running_mean, "running mean")
        _close(g["bn"]["running"][1], bn.running_var, "running variance")


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_coupled_losses_over_two_ranks_are_the_global_batchs(pieces, name):
    """The ranks' shares sum to the global loss; each rank's gradient is
    that of its rows (the median's and the largest difference's reaching
    the rank that holds them)."""
    payload, _, got = pieces
    pred = payload["pred"].clone().requires_grad_(True)
    loss = LOSSES[name](pred, payload["target"])
    (grad,) = torch.autograd.grad(loss, [pred])
    for g in got:
        _close(g[name]["loss"], loss.detach(), f"{name} value")
    _close(torch.cat([g[name]["grad"] for g in got]), grad, f"{name} gradient")


def test_one_gloo_rank_steps_bit_equal_to_the_plain_step():
    """A group of one rank (gloo, a process of its own, one thread as
    here) takes g_step through the data-parallel path: the gradient and
    loss sums and ``replicate`` add nothing, its state equals this
    process's plain step's bit for bit."""
    from climategan_torch.bench_train import synthetic_batch
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.checkpoint import checkpoint_dict

    builder = StepBuilder(load_opts(commandline_opts=TINY_OVERRIDES))
    batch = synthetic_batch(2, 32, 32, "cpu")
    state = builder.init_state(0, "cpu")
    g_sd = copy.deepcopy(state.G.state_dict())
    d_sd = copy.deepcopy(state.D.state_dict())
    jobs = [("g_step", g_sd, d_sd, {"draws": (0.05, False)})]
    stepped, _ = builder.g_step(builder.state_for(state.G, state.D), batch,
                                draws=(0.05, False))
    got = run_ranks("tests.torch_port_ranks:steps", 1,
                    {"opts": builder.opts, "batch": batch, "jobs": jobs},
                    devices=["cpu"], backend="gloo", timeout=120)[0]
    assert got[0]["digest"] == state_digest(checkpoint_dict(stepped, 0))


def test_rank_0_alone_saves_and_every_rank_holds_what_it_wrote(tmp_path):
    """``replicate`` makes rank 1's state rank 0's; ``save_on_main`` writes
    once and gathers equal digests, that of the file."""
    got = run_ranks("tests.torch_port_ranks:save", 2,
                    {"dir": str(tmp_path / "checkpoints")},
                    devices=["cpu", "cpu"], backend="gloo", timeout=120)
    digests = got[0]["digests"]
    assert len(digests) == 2 and len(set(digests)) == 1
    assert got[1]["digests"] == digests
    assert [g["mine"] for g in got] == digests
    assert got[0]["file"] == got[1]["file"] == digests[0]
    assert got[0]["mtime"] == got[1]["mtime"]
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "latest.json", "latest_ckpt.pth"]


def test_torch_distributed_run_trains_an_epoch_on_two_gloo_ranks(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    climategan_torch.train --device cpu``: one epoch of the tiny model,
    one row of each domain per rank; rank 0 alone logs (one epoch record)
    and writes the checkpoint, whose digest is every rank's."""
    lists = write_dataset(tmp_path / "data")
    config = Opts(copy.deepcopy(TINY_OVERRIDES))
    merge(Opts({"data": {"files": {"base": "", **lists},
                         "loaders": {"batch_size": 2, "num_workers": 0},
                         "transforms": TRANSFORMS},
                "train": {"epochs": 1, "lambdas": {"G": {"p": {"vgg": 0}}}}}),
          config)
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump(json.loads(json.dumps(config))))
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "climategan_torch.train",
           "--device", "cpu", f"args.config={cfg}", f"output_path={out}"]
    proc = subprocess.run(cmd, env=child_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    records = [json.loads(line) for line in
               (out / "train.jsonl").read_text().splitlines()]
    epochs = [r for r in records if "ckpt_bytes" in r]
    assert len(epochs) == 1 and epochs[0]["world_size"] == 2
    assert sum("epoch_time_s" in r for r in records) == 1
    ckpt = read_checkpoint(out / "checkpoints" / "latest_ckpt.pth")
    assert state_digest(ckpt) == epochs[0]["state_digest"]
    assert ckpt["step"] == 2  # 4 samples, 2 a global batch


# ---- serving over replicas ---------------------------------------------------

@pytest.mark.parametrize("no_z", [True, False])
def test_mesh_serving_over_two_cpu_replicas_is_within_one_lsb(no_z):
    """``build_mesh_infer_fn`` over ["cpu", "cpu"] against ``infer`` on the
    whole batch, from one generator: each event within 1 LSB, the mask
    within f32 noise; the wildfire's gray mean is the whole batch's (a
    part's own mean would move it by many LSB)."""
    opts = load_opts()
    merge(Opts(copy.deepcopy(TINY_OVERRIDES)), opts)
    opts.gen.p.no_z = no_z
    kwargs = dict(dtype=torch.float32, seed=0)
    _, one = build_infer_fn(opts, device="cpu", **kwargs)
    _, two = build_mesh_infer_fn(opts, ["cpu", "cpu"], **kwargs)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    x = x * 2 - 1
    # a mostly dark second photo: after each photo's min-max rescale the
    # halves' gray means still differ
    x[1] = torch.where(x[1] > 0.8, x[1], torch.full_like(x[1], -0.9))
    want = one(x, generator=torch.Generator().manual_seed(3))
    got = two(x, generator=torch.Generator().manual_seed(3))
    assert set(got) == set(want)
    for k in ("flood", "wildfire", "smog"):
        assert got[k].shape == want[k].shape and got[k].dtype == torch.uint8
        diff = (got[k].int() - want[k].int()).abs().max().item()
        assert diff <= 1, (k, diff)
    _close(got["mask"], want["mask"], "mask")
    g_value = torch.tensor(120.0)
    whole = one(x, g_value=g_value, generator=torch.Generator().manual_seed(3))
    alone = one(x[1:], g_value=g_value,
                generator=torch.Generator().manual_seed(3))
    apart = (alone["wildfire"].int() - whole["wildfire"][1:].int()).abs()
    assert apart.max().item() > 1
