"""What each rank of the port's data-parallel tests runs, in its own
process (``climategan_torch.parallel.spawn.run_ranks``): the port and
torch only, no JAX. Every function takes ``(device, payload)`` and
returns what the test holds to one process (tests/test_torch_port_parallel
.py) or to the JAX step (tests/test_torch_port_train.py and
_step_options.py).
"""
from __future__ import annotations

import torch

from climategan_torch import losses as L
from climategan_torch.models.discriminator import DisConfig, OmniDiscriminator
from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.models.norms import BatchNorm2d
from climategan_torch.parallel import distributed as dist
from climategan_torch.parallel.mesh import replicate, shard_batch
from climategan_torch.train_step import StepBuilder, TrainState
from climategan_torch.utils.checkpoint import (
    checkpoint_dict,
    read_checkpoint,
    save_on_main,
    state_digest,
)
from climategan_torch.utils.step_check import first_moments

LOSSES = {"sigm": L.sigm_loss, "dada": L.dada_depth_loss,
          "simse": L.simse_loss}


def _mine(t: torch.Tensor) -> torch.Tensor:
    return shard_batch(t, dist.rank(), dist.world())


def pieces(device, payload) -> dict:
    """Batch norm in train mode and the losses coupled to the batch, on
    this rank's rows inside ``sharded_batch()``: the outputs, the summed
    shares, the gradients of this rank's rows and the batch norm's
    parameter gradients summed over the ranks, its running statistics."""
    out = {}
    bn = BatchNorm2d(payload["x"].shape[1])
    bn.load_state_dict(payload["bn"])
    x = _mine(payload["x"]).requires_grad_(True)
    with dist.sharded_batch():
        y = bn(x)
        objective = (y * _mine(payload["c"])).sum()
    grads = torch.autograd.grad(objective, [x, bn.weight, bn.bias])
    out["bn"] = {"y": y.detach(), "x_grad": grads[0],
                 "w_grads": dist.all_reduce_grads(grads[1:]),
                 "running": (bn.running_mean.clone(),
                             bn.running_var.clone())}
    for name, fn in LOSSES.items():
        pred = _mine(payload["pred"]).requires_grad_(True)
        with dist.sharded_batch():
            share = fn(pred, _mine(payload["target"]))
            (g,) = torch.autograd.grad(share, [pred])
        out[name] = {"loss": dist.all_reduce_metrics({"v": share})["v"],
                     "grad": g}
    return out


def _models(opts, g_sd, d_sd):
    G = OmniGenerator(GenConfig.from_opts(opts))
    G.load_state_dict(g_sd)
    D = OmniDiscriminator(DisConfig.from_opts(opts))
    D.load_state_dict(d_sd)
    return G, D


def steps(device, payload) -> list:
    """Each job of the payload (a step name, the models' state dicts
    before it, its keyword arguments, and optionally opts of its own with
    the payload's ``train.grad_accumulation``), on ``device`` (TF32 off;
    PyTorch's deterministic algorithms with ``payload["deterministic"]``),
    on this rank's rows
    of the global batch from a state ``replicate`` made equal: rank 0
    returns both models, the stepped model's first moments and the metrics
    (on the CPU); every rank its state's digest."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(bool(payload.get("deterministic")),
                                      warn_only=True)
    opts = payload["opts"]
    builder = StepBuilder(opts)
    mine = shard_batch({d: {k: v.to(device) for k, v in b.items()}
                        for d, b in payload["batch"].items()},
                       dist.rank(), dist.world(), builder.grad_accumulation)
    results = []
    for job in payload["jobs"]:
        name, g_sd, d_sd, kwargs = job[:4]
        job_builder = builder if len(job) == 4 else StepBuilder(job[4])
        if job_builder.grad_accumulation != builder.grad_accumulation:
            raise ValueError("a job's opts split the batch otherwise")
        G, D = _models(opts, g_sd, d_sd)
        state = job_builder.state_for(G.to(device), D.to(device))
        replicate(state)
        state, metrics = getattr(job_builder, name)(state, mine, **kwargs)
        res = {"digest": state_digest(checkpoint_dict(state, 0))}
        if dist.is_main():
            def cpu(tree):
                return {k: v.detach().cpu() for k, v in tree.items()}

            res.update(G=cpu(G.state_dict()), D=cpu(D.state_dict()),
                       g_mu=cpu(first_moments(G, state.g_opt)),
                       d_mu=cpu(first_moments(D, state.d_opt)),
                       metrics={k: float(v) for k, v in metrics.items()})
        results.append(res)
    return results


def save(device, payload) -> dict:
    """``save_on_main`` of a small state that differs between the ranks
    until ``replicate``: rank 0 alone writes, every rank's digest is the
    one of the file."""
    torch.manual_seed(dist.rank())
    G, D = torch.nn.Conv2d(3, 4, 3), torch.nn.Conv2d(4, 1, 1)
    from climategan_torch.optim import init_extra_adam

    state = TrainState(G, D, init_extra_adam(list(G.parameters())),
                       init_extra_adam(list(D.parameters())), 3,
                       torch.Generator().manual_seed(dist.rank()))
    replicate(state)
    path, digests = save_on_main(payload["dir"], state, 0)
    return {"digests": digests, "mine": state_digest(checkpoint_dict(state, 0)),
            "file": state_digest(read_checkpoint(path)),
            "mtime": path.stat().st_mtime_ns}
