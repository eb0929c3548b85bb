"""The mesh of the JAX package's ``parallel/mesh.py``: a list of devices
for in-process replicas (serving, the bench), a batch split over the ranks
of a process group (training), and the device counts of row sharding.

The JAX package puts a ``data`` mesh axis, a ``space`` axis, or both
(``make_mesh_2d``) over its devices and lets XLA shard the batch and the
rows; here a serving process holds one replica of the model per device of
``make_mesh`` and splits each batch over them, or each image's rows
(``spatial.py``, ``inference.build_spatial_infer_fn``), or both
(``hybrid_groups``: each data group's row shards adjacent, as
``make_mesh_2d`` orders them). A training process is one rank of a group
(``distributed.py``) that takes its rows of the global batch
(``shard_batch``) from a state that ``replicate`` made equal on every
rank, and under ``tpu.spatial_shards`` k splits each image's rows over k
devices of its own (``spatial_devices``: rank r of a node owns cards
[r k, (r + 1) k)), the hybrid data x space layout.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from climategan_torch.parallel import distributed as dist


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of a mesh: ``devices`` (a device may repeat, e.g.
    ``["cuda:0", "cuda:0"]``), else every visible card; the first
    ``n_devices`` of them. Without a card and without ``devices`` it
    raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: give the mesh's "
                               "devices")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    return devs if n_devices is None else devs[:n_devices]


def mesh_size(batch: int, n: int) -> int:
    """The JAX rule: the largest device count up to ``n`` that divides the
    batch."""
    return max(d for d in range(1, max(n, 1) + 1) if batch % d == 0)


def spatial_size(rows: int, n: int) -> int:
    """The JAX rule of ``--spatial``: the largest device count up to ``n``
    that divides the rows."""
    return mesh_size(rows, n)


def hybrid_size(batch: int, rows: int, n: int, sp: int) -> int:
    """The data-parallel size of ``--hybrid sp`` over ``n`` devices (the
    JAX bench's rule): ``rows`` must divide by ``sp``; dp is the largest
    divisor of the batch up to ``n // sp``."""
    if sp < 1 or rows % sp:
        raise ValueError(f"--hybrid {sp}: size {rows} must divide by the "
                         "row shard count")
    if n < sp:
        raise ValueError(f"--hybrid {sp} needs {sp} devices, got {n}")
    return mesh_size(batch, n // sp)


def spatial_shards(opts) -> int:
    """``tpu.spatial_shards`` (1 when unset)."""
    return int((opts.get("tpu", {}) or {}).get("spatial_shards", 1) or 1)


def owned_cards(k: int, local_rank: int, n_cards: int) -> int:
    """How many of the cards [r k, (r + 1) k) that rank r of a node owns
    exist among ``n_cards``."""
    return max(0, min(k, n_cards - local_rank * k))


def spatial_devices(device, k: int, local_rank: int = 0,
                    n_cards: Optional[int] = None
                    ) -> Optional[List[torch.device]]:
    """The row shards' devices of a training rank under
    ``tpu.spatial_shards`` k, by the JAX trainer's rule over the devices
    the rank owns: on a card, rank ``local_rank`` of a node owns cards
    [r k, (r + 1) k) (start ``cards / k`` ranks a node) and shards over
    them where k divides them, that is where all k exist; on the CPU the
    shards share it. None where k does not divide the rank's cards: the
    rank trains unsharded, as JAX falls back to pure data parallelism
    (``fallback_message``). k <= 1: None."""
    device = torch.device(device)
    if k <= 1:
        return None
    if device.type != "cuda":
        return [device] * k
    n = torch.cuda.device_count() if n_cards is None else n_cards
    if owned_cards(k, local_rank, n) != k:
        return None
    return [torch.device("cuda", i)
            for i in range(local_rank * k, (local_rank + 1) * k)]


def fallback_message(k: int, n_devices: int) -> str:
    """The JAX trainer's message when ``tpu.spatial_shards`` does not
    divide the devices."""
    return (f"tpu.spatial_shards={k} does not divide the {n_devices}-device "
            "mesh; falling back to pure DP")


def hybrid_groups(devices: Sequence, dp: int, sp: int
                  ) -> List[List[torch.device]]:
    """The dp x sp grid of ``make_mesh_2d``: data group g holds the sp
    adjacent devices [g sp, (g + 1) sp)."""
    devs = [torch.device(d) for d in devices]
    if len(devs) < dp * sp:
        raise ValueError(f"need {dp * sp} devices, have {len(devs)}")
    return [devs[g * sp:(g + 1) * sp] for g in range(dp)]


def shard_batch(batch, rank: int, world: int, micro: int = 1):
    """Rank ``rank``'s rows of a global batch (a nested dict of tensors or
    numpy arrays with the batch first; ``distributed.local_rows``): with
    ``micro`` micro-batches, its rows of each global micro-batch. One rank
    gets the batch itself."""
    if world == 1:
        return batch

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        rows = dist.local_rows(x.shape[0], rank, world, micro)
        if isinstance(x, torch.Tensor):
            return x[torch.tensor(rows, device=x.device)]
        return np.asarray(x)[rows]

    return take(batch)


def replicate(state) -> None:
    """Rank 0's training state on every rank, in place: both models'
    parameters and buffers, both optimizer states, the step and the loss
    draws' generator (a ``train_step.TrainState``). Without a group it
    does nothing."""
    if not torch.distributed.is_initialized():
        return
    tensors = [t for m in (state.G, state.D) for t in m.state_dict().values()]
    for opt in (state.g_opt, state.d_opt):
        for value in opt.values():
            tensors.extend(value if isinstance(value, list) else [value])
    dist.broadcast_(tensors)
    state.step = int(dist.broadcast_object(int(state.step)))
    state.generator.set_state(dist.broadcast_object(
        state.generator.get_state()))


def gather(parts: Sequence[Dict[str, torch.Tensor]],
           device) -> Dict[str, torch.Tensor]:
    """The outputs of the replicas (dicts of batch-first tensors, in the
    replicas' order) as one batch on ``device``."""
    return {k: torch.cat([p[k].to(device) for p in parts])
            for k in parts[0]}
