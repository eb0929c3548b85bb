"""The process group of data-parallel training and serving, the port's
counterpart of the JAX package's ``parallel/distributed.py``.

The JAX package joins a pod's coordination service and lets XLA insert the
collectives of a batch-sharded step. Here one process runs per rank, each
on one card, and the port issues its collectives itself over
``torch.distributed``:

  * ``maybe_init_distributed`` starts the group from the launcher's
    environment (``torch.distributed.run`` or SLURM) and returns the
    device of this rank; a single process starts nothing;
  * inside ``sharded_batch()`` the batch of the running step is split over
    the group's ranks, each holding its rows (``local_rows``): batch norms
    take the statistics of the global batch (``all_reduce_sum_grad``) and
    every loss returns this rank's **share** of the global loss, so that
    the shares sum to it; ``gather_batch`` gives every rank the global
    tensor where a loss needs one (the median of the depth loss);
  * after the backward, ``all_reduce_grads`` sums the shares' gradients:
    the gradient of the global loss on every rank.

Without a group (one process) every function here returns its input and
issues no collective. ``CLIMATEGAN_DISTRIBUTED=0`` keeps a process out of
any group (the counterpart of ``JAX_MULTIHOST=0``).
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

KILL_SWITCH = "CLIMATEGAN_DISTRIBUTED"
# a rank that fails or hangs fails the run: every collective (the barrier
# around rank 0's evaluation included) gives up after this many seconds
TIMEOUT_S = 1800
BUCKET_BYTES = 25 * 2 ** 20



class _Sharded:
    """Whether the running step's batch is split over the ranks. One flag
    for the process, not per thread: a rematerialized forward runs again
    inside the backward, on autograd's device thread."""

    on = False


def _launcher_env() -> Optional[Tuple[int, int, int]]:
    """(rank, world, local rank) of a multi-process launch, or None.
    ``torch.distributed.run`` sets RANK and WORLD_SIZE (a group starts even
    at world size 1); SLURM starts one when SLURM_NTASKS > 1, with the
    rendezvous in MASTER_ADDR and MASTER_PORT."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return (int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", "0")))
    try:
        ntasks = int(env.get("SLURM_NTASKS", "1"))
    except ValueError:
        ntasks = 1
    if ntasks <= 1:
        return None
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(
            f"SLURM_NTASKS={ntasks}: a data-parallel job needs the rendezvous "
            f"address; set {' and '.join(missing)} (e.g. MASTER_ADDR to the "
            "first node's host name and MASTER_PORT to a free port)")
    return (int(env["SLURM_PROCID"]), ntasks,
            int(env.get("SLURM_LOCALID", "0")))


def maybe_init_distributed(device="cuda", backend: Optional[str] = None,
                           verbose: int = 0,
                           spatial_shards: int = 1) -> torch.device:
    """Start the process group when this process is one rank of a
    multi-process launch, and return the device it runs on: ``cuda`` means
    ``cuda:LOCAL_RANK`` (a device with an index is kept), or under
    ``spatial_shards`` k the first of the k cards the rank owns
    (``mesh.spatial_devices``: ``cuda:LOCAL_RANK * k``), ``cpu`` the CPU.
    The backend is ``backend``, else ``nccl`` on a card and ``gloo`` on the
    CPU; nothing is retried on another. A single process (or
    ``CLIMATEGAN_DISTRIBUTED=0``) starts nothing and gets ``device``
    back."""
    from climategan_torch.inference import resolve_device

    device = resolve_device(device)
    if dist.is_initialized():
        return _device_of_rank(device)
    launch = None if os.environ.get(KILL_SWITCH) == "0" else _launcher_env()
    if launch is None:
        return device
    rank_, world_, local = launch
    from climategan_torch.parallel.mesh import spatial_devices

    shards = (spatial_devices(device, spatial_shards, local)
              if device.type == "cuda" and device.index is None else None)
    device = shards[0] if shards else _device_of_rank(device, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", rank=rank_,
        world_size=world_, timeout=datetime.timedelta(seconds=TIMEOUT_S),
        device_id=device if backend == "nccl" else None)
    if verbose:
        print(f"torch.distributed up: rank {rank_}/{world_} on {device} "
              f"({backend})", flush=True)
    return device


def _device_of_rank(device: torch.device,
                   local: Optional[int] = None) -> torch.device:
    """``cuda`` without an index -> ``cuda:LOCAL_RANK``; anything else as
    it is."""
    if device.type != "cuda" or device.index is not None:
        return device
    if local is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def local_rank() -> int:
    """This process's rank on its node (LOCAL_RANK; 0 without a group)."""
    launch = _launcher_env() if dist.is_initialized() else None
    return launch[2] if launch else 0


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def _to_comm(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it: NCCL takes tensors on this rank's
    card, gloo on the CPU or a card."""
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def barrier() -> None:
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (a picklable value)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_objects(obj) -> List:
    """Every rank's ``obj``, in rank order, on every rank."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


# ---- the sharded batch ---------------------------------------------------

@contextlib.contextmanager
def sharded_batch() -> Iterator[None]:
    """Inside the block the running step's batch is split over the group's
    ranks (``local_rows``): batch norms and losses reduce over the global
    batch. Outside it (rank 0's evaluation, serving) they see this rank's
    tensors alone."""
    before, _Sharded.on = _Sharded.on, True
    try:
        yield
    finally:
        _Sharded.on = before


def batch_world() -> int:
    """The ranks the running step's batch is split over: the group's size
    inside ``sharded_batch()``, else 1."""
    return world() if _Sharded.on else 1


def batch_rank() -> int:
    return rank() if _Sharded.on else 0


def local_rows(n: int, rank_: int, world_: int, micro: int = 1) -> List[int]:
    """The rows of a global batch of ``n`` that rank ``rank_`` of
    ``world_`` holds (the port's counterpart of ``make_global_array``: a
    rank keeps its own shard, and the global batch is their union in rank
    order). With ``micro`` micro-batches (``train.grad_accumulation``) they
    are its rows of **each** global micro-batch, micro-batch after
    micro-batch, so that a contiguous split of the shard into ``micro``
    parts gives its rows of each: the global micro-batch i is the union of
    the ranks' part i, as JAX splits the sharded global batch."""
    if n % (world_ * micro):
        raise ValueError(f"a batch of {n} does not split into {micro} "
                         f"micro-batches over {world_} ranks")
    m = n // micro
    per = m // world_
    return [i * m + rank_ * per + j for i in range(micro) for j in range(per)]


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward sums the gradients over the
    ranks: each rank's share of the loss reaches every rank's input."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)


def all_reduce_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the sharded batch, with its
    gradient (no collective outside ``sharded_batch()``)."""
    return _AllReduceSum.apply(x) if batch_world() > 1 else x


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order, on every rank, with their
    gradient (each rank's gradient reaches the rank that holds the row): a
    sum over the ranks of a zero-filled global buffer holding this rank's
    rows, which gloo takes for CUDA tensors and which adds exact zeros."""
    w = batch_world()
    if w == 1:
        return x
    n, r = x.shape[0], batch_rank()
    zeros = x.new_zeros((n,) + tuple(x.shape[1:]))
    buf = torch.cat([zeros] * r + [x] + [zeros] * (w - 1 - r))
    return _AllReduceSum.apply(buf)


# ---- after the backward ---------------------------------------------------

def _flat_all_reduce(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over the ranks of same-dtype tensors, through one flat
    buffer on the backend's device."""
    flat = _to_comm(torch.cat([t.reshape(-1) for t in tensors]))
    dist.all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.device))
        i += t.numel()
    return out


def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]],
                     bucket_bytes: int = BUCKET_BYTES
                     ) -> List[Optional[torch.Tensor]]:
    """The sums over the group's ranks of a step's gradients (None stays
    None: a parameter no loss reaches is unreached on every rank), in
    buckets of about ``bucket_bytes`` flattened per dtype. Without a group,
    the gradients as they are."""
    grads = list(grads)
    if not dist.is_initialized():
        return grads
    out: List[Optional[torch.Tensor]] = list(grads)
    buckets: Dict[torch.dtype, Tuple[List[int], int]] = {}

    def flush(dtype):
        idx, _ = buckets.pop(dtype)
        for i, t in zip(idx, _flat_all_reduce([grads[i] for i in idx])):
            out[i] = t

    for i, g in enumerate(grads):
        if g is None:
            continue
        idx, size = buckets.setdefault(g.dtype, ([], 0))
        idx.append(i)
        size += g.numel() * g.element_size()
        buckets[g.dtype] = (idx, size)
        if size >= bucket_bytes:
            flush(g.dtype)
    for dtype in list(buckets):
        flush(dtype)
    return out


def all_reduce_metrics(metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The sums over the ranks of scalar metrics (each rank's share of a
    loss: their sum is the global loss), in one collective; each keeps
    its device and dtype. Without a group, the metrics as they are."""
    if not dist.is_initialized() or not metrics:
        return metrics
    keys = list(metrics)
    vals = [torch.as_tensor(metrics[k]) for k in keys]
    device = next((v.device for v in vals if v.device.type != "cpu"),
                  vals[0].device)
    flat = _to_comm(torch.stack([v.detach().to(device, torch.float32)
                                 .reshape(()) for v in vals]))
    dist.all_reduce(flat)
    return {k: flat[i].to(v.device, v.dtype)
            for i, (k, v) in enumerate(zip(keys, vals))}


def broadcast_(tensors: Sequence[torch.Tensor],
               bucket_bytes: int = BUCKET_BYTES) -> None:
    """Rank 0's values into ``tensors`` on every rank, in place, through
    flat buffers of about ``bucket_bytes`` per device and dtype."""
    if not dist.is_initialized():
        return
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        i = 0
        while i < len(ts):
            j, size = i, 0
            while j < len(ts) and (j == i or size < bucket_bytes):
                size += ts[j].numel() * ts[j].element_size()
                j += 1
            chunk = ts[i:j]
            flat = _to_comm(torch.cat([t.detach().reshape(-1)
                                       for t in chunk]))
            dist.broadcast(flat, src=0)
            k = 0
            with torch.no_grad():
                for t in chunk:
                    t.copy_(flat[k:k + t.numel()].view(t.shape))
                    k += t.numel()
            i = j
