"""Training checkpoints in the reference ``.pth`` layout (reference
trainer.py:396-579), the port's counterpart of the JAX package's
``utils/checkpoint.py`` (which writes orbax, a format that needs the JAX
stack).

A checkpoint is one ``torch.save``d dict of plain tensors, which loads
with ``weights_only=True``:

  * ``epoch``, ``G``, ``g_opt``, ``D``, ``d_opt``: the reference's keys.
    ``G`` and ``D`` are the models' state dicts (parameters, batch-norm
    running statistics, spectral u/v); ``G`` is the layout that
    ``apply_events -r`` serves and the JAX package's
    ``load_torch_state_dict`` + ``convert_generator`` read. ``g_opt`` and
    ``d_opt`` hold the optimizer's ``count`` and its per-parameter state
    (ExtraAdam: ``mu``, ``nu``, ``saved``) keyed by parameter name;
  * ``step`` (the global step: even steps extrapolate) and ``generator``
    (the state of the loss draws' generator).

``save_checkpoint`` writes ``latest_ckpt.pth`` every epoch and, at the
keep epochs, ``epoch_N.pth`` beside it, then ``latest.json`` (naming the
newest) and the run's ``opts.json``. A state restored from it is
bit-equal to the state saved.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

LATEST = "latest_ckpt.pth"


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def opt_state_dict(module: nn.Module, opt_state) -> Dict:
    """An optimizer state (``optim.py``: ``count`` and per-parameter lists)
    keyed by ``module``'s parameter names."""
    names = [n for n, _ in module.named_parameters()]
    out = {"count": int(opt_state["count"])}
    for key, value in opt_state.items():
        if key != "count":
            out[key] = {n: _cpu(t) for n, t in zip(names, value)}
    return out


def load_opt_state(module: nn.Module, saved: Dict, target) -> Dict:
    """The optimizer state of ``saved`` (``opt_state_dict``'s layout) as
    lists in ``module``'s parameter order, on each parameter's device;
    names that differ from the model's raise, naming them."""
    params = dict(module.named_parameters())
    out = {"count": torch.tensor(int(saved["count"]),
                                 dtype=target["count"].dtype)}
    for key in target:
        if key == "count":
            continue
        if key not in saved:
            raise ValueError(f"checkpoint optimizer state has no {key!r}")
        _check_keys(f"optimizer {key}", saved[key], params)
        out[key] = [saved[key][n].to(p.device) for n, p in params.items()]
    return out


def _check_keys(what: str, saved, want) -> None:
    got, need = set(saved), set(want)
    if got != need:
        raise ValueError(
            f"checkpoint structure mismatch vs current model ({what}): "
            f"missing={sorted(need - got)[:8]} extra={sorted(got - need)[:8]}")


def checkpoint_dict(state, epoch: int) -> Dict:
    """The save dict of a ``train_step.TrainState`` (on the CPU)."""
    return {
        "epoch": int(epoch),
        "G": {k: _cpu(v) for k, v in state.G.state_dict().items()},
        "g_opt": opt_state_dict(state.G, state.g_opt),
        "D": {k: _cpu(v) for k, v in state.D.state_dict().items()},
        "d_opt": opt_state_dict(state.D, state.d_opt),
        "step": int(state.step),
        "generator": state.generator.get_state(),
    }


def state_digest(ckpt: Dict) -> str:
    """sha256 over the training state of a save dict (everything but the
    epoch), key by key in sorted order: equal digests, bit-equal states."""
    h = hashlib.sha256()

    def walk(prefix, v):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(f"{prefix}.{k}", v[k])
        elif isinstance(v, torch.Tensor):
            h.update(f"{prefix}:{v.dtype}:{tuple(v.shape)}".encode())
            flat = v.detach().cpu().contiguous().reshape(-1)
            h.update(flat.view(torch.uint8).numpy().data)
        else:
            h.update(f"{prefix}={v!r}".encode())

    walk("", {k: v for k, v in ckpt.items() if k != "epoch"})
    return h.hexdigest()


def _atomic_save(obj, path: Path) -> None:
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(directory, state, epoch: int, opts=None) -> Path:
    """``latest_ckpt.pth`` every epoch, plus ``epoch_N.pth`` at the keep
    epochs (``epoch >= train.min_save_epoch`` and a multiple of
    ``train.save_n_epochs``, defaults.yaml), ``latest.json`` and the run
    dir's ``opts.json``. Returns the path of ``latest_ckpt.pth``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    train = opts.train if opts is not None else {}
    save_n = int(train.get("save_n_epochs", 25))
    min_save = int(train.get("min_save_epoch", 28))
    keep = epoch >= min_save and epoch % max(save_n, 1) == 0

    latest = directory / LATEST
    _atomic_save(checkpoint_dict(state, epoch), latest)
    meta = {"epoch": epoch, "latest": LATEST}
    if keep:  # the same file under a second name
        kept = directory / f"epoch_{epoch}.pth"
        kept.unlink(missing_ok=True)
        try:
            os.link(latest, kept)
        except OSError:  # a file system without hard links
            shutil.copyfile(latest, kept)
        meta["kept"] = kept.name
    with open(directory / "latest.json", "w") as f:
        json.dump(meta, f)
    if opts is not None:
        with open(directory.parent / "opts.json", "w") as f:
            json.dump(opts, f, indent=2, default=str)
    return latest


def read_checkpoint(path) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(directory, state) -> Tuple[Optional[Dict], int]:
    """Restore the newest checkpoint under ``directory`` (a run's
    ``checkpoints/``) into ``state`` in place: both models, both optimizer
    states, the step and the draws' generator. Returns ``(checkpoint,
    epoch)``, or ``(None, -1)`` when there is none. Keys that differ from
    the model's raise, naming them; an orbax checkpoint raises (ROADMAP
    A.11)."""
    from climategan_torch.utils.serving import torch_checkpoint

    directory = Path(directory)
    if not ((directory / "latest.json").exists()
            or (directory / LATEST).exists()):
        return None, -1
    ckpt = read_checkpoint(torch_checkpoint(directory))
    for key in ("G", "D", "g_opt", "d_opt", "step", "generator"):
        if key not in ckpt:
            raise ValueError(f"{directory} holds no training checkpoint of "
                             f"this trainer: no {key!r}")
    for name, module in (("G", state.G), ("D", state.D)):
        _check_keys(name, ckpt[name], module.state_dict())
        module.load_state_dict(ckpt[name], strict=True)
    state.g_opt = load_opt_state(state.G, ckpt["g_opt"], state.g_opt)
    state.d_opt = load_opt_state(state.D, ckpt["d_opt"], state.d_opt)
    state.step = int(ckpt["step"])
    state.generator.set_state(ckpt["generator"])
    return ckpt, int(ckpt["epoch"])


def load_partial_state(path, G: nn.Module, opts,
                       parts=("masker", "painter")) -> None:
    """Load the masker and/or painter groups of a checkpoint (a ``.pth``
    or a run dir) into ``G`` in place, the rest kept: the reference's
    ``load_paths.m`` / ``.p`` / ``.pm`` (trainer.py:422-579,
    defaults.yaml:2-14)."""
    from climategan_torch.utils.serving import load_state

    sd = load_state(path, opts, parts=tuple(parts), into=G.state_dict())
    G.load_state_dict(sd, strict=True)

