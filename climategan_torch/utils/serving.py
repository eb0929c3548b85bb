"""Serving-path checkpoint resolution: generator weights for inference from
a resume path, the counterpart of the JAX package's ``utils/serving.py``.

The product story is "download the released trained weights and point
``apply_events -r`` at them". A resume path is classified as:

  * **torch .pth file**: a released ClimateGAN checkpoint (a bare G state
    dict or the reference's ``{"G": ..., "g_opt": ...}`` save dict);
  * **reference-style run dir**: a dir holding ``opts.yaml`` and
    ``checkpoints/latest_ckpt.pth`` (or any ``*.pth``), what the reference's
    own training runs write;
  * **port run dir**: what the port's trainer writes, ``checkpoints/`` with
    ``latest_ckpt.pth`` and ``latest.json`` naming the newest checkpoint,
    which wins;
  * **orbax run dir** (``checkpoints/latest.json`` naming no ``.pth``): the
    JAX package's own format. It is recognised so that the answer is the
    same as the JAX package's, but loading it raises: reading orbax needs
    the JAX stack (ROADMAP A.11).

Opts are found next to the checkpoint (``opts.json`` / ``opts.yaml`` /
``opts.yml`` in the run dir) and merged over the port's defaults, which
match the released checkpoints' architecture.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch

from climategan_torch.models.generator import GenConfig
from climategan_torch.utils.convert import (
    GROUPS,
    load_torch_state_dict,
    state_dict_from_reference,
)
from climategan_torch.utils.opts import Opts, load_opts

BOTH = ("masker", "painter")


def find_torch_ckpt(d: Path) -> Optional[Path]:
    """A torch checkpoint under a run dir, as the reference finds it
    (``<dir>/checkpoints/latest_ckpt.pth``), else the last ``*.pth`` (then
    ``*.pt``) by name in ``checkpoints/`` or the dir itself."""
    for base in (d / "checkpoints", d):
        if not base.is_dir():
            continue
        latest = base / "latest_ckpt.pth"
        if latest.exists():
            return latest
        pths = sorted(base.glob("*.pth")) + sorted(base.glob("*.pt"))
        if pths:
            return pths[-1]
    return None


def latest_torch_ckpt(ckpts: Path) -> Optional[Path]:
    """The ``.pth`` that ``<ckpts>/latest.json`` names (the port trainer's
    newest checkpoint; a relative name is under ``ckpts``), else None (an
    orbax ``latest.json`` names a directory)."""
    try:
        meta = json.loads((ckpts / "latest.json").read_text())
    except (OSError, ValueError):
        return None
    name = meta.get("latest") if isinstance(meta, dict) else None
    if not name or Path(str(name)).suffix not in (".pth", ".pt"):
        return None
    f = ckpts / str(name)
    return f.resolve() if f.is_file() else None


def resolve_checkpoint(path) -> Tuple[str, Path]:
    """Classify a resume path -> ("orbax", run_dir) | ("torch", pth_file).

    Raises FileNotFoundError naming the flavors tried when nothing matches.
    """
    p = Path(str(path)).expanduser().resolve()
    if p.is_file():
        if p.suffix in (".pth", ".pt"):
            return "torch", p
        raise FileNotFoundError(
            f"{p} is a file but not a torch checkpoint (.pth/.pt)")
    if p.is_dir():
        for ckpts in (p / "checkpoints", p):  # the run dir or its checkpoints
            if (ckpts / "latest.json").exists():
                newest = latest_torch_ckpt(ckpts)
                if newest is not None:
                    return "torch", newest
                return "orbax", ckpts.parent if ckpts == p else p
        t = find_torch_ckpt(p)
        if t is not None:
            return "torch", t
    raise FileNotFoundError(
        f"no checkpoint found at {p}: expected an orbax run dir "
        f"(checkpoints/latest.json), a torch .pth file, or a reference-"
        f"style run dir (checkpoints/latest_ckpt.pth)")


def run_dir_of(kind: str, p: Path) -> Path:
    """The run directory a resolved checkpoint belongs to (where
    opts.json / opts.yaml live)."""
    if kind == "orbax":
        return p
    run = p.parent
    if run.name == "checkpoints":
        run = run.parent
    return run


def discover_opts(run: Path, overrides=None) -> Opts:
    """Opts from the run dir when present, else the defaults (and
    ``overrides`` on top either way)."""
    for cand in ("opts.json", "opts.yaml", "opts.yml"):
        f = run / cand
        if f.exists():
            return load_opts(path=f, commandline_opts=overrides)
    return load_opts(commandline_opts=overrides)


def torch_checkpoint(path) -> Path:
    """The ``.pth`` file a resume path resolves to; an orbax run dir raises
    a ValueError naming ROADMAP A.11."""
    kind, p = resolve_checkpoint(path)
    if kind == "orbax":
        raise ValueError(
            f"{p} is an orbax run dir (checkpoints/latest.json), the JAX "
            f"package's checkpoint format, which the PyTorch port cannot "
            f"read (ROADMAP A.11); the port serves and resumes reference "
            f".pth files, reference-style run dirs "
            f"(checkpoints/latest_ckpt.pth) and its own trainer's run dirs")
    return p


def load_state(path, opts, parts: Tuple[str, ...] = BOTH,
               into: Optional[Mapping[str, torch.Tensor]] = None,
               allow_pickle: bool = False) -> Dict[str, torch.Tensor]:
    """The generator state dict of ``opts`` (or the masker / painter groups
    named by ``parts``) from a resume path; the groups outside ``parts``,
    and groups a checkpoint lacks entirely, come from ``into`` (zeros when
    None)."""
    sd = load_torch_state_dict(torch_checkpoint(path),
                               allow_pickle=allow_pickle)
    return state_dict_from_reference(sd, GenConfig.from_opts(opts),
                                     parts=parts, lenient=True, into=into)


def load_inference_state(resume_path, overrides=None,
                         allow_pickle: bool = False
                         ) -> Tuple[Opts, Dict[str, torch.Tensor]]:
    """One-call serving entry: a resume path of any flavor ->
    ``(opts, state_dict)``, for ``build_infer_fn(opts, state_dict=...)``.
    This is what ``apply_events -r`` and ``eval_masker -r`` use."""
    kind, p = resolve_checkpoint(resume_path)
    opts = discover_opts(run_dir_of(kind, p), overrides)
    return opts, load_state(resume_path, opts, allow_pickle=allow_pickle)


def zero_filled_parts(state_dict: Mapping[str, torch.Tensor]) -> Tuple[str, ...]:
    """The parts ("masker", "painter") with a module group whose tensors
    are all zero: a group the checkpoint lacked, which the lenient load
    kept as zeros. Such a module cannot run: its zero spectral u/v give a
    zero sigma."""
    parts = []
    for _, prefix, part in GROUPS:
        values = [v for k, v in state_dict.items() if k.startswith(prefix)
                  and not k.endswith(".num_batches_tracked")]
        if values and part not in parts and not any(v.any() for v in values):
            parts.append(part)
    return tuple(parts)


def check_servable(state_dict: Mapping[str, torch.Tensor],
                   parts: Iterable[str], source) -> None:
    """Raise ValueError where a part that the caller runs was zero-filled
    (``zero_filled_parts``): a forward of it would divide by a zero sigma."""
    empty = [p for p in zero_filled_parts(state_dict) if p in tuple(parts)]
    if not empty:
        return
    hint = ("; serve its masker with --ignore_event flood"
            if empty == ["painter"] else "")
    raise ValueError(f"{source} has no {' and no '.join(empty)} weights (the "
                     f"load kept them as zeros, which cannot run){hint}")
