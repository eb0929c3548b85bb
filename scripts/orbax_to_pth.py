#!/usr/bin/env python
"""Convert a JAX training run dir (orbax checkpoint) into a run dir of the
PyTorch port (``climategan_torch``), which serves and resumes it.

Usage (on a host with JAX and orbax; the port's card needs neither):
  python scripts/orbax_to_pth.py -i jax_run_dir -o torch_run_dir

The input is what ``climategan_tpu``'s trainer writes: ``opts.json`` or
``opts.yaml`` and ``checkpoints/latest.json`` naming the newest orbax
checkpoint of the whole ``TrainState`` (both models' variables, both
optimizer states, the step and the JAX PRNG key). When the run dir was
moved, the absolute path in ``latest.json`` is gone, and the checkpoint
is looked up as ``checkpoints/<its basename>``.

The output is the port trainer's layout (``climategan_torch/utils/
checkpoint.py``): ``opts.yaml`` and ``opts.json`` (the run's opts over the
port's defaults), ``checkpoints/latest_ckpt.pth`` (``epoch``, ``G``,
``g_opt``, ``D``, ``d_opt``, ``step``, ``generator``) and
``checkpoints/latest.json``. ``python -m climategan_torch.apply_events
-r``, ``eval_masker -r``, ``compare_maskers -r`` serve it, and ``python -m
climategan_torch.train args.resume=true output_path=<it>`` resumes it at
the JAX run's epoch and step. Every tensor is the JAX leaf's value (conv
kernels HWIO -> OIHW): the generator through
``climategan_torch.utils.convert.state_dict_from_jax``, the
discriminators through ``d_state_dict_from_jax``, and each optimizer
moment (ExtraAdam's mu, nu, saved; Adam's mu, nu) leaf by leaf onto the
parameter it belongs to. A config without discriminators converts G
alone (``D`` and ``d_opt`` hold no tensors, as the port's trainer saves
them).

The JAX PRNG key has no PyTorch counterpart: the checkpoint's
``generator`` (the port's loss and painter draws) is a new
``torch.Generator`` seeded from the opts (their ``seed``, else 0, the
port trainer's own seed), so the draws after a resume differ from the
JAX run's.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def orbax_checkpoint(run_dir: Path):
    """(the orbax checkpoint dir, its epoch) that ``checkpoints/
    latest.json`` names; a name that no longer exists (a moved run dir)
    is looked up under ``checkpoints/`` by its basename."""
    ckpts = run_dir / "checkpoints"
    meta = json.loads((ckpts / "latest.json").read_text())
    path = Path(str(meta["latest"]))
    if not path.is_absolute():
        path = ckpts / path
    if not path.exists():
        moved = ckpts / path.name
        if not moved.exists():
            raise FileNotFoundError(
                f"{ckpts / 'latest.json'} names {meta['latest']}, which "
                f"exists neither there nor as {moved}")
        path = moved
    return path, int(meta["epoch"])


def restore(path: Path) -> dict:
    """The saved ``TrainState`` as a dict of numpy trees."""
    import orbax.checkpoint as ocp

    raw = ocp.StandardCheckpointer().restore(path.resolve())
    if not (isinstance(raw, dict) and "g_params" in raw):
        raise ValueError(f"{path} holds no TrainState of the JAX trainer")
    import jax

    return jax.tree_util.tree_map(np.asarray, raw)


def leaf_pairing(to_state_dict, variables: dict, names) -> dict:
    """{port parameter name: index of its leaf in ``variables["params"]``'s
    flattening}. Each leaf is replaced by an array filled with its index,
    and ``to_state_dict`` (the converter of the model's weights) says
    which tensor each index lands in."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    if len(leaves) >= 2 ** 24:  # indices exact in float32
        raise ValueError("too many leaves to pair")
    tagged = jax.tree_util.tree_unflatten(treedef, [
        np.full(np.shape(a), i, np.float32) for i, a in enumerate(leaves)])
    sd = to_state_dict({**variables, "params": tagged})
    pairing = {}
    for name in names:
        if name not in sd:
            raise KeyError(f"no JAX leaf converts to the port's {name}")
        t = sd[name]
        pairing[name] = int(t[(0,) * t.dim()])
    return pairing


def leaf_to_param(a: np.ndarray, like):
    """A JAX leaf in the layout of the port's parameter ``like``: conv
    kernels HWIO -> OIHW, scalars (NovoGrad's per-tensor second moment)
    and vectors as they are."""
    import torch

    a = np.asarray(a, dtype=np.float32)
    if a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))
    t = torch.from_numpy(np.ascontiguousarray(a))
    if a.ndim and tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"leaf of shape {a.shape} for a parameter of shape "
                         f"{tuple(like.shape)}")
    return t


def opt_state(opt: dict, pairing: dict, params: dict, want_keys) -> dict:
    """A JAX optimizer state (``count`` and per-leaf trees, as orbax
    restores a NamedTuple: a dict of its fields) in the port's
    ``opt_state_dict`` layout: ``count`` and ``{key: {name: tensor}}``."""
    import jax

    keys = sorted(k for k in opt if k != "count")
    if keys != sorted(want_keys):
        raise ValueError(f"the JAX optimizer state has {keys}; the port's "
                         f"optimizer of these opts keeps {sorted(want_keys)}")
    out = {"count": int(np.asarray(opt["count"]))}
    for key in keys:
        leaves = jax.tree_util.tree_leaves(opt[key])
        out[key] = {name: leaf_to_param(leaves[i], params[name])
                    for name, i in pairing.items()}
    return out


def convert(run_dir, out_dir) -> Path:
    """Writes the port's run dir; returns its ``latest_ckpt.pth``."""
    import torch
    import yaml

    from climategan_torch.models.discriminator import (
        DisConfig,
        OmniDiscriminator,
    )
    from climategan_torch.models.generator import GenConfig, OmniGenerator
    from climategan_torch.optim import make_optimizer
    from climategan_torch.utils.checkpoint import LATEST
    from climategan_torch.utils.convert import (
        d_state_dict_from_jax,
        state_dict_from_jax,
    )
    from climategan_torch.utils.serving import discover_opts

    run_dir, out_dir = Path(run_dir).resolve(), Path(out_dir).resolve()
    path, epoch = orbax_checkpoint(run_dir)
    opts = discover_opts(run_dir)
    state = restore(path)

    gcfg, dcfg = GenConfig.from_opts(opts), DisConfig.from_opts(opts)
    G, D = OmniGenerator(gcfg), OmniDiscriminator(dcfg)
    models = {
        "G": (G, {"params": state["g_params"], **state["g_state"]},
              lambda v: state_dict_from_jax(v, gcfg), state["g_opt"],
              opts.gen.opt.get("optimizer", "ExtraAdam")),
        "D": (D, {"params": state.get("d_params") or {},
                  **(state.get("d_state") or {})},
              lambda v: d_state_dict_from_jax(v, dcfg), state["d_opt"],
              opts.dis.opt.get("optimizer", "ExtraAdam")),
    }
    ckpt = {"epoch": epoch}
    for key, (module, variables, to_sd, opt, optimizer) in models.items():
        params = dict(module.named_parameters())
        want = module.state_dict()
        sd = to_sd(variables) if params else {}
        if set(sd) != set(want):
            raise ValueError(
                f"{key}: the converted keys differ from the port's model: "
                f"missing {sorted(set(want) - set(sd))[:8]}, extra "
                f"{sorted(set(sd) - set(want))[:8]}")
        ckpt[key] = sd
        pairing = leaf_pairing(to_sd, variables, params) if params else {}
        moments = [k for k in make_optimizer(optimizer)[0]([]) if k != "count"]
        ckpt[f"{key.lower()}_opt"] = opt_state(opt or {"count": 0}, pairing,
                                               params, moments)
    ckpt["step"] = int(np.asarray(state["step"]))
    seed = int(opts.get("seed", 0) or 0)
    ckpt["generator"] = torch.Generator().manual_seed(seed).get_state()

    ckpts = out_dir / "checkpoints"
    ckpts.mkdir(parents=True, exist_ok=True)
    torch.save(ckpt, ckpts / LATEST)
    (ckpts / "latest.json").write_text(json.dumps({"epoch": epoch,
                                                   "latest": LATEST}))
    plain = opts.to_dict()
    with open(out_dir / "opts.yaml", "w") as f:
        yaml.safe_dump(plain, f)
    with open(out_dir / "opts.json", "w") as f:
        json.dump(plain, f, indent=2, default=str)
    return ckpts / LATEST


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The JAX PRNG key is not converted: the port's draws resume "
               "from a torch.Generator seeded from the opts (their seed, "
               "else 0).")
    ap.add_argument("-i", "--input", required=True,
                    help="the JAX run dir (opts + checkpoints/latest.json)")
    ap.add_argument("-o", "--output", required=True,
                    help="the port's run dir to write")
    args = ap.parse_args(argv)
    out = convert(args.input, args.output)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
