"""Parameter counts of the models, written to the run directory (the
counterpart of the JAX package's ``utils/summary.py``, after reference
tutils.write_architecture)."""
from __future__ import annotations

from pathlib import Path

import torch.nn as nn


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def param_summary(module: nn.Module, max_depth: int = 2) -> str:
    """The total, then per submodule parameter counts nested up to
    ``max_depth``."""
    lines = [f"total params: {count_params(module):,}"]

    def walk(mod: nn.Module, path, depth):
        children = list(mod.named_children())
        if not children or depth >= max_depth:
            lines.append(f"{'  ' * depth}{'/'.join(path)}: "
                         f"{count_params(mod):,}")
            return
        for name, child in sorted(children):
            walk(child, path + (name,), depth + 1)

    for name, child in sorted(module.named_children()):
        walk(child, (name,), 0)
    return "\n".join(lines)


def write_architecture(output_path, G: nn.Module, D: nn.Module) -> None:
    """``archi_num_params.txt`` (reference tutils.py:616-645)."""
    out = Path(str(output_path))
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "archi_num_params.txt", "w") as f:
        f.write("=== Generator ===\n")
        f.write(param_summary(G))
        f.write("\n\n=== Discriminators ===\n")
        f.write(param_summary(D))
        f.write("\n")
