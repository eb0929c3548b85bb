"""Hand-written Hopper kernels of the port and their plain PyTorch twins.

Each wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. ``launches`` counts kernel launches
per kernel name, and nothing else adds to it.
"""
from __future__ import annotations

from typing import Dict

launches: Dict[str, int] = {"spade_cond": 0, "masked_blend": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
