"""Stage timers: ``Timer`` with a store and ``stores_report``, from the JAX
package's ``utils/timer.py``.

PyTorch returns before the card finishes, so a timed region that must hold
the device's work passes ``sync=<device>``: ``torch.cuda.synchronize`` runs
on that device before the clock is read.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch


class Timer:
    """Context manager appending the elapsed seconds to ``store``."""

    def __init__(self, store: list, sync=None):
        self.store = store
        self.sync = None if sync is None else torch.device(sync)

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None and self.sync.type == "cuda":
            torch.cuda.synchronize(self.sync)
        self.store.append(time.perf_counter() - self._start)
        return False


def stores_report(stores: Dict[str, List[float]]) -> str:
    """mean +/- std per stage, like the reference apply_events.py:244-291."""
    lines = []
    for name, values in stores.items():
        if not values:
            continue
        v = np.asarray(values)
        lines.append(f"{name:>20}: {v.mean():.3f} +/- {v.std():.3f} "
                     f"(n={len(v)})")
    return "\n".join(lines)
