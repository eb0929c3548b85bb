"""Training logger: console, a JSONL file and an optional comet.ml
experiment, the port's counterpart of the JAX package's
``utils/logger.py`` (a re-design of reference climategan/logger.py, which
logs scalars, learning rates and image panels to comet.ml).

Records go to ``<output_path>/train.jsonl``, one JSON object per line;
image grids to ``<output_path>/images/<name>_<step>.png``. Comet and the
PNG writer are optional: without them (or when a comet call fails) the
logger says so and goes on; nothing else is caught here.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

import numpy as np


class Logger:
    def __init__(self, opts, comet_exp=None, log_every: int = 50):
        self.opts = opts
        self.exp = comet_exp
        self.log_every = log_every
        self.start_time = time.time()
        self._last_step_time = time.time()
        self.out = Path(str(opts.get("output_path", "."))) if opts else Path(".")
        self.out.mkdir(parents=True, exist_ok=True)
        self.metrics_path = self.out / "train.jsonl"

    def print(self, *args):
        print("[climategan_torch]", *args, flush=True)

    @staticmethod
    def _to_float(metrics: Dict) -> Dict[str, float]:
        out = {}
        for k, v in metrics.items():
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                continue
        return out

    def write(self, record: Dict) -> None:
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _comet(self, method: str, *args, **kwargs) -> None:
        if self.exp is None:
            return
        try:
            getattr(self.exp, method)(*args, **kwargs)
        except Exception as e:  # an optional remote logger
            self.print(f"comet {method} failed: {e}")

    def log_step(self, step: int, metrics: Dict) -> None:
        """Every ``log_every`` global steps: the metrics (read from the
        device then, and only then) and the time since the last record."""
        if step % self.log_every != 0:
            return
        now = time.time()
        values = self._to_float(metrics)
        rec = {"step": step, "t": round(now - self.start_time, 2),
               "step_time": round(now - self._last_step_time, 4), **values}
        self._last_step_time = now
        self.write(rec)
        self._comet("log_metrics", values, step=step)
        self.print(f"step {step} g={rec.get('g_total', float('nan')):.4f} "
                   f"d={rec.get('d_total', float('nan')):.4f}")

    def log_epoch_time(self, epoch: int, seconds: float, n_steps: int,
                       **extra) -> None:
        rec = {"epoch": epoch, "epoch_time_s": round(seconds, 2),
               "steps": n_steps, **extra}
        self.write(rec)
        self.print(f"epoch {epoch}: {n_steps} steps in {seconds:.1f}s")

    def log_metrics(self, metrics: Dict) -> None:
        rec = self._to_float(metrics)
        if rec:
            self.write(rec)
            self._comet("log_metrics", rec)
            self.print(" ".join(f"{k}={v:.4f}" for k, v in rec.items()))

    def log_images(self, name: str, images: np.ndarray, step: int = 0) -> None:
        """An image grid ((n, H, W, 3) in [0, 1], side by side) as a PNG,
        and to comet."""
        grid = np.concatenate(list(images), axis=1)
        if grid.dtype != np.uint8:
            grid = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
        out = self.out / "images"
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{name}_{step}.png"
        try:
            import cv2

            cv2.imwrite(str(path), grid[..., ::-1])
        except ImportError:
            try:
                from PIL import Image
            except ImportError:
                self.print(f"no PNG writer (cv2 or PIL): {path.name} not "
                           "written")
            else:
                Image.fromarray(grid).save(path)
        self._comet("log_image", grid, name=name, step=step)
