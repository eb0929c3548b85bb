#!/usr/bin/env python
"""Compare several masker checkpoints on the same images, the port's twin
of ``scripts/compare_maskers.py`` (reference
utils_scripts/compare_maskers.py, without the comet upload), on the card
unless ``--device cpu``:

    python -m climategan_torch.compare_maskers -i images/ \\
        -r run_a/ run_b/ -l labels/ -o masker_comparison/ [--limit N]

Each ``-r`` is anything ``apply_events -r`` serves (a run dir of the
port's trainer, a reference-style run dir, a ``.pth``); its opts come
from the run dir (``opts.json`` / ``opts.yaml``), else the defaults. A run
dir with no checkpoint runs random weights (seed 0) and says so. Every
image is resized and center-cropped to 640^2 and run through each
model's ``infer_masker`` in f32; ``<stem>_panel.png`` is ``[input |
mask_1 | mask_2 | ...]``, and with ``-l`` (labels named by the image's
stem: 0 cannot, 1 must, 2 may be flooded) ``metrics.json`` holds each
model's mean of ``masker_classification_metrics``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from climategan_torch.apply_events import find_images
from climategan_torch.eval_metrics import masker_classification_metrics
from climategan_torch.inference import resolve_device
from climategan_torch.models.generator import (
    GenConfig,
    OmniGenerator,
    create_generator,
)
from climategan_torch.utils.native import resize_and_crop, uint8_to_m11
from climategan_torch.utils.serving import (
    discover_opts,
    load_state,
    resolve_checkpoint,
    run_dir_of,
)

SIZE = 640


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m climategan_torch.compare_maskers")
    ap.add_argument("-i", "--images_dir", required=True)
    ap.add_argument("-r", "--run_dirs", nargs="+", required=True)
    ap.add_argument("-l", "--labels_dir", default=None)
    ap.add_argument("-o", "--output_dir", default="masker_comparison")
    ap.add_argument("--limit", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no card raises")
    return ap.parse_args(argv)


def load_masker(run_dir, device: torch.device):
    """(name, f32 eval-mode generator on ``device``) of a run dir: its
    checkpoint's weights (a group it lacks kept as zeros, as
    ``apply_events -r`` loads them), or random weights (seed 0) with a
    warning when it has none."""
    rd = Path(run_dir).resolve()
    try:
        found = resolve_checkpoint(rd)
    except FileNotFoundError:
        print(f"WARNING: random weights for {rd.name}", file=sys.stderr)
        return rd.name, create_generator(discover_opts(rd), 0).to(device).eval()
    opts = discover_opts(run_dir_of(*found))
    G = OmniGenerator(GenConfig.from_opts(opts))
    G.load_state_dict(load_state(rd, opts), strict=True)
    return rd.name, G.to(device).eval()


def read_label(labels_dir, stem: str) -> Optional[np.ndarray]:
    import cv2

    lp = next(Path(labels_dir).glob(stem + ".*"), None)
    if lp is None:
        return None
    return cv2.resize(cv2.imread(str(lp), cv2.IMREAD_GRAYSCALE), (SIZE, SIZE),
                      interpolation=cv2.INTER_NEAREST)


@torch.inference_mode()
def compare(args) -> Dict:
    """Writes the panels (and ``metrics.json`` with labels); returns
    ``{"device", "panels", "metrics"}``."""
    import cv2

    device = resolve_device(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    models = [load_masker(rd, device) for rd in args.run_dirs]

    paths = find_images(Path(args.images_dir))
    if args.limit > 0:
        paths = paths[: args.limit]
    metrics: Dict[str, List[Dict]] = {name: [] for name, _ in models}
    panels = []
    for p in paths:
        img = resize_and_crop(cv2.imread(str(p), cv2.IMREAD_COLOR)[..., ::-1],
                              SIZE)
        x = torch.from_numpy(uint8_to_m11(img)).permute(2, 0, 1)[None]
        x = x.to(device).contiguous()
        label = read_label(args.labels_dir, p.stem) if args.labels_dir else None
        panel = [img]
        for name, G in models:
            m = G.infer_masker(x)[2][0, 0].float().cpu().numpy()
            panel.append(np.repeat((m * 255).astype(np.uint8)[..., None], 3,
                                   axis=-1))
            if label is not None:
                metrics[name].append(masker_classification_metrics(m, label)[0])
        panel_path = out / f"{p.stem}_panel.png"
        cv2.imwrite(str(panel_path), np.concatenate(panel, axis=1)[..., ::-1])
        panels.append(panel_path)
        print(p.stem)

    summary = None
    if args.labels_dir:
        summary = {
            name: {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
            for name, ms in metrics.items() if ms
        }
        with open(out / "metrics.json", "w") as f:
            json.dump(summary, f, indent=2)
        print(json.dumps(summary, indent=2))
    return {"device": str(device), "panels": panels, "metrics": summary}


def main(argv=None) -> int:
    compare(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
