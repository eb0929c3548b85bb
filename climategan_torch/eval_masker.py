#!/usr/bin/env python
"""Masker evaluation CLI of the port (the root ``eval_masker.py`` on
``G.infer_masker``), on the card unless ``--device cpu``.

Computes the paper's masker metrics against {cannot=0, must=1, may=2}
ground-truth labels: error, F0.5, edge coherence, MNR, plus the full
confusion table (reference eval_masker.py:37-69 thresholds), and writes a
JSON report + optional error-map PNGs.

    python -m climategan_torch.eval_masker --images_dir imgs/ \\
        --labels_dir labels/ -r model.pth [--output metrics.json] [--write_maps]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from climategan_torch.apply_events import find_images
from climategan_torch.eval_metrics import (
    edges_coherence_std_min,
    masker_classification_metrics,
)
from climategan_torch.inference import resolve_device
from climategan_torch.models.generator import (
    GenConfig,
    OmniGenerator,
    create_generator,
)
from climategan_torch.utils.native import resize_and_crop, uint8_to_m11
from climategan_torch.utils.opts import load_opts
from climategan_torch.utils.serving import check_servable, load_inference_state

ROOT = Path(__file__).resolve().parent.parent
# paper thresholds (reference eval_masker.py:54-68)
THRESHOLDS = {"error": 0.05, "f05": 0.95, "edge_coherence": 0.02,
              "accuracy": 0.95}
KEY_METRICS = ["f05", "error", "edge_coherence", "mnr"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m climategan_torch.eval_masker")
    ap.add_argument("--images_dir", required=True)
    ap.add_argument("--labels_dir", required=True)
    ap.add_argument("-r", "--resume_path", default=None)
    ap.add_argument("--output", default="masker_metrics.json")
    ap.add_argument("--write_maps", action="store_true")
    ap.add_argument("--plot", action="store_true",
                    help="per-image error-overlay figures + metric boxplots "
                         "(reference eval_masker.py:232-320, :751-772)")
    ap.add_argument("--bin_value", type=float, default=0.5)
    ap.add_argument("--limit", type=int, default=-1)
    ap.add_argument("--size", type=int, default=640,
                    help="inference resolution (reference fixes 640)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def load_masker(args) -> OmniGenerator:
    """The generator of ``-r`` (random weights from seed 0 without it), f32
    in eval mode on ``--device``; a checkpoint without the masker is
    refused."""
    device = resolve_device(args.device)
    if args.resume_path:
        opts, sd = load_inference_state(args.resume_path)
        check_servable(sd, ("masker",), args.resume_path)
        G = OmniGenerator(GenConfig.from_opts(opts))
        G.load_state_dict(sd, strict=True)
    else:
        print("WARNING: random weights (no -r given)", file=sys.stderr)
        G = create_generator(load_opts(), seed=0)
    return G.to(device).eval()


@torch.inference_mode()
def score_image(G: OmniGenerator, img: np.ndarray, label: np.ndarray,
                size: int, bin_value: float):
    """One (uint8 RGB image, {0, 1, 2} label) pair -> (metrics, maps,
    smooth mask prediction, the image and label at ``size``^2)."""
    img = resize_and_crop(img, size)
    x = torch.from_numpy(uint8_to_m11(img))[None].permute(0, 3, 1, 2)
    device = next(G.parameters()).device
    pred = G.infer_masker(x.contiguous().to(device))[2][0, 0].float().cpu().numpy()
    if label.shape[:2] != (size, size):
        import cv2

        label = cv2.resize(label, (size, size), interpolation=cv2.INTER_NEAREST)
    metrics, maps = masker_classification_metrics(pred, label)
    ec, _, _ = edges_coherence_std_min(pred, label, bin_th=bin_value)
    metrics["edge_coherence"] = ec
    return metrics, maps, pred, img, label


def summarize(per_image: List[Dict]) -> Dict:
    summary = {k: float(np.mean([m[k] for m in per_image]))
               for k in per_image[0] if k != "image"}
    summary["n_images"] = len(per_image)
    summary["pass"] = {
        "error": summary["error"] <= THRESHOLDS["error"],
        "f05": summary["f05"] >= THRESHOLDS["f05"],
        "edge_coherence":
            summary["edge_coherence"] <= THRESHOLDS["edge_coherence"],
        "accuracy": summary["accuracy"] >= THRESHOLDS["accuracy"],
    }
    return summary


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import cv2

    G = load_masker(args)
    img_paths = find_images(Path(args.images_dir))
    if args.limit > 0:
        img_paths = img_paths[: args.limit]
    labels_dir = Path(args.labels_dir)
    if args.plot:
        sys.path.insert(0, str(ROOT))
        from scripts.plot_metrics import boxplots, plot_overlay_images

    per_image = []
    for p in img_paths:
        lp = next((labels_dir / (p.stem + ext)
                   for ext in (".png", ".jpg", ".npy")
                   if (labels_dir / (p.stem + ext)).exists()), None)
        if lp is None:
            continue
        img = cv2.imread(str(p), cv2.IMREAD_COLOR)[..., ::-1]
        label = (np.load(lp) if lp.suffix == ".npy"
                 else cv2.imread(str(lp), cv2.IMREAD_GRAYSCALE))
        metrics, maps, pred, img, label = score_image(
            G, img, label, args.size, args.bin_value)
        metrics["image"] = p.name
        per_image.append(metrics)

        if args.write_maps:
            out = Path(args.output).parent / "maps"
            out.mkdir(parents=True, exist_ok=True)
            for name, m in maps.items():
                cv2.imwrite(str(out / f"{p.stem}_{name}.png"),
                            (np.clip(m, 0, 1) * 255).astype(np.uint8))
            # raw prediction too: scripts/plot_metrics.metrics_onefig
            # composes its figure offline from these maps
            cv2.imwrite(str(out / f"{p.stem}_pred.png"),
                        (np.clip(pred, 0, 1) * 255).astype(np.uint8))

        if args.plot:
            plot_dir = Path(args.output).parent / "plots"
            plot_dir.mkdir(parents=True, exist_ok=True)
            plot_overlay_images(
                plot_dir / f"{p.stem}.png", np.ascontiguousarray(img),
                label, pred, metrics, maps,
                edge_coherence=metrics["edge_coherence"])

    if not per_image:
        print("No (image, label) pairs found", file=sys.stderr)
        return 1

    summary = summarize(per_image)
    with open(args.output, "w") as f:
        json.dump({"summary": summary, "per_image": per_image}, f, indent=2)
    print(json.dumps({k: summary[k] for k in KEY_METRICS + ["accuracy"]},
                     indent=2))
    print(f"Report: {args.output}")

    if args.plot:
        plot_dir = Path(args.output).parent / "plots"
        plot_dir.mkdir(parents=True, exist_ok=True)
        boxplots({"model": per_image}, plot_dir)
        print(f"Plots: {plot_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
