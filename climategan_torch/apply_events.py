#!/usr/bin/env python
"""Batch inference CLI of the port: render flood / wildfire / smog onto a
folder of street-level images, on the card unless ``--device cpu``.

    python -m climategan_torch.apply_events -i ./images -o ./outputs \\
        -r model.pth --half

The flag surface of the root ``apply_events.py`` plus ``--device``. ``-r``
takes a released reference ``.pth`` or a reference-style run dir
(``utils/serving.py``); without it the weights are random from ``--seed``.

``main(argv)`` parses the flags, decodes the images with cv2 and writes
PNGs; ``render(images, args, write)`` does the rest without files: the host
prep (``utils/native.py``, in a thread pool), batches grouped by shape with
the last one padded by repeating its last image, the forward through
``build_infer_fn``, and the copy of each batch's uint8 outputs into pinned
host buffers, whose PNG writes run on writer threads while the next batch
runs on the card (``--no_overlap`` synchronises every batch and writes it
before the next).
"""
from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from climategan_torch.inference import build_infer_fn, resolve_device
from climategan_torch.utils import native
from climategan_torch.utils.native import resize_and_crop, uint8_to_m11
from climategan_torch.utils.opts import load_opts
from climategan_torch.utils.serving import check_servable, load_inference_state
from climategan_torch.utils.timer import Timer, stores_report

WRITTEN_EVENTS = ("flood", "wildfire", "smog")
STAGES = ("imports", "setup", "decode", "data pre-processing", "all events",
          "write", "numpy")
# batches whose outputs may wait for the writers at once (host memory
# bound), and the writer threads: cv2's PNG encode releases the GIL, and one
# thread wrote 6 noise photos' PNGs at 640^2 in 0.19 s, 4x a batch-2 forward
IN_FLIGHT = 2
WRITERS = 4
SCALE_OUT = ("multi-GPU serving (--mesh, --spatial) is not ported yet: "
             "ROADMAP A.11")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m climategan_torch.apply_events")
    p.add_argument("-i", "--images_paths", type=str, required=True,
                   help="Path to a directory with image files")
    p.add_argument("-o", "--output_path", type=str, default=None,
                   help="Output directory (default: <input>/climategan_outputs)")
    p.add_argument("-r", "--resume_path", type=str, default=None,
                   help="a reference .pth file or a run dir with opts.yaml "
                        "and checkpoints/latest_ckpt.pth")
    p.add_argument("-b", "--batch_size", type=int, default=4)
    p.add_argument("--half", action="store_true",
                   help="bf16 inference (default f32)")
    p.add_argument("--flood_mask_binarization", type=float, default=0.5)
    p.add_argument("--keep_ratio_128", action="store_true",
                   help="Keep aspect ratio, round dims to multiples of 128")
    p.add_argument("--max_im_width", type=int, default=-1)
    p.add_argument("--no_cloudy", action="store_true")
    p.add_argument("--no_native", action="store_true",
                   help="disable the C++ host-preprocessing fast path")
    p.add_argument("--no_overlap", action="store_true",
                   help="synchronise each batch and write it before the next "
                        "(exact per-stage timings; default overlaps them)")
    p.add_argument("--ignore_event", nargs="*", default=[],
                   choices=["flood", "wildfire", "smog"])
    p.add_argument("--time", action="store_true", dest="time_inference",
                   help="Print the per-stage timing report")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--zip_outputs", action="store_true",
                   help="zip the output directory when done")
    p.add_argument("--upload", action="store_true",
                   help="upload outputs to comet.ml (requires comet creds)")
    p.add_argument("--mesh", action="store_true",
                   help="not ported: " + SCALE_OUT)
    p.add_argument("--spatial", action="store_true",
                   help="not ported: " + SCALE_OUT)
    p.add_argument("--fuse", action="store_true",
                   help="accepted for the root CLI's flag surface; a no-op: "
                        "the port always bakes spectral norm into the kernels")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mesh or args.spatial:
        parser.error(SCALE_OUT)
    return args


def new_stores() -> Dict[str, List[float]]:
    return {k: [] for k in STAGES}


# ---- host image prep (the root CLI's helpers) ---------------------------

def to_128(n: int, max_width: int = -1) -> int:
    """Floor to a multiple of 128 (reference utils.py:998-1007)."""
    n = max(128, (int(n) // 128) * 128)
    if max_width > 0:
        n = min(n, (max_width // 128) * 128)
    return n


def find_images(path: Path):
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}
    return sorted(p for p in path.iterdir() if p.suffix.lower() in exts)


def resize_keep_128(img: np.ndarray, max_width: int = -1) -> np.ndarray:
    import cv2

    h, w = img.shape[:2]
    return cv2.resize(img, (to_128(w, max_width), to_128(h, max_width)),
                      interpolation=cv2.INTER_LINEAR)


def prep(img: np.ndarray, args, use_native: bool) -> np.ndarray:
    """uint8 RGB HxWx3 -> the model's float32 [-1, 1] input; without the
    native library, ``native``'s one plain path."""
    if args.keep_ratio_128:
        img = resize_keep_128(img, args.max_im_width)
        return native.pack_uint8_to_m11(img) if use_native else uint8_to_m11(img)
    if use_native:
        # C++ resize + center crop + [-1, 1] pack in one pass (no
        # intermediate uint8 copy; releases the GIL)
        return native.prepare_inference(img, 640)
    return uint8_to_m11(resize_and_crop(img, 640))


def pad_batch(batch: np.ndarray, size: int) -> np.ndarray:
    """Pad to ``size`` images by repeating the last one, so every batch of a
    shape has one shape (and the wildfire's batch gray mean, one scalar
    over the batch, sees the same images as the root CLI's)."""
    pad = size - len(batch)
    if pad <= 0:
        return batch
    return np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)], axis=0)


# ---- model and serving loop ---------------------------------------------

def load_model(args) -> Callable:
    """``infer`` of ``build_infer_fn`` with the weights of ``-r`` (random
    from ``--seed`` without it) on ``--device``. A checkpoint that lacks
    the masker, or the painter while the flood is asked for, is refused."""
    device = resolve_device(args.device)
    state_dict = None
    if args.resume_path:
        opts, state_dict = load_inference_state(args.resume_path)
        # the painter runs only for the flood
        check_servable(state_dict, ("masker",) if "flood" in args.ignore_event
                       else ("masker", "painter"), args.resume_path)
    else:
        opts = load_opts()
        print("WARNING: no -r/--resume_path given; using random weights "
              "(pipeline timing/smoke mode)", file=sys.stderr)
    _, infer = build_infer_fn(
        opts, dtype=torch.bfloat16 if args.half else torch.float32,
        bin_value=args.flood_mask_binarization, cloudy=not args.no_cloudy,
        ignore_event=tuple(args.ignore_event), device=device,
        state_dict=state_dict, seed=args.seed)
    return infer


def _to_host(out: Dict[str, torch.Tensor], device: torch.device):
    """Start the copy of the written events to the host: pinned buffers and
    ``non_blocking`` copies with an event recorded after them on the card.
    The outputs are contiguous NHWC uint8 once copied; unlike the JAX CLI,
    nothing is flattened first (its ``flatten_events`` works around a
    strided transfer path of the TPU, which a CUDA copy does not have)."""
    keep = {k: v for k, v in out.items() if k in WRITTEN_EVENTS}
    if device.type != "cuda":
        return {k: v.contiguous() for k, v in keep.items()}, None
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            for k, v in keep.items()}
    for k, v in keep.items():
        host[k].copy_(v, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def render(images: Sequence[Tuple[str, np.ndarray]], args,
           write: Callable[[str, str, np.ndarray], None],
           infer: Optional[Callable] = None,
           stores: Optional[Dict[str, List[float]]] = None) -> int:
    """Serve ``images``, (name, uint8 RGB HxWx3) pairs, calling
    ``write(name, event, uint8 RGB HxWx3)`` for each written event. Loads
    the model from ``args`` unless ``infer`` is given. One
    ``torch.Generator`` on the device, seeded with ``--seed``, feeds every
    batch in turn. Returns the number of batches run."""
    stores = new_stores() if stores is None else stores
    device = resolve_device(args.device)
    if infer is None:
        with Timer(store=stores["setup"]):
            infer = load_model(args)

    with Timer(store=stores["data pre-processing"]):
        use_native = not args.no_native and native.available()
        # cv2 and the native library release the GIL
        with ThreadPoolExecutor(max_workers=4) as ex:
            xs = list(ex.map(lambda im: prep(im[1], args, use_native), images))
    # group identical shapes (one batch shape per bucket)
    by_shape: Dict[tuple, list] = {}
    for (name, _), a in zip(images, xs):
        by_shape.setdefault(a.shape, []).append((name, a))

    def flush(name, j, out, done):
        """Wait for the batch's copies, then write image j's events."""
        with Timer(store=stores["numpy"]):
            if done is not None:
                done.synchronize()
            arrays = {k: v[j].numpy() for k, v in out.items()}
        with Timer(store=stores["write"]):
            for event in WRITTEN_EVENTS:
                if event in arrays:
                    write(name, event, arrays[event])

    generator = torch.Generator(device=device).manual_seed(args.seed)
    n_batches = 0
    pending = []  # the write futures of each batch not yet written
    with ThreadPoolExecutor(max_workers=WRITERS) as writers:
        for shape, items in by_shape.items():
            for i in range(0, len(items), args.batch_size):
                chunk = items[i: i + args.batch_size]
                batch = pad_batch(np.stack([a for _, a in chunk]),
                                  args.batch_size)
                with Timer(store=stores["all events"],
                           sync=device if args.no_overlap else None):
                    x = torch.from_numpy(batch)
                    if device.type == "cuda":
                        x = x.pin_memory().to(device, non_blocking=True)
                    out, done = _to_host(infer(x, generator=generator), device)
                n_batches += 1
                if args.no_overlap:
                    for j, (name, _) in enumerate(chunk):
                        flush(name, j, out, done)
                else:
                    while len(pending) >= IN_FLIGHT:
                        for f in pending.pop(0):
                            f.result()
                    pending.append([writers.submit(flush, name, j, out, done)
                                    for j, (name, _) in enumerate(chunk)])
                print(f"  processed {i + len(chunk)}/{len(items)} @ {shape}")
        for fs in pending:
            for f in fs:
                f.result()
    return n_batches


def main(argv=None) -> int:
    args = parse_args(argv)
    stores = new_stores()
    t0 = time.perf_counter()
    import cv2
    stores["imports"].append(time.perf_counter() - t0)

    in_dir = Path(args.images_paths).expanduser().resolve()
    out_dir = (Path(args.output_path).expanduser().resolve()
               if args.output_path else in_dir / "climategan_outputs")
    out_dir.mkdir(parents=True, exist_ok=True)

    with Timer(store=stores["setup"]):
        infer = load_model(args)

    paths = find_images(in_dir)
    if not paths:
        print(f"No images found in {in_dir}", file=sys.stderr)
        return 1
    print(f"Found {len(paths)} images; batch={args.batch_size}")

    def decode(p):
        return p.stem, cv2.imread(str(p), cv2.IMREAD_COLOR)[..., ::-1]

    with Timer(store=stores["decode"]):
        with ThreadPoolExecutor(max_workers=4) as ex:
            images = list(ex.map(decode, paths))

    def write(name, event, img):
        cv2.imwrite(str(out_dir / f"{name}_{event}.png"), img[..., ::-1])

    render(images, args, write, infer=infer, stores=stores)

    if args.zip_outputs:
        import shutil

        zip_path = shutil.make_archive(str(out_dir), "zip", out_dir)
        print(f"zipped outputs: {zip_path}")

    if args.upload:
        try:
            import comet_ml

            exp = comet_ml.Experiment(project_name="climategan-tpu-inference")
            for f in sorted(out_dir.iterdir()):
                if f.suffix == ".png":
                    exp.log_image(str(f))
            exp.end()
            print("uploaded outputs to comet")
        except Exception as e:
            print(f"comet upload unavailable: {e}", file=sys.stderr)

    if args.time_inference:
        print("\n--- timing report (s) ---")
        print(stores_report(stores))
    print(f"Outputs written to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
