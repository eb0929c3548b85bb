"""Trainer: setup, epochs, evaluation, checkpoints, resume and inference,
the port's counterpart of the JAX package's ``trainer.py`` (a re-design of
reference climategan/trainer.py: ``setup`` :702, ``train`` :888,
``run_epoch`` :924, ``run_evaluation`` :1653, ``save`` :396, ``resume``
:422, ``resume_from_path`` :336, ``infer_all`` :217).

The Trainer owns a ``train_step.TrainState`` (both models on the card in
train mode, both optimizer states, the step and the loss draws'
generator), the host loaders of ``data/datasets.py`` and a ``Logger``.
An epoch runs ``StepBuilder.train_step`` on the zipped train loaders
(KITTI alone while KITTI pretraining lasts), then the evaluation (the
seg head's pixel accuracy and mIOU, the validation losses, the image
panels) in eval mode, then a checkpoint in the reference ``.pth`` layout.

Unlike the JAX trainer, nothing here catches an exception raised by a
forward or a kernel: the evaluation and its panels run ``spade_cond`` and
``masked_blend``, and a failure there stops the run. Only an optional
logger (comet, the PNG writer) is skipped when absent. With
``train.fid.enable`` the evaluation also logs the painter's FID
(``compute_val_fid``). Options that are not ported raise a ``ValueError``
at ``setup`` naming their ROADMAP item: spatial shards or a mesh over
several devices (A.11); an orbax run dir raises where it would be loaded
(A.11).

Each epoch adds one record to ``train.jsonl``: the steps, the epoch's
seconds, the seconds spent waiting on the loader and each step's host
seconds; then the evaluation's and the checkpoint's seconds, the
checkpoint's bytes, the launches of each kernel over the epoch and, on a
card, the peak memory.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from climategan_torch import kernels
from climategan_torch.data.datasets import get_all_loaders, to_step_batch
from climategan_torch.eval_metrics import accuracy, mIOU
from climategan_torch.inference import build_infer_fn, resolve_device
from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.ops.interpolate import resize
from climategan_torch.optim import make_lr_schedule
from climategan_torch.train_step import StepBuilder
from climategan_torch.utils.checkpoint import (
    checkpoint_dict,
    load_partial_state,
    restore_checkpoint,
    save_checkpoint,
    state_digest,
)
from climategan_torch.utils.logger import Logger
from climategan_torch.utils.opts import load_opts

BOTH = ("masker", "painter")


def refuse_unported_trainer(opts) -> None:
    """Raises a ``ValueError`` naming its ROADMAP item for each trainer
    option this port does not have."""
    tpu = opts.get("tpu", {}) or {}
    if int(tpu.get("spatial_shards", 1) or 1) > 1:
        raise ValueError("tpu.spatial_shards > 1: row-sharded training is "
                         "not ported yet (ROADMAP A.11)")
    mesh = tpu.get("mesh", {}) or {}
    if any(int(v) not in (-1, 1) for v in mesh.values()):
        raise ValueError(f"tpu.mesh={dict(mesh)}: training over several "
                         "devices is not ported yet (ROADMAP A.11)")


def _path_opt(v) -> Optional[Path]:
    return (Path(str(v)).expanduser()
            if v and str(v).lower() != "none" else None)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).cpu().numpy()


class Trainer:
    def __init__(self, opts, comet_exp=None, device="cuda"):
        self.opts = opts
        self.device = resolve_device(device)
        self.logger = Logger(opts, comet_exp)
        self.is_setup = False
        self.loaders = None
        self.builder: Optional[StepBuilder] = None
        self.state = None
        self.G: Optional[OmniGenerator] = None  # inference mode
        self.inference_state = None
        self.val_painter = None
        self.current_epoch = 0
        self.kitti_pretrain = False
        self._infer_fns: Dict[tuple, tuple] = {}
        self.g_sched = make_lr_schedule(opts.gen.opt)
        self.d_sched = make_lr_schedule(opts.dis.opt)

    # ------------------------------------------------------------------
    def setup(self, inference: bool = False, seed: int = 0):
        """Training: loaders, the step, a random state from ``seed`` (the
        pretrained backbone over it where asked). Inference: the generator
        weights of the load paths or the run dir."""
        refuse_unported_trainer(self.opts)
        if inference:
            self.inference_state = self._inference_resume()
            if self.inference_state is not None:
                G = OmniGenerator(GenConfig.from_opts(self.opts))
                G.load_state_dict(self.inference_state, strict=True)
                self.G = G.eval().to(self.device)
            self.is_setup = True
            return self

        from climategan_torch.utils.convert import (
            maybe_load_pretrained_backbone,
        )
        from climategan_torch.utils.summary import write_architecture

        self.loaders = get_all_loaders(self.opts)
        self.builder = StepBuilder(self.opts, vgg=self._maybe_vgg(seed))
        self._sample_batch()
        self.state = self.builder.init_state(seed, self.device)
        if maybe_load_pretrained_backbone(self.opts, self.state.G):
            self.logger.print("loaded pretrained backbone weights")
        write_architecture(self.opts.output_path, self.state.G, self.state.D)
        self.is_setup = True
        return self

    def _inference_resume(self):
        """The generator state dict of the load paths, pm > (m and/or p) >
        output_path (reference trainer.py:422-546); None when there is
        none. A load path that is given must resolve."""
        from climategan_torch.utils.serving import (
            load_state,
            resolve_checkpoint,
        )

        lp = self.opts.get("load_paths", {}) or {}
        pm, p, m = (_path_opt(lp.get(k)) for k in ("pm", "p", "m"))
        state = None
        if pm is not None:
            state = load_state(pm, self.opts)
            self.logger.print(f"loaded P+M inference weights from {pm}")
        else:
            if m is not None:
                state = load_state(m, self.opts, parts=("masker",), into=state)
                self.logger.print(f"loaded M inference weights from {m}")
            if p is not None:
                state = load_state(p, self.opts, parts=("painter",),
                                   into=state)
                self.logger.print(f"loaded P inference weights from {p}")
        if state is None:
            out = Path(str(self.opts.output_path or ""))
            if out and out.exists():
                try:
                    resolve_checkpoint(out)
                except FileNotFoundError:
                    return None
                state = load_state(out, self.opts)
                self.logger.print(f"loaded inference weights from {out}")
        return state

    def _maybe_vgg(self, seed: int):
        """VGG19 for the painter's perceptual loss: torchvision weights
        from ``opts.vgg_weights``; without them the loss is off (with a
        warning) unless ``train.allow_random_vgg`` asks for a random VGG,
        as the JAX trainer does."""
        if float(self.opts.train.lambdas.G.p.vgg) == 0 or \
                "p" not in self.opts.tasks:
            return None
        from climategan_torch.losses import VGG19Features

        vgg_path = self.opts.get("vgg_weights") or None
        if not (vgg_path and Path(str(vgg_path)).exists()):
            if self.opts.train.get("allow_random_vgg", False):
                self.logger.print(
                    "WARNING: no vgg_weights found; training the perceptual "
                    "loss against a RANDOM VGG (train.allow_random_vgg=true)")
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(seed)
                    return VGG19Features().to(self.device)
            self.logger.print(
                "WARNING: no vgg_weights file found: the painter's VGG "
                "perceptual loss is OFF (the reference always uses "
                "torchvision's VGG19, losses.py:304-350). Set "
                "opts.vgg_weights to a torchvision vgg19 .pth, or "
                "train.allow_random_vgg=true to train against a random VGG.")
            return None
        from climategan_torch.utils.convert import load_vgg19_weights

        return load_vgg19_weights(str(vgg_path), VGG19Features()).to(
            self.device)

    def _sample_batch(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The first batch of each train loader, as the JAX trainer draws
        it (``next(iter(loader))``) to build its state: it consumes a
        shuffle (and the transforms' draws) of every loader before the
        first epoch."""
        return {domain: loader.sample()["data"]
                for domain, loader in self.loaders["train"].items()}

    # ------------------------------------------------------------------
    def train(self):
        assert self.is_setup
        epochs = int(self.opts.train.get("epochs", 1))
        kitti_epochs = 0
        if (self.opts.train.kitti.get("pretrain")
                and "kitti" in self.loaders.get("train", {})):
            kitti_epochs = int(self.opts.train.kitti.get("epochs", 10))
        for epoch in range(self.current_epoch, epochs):
            self.current_epoch = epoch
            self.kitti_pretrain = epoch < kitti_epochs
            before = dict(kernels.launches)
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            self.run_epoch()
            t0 = time.perf_counter()
            self.run_evaluation()
            t1 = time.perf_counter()
            path = self.save()
            rec = {"epoch": epoch, "eval_s": round(t1 - t0, 3),
                   "save_s": round(time.perf_counter() - t1, 3),
                   "ckpt_bytes": path.stat().st_size,
                   "launches": {k: v - before[k]
                                for k, v in kernels.launches.items()}}
            if self.device.type == "cuda":
                rec["max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated(self.device)
            self.logger.write(rec)

    def _epoch_loaders(self):
        """This epoch's train loaders; KITTI pretraining swaps the sim
        stream for KITTI (reference switch_data, trainer.py:817-846)."""
        train = self.loaders["train"]
        if self.kitti_pretrain:
            return {"kitti": train["kitti"]}
        return {k: v for k, v in train.items() if k != "kitti"}

    def pseudo_scale(self, epoch: int) -> float:
        """1.0 while pseudo-label training lasts, 0.0 from
        ``train.pseudo.epochs`` on (-1 or 0: never off; reference
        trainer.py:920-922)."""
        pseudo = self.opts.train.get("pseudo", {}) or {}
        if not (pseudo.get("tasks") or []):
            return 0.0
        n = int(pseudo.get("epochs", -1))
        return 1.0 if (n <= 0 or epoch < n) else 0.0

    def run_epoch(self):
        epoch = self.current_epoch
        g_scale = self.g_sched(epoch)
        d_scale = self.d_sched(epoch)
        p_scale = self.pseudo_scale(epoch)
        t0 = time.perf_counter()
        waits, steps = [], []
        batches = zip(*self._epoch_loaders().values())
        while True:
            t_wait = time.perf_counter()
            tup = next(batches, None)
            t_got = time.perf_counter()
            if tup is None:
                break
            batch = {item["domain"]: to_step_batch(item["data"], self.device)
                     for item in tup}
            self.state, metrics = self.builder.train_step(
                self.state, batch, g_scale, d_scale, p_scale)
            self.logger.log_step(self.global_step, metrics)
            waits.append(t_got - t_wait)
            steps.append(time.perf_counter() - t_wait)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.logger.log_epoch_time(
            epoch, time.perf_counter() - t0, len(steps),
            loader_wait_s=[round(w, 4) for w in waits],
            step_s=[round(s, 4) for s in steps])
        # per-group learning rates, as the reference logs its lr_names
        # (logger.py:256-272, optim.py:88-107)
        lrs = {"lr/G": self.builder.g_lr * g_scale,
               "lr/D": self.builder.d_lr * d_scale}
        for prefix, scale in self.builder.g_lr_rules.items():
            lrs[f"lr/G_{prefix}"] = self.builder.g_lr * scale * g_scale
        for prefix, scale in self.builder.d_lr_rules.items():
            lrs[f"lr/D_{prefix}"] = self.builder.d_lr * scale * d_scale
        self.logger.log_metrics(lrs)

    @property
    def global_step(self) -> int:
        return int(self.state.step) if self.state is not None else 0

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _eval_G(self, val_painter: bool = False):
        """The generator in eval mode without gradients: the training
        state's (back in train mode after the block) or the inference
        model. ``val_painter``: with the validation painter in place of
        its own, where one is loaded."""
        if self.state is not None:
            G = self.state.G
            G.eval()
        else:
            assert self.G is not None, (
                "no weights loaded: run setup() with a resumable "
                "output_path or load_paths")
            G = self.G
        own = G.painter
        if val_painter and self.val_painter is not None:
            G.painter = self.val_painter
        try:
            with torch.no_grad():
                yield G
        finally:
            G.painter = own
            if self.state is not None:
                G.train()

    def load_val_painter(self) -> bool:
        """A frozen painter for the evaluation's painting only
        (``val.val_painter``; reference generator.py:357-411): a ``.pth``
        whose painter is under ``painter.`` (a full G state dict,
        ``G.``-prefixed or not) or unprefixed (a painter state dict), or a
        run dir of this trainer. Returns False when none is set; a path
        that does not load raises."""
        from climategan_torch.utils.convert import load_torch_state_dict
        from climategan_torch.utils.serving import torch_checkpoint

        path = self.opts.val.get("val_painter")
        if not path:
            return False
        sd = load_torch_state_dict(torch_checkpoint(path))
        sd = {k[2:] if k.startswith("G.") else k: v for k, v in sd.items()}
        painter = {k[len("painter."):]: v for k, v in sd.items()
                   if k.startswith("painter.")}
        if not painter:  # a painter state dict: keys without the prefix
            painter = dict(sd)
        G = self.state.G if self.state is not None else self.G
        val = OmniGenerator(G.cfg).painter
        val.load_state_dict(painter, strict=True)
        self.val_painter = val.to(self.device).eval().requires_grad_(False)
        self.logger.print("loaded validation-only painter")
        return True

    def run_evaluation(self):
        """One pass over the zipped val loaders: the seg head's accuracy
        and mIOU per domain (eval mode, f32) and the validation losses,
        averaged over the batches; then the panels and image grids."""
        if self.loaders is None or not self.loaders.get("val"):
            return {}
        p_scale = self.pseudo_scale(self.current_epoch)
        accum: Dict[str, float] = {}
        n = 0
        for tup in zip(*self.loaders["val"].values()):
            with self._eval_G() as G:
                for item in tup:
                    domain, data = item["domain"], item["data"]
                    if domain == "rf" or "s" not in data:
                        continue
                    x = to_step_batch({"x": data["x"]}, self.device)["x"]
                    _, s, _ = G.infer_masker(x)
                    pred = s.argmax(1).cpu().numpy()
                    tgt = np.asarray(data["s"])
                    for name, fn in (("acc", accuracy), ("mIOU", mIOU)):
                        key = f"val/{name}_{domain}"
                        accum[key] = accum.get(key, 0.0) + fn(pred, tgt)
            val_batch = {item["domain"]: to_step_batch(item["data"],
                                                       self.device)
                         for item in tup}
            losses = self.builder.eval_losses(self.state, val_batch, p_scale)
            for k, v in losses.items():
                accum[k] = accum.get(k, 0.0) + float(v)
            n += 1
        metrics = {k: v / max(n, 1) for k, v in accum.items()}
        if (self.opts.train.fid.get("enable", False)
                and "p" in self.opts.tasks):
            metrics["val/fid"] = self.compute_val_fid()
        self._log_eval_panels()
        self.log_eval_images()
        self.logger.log_metrics(metrics)
        return metrics

    def log_eval_images(self, n: int = 4):
        """Per-domain grids as the reference's comet grids (logger.py:28-219,
        296-339): a row per sample, columns input | label | prediction per
        task, and the masker -> painter panel; PNGs under
        ``output_path/images``."""
        tasks = set(self.opts.tasks)

        def grey(t, hw):
            a = _nhwc(resize(t.float(), hw, "bilinear"))
            lo, hi = a.min(), a.max()
            a = (a - lo) / (hi - lo + 1e-9)
            return np.repeat(a[..., :1], 3, axis=-1)

        def seg_grey(idx, hw, nc):
            a = idx.float()[:, None] / max(nc - 1, 1)
            return np.repeat(_nhwc(resize(a, hw, "nearest")), 3, axis=-1)

        for domain, loader in (self.loaders.get("val") or {}).items():
            item = loader.sample()
            if item is None:
                continue
            data = {k: v[:n] for k, v in item["data"].items()}
            t = to_step_batch(data, self.device)
            x = t["x"]
            hw = tuple(x.shape[-2:])
            cols = [_nhwc((x + 1) / 2)]
            with self._eval_G(val_painter=True) as G:
                if domain == "rf" and "p" in tasks:
                    m = t["m"]
                    cols.append(_nhwc((x * (1 - m) + 1) / 2))
                    cols.append(_nhwc((G.paint(m, x) + 1) / 2))
                elif tasks & set("msd"):
                    d, s, m = G.infer_masker(x)
                    if "d" in tasks:
                        if "d" in t:
                            cols.append(grey(t["d"], hw))
                        cols.append(grey(G.depth_map(d), hw))
                    if "s" in tasks:
                        nc = int(s.shape[1])
                        if "s" in t:
                            cols.append(seg_grey(t["s"], hw, nc))
                        cols.append(seg_grey(s.argmax(1), hw, nc))
                    if "m" in tasks:
                        if "m" in t:
                            cols.append(np.repeat(_nhwc(t["m"]), 3, axis=-1))
                        cols.append(np.repeat(_nhwc(m), 3, axis=-1))
                        if "p" in tasks:  # the masker -> painter panel
                            cols.append(_nhwc((G.paint(m, x) + 1) / 2))
                else:
                    continue
            self.logger.log_images(f"val_{domain}_tasks",
                                   np.concatenate(cols, axis=2),
                                   step=self.global_step)

    def _log_eval_panels(self, n: int = 2):
        """[x | d | s | m | painted] of the first val batch of r (else the
        first domain), as the reference's comet grids."""
        val = self.loaders["val"]
        loader = val.get("r") or next(iter(val.values()), None)
        if loader is None:
            return
        item = loader.sample()
        x = to_step_batch({"x": item["data"]["x"][:n]}, self.device)["x"]
        hw = tuple(x.shape[-2:])
        with self._eval_G() as G:
            d, s, m = G.infer_masker(x)
            d = G.depth_map(d)
            panels = [_nhwc((x + 1) / 2)]
            dn = resize((d - d.min()) / (d.max() - d.min() + 1e-9), hw,
                        "bilinear")
            panels.append(np.repeat(_nhwc(dn), 3, axis=-1))
            seg = resize(s, hw, "bilinear", align_corners=True).argmax(1)
            seg = seg.float()[:, None] / max(s.shape[1] - 1, 1)
            panels.append(np.repeat(_nhwc(seg), 3, axis=-1))
            panels.append(np.repeat(_nhwc(m), 3, axis=-1))
            if "p" in self.opts.tasks:
                panels.append(_nhwc((G.paint(m, x) + 1) / 2))
        self.logger.log_images("val_panel", np.concatenate(panels, axis=2),
                               step=self.global_step)

    def compute_val_fid(self, max_images: Optional[int] = None) -> float:
        """The painter's FID on the val rf images (reference
        fid.py:334-434): the first ``train.fid.n_images`` (or
        ``max_images``) of the rf loader, painted by the eval G (the
        validation painter where one is loaded) in batches of
        ``train.fid.paint_batch_size``, in f32 (``spade_cond`` and
        ``masked_blend`` on a card); the Inception of
        ``opts.inception_weights`` where the file exists, else random from
        seed 0 (a relative FID); real and painted features in batches of
        ``train.fid.batch_size``. NaN without an rf loader or the
        painter."""
        from climategan_torch.fid import FIDEvaluator, InceptionV3Features

        fid_opts = self.opts.train.fid
        rf = (self.loaders or {}).get("val", {}).get("rf")
        if rf is None or "p" not in self.opts.tasks:
            return float("nan")
        n_images = max_images or int(fid_opts.get("n_images", 57))
        xs, ms, n = [], [], 0
        for item in rf:
            t = to_step_batch({k: item["data"][k] for k in ("x", "m")},
                              self.device)
            xs.append(t["x"])
            ms.append(t["m"])
            n += t["x"].shape[0]
            if n >= n_images:
                break
        if not xs:
            return float("nan")
        x, m = torch.cat(xs)[:n_images], torch.cat(ms)[:n_images]
        paint_bs = int(fid_opts.get("paint_batch_size", 8))
        with self._eval_G(val_painter=True) as G:
            fake = torch.cat([G.paint(m[i:i + paint_bs], x[i:i + paint_bs])
                              for i in range(0, x.shape[0], paint_bs)])
        model = None
        w = _path_opt(self.opts.get("inception_weights"))
        if w is not None and w.exists():
            from climategan_torch.utils.convert import load_inception_weights

            model = load_inception_weights(str(w), InceptionV3Features())
        ev = FIDEvaluator(model, int(fid_opts.get("batch_size", 50)),
                          self.device)
        ev.set_real(x)
        return ev.fid(fake)

    def paint_and_mask(self, image_batch, mask_batch=None,
                       resolution: str = "approx") -> torch.Tensor:
        """Paint an NHWC [-1, 1] batch, inferring the masks when none are
        given (reference trainer.py:137-208); returns NHWC on the device.
        Resolutions: approx (down to the painter's 2^spade_n_up multiple),
        exact (approx, then resized back), basic (640^2), upsample (basic,
        then resized back)."""
        assert resolution in {"approx", "exact", "basic", "upsample"}
        x = torch.as_tensor(np.asarray(image_batch, np.float32)) \
            .permute(0, 3, 1, 2).to(self.device)
        orig_hw = tuple(x.shape[-2:])
        with self._eval_G() as G:
            mult = 2 ** G.cfg.p_spade_n_up
            if resolution in ("basic", "upsample"):
                work_hw = (640, 640)
            else:
                work_hw = (max(mult, orig_hw[0] // mult * mult),
                           max(mult, orig_hw[1] // mult * mult))
            xw = resize(x, work_hw, "bilinear")
            if mask_batch is None:
                z = G.encode(xw)
                z_depth = G.depth(z)[1] if G.cfg.m_use_dada else None
                m = G.mask(z, z_depth, x=xw)
            else:
                m = torch.as_tensor(np.asarray(mask_batch, np.float32)) \
                    .permute(0, 3, 1, 2).to(self.device)
                m = resize(m, work_hw, "nearest")
            painted = G.paint(m, xw)
        if resolution in ("exact", "upsample"):
            painted = resize(painted, orig_hw, "bilinear")
        return painted.permute(0, 2, 3, 1)

    # ------------------------------------------------------------------
    def save(self) -> Path:
        out = Path(str(self.opts.output_path)) / "checkpoints"
        path = save_checkpoint(out, self.state, self.current_epoch, self.opts)
        self.logger.print(f"saved checkpoint at epoch {self.current_epoch}")
        return path

    def _load_part(self, path, parts) -> bool:
        """The masker and/or painter of a ``.pth`` or run dir into the live
        generator (reference trainer.py:440-527); an orbax dir raises
        (ROADMAP A.11)."""
        load_partial_state(path, self.state.G, self.opts, parts)
        return True

    def resume(self) -> bool:
        """Resume with the reference's load-path precedence
        (defaults.yaml:2-14): pm > (p and/or m) > output_path's newest
        checkpoint, which restores the whole state and the epoch."""
        lp = self.opts.get("load_paths", {}) or {}
        pm, p, m = (_path_opt(lp.get(k)) for k in ("pm", "p", "m"))
        if pm is not None and self._load_part(pm, BOTH):
            self.logger.print(f"loaded P+M weights from {pm}")
            return True
        loaded = False
        if m is not None and self._load_part(m, ("masker",)):
            loaded = True
            self.logger.print(f"loaded Masker weights from {m}")
        if p is not None and self._load_part(p, ("painter",)):
            loaded = True
            self.logger.print(f"loaded Painter weights from {p}")
        if loaded:
            return True

        out = Path(str(self.opts.output_path)) / "checkpoints"
        ckpt, epoch = restore_checkpoint(out, self.state)
        if ckpt is None:
            return False
        self.current_epoch = epoch + 1
        digest = state_digest(checkpoint_dict(self.state, epoch))
        self.logger.write({"resumed_from_epoch": epoch,
                           "state_digest": digest})
        self.logger.print(f"resumed from epoch {epoch}")
        return True

    @classmethod
    def resume_from_path(cls, path, inference: bool = True,
                         setup: bool = True, overrides=None,
                         device="cuda") -> "Trainer":
        """A trainer (inference mode by default) from a run dir holding
        opts.json / opts.yaml and checkpoints (reference
        trainer.py:336-394)."""
        path = Path(str(path))
        opts_file = next((path / c for c in ("opts.json", "opts.yaml",
                                              "opts.yml")
                          if (path / c).exists()), None)
        opts = load_opts(path=opts_file, commandline_opts=overrides)
        opts.output_path = str(path)
        trainer = cls(opts, device=device)
        if setup:
            trainer.setup(inference=inference)
        return trainer

    # ------------------------------------------------------------------
    def _g_state_dict(self):
        if self.state is not None:
            return self.state.G.state_dict()
        assert self.inference_state is not None, (
            "no weights loaded: run setup() with a resumable output_path or "
            "load_paths, or pass state_dict=")
        return self.inference_state

    def infer_all(self, x, numpy: bool = True, stores: Optional[dict] = None,
                  bin_value: float = 0.5, cloudy: bool = True,
                  ignore_event=(), rng_seed: int = 0, state_dict=None):
        """All events on an NHWC [-1, 1] batch with the current (or the
        given) generator weights (reference trainer.py:217-334), in
        ``tpu.inference_dtype``. The model of each knob combination is built
        once and takes the weights at every call."""
        from climategan_torch.models.blocks import pack_spade_weights

        assert self.is_setup
        dtype = (torch.bfloat16
                 if self.opts.tpu.get("inference_dtype", "bfloat16")
                 == "bfloat16" else torch.float32)
        ignore_event = tuple(sorted(ignore_event))
        key = (dtype, float(bin_value), bool(cloudy), ignore_event)
        sd = self._g_state_dict() if state_dict is None else state_dict
        if key not in self._infer_fns:
            self._infer_fns[key] = build_infer_fn(
                self.opts, dtype=dtype, bin_value=bin_value, cloudy=cloudy,
                ignore_event=ignore_event, device=self.device, state_dict=sd)
        else:
            G, _ = self._infer_fns[key]
            G.load_state_dict(sd, strict=True)
            pack_spade_weights(G)
        _, infer = self._infer_fns[key]
        gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        t0 = time.perf_counter()
        out = infer(x, generator=gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if stores is not None:
            stores.setdefault("all events", []).append(
                time.perf_counter() - t0)
        if numpy:  # numpy has no bf16: a bf16 mask comes back as f32
            out = {k: (v.float() if v.dtype == torch.bfloat16 else v)
                   .cpu().numpy() for k, v in out.items()}
        return out
