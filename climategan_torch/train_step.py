"""One training step of the generator and the discriminators: ``g_step``
(update_G), then ``d_step`` (update_D), as the JAX package's
``train_step.py`` computes them.

Batch layout: ``{domain: {task: tensor}}`` with NCHW images, masks and
depth targets and (N, H, W) integer seg labels. Domains: "r" (real) and "s"
(sim) for the masker, "rf" (real flooded) for the painter.

What carries over from the JAX step:
  * G and D are in train mode in both steps. Every train-mode forward
    advances the batch-norm running statistics and, where the JAX step
    passes ``update_sn``, the spectral u/v, in place: the state threads
    through the domains in the order the step visits them (the G step: r,
    s, then rf; the D step: the batch's order). The G step advances D's
    u/v; the D step runs G (under ``torch.no_grad()``: the D losses read
    only detached G outputs), which advances G's statistics and u/v.
  * Gradients reach only the net being stepped: the other net's
    parameters are frozen while the step runs.
  * Every GAN loss of one step shares one draw ``(soft, flip)``: ``soft``
    is the label shift (a uniform times ``dis.soft_shift``), ``flip`` the
    label flip (a uniform below ``dis.flip_prob``). A painter with z
    (``gen.p.no_z: false``) also takes one NCHW latent for the rf batch
    per step. Each step draws both from ``TrainState.generator``, the
    z after ``(soft, flip)``; ``draws=`` and ``z=`` pass them in.
  * The SPADE mask decoder's conditioning is ``G.make_m_cond`` of the
    step's own depth and seg outputs, their gradient stopped in the D step
    and with ``gen.m.spade.detach``. The depth loss is the bucket
    cross-entropy under ``gen.d.classify.enable``, berHu under
    ``gen.d.loss: dada``, else the scale-invariant one.
  * Mixed precision: with ``train.bf16`` the generator runs under bf16
    autocast on bf16 inputs; parameters, optimizer state, statistics, the
    discriminators and the losses stay f32.
  * Without VGG weights (``vgg=None``) the perceptual loss is skipped, as
    the JAX trainer does when none are given.

Options outside the ported path raise a ``ValueError`` at
``StepBuilder(...)`` that names the ROADMAP item that will port them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn as nn

from climategan_torch import losses as L
from climategan_torch.models.discriminator import (
    OmniDiscriminator,
    create_discriminator,
)
from climategan_torch.models.generator import OmniGenerator, create_generator
from climategan_torch.ops.interpolate import resize
from climategan_torch.optim import build_lr_scales, clamp_params, make_optimizer

Batch = Dict[str, Dict[str, torch.Tensor]]
Draws = Tuple[float, bool]
REMAINDER = "ROADMAP A.8 remainder"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training hyperparameters of ``opts`` that the ported branches
    read (a copy of the JAX package's ``TrainConfig``; the options of the
    branches not ported are refused by ``refuse_unported``)."""

    tasks: Tuple[str, ...] = ("d", "s", "m", "p")
    lam_d_main: float = 1.0
    lam_d_gml: float = 0.5
    lam_s_crossent: float = 1.0
    lam_s_minent: float = 0.001
    lam_s_advent: float = 0.001
    lam_m_bce: float = 1.0
    lam_m_tv: float = 1.0
    lam_m_gi: float = 0.05
    lam_p_vgg: float = 10.0
    lam_p_tv: float = 0.0
    lam_p_context: float = 0.0
    lam_p_reconstruction: float = 0.0
    lam_p_featmatch: float = 10.0
    adv_main: float = 1.0
    ent_main: float = 0.5
    ent_var: float = 0.1
    s_use_advent: bool = True
    s_use_dada: bool = True
    s_use_minent: bool = True
    m_use_advent: bool = True
    m_use_dada: bool = False
    m_use_minent: bool = True
    m_use_minent_var: bool = True
    m_use_ground_intersection: bool = True
    p_loss: str = "gan"
    soft_shift: float = 0.2
    flip_prob: float = 0.05
    m_gan_type: str = "WGAN_norm"
    s_gan_type: str = "WGAN_norm"
    use_vgg: bool = True
    bf16: bool = True
    d_classify: bool = False
    d_loss: str = "sigm"
    m_use_spade: bool = False
    p_no_z: bool = True
    pseudo_tasks: Tuple[str, ...] = ()
    lam_s_crossent_pseudo: float = 0.001
    wgan_clamp: Tuple[float, float] = (-0.01, 0.01)
    label_s: float = 0.0
    label_r: float = 1.0

    @classmethod
    def from_opts(cls, opts) -> "TrainConfig":
        lam = opts.train.lambdas
        return cls(
            tasks=tuple(opts.tasks),
            lam_d_main=float(lam.G.d.main),
            lam_d_gml=float(lam.G.d.gml),
            lam_s_crossent=float(lam.G.s.crossent),
            lam_s_minent=float(lam.G.s.minent),
            lam_s_advent=float(lam.G.s.advent),
            lam_m_bce=float(lam.G.m.bce),
            lam_m_tv=float(lam.G.m.tv),
            lam_m_gi=float(lam.G.m.gi),
            lam_p_vgg=float(lam.G.p.vgg),
            lam_p_tv=float(lam.G.p.tv),
            lam_p_context=float(lam.G.p.context),
            lam_p_reconstruction=float(lam.G.p.reconstruction),
            lam_p_featmatch=float(lam.G.p.featmatch),
            adv_main=float(lam.advent.adv_main),
            ent_main=float(lam.advent.ent_main),
            ent_var=float(lam.advent.ent_var),
            s_use_advent=bool(opts.gen.s.get("use_advent", True)),
            s_use_dada=bool(opts.gen.s.get("use_dada", True)),
            s_use_minent=bool(opts.gen.s.get("use_minent", True)),
            m_use_advent=bool(opts.gen.m.get("use_advent", True)),
            m_use_dada=bool(opts.gen.m.get("use_dada", False)),
            m_use_minent=bool(opts.gen.m.get("use_minent", True)),
            m_use_minent_var=bool(opts.gen.m.get("use_minent_var", True)),
            m_use_ground_intersection=bool(
                opts.gen.m.get("use_ground_intersection", True)),
            p_loss=opts.gen.p.get("loss", "gan"),
            soft_shift=float(opts.dis.get("soft_shift", 0.2)),
            flip_prob=float(opts.dis.get("flip_prob", 0.05)),
            m_gan_type=opts.dis.m.get("gan_type", "WGAN_norm"),
            s_gan_type=opts.dis.s.get("gan_type", "WGAN_norm"),
            use_vgg=float(lam.G.p.vgg) != 0,
            bf16=bool(opts.train.get("bf16", True)),
            d_classify=bool(opts.gen.d.get("classify", {}).get("enable",
                                                                False)),
            d_loss=opts.gen.d.get("loss", "sigm"),
            m_use_spade=bool(opts.gen.m.get("use_spade", False)),
            p_no_z=bool(opts.gen.p.get("no_z", True)),
            pseudo_tasks=tuple(opts.train.get("pseudo", {}).get("tasks", [])
                               or []),
            lam_s_crossent_pseudo=float(lam.G.s.get("crossent_pseudo", 0.001)),
            wgan_clamp=(float(opts.dis.m.get("wgan_clamp_lower", -0.01)),
                        float(opts.dis.m.get("wgan_clamp_upper", 0.01))),
        )


def refuse_unported(opts) -> None:
    """Raises a ``ValueError`` naming its ROADMAP item for each option whose
    branch of the JAX step this port does not have."""
    tpu = opts.get("tpu", {}) or {}
    checks = [
        ("train.grad_accumulation > 1",
         int(opts.train.get("grad_accumulation", 1) or 1) > 1, REMAINDER),
        ("tpu.remat", bool(tpu.get("remat", False)), REMAINDER),
        ("tpu.remat_d", bool(tpu.get("remat_d", False)), REMAINDER),
        ("dis.p.use_local_discriminator",
         bool(opts.dis.p.get("use_local_discriminator", False)), REMAINDER),
        ("gen.m.use_pl4m", bool(opts.gen.m.get("use_pl4m", False)),
         REMAINDER),
        ("WGAN_gp", "WGAN_gp" in (opts.dis.m.get("gan_type"),
                                  opts.dis.s.get("gan_type")), REMAINDER),
        ("gen.p.diff_aug.use", bool(opts.gen.p.diff_aug.get("use", False)),
         REMAINDER),
    ]
    for name, on, item in checks:
        if on:
            raise ValueError(f"{name} is not ported to the PyTorch training "
                             f"step yet ({item})")


@dataclasses.dataclass
class TrainState:
    """The models (in train mode), the optimizer states, the global step
    (even steps extrapolate) and the generator of the loss draws."""

    G: OmniGenerator
    D: OmniDiscriminator
    g_opt: dict
    d_opt: dict
    step: int = 0
    generator: torch.Generator = dataclasses.field(
        default_factory=lambda: torch.Generator().manual_seed(0))


def divide_pred(pred):
    """(real, fake) halves of a discriminator output of a real || fake
    batch."""
    if isinstance(pred, (list, tuple)):
        real = [[t[: t.shape[0] // 2] for t in scale] for scale in pred]
        fake = [[t[t.shape[0] // 2:] for t in scale] for scale in pred]
        return real, fake
    return pred[: pred.shape[0] // 2], pred[pred.shape[0] // 2:]


@contextlib.contextmanager
def frozen(module: nn.Module) -> Iterator[None]:
    """The module's parameters need no gradient inside the block."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _named(module: nn.Module) -> Tuple[List[str], List[torch.Tensor]]:
    named = list(module.named_parameters())
    return [n for n, _ in named], [p for _, p in named]


class StepBuilder:
    """The training step of ``opts``. ``vgg``: a ``VGG19Features`` with
    weights, or None to skip the perceptual loss."""

    def __init__(self, opts, vgg: Optional[nn.Module] = None):
        refuse_unported(opts)
        self.opts = opts
        self.cfg = TrainConfig.from_opts(opts)
        self.vgg = None if vgg is None else vgg.eval().requires_grad_(False)
        g_lr, d_lr = opts.gen.opt.lr, opts.dis.opt.lr
        self.g_lr = float(g_lr.get("default", 5e-5) if isinstance(g_lr, dict)
                          else g_lr)
        self.d_lr = float(d_lr.get("default", 2e-5) if isinstance(d_lr, dict)
                          else d_lr)
        self.g_opt_init, self.g_opt_step = make_optimizer(
            opts.gen.opt.get("optimizer", "ExtraAdam"),
            float(opts.gen.opt.get("beta1", 0.9)))
        self.d_opt_init, self.d_opt_step = make_optimizer(
            opts.dis.opt.get("optimizer", "ExtraAdam"),
            float(opts.dis.opt.get("beta1", 0.5)))
        # per-task lr groups: module prefixes -> multipliers of the default
        self.g_lr_rules: Dict[str, float] = {}
        if isinstance(g_lr, dict) and len(g_lr) > 1:
            prefixes = {"m": ("encoder", "decoders.m"), "d": ("decoders.d",),
                        "s": ("decoders.s",), "p": ("painter",)}
            for task, names in prefixes.items():
                if task in g_lr:
                    for name in names:
                        self.g_lr_rules[name] = float(g_lr[task]) / self.g_lr
        self.d_lr_rules: Dict[str, float] = {}
        if isinstance(d_lr, dict) and len(d_lr) > 1:
            for task, name in (("p", "p"), ("m", "m_advent"),
                               ("s", "s_advent")):
                if task in d_lr:
                    self.d_lr_rules[name] = float(d_lr[task]) / self.d_lr

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0, device="cuda") -> TrainState:
        """Random G (from ``seed``) and D (from ``seed + 1``) on ``device``
        in f32 and train mode, fresh optimizer states."""
        G = create_generator(self.opts, seed).to(device).train()
        D = create_discriminator(self.opts, seed + 1).to(device).train()
        return self.state_for(G, D, seed)

    def state_for(self, G: OmniGenerator, D: OmniDiscriminator,
                  seed: int = 0) -> TrainState:
        """A state around given models (put in train mode), fresh optimizer
        states and the draws' generator from ``seed``."""
        G.train()
        D.train()
        return TrainState(G, D, self.g_opt_init(list(G.parameters())),
                          self.d_opt_init(list(D.parameters())), 0,
                          torch.Generator().manual_seed(seed))

    def draw(self, state: TrainState) -> Draws:
        """One ``(soft, flip)`` draw from the state's generator."""
        u = torch.rand(2, generator=state.generator, dtype=torch.float64)
        return (float(u[0]) * self.cfg.soft_shift,
                bool(u[1] < self.cfg.flip_prob))

    def painter_z(self, state: TrainState, batch: Batch,
                  z: Optional[torch.Tensor] = None
                  ) -> Optional[torch.Tensor]:
        """``z``, or the painter's z for ``batch``'s rf images drawn from
        the state's generator (on the host) where the painter takes one;
        None where it takes none."""
        if (z is not None or self.cfg.p_no_z or "rf" not in batch
                or "p" not in self.cfg.tasks):
            return z
        x = batch["rf"]["x"]
        return state.G.sample_painter_z(
            x.shape[0], x.shape[2], x.shape[3],
            generator=state.generator).to(x.device)

    def _autocast(self, x: torch.Tensor, enabled: bool):
        return torch.autocast(x.device.type, dtype=torch.bfloat16,
                              enabled=enabled)

    def _p_gan_loss(self, pred, target_is_real: bool, draws: Draws,
                    for_discriminator: bool) -> torch.Tensor:
        if self.cfg.p_loss == "hinge":
            return L.hinge_loss(pred, target_is_real, for_discriminator)
        soft, flip = draws
        return L.gan_loss(pred, target_is_real, soft, flip)

    # ------------------------------------------------------------------
    # loss pieces
    # ------------------------------------------------------------------
    def _masker_losses(self, G, D, batch, domain: str, for_: str,
                       draws: Draws, update_sn: bool, eval_mode: bool = False,
                       pseudo_scale: float = 1.0):
        """Masker losses of one domain for the G step (``for_="G"``) or the
        D step (``"D"``, where G runs under ``torch.no_grad()``: the D
        losses read its outputs detached). Returns ``(total, metrics)``."""
        cfg = self.cfg
        x = batch["x"]
        bf16 = cfg.bf16 and not eval_mode
        if bf16:
            x = x.to(torch.bfloat16)
        metrics: Dict[str, torch.Tensor] = {}
        total = 0.0

        with self._autocast(x, bf16), torch.set_grad_enabled(
                for_ == "G" and torch.is_grad_enabled()):
            z = G.encode(x)
            d_pred = s_pred = z_depth = logits = None
            if "d" in cfg.tasks:
                d_pred, z_depth = G.depth(z, update_sn=update_sn)
            if "s" in cfg.tasks:
                s_pred = G.segmentation(z, z_depth)
            if "m" in cfg.tasks and ("m" in batch or for_ == "D"):
                cond = None
                if cfg.m_use_spade and d_pred is not None and s_pred is not None:
                    d_c, s_c = d_pred, s_pred
                    if for_ == "D":
                        d_c, s_c = d_c.detach(), s_c.detach()
                    cond = G.make_m_cond(d_c, s_c, x)
                logits = G.mask(z, z_depth, sigmoid=False, update_sn=update_sn,
                                cond=cond)

        def disc(method):
            return lambda e: method(e.float(), update_sn=update_sn)

        if (for_ == "G" and "d" in batch and d_pred is not None
                and (domain == "s" or "d" in cfg.pseudo_tasks)
                and cfg.lam_d_main != 0):
            pred = d_pred.float()
            if cfg.d_classify:
                target = batch["d"]
                if target.ndim == 4:  # (N, 1, H, W) bucket indices
                    target = target[:, 0]
                dl = L.cross_entropy(pred, target.long())
            elif cfg.d_loss == "dada":
                dl = L.dada_depth_loss(pred, batch["d"].float())
            else:
                dl = L.sigm_loss(pred, batch["d"].float(),
                                 gmweight=cfg.lam_d_gml)
            dl = dl * cfg.lam_d_main
            if domain != "s":
                dl = dl * pseudo_scale
            total = total + dl
            metrics[f"d_{domain}"] = dl

        if s_pred is not None:
            softmax_s = torch.softmax(s_pred.float(), dim=1)
            if for_ == "G":
                if "s" in batch and (domain == "s" or "s" in cfg.pseudo_tasks):
                    w = (cfg.lam_s_crossent if domain == "s"
                         else cfg.lam_s_crossent_pseudo)
                    if w != 0:
                        sl = L.cross_entropy(s_pred.float(), batch["s"]) * w
                        if domain != "s":
                            sl = sl * pseudo_scale
                        total = total + sl
                        metrics[f"s_crossent_{domain}"] = sl
                if (domain == "r" and cfg.s_use_minent
                        and cfg.lam_s_minent != 0):
                    ml = L.minent_loss(softmax_s) * cfg.lam_s_minent
                    total = total + ml
                    metrics["s_minent"] = ml
            if cfg.s_use_advent:
                dp = (d_pred.detach().float()
                      if cfg.s_use_dada and d_pred is not None else None)
                if for_ == "D":
                    label = cfg.label_s if domain == "s" else cfg.label_r
                    weight, sm = cfg.adv_main, softmax_s.detach()
                else:
                    label, weight, sm = cfg.label_s, cfg.lam_s_advent, softmax_s
                if (for_ == "D" or domain == "r") and weight != 0:
                    al = L.advent_loss(sm, label, disc(D.disc_s),
                                       cfg.s_gan_type, dp) * weight
                    total = total + al
                    metrics[f"s_advent_{for_}_{domain}"] = al

        if logits is not None:
            logits = logits.float()
            prob1 = torch.sigmoid(logits)
            prob = torch.cat([prob1, 1.0 - prob1], dim=1)
            if for_ == "G":
                if cfg.lam_m_tv != 0:
                    tl = L.tv_loss(prob1) * cfg.lam_m_tv
                    total = total + tl
                    metrics[f"m_tv_{domain}"] = tl
                if domain == "s" and "m" in batch and cfg.lam_m_bce != 0:
                    bl = L.bce_with_logits(logits, batch["m"].float()) \
                        * cfg.lam_m_bce
                    total = total + bl
                    metrics["m_bce"] = bl
                if domain == "r":
                    if (cfg.m_use_ground_intersection and "m" in batch
                            and cfg.lam_m_gi != 0):
                        gl = L.ground_intersection_loss(
                            prob1, batch["m"].float()) * cfg.lam_m_gi
                        total = total + gl
                        metrics["m_gi"] = gl
                    if cfg.m_use_minent and cfg.ent_main != 0:
                        ml = L.minent_loss(
                            prob, version=2 if cfg.m_use_minent_var else 1,
                            lambda_var=cfg.ent_var) * cfg.ent_main
                        total = total + ml
                        metrics["m_minent"] = ml
            if cfg.m_use_advent:
                dp = None
                if cfg.m_use_dada and d_pred is not None:
                    dp = resize(d_pred.detach().float(), x.shape[-2:],
                                "nearest")
                if for_ == "D":
                    label = cfg.label_s if domain == "s" else cfg.label_r
                    pr = prob.detach()
                else:
                    label, pr = cfg.label_s, prob
                if (for_ == "D" or domain == "r") and cfg.adv_main != 0:
                    al = L.advent_loss(pr, label, disc(D.disc_m),
                                       cfg.m_gan_type, dp) * cfg.adv_main
                    total = total + al
                    metrics[f"m_advent_{for_}_{domain}"] = al
        return total, metrics

    def _paint(self, G, batch, update_sn: bool, bf16: bool,
               z: Optional[torch.Tensor] = None):
        """(x, m, fake) in f32; the painter runs in bf16 under ``bf16``, on
        ``z`` where it takes one."""
        dt = torch.bfloat16 if bf16 else torch.float32
        x, m = batch["x"].to(dt), batch["m"].to(dt)
        with self._autocast(x, bf16):
            fake = G.paint(m, x, update_sn=update_sn, z=z)
        return x.float(), m.float(), fake.float()

    def _painter_losses(self, G, D, batch, draws: Draws, update_sn: bool,
                        bf16: Optional[bool] = None,
                        z: Optional[torch.Tensor] = None):
        """Painter losses of the G step on the rf domain. Returns
        ``(total, metrics)``."""
        cfg = self.cfg
        x, m, fake = self._paint(G, batch, update_sn,
                                 cfg.bf16 if bf16 is None else bf16, z)
        metrics: Dict[str, torch.Tensor] = {}
        total = 0.0
        if cfg.use_vgg and cfg.lam_p_vgg != 0 and self.vgg is not None:
            vl = L.vgg_loss(self.vgg, L.vgg_preprocess(fake * m),
                            L.vgg_preprocess(x * m)) * cfg.lam_p_vgg
            total = total + vl
            metrics["p_vgg"] = vl
        if cfg.lam_p_tv != 0:
            tl = L.tv_loss(fake * m) * cfg.lam_p_tv
            total = total + tl
            metrics["p_tv"] = tl
        if cfg.lam_p_context != 0:
            cl = L.context_loss(fake, x, m) * cfg.lam_p_context
            total = total + cl
            metrics["p_context"] = cl
        if cfg.lam_p_reconstruction != 0:
            rl = L.reconstruction_loss(fake, x, m) * cfg.lam_p_reconstruction
            total = total + rl
            metrics["p_reconstruction"] = rl

        real_fake = torch.cat([torch.cat([m, x], dim=1),
                               torch.cat([m, fake], dim=1)], dim=0)
        real_d, fake_d = divide_pred(D.disc_p(real_fake, update_sn=update_sn))
        gl = self._p_gan_loss(fake_d, True, draws, for_discriminator=False)
        total = total + gl
        metrics["p_gan"] = gl
        if cfg.lam_p_featmatch != 0:
            fl = L.feat_match_loss(real_d, fake_d) * cfg.lam_p_featmatch
            total = total + fl
            metrics["p_featmatch"] = fl
        return total, metrics

    # ------------------------------------------------------------------
    # the steps
    # ------------------------------------------------------------------
    def g_step(self, state: TrainState, batch: Batch, lr_scale: float = 1.0,
               pseudo_scale: float = 1.0, draws: Optional[Draws] = None,
               z: Optional[torch.Tensor] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """update_G: the masker losses over r and s, then the painter's over
        rf; one optimizer call over G's parameters."""
        draws = self.draw(state) if draws is None else draws
        z = self.painter_z(state, batch, z)
        G, D = state.G, state.D
        total = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        with frozen(D):
            for domain in ("r", "s"):
                if domain in batch and any(t in self.cfg.tasks for t in "msd"):
                    dl, dm = self._masker_losses(
                        G, D, batch[domain], domain, "G", draws, True,
                        pseudo_scale=pseudo_scale)
                    total = total + dl
                    metrics.update(dm)
            if "p" in self.cfg.tasks and "rf" in batch:
                pl, pm = self._painter_losses(G, D, batch["rf"], draws, True,
                                              z=z)
                total = total + pl
                metrics.update(pm)
        names, params = _named(G)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        scales = (build_lr_scales(names, self.g_lr_rules)
                  if self.g_lr_rules else None)
        state.g_opt = self.g_opt_step(grads, state.g_opt, params,
                                      self.g_lr * lr_scale,
                                      state.step % 2 == 0, scales)
        metrics["g_total"] = total
        return state, {k: v.detach() for k, v in metrics.items()}

    def d_step(self, state: TrainState, batch: Batch, lr_scale: float = 1.0,
               draws: Optional[Draws] = None,
               z: Optional[torch.Tensor] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """update_D: the painter D on rf and the ADVENT Ds on r and s, in
        the batch's order; one optimizer call over D's parameters, WGAN
        clipping of the ADVENT Ds, then the global step advances."""
        draws = self.draw(state) if draws is None else draws
        z = self.painter_z(state, batch, z)
        cfg = self.cfg
        G, D = state.G, state.D
        total = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        for domain, dbatch in batch.items():
            if domain == "rf" and "p" in cfg.tasks:
                with torch.no_grad():
                    x, m, fake = self._paint(G, dbatch, True, cfg.bf16, z)
                real_fake = torch.cat([torch.cat([m, x], dim=1),
                                       torch.cat([m, fake], dim=1)], dim=0)
                real_d, fake_d = divide_pred(D.disc_p(real_fake,
                                                      update_sn=True))
                dl = (self._p_gan_loss(fake_d, False, draws, True)
                      + self._p_gan_loss(real_d, True, draws, True))
                total = total + dl
                metrics["D_p_gan"] = dl
            elif domain in ("r", "s"):
                dl, dm = self._masker_losses(G, D, dbatch, domain, "D",
                                             draws, True)
                total = total + dl * cfg.adv_main
                metrics.update(dm)
        names, params = _named(D)
        if params:  # no discriminator (no task has a GAN loss): no update
            grads = torch.autograd.grad(total, params, allow_unused=True)
            scales = (build_lr_scales(names, self.d_lr_rules)
                      if self.d_lr_rules else None)
            state.d_opt = self.d_opt_step(grads, state.d_opt, params,
                                          self.d_lr * lr_scale,
                                          state.step % 2 == 0, scales)
        if cfg.m_gan_type == "WGAN" or cfg.s_gan_type == "WGAN":
            lo, hi = cfg.wgan_clamp
            for name in ("m_advent", "s_advent"):
                if hasattr(D, name):
                    clamp_params(list(getattr(D, name).parameters()), lo, hi)
        state.step += 1
        metrics["d_total"] = torch.as_tensor(total)
        return state, {k: v.detach() for k, v in metrics.items()}

    def train_step(self, state: TrainState, batch: Batch,
                   g_lr_scale: float = 1.0, d_lr_scale: float = 1.0,
                   pseudo_scale: float = 1.0, draws=(None, None)
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """``g_step`` then ``d_step``; ``draws``: (G's, D's) or None each."""
        state, gm = self.g_step(state, batch, g_lr_scale, pseudo_scale,
                                draws[0])
        state, dm = self.d_step(state, batch, d_lr_scale, draws[1])
        return state, {**gm, **dm}

    @torch.no_grad()
    def eval_losses(self, state: TrainState, batch: Batch,
                    pseudo_scale: float = 1.0,
                    draws: Optional[Draws] = None,
                    z: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        """Validation G losses with G and D in eval mode (baked spectral
        kernels, packed SPADEs, running statistics), in f32, with fixed
        draws and z (seed 0 unless given); the models go back to train
        mode."""
        fixed = TrainState(state.G, None, {}, {})
        draws = self.draw(fixed) if draws is None else draws
        z = self.painter_z(fixed, batch, z)
        G, D = state.G.eval(), state.D.eval()
        metrics: Dict[str, torch.Tensor] = {}
        total = 0.0
        try:
            for domain in ("r", "s"):
                if domain in batch and any(t in self.cfg.tasks for t in "msd"):
                    dl, dm = self._masker_losses(
                        G, D, batch[domain], domain, "G", draws, False,
                        eval_mode=True, pseudo_scale=pseudo_scale)
                    total = total + dl
                    metrics.update({f"val_{k}": v for k, v in dm.items()})
            if "p" in self.cfg.tasks and "rf" in batch:
                pl, pm = self._painter_losses(G, D, batch["rf"], draws, False,
                                              bf16=False, z=z)
                total = total + pl
                metrics.update({f"val_{k}": v for k, v in pm.items()})
        finally:
            G.train()
            D.train()
        metrics["val_g_total"] = total
        return metrics
