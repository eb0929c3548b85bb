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

The options of the JAX ``StepBuilder``, each as the JAX step computes it:
  * ``dis.p.use_local_discriminator``: ``p_global`` on the painter's
    output and the real image, ``p_local`` on their masked parts (D calls
    in JAX's order, which sets the u/v); the G step's local GAN term is
    scaled by ``lambdas.G.p.gan``.
  * ``gen.m.use_pl4m``: on domain r of the G step, the painter paints the
    masked real image with the masker's ``prob1`` as the mask, in eval
    semantics (running statistics, the stored u/v, nothing written), its
    parameters detached, on the plain convs of train mode (``spade_cond``
    has no backward); the gradient reaches the mask through the painter's
    input, its conditioning and the paste (``MaskedBlend``). Its D calls
    are read-only.
  * ``WGAN_gp`` (``dis.{m,s}.gan_type``): in the D step, the gradient
    penalty of the read-only ADVENT D on the detached ``prob`` (m) or raw
    seg logits (s), weighted by ``lambdas.advent.WGAN_gp``.
  * ``gen.p.diff_aug``: ``ops/diff_aug.py`` on the painter's output and
    the real image after the painter's VGG/TV/context/reconstruction terms
    and before its D; the mask joins them unaugmented. Its draws come from
    the state's generator after ``(soft, flip)`` and z, or ``aug=``.
  * ``train.grad_accumulation: k``: each domain's batch in k contiguous
    slices; losses, metrics and gradients averaged, one optimizer call.
    Every slice starts from the step's initial statistics and u/v and
    the last slice's are kept (JAX's ``loss_fn`` reads the step's state);
    all share the step's draws, z and augmentation draws (of slice size).
  * ``tpu.remat`` / ``tpu.remat_d`` with ``tpu.remat_policy``: each
    per-domain loss function of the G (D) step under
    ``torch.utils.checkpoint``; ``""``/``"full"`` save nothing, ``"dots"``
    and ``"small_convs[:AREA]"`` save matrix products and (small)
    convolutions (``make_remat_policy``). The recompute runs from the
    statistics and u/v the forward started from and leaves those the
    forward wrote, as JAX's functional ``jax.checkpoint`` does, so a remat
    step equals a plain one.

Data parallel (a process group of several ranks, ``parallel/``): each rank
steps on its rows of the global batch (``parallel.mesh.shard_batch``;
under ``train.grad_accumulation`` its rows of each global micro-batch) from
the same state. ``g_step`` and ``d_step`` run inside
``distributed.sharded_batch()``: the batch norms take the global batch's
statistics and each loss is this rank's share of the global loss; the
draws are made for the global batch from the state's generator, the same
on every rank, and each rank takes its rows; the gradients and the metrics
are summed over the ranks before the optimizer call (``autograd.grad``
fires no DDP hook, so the step reduces them itself). The step then equals
one process's on the global batch, and every rank holds the same state.
Without a group nothing of this issues a collective.

Row-sharded (``devices=``, ``tpu.spatial_shards``): each micro-batch's
maps are split by rows over the k devices (``spatial.split_rows``: images,
masks, depth targets and the (N, H, W) seg labels by the same rule), after
the split into micro-batches and, on a rank, of its rows of the batch.
G and D run their ``forward_rows`` in train mode on the shards and each
loss takes the row-sharded maps (``losses.py``), so each shard's
gradients reach the one set of parameters (every shard reads them through
``.to(device)``), where autograd sums them; then the ranks' sums, as
above. The batch norms' statistics are those of every shard (and rank),
the spectral convs run one power iteration per call, the paste runs per
shard. Under several ranks this is the hybrid data x space step. Every
option runs on rows: the local painter D and pl4m's frozen painter on the
shards, the gradient penalty's norms summed over them, the diff-aug
translation's rows fetched from the neighbours, the VGG on rows, and remat
of per-domain functions that take ``Rows`` (its ``small_convs`` policy by
the whole map's area). Every generator configuration runs on rows: the
SPADE masker's conditioning is built on the shards (the depth's min-max
over every shard), a painter's z is drawn for the (global) batch as above
and split by rows, depth classification's bucket targets are split as the
maps, and DeepLab v2's dropout masks are drawn for the whole map and
sliced by rows (``deeplab_v2.dropout``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from climategan_torch import losses as L
from climategan_torch.models.discriminator import (
    OmniDiscriminator,
    create_discriminator,
)
from climategan_torch.models.generator import OmniGenerator, create_generator
from climategan_torch.ops.diff_aug import DiffTransforms
from climategan_torch.ops.interpolate import resize
from climategan_torch.optim import build_lr_scales, clamp_params, make_optimizer
from climategan_torch.parallel import distributed, spatial
from climategan_torch.parallel.spatial import Rows, each

Batch = Dict[str, Dict[str, torch.Tensor]]
Draws = Tuple[float, bool]
# the diff-aug draws of one step: (the painter output's, the real image's)
AugDraws = Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]
# the buffers a train-mode forward writes: batch-norm running statistics
# and spectral u/v
STATE_BUFFERS = ("running_mean", "running_var", "weight_u", "weight_v")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training hyperparameters of ``opts`` (a copy of the JAX
    package's ``TrainConfig``)."""

    tasks: Tuple[str, ...] = ("d", "s", "m", "p")
    lam_d_main: float = 1.0
    lam_d_gml: float = 0.5
    lam_s_crossent: float = 1.0
    lam_s_minent: float = 0.001
    lam_s_advent: float = 0.001
    lam_m_bce: float = 1.0
    lam_m_tv: float = 1.0
    lam_m_gi: float = 0.05
    lam_m_pl4m: float = 1.0
    lam_p_vgg: float = 10.0
    lam_p_tv: float = 0.0
    lam_p_context: float = 0.0
    lam_p_reconstruction: float = 0.0
    lam_p_featmatch: float = 10.0
    lam_p_gan: float = 1.0
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
    use_pl4m: bool = False
    p_loss: str = "gan"
    p_use_local: bool = False
    p_diff_aug_use: bool = False
    p_diff_aug_color: bool = False
    p_diff_aug_cutout: bool = False
    p_diff_aug_translation: bool = False
    p_diff_aug_cutout_ratio: float = 0.5
    p_diff_aug_translation_ratio: float = 0.125
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
    wgan_gp_lambda: float = 10.0
    wgan_clamp: Tuple[float, float] = (-0.01, 0.01)
    label_s: float = 0.0
    label_r: float = 1.0

    @classmethod
    def from_opts(cls, opts) -> "TrainConfig":
        lam = opts.train.lambdas
        aug = opts.gen.p.get("diff_aug", {}) or {}
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
            lam_m_pl4m=float(lam.G.m.pl4m),
            lam_p_vgg=float(lam.G.p.vgg),
            lam_p_tv=float(lam.G.p.tv),
            lam_p_context=float(lam.G.p.context),
            lam_p_reconstruction=float(lam.G.p.reconstruction),
            lam_p_featmatch=float(lam.G.p.featmatch),
            lam_p_gan=float(lam.G.p.gan),
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
            use_pl4m=bool(opts.gen.m.get("use_pl4m", False)),
            p_loss=opts.gen.p.get("loss", "gan"),
            p_use_local=bool(opts.dis.p.get("use_local_discriminator",
                                            False)),
            p_diff_aug_use=bool(aug.get("use", False)),
            p_diff_aug_color=bool(aug.get("do_color_jittering", False)),
            p_diff_aug_cutout=bool(aug.get("do_cutout", False)),
            p_diff_aug_translation=bool(aug.get("do_translation", False)),
            p_diff_aug_cutout_ratio=float(aug.get("cutout_ratio", 0.5)),
            p_diff_aug_translation_ratio=float(
                aug.get("translation_ratio", 0.125)),
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
            wgan_gp_lambda=float(lam.advent.get("WGAN_gp", 10.0)),
            wgan_clamp=(float(opts.dis.m.get("wgan_clamp_lower", -0.01)),
                        float(opts.dis.m.get("wgan_clamp_upper", 0.01))),
        )


_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default}
_CONVS = {torch.ops.aten.convolution.default}


def make_remat_policy(spec: str) -> Optional[Callable[..., bool]]:
    """``tpu.remat_policy`` as a predicate ``policy(op, *args) -> bool`` on
    an aten op and its arguments: True saves the op's output through the
    backward, False lets it be recomputed (JAX's ``make_remat_policy``).
    ``""``/``"full"`` -> None (save nothing); ``"dots"`` saves every matrix
    product and convolution; ``"small_convs[:AREA]"`` saves every matrix
    product and each convolution whose input's spatial area is at most
    AREA pixels (default 160 * 160): the masker trunk's, not the painter's
    full-resolution ones. On a row-sharded map the area is the whole
    map's (``spatial.whole_area``), not the shard's window's, so a sharded
    step saves the convolutions the unsharded step saves."""
    if not spec or spec == "full":
        return None
    if spec == "dots":
        return lambda op, *args: op in _MATMULS or op in _CONVS
    if spec.startswith("small_convs"):
        area = int(spec.split(":", 1)[1]) if ":" in spec else 160 * 160

        def policy(op, *args) -> bool:
            if op in _MATMULS:
                return True
            if op in _CONVS and args:
                whole = spatial.whole_area()
                if whole is None:
                    h, w = args[0].shape[-2:]
                    whole = h * w
                return whole <= area
            return False

        return policy
    raise ValueError(f"unknown tpu.remat_policy: {spec!r}")


def state_buffers(*modules: nn.Module) -> List[torch.Tensor]:
    """The buffers a train-mode forward of ``modules`` writes
    (``STATE_BUFFERS``)."""
    return [b for m in modules for n, b in m.named_buffers()
            if n.rsplit(".", 1)[-1] in STATE_BUFFERS]


@torch.no_grad()
def load_buffers(buffers: List[torch.Tensor],
                 values: List[torch.Tensor]) -> None:
    for b, v in zip(buffers, values):
        b.copy_(v)


def snapshot(buffers: List[torch.Tensor]) -> List[torch.Tensor]:
    return [b.detach().clone() for b in buffers]


@contextlib.contextmanager
def buffers_as(buffers: List[torch.Tensor],
               values: List[torch.Tensor]) -> Iterator[None]:
    """Inside the block the buffers hold ``values``; after it, what they
    held before."""
    now = snapshot(buffers)
    load_buffers(buffers, values)
    try:
        yield
    finally:
        load_buffers(buffers, now)


def remat_contexts(buffers: List[torch.Tensor],
                   policy: Optional[Callable[..., bool]],
                   devices: Tuple[torch.device, ...] = ()):
    """``context_fn`` of one ``checkpoint`` call: the forward runs as it
    is (under the selective policy's caching mode, where there is one);
    the recompute runs with ``buffers`` holding what they held when the
    forward started, and they get back what they held before the
    recompute; so do the random generators of the CUDA ``devices``
    (DeepLab v2's dropout draws the same masks again), which
    ``checkpoint`` restores only for the devices of the tensors it finds
    in its arguments, not of row-sharded maps."""
    start = snapshot(buffers)
    states = [torch.cuda.get_rng_state(d) for d in devices]
    if policy is None:
        fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
    else:
        def decide(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if policy(op, *args)
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        fwd, rec = create_selective_checkpoint_contexts(decide)

    @contextlib.contextmanager
    def recompute():
        with buffers_as(buffers, start), torch.random.fork_rng(
                devices=list(devices), enabled=bool(devices)), rec:
            for d, state in zip(devices, states):
                torch.cuda.set_rng_state(state, d)
            yield

    return fwd, recompute()


def cuda_devices(*args) -> Tuple[torch.device, ...]:
    """The CUDA devices of the tensors and row-sharded maps in ``args``
    (dicts, lists and tuples searched)."""
    found = {}

    def visit(a):
        if isinstance(a, Rows):
            for p in a.parts:
                visit(p)
        elif isinstance(a, torch.Tensor) and a.device.type == "cuda":
            found[a.device] = None
        elif isinstance(a, dict):
            for v in a.values():
                visit(v)
        elif isinstance(a, (list, tuple)):
            for v in a:
                visit(v)

    for a in args:
        visit(a)
    return tuple(found)


def _detach(t):
    return each(lambda p: p.detach(), t)


def shard_rows(batch: Batch, devices) -> Batch:
    """Every map of a batch split by rows over ``devices``
    (``spatial.split_rows``)."""
    return {dom: {key: spatial.split_rows(t, devices) for key, t in d.items()}
            for dom, d in batch.items()}


def split_micro(batch: Batch, k: int) -> List[Batch]:
    """A batch as k micro-batches of contiguous slices of each tensor (on
    a rank of a data-parallel step, its rows of each global micro-batch)."""
    if k <= 1:
        return [batch]
    return [{dom: {key: t[i * (t.shape[0] // k):(i + 1) * (t.shape[0] // k)]
                   for key, t in d.items()} for dom, d in batch.items()}
            for i in range(k)]


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
    batch (tensors or row-sharded maps)."""
    def real(t):
        return each(lambda p: p[: p.shape[0] // 2], t)

    def fake(t):
        return each(lambda p: p[p.shape[0] // 2:], t)

    if isinstance(pred, (list, tuple)):
        return ([[real(t) for t in scale] for scale in pred],
                [[fake(t) for t in scale] for scale in pred])
    return real(pred), fake(pred)


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


def _real_fake(m, x, fake):
    """The painter D's input: [m | x] || [m | fake] along the batch."""
    return each(lambda m_, x_, f_: torch.cat([torch.cat([m_, x_], dim=1),
                                              torch.cat([m_, f_], dim=1)],
                                             dim=0), m, x, fake)


class StepBuilder:
    """The training step of ``opts``. ``vgg``: a ``VGG19Features`` with
    weights, or None to skip the perceptual loss."""

    def __init__(self, opts, vgg: Optional[nn.Module] = None):
        self.opts = opts
        self.cfg = c = TrainConfig.from_opts(opts)
        tpu = opts.get("tpu", {}) or {}
        self.remat = bool(tpu.get("remat", False))
        self.remat_d = bool(tpu.get("remat_d", False))
        self.remat_policy = make_remat_policy(tpu.get("remat_policy", "")
                                              or "")
        self.grad_accumulation = int(opts.train.get("grad_accumulation", 1)
                                     or 1)
        self.diff_aug = (DiffTransforms(
            c.p_diff_aug_color, c.p_diff_aug_cutout, c.p_diff_aug_translation,
            c.p_diff_aug_cutout_ratio, c.p_diff_aug_translation_ratio)
            if c.p_diff_aug_use else None)
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
            # JAX matches "p" as a prefix of every painter D's name
            p_names = (("p_global", "p_local") if c.p_use_local else ("p",))
            for task, names in (("p", p_names), ("m", ("m_advent",)),
                                ("s", ("s_advent",))):
                if task in d_lr:
                    for name in names:
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
        None where it takes none. In a data-parallel step it is drawn for
        the global batch and this rank takes its rows."""
        if (z is not None or self.cfg.p_no_z or "rf" not in batch
                or "p" not in self.cfg.tasks):
            return z
        x = batch["rf"]["x"]
        n, w = x.shape[0], distributed.batch_world()
        z = state.G.sample_painter_z(n * w, x.shape[2], x.shape[3],
                                     generator=state.generator)
        if w > 1:
            r = distributed.batch_rank()
            z = z[r * n:(r + 1) * n]
        return z.to(x.device)

    def aug_draws(self, state: TrainState, batch: Batch,
                  aug: Optional[AugDraws] = None) -> Optional[AugDraws]:
        """``aug``, or the diff-aug draws for ``batch``'s rf images (the
        painter output's, then the real image's) from the state's
        generator where ``gen.p.diff_aug.use`` is on; None where it is
        off. In a data-parallel step they are drawn for the global batch
        and this rank takes its rows."""
        if (aug is not None or self.diff_aug is None or "rf" not in batch
                or "p" not in self.cfg.tasks):
            return aug
        n, _, h, w = batch["rf"]["x"].shape
        ranks = distributed.batch_world()
        draws = tuple(self.diff_aug.draw(n * ranks, h, w, state.generator)
                      for _ in range(2))
        if ranks == 1:
            return draws
        r = distributed.batch_rank()
        return tuple({k: v[r * n:(r + 1) * n] for k, v in d.items()}
                     for d in draws)

    def _remat(self, on: bool, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, under ``checkpoint`` when ``on``: the
        recompute starts from the statistics and u/v of G and D that the
        forward started from (``remat_contexts``). Row-sharded batches
        (``Rows``) pass as they are; every op names its shard's device, so
        a recompute that autograd runs on another device's thread computes
        the same."""
        if not on:
            return fn(*args, **kwargs)
        G, D = args[0], args[1]
        return checkpoint(functools.partial(fn, **kwargs), *args,
                          use_reentrant=False,
                          context_fn=functools.partial(
                              remat_contexts, state_buffers(G, D),
                              self.remat_policy,
                              cuda_devices(args[2:], kwargs)))

    def _accumulate(self, micro: List[Batch], loss_fn, params,
                    buffers: List[torch.Tensor]):
        """``(total, metrics, grads)`` of ``loss_fn`` averaged over the
        micro-batches, each from the statistics and u/v the step started
        from; the last one's are kept."""
        k = len(micro)
        start = snapshot(buffers) if k > 1 else None
        total, metrics, grads = 0.0, {}, None
        for i, mb in enumerate(micro):
            if i:
                load_buffers(buffers, start)
            t, m = loss_fn(mb)
            g = torch.autograd.grad(t, params, allow_unused=True) \
                if params else ()
            if i == 0:
                total, metrics, grads = t, m, list(g)
                continue
            total = total + t
            metrics = {key: metrics[key] + v for key, v in m.items()}
            grads = [a if b is None else (b if a is None else a + b)
                     for a, b in zip(grads, g)]
        if k > 1:
            inv = 1.0 / k
            total = total * inv
            metrics = {key: v * inv for key, v in metrics.items()}
            grads = [None if g is None else g * inv for g in grads]
        return total, metrics, grads

    def _autocast(self, x, enabled: bool):
        device = x.parts[0].device if isinstance(x, Rows) else x.device
        return torch.autocast(device.type, dtype=torch.bfloat16,
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
                       pseudo_scale: float = 1.0,
                       painter_z: Optional[torch.Tensor] = None,
                       gp_inputs: Optional[Dict[str, torch.Tensor]] = None):
        """Masker losses of one domain for the G step (``for_="G"``) or the
        D step (``"D"``, where G runs under ``torch.no_grad()``: the D
        losses read its outputs detached); ``painter_z``: pl4m's painter
        latent. Under ``WGAN_gp`` the D step's penalty inputs (detached)
        go into ``gp_inputs`` under "s" and "m", for ``_gradient_penalty``
        outside a rematerialized forward: a gradient taken inside one would
        recompute it there. Returns ``(total, metrics)``."""
        cfg = self.cfg
        x = batch["x"]
        bf16 = cfg.bf16 and not eval_mode
        if bf16:
            x = each(lambda t: t.to(torch.bfloat16), x)
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
                        d_c, s_c = _detach(d_c), _detach(s_c)
                    cond = G.make_m_cond(d_c, s_c, x)
                logits = G.mask(z, z_depth, sigmoid=False, update_sn=update_sn,
                                cond=cond)

        def disc(method):
            return lambda e: method(L.upcast(e), update_sn=update_sn)

        if (for_ == "G" and "d" in batch and d_pred is not None
                and (domain == "s" or "d" in cfg.pseudo_tasks)
                and cfg.lam_d_main != 0):
            pred = L.upcast(d_pred)
            if cfg.d_classify:
                # (N, 1, H, W) or (N, H, W) bucket indices
                target = each(lambda t: (t[:, 0] if t.ndim == 4 else t)
                              .long(), batch["d"])
                dl = L.cross_entropy(pred, target)
            elif cfg.d_loss == "dada":
                dl = L.dada_depth_loss(pred, L.upcast(batch["d"]))
            else:
                dl = L.sigm_loss(pred, L.upcast(batch["d"]),
                                 gmweight=cfg.lam_d_gml)
            dl = dl * cfg.lam_d_main
            if domain != "s":
                dl = dl * pseudo_scale
            total = total + dl
            metrics[f"d_{domain}"] = dl

        if s_pred is not None:
            softmax_s = each(lambda t: torch.softmax(t, dim=1),
                             L.upcast(s_pred))
            if for_ == "G":
                if "s" in batch and (domain == "s" or "s" in cfg.pseudo_tasks):
                    w = (cfg.lam_s_crossent if domain == "s"
                         else cfg.lam_s_crossent_pseudo)
                    if w != 0:
                        sl = L.cross_entropy(L.upcast(s_pred), batch["s"]) * w
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
                dp = (L.upcast(_detach(d_pred))
                      if cfg.s_use_dada and d_pred is not None else None)
                if for_ == "D":
                    label = cfg.label_s if domain == "s" else cfg.label_r
                    weight, sm = cfg.adv_main, _detach(softmax_s)
                else:
                    label, weight, sm = cfg.label_s, cfg.lam_s_advent, softmax_s
                if (for_ == "D" or domain == "r") and weight != 0:
                    al = L.advent_loss(sm, label, disc(D.disc_s),
                                       cfg.s_gan_type, dp) * weight
                    total = total + al
                    metrics[f"s_advent_{for_}_{domain}"] = al
                    if for_ == "D" and cfg.s_gan_type == "WGAN_gp":
                        # the raw logits, as JAX feeds them
                        gp_inputs["s"] = L.upcast(_detach(s_pred))

        if logits is not None:
            logits = L.upcast(logits)
            prob1 = each(torch.sigmoid, logits)
            prob = each(lambda p: torch.cat([p, 1.0 - p], dim=1), prob1)
            if for_ == "G":
                if cfg.lam_m_tv != 0:
                    tl = L.tv_loss(prob1) * cfg.lam_m_tv
                    total = total + tl
                    metrics[f"m_tv_{domain}"] = tl
                if domain == "s" and "m" in batch and cfg.lam_m_bce != 0:
                    bl = L.bce_with_logits(logits, L.upcast(batch["m"])) \
                        * cfg.lam_m_bce
                    total = total + bl
                    metrics["m_bce"] = bl
                if domain == "r":
                    if (cfg.m_use_ground_intersection and "m" in batch
                            and cfg.lam_m_gi != 0):
                        gl = L.ground_intersection_loss(
                            prob1, L.upcast(batch["m"])) * cfg.lam_m_gi
                        total = total + gl
                        metrics["m_gi"] = gl
                    if cfg.use_pl4m and cfg.lam_m_pl4m != 0:
                        pl = self._pl4m_loss(G, D, x, prob1, draws,
                                             painter_z) \
                            * cfg.lam_m_pl4m
                        total = total + pl
                        metrics["m_pl4m"] = pl
                    if cfg.m_use_minent and cfg.ent_main != 0:
                        ml = L.minent_loss(
                            prob, version=2 if cfg.m_use_minent_var else 1,
                            lambda_var=cfg.ent_var) * cfg.ent_main
                        total = total + ml
                        metrics["m_minent"] = ml
            if cfg.m_use_advent:
                dp = None
                if cfg.m_use_dada and d_pred is not None:
                    dp = L.upcast(_detach(d_pred))
                    dp = (spatial.resize(dp, (x.h, x.w), "nearest")
                          if isinstance(dp, Rows)
                          else resize(dp, x.shape[-2:], "nearest"))
                if for_ == "D":
                    label = cfg.label_s if domain == "s" else cfg.label_r
                    pr = _detach(prob)
                else:
                    label, pr = cfg.label_s, prob
                if (for_ == "D" or domain == "r") and cfg.adv_main != 0:
                    al = L.advent_loss(pr, label, disc(D.disc_m),
                                       cfg.m_gan_type, dp) * cfg.adv_main
                    total = total + al
                    metrics[f"m_advent_{for_}_{domain}"] = al
                    if for_ == "D" and cfg.m_gan_type == "WGAN_gp":
                        gp_inputs["m"] = _detach(prob)
        return total, metrics

    def _gradient_penalty(self, D, domain: str, gp_inputs, metrics):
        """The WGAN-GP terms of one domain of the D step, s then m, each
        weighted by ``lambdas.advent.WGAN_gp``, on the read-only ADVENT D;
        the unweighted penalties go into ``metrics``."""
        total = 0.0
        for task, disc in (("s", D.disc_s), ("m", D.disc_m)):
            if task in gp_inputs:
                gp = L.wgan_gp(disc, gp_inputs[task])
                total = total + gp * self.cfg.wgan_gp_lambda
                metrics[f"{task}_gp_{domain}"] = gp
        return total

    def _pl4m_loss(self, G, D, x, m, draws: Draws,
                   z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The painter's GAN loss for the masker (reference
        trainer.py:1618-1651): ``G.paint(m, x, frozen=True)`` (eval
        semantics, parameters detached; in bf16 where x is) through the
        read-only painter D(s), the gradient reaching only ``m``."""
        with self._autocast(x, x.dtype == torch.bfloat16):
            fake = G.paint(m, x, z=z, frozen=True)
        if self.cfg.p_use_local:
            # the painter's own dtype into p_global, as JAX feeds it
            with self._autocast(fake, fake.dtype == torch.bfloat16):
                fdg = D.disc_p_global(fake)
            fdl = D.disc_p_local(each(torch.mul, L.upcast(fake), m))
            return (self._p_gan_loss(fdg, True, draws, False)
                    + self._p_gan_loss(fdl, True, draws, False))
        _, fake_d = divide_pred(D.disc_p(_real_fake(m, L.upcast(x),
                                                    L.upcast(fake))))
        return self._p_gan_loss(fake_d, True, draws, for_discriminator=False)

    def _paint(self, G, batch, update_sn: bool, bf16: bool,
               z: Optional[torch.Tensor] = None):
        """(x, m, fake) in f32 (float64 kept); the painter runs in bf16
        under ``bf16``, on ``z`` where it takes one."""
        x, m = (each(lambda t: t.to(torch.bfloat16), batch[k]) if bf16
                else L.upcast(batch[k]) for k in ("x", "m"))
        with self._autocast(x, bf16):
            fake = G.paint(m, x, update_sn=update_sn, z=z)
        return L.upcast(x), L.upcast(m), L.upcast(fake)

    def _augment(self, fake, x, aug: Optional[AugDraws]):
        """DiffAugment of (fake, x) on the step's draws, where it is on."""
        if self.diff_aug is None:
            return fake, x
        return self.diff_aug(fake, aug[0]), self.diff_aug(x, aug[1])

    def _painter_losses(self, G, D, batch, draws: Draws, update_sn: bool,
                        bf16: Optional[bool] = None,
                        z: Optional[torch.Tensor] = None,
                        aug: Optional[AugDraws] = None):
        """Painter losses of the G step on the rf domain. Returns
        ``(total, metrics)``."""
        cfg = self.cfg
        x, m, fake = self._paint(G, batch, update_sn,
                                 cfg.bf16 if bf16 is None else bf16, z)
        metrics: Dict[str, torch.Tensor] = {}
        total = 0.0
        if cfg.use_vgg and cfg.lam_p_vgg != 0 and self.vgg is not None:
            masked = [L.vgg_preprocess(each(torch.mul, t, m))
                      for t in (fake, x)]
            vl = L.vgg_loss(self.vgg, *masked) * cfg.lam_p_vgg
            total = total + vl
            metrics["p_vgg"] = vl
        if cfg.lam_p_tv != 0:
            tl = L.tv_loss(each(torch.mul, fake, m)) * cfg.lam_p_tv
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

        fake, x = self._augment(fake, x, aug)
        if cfg.p_use_local:
            # JAX's order of D calls: fake global, fake local, real global
            fake_d = D.disc_p_global(fake, update_sn=update_sn)
            fake_l = D.disc_p_local(each(torch.mul, fake, m),
                                    update_sn=update_sn)
            real_d = D.disc_p_global(x, update_sn=update_sn)
            gl = (self._p_gan_loss(fake_d, True, draws, False)
                  + self._p_gan_loss(fake_l, True, draws, False)) \
                * cfg.lam_p_gan
        else:
            real_d, fake_d = divide_pred(D.disc_p(_real_fake(m, x, fake),
                                                  update_sn=update_sn))
            gl = self._p_gan_loss(fake_d, True, draws, for_discriminator=False)
        total = total + gl
        metrics["p_gan"] = gl
        if cfg.lam_p_featmatch != 0:
            fl = L.feat_match_loss(real_d, fake_d) * cfg.lam_p_featmatch
            total = total + fl
            metrics["p_featmatch"] = fl
        return total, metrics

    def _painter_d_loss(self, G, D, batch, draws: Draws,
                        z: Optional[torch.Tensor] = None,
                        aug: Optional[AugDraws] = None) -> torch.Tensor:
        """The painter D's loss of the D step on the rf domain: G paints
        without a gradient (its statistics and u/v advance), then the D(s)
        on the real and painted images."""
        with torch.no_grad():
            x, m, fake = self._paint(G, batch, True, self.cfg.bf16, z)
        fake, x = self._augment(fake, x, aug)
        gan = self._p_gan_loss
        if self.cfg.p_use_local:
            # JAX's order: fake global, real global, fake local, real local
            fdg = D.disc_p_global(fake, update_sn=True)
            rdg = D.disc_p_global(x, update_sn=True)
            fdl = D.disc_p_local(each(torch.mul, fake, m), update_sn=True)
            rdl = D.disc_p_local(each(torch.mul, x, m), update_sn=True)
            return (gan(fdg, False, draws, True) + gan(rdg, True, draws, True)
                    + gan(fdl, False, draws, True)
                    + gan(rdl, True, draws, True))
        real_d, fake_d = divide_pred(D.disc_p(_real_fake(m, x, fake),
                                              update_sn=True))
        return gan(fake_d, False, draws, True) + gan(real_d, True, draws, True)

    # ------------------------------------------------------------------
    # the steps
    # ------------------------------------------------------------------
    def _rows(self, micro: List[Batch], devices) -> List[Batch]:
        """The micro-batches, each split by rows over ``devices`` where
        there are several."""
        if devices is None or len(devices) < 2:
            return micro
        return [shard_rows(mb, devices) for mb in micro]

    @distributed.sharded_batch()
    def g_step(self, state: TrainState, batch: Batch, lr_scale: float = 1.0,
               pseudo_scale: float = 1.0, draws: Optional[Draws] = None,
               z: Optional[torch.Tensor] = None,
               aug: Optional[AugDraws] = None, devices=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """update_G: the masker losses over r and s, then the painter's over
        rf (each per-domain function rematerialized under ``tpu.remat``),
        averaged over ``train.grad_accumulation`` micro-batches; one
        optimizer call over G's parameters (on the gradients summed over
        the ranks of a data-parallel step). ``devices``: the row shards'
        devices of a row-sharded step."""
        cfg = self.cfg
        draws = self.draw(state) if draws is None else draws
        micro = split_micro(batch, self.grad_accumulation)
        z = self.painter_z(state, micro[0], z)
        aug = self.aug_draws(state, micro[0], aug)
        micro = self._rows(micro, devices)
        G, D = state.G, state.D

        def loss_fn(mb):
            total = 0.0
            metrics: Dict[str, torch.Tensor] = {}
            for domain in ("r", "s"):
                if domain in mb and any(t in cfg.tasks for t in "msd"):
                    dl, dm = self._remat(
                        self.remat, self._masker_losses, G, D, mb[domain],
                        domain, "G", draws, True, pseudo_scale=pseudo_scale,
                        painter_z=z)
                    total = total + dl
                    metrics.update(dm)
            if "p" in cfg.tasks and "rf" in mb:
                pl, pm = self._remat(self.remat, self._painter_losses, G, D,
                                     mb["rf"], draws, True, z=z, aug=aug)
                total = total + pl
                metrics.update(pm)
            metrics["g_total"] = total
            return total, metrics

        names, params = _named(G)
        # D stays frozen through the backward too: a rematerialized forward
        # runs inside it
        with frozen(D):
            total, metrics, grads = self._accumulate(
                micro, loss_fn, params, state_buffers(G, D))
        grads = distributed.all_reduce_grads(grads)
        metrics = distributed.all_reduce_metrics(metrics)
        scales = (build_lr_scales(names, self.g_lr_rules)
                  if self.g_lr_rules else None)
        state.g_opt = self.g_opt_step(grads, state.g_opt, params,
                                      self.g_lr * lr_scale,
                                      state.step % 2 == 0, scales)
        return state, {k: v.detach() for k, v in metrics.items()}

    @distributed.sharded_batch()
    def d_step(self, state: TrainState, batch: Batch, lr_scale: float = 1.0,
               draws: Optional[Draws] = None,
               z: Optional[torch.Tensor] = None,
               aug: Optional[AugDraws] = None, devices=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """update_D: the painter D on rf and the ADVENT Ds on r and s, in
        the batch's order (each per-domain function rematerialized under
        ``tpu.remat_d``), averaged over ``train.grad_accumulation``
        micro-batches; one optimizer call over D's parameters, WGAN
        clipping of the ADVENT Ds, then the global step advances (on the
        gradients summed over the ranks of a data-parallel step).
        ``devices``: the row shards' devices of a row-sharded step."""
        cfg = self.cfg
        draws = self.draw(state) if draws is None else draws
        micro = split_micro(batch, self.grad_accumulation)
        z = self.painter_z(state, micro[0], z)
        aug = self.aug_draws(state, micro[0], aug)
        micro = self._rows(micro, devices)
        G, D = state.G, state.D

        def loss_fn(mb):
            total = 0.0
            metrics: Dict[str, torch.Tensor] = {}
            for domain, dbatch in mb.items():
                if domain == "rf" and "p" in cfg.tasks:
                    dl = self._remat(self.remat_d, self._painter_d_loss, G, D,
                                     dbatch, draws, z=z, aug=aug)
                    total = total + dl
                    metrics["D_p_gan"] = dl
                elif domain in ("r", "s"):
                    gp_inputs: Dict[str, torch.Tensor] = {}
                    dl, dm = self._remat(self.remat_d, self._masker_losses,
                                         G, D, dbatch, domain, "D", draws,
                                         True, gp_inputs=gp_inputs)
                    dl = dl + self._gradient_penalty(D, domain, gp_inputs, dm)
                    total = total + dl * cfg.adv_main
                    metrics.update(dm)
            metrics["d_total"] = torch.as_tensor(total)
            return total, metrics

        names, params = _named(D)
        # no discriminator (no task has a GAN loss): no update
        total, metrics, grads = self._accumulate(micro, loss_fn, params,
                                                 state_buffers(G, D))
        grads = distributed.all_reduce_grads(grads)
        metrics = distributed.all_reduce_metrics(metrics)
        if params:
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
        return state, {k: v.detach() for k, v in metrics.items()}

    def train_step(self, state: TrainState, batch: Batch,
                   g_lr_scale: float = 1.0, d_lr_scale: float = 1.0,
                   pseudo_scale: float = 1.0, draws=(None, None),
                   aug=(None, None), devices=None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """``g_step`` then ``d_step``; ``draws`` and ``aug``: (G's, D's) or
        None each; ``devices``: the row shards' devices."""
        state, gm = self.g_step(state, batch, g_lr_scale, pseudo_scale,
                                draws[0], aug=aug[0], devices=devices)
        state, dm = self.d_step(state, batch, d_lr_scale, draws[1],
                                aug=aug[1], devices=devices)
        return state, {**gm, **dm}

    @torch.no_grad()
    def eval_losses(self, state: TrainState, batch: Batch,
                    pseudo_scale: float = 1.0,
                    draws: Optional[Draws] = None,
                    z: Optional[torch.Tensor] = None,
                    aug: Optional[AugDraws] = None
                    ) -> Dict[str, torch.Tensor]:
        """Validation G losses with G and D in eval mode (baked spectral
        kernels, packed SPADEs, running statistics): the masker in f32, the
        painter in ``train.bf16``'s dtype (its SPADEs on the bf16 packs
        then), as JAX's ``eval_losses``; fixed draws, z and diff-aug draws
        (seed 0 unless given); the models go back to train mode."""
        fixed = TrainState(state.G, None, {}, {})
        draws = self.draw(fixed) if draws is None else draws
        z = self.painter_z(fixed, batch, z)
        aug = self.aug_draws(fixed, batch, aug)
        G, D = state.G.eval(), state.D.eval()
        metrics: Dict[str, torch.Tensor] = {}
        total = 0.0
        try:
            for domain in ("r", "s"):
                if domain in batch and any(t in self.cfg.tasks for t in "msd"):
                    dl, dm = self._masker_losses(
                        G, D, batch[domain], domain, "G", draws, False,
                        eval_mode=True, pseudo_scale=pseudo_scale,
                        painter_z=z)
                    total = total + dl
                    metrics.update({f"val_{k}": v for k, v in dm.items()})
            if "p" in self.cfg.tasks and "rf" in batch:
                pl, pm = self._painter_losses(G, D, batch["rf"], draws, False,
                                              z=z, aug=aug)
                total = total + pl
                metrics.update({f"val_{k}": v for k, v in pm.items()})
        finally:
            G.train()
            D.train()
        metrics["val_g_total"] = total
        return metrics
