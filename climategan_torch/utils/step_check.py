"""Holding the models after one training step to a reference's, leaf by
leaf: the port's card step to its CPU step (``chip_smoke.py`` phase 7, the
card tests) and the port's CPU step to the JAX package's (the CPU tests).

``hold_state`` compares a module with a reference state dict. The
reference's first moments (``(1 - b1) g`` after ExtraAdam's first call, so
its gradients) sort the leaves and values:

  * a **noise leaf** is one whose largest reference first moment is at or
    below ``NOISE_FLOOR`` times the model's largest. Its gradient is f32
    rounding: a bias in front of an instance or batch norm has a true
    gradient of zero, and an instance norm over one pixel divides by
    sqrt(1e-5), which amplifies that rounding 316x;
  * in any other leaf, a **noise value** is one whose reference first
    moment is nonzero and at most ``VALUE_FLOOR`` times its leaf's
    largest. An exact zero (a dilated tap that reads only padding) is held
    like any other value.

The bars:

  * batch-norm running statistics and spectral u/v within 1e-5;
  * the first moments of every leaf that is not a noise leaf within 1e-3
    of the leaf's largest reference value. A leaf whose gradient has the
    wrong sign, or none, fails here;
  * every parameter value that is not noise within 1e-6, and at least
    99.9% of each model's values within 1e-6;
  * noise values within 2 lr. That bar cannot fail (ExtraAdam's first call
    moves a value by at most lr, and by about lr * sign(g) for any |g| above
    about 3e-7, so a gradient of random sign may land 2 lr away); such
    values are counted in the summary, not checked.

Measured at ``tiny_opts(32)`` against the JAX package (the port's CPU
train step): the largest noise leaf reached 1.5e-5 of G's largest
gradient (``painter.fc.bias``) and the smallest other leaf 2.4e-5; other
leaves' first moments agreed within 6.1e-5 of their largest value; every
value off by more than 1e-6 in them had a first moment below 8.2e-5 of its
leaf's largest. With these floors 265k of G's 29.0M values and 364k of
D's 5.6M are noise.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn as nn

from climategan_torch.train_step import STATE_BUFFERS

STATS = STATE_BUFFERS
NOISE_FLOOR = 3e-5
VALUE_FLOOR = 3e-4

# ``tiny_opts(32)`` of the JAX package's tests, written out as port opts
# overrides (images TINY_SIZE^2, depth and seg targets 32^2): the small
# card-against-CPU step of chip_smoke.py and the card tests. At 64^2 the
# f32 backward is ill-conditioned: two f32 conv implementations (oneDNN on
# and off on the CPU, or the card and the CPU) give the same step gradients
# up to 4.9% of a leaf's largest apart; at 32^2 within 1.8e-5.
TINY_SIZE = 32
TINY_OVERRIDES = {
    "gen": {"deeplabv2": {"nblocks": [1, 1, 1, 1]},
            "p": {"latent_dim": 32, "spade_n_up": 5},
            "m": {"proj_dim": 16, "n_res": 1}},
    "data": {"transforms": [
        {"name": "resize", "ignore": False, "new_size": TINY_SIZE,
         "keep_aspect_ratio": True},
        {"name": "resize", "ignore": False,
         "new_size": {"default": TINY_SIZE, "d": 32, "s": 32}}]},
    "dis": {"p": {"n_layers": 2, "ndf": 16, "num_D": 2}},
    "train": {"bf16": False},
}
# The same sizes without DADA (no product of the seg entropy with the
# depth) and with depth targets at the depth head's own TINY_DP_DEPTH^2: at
# TINY_SIZE^2 the head's map otherwise goes through a bicubic resize whose
# CUDA backward has no deterministic version (atomic adds), so the tiny
# step would differ run to run on a card. The card's data-parallel checks
# (chip_smoke.py phase 11, the card tests) hold this step.
TINY_DP_DEPTH = 8
TINY_DP_OVERRIDES = {
    **TINY_OVERRIDES,
    "gen": {**TINY_OVERRIDES["gen"],
            "s": {"use_dada": False},
            "m": {**TINY_OVERRIDES["gen"]["m"], "use_dada": False}},
    "data": {"transforms": [
        TINY_OVERRIDES["data"]["transforms"][0],
        {"name": "resize", "ignore": False,
         "new_size": {"default": TINY_SIZE, "d": TINY_DP_DEPTH, "s": 32}}]},
}


def first_moments(module: nn.Module, opt_state) -> Dict[str, torch.Tensor]:
    """The optimizer state's first moments by parameter name."""
    return {n: m for (n, _), m in zip(module.named_parameters(),
                                      opt_state["mu"])}


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` in f32 on ``device`` (the held module's), where the bars are
    computed: a reference on another device is copied once a leaf."""
    return t.detach().to(device=device, dtype=torch.float32)


def hold_state(got: nn.Module, want: Mapping[str, torch.Tensor],
               lr: Optional[float] = None,
               got_mu: Optional[Mapping[str, torch.Tensor]] = None,
               want_mu: Optional[Mapping[str, torch.Tensor]] = None,
               stats: bool = True, what: str = "",
               held: Optional[Callable[[str], bool]] = None) -> str:
    """Hold module ``got`` to the reference state dict ``want`` with the
    bars of the module docstring; raises AssertionError naming the leaf.
    ``lr=None``: the parameters must equal the reference's (a step that
    does not update this model). Otherwise ``got_mu`` and ``want_mu`` are
    both sides' first moments by parameter name. ``held``: which parameters
    the first moments and values are held for (default: all); the noise
    floor stays relative to the whole model's largest first moment, and
    the share of values off counts the held ones. Returns a summary."""
    sd = got.state_dict()
    params = dict(got.named_parameters())
    dev = next(iter(sd.values())).device
    if stats:
        for k, v in sd.items():
            if k.rsplit(".", 1)[-1] in STATS:
                err = (_f32(v, dev) - _f32(want[k], dev)).abs().max().item()
                if err > 1e-5:
                    raise AssertionError(f"{what} {k}: {err:.3g} > 1e-5")
    if lr is None:
        for k in params:
            if not torch.equal(_f32(sd[k], dev), _f32(want[k], dev)):
                raise AssertionError(f"{what} {k}: changed by a step that "
                                     "does not update it")
        return f"{what}: parameters unchanged"
    floor = NOISE_FLOOR * max(want_mu[k].detach().abs().max().item()
                              for k in params)
    if held is not None:
        params = {k: v for k, v in params.items() if held(k)}
    off = noise = total = noise_leaves = 0
    worst_noise = 0.0
    for k in params:
        ref_m = _f32(want_mu[k], dev).abs()
        leaf_max = ref_m.max().item()
        d = (_f32(sd[k], dev) - _f32(want[k], dev)).abs()
        if leaf_max <= floor:
            is_noise = torch.ones_like(d, dtype=torch.bool)
            noise_leaves += 1
        else:
            m_err = (_f32(got_mu[k], dev)
                     - _f32(want_mu[k], dev)).abs().max().item()
            if m_err > 1e-3 * leaf_max:
                raise AssertionError(
                    f"{what} {k}: first moment off by {m_err:.3g}, more "
                    f"than 1e-3 of its largest, {leaf_max:.3g}")
            is_noise = (ref_m > 0) & (ref_m <= VALUE_FLOOR * leaf_max)
            held = d[~is_noise]
            if held.max().item() > 1e-6:
                raise AssertionError(
                    f"{what} {k}: {held.max().item():.3g} > 1e-6 where the "
                    "reference gradient is not noise")
        if is_noise.any():
            worst_noise = max(worst_noise, d[is_noise].max().item())
            if worst_noise > 2 * lr:
                raise AssertionError(f"{what} {k}: {worst_noise:.3g} > 2 lr")
        off += int((d > 1e-6).sum())
        noise += int(is_noise.sum())
        total += d.numel()
    share = off / max(total, 1)
    if share > 1e-3:
        raise AssertionError(f"{what}: {100 * share:.3f}% of parameter "
                             "values off by more than 1e-6")
    return (f"{what}: {len(params) - noise_leaves} of {len(params)} leaves' "
            f"first moments within 1e-3; {total - noise} of {total} values "
            f"within 1e-6, {noise} noise values within "
            f"{worst_noise / lr:.3g} lr; {100 * share:.4f}% of values off by "
            "more than 1e-6")
