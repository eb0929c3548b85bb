"""Optimizers, learning-rate groups and schedules, with the JAX package's
formulas (its ``optim.py``, a re-design of the reference ``optim.py``).

Each step is a plain function over a list of parameters and their
gradients (``None`` reads as zero, as an unused leaf's gradient is in JAX),
under ``torch.no_grad()``. It updates the parameters in place and returns
the new state, a dict of tensors: ``count`` (a CPU int64 scalar), and
per-parameter lists ``mu``, ``nu`` and, for ExtraAdam, ``saved`` (buffers
made once by ``init_extra_adam`` and written in place by every
extrapolation, so the state a call was given is not kept).

  * ExtraAdam: even global steps extrapolate, odd ones update the
    parameters saved before the extrapolation; both advance the moments.
    The bias correction is ``sqrt(1 - b2^t) / (1 - b1^t)`` on the step and
    eps is added to ``sqrt(v)`` after it, so ``torch.optim.Adam`` (eps
    inside the correction) is not the same function.
  * Adam, RMSprop (torch's defaults, no momentum), RAdam (rectified) and
    NovoGrad (per-tensor second moment), as the reference selects them by
    name.
  * ``lr_scales`` multiplies the learning rate per parameter (the per-task
    groups, ``build_lr_scales``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

State = Dict[str, object]
Params = Sequence[torch.Tensor]


def _grads(grads, params) -> List[torch.Tensor]:
    return [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
            for g, p in zip(grads, params)]


def _scales(lr_scales, params) -> List[float]:
    return [1.0] * len(params) if lr_scales is None else [float(s) for s in lr_scales]


def init_adam(params: Params) -> State:
    return {"count": torch.zeros((), dtype=torch.int64),
            "mu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params]}


def init_extra_adam(params: Params) -> State:
    state = init_adam(params)
    state["saved"] = [p.detach().clone() for p in params]
    return state


def init_novograd(params: Params) -> State:
    state = init_adam(params)
    state["nu"] = [torch.zeros((), dtype=torch.float32, device=p.device)
                   for p in params]
    return state


def _moments(g, state, b1, b2):
    """m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g^2, for every
    tensor, as new lists."""
    mu = torch._foreach_mul(state["mu"], b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
    nu = torch._foreach_mul(state["nu"], b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                               1.0 - b2))
    return mu, nu


def _adam_delta(mu, nu, lr, scales, step_scale, eps):
    """-(lr * scale * step_scale) * m / (sqrt(v) + eps), per tensor."""
    den = torch._foreach_sqrt(nu)
    torch._foreach_add_(den, eps)
    delta = torch._foreach_div(mu, den)
    torch._foreach_mul_(delta, [-(lr * s * step_scale) for s in scales])
    return delta


@torch.no_grad()
def extra_adam_step(grads, state: State, params: Params, lr: float,
                    extrapolate: bool, lr_scales=None, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8) -> State:
    """One ExtraAdam call: an extrapolation from the current parameters
    (which it saves), or an update of the saved ones."""
    count = int(state["count"]) + 1
    step_scale = math.sqrt(1.0 - b2 ** count) / (1.0 - b1 ** count)
    g = _grads(grads, params)
    mu, nu = _moments(g, state, b1, b2)
    delta = _adam_delta(mu, nu, lr, _scales(lr_scales, params), step_scale,
                        eps)
    params, saved = list(params), state["saved"]
    if extrapolate:  # save the current parameters into the saved buffers
        torch._foreach_copy_(saved, params)
    else:
        torch._foreach_copy_(params, saved)
    torch._foreach_add_(params, delta)
    return {"count": torch.tensor(count), "mu": mu, "nu": nu, "saved": saved}


@torch.no_grad()
def adam_step(grads, state: State, params: Params, lr: float, lr_scales=None,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> State:
    count = int(state["count"]) + 1
    step_scale = math.sqrt(1.0 - b2 ** count) / (1.0 - b1 ** count)
    g = _grads(grads, params)
    mu, nu = _moments(g, state, b1, b2)
    torch._foreach_add_(list(params), _adam_delta(
        mu, nu, lr, _scales(lr_scales, params), step_scale, eps))
    return {"count": torch.tensor(count), "mu": mu, "nu": nu}


@torch.no_grad()
def rmsprop_step(grads, state: State, params: Params, lr: float,
                 lr_scales=None, alpha: float = 0.99,
                 eps: float = 1e-8) -> State:
    """torch.optim.RMSprop's defaults (no momentum, no centering):
    v = alpha v + (1 - alpha) g^2; p -= lr g / (sqrt(v) + eps). ``mu``
    is carried unused."""
    nu = []
    for g, v, p, s in zip(_grads(grads, params), state["nu"], params,
                          _scales(lr_scales, params)):
        v = alpha * v + (1.0 - alpha) * g * g
        p.sub_((lr * s) * g / (torch.sqrt(v) + eps))
        nu.append(v)
    return {"count": state["count"] + 1, "mu": state["mu"], "nu": nu}


@torch.no_grad()
def radam_step(grads, state: State, params: Params, lr: float, lr_scales=None,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> State:
    """RAdam: the rectified adaptive step while the SMA length exceeds 4,
    the bias-corrected momentum step before."""
    count = int(state["count"]) + 1
    t = float(count)
    b2t = b2 ** t
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    rho_t = rho_inf - 2.0 * t * b2t / (1.0 - b2t)
    rect = math.sqrt(max((rho_t - 4.0) * (rho_t - 2.0) * rho_inf, 0.0)
                     / max((rho_inf - 4.0) * (rho_inf - 2.0) * rho_t, 1e-12))
    bc1 = 1.0 - b1 ** t
    mu, nu = [], []
    for g, m, v, p, s in zip(_grads(grads, params), state["mu"], state["nu"],
                             params, _scales(lr_scales, params)):
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        if rho_t > 4.0:
            upd = (rect * math.sqrt(1.0 - b2t) / bc1) * m / (torch.sqrt(v) + eps)
        else:
            upd = (1.0 / bc1) * m
        p.sub_((lr * s) * upd)
        mu.append(m)
        nu.append(v)
    return {"count": torch.tensor(count), "mu": mu, "nu": nu}


@torch.no_grad()
def novograd_step(grads, state: State, params: Params, lr: float,
                  lr_scales=None, b1: float = 0.9, b2: float = 0.0,
                  eps: float = 1e-8) -> State:
    """NovoGrad with the reference's betas (beta1, 0): a per-tensor scalar
    second moment, a layer-normalized first moment, no gradient
    averaging."""
    first = int(state["count"]) == 0
    mu, nu = [], []
    for g, m, v, p, s in zip(_grads(grads, params), state["mu"], state["nu"],
                             params, _scales(lr_scales, params)):
        g2 = torch.sum(g * g)
        v = g2 if first else b2 * v + (1.0 - b2) * g2
        gn = g / (torch.sqrt(v) + eps)
        m = gn if first else b1 * m + gn
        p.sub_((lr * s) * m)
        mu.append(m)
        nu.append(v)
    return {"count": state["count"] + 1, "mu": mu, "nu": nu}


Step = Callable[..., State]


def make_optimizer(name: str, b1: float = 0.9) -> Tuple[Callable, Step]:
    """The reference's selection by ``name.lower()``: extraadam, novograd,
    radam, rmsprop, anything else Adam. Returns ``(init_fn, step_fn)``;
    ``step_fn(grads, state, params, lr, extrapolate, lr_scales)`` has one
    signature for all (only ExtraAdam reads ``extrapolate``)."""
    n = (name or "extraadam").lower()
    if n == "extraadam":
        def step(grads, state, params, lr, extrapolate, lr_scales=None):
            return extra_adam_step(grads, state, params, lr, extrapolate,
                                   lr_scales, b1=b1)
        return init_extra_adam, step
    if n == "novograd":
        def step(grads, state, params, lr, extrapolate, lr_scales=None):
            return novograd_step(grads, state, params, lr, lr_scales, b1=b1)
        return init_novograd, step
    if n == "radam":
        def step(grads, state, params, lr, extrapolate, lr_scales=None):
            return radam_step(grads, state, params, lr, lr_scales, b1=b1)
        return init_adam, step
    if n == "rmsprop":
        def step(grads, state, params, lr, extrapolate, lr_scales=None):
            return rmsprop_step(grads, state, params, lr, lr_scales)
        return init_adam, step

    def step(grads, state, params, lr, extrapolate, lr_scales=None):
        return adam_step(grads, state, params, lr, lr_scales, b1=b1)
    return init_adam, step


# --------------------------------------------------------------------------
# learning-rate schedules (functions of the epoch) and groups
# --------------------------------------------------------------------------


def make_lr_schedule(opt_conf) -> Callable[[int], float]:
    policy = opt_conf.get("lr_policy")
    gamma = float(opt_conf.get("lr_gamma", 0.5))
    step_size = int(opt_conf.get("lr_step_size", 5) or 5)
    milestones = opt_conf.get("lr_milestones")

    if policy in (None, "constant", {}):
        return lambda epoch: 1.0
    if policy == "step":
        return lambda epoch: gamma ** (int(epoch) // step_size)
    if policy == "multi_step":
        if isinstance(milestones, int):
            ms = list(range(int(milestones), 1000, step_size))
        else:
            ms = [int(m) for m in (milestones or [])]
        return lambda epoch: gamma ** sum(1 for m in ms if int(epoch) >= m)
    raise NotImplementedError(f"lr policy {policy}")


def build_lr_scales(names: Sequence[str], rules: Dict[str, float],
                    default: float = 1.0) -> List[float]:
    """The lr multiplier of each parameter name: that of the first rule
    whose module prefix (a dotted path) starts the name, else
    ``default``."""
    scales = []
    for name in names:
        scale = default
        for prefix, s in rules.items():
            if name == prefix or name.startswith(prefix + "."):
                scale = s
                break
        scales.append(scale)
    return scales


@torch.no_grad()
def clamp_params(params: Params, lo: float, hi: float) -> None:
    """WGAN weight clipping, in place."""
    for p in params:
        p.clamp_(lo, hi)
