"""Conv + batch-norm folding, the port's counterpart of the JAX package's
``utils/bn_fold.py`` (after reference climategan/bn_fusion.py).

``fold_conv_bn`` is the pure rewrite: (kernel', bias') such that
``conv(x, kernel') + bias' == BN(conv(x, kernel) + bias)`` in eval mode.
``fold_generator_bns(G)`` applies the JAX package's variables rewrite to
every ``Conv2dBlock`` of an eval-mode model whose norm is a batch norm (the
DADA depth decoder's ``enc4_*`` and its upsampling conv, the base depth
decoder's blocks, a SPADE mask decoder's ``spectral_batch`` blocks): the
conv's kernel and bias are scaled by ``alpha = gamma / sqrt(var + eps)``,
and the norm keeps the shift: its weight becomes ``sqrt(1 + eps)``, its
bias ``beta - alpha * mean``, its running statistics zero mean and unit
variance. The folded model's state dict is then
``state_dict_from_jax(fold_generator_bns(variables))`` of the JAX
package's on the same weights, for every folded block.

Two differences from the JAX rewrite, both where JAX's is not exact:

  * JAX resets the running statistics of every batch norm of the tree,
    also those that are not in a ``Conv2dBlock`` and so not folded (the
    ResNet encoder's, the DeepLab v3 decoder's); here they stay, so the
    folded forward equals the unfolded one with trained statistics too.
  * A spectral conv runs in eval mode on its baked ``weight_bar / sigma``
    (``norms.SNConv``): the fold scales that baked weight (what JAX's
    rewrite gives after ``bake_spectral_norm``), and leaves ``weight_bar``
    and u, v as they are. A later ``eval()``, state-dict load or
    ``bake()`` re-derives the baked weight from ``weight_bar``, so fold
    last, on the model as it will serve.

A library function, as in JAX: no entry point calls it, and
``apply_events --fuse`` stays a no-op (ROADMAP C, "Choices").
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from climategan_torch.models.blocks import Conv2dBlock
from climategan_torch.models.norms import BatchNorm2d


def _alpha(scale: Optional[torch.Tensor], var: torch.Tensor,
           eps: float) -> torch.Tensor:
    gamma = torch.ones_like(var) if scale is None else scale
    return gamma * torch.rsqrt(var + eps)


def fold_conv_bn(
    weight: torch.Tensor,             # OIHW
    bias: Optional[torch.Tensor],     # (O,) or None
    scale: Optional[torch.Tensor],    # BN gamma (O,) or None
    bn_bias: Optional[torch.Tensor],  # BN beta (O,) or None
    mean: torch.Tensor,               # running mean (O,)
    var: torch.Tensor,                # running var (O,)
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight', bias') such that ``conv(x, weight') + bias' ==
    BN(conv(x, weight) + bias)`` (reference bn_fusion.py:121-132)."""
    beta = torch.zeros_like(mean) if bn_bias is None else bn_bias
    alpha = _alpha(scale, var, eps)
    b = torch.zeros_like(mean) if bias is None else bias
    return weight * alpha[:, None, None, None], (b - mean) * alpha + beta


@torch.no_grad()
def fold_block(block: Conv2dBlock) -> None:
    """The JAX rewrite (bn_fold.py ``_fold_node``) on one eval-mode
    ``Conv2dBlock`` with a batch norm, in place."""
    bn, conv = block.norm, block.conv
    alpha = _alpha(bn.weight, bn.running_var, bn.eps)
    # a spectral conv's eval kernel is its baked weight, its bias the
    # wrapped module's
    bias = conv.module.bias if conv.spectral else conv.bias
    conv.weight.mul_(alpha[:, None, None, None].to(conv.weight))
    if bias is not None:
        bias.mul_(alpha.to(bias))
    bn.bias.copy_(bn.bias - alpha * bn.running_mean)
    bn.weight.fill_(math.sqrt(1.0 + bn.eps))
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)


def folded_blocks(model: nn.Module):
    """The ``Conv2dBlock``s of ``model`` that ``fold_generator_bns``
    folds: those whose norm is a batch norm, by module name."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, Conv2dBlock) and isinstance(m.norm, BatchNorm2d)]


def fold_generator_bns(G: nn.Module) -> nn.Module:
    """Fold every conv + batch norm ``Conv2dBlock`` of an eval-mode model
    in place (see the module docstring); returns the model."""
    blocks = folded_blocks(G)
    training = [name for name, m in blocks if m.training]
    if training:
        raise ValueError(f"fold_generator_bns folds eval-mode batch norms; "
                         f"{training[0]} is in train mode (call G.eval() "
                         f"first)")
    for _, block in blocks:
        fold_block(block)
    return G
