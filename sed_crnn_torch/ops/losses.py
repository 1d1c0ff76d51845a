"""Training objectives, numerically stable.

Counterpart of the JAX package's `ops/losses.py`:

* ``bce_with_logits``: binary cross-entropy on logits in the stable form
  ``max(x, 0) - x t + log(1 + exp(-|x|))``;
* ``focal_bce``: the reference's focal loss through the sigmoid, with its
  ``1e-12`` epsilon: ``-alpha (1 - pt)^gamma log(pt + eps)``, ``pt`` flipped
  by the target.

Both compute in float32 and reduce by ``"mean"``, ``"sum"`` or ``"none"``
(the full-split sweep takes elementwise losses).
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, reduction: str = "mean"):
    x = logits.float()
    t = targets.float()
    loss = torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    return _reduce(loss, reduction)


def focal_bce(
    logits: torch.Tensor,
    targets: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
    eps: float = 1e-12,
    reduction: str = "mean",
):
    pt = torch.sigmoid(logits.float())
    t = targets.float()
    pt = torch.where(t == 1.0, pt, 1.0 - pt)
    loss = -alpha * (1.0 - pt) ** gamma * torch.log(pt + eps)
    return _reduce(loss, reduction)


def _reduce(loss: torch.Tensor, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def make_loss(name: str, alpha: float = 0.25, gamma: float = 2.0):
    """-> ``fn(logits, targets, reduction="mean")``."""
    if name == "bce":
        return bce_with_logits
    if name == "focal":
        return lambda logits, targets, reduction="mean": focal_bce(
            logits, targets, alpha, gamma, reduction=reduction
        )
    raise ValueError(f"unknown loss {name!r}; expected 'bce' or 'focal'")
