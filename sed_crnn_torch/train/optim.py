"""Optimization: Adam, global-norm clipping and a ReduceLROnPlateau schedule
as plain tensor functions over ``{name: tensor}`` dictionaries.

Counterpart of the JAX package's `train/optim.py`, with its formula and its
order (not `torch.optim.Adam`, whose update is arranged differently): clip
by global norm first, then add the L2 term ``weight_decay * p`` into the
gradient, then the moments, bias corrections ``1 - b^t`` in float32, and
``p - lr * mhat / (sqrt(vhat) + eps)`` with ``lr = learning_rate *
lr_scale``. `AdamState` keeps ``step``/``mu``/``nu``, which
`models/convert.py` writes in the JAX checkpoint layout.

`Adam.update_stacked` is the step of S independent models whose every
tensor holds the seeds one after another (`models/stacked.py`): the global
norm is clipped per seed, and ``lr_scale`` is a float32 (S,) tensor, so that
each seed's ``float32(learning_rate) * lr_scale`` and every elementwise
operation are the ones that seed takes alone.

The plateau schedule is host arithmetic in float32 (the JAX version's
dtype), stepped once per epoch on the validation loss (per seed when
stacked).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: int           # updates taken so far
    mu: Tensors         # first moments, keyed like the parameters
    nu: Tensors         # second moments


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None

    def init(self, params: Tensors) -> AdamState:
        zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return AdamState(step=0, mu=zeros, nu={k: z.clone() for k, z in zeros.items()})

    def update(
        self,
        grads: Tensors,
        state: AdamState,
        params: Tensors,
        lr_scale: float = 1.0,
    ) -> Tuple[Tensors, AdamState]:
        """-> ``(new_params, new_state)``; ``lr_scale`` multiplies the base
        learning rate (the plateau schedule drives it)."""
        if self.grad_clip_norm is not None:
            grads = clip_by_global_norm(grads, self.grad_clip_norm)
        lr = float(np.float32(self.learning_rate) * np.float32(lr_scale))
        return self._step(grads, state, params, lr)

    def update_stacked(
        self,
        grads: Tensors,
        state: AdamState,
        params: Tensors,
        lr_scale: torch.Tensor,
    ) -> Tuple[Tensors, AdamState]:
        """`update` for S stacked models, ``lr_scale`` a float32 (S,) tensor on
        the parameters' device; each tensor's first ``numel / S`` elements
        belong to seed 0, and so on."""
        S = lr_scale.shape[0]
        if self.grad_clip_norm is not None:
            grads = clip_by_global_norm(grads, self.grad_clip_norm, n_seeds=S)
        rows = lambda d: {k: t.reshape(S, -1) for k, t in d.items()}  # noqa: E731
        lr = (torch.tensor(np.float32(self.learning_rate), device=lr_scale.device)
              * lr_scale.float())[:, None]
        new_params, new = self._step(rows(grads), AdamState(state.step, rows(state.mu),
                                                            rows(state.nu)), rows(params), lr)
        back = lambda d: {k: t.view(params[k].shape) for k, t in d.items()}  # noqa: E731
        return back(new_params), AdamState(new.step, back(new.mu), back(new.nu))

    def _step(self, grads: Tensors, state: AdamState, params: Tensors,
              lr) -> Tuple[Tensors, AdamState]:
        """Decay, moments, bias corrections and the update, with ``lr`` the
        float32 learning rate (a float, or a tensor broadcasting against every
        leaf)."""
        if self.weight_decay:
            grads = {k: g + self.weight_decay * params[k].to(g.dtype) for k, g in grads.items()}
        step = state.step + 1
        f32 = np.float32
        # The scalars in float32, as the JAX version computes them on device.
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(step))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(step))
        mu = {k: self.b1 * state.mu[k] + (1 - self.b1) * g for k, g in grads.items()}
        nu = {k: self.b2 * state.nu[k] + (1 - self.b2) * g * g for k, g in grads.items()}
        new_params = {
            k: (p.float() - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)).to(p.dtype)
            for k, p in params.items()
        }
        return new_params, AdamState(step=step, mu=mu, nu=nu)


def global_norm(tensors: Tensors, n_seeds: Optional[int] = None) -> torch.Tensor:
    """The norm over all tensors; with ``n_seeds`` S, one per seed of stacked
    tensors, an (S,) tensor."""
    if n_seeds is None:
        return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors.values()))
    return torch.sqrt(sum(torch.sum(t.float().reshape(n_seeds, -1) ** 2, dim=1)
                          for t in tensors.values()))


def clip_by_global_norm(tensors: Tensors, max_norm: float,
                        n_seeds: Optional[int] = None) -> Tensors:
    """Scale the tensors down to a global norm of at most ``max_norm``; with
    ``n_seeds``, each seed of stacked tensors by its own norm."""
    norm = global_norm(tensors, n_seeds)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    if n_seeds is None:
        return {k: t * scale.to(t.dtype) for k, t in tensors.items()}
    return {k: (t.reshape(n_seeds, -1) * scale[:, None].to(t.dtype)).view(t.shape)
            for k, t in tensors.items()}


class PlateauState(NamedTuple):
    best: float
    num_bad: int
    lr_scale: float


@dataclasses.dataclass(frozen=True)
class ReduceLROnPlateau:
    """Epoch-level schedule (torch semantics, mode 'min', relative threshold,
    no cooldown), in float32 like the JAX version."""

    factor: float = 0.5
    patience: int = 10
    threshold: float = 1e-4
    min_scale: float = 0.0

    def init(self) -> PlateauState:
        return PlateauState(best=float("inf"), num_bad=0, lr_scale=1.0)

    def step(self, state: PlateauState, metric) -> PlateauState:
        f32 = np.float32
        metric, best, lr = f32(metric), f32(state.best), f32(state.lr_scale)
        improved = bool(metric < best * f32(1.0 - self.threshold))
        drop = not improved and state.num_bad + 1 > self.patience
        return PlateauState(
            best=float(metric if improved else best),
            num_bad=0 if (improved or drop) else state.num_bad + 1,
            lr_scale=float(max(lr * f32(self.factor), f32(self.min_scale)) if drop else lr),
        )
