"""S independent CRNNs of one configuration as one model: the seed axis of
stacked multi-seed training (`train/multiseed.py::run_fold_multiseed`).

The JAX package lifts one model over a leading seed axis with ``jax.vmap``.
PyTorch cannot map over the GRU kernels' ctypes calls or BatchNorm's
in-place buffers, so here the seed axis is explicit, and each layer computes
what S separate layers would:

* the convolutions are one grouped convolution (``groups=S``) over
  ``(B, S*C, H, W)`` activations, seed s owning channels ``[s*C, (s+1)*C)``;
* BatchNorm normalizes each of the S*C channels by its own batch statistics,
  which are exactly the per-seed, per-channel ones;
* pooling and ReLU are elementwise over the channels;
* dropout draws each seed's masks from that seed's generators, with the
  shapes and in the order of a single model's forward;
* the GRU input projections and the dense head are batched products over
  ``(S, B*T, in)``; the recurrence runs kernel B with its seed axis
  (`gru_scan_stack`: one launch per kernel for all seeds and directions).

A bf16 trunk follows `CRNN`: convolution, bias and BatchNorm in float32, one
rounding per block.

Every parameter and buffer has a single model's name (`CRNN.state_dict`'s)
and holds the S seeds' values one after another: ``view(S, *shape)`` gives
each seed's tensor. `StackedCRNN.from_models` stacks S `CRNN`s and
`StackedCRNN.seed` returns one, so checkpoints go through
`models/convert.py` as they are.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sed_crnn_torch.core.config import ModelConfig
from sed_crnn_torch.models.crnn import _ACTIVATIONS, CRNN, CRNNShape
from sed_crnn_torch.nn.layers import BatchNorm2d, Dropout, max_pool2d
from sed_crnn_torch.ops.kernels.gru_scan import GATES, gru_scan_stack

Tensors = Dict[str, torch.Tensor]


class _Conv(nn.Module):
    """S convolutions as one grouped convolution over (B, S*C_in, H, W)."""

    def __init__(self, n_seeds: int, in_ch: int, out_ch: int, kernel):
        super().__init__()
        self.n_seeds = n_seeds
        self.weight = nn.Parameter(torch.zeros(n_seeds * out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(n_seeds * out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return F.conv2d(x, self.weight, self.bias, padding="same", groups=self.n_seeds)
        # as `nn/layers.py` Conv2d: bf16 operands, float32 sums and output
        return F.conv2d(x.float(), self.weight.to(x.dtype).float(), self.bias.float(),
                        padding="same", groups=self.n_seeds)


class _GRU(nn.Module):
    """S GRU directions' weights in the single GRU's layout, seed first."""

    def __init__(self, n_seeds: int, in_dim: int, hidden: int, reset_after: bool):
        super().__init__()
        h3 = 3 * hidden
        self.wi = nn.Parameter(torch.zeros(n_seeds, in_dim, h3))
        self.wh = nn.Parameter(torch.zeros(n_seeds, hidden, h3))
        self.bi = nn.Parameter(torch.zeros(n_seeds, h3))
        self.bh = nn.Parameter(torch.zeros(n_seeds, h3)) if reset_after else None

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, B, T, in) -> (S, B, T, 3H): each seed's ``x @ wi + bi``."""
        S, B, T, d = x.shape
        return (torch.bmm(x.reshape(S, B * T, d), self.wi)
                + self.bi[:, None]).reshape(S, B, T, -1)


class _BiGRU(nn.Module):
    def __init__(self, n_seeds: int, in_dim: int, hidden: int, reset_after: bool,
                 gate_activation: str):
        super().__init__()
        if gate_activation not in GATES:
            raise ValueError(f"unknown gate_activation {gate_activation!r}")
        self.hidden = hidden
        self.reset_after = reset_after
        self.gate_activation = gate_activation
        self.fwd = _GRU(n_seeds, in_dim, hidden, reset_after)
        self.bwd = _GRU(n_seeds, in_dim, hidden, reset_after)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, B, T, in) -> (S, B, T, 2H) from zero initial states."""
        f, b = self.fwd, self.bwd
        zeros = x.new_zeros((x.shape[0], x.shape[1], self.hidden))
        (yf, _), (yb, _) = gru_scan_stack((f.project(x), b.project(x)), (f.wh, b.wh),
                                          (f.bh, b.bh), (zeros, zeros), self.reset_after,
                                          self.gate_activation)
        return torch.cat([yf, yb], dim=-1)


class _Dense(nn.Module):
    def __init__(self, n_seeds: int, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_seeds, out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(n_seeds, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, N, in) -> (S, N, out)."""
        return torch.bmm(x, self.weight.transpose(1, 2)) + self.bias[:, None]


class StackedCRNN(CRNNShape, nn.Module):
    """``n_seeds`` CRNNs of ``cfg`` computed together; see the module notes."""

    def __init__(self, cfg: ModelConfig, n_seeds: int):
        super().__init__()
        if n_seeds < 1:
            raise ValueError(f"need at least one seed, got {n_seeds}")
        self.cfg = cfg
        self.n_seeds = n_seeds
        S, in_ch = n_seeds, cfg.in_channels
        convs, bns = [], []
        for out_ch in cfg.conv_channels:
            convs.append(_Conv(S, in_ch, out_ch, tuple(cfg.kernel_size)))
            bns.append(BatchNorm2d(S * out_ch, cfg.bn_eps, cfg.bn_momentum))
            in_ch = out_ch
        self.conv = nn.ModuleList(convs)
        self.bn = nn.ModuleList(bns)
        self.dropout = Dropout(cfg.dropout)
        reset_after = cfg.name != "sednet"
        grus, in_dim = [], self.flat_dim
        for h in cfg.gru_hidden:
            grus.append(_BiGRU(S, in_dim, h, reset_after, cfg.gru_gate_activation))
            in_dim = 2 * h
        self.gru = nn.ModuleList(grus)
        head = []
        for d in cfg.head_dims:
            head.append(_Dense(S, in_dim, d))
            in_dim = d
        self.head = nn.ModuleList(head)
        # each seed's shape of every entry, keyed like the state dict
        self.seed_shapes = {k: tuple(v.shape) for k, v in CRNN(cfg).state_dict().items()}
        self.eval()

    # ---- seeds in and out ------------------------------------------------
    @classmethod
    def from_models(cls, models: Sequence[CRNN]) -> "StackedCRNN":
        """Stack S CRNNs of one configuration (on the CPU, in eval mode)."""
        stacked = cls(models[0].cfg, len(models))
        sds = [m.state_dict() for m in models]
        stacked.load_state_dict({k: torch.stack([sd[k].detach().cpu() for sd in sds]).reshape(
            v.shape) for k, v in stacked.state_dict().items()})
        return stacked

    def split(self, tensors: Tensors, i: int) -> Tensors:
        """Seed ``i``'s tensors (views) of a dict keyed like the state dict or
        the parameters (Adam's moments)."""
        return {k: t.view(self.n_seeds, *self.seed_shapes[k])[i] for k, t in tensors.items()}

    def seed(self, i: int) -> CRNN:
        """Seed ``i`` as a `CRNN` on this model's device, in eval mode."""
        model = CRNN(self.cfg)
        model.load_state_dict(self.split(self.state_dict(), i))
        return model.to(self.conv[0].weight.device)

    # ---- forward ---------------------------------------------------------
    def _dropout(self, x: torch.Tensor, gens: Sequence[Sequence[torch.Generator]],
                 site: int) -> torch.Tensor:
        """Each seed's channels through `Dropout` with that seed's generator
        of ``site``: the masks a single model draws at that site."""
        if not self.training or self.dropout.rate == 0.0:
            return x
        return torch.cat([self.dropout(xs, g[site])
                          for xs, g in zip(x.chunk(self.n_seeds, dim=1), gens)], dim=1)

    def forward(
        self,
        x: torch.Tensor,
        dropout_generators: Optional[Sequence[Sequence[torch.Generator]]] = None,
    ) -> torch.Tensor:
        """x (S, B, T, F) (or another of `CRNN`'s input layouts behind the seed
        axis) -> logits (S, B, T_out, n_classes), float32.
        ``dropout_generators``: per seed its `n_dropout_sites` generators on
        the input's device, needed in train mode when ``cfg.dropout > 0``."""
        cfg, S = self.cfg, self.n_seeds
        if x.shape[0] != S:
            raise ValueError(f"expected {S} seeds on the leading axis, got {tuple(x.shape)}")
        gens = dropout_generators or [[None] * self.n_dropout_sites] * S
        dtype = getattr(torch, cfg.compute_dtype)
        B = x.shape[1]
        x = self._to_nchw(x.to(dtype).reshape(S * B, *x.shape[2:]))
        _, c, h, w = x.shape
        x = x.reshape(S, B, c, h, w).transpose(0, 1).reshape(B, S * c, h, w)
        for i, (conv, bn, p) in enumerate(zip(self.conv, self.bn, cfg.pool)):
            x = max_pool2d(torch.relu(bn(conv(x)).to(dtype)), (1, p))
            if cfg.dropout_per_block:
                x = self._dropout(x, gens, i)
        if not cfg.dropout_per_block:
            x = self._dropout(x, gens, -1)

        # (B, S*C, H, W) -> (S, B, T, C*F) in the JAX flatten order [B, T, C, F]
        _, sc, h, w = x.shape
        x = x.reshape(B, S, sc // S, h, w)
        x = x.permute(1, 0, 4, 2, 3) if cfg.pool_axis == "time" else x.permute(1, 0, 3, 2, 4)
        x = x.reshape(S, B, x.shape[2], -1).to(torch.float32)

        for gru in self.gru:
            x = gru(x)
        T = x.shape[2]
        x = x.reshape(S, B * T, -1)
        act = _ACTIVATIONS[cfg.head_activation]
        for i, dense in enumerate(self.head):
            x = dense(x)
            if i < len(self.head) - 1:
                x = act(x)
        return x.reshape(S, B, T, -1).to(torch.float32)

