"""GRU and bidirectional GRU modules over the recurrence of
`ops/kernels/gru_scan.py`.

Counterparts of the JAX package's `nn/gru.py`. Weights keep the JAX layout
so checkpoints carry over as they are: ``wi (in, 3H)``, ``wh (H, 3H)``,
``bi (3H)`` and, for ``reset_after=True`` only, ``bh (3H)``, gate order
(reset, update, candidate). The input projection for every timestep is
hoisted out of the recurrence as one ``torch.matmul``.

``reset_after=True`` is the torch/cuDNN convention (reset applied to the
projected hidden state); ``False`` is the keras-2.2 SEDnet convention (reset
applied to ``h`` before the recurrent product, one bias). The recurrence
runs through the kernel's wrapper, which launches the CUDA kernel for a CUDA
tensor and runs the plain step loop for a CPU tensor.
Parameters start at zero: weights come from `models/convert.py` until the
training slice ports the init schemes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sed_crnn_torch.ops.kernels.gru_scan import GATES, gru_scan


class GRU(nn.Module):
    def __init__(
        self,
        in_dim: int,
        hidden: int,
        reset_after: bool = True,
        gate_activation: str = "sigmoid",
    ):
        super().__init__()
        if gate_activation not in GATES:
            raise ValueError(f"unknown gate_activation {gate_activation!r}")
        self.hidden = hidden
        self.reset_after = reset_after
        self.gate_activation = gate_activation
        h3 = 3 * hidden
        self.wi = nn.Parameter(torch.zeros(in_dim, h3))
        self.wh = nn.Parameter(torch.zeros(hidden, h3))
        self.bi = nn.Parameter(torch.zeros(h3))
        self.bh = nn.Parameter(torch.zeros(h3)) if reset_after else None

    def forward(
        self, x: torch.Tensor, h0: Optional[torch.Tensor] = None, reverse: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, T, in) -> (outputs (B, T, H), h_last (B, H))."""
        if h0 is None:
            h0 = x.new_zeros((x.shape[0], self.hidden))
        xp = torch.matmul(x, self.wi) + self.bi                    # (B, T, 3H)
        return gru_scan(xp, self.wh, self.bh, h0, self.reset_after, self.gate_activation, reverse)


class BiGRU(nn.Module):
    """Bidirectional GRU; output is the [forward ; backward] concat (2H)."""

    def __init__(
        self,
        in_dim: int,
        hidden: int,
        reset_after: bool = True,
        gate_activation: str = "sigmoid",
    ):
        super().__init__()
        self.hidden = hidden
        self.fwd = GRU(in_dim, hidden, reset_after, gate_activation)
        self.bwd = GRU(in_dim, hidden, reset_after, gate_activation)

    def forward(
        self, x: torch.Tensor, h0: Optional[Dict[str, torch.Tensor]] = None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x (B, T, in) -> ((B, T, 2H), {"fwd": h, "bwd": h}). ``h0`` is an
        optional dict of initial states, as streaming carries them."""
        h0 = h0 or {}
        yf, hf = self.fwd(x, h0.get("fwd"), reverse=False)
        yb, hb = self.bwd(x, h0.get("bwd"), reverse=True)
        return torch.cat([yf, yb], dim=-1), {"fwd": hf, "bwd": hb}
