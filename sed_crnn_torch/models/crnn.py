"""The CRNN model family as one configuration-driven `nn.Module`.

Counterpart of the JAX package's `models/crnn.py`: 3x [conv + BN + ReLU +
max pool (+ dropout)] -> stacked bidirectional GRUs -> time-distributed
dense head, covering SEDnet (mel-axis pooling, keras-convention GRUs) and
the two time-pooled variants.

Layout: NCHW with the JAX package's (H, W) and W the pooled axis, i.e.
(B, C, T, F) for mel pooling and (B, C, F, T) for time pooling. The trunk
output is flattened in the JAX order [B, T, C, F] before the GRUs.

Train mode (`model.train()`): BatchNorm normalizes with batch statistics and
updates its running buffers, and dropout draws from one generator per
dropout site (`dropout_generators`), the JAX package's one key per block.
`init_parameters` draws every layer by the config's ``init_scheme``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from sed_crnn_torch.core.config import GRU_BACKENDS, ModelConfig
from sed_crnn_torch.nn.gru import BiGRU
from sed_crnn_torch.nn.layers import BatchNorm2d, Conv2d, Dense, Dropout, max_pool2d

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
}

Carry = List[Dict[str, torch.Tensor]]


class CRNNShape:
    """The shape arithmetic and input layout of a configuration, shared by
    `CRNN` and the seed-stacked `models/stacked.py::StackedCRNN`."""

    cfg: ModelConfig

    @property
    def n_dropout_sites(self) -> int:
        """Dropout generators a train-mode forward takes: one per block plus
        the trailing site (the JAX package splits its key the same way)."""
        return len(self.cfg.conv_channels) + 1

    # ---- static shape arithmetic -------------------------------------
    @property
    def trunk_out_hw(self) -> Tuple[int, int]:
        """(H, W) after the conv trunk; W is the pooled axis."""
        cfg = self.cfg
        h, w = (cfg.n_mels, cfg.seq_len_in) if cfg.pool_axis == "time" else (
            cfg.seq_len_in, cfg.n_mels)
        for p in cfg.pool:
            w //= p
        return h, w

    @property
    def flat_dim(self) -> int:
        """Features fed to the first GRU: channels x non-time spatial dim."""
        h, w = self.trunk_out_hw
        return self.cfg.conv_channels[-1] * (h if self.cfg.pool_axis == "time" else w)

    @property
    def seq_len_out(self) -> int:
        h, w = self.trunk_out_hw
        return w if self.cfg.pool_axis == "time" else h

    def _to_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) mono, (B, T, F*C) channel-stacked (channel c holds
        features [c*F, (c+1)*F)), or (B, C, T, F) -> NCHW, W pooled."""
        cfg = self.cfg
        if x.ndim == 3:
            b, t, fc = x.shape
            if fc != cfg.in_channels * cfg.n_mels:
                raise ValueError(
                    f"expected {cfg.in_channels * cfg.n_mels} stacked features "
                    f"for {cfg.in_channels} channels, got {fc}"
                )
            x = x.reshape(b, t, cfg.in_channels, cfg.n_mels).transpose(1, 2)
        if x.ndim != 4:
            raise ValueError(f"expected (B,T,F) or (B,C,T,F) input, got {tuple(x.shape)}")
        return x.transpose(2, 3) if cfg.pool_axis == "time" else x


class CRNN(CRNNShape, nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.gru_backend not in GRU_BACKENDS:
            raise ValueError(f"unknown GRU backend {cfg.gru_backend!r}; expected one of "
                             f"{GRU_BACKENDS}")
        self.cfg = cfg
        in_ch = cfg.in_channels
        convs, bns = [], []
        for out_ch in cfg.conv_channels:
            convs.append(Conv2d(in_ch, out_ch, tuple(cfg.kernel_size)))
            bns.append(BatchNorm2d(out_ch, cfg.bn_eps, cfg.bn_momentum))
            in_ch = out_ch
        self.conv = nn.ModuleList(convs)
        self.bn = nn.ModuleList(bns)
        self.dropout = Dropout(cfg.dropout)
        # the legacy keras SEDnet convention resets before the recurrent product
        reset_after = cfg.name != "sednet"
        grus, in_dim = [], self.flat_dim
        for h in cfg.gru_hidden:
            grus.append(BiGRU(in_dim, h, reset_after, cfg.gru_gate_activation))
            in_dim = 2 * h
        self.gru = nn.ModuleList(grus)
        head = []
        for d in cfg.head_dims:
            head.append(Dense(in_dim, d))
            in_dim = d
        self.head = nn.ModuleList(head)
        self.eval()

    def init_parameters(self, generator: torch.Generator) -> "CRNN":
        """Draw every parameter by ``cfg.init_scheme`` from ``generator``, in
        the JAX package's layer order, and reset the BatchNorm running
        statistics. Draws happen on the generator's device and are copied
        into the parameters wherever they live."""
        scheme = self.cfg.init_scheme
        for conv, bn in zip(self.conv, self.bn):
            conv.init_parameters(generator, scheme)
            bn.init_parameters()
        for gru in self.gru:
            gru.init_parameters(generator, scheme)
        for dense in self.head:
            dense.init_parameters(generator, scheme)
        return self

    def forward(
        self,
        x: torch.Tensor,
        rnn_carry: Optional[Carry] = None,
        carry_at: Optional[int] = None,
        dropout_generators: Optional[Sequence[torch.Generator]] = None,
    ) -> Tuple[torch.Tensor, Carry]:
        """Forward -> ``(logits (B, T_out, n_classes), new_carry)``.

        ``rnn_carry``: one {"fwd", "bwd"} state dict per BiGRU, as streaming
        chains chunks; None starts from zeros. ``carry_at``: make the
        returned forward states the hidden states at that GRU timestep
        instead of the final ones (lookahead streaming).
        ``dropout_generators``: `n_dropout_sites` generators on the input's
        device, needed in train mode when ``cfg.dropout > 0``.
        """
        cfg = self.cfg
        gens = list(dropout_generators or [None] * self.n_dropout_sites)
        dtype = getattr(torch, cfg.compute_dtype)
        x = self._to_nchw(x.to(dtype))
        for i, (conv, bn, p) in enumerate(zip(self.conv, self.bn, cfg.pool)):
            # A bf16 trunk keeps convolution, bias and BatchNorm in float32
            # and rounds once per block, here (`nn/layers.py` Conv2d).
            x = max_pool2d(torch.relu(bn(conv(x)).to(dtype)), (1, p))
            if cfg.dropout_per_block:
                x = self.dropout(x, gens[i])
        if not cfg.dropout_per_block:
            x = self.dropout(x, gens[-1])

        # -> (B, T, C*F) in the JAX flatten order [B, T, C, F]
        x = x.permute(0, 3, 1, 2) if cfg.pool_axis == "time" else x.permute(0, 2, 1, 3)
        x = x.reshape(x.shape[0], x.shape[1], -1).to(torch.float32)

        new_carry: Carry = []
        for i, gru in enumerate(self.gru):
            x, h_last = gru(x, None if rnn_carry is None else rnn_carry[i])
            if carry_at is not None:
                h_last = {"fwd": x[:, carry_at, : gru.hidden], "bwd": h_last["bwd"]}
            new_carry.append(h_last)

        act = _ACTIVATIONS[cfg.head_activation]
        for i, dense in enumerate(self.head):
            x = dense(x)
            if i < len(self.head) - 1:
                x = act(x)
        return x.to(torch.float32), new_carry

    def zero_carry(self, batch: int = 1, device=None) -> Carry:
        dev = device if device is not None else self.conv[0].weight.device
        return [
            {d: torch.zeros((batch, g.hidden), device=dev) for d in ("fwd", "bwd")}
            for g in self.gru
        ]


def count_params(model: nn.Module) -> int:
    """Trainable parameters (BatchNorm running statistics excluded), the
    JAX package's count of its ``params`` tree."""
    return sum(p.numel() for p in model.parameters())


def model_flops_per_example(model: CRNN) -> int:
    """Rough forward FLOP count (MACs x 2) for throughput accounting."""
    cfg = model.cfg
    h, w = (cfg.n_mels, cfg.seq_len_in) if cfg.pool_axis == "time" else (
        cfg.seq_len_in, cfg.n_mels)
    kh, kw = cfg.kernel_size
    flops, in_ch = 0, cfg.in_channels
    for out_ch, p in zip(cfg.conv_channels, cfg.pool):
        flops += 2 * h * w * in_ch * out_ch * kh * kw
        w //= p
        in_ch = out_ch
    t, feat = model.seq_len_out, model.flat_dim
    for hdim in cfg.gru_hidden:
        flops += 2 * 2 * t * (feat * 3 * hdim + hdim * 3 * hdim)
        feat = 2 * hdim
    in_dim = 2 * cfg.gru_hidden[-1]
    for d in cfg.head_dims:
        flops += 2 * t * in_dim * d
        in_dim = d
    return flops
