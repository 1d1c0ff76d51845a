"""The CRNN's layers as `nn.Module`s (inference forward).

Counterparts of the JAX package's `nn/layers.py`. Activations are NCHW with
the same (H, W) as the JAX package's NHWC layout, W being the pooled axis;
weights are PyTorch's (OIHW convolutions, (out, in) dense), which
`models/convert.py` fills from the JAX tree.

BatchNorm runs in eval mode only (running statistics); train mode comes
with the training slice and raises until then.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """``x @ weight.T + bias`` over the last axis (time-distributed)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    """Stride-1 2-D convolution with SAME padding (pad 1 for 3x3)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int] = (3, 3)):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding="same")


class BatchNorm2d(nn.Module):
    """Eval-mode batch norm over the channel axis of NCHW activations:
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` in float32, or, for a
    reduced-precision trunk, the affine folded to ``x * inv + shift`` in the
    input dtype (the JAX package's bf16 form)."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("BatchNorm2d train mode is not yet ported")
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight.float()
        mean = self.running_mean
        bias = self.bias.float()
        if x.dtype == torch.float32:
            return (x - mean.view(shape)) * inv.view(shape) + bias.view(shape)
        shift = bias - mean * inv
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class Dropout(nn.Module):
    """Identity at inference; train-mode dropout comes with training."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0.0:
            raise NotImplementedError("Dropout train mode is not yet ported")
        return x


def max_pool2d(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Non-overlapping max pool over (H, W) of NCHW input, floor-truncating
    ragged edges as torch MaxPool2d does."""
    if tuple(window) == (1, 1):
        return x
    return F.max_pool2d(x, window, stride=window)
