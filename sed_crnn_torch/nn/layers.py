"""The CRNN's layers as `nn.Module`s, for inference and training.

Counterparts of the JAX package's `nn/layers.py`. Activations are NCHW with
the same (H, W) as the JAX package's NHWC layout, W being the pooled axis;
weights are PyTorch's (OIHW convolutions, (out, in) dense), which
`models/convert.py` fills from the JAX tree.

Initialization follows the JAX package's two schemes, drawn from a caller's
`torch.Generator` (the two frameworks' random streams differ, so only the
distributions match): ``"torch"`` U(+-1/sqrt(fan_in)) for weights and
biases, ``"keras"`` glorot-uniform weights and zero biases.

BatchNorm in train mode normalizes with the batch statistics and updates its
running buffers in place; Dropout in train mode draws its keep-mask from an
explicit generator.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

INIT_SCHEMES = ("torch", "keras")


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with U(-bound, bound) drawn from ``generator``."""
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        return t.copy_(u * (2.0 * bound) - bound)


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
    """keras' default kernel initializer: U(+-sqrt(6 / (fan_in + fan_out)))."""
    return uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def _init_weight_bias(weight, bias, fan_in, fan_out, scheme, generator) -> None:
    if scheme == "keras":
        glorot_uniform_(weight, fan_in, fan_out, generator)
        with torch.no_grad():
            bias.zero_()
    elif scheme == "torch":
        bound = 1.0 / math.sqrt(fan_in)
        uniform_(weight, bound, generator)
        uniform_(bias, bound, generator)
    else:
        raise ValueError(f"unknown init scheme {scheme!r}; expected one of {INIT_SCHEMES}")


class Dense(nn.Module):
    """``x @ weight.T + bias`` over the last axis (time-distributed)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def init_parameters(self, generator: torch.Generator, scheme: str = "torch") -> None:
        out_dim, in_dim = self.weight.shape
        _init_weight_bias(self.weight, self.bias, in_dim, out_dim, scheme, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    """Stride-1 2-D convolution with SAME padding (pad 1 for 3x3)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int] = (3, 3)):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def init_parameters(self, generator: torch.Generator, scheme: str = "torch") -> None:
        out_ch, in_ch, kh, kw = self.weight.shape
        _init_weight_bias(self.weight, self.bias, in_ch * kh * kw, out_ch * kh * kw,
                          scheme, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Float32 in, float32 out. A reduced-precision ``x`` (a bf16 trunk)
        gives a float32 output too: the weight is rounded to ``x``'s dtype,
        the exact products are summed and the bias added in float32, as a
        bf16 convolution accumulates, and the block rounds once, after
        BatchNorm (`models/crnn.py`)."""
        if x.dtype == torch.float32:
            return F.conv2d(x, self.weight, self.bias, padding="same")
        return F.conv2d(x.float(), self.weight.to(x.dtype).float(), self.bias.float(),
                        padding="same")


class BatchNorm2d(nn.Module):
    """Batch norm over the channel axis of NCHW activations, with the JAX
    package's torch semantics.

    Eval: ``(x - mean) * rsqrt(var + eps) * scale + bias`` in float32 with
    the running statistics, or, for a reduced-precision trunk, the affine
    folded to ``x * inv + shift`` in the input dtype (the JAX bf16 form).

    Train: the batch mean and the single-pass ``var = max(E[x^2] - E[x]^2,
    0)`` in float32 (as the JAX package computes it, not `F.batch_norm`'s
    two-pass variance) normalize; the running buffers are updated in place
    with ``momentum`` and the unbiased ``var * n / (n - 1)``, ``n = B*H*W``.

    Cross-replica (data-parallel) training: with a `parallel.mesh.Mesh` in
    ``sync_group``, the train-mode ``mean`` and ``mean_sq`` are averaged and
    ``n`` summed over the mesh's ranks (the JAX package's `pmean` / `psum`
    with ``axis_name``), packed into one differentiable all_reduce (the
    group's ``all_reduce_sum_grad``): its backward sums the cotangents over
    ranks, so the parameters below receive the global batch's gradient. The data-parallel trainer sets and clears
    the attribute around its train step; eval mode never reads it.
    """

    sync_group = None

    def __init__(self, ch: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def init_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if self.training:
            xf = x.float()
            axes = (0, 2, 3)
            n = float(xf.numel() // xf.shape[1])
            mean = xf.mean(dim=axes)
            mean_sq = (xf * xf).mean(dim=axes)
            if self.sync_group is not None:
                mean, mean_sq, n = _global_moments(mean, mean_sq, n, self.sync_group)
                var = torch.clamp_min(mean_sq - mean * mean, 0.0)
                unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
            else:
                var = torch.clamp_min(mean_sq - mean * mean, 0.0)
                unbiased = var * n / max(n - 1.0, 1.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        bias = self.bias.float()
        if x.dtype == torch.float32:
            return (x - mean.view(shape)) * inv.view(shape) + bias.view(shape)
        shift = bias - mean * inv
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def _global_moments(mean: torch.Tensor, mean_sq: torch.Tensor, n: float, mesh):
    """(pmean(mean), pmean(mean_sq), psum(n)) over ``mesh`` with one
    differentiable all_reduce of the packed (2C + 1,) float32 vector; ``n``
    comes back as a 0-d tensor, so nothing waits on the device."""
    c = mean.shape[0]
    packed = torch.cat([mean, mean_sq, mean.new_full((1,), n)])
    total = mesh.all_reduce_sum_grad(packed)
    w = float(mesh.size)
    return total[:c] / w, total[c : 2 * c] / w, total[2 * c]


class Dropout(nn.Module):
    """Identity at inference. In train mode, ``x * keep_mask / keep`` with
    the keep-mask drawn from ``generator`` (on ``x``'s device)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout in train mode requires a generator")
        keep = 1.0 - self.rate
        if keep <= 0.0:
            return torch.zeros_like(x)
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return x * ((u < keep).to(x.dtype) * (1.0 / keep))


def max_pool2d(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Non-overlapping max pool over (H, W) of NCHW input, floor-truncating
    ragged edges as torch MaxPool2d does. Its gradient goes to the first
    maximal element of each window, the JAX package's custom VJP rule."""
    if tuple(window) == (1, 1):
        return x
    return F.max_pool2d(x, window, stride=window)
