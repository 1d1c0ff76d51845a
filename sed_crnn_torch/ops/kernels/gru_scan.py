"""GRU forward recurrence: the CUDA kernel (``csrc/gru_scan.cu``) and its
plain PyTorch version.

The counterpart of the JAX package's `ops/pallas/gru_scan.py` forward
(`_fwd_kernel`, ``with_res=False``), with its batch-major contract:
``xp (B, T, 3H)`` pre-projected inputs (``x @ wi + bi``), ``wh (H, 3H)`` in
gate order (reset, update, candidate), ``bh (3H,)`` read only when
``reset_after``, ``h0 (B, H)`` -> ``ys (B, T, H)``, ``h_last (B, H)``. Both
``reset_after`` conventions, ``sigmoid`` and keras-2.2 ``hard_sigmoid``
gates, and reverse time.

`gru_scan` launches the kernel for a CUDA tensor and runs `gru_scan_plain`
(the step loop of the JAX package's `nn/gru.py` scan body) only for a CPU
tensor. The kernel streams ``xp`` and ``ys``, so any T and B are taken.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Callable, Optional, Tuple

import torch

from sed_crnn_torch.ops.kernels import _build

GATES = ("sigmoid", "hard_sigmoid")
MAX_HIDDEN = 128  # wh (H, 3H) float32 must fit the block's shared memory


def hard_sigmoid(v: torch.Tensor) -> torch.Tensor:
    """keras-2.2 ``clip(0.2 v + 0.5, 0, 1)`` (not torch's relu6(v + 3) / 6)."""
    return torch.clamp(0.2 * v + 0.5, 0.0, 1.0)


def gate_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "sigmoid":
        return torch.sigmoid
    if name == "hard_sigmoid":
        return hard_sigmoid
    raise ValueError(f"unknown gate_activation {name!r}")


def gru_scan_plain(
    xp: torch.Tensor,
    wh: torch.Tensor,
    bh: Optional[torch.Tensor],
    h0: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence as a Python step loop of float32 PyTorch ops."""
    B, T, H3 = xp.shape
    H = H3 // 3
    gate = gate_fn(gate_activation)
    h = h0
    ys = [h0] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        xt = xp[:, t]
        xr, xz, xn = xt[:, :H], xt[:, H : 2 * H], xt[:, 2 * H :]
        if reset_after:
            hp = h @ wh + bh
            r = gate(xr + hp[:, :H])
            z = gate(xz + hp[:, H : 2 * H])
            n = torch.tanh(xn + r * hp[:, 2 * H :])
        else:
            r = gate(xr + h @ wh[:, :H])
            z = gate(xz + h @ wh[:, H : 2 * H])
            n = torch.tanh(xn + (r * h) @ wh[:, 2 * H :])
        h = (1.0 - z) * n + z * h
        ys[t] = h
    ys_t = torch.stack(ys, dim=1) if T else xp.new_zeros((B, 0, H))
    return ys_t, h


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gru_scan_fwd.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.gru_scan_fwd.restype = i
    lib.gru_scan_error_string.argtypes = [i]
    lib.gru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _checked(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    return t.contiguous()


def gru_scan(
    xp: torch.Tensor,
    wh: torch.Tensor,
    bh: Optional[torch.Tensor],
    h0: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction of the GRU recurrence over all T steps.
    CUDA tensor: the kernel; CPU tensor: `gru_scan_plain`."""
    B, T, H3 = xp.shape
    H = H3 // 3
    if bh is not None:
        bh = bh.reshape(H3)
    elif reset_after:
        bh = xp.new_zeros((H3,))
    if xp.device.type == "cpu":
        return gru_scan_plain(xp, wh, bh, h0, reset_after, gate_activation, reverse)
    if xp.device.type != "cuda":
        raise ValueError(f"unsupported device {xp.device}")
    if gate_activation not in GATES:
        raise ValueError(f"unknown gate_activation {gate_activation!r}")
    if H3 != 3 * H or not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"xp's last axis must be 3H with 0 < H <= {MAX_HIDDEN}, got {H3}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (xp, wh, bh, h0)
    ):
        raise NotImplementedError(
            "the GRU kernel's backward is not yet ported; run inference under torch.no_grad()"
        )
    dev = xp.device
    xp = _checked("xp", xp, (B, T, H3), dev)
    wh = _checked("wh", wh, (H, H3), dev)
    h0 = _checked("h0", h0, (B, H), dev)
    if reset_after:
        bh = _checked("bh", bh, (H3,), dev)
    ys = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        h_last.copy_(h0)
        return ys, h_last
    lib = _lib()
    with torch.cuda.device(dev):
        status = lib.gru_scan_fwd(
            xp.data_ptr(), wh.data_ptr(), bh.data_ptr() if reset_after else None,
            h0.data_ptr(), ys.data_ptr(), h_last.data_ptr(),
            B, T, H, int(reset_after), int(gate_activation == "hard_sigmoid"),
            int(reverse), torch.cuda.current_stream(dev).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"gru_scan launch failed: {lib.gru_scan_error_string(status).decode()}"
        )
    gru_scan.launches += 1
    return ys, h_last


gru_scan.launches = 0
