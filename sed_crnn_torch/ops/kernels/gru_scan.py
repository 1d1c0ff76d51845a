"""GRU recurrence: the CUDA kernels (``csrc/gru_scan.cu``), their plain
PyTorch versions, and the `torch.autograd.Function` that joins them.

The counterpart of the JAX package's `ops/pallas/gru_scan.py`, with its
batch-major contract: ``xp (B, T, 3H)`` pre-projected inputs
(``x @ wi + bi``), ``wh (H, 3H)`` in gate order (reset, update, candidate),
``bh (3H,)`` read only when ``reset_after``, ``h0 (B, H)`` -> ``ys (B, T, H)``,
``h_last (B, H)``. Both ``reset_after`` conventions, ``sigmoid`` and
keras-2.2 ``hard_sigmoid`` gates, and reverse time.

Three kernels, each behind a wrapper that launches it for a CUDA tensor,
runs its plain version only for a CPU tensor, and counts its launches:

* `gru_scan`: the forward (`_fwd_kernel`, ``with_res=False``). With grad
  enabled and an input that requires grad it goes through `GruScanFn`
  instead; under ``no_grad`` it launches this kernel (serving, validation).
* `gru_scan_fwd_res`: the forward that also stores the gates of every step,
  ``res (B, T, 3H)`` = r | z | n, or ``(B, T, 4H)`` with the projected
  candidate hn appended when ``reset_after`` (`_fwd_kernel`,
  ``with_res=True``).
* `gru_scan_bwd`: the reverse-time gradient recurrence (`_bwd_kernel`) over
  the stored residuals -> ``dxp, dwh, dbh, dh0``. Its kernel writes one
  partial ``dwh``/``dbh`` per block of batch rows, which a second kernel adds
  in block order (counted in ``gru_scan_bwd.sum_launches``). ``dbh`` is zero
  when ``reset_after`` is False, as the JAX wrapper sets it.

`GruScanFn` is the custom VJP: its forward is `gru_scan_fwd_res`, its
backward `gru_scan_bwd`, on the card or, for CPU tensors, their plain
versions. The kernels stream every per-step array, so any T and B are taken.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Callable, Optional, Tuple

import torch

from sed_crnn_torch.ops.kernels import _build

GATES = ("sigmoid", "hard_sigmoid")
MAX_HIDDEN = 128      # forward: wh (H, 3H) float32 must fit the block's shared memory
MAX_HIDDEN_BWD = 64   # backward: whT and the partial dwh, both (H, 3H), must fit


def hard_sigmoid(v: torch.Tensor) -> torch.Tensor:
    """keras-2.2 ``clip(0.2 v + 0.5, 0, 1)`` (not torch's relu6(v + 3) / 6)."""
    return torch.clamp(0.2 * v + 0.5, 0.0, 1.0)


def gate_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "sigmoid":
        return torch.sigmoid
    if name == "hard_sigmoid":
        return hard_sigmoid
    raise ValueError(f"unknown gate_activation {name!r}")


def gate_grad_from_output(name: str, g: torch.Tensor) -> torch.Tensor:
    """d gate / d pre-activation, from the gate's output value."""
    if name == "sigmoid":
        return g * (1.0 - g)
    if name == "hard_sigmoid":
        return 0.2 * ((g > 0.0) & (g < 1.0)).to(g.dtype)
    raise ValueError(f"unknown gate_activation {name!r}")


def res_width(reset_after: bool, H: int) -> int:
    """Width of a residual row: r | z | n, plus hn when ``reset_after``."""
    return 4 * H if reset_after else 3 * H


def _steps(T: int, reverse: bool):
    return range(T - 1, -1, -1) if reverse else range(T)


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
    ys, _, h = gru_scan_fwd_res_plain(xp, wh, bh, h0, reset_after, gate_activation,
                                      reverse, keep_res=False)
    return ys, h


def gru_scan_fwd_res_plain(
    xp: torch.Tensor,
    wh: torch.Tensor,
    bh: Optional[torch.Tensor],
    h0: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
    keep_res: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """The step loop, also returning the residuals ``res`` (None unless
    ``keep_res``) -> ``(ys, res, h_last)``."""
    B, T, H3 = xp.shape
    H = H3 // 3
    gate = gate_fn(gate_activation)
    h = h0
    ys = [h0] * T
    res = [None] * T
    for t in _steps(T, reverse):
        xt = xp[:, t]
        xr, xz, xn = xt[:, :H], xt[:, H : 2 * H], xt[:, 2 * H :]
        if reset_after:
            hp = h @ wh + bh
            r = gate(xr + hp[:, :H])
            z = gate(xz + hp[:, H : 2 * H])
            hn = hp[:, 2 * H :]
            n = torch.tanh(xn + r * hn)
            gates = (r, z, n, hn)
        else:
            r = gate(xr + h @ wh[:, :H])
            z = gate(xz + h @ wh[:, H : 2 * H])
            n = torch.tanh(xn + (r * h) @ wh[:, 2 * H :])
            gates = (r, z, n)
        h = (1.0 - z) * n + z * h
        ys[t] = h
        if keep_res:
            res[t] = torch.cat(gates, dim=-1)
    ys_t = torch.stack(ys, dim=1) if T else xp.new_zeros((B, 0, H))
    if not keep_res:
        return ys_t, None, h
    res_t = torch.stack(res, dim=1) if T else xp.new_zeros((B, 0, res_width(reset_after, H)))
    return ys_t, res_t, h


def gru_scan_bwd_plain(
    ys: torch.Tensor,
    res: torch.Tensor,
    wh: torch.Tensor,
    h0: torch.Tensor,
    dys: torch.Tensor,
    dhl: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse-time gradient recurrence as an explicit step loop over the
    stored residuals (the JAX `_bwd_kernel`'s math, not autograd) ->
    ``(dxp (B, T, 3H), dwh (H, 3H), dbh (3H,), dh0 (B, H))``."""
    B, T, H = ys.shape
    dwh = wh.new_zeros(wh.shape)
    dbh = wh.new_zeros((3 * H,))
    dxp = [None] * T
    dh = dhl
    for t in _steps(T, not reverse):
        if reverse:      # the forward walked t = T-1 .. 0; predecessor is ys[t+1]
            h_prev = ys[:, t + 1] if t < T - 1 else h0
        else:
            h_prev = ys[:, t - 1] if t > 0 else h0
        rt = res[:, t]
        r, z, n = rt[:, :H], rt[:, H : 2 * H], rt[:, 2 * H : 3 * H]
        dht = dys[:, t] + dh
        da_z = dht * (h_prev - n) * gate_grad_from_output(gate_activation, z)
        da_n = dht * (1.0 - z) * (1.0 - n * n)
        if reset_after:
            hn = rt[:, 3 * H :]
            da_r = da_n * hn * gate_grad_from_output(gate_activation, r)
            dhp = torch.cat([da_r, da_z, da_n * r], dim=-1)
            dh = dht * z + dhp @ wh.T
            dwh = dwh + h_prev.T @ dhp
            dbh = dbh + dhp.sum(0)
        else:
            drh = da_n @ wh[:, 2 * H :].T
            da_r = drh * h_prev * gate_grad_from_output(gate_activation, r)
            da_rz = torch.cat([da_r, da_z], dim=-1)
            dh = dht * z + da_rz @ wh[:, : 2 * H].T + drh * r
            dwh = dwh + torch.cat([h_prev.T @ da_rz, (r * h_prev).T @ da_n], dim=-1)
        dxp[t] = torch.cat([da_r, da_z, da_n], dim=-1)
    dxp_t = torch.stack(dxp, dim=1) if T else ys.new_zeros((B, 0, 3 * H))
    return dxp_t, dwh, dbh, dh


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gru_scan_fwd.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.gru_scan_fwd.restype = i
    lib.gru_scan_fwd_res.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.gru_scan_fwd_res.restype = i
    lib.gru_scan_bwd_blocks.argtypes = [i, i]
    lib.gru_scan_bwd_blocks.restype = i
    lib.gru_scan_bwd.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.gru_scan_bwd.restype = i
    lib.gru_scan_sum_partials.argtypes = [p, p, i, i, p]
    lib.gru_scan_sum_partials.restype = i
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


def _raise_on(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_lib().gru_scan_error_string(status).decode()}")


def _device_of(xp: torch.Tensor) -> torch.device:
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xp.device}")
    return xp.device


def _validate(H3: int, gate_activation: str, max_hidden: int) -> int:
    if gate_activation not in GATES:
        raise ValueError(f"unknown gate_activation {gate_activation!r}")
    H = H3 // 3
    if H3 != 3 * H or not 0 < H <= max_hidden:
        raise ValueError(f"the gate axis must be 3H with 0 < H <= {max_hidden}, got {H3}")
    return H


def _bias(bh: Optional[torch.Tensor], reset_after: bool, xp: torch.Tensor) -> Optional[torch.Tensor]:
    """``bh`` as (3H,); zeros when ``reset_after`` and none is given."""
    H3 = xp.shape[-1]
    if bh is not None:
        return bh.reshape(H3)
    return xp.new_zeros((H3,)) if reset_after else None


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

    With grad enabled and an input that requires grad: `GruScanFn` (the
    residual forward and the backward kernel). Otherwise, for a CUDA tensor
    the forward kernel, for a CPU tensor `gru_scan_plain`."""
    bh = _bias(bh, reset_after, xp)
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (xp, wh, bh, h0)
    ):
        return GruScanFn.apply(xp, wh, bh, h0, reset_after, gate_activation, reverse)
    dev = _device_of(xp)
    if dev.type == "cpu":
        return gru_scan_plain(xp, wh, bh, h0, reset_after, gate_activation, reverse)
    B, T, H3 = xp.shape
    H = _validate(H3, gate_activation, MAX_HIDDEN)
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
    with torch.cuda.device(dev):
        status = _lib().gru_scan_fwd(
            xp.data_ptr(), wh.data_ptr(), bh.data_ptr() if reset_after else None,
            h0.data_ptr(), ys.data_ptr(), h_last.data_ptr(),
            B, T, H, int(reset_after), int(gate_activation == "hard_sigmoid"),
            int(reverse), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(status, "gru_scan")
    gru_scan.launches += 1
    return ys, h_last


gru_scan.launches = 0


def gru_scan_fwd_res(
    xp: torch.Tensor,
    wh: torch.Tensor,
    bh: Optional[torch.Tensor],
    h0: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward that keeps its residuals -> ``(ys, res, h_last)``. CUDA
    tensor: the kernel; CPU tensor: `gru_scan_fwd_res_plain`."""
    bh = _bias(bh, reset_after, xp)
    dev = _device_of(xp)
    if dev.type == "cpu":
        return gru_scan_fwd_res_plain(xp, wh, bh, h0, reset_after, gate_activation, reverse)
    B, T, H3 = xp.shape
    H = _validate(H3, gate_activation, MAX_HIDDEN)
    xp = _checked("xp", xp, (B, T, H3), dev)
    wh = _checked("wh", wh, (H, H3), dev)
    h0 = _checked("h0", h0, (B, H), dev)
    if reset_after:
        bh = _checked("bh", bh, (H3,), dev)
    ys = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    res = torch.empty((B, T, res_width(reset_after, H)), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        h_last.copy_(h0)
        return ys, res, h_last
    with torch.cuda.device(dev):
        status = _lib().gru_scan_fwd_res(
            xp.data_ptr(), wh.data_ptr(), bh.data_ptr() if reset_after else None,
            h0.data_ptr(), ys.data_ptr(), res.data_ptr(), h_last.data_ptr(),
            B, T, H, int(reset_after), int(gate_activation == "hard_sigmoid"),
            int(reverse), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(status, "gru_scan_fwd_res")
    gru_scan_fwd_res.launches += 1
    return ys, res, h_last


gru_scan_fwd_res.launches = 0


def gru_scan_bwd(
    ys: torch.Tensor,
    res: torch.Tensor,
    wh: torch.Tensor,
    h0: torch.Tensor,
    dys: torch.Tensor,
    dhl: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient recurrence -> ``(dxp, dwh, dbh, dh0)``. CUDA tensor: the
    backward kernel and the fixed-order partial sum; CPU tensor:
    `gru_scan_bwd_plain`."""
    dev = _device_of(ys)
    if dev.type == "cpu":
        return gru_scan_bwd_plain(ys, res, wh, h0, dys, dhl, reset_after,
                                  gate_activation, reverse)
    B, T, H = ys.shape
    _validate(3 * H, gate_activation, MAX_HIDDEN_BWD)
    ys = _checked("ys", ys, (B, T, H), dev)
    res = _checked("res", res, (B, T, res_width(reset_after, H)), dev)
    wh = _checked("wh", wh, (H, 3 * H), dev)
    h0 = _checked("h0", h0, (B, H), dev)
    dys = _checked("dys", dys, (B, T, H), dev)
    dhl = _checked("dhl", dhl, (B, H), dev)
    dxp = torch.empty((B, T, 3 * H), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return dxp, wh.new_zeros(wh.shape), wh.new_zeros((3 * H,)), dhl.clone()
    lib = _lib()
    n = 3 * H * H + 3 * H
    part = torch.empty((lib.gru_scan_bwd_blocks(H, B), n), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    sums = torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.gru_scan_bwd(
            ys.data_ptr(), res.data_ptr(), wh.data_ptr(), h0.data_ptr(), dys.data_ptr(),
            dhl.data_ptr(), dxp.data_ptr(), dh0.data_ptr(), part.data_ptr(),
            B, T, H, int(reset_after), int(gate_activation == "hard_sigmoid"),
            int(reverse), stream,
        )
        _raise_on(status, "gru_scan_bwd")
        gru_scan_bwd.launches += 1
        status = lib.gru_scan_sum_partials(part.data_ptr(), sums.data_ptr(),
                                           part.shape[0], n, stream)
        _raise_on(status, "gru_scan_sum_partials")
        gru_scan_bwd.sum_launches += 1
    return dxp, sums[: 3 * H * H].view(H, 3 * H), sums[3 * H * H :], dh0


gru_scan_bwd.launches = 0
gru_scan_bwd.sum_launches = 0


class GruScanFn(torch.autograd.Function):
    """The custom VJP of the recurrence: forward `gru_scan_fwd_res`, saving
    ``(ys, res, wh, h0)``; backward `gru_scan_bwd`. A cotangent that autograd
    passes as None (``ys`` or ``h_last`` unused downstream) becomes zeros;
    ``bh``'s gradient is None when no ``bh`` was given, and zeros when it was
    given with ``reset_after=False`` (the kernel never reads it then)."""

    @staticmethod
    def forward(ctx, xp, wh, bh, h0, reset_after, gate_activation, reverse):
        ys, res, h_last = gru_scan_fwd_res(xp, wh, bh, h0, reset_after,
                                           gate_activation, reverse)
        ctx.save_for_backward(ys, res, wh, h0)
        ctx.conf = (reset_after, gate_activation, reverse)
        ctx.has_bh = bh is not None
        ctx.set_materialize_grads(False)
        return ys, h_last

    @staticmethod
    def backward(ctx, dys, dhl):
        ys, res, wh, h0 = ctx.saved_tensors
        dys = torch.zeros_like(ys) if dys is None else dys.contiguous()
        dhl = torch.zeros_like(h0) if dhl is None else dhl.contiguous()
        dxp, dwh, dbh, dh0 = gru_scan_bwd(ys, res, wh, h0, dys, dhl, *ctx.conf)
        return dxp, dwh, dbh if ctx.has_bh else None, dh0, None, None, None
