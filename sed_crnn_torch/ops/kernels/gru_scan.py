"""GRU recurrence: the CUDA kernels (``csrc/gru_warp.cu`` and
``csrc/gru_scan.cu``), their plain PyTorch versions, and the
`torch.autograd.Function`s that join them.

The counterpart of the JAX package's `ops/pallas/gru_scan.py`, with its
batch-major contract: ``xp (B, T, 3H)`` pre-projected inputs
(``x @ wi + bi``), ``wh (H, 3H)`` in gate order (reset, update, candidate),
``bh (3H,)`` read only when ``reset_after``, ``h0 (B, H)`` -> ``ys (B, T, H)``,
``h_last (B, H)``. Both ``reset_after`` conventions, ``sigmoid`` and
keras-2.2 ``hard_sigmoid`` gates, and reverse time.

Two CUDA bodies, chosen by `gru_body` from the hidden width H:

* ``"warp"`` (``csrc/gru_warp.cu``), H <= 32 (every preset): one warp per
  batch row (or 32 / HP rows, HP = H rounded up to a power of two), the
  recurrent weights in registers, one or two directions per launch, and the
  backward's ``dwh``/``dbh`` reduced after the gradient chain by a separate
  kernel over the stored rows (`gru_dwh_plain` is its reference);
* ``"retained"`` (``csrc/gru_scan.cu``), 32 < H <= 128 for the forward and
  <= 64 for the backward: a block of batch rows per direction, the weights
  and the partial ``dwh`` in shared memory; a pair is two launches.

Entry points, each of which launches a kernel for a CUDA tensor, runs its
plain version only for a CPU tensor, and counts its launches:

* `gru_scan` / `gru_scan_pair`: the forward of one direction / of both
  directions of a BiGRU (``_fwd_kernel``, ``with_res=False``); with grad
  enabled and an input that requires grad they go through `GruScanFn` /
  `GruScanPairFn` instead. Counted in ``gru_scan.launches``.
* `gru_scan_fwd_res` / `gru_scan_pair_fwd_res`: the forward that also stores
  the gates of every step, ``res (B, T, 3H)`` = r | z | n, or ``(B, T, 4H)``
  with the projected candidate hn appended when ``reset_after``
  (``_fwd_kernel``, ``with_res=True``). Counted in
  ``gru_scan_fwd_res.launches``.
* `gru_scan_bwd` / `gru_scan_pair_bwd`: the reverse-time gradient recurrence
  (``_bwd_kernel``) over the stored residuals -> ``dxp, dwh, dbh, dh0``.
  The chain is counted in ``gru_scan_bwd.launches``; the warp body's
  ``dwh``/``dbh`` reduction in ``gru_scan_bwd.dwh_launches``; the fixed-order
  sum of per-block partials (either body) in ``gru_scan_bwd.sum_launches``.
  ``dbh`` is zero when ``reset_after`` is False, as the JAX wrapper sets it.

A pair on the warp body is one launch of each kernel; ``direction 0`` runs
forward in time and ``direction 1`` reversed, as `nn/gru.py`'s BiGRU needs.

`gru_scan_stack`, `gru_scan_stack_fwd_res`, `gru_scan_stack_bwd` and
`GruScanStackFn` are the pair's entry points for S independent BiGRUs of one
shape (stacked multi-seed training, `models/stacked.py`): every operand of a
direction carries a leading seed axis, ``xp (S, B, T, 3H)``, ``wh (S, H,
3H)``, ``bh (S, 3H)``, ``h0 (S, B, H)``, and so does every result. On the
warp body each kernel launches once per call for all S seeds x 2
directions, counted in the counters above; the retained body takes no seed
axis. A CPU tensor runs the plain versions seed by seed.
``gru_scan.retained_launches`` counts the launches of the retained body's
recurrences (forward, residual forward, backward) among all of the above.
The kernels stream every per-step array, so any T and B are taken.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from sed_crnn_torch.ops.kernels import _build

GATES = ("sigmoid", "hard_sigmoid")
MAX_HIDDEN = 128      # forward: the retained body keeps wh (H, 3H) in shared memory
MAX_HIDDEN_BWD = 64   # backward: the retained body keeps whT and the partial dwh there
WARP_MAX_HIDDEN = 32  # the warp body: lane j owns hidden unit j

Pair = Tuple[torch.Tensor, torch.Tensor]


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


def gru_body(H: int, backward: bool = False) -> str:
    """The CUDA body that a hidden width H runs on: ``"warp"``
    (``csrc/gru_warp.cu``) for H <= 32, ``"retained"`` (``csrc/gru_scan.cu``)
    up to `MAX_HIDDEN` (forward) or `MAX_HIDDEN_BWD` (``backward``)."""
    limit = MAX_HIDDEN_BWD if backward else MAX_HIDDEN
    if not 0 < H <= limit:
        raise ValueError(f"hidden width must satisfy 0 < H <= {limit}, got {H}")
    return "warp" if H <= WARP_MAX_HIDDEN else "retained"


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


def gru_dwh_plain(
    ys: torch.Tensor,
    res: torch.Tensor,
    h0: torch.Tensor,
    dxp: torch.Tensor,
    reset_after: bool,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dwh (H, 3H)`` and ``dbh (3H,)`` from the stored rows, after the
    gradient chain: with ``h_prev`` the state before each step (``ys``
    shifted by one step in the direction's order, ``h0`` at the chain's
    start) and ``dxp = [da_r, da_z, da_n]``,
    ``dwh[:, :2H] = h_prev^T dxp[:, :2H]``; ``dwh[:, 2H:] = (r h_prev)^T da_n``
    when not ``reset_after``, else ``h_prev^T (da_n r)`` and
    ``dbh = sum [da_r, da_z, da_n r]`` (zeros when not ``reset_after``)."""
    B, T, H = ys.shape
    if B == 0 or T == 0:
        return ys.new_zeros((H, 3 * H)), ys.new_zeros((3 * H,))
    before = h0[:, None]
    h_prev = torch.cat([ys[:, 1:], before], 1) if reverse else torch.cat([before, ys[:, :-1]], 1)
    h_prev = h_prev.reshape(-1, H)
    r = res[..., :H].reshape(-1, H)
    d = dxp.reshape(-1, 3 * H)
    if reset_after:
        dhp = torch.cat([d[:, : 2 * H], d[:, 2 * H :] * r], dim=-1)
        return h_prev.T @ dhp, dhp.sum(0)
    dwh = torch.cat([h_prev.T @ d[:, : 2 * H], (r * h_prev).T @ d[:, 2 * H :]], dim=-1)
    return dwh, ys.new_zeros((3 * H,))


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
    stored residuals (the JAX `_bwd_kernel`'s math, not autograd), then
    `gru_dwh_plain` -> ``(dxp (B, T, 3H), dwh (H, 3H), dbh (3H,), dh0 (B, H))``."""
    B, T, H = ys.shape
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
            dh = dht * z + torch.cat([da_r, da_z, da_n * r], dim=-1) @ wh.T
        else:
            drh = da_n @ wh[:, 2 * H :].T
            da_r = drh * h_prev * gate_grad_from_output(gate_activation, r)
            dh = dht * z + torch.cat([da_r, da_z], dim=-1) @ wh[:, : 2 * H].T + drh * r
        dxp[t] = torch.cat([da_r, da_z, da_n], dim=-1)
    dxp_t = torch.stack(dxp, dim=1) if T else ys.new_zeros((B, 0, 3 * H))
    dwh, dbh = gru_dwh_plain(ys, res, h0, dxp_t, reset_after, reverse)
    return dxp_t, dwh, dbh, dh


# --- the CUDA libraries --------------------------------------------------------

_p, _i = ctypes.c_void_p, ctypes.c_int


class _FwdDir(ctypes.Structure):
    _fields_ = [(n, _p) for n in ("xp", "wh", "bh", "h0", "ys", "res", "h_last")] + [
        ("reverse", _i)]


class _BwdDir(ctypes.Structure):
    _fields_ = [(n, _p) for n in ("ys", "res", "wh", "h0", "dys", "dhl", "dxp", "dh0")] + [
        ("reverse", _i)]


class _DwhDir(ctypes.Structure):
    _fields_ = [(n, _p) for n in ("ys", "res", "h0", "dxp", "part")] + [("reverse", _i)]


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The retained body, ``csrc/gru_scan.cu``."""
    lib = _build.load("gru_scan")
    lib.gru_scan_fwd.argtypes = [_p] * 6 + [_i] * 6 + [_p]
    lib.gru_scan_fwd.restype = _i
    lib.gru_scan_fwd_res.argtypes = [_p] * 7 + [_i] * 6 + [_p]
    lib.gru_scan_fwd_res.restype = _i
    lib.gru_scan_bwd_blocks.argtypes = [_i, _i]
    lib.gru_scan_bwd_blocks.restype = _i
    lib.gru_scan_bwd.argtypes = [_p] * 9 + [_i] * 6 + [_p]
    lib.gru_scan_bwd.restype = _i
    lib.gru_scan_sum_partials.argtypes = [_p, _p, _i, _i, _p]
    lib.gru_scan_sum_partials.restype = _i
    lib.gru_scan_error_string.argtypes = [_i]
    lib.gru_scan_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=None)
def _warp_lib() -> ctypes.CDLL:
    """The warp body, ``csrc/gru_warp.cu``."""
    lib = _build.load("gru_warp")
    lib.gru_warp_fwd_launch.argtypes = [ctypes.POINTER(_FwdDir)] + [_i] * 8 + [_p]
    lib.gru_warp_fwd_launch.restype = _i
    lib.gru_warp_bwd_launch.argtypes = [ctypes.POINTER(_BwdDir)] + [_i] * 7 + [_p]
    lib.gru_warp_bwd_launch.restype = _i
    lib.gru_warp_dwh_blocks.argtypes = [_i, _i]
    lib.gru_warp_dwh_blocks.restype = _i
    lib.gru_warp_dwh_launch.argtypes = [ctypes.POINTER(_DwhDir)] + [_i] * 6 + [_p]
    lib.gru_warp_dwh_launch.restype = _i
    lib.gru_warp_sum_partials.argtypes = [_p, _p, _i, _i, _i, _p]
    lib.gru_warp_sum_partials.restype = _i
    lib.gru_warp_error_string.argtypes = [_i]
    lib.gru_warp_error_string.restype = ctypes.c_char_p
    return lib


def _checked(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    return t.contiguous()


def _raise_on(status: int, what: str, error_string) -> None:
    """Raise with the library's message for a non-zero CUDA status."""
    if status != 0:
        raise RuntimeError(f"{what} launch failed: {error_string(status).decode()}")


def _device_of(xp: torch.Tensor) -> torch.device:
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xp.device}")
    return xp.device


def _validate(H3: int, gate_activation: str, backward: bool) -> Tuple[int, str]:
    """-> (H, the body that runs it)."""
    if gate_activation not in GATES:
        raise ValueError(f"unknown gate_activation {gate_activation!r}")
    H = H3 // 3
    if H3 != 3 * H:
        raise ValueError(f"the gate axis must be 3H, got {H3}")
    return H, gru_body(H, backward)


def _bias(bh: Optional[torch.Tensor], reset_after: bool, xp: torch.Tensor) -> Optional[torch.Tensor]:
    """``bh`` as (3H,); zeros when ``reset_after`` and none is given."""
    H3 = xp.shape[-1]
    if bh is not None:
        return bh.reshape(H3)
    return xp.new_zeros((H3,)) if reset_after else None


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _lead(stack: Optional[int]) -> tuple:
    """The leading shape of stacked operands: (S,), or () unstacked."""
    return () if stack is None else (stack,)


def _fwd(xps: Sequence[torch.Tensor], whs, bhs, h0s, reverses: Sequence[bool],
         reset_after: bool, gate_activation: str, with_res: bool,
         body: Optional[str] = None, stack: Optional[int] = None) -> Tuple[List[tuple], int]:
    """Launch the forward of ``len(xps)`` (1 or 2) directions of one shape on
    the card, on ``body`` (default: `gru_body`'s choice) -> per direction
    ``(ys, res or None, h_last)``, and the number of launches. ``stack``:
    the seed count S of stacked operands (both directions, the warp body),
    None for unstacked ones."""
    dev = xps[0].device
    lead = _lead(stack)
    B, T, H3 = xps[0].shape[-3:]
    H, chosen = _validate(H3, gate_activation, backward=False)
    body = body or chosen
    dirs = []
    for x, wh, bh, h0 in zip(xps, whs, bhs, h0s):
        dirs.append((_checked("xp", x, lead + (B, T, H3), dev),
                     _checked("wh", wh, lead + (H, H3), dev),
                     _checked("bh", bh, lead + (H3,), dev) if reset_after else None,
                     _checked("h0", h0, lead + (B, H), dev)))
    outs = [(torch.empty(lead + (B, T, H), dtype=torch.float32, device=dev),
             torch.empty(lead + (B, T, res_width(reset_after, H)), dtype=torch.float32,
                         device=dev) if with_res else None,
             torch.empty(lead + (B, H), dtype=torch.float32, device=dev)) for _ in dirs]
    if B == 0 or T == 0 or stack == 0:
        for (_, _, _, h0), (_, _, hl) in zip(dirs, outs):
            hl.copy_(h0)
        return outs, 0
    flags = (int(reset_after), int(gate_activation == "hard_sigmoid"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if body == "warp":
            lib = _warp_lib()
            arr = (_FwdDir * len(dirs))(*(
                _FwdDir(x.data_ptr(), wh.data_ptr(), _ptr(bh), h0.data_ptr(), ys.data_ptr(),
                        _ptr(res), hl.data_ptr(), int(rev))
                for (x, wh, bh, h0), (ys, res, hl), rev in zip(dirs, outs, reverses)))
            status = lib.gru_warp_fwd_launch(arr, len(dirs), stack or 1, B, T, H, *flags,
                                             int(with_res), stream)
            _raise_on(status, "gru_warp_fwd", lib.gru_warp_error_string)
            return outs, 1
        if body != "retained":
            raise ValueError(f"unknown GRU body {body!r}")
        if stack is not None:
            raise ValueError("the retained GRU body (H > 32) takes no seed axis")
        lib = _lib()
        for (x, wh, bh, h0), (ys, res, hl), rev in zip(dirs, outs, reverses):
            if with_res:
                status = lib.gru_scan_fwd_res(x.data_ptr(), wh.data_ptr(), _ptr(bh),
                                              h0.data_ptr(), ys.data_ptr(), res.data_ptr(),
                                              hl.data_ptr(), B, T, H, *flags, int(rev), stream)
            else:
                status = lib.gru_scan_fwd(x.data_ptr(), wh.data_ptr(), _ptr(bh), h0.data_ptr(),
                                          ys.data_ptr(), hl.data_ptr(), B, T, H, *flags,
                                          int(rev), stream)
            _raise_on(status, "gru_scan_fwd", lib.gru_scan_error_string)
            gru_scan.retained_launches += 1
    return outs, len(dirs)


def _bwd(ys_s, res_s, whs, h0s, dys_s, dhl_s, reverses: Sequence[bool], reset_after: bool,
         gate_activation: str, body: Optional[str] = None,
         stack: Optional[int] = None) -> List[tuple]:
    """Launch the backward of ``len(ys_s)`` directions of one shape on the
    card -> per direction ``(dxp, dwh, dbh, dh0)``; counts its launches.
    ``stack`` as for `_fwd`."""
    dev = ys_s[0].device
    lead = _lead(stack)
    B, T, H = ys_s[0].shape[-3:]
    _, chosen = _validate(3 * H, gate_activation, backward=True)
    body = body or chosen
    RW = res_width(reset_after, H)
    dirs = [(_checked("ys", ys, lead + (B, T, H), dev),
             _checked("res", res, lead + (B, T, RW), dev),
             _checked("wh", wh, lead + (H, 3 * H), dev), _checked("h0", h0, lead + (B, H), dev),
             _checked("dys", dys, lead + (B, T, H), dev), _checked("dhl", dhl, lead + (B, H), dev))
            for ys, res, wh, h0, dys, dhl in zip(ys_s, res_s, whs, h0s, dys_s, dhl_s)]
    n_dir = len(dirs)
    dxps = [torch.empty(lead + (B, T, 3 * H), dtype=torch.float32, device=dev) for _ in dirs]
    if B == 0 or T == 0 or stack == 0:
        return [(dxp, d[2].new_zeros(lead + (H, 3 * H)), d[2].new_zeros(lead + (3 * H,)),
                 d[5].clone()) for dxp, d in zip(dxps, dirs)]
    dh0s = [torch.empty(lead + (B, H), dtype=torch.float32, device=dev) for _ in dirs]
    n = 3 * H * H + 3 * H
    n_seed = stack or 1
    flags = (int(reset_after), int(gate_activation == "hard_sigmoid"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if body == "warp":
            lib = _warp_lib()
            arr = (_BwdDir * n_dir)(*(
                _BwdDir(*(t.data_ptr() for t in d), dxp.data_ptr(), dh0.data_ptr(), int(rev))
                for d, dxp, dh0, rev in zip(dirs, dxps, dh0s, reverses)))
            status = lib.gru_warp_bwd_launch(arr, n_dir, n_seed, B, T, H, *flags, stream)
            _raise_on(status, "gru_warp_bwd", lib.gru_warp_error_string)
            gru_scan_bwd.launches += 1
            # Partials per (direction, seed), each seed's in block order.
            part = torch.empty((n_dir, n_seed, lib.gru_warp_dwh_blocks(B, T), n),
                               dtype=torch.float32, device=dev)
            arr = (_DwhDir * n_dir)(*(
                _DwhDir(ys.data_ptr(), res.data_ptr(), h0.data_ptr(), dxp.data_ptr(),
                        part[k].data_ptr(), int(rev))
                for k, ((ys, res, _, h0, _, _), dxp, rev) in enumerate(zip(dirs, dxps, reverses))))
            status = lib.gru_warp_dwh_launch(arr, n_dir, n_seed, B, T, H, int(reset_after),
                                             stream)
            _raise_on(status, "gru_warp_dwh", lib.gru_warp_error_string)
            gru_scan_bwd.dwh_launches += 1
            sums = torch.empty((n_dir, n_seed, n), dtype=torch.float32, device=dev)
            status = lib.gru_warp_sum_partials(part.data_ptr(), sums.data_ptr(), n_dir * n_seed,
                                               part.shape[2], n, stream)
            _raise_on(status, "gru_warp_sum_partials", lib.gru_warp_error_string)
            gru_scan_bwd.sum_launches += 1
            if stack is not None:
                return [(dxp, sums[k, :, : 3 * H * H].view(stack, H, 3 * H),
                         sums[k, :, 3 * H * H :], dh0)
                        for k, (dxp, dh0) in enumerate(zip(dxps, dh0s))]
            sums = sums[:, 0]
        elif body == "retained":
            if stack is not None:
                raise ValueError("the retained GRU body (H > 32) takes no seed axis")
            lib = _lib()
            part = torch.empty((lib.gru_scan_bwd_blocks(H, B), n), dtype=torch.float32,
                               device=dev)
            sums = torch.empty((n_dir, n), dtype=torch.float32, device=dev)
            for k, (d, dxp, dh0, rev) in enumerate(zip(dirs, dxps, dh0s, reverses)):
                status = lib.gru_scan_bwd(*(t.data_ptr() for t in d), dxp.data_ptr(),
                                          dh0.data_ptr(), part.data_ptr(), B, T, H, *flags,
                                          int(rev), stream)
                _raise_on(status, "gru_scan_bwd", lib.gru_scan_error_string)
                gru_scan_bwd.launches += 1
                gru_scan.retained_launches += 1
                status = lib.gru_scan_sum_partials(part.data_ptr(), sums[k].data_ptr(),
                                                   part.shape[0], n, stream)
                _raise_on(status, "gru_scan_sum_partials", lib.gru_scan_error_string)
                gru_scan_bwd.sum_launches += 1
        else:
            raise ValueError(f"unknown GRU body {body!r}")
    return [(dxp, sums[k, : 3 * H * H].view(H, 3 * H), sums[k, 3 * H * H :], dh0)
            for k, (dxp, dh0) in enumerate(zip(dxps, dh0s))]


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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
    residual forward and the backward kernels). Otherwise, for a CUDA tensor
    the forward kernel of `gru_body`'s body, for a CPU tensor `gru_scan_plain`."""
    bh = _bias(bh, reset_after, xp)
    if _needs_grad(xp, wh, bh, h0):
        return GruScanFn.apply(xp, wh, bh, h0, reset_after, gate_activation, reverse)
    if _device_of(xp).type == "cpu":
        return gru_scan_plain(xp, wh, bh, h0, reset_after, gate_activation, reverse)
    (out,), n = _fwd([xp], [wh], [bh], [h0], [reverse], reset_after, gate_activation, False)
    gru_scan.launches += n
    return out[0], out[2]


gru_scan.launches = 0
gru_scan.retained_launches = 0


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
    if _device_of(xp).type == "cpu":
        return gru_scan_fwd_res_plain(xp, wh, bh, h0, reset_after, gate_activation, reverse)
    (out,), n = _fwd([xp], [wh], [bh], [h0], [reverse], reset_after, gate_activation, True)
    gru_scan_fwd_res.launches += n
    return out


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
    backward kernels (the chain, then on the warp body the ``dwh``
    reduction, then the fixed-order partial sum); CPU tensor:
    `gru_scan_bwd_plain`."""
    if _device_of(ys).type == "cpu":
        return gru_scan_bwd_plain(ys, res, wh, h0, dys, dhl, reset_after,
                                  gate_activation, reverse)
    (out,) = _bwd([ys], [res], [wh], [h0], [dys], [dhl], [reverse], reset_after,
                  gate_activation)
    return out


gru_scan_bwd.launches = 0
gru_scan_bwd.dwh_launches = 0
gru_scan_bwd.sum_launches = 0


def _pair_bias(bh: Sequence[Optional[torch.Tensor]], reset_after: bool, xp: Pair):
    return tuple(_bias(b, reset_after, x) for b, x in zip(bh, xp))


def _check_pair(xp: Pair) -> torch.device:
    dev = _device_of(xp[0])
    if len(xp) != 2 or xp[1].device != dev or xp[1].shape != xp[0].shape:
        raise ValueError("a pair needs two directions of one shape on one device")
    return dev


def gru_scan_pair(
    xp: Pair,
    wh: Pair,
    bh: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    h0: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[Pair, Pair]:
    """Both directions of a BiGRU, each argument a (forward-in-time,
    reversed) pair -> ``((ys_f, h_last_f), (ys_b, h_last_b))``.

    With grad enabled and an input that requires grad: `GruScanPairFn`.
    Otherwise, for CUDA tensors one launch of the warp body (two of the
    retained one), for CPU tensors two `gru_scan_plain` runs."""
    bh = _pair_bias(bh, reset_after, xp)
    if _needs_grad(*xp, *wh, *bh, *h0):
        ys_f, ys_b, hl_f, hl_b = GruScanPairFn.apply(*xp, *wh, *bh, *h0, reset_after,
                                                     gate_activation)
        return (ys_f, hl_f), (ys_b, hl_b)
    if _check_pair(xp).type == "cpu":
        return tuple(gru_scan_plain(x, w, b, h, reset_after, gate_activation, rev)
                     for x, w, b, h, rev in zip(xp, wh, bh, h0, (False, True)))
    outs, n = _fwd(xp, wh, bh, h0, (False, True), reset_after, gate_activation, False)
    gru_scan.launches += n
    return tuple((ys, hl) for ys, _, hl in outs)


def gru_scan_pair_fwd_res(
    xp: Pair,
    wh: Pair,
    bh: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    h0: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[tuple, tuple]:
    """`gru_scan_fwd_res` of both directions -> ``((ys, res, h_last) forward,
    (ys, res, h_last) reversed)``; counted in ``gru_scan_fwd_res.launches``."""
    bh = _pair_bias(bh, reset_after, xp)
    if _check_pair(xp).type == "cpu":
        return tuple(gru_scan_fwd_res_plain(x, w, b, h, reset_after, gate_activation, rev)
                     for x, w, b, h, rev in zip(xp, wh, bh, h0, (False, True)))
    outs, n = _fwd(xp, wh, bh, h0, (False, True), reset_after, gate_activation, True)
    gru_scan_fwd_res.launches += n
    return tuple(outs)


def gru_scan_pair_bwd(
    ys: Pair,
    res: Pair,
    wh: Pair,
    h0: Pair,
    dys: Pair,
    dhl: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[tuple, tuple]:
    """`gru_scan_bwd` of both directions -> ``((dxp, dwh, dbh, dh0) forward,
    (...) reversed)``: on the warp body one launch each of the chain, the
    ``dwh`` reduction and the partial sum."""
    if _check_pair(ys).type == "cpu":
        return tuple(gru_scan_bwd_plain(*a, reset_after, gate_activation, rev)
                     for *a, rev in zip(ys, res, wh, h0, dys, dhl, (False, True)))
    return tuple(_bwd(ys, res, wh, h0, dys, dhl, (False, True), reset_after, gate_activation))


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


def _bigru_function(name: str, fwd_res: Callable, bwd: Callable, doc: str):
    """A `torch.autograd.Function` over both directions of a BiGRU: forward
    ``fwd_res``, saving what ``bwd`` takes. Arguments ``(xp_f, xp_b, wh_f,
    wh_b, bh_f, bh_b, h0_f, h0_b, reset_after, gate_activation)``, outputs
    ``(ys_f, ys_b, h_last_f, h_last_b)``; the same rules for absent
    cotangents and biases as `GruScanFn`."""

    def forward(ctx, xp_f, xp_b, wh_f, wh_b, bh_f, bh_b, h0_f, h0_b, reset_after,
                gate_activation):
        (ys_f, res_f, hl_f), (ys_b, res_b, hl_b) = fwd_res(
            (xp_f, xp_b), (wh_f, wh_b), (bh_f, bh_b), (h0_f, h0_b), reset_after,
            gate_activation)
        ctx.save_for_backward(ys_f, ys_b, res_f, res_b, wh_f, wh_b, h0_f, h0_b)
        ctx.conf = (reset_after, gate_activation)
        ctx.has_bh = (bh_f is not None, bh_b is not None)
        ctx.set_materialize_grads(False)
        return ys_f, ys_b, hl_f, hl_b

    def backward(ctx, dys_f, dys_b, dhl_f, dhl_b):
        ys_f, ys_b, res_f, res_b, wh_f, wh_b, h0_f, h0_b = ctx.saved_tensors

        def cot(g, like):
            return torch.zeros_like(like) if g is None else g.contiguous()

        grads = bwd(
            (ys_f, ys_b), (res_f, res_b), (wh_f, wh_b), (h0_f, h0_b),
            (cot(dys_f, ys_f), cot(dys_b, ys_b)), (cot(dhl_f, h0_f), cot(dhl_b, h0_b)),
            *ctx.conf)
        (dxp_f, dwh_f, dbh_f, dh0_f), (dxp_b, dwh_b, dbh_b, dh0_b) = grads
        return (dxp_f, dxp_b, dwh_f, dwh_b, dbh_f if ctx.has_bh[0] else None,
                dbh_b if ctx.has_bh[1] else None, dh0_f, dh0_b, None, None)

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward), "__doc__": doc})


GruScanPairFn = _bigru_function(
    "GruScanPairFn", gru_scan_pair_fwd_res, gru_scan_pair_bwd,
    """`GruScanFn` for both directions of a BiGRU at once: forward
    `gru_scan_pair_fwd_res`, backward `gru_scan_pair_bwd`.""")


# --- S BiGRUs of one shape at once (stacked multi-seed training) ---------------

def _check_stack(xp: Pair) -> Tuple[torch.device, int]:
    dev = _check_pair(xp)
    if xp[0].dim() != 4:
        raise ValueError(f"stacked operands need a leading seed axis, got xp {tuple(xp[0].shape)}")
    return dev, xp[0].shape[0]


def _stack_bias(bh, reset_after: bool, xp: Pair):
    """Each direction's ``bh`` as (S, 3H); zeros when ``reset_after`` and none
    is given."""
    S, _, _, H3 = xp[0].shape
    return tuple((b.reshape(S, H3) if b is not None
                  else x.new_zeros((S, H3)) if reset_after else None) for b, x in zip(bh, xp))


def _seedwise(fn: Callable, *stacked) -> tuple:
    """``fn`` on every seed's slice of the stacked arguments (None passes
    through), its results stacked along a new seed axis."""
    S = stacked[0].shape[0]
    outs = [fn(*(None if a is None else a[s] for a in stacked)) for s in range(S)]
    return tuple(torch.stack(r) for r in zip(*outs))


def gru_scan_stack(
    xp: Pair,
    wh: Pair,
    bh: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    h0: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[Pair, Pair]:
    """Both directions of S BiGRUs, each argument a (forward-in-time,
    reversed) pair of stacked tensors ``xp (S, B, T, 3H)``, ``wh (S, H, 3H)``,
    ``bh (S, 3H)`` or None, ``h0 (S, B, H)`` -> ``((ys_f, h_last_f), (ys_b,
    h_last_b))`` of shapes (S, B, T, H) and (S, B, H).

    With grad enabled and an input that requires grad: `GruScanStackFn`.
    Otherwise, for CUDA tensors one launch of the warp body for every seed and
    direction, for CPU tensors `gru_scan_plain` seed by seed."""
    dev, S = _check_stack(xp)
    bh = _stack_bias(bh, reset_after, xp)
    if _needs_grad(*xp, *wh, *bh, *h0):
        ys_f, ys_b, hl_f, hl_b = GruScanStackFn.apply(*xp, *wh, *bh, *h0, reset_after,
                                                      gate_activation)
        return (ys_f, hl_f), (ys_b, hl_b)
    if dev.type == "cpu":
        return tuple(_seedwise(lambda x_, w_, b_, h_: gru_scan_plain(
            x_, w_, b_, h_, reset_after, gate_activation, rev), x, w, b, h)
            for x, w, b, h, rev in zip(xp, wh, bh, h0, (False, True)))
    outs, n = _fwd(xp, wh, bh, h0, (False, True), reset_after, gate_activation, False,
                   stack=S)
    gru_scan.launches += n
    return tuple((ys, hl) for ys, _, hl in outs)


def gru_scan_stack_fwd_res(
    xp: Pair,
    wh: Pair,
    bh: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    h0: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[tuple, tuple]:
    """`gru_scan_pair_fwd_res` of S stacked BiGRUs -> per direction ``(ys,
    res, h_last)`` with a leading seed axis; one launch on the card, counted
    in ``gru_scan_fwd_res.launches``."""
    dev, S = _check_stack(xp)
    bh = _stack_bias(bh, reset_after, xp)
    if dev.type == "cpu":
        return tuple(_seedwise(lambda x_, w_, b_, h_: gru_scan_fwd_res_plain(
            x_, w_, b_, h_, reset_after, gate_activation, rev), x, w, b, h)
            for x, w, b, h, rev in zip(xp, wh, bh, h0, (False, True)))
    outs, n = _fwd(xp, wh, bh, h0, (False, True), reset_after, gate_activation, True, stack=S)
    gru_scan_fwd_res.launches += n
    return tuple(outs)


def gru_scan_stack_bwd(
    ys: Pair,
    res: Pair,
    wh: Pair,
    h0: Pair,
    dys: Pair,
    dhl: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[tuple, tuple]:
    """`gru_scan_pair_bwd` of S stacked BiGRUs -> per direction ``(dxp, dwh,
    dbh, dh0)`` with a leading seed axis: on the card one launch each of the
    chain, the ``dwh`` reduction and the partial sum for all seeds; each
    seed's ``dwh`` summed in the same fixed order as alone."""
    dev, S = _check_stack(ys)
    if dev.type == "cpu":
        return tuple(_seedwise(lambda *a: gru_scan_bwd_plain(*a, reset_after, gate_activation,
                                                             rev), *args)
                     for *args, rev in zip(ys, res, wh, h0, dys, dhl, (False, True)))
    return tuple(_bwd(ys, res, wh, h0, dys, dhl, (False, True), reset_after, gate_activation,
                      stack=S))


GruScanStackFn = _bigru_function(
    "GruScanStackFn", gru_scan_stack_fwd_res, gru_scan_stack_bwd,
    """`GruScanPairFn` over stacked operands: forward `gru_scan_stack_fwd_res`,
    backward `gru_scan_stack_bwd`, every tensor with a leading seed axis.""")
