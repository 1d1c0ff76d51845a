"""Fused log-mel: the CUDA kernel (``csrc/fused_logmel.cu``) and its plain
PyTorch version.

Both compute the radix-2 decimation-in-frequency formulation of the JAX
package's `ops/pallas/fused_logmel.py::_kernel_dif_chunked`, in float32:
frame t is rows t and t+1 of the hop-row view of the (padded) waveform;
``s = wa*a + wb*b`` gives the even DFT bins through an M-point real DFT,
``d = wa*a - wb*b`` the odd bins through the half-bin-shifted DFT; then
power, the mel product (the even/odd split folded into the mel rows), the
optional floor and the log.

`fused_log_mel` launches the kernel for a CUDA tensor and runs
`fused_log_mel_plain` only for a CPU tensor. It takes the 50%-overlap
configurations (``hop * 2 == n_fft``, ``n_fft % 4 == 0``), which every
preset uses; the JAX package's framed and exact kernels are not ported yet.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.mel import mel_filterbank
from sed_crnn_torch.ops.stft import hann_window, reflect_pad

BIN_TILE = 64     # csrc/fused_logmel.cu TB: bins per tile
FRAME_TILE = 64   # csrc/fused_logmel.cu TF: frames per block
MAX_MELS = 256    # keeps the block's shared memory under the card's limit


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@lru_cache(maxsize=8)
def dif_operands(sr: int, n_fft: int, n_mels: int, fmin: float, fmax) -> dict:
    """Window halves, packed sub-DFT bases and mel rows, built in float64.

    ``bc``/``bs`` are (M, NB): the cos and -sin bases of the even bins in
    columns [0, n_even) and of the odd (half-bin-shifted) bins in columns
    [ne_pad, ne_pad + n_odd), every other column zero. ``melw`` (NB, n_mels)
    holds ``fb[:, 0::2].T`` and ``fb[:, 1::2].T`` in the matching rows, so
    padded columns contribute nothing. Cached arrays are shared: read only.
    """
    M = n_fft // 2
    n_even, n_odd = M // 2 + 1, M // 2
    ne_pad = _round_up(n_even, BIN_TILE)
    nb = ne_pad + _round_up(n_odd, BIN_TILE)
    k = np.arange(M, dtype=np.float64)[:, None]
    ang_e = 2.0 * np.pi * k * np.arange(n_even, dtype=np.float64)[None, :] / M
    ang_o = 2.0 * np.pi * k * (np.arange(n_odd, dtype=np.float64)[None, :] + 0.5) / M
    bc = np.zeros((M, nb), np.float32)
    bs = np.zeros((M, nb), np.float32)
    bc[:, :n_even], bs[:, :n_even] = np.cos(ang_e), -np.sin(ang_e)
    bc[:, ne_pad : ne_pad + n_odd], bs[:, ne_pad : ne_pad + n_odd] = np.cos(ang_o), -np.sin(ang_o)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)            # (n_mels, bins)
    melw = np.zeros((nb, n_mels), np.float32)
    melw[:n_even] = fb.T[0::2]
    melw[ne_pad : ne_pad + n_odd] = fb.T[1::2]
    w = hann_window(n_fft, np.float64)
    return {
        "wa": w[:M].astype(np.float32), "wb": w[M:].astype(np.float32),
        "bc": bc, "bs": bs, "melw": melw, "ne_pad": ne_pad,
    }


@lru_cache(maxsize=8)
def _device_operands(sr, n_fft, n_mels, fmin, fmax, device: str) -> dict:
    ops = dif_operands(sr, n_fft, n_mels, fmin, fmax)
    return {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
            for k, v in ops.items()}


def _operands(cfg: FrontendConfig, device: torch.device) -> dict:
    return _device_operands(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                            cfg.fmax, str(device))


def frame_rows(y: torch.Tensor, cfg: FrontendConfig) -> Tuple[torch.Tensor, int]:
    """(Padded) waveform as hop-sized rows ``(n_frames + 1, hop)`` plus the
    frame count; frame t is rows t and t+1. A view, no copy, when uncentered."""
    if cfg.hop_length * 2 != cfg.n_fft or cfg.n_fft % 4:
        raise NotImplementedError(
            "the fused log-mel kernel takes hop * 2 == n_fft with n_fft % 4 == 0; "
            "the framed and exact variants are not yet ported"
        )
    if y.ndim != 1:
        raise ValueError(f"expected a 1-D waveform, got shape {tuple(y.shape)}")
    n_fft, hop = cfg.n_fft, cfg.hop_length
    if cfg.center:
        if y.shape[0] <= n_fft // 2:
            raise ValueError(f"centered framing needs more than {n_fft // 2} samples")
        y = reflect_pad(y, n_fft // 2)
    if y.shape[0] < n_fft:
        raise ValueError(f"signal length {y.shape[0]} < n_fft {n_fft}")
    n_frames = 1 + (y.shape[0] - n_fft) // hop
    # (n_frames - 1) * hop + n_fft <= len and n_fft == 2 * hop, so the
    # n_frames + 1 rows always lie inside the signal.
    return y[: (n_frames + 1) * hop].contiguous().view(n_frames + 1, hop), n_frames


def _finish(mel: torch.Tensor, log_floor) -> torch.Tensor:
    if log_floor is not None:
        mel = torch.clamp_min(mel, log_floor)
    return torch.log(mel)


def fused_log_mel_plain(y: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The kernel's arithmetic in float32 PyTorch ops: 1-D waveform ->
    ``(n_frames, n_mels)`` log mel energies."""
    rows, n_frames = frame_rows(y.to(torch.float32), cfg)
    ops = _operands(cfg, rows.device)
    ne = ops["ne_pad"]
    ya = ops["wa"] * rows[:n_frames]
    yb = ops["wb"] * rows[1 : n_frames + 1]
    s, d = ya + yb, ya - yb
    e_re, e_im = s @ ops["bc"][:, :ne], s @ ops["bs"][:, :ne]
    d_re, d_im = d @ ops["bc"][:, ne:], d @ ops["bs"][:, ne:]
    power = torch.cat([e_re * e_re + e_im * e_im, d_re * d_re + d_im * d_im], dim=1)
    return _finish(power @ ops["melw"], cfg.log_floor)


def _n_groups(n_frames: int, n_bin_tiles: int, device: torch.device) -> int:
    """Bin-tile groups per frame tile: enough blocks for two per SM."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    frame_tiles = -(-n_frames // FRAME_TILE)
    g = min(n_bin_tiles, max(1, -(-2 * n_sm // frame_tiles)))
    per = -(-n_bin_tiles // g)
    return -(-n_bin_tiles // per)


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_logmel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_logmel.argtypes = [p] * 8 + [i] * 7 + [ctypes.c_float, p]
    lib.fused_logmel.restype = i
    lib.fused_logmel_tile_bins.argtypes = []
    lib.fused_logmel_tile_bins.restype = i
    lib.fused_logmel_error_string.argtypes = [i]
    lib.fused_logmel_error_string.restype = ctypes.c_char_p
    if lib.fused_logmel_tile_bins() != BIN_TILE:
        raise RuntimeError("csrc/fused_logmel.cu tile width differs from BIN_TILE")
    return lib


def fused_log_mel(y: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """1-D float32 waveform -> ``(n_frames, n_mels)`` log mel energies.
    CUDA tensor: the kernel; CPU tensor: `fused_log_mel_plain`."""
    if y.device.type == "cpu":
        return fused_log_mel_plain(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype != torch.float32:
        raise TypeError(f"expected a float32 waveform, got {y.dtype}")
    if not 0 < cfg.n_mels <= MAX_MELS:
        raise ValueError(f"n_mels must be in [1, {MAX_MELS}], got {cfg.n_mels}")
    rows, n_frames = frame_rows(y, cfg)
    ops = _operands(cfg, rows.device)
    nb = ops["bc"].shape[1]
    out = torch.empty((n_frames, cfg.n_mels), dtype=torch.float32, device=rows.device)
    groups = _n_groups(n_frames, nb // BIN_TILE, rows.device)
    partial = (torch.empty((groups, n_frames, cfg.n_mels), dtype=torch.float32,
                           device=rows.device) if groups > 1 else out)
    lib = _lib()
    use_floor = cfg.log_floor is not None
    with torch.cuda.device(rows.device):
        status = lib.fused_logmel(
            rows.data_ptr(), ops["wa"].data_ptr(), ops["wb"].data_ptr(),
            ops["bc"].data_ptr(), ops["bs"].data_ptr(), ops["melw"].data_ptr(),
            partial.data_ptr(), out.data_ptr(),
            n_frames, cfg.hop_length, nb, ops["ne_pad"] // BIN_TILE, cfg.n_mels,
            groups, int(use_floor), float(cfg.log_floor) if use_floor else 0.0,
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"fused_logmel launch failed: {lib.fused_logmel_error_string(status).decode()}"
        )
    fused_log_mel.launches += 1
    return out


fused_log_mel.launches = 0
