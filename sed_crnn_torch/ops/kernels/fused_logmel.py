"""Fused log-mel: the CUDA kernel (``csrc/fused_logmel.cu``) and its plain
PyTorch versions.

The JAX package's `ops/pallas/fused_logmel.py` has three TPU kernels; one
CUDA body with two formulations replaces them, each in float32:

* DIF, the radix-2 decimation in frequency (JAX ``_kernel_dif_chunked`` and
  ``_kernel_dif``): frame t's halves ``a``, ``b`` read at ``src[t*stride + k]``
  and ``src[t*stride + M + k]`` (``M = n_fft / 2``); ``s = wa*a + wb*b``
  gives the even DFT bins through an M-point real DFT, ``d = wa*a - wb*b``
  the odd bins through the half-bin-shifted DFT; then power, the mel product
  (the even/odd split folded into the mel rows), the optional floor and the
  log;
* direct (JAX ``_kernel_exact``): the raw frame against the window-folded
  bases of the full n_fft-point DFT, then the same power, mel, floor, log.

Modes, renamed from the JAX package's (as `core/config.py` renames the
backends): ``"dif"`` is the JAX ``"bf16x3"`` (the TPU ran the DIF products
as bf16x3; here they are float32 FMAs) and ``"exact"`` keeps its name.
Dispatch follows the JAX ``fused_log_mel`` / ``fused_log_mel_frames``:

* ``"chunked"``: mode ``"dif"``, ``hop * 2 == n_fft``, ``n_fft % 4 == 0`` and
  a signal of at least ``n_fft`` samples: stride ``M`` on the (padded)
  waveform, frame t is hop rows t and t+1;
* ``"framed"``: mode ``"dif"`` otherwise (any hop, short signals): stride
  ``hop`` on the padded waveform, or ``n_fft`` on a frame matrix;
* ``"exact"``: mode ``"exact"``, or any ``n_fft % 4 != 0`` (the DIF split
  needs an even half length).

`fused_log_mel` and `fused_log_mel_frames` launch the kernel for a CUDA
tensor and run the plain version only for a CPU tensor. Launches are counted
per route on `fused_log_mel`: ``launches`` (chunked), ``framed_launches``
and ``exact_launches``, whichever of the two wrappers launched.
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
from sed_crnn_torch.ops.stft import dft_bases, hann_window, reflect_pad

BIN_TILE = 64     # csrc/fused_logmel.cu TB: bins per tile
FRAME_TILE = 64   # csrc/fused_logmel.cu TF: frames per block
MAX_MELS = 256    # keeps the block's shared memory under the card's limit
MODES = ("dif", "exact")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def dif_operands(sr: int, n_fft: int, n_mels: int, fmin: float, fmax) -> dict:
    """Window halves, packed sub-DFT bases and mel rows, built in float64.

    ``bc``/``bs`` are (M, NB): the cos and -sin bases of the even bins in
    columns [0, n_even) and of the odd (half-bin-shifted) bins in columns
    [ne_pad, ne_pad + n_odd), every other column zero. ``melw`` (NB, n_mels)
    holds ``fb[:, 0::2].T`` and ``fb[:, 1::2].T`` in the matching rows, so
    padded columns contribute nothing.
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
        "bc": bc, "bs": bs, "melw": melw, "n_even_tiles": ne_pad // BIN_TILE,
    }


def exact_operands(sr: int, n_fft: int, n_mels: int, fmin: float, fmax) -> dict:
    """The direct formulation's operands (the JAX ``_padded_operands``):
    window-folded cos / -sin bases of the full DFT, ``(n_fft, NB)``, and the
    transposed mel filterbank ``(NB, n_mels)``, the bin axis padded with
    zeros to a multiple of the 64-bin tile (1025 -> 1088), so padded bins
    contribute nothing. Every tile counts as "even": no DIF split."""
    n_bins = 1 + n_fft // 2
    nb = _round_up(n_bins, BIN_TILE)
    cos_b, sin_b = dft_bases(n_fft, windowed=True)                 # (n_fft, n_bins)
    bc = np.zeros((n_fft, nb), np.float32)
    bs = np.zeros((n_fft, nb), np.float32)
    bc[:, :n_bins], bs[:, :n_bins] = cos_b, sin_b
    melw = np.zeros((nb, n_mels), np.float32)
    melw[:n_bins] = mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T
    return {"bc": bc, "bs": bs, "melw": melw, "n_even_tiles": nb // BIN_TILE}


@lru_cache(maxsize=8)
def _device_operands(sr, n_fft, n_mels, fmin, fmax, direct: bool, device: str) -> dict:
    """The operands on ``device``, built on the host and cached only here:
    the cached tensors are shared, read only."""
    ops = (exact_operands if direct else dif_operands)(sr, n_fft, n_mels, fmin, fmax)
    return {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
            for k, v in ops.items()}


def _operands(cfg: FrontendConfig, n_fft: int, direct: bool, device: torch.device) -> dict:
    return _device_operands(cfg.sample_rate, n_fft, cfg.n_mels, cfg.fmin, cfg.fmax,
                            direct, str(device))


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown fused log-mel mode {mode!r}; expected one of {MODES}")


def route(n_samples: int, cfg: FrontendConfig, mode: str = "dif") -> str:
    """Which formulation and frame source `fused_log_mel` takes for a signal
    of ``n_samples`` (before centre padding): ``"chunked"``, ``"framed"`` or
    ``"exact"``."""
    _check_mode(mode)
    if mode == "exact" or cfg.n_fft % 4:
        return "exact"
    if cfg.hop_length * 2 == cfg.n_fft and n_samples >= cfg.n_fft:
        return "chunked"
    return "framed"


def frame_source(y: torch.Tensor, cfg: FrontendConfig) -> Tuple[torch.Tensor, int]:
    """The (centre-padded) contiguous waveform and its frame count: frame t
    is ``n_fft`` samples from ``t * hop``, as `stft.frame_signal` cuts it."""
    if y.ndim != 1:
        raise ValueError(f"expected a 1-D waveform, got shape {tuple(y.shape)}")
    if cfg.center:
        y = reflect_pad(y, cfg.n_fft // 2)
    if y.shape[0] < cfg.n_fft:
        raise ValueError(f"signal length {y.shape[0]} < n_fft {cfg.n_fft}")
    return y.contiguous(), 1 + (y.shape[0] - cfg.n_fft) // cfg.hop_length


def _finish(mel: torch.Tensor, log_floor) -> torch.Tensor:
    if log_floor is not None:
        mel = torch.clamp_min(mel, log_floor)
    return torch.log(mel)


def _plain(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
           cfg: FrontendConfig, direct: bool) -> torch.Tensor:
    """The kernel's arithmetic in float32 PyTorch ops, frames read from the
    flat ``src`` at ``t * stride`` as the kernel reads them."""
    ops = _operands(cfg, n_fft, direct, src.device)
    base = src.storage_offset()
    if direct:
        fr = src.as_strided((n_frames, n_fft), (stride, 1), base)
        re, im = fr @ ops["bc"], fr @ ops["bs"]
        return _finish((re * re + im * im) @ ops["melw"], cfg.log_floor)
    M = n_fft // 2
    ne = ops["n_even_tiles"] * BIN_TILE
    ya = ops["wa"] * src.as_strided((n_frames, M), (stride, 1), base)
    yb = ops["wb"] * src.as_strided((n_frames, M), (stride, 1), base + M)
    s, d = ya + yb, ya - yb
    e_re, e_im = s @ ops["bc"][:, :ne], s @ ops["bs"][:, :ne]
    d_re, d_im = d @ ops["bc"][:, ne:], d @ ops["bs"][:, ne:]
    power = torch.cat([e_re * e_re + e_im * e_im, d_re * d_re + d_im * d_im], dim=1)
    return _finish(power @ ops["melw"], cfg.log_floor)


def fused_log_mel_plain(y: torch.Tensor, cfg: FrontendConfig, mode: str = "dif") -> torch.Tensor:
    """1-D waveform -> ``(n_frames, n_mels)`` log mel energies by the route
    `fused_log_mel` takes, in plain float32 PyTorch ops."""
    r = route(y.shape[0], cfg, mode)
    src, n_frames = frame_source(y.to(torch.float32), cfg)
    return _plain(src, cfg.hop_length, n_frames, cfg.n_fft, cfg, r == "exact")


def _frame_matrix(frames: torch.Tensor, mode: str) -> Tuple[torch.Tensor, int, int, bool]:
    """A frame matrix as the flat source read at stride n_fft, its frame
    count and n_fft, and whether it takes the direct formulation."""
    _check_mode(mode)
    if frames.ndim != 2 or frames.shape[0] == 0:
        raise ValueError(f"expected (n_frames, n_fft) frames, got {tuple(frames.shape)}")
    n_frames, n_fft = frames.shape
    return frames.contiguous().view(-1), n_frames, n_fft, mode == "exact" or n_fft % 4 != 0


def fused_log_mel_frames_plain(frames: torch.Tensor, cfg: FrontendConfig,
                               mode: str = "dif") -> torch.Tensor:
    """``(n_frames, n_fft)`` frames -> ``(n_frames, n_mels)`` log mel energies,
    in plain float32 PyTorch ops (DIF, or direct for mode ``"exact"`` and
    ``n_fft % 4 != 0``)."""
    src, n_frames, n_fft, direct = _frame_matrix(frames.to(torch.float32), mode)
    return _plain(src, n_fft, n_frames, n_fft, cfg, direct)


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
    lib.fused_logmel.argtypes = ([p] * 8 + [i, i, ctypes.c_longlong] + [i] * 6
                                 + [ctypes.c_float, p])
    lib.fused_logmel.restype = i
    lib.fused_logmel_tile_bins.argtypes = []
    lib.fused_logmel_tile_bins.restype = i
    lib.fused_logmel_error_string.argtypes = [i]
    lib.fused_logmel_error_string.restype = ctypes.c_char_p
    if lib.fused_logmel_tile_bins() != BIN_TILE:
        raise RuntimeError("csrc/fused_logmel.cu tile width differs from BIN_TILE")
    return lib


def _check_cuda(x: torch.Tensor, cfg: FrontendConfig) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32 samples, got {x.dtype}")
    if not 0 < cfg.n_mels <= MAX_MELS:
        raise ValueError(f"n_mels must be in [1, {MAX_MELS}], got {cfg.n_mels}")


def _launch(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
            cfg: FrontendConfig, direct: bool) -> torch.Tensor:
    """One launch over frames ``src[t*stride : t*stride + n_fft]``."""
    if src.ndim != 1 or not src.is_contiguous():
        raise ValueError("the frame source must be a contiguous 1-D tensor")
    if n_frames <= 0 or (n_frames - 1) * stride + n_fft > src.shape[0]:
        raise ValueError(f"{n_frames} frames of {n_fft} at stride {stride} overrun "
                         f"{src.shape[0]} samples")
    dev = src.device
    ops = _operands(cfg, n_fft, direct, dev)
    nb = ops["bc"].shape[1]
    out = torch.empty((n_frames, cfg.n_mels), dtype=torch.float32, device=dev)
    groups = _n_groups(n_frames, nb // BIN_TILE, dev)
    partial = (torch.empty((groups, n_frames, cfg.n_mels), dtype=torch.float32, device=dev)
               if groups > 1 else out)
    lib = _lib()
    use_floor = cfg.log_floor is not None
    window = (None, None) if direct else (ops["wa"].data_ptr(), ops["wb"].data_ptr())
    with torch.cuda.device(dev):
        status = lib.fused_logmel(
            src.data_ptr(), *window, ops["bc"].data_ptr(), ops["bs"].data_ptr(),
            ops["melw"].data_ptr(), partial.data_ptr(), out.data_ptr(),
            n_frames, n_fft if direct else n_fft // 2, stride, nb, ops["n_even_tiles"],
            cfg.n_mels, groups, int(direct), int(use_floor),
            float(cfg.log_floor) if use_floor else 0.0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"fused_logmel launch failed: {lib.fused_logmel_error_string(status).decode()}"
        )
    return out


def _count(r: str) -> None:
    if r == "chunked":
        fused_log_mel.launches += 1
    elif r == "framed":
        fused_log_mel.framed_launches += 1
    else:
        fused_log_mel.exact_launches += 1


def fused_log_mel(y: torch.Tensor, cfg: FrontendConfig, mode: str = "dif") -> torch.Tensor:
    """1-D float32 waveform -> ``(n_frames, n_mels)`` log mel energies.
    CUDA tensor: the kernel, by the route `route` names; CPU tensor:
    `fused_log_mel_plain`."""
    if y.device.type == "cpu":
        return fused_log_mel_plain(y, cfg, mode)
    _check_cuda(y, cfg)
    r = route(y.shape[0], cfg, mode)
    src, n_frames = frame_source(y, cfg)
    out = _launch(src, cfg.hop_length, n_frames, cfg.n_fft, cfg, r == "exact")
    _count(r)
    return out


def fused_log_mel_frames(frames: torch.Tensor, cfg: FrontendConfig,
                         mode: str = "dif") -> torch.Tensor:
    """``(n_frames, n_fft)`` float32 frames -> ``(n_frames, n_mels)`` log mel
    energies (the JAX ``fused_log_mel_frames``). CUDA tensor: the kernel at
    stride ``n_fft``; CPU tensor: `fused_log_mel_frames_plain`."""
    if frames.device.type == "cpu":
        return fused_log_mel_frames_plain(frames, cfg, mode)
    _check_cuda(frames, cfg)
    src, n_frames, n_fft, direct = _frame_matrix(frames, mode)
    out = _launch(src, n_fft, n_frames, n_fft, cfg, direct)
    _count("exact" if direct else "framed")
    return out


fused_log_mel.launches = 0
fused_log_mel.framed_launches = 0
fused_log_mel.exact_launches = 0
