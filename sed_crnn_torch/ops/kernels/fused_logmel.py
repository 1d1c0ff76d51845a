"""Fused log-mel: the CUDA kernels (``csrc/logmel_fft.cu`` and
``csrc/fused_logmel.cu``) and their plain PyTorch versions.

The JAX package's `ops/pallas/fused_logmel.py` has three TPU kernels, which
all compute one function: windowed real DFT, power, mel, floor, log. Two
CUDA bodies replace them, each in float32, chosen by `body` from ``n_fft``:

* ``"fft"`` (``csrc/logmel_fft.cu``), every power-of-two ``n_fft`` from 256
  to 16384, whatever the route: the frame windowed on load and packed as
  ``n_fft / 2`` complex points, a radix-4 Stockham FFT in shared memory, the
  real-to-complex untangle, power, the mel filterbank as CSR rows, floor,
  log. `fft_log_mel_plain` repeats its arithmetic operation by operation;
* ``"dft"`` (``csrc/fused_logmel.cu``), any other ``n_fft``, in two
  formulations:

  - DIF, the radix-2 decimation in frequency (JAX ``_kernel_dif_chunked``
    and ``_kernel_dif``): frame t's halves ``a``, ``b`` read at
    ``src[t*stride + k]`` and ``src[t*stride + M + k]`` (``M = n_fft / 2``);
    ``s = wa*a + wb*b`` gives the even DFT bins through an M-point real DFT,
    ``d = wa*a - wb*b`` the odd bins through the half-bin-shifted DFT; then
    power, the mel product (the even/odd split folded into the mel rows),
    the optional floor and the log;
  - direct (JAX ``_kernel_exact``): the raw frame against the
    window-folded bases of the full n_fft-point DFT, then the same power,
    mel, floor, log.

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

`fused_log_mel` and `fused_log_mel_frames` launch a kernel for a CUDA
tensor and run the DIF / direct plain version only for a CPU tensor (the
function the JAX kernels compute, as the JAX package runs it). Launches are
counted per route on `fused_log_mel`: ``launches`` (chunked),
``framed_launches`` and ``exact_launches``, whichever of the two wrappers
launched and whichever body ran; ``dft_launches`` counts the launches of
the ``"dft"`` body among them.
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
MAX_MELS = 256    # keeps the dft body's shared memory under the card's limit
MODES = ("dif", "exact")
FFT_LOG_N = (8, 14)   # csrc/logmel_fft.cu: n_fft 256 .. 16384


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


def body(n_fft: int) -> str:
    """Which CUDA body computes a launch at ``n_fft``: ``"fft"`` for a power
    of two from 256 to 16384, ``"dft"`` otherwise."""
    lo, hi = FFT_LOG_N
    return "fft" if n_fft & (n_fft - 1) == 0 and 1 << lo <= n_fft <= 1 << hi else "dft"


def mel_csr(sr: int, n_fft: int, n_mels: int, fmin: float, fmax):
    """The mel filterbank as rows of contiguous bins: each band's first bin
    (int32, ``n_mels``), row pointers (int32, ``n_mels + 1``) and the weights
    from its first to its last nonzero bin, in bin order (float32). A band
    with no nonzero bin is empty."""
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    first = np.zeros(n_mels, np.int32)
    ptr = np.zeros(n_mels + 1, np.int32)
    rows = []
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        first[m], ptr[m + 1] = lo, ptr[m] + hi - lo
        rows.append(row[lo:hi])
    return first, ptr, np.concatenate(rows).astype(np.float32)


def fft_operands(sr: int, n_fft: int, n_mels: int, fmin: float, fmax) -> dict:
    """The FFT body's operands: the Hann window, the twiddles of the
    ``n_fft / 2``-point complex FFT (``tw[m] = exp(-2 pi i m / H)``, ``(H, 2)``)
    and of the real-to-complex untangle (``utw[k] = exp(-2 pi i k / n_fft)``,
    ``(H + 1, 2)``), each computed in float64 and rounded to float32, and
    the mel filterbank as CSR rows (`mel_csr`)."""
    h = n_fft // 2
    ang = 2.0 * np.pi * np.arange(h, dtype=np.float64) / h
    uang = 2.0 * np.pi * np.arange(h + 1, dtype=np.float64) / n_fft
    first, ptr, weights = mel_csr(sr, n_fft, n_mels, fmin, fmax)
    return {
        "window": hann_window(n_fft, np.float64).astype(np.float32),
        "tw": np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32),
        "utw": np.stack([np.cos(uang), -np.sin(uang)], axis=1).astype(np.float32),
        "mel_first": first, "mel_ptr": ptr, "mel_w": weights,
    }


_OPERANDS = {"dif": dif_operands, "exact": exact_operands, "fft": fft_operands}


@lru_cache(maxsize=16)
def _device_operands(sr, n_fft, n_mels, fmin, fmax, kind: str, device: str) -> dict:
    """The operands of ``kind`` (``"dif"``, ``"exact"``, ``"fft"``) on
    ``device``, built on the host and cached only here: the cached tensors
    are shared, read only."""
    ops = _OPERANDS[kind](sr, n_fft, n_mels, fmin, fmax)
    return {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
            for k, v in ops.items()}


def _operands(cfg: FrontendConfig, n_fft: int, kind: str, device: torch.device) -> dict:
    return _device_operands(cfg.sample_rate, n_fft, cfg.n_mels, cfg.fmin, cfg.fmax,
                            kind, str(device))


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
    """The dft body's arithmetic in float32 PyTorch ops, frames read from
    the flat ``src`` at ``t * stride`` as the kernel reads them."""
    ops = _operands(cfg, n_fft, "exact" if direct else "dif", src.device)
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


def _butterfly(vr, vi):
    """The R-point forward DFT of ``csrc/logmel_fft.cu``'s ``butterfly<R>``
    (R = 2 or 4) on lists of real and imaginary parts, the same operations."""
    if len(vr) == 2:
        return [vr[0] + vr[1], vr[0] - vr[1]], [vi[0] + vi[1], vi[0] - vi[1]]
    t0r, t0i, t1r, t1i = vr[0] + vr[2], vi[0] + vi[2], vr[0] - vr[2], vi[0] - vi[2]
    t2r, t2i, t3r, t3i = vr[1] + vr[3], vi[1] + vi[3], vr[1] - vr[3], vi[1] - vi[3]
    return ([t0r + t2r, t1r + t3i, t0r - t2r, t1r - t3i],
            [t0i + t2i, t1i - t3r, t0i - t2i, t1i + t3r])


def _fft_plain(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
               cfg: FrontendConfig) -> torch.Tensor:
    """The FFT body's arithmetic stage by stage in float32 PyTorch ops, frames
    read from the flat ``src`` at ``t * stride``: the same radices, twiddle
    tables, untangle and CSR order, each product and sum rounded where the
    kernel rounds it (the kernel contracts nothing into an FMA), so that an
    indexing mistake shows on the CPU."""
    ops = _operands(cfg, n_fft, "fft", src.device)
    h = n_fft // 2
    x = src.as_strided((n_frames, n_fft), (stride, 1), src.storage_offset()) * ops["window"]
    re, im = x[:, 0::2], x[:, 1::2]                 # z[n] = x[2n] + i x[2n+1]
    tw_r, tw_i = ops["tw"][:, 0], ops["tw"][:, 1]
    log_h = h.bit_length() - 1
    ns = 1
    for radix in [2] * (log_h % 2) + [4] * (log_h // 2):    # Stockham, Ns = 1, R1, ...
        j = torch.arange(h // radix, device=src.device)
        k = j % ns
        vr = [re[:, j + r * (h // radix)] for r in range(radix)]
        vi = [im[:, j + r * (h // radix)] for r in range(radix)]
        if ns > 1:
            for r in range(1, radix):
                m = k * r * (h // (radix * ns))
                wr, wi = tw_r[m], tw_i[m]
                vr[r], vi[r] = vr[r] * wr - vi[r] * wi, vr[r] * wi + vi[r] * wr
        ur, ui = _butterfly(vr, vi)
        d = (j - k) * radix + k
        re, im = torch.empty_like(x[:, :h]), torch.empty_like(x[:, :h])
        for r in range(radix):
            re[:, d + r * ns], im[:, d + r * ns] = ur[r], ui[r]
        ns *= radix
    k = torch.arange(h + 1, device=src.device)
    a_r, a_i = re[:, k % h], im[:, k % h]
    b_r, b_i = re[:, (h - k) % h], im[:, (h - k) % h]
    w_r, w_i = ops["utw"][:, 0], ops["utw"][:, 1]
    e_r, e_i = 0.5 * (a_r + b_r), 0.5 * (a_i - b_i)
    o_r, o_i = 0.5 * (a_i + b_i), 0.5 * (b_r - a_r)
    x_r = e_r + (w_r * o_r - w_i * o_i)
    x_i = e_i + (w_r * o_i + w_i * o_r)
    power = x_r * x_r + x_i * x_i                   # (n_frames, h + 1)
    first, ptr, mel_w = ops["mel_first"].long(), ops["mel_ptr"].long(), ops["mel_w"]
    count = ptr[1:] - ptr[:-1]
    acc = torch.zeros((n_frames, cfg.n_mels), dtype=torch.float32, device=src.device)
    for i in range(int(count.max())):               # bin i of every band, in bin order
        live = i < count
        w = torch.where(live, mel_w[torch.clamp(ptr[:-1] + i, max=mel_w.numel() - 1)], 0.0)
        acc = acc + w * power[:, torch.clamp(first + i, max=h)]
    return _finish(acc, cfg.log_floor)


def fft_log_mel_plain(y: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """1-D waveform -> ``(n_frames, n_mels)`` log mel energies by the FFT
    body's arithmetic (`_fft_plain`), frames at stride hop on the (centre
    padded) waveform; a power-of-two ``n_fft`` from 256 to 16384."""
    if body(cfg.n_fft) != "fft":
        raise ValueError(f"the FFT body takes a power-of-two n_fft in [{1 << FFT_LOG_N[0]}, "
                         f"{1 << FFT_LOG_N[1]}], got {cfg.n_fft}")
    src, n_frames = frame_source(y.to(torch.float32), cfg)
    return _fft_plain(src, cfg.hop_length, n_frames, cfg.n_fft, cfg)


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


@lru_cache(maxsize=None)
def _fft_lib() -> ctypes.CDLL:
    lib = _build.load("logmel_fft")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.logmel_fft.argtypes = ([p, ctypes.c_longlong, i, i] + [p] * 6
                               + [i, i, ctypes.c_float, p, p])
    lib.logmel_fft.restype = i
    for name in ("logmel_fft_min_log_n", "logmel_fft_max_log_n"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.logmel_fft_error_string.argtypes = [i]
    lib.logmel_fft_error_string.restype = ctypes.c_char_p
    if (lib.logmel_fft_min_log_n(), lib.logmel_fft_max_log_n()) != FFT_LOG_N:
        raise RuntimeError("csrc/logmel_fft.cu size range differs from FFT_LOG_N")
    return lib


def _check_cuda(x: torch.Tensor, cfg: FrontendConfig) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32 samples, got {x.dtype}")
    if not 0 < cfg.n_mels <= MAX_MELS:
        raise ValueError(f"n_mels must be in [1, {MAX_MELS}], got {cfg.n_mels}")


def _floor(cfg: FrontendConfig) -> Tuple[int, float]:
    use = cfg.log_floor is not None
    return int(use), float(cfg.log_floor) if use else 0.0


def _launch_fft(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
                cfg: FrontendConfig) -> torch.Tensor:
    ops = _operands(cfg, n_fft, "fft", src.device)
    out = torch.empty((n_frames, cfg.n_mels), dtype=torch.float32, device=src.device)
    lib = _fft_lib()
    with torch.cuda.device(src.device):
        status = lib.logmel_fft(
            src.data_ptr(), stride, n_frames, n_fft.bit_length() - 1,
            *(ops[k].data_ptr() for k in ("window", "tw", "utw", "mel_first", "mel_ptr",
                                          "mel_w")),
            cfg.n_mels, *_floor(cfg), out.data_ptr(),
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"logmel_fft launch failed: {lib.logmel_fft_error_string(status).decode()}")
    return out


def _launch_dft(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
                cfg: FrontendConfig, direct: bool) -> torch.Tensor:
    """The dft body (direct or DIF formulation) at any ``n_fft``; `_launch`
    takes it where `body` says ``"dft"``."""
    dev = src.device
    ops = _operands(cfg, n_fft, "exact" if direct else "dif", dev)
    out = torch.empty((n_frames, cfg.n_mels), dtype=torch.float32, device=dev)
    nb = ops["bc"].shape[1]
    groups = _n_groups(n_frames, nb // BIN_TILE, dev)
    partial = (torch.empty((groups, n_frames, cfg.n_mels), dtype=torch.float32, device=dev)
               if groups > 1 else out)
    lib = _lib()
    window = (None, None) if direct else (ops["wa"].data_ptr(), ops["wb"].data_ptr())
    with torch.cuda.device(dev):
        status = lib.fused_logmel(
            src.data_ptr(), *window, ops["bc"].data_ptr(), ops["bs"].data_ptr(),
            ops["melw"].data_ptr(), partial.data_ptr(), out.data_ptr(),
            n_frames, n_fft if direct else n_fft // 2, stride, nb, ops["n_even_tiles"],
            cfg.n_mels, groups, int(direct), *_floor(cfg),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"fused_logmel launch failed: {lib.fused_logmel_error_string(status).decode()}"
        )
    fused_log_mel.dft_launches += 1
    return out


def _launch(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
            cfg: FrontendConfig, direct: bool) -> torch.Tensor:
    """One launch over frames ``src[t*stride : t*stride + n_fft]``, by the
    body `body` names for ``n_fft`` (the direct formulation applies to the
    dft body only)."""
    if src.ndim != 1 or not src.is_contiguous():
        raise ValueError("the frame source must be a contiguous 1-D tensor")
    if n_frames <= 0 or (n_frames - 1) * stride + n_fft > src.shape[0]:
        raise ValueError(f"{n_frames} frames of {n_fft} at stride {stride} overrun "
                         f"{src.shape[0]} samples")
    if body(n_fft) == "fft":
        return _launch_fft(src, stride, n_frames, n_fft, cfg)
    return _launch_dft(src, stride, n_frames, n_fft, cfg, direct)


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
fused_log_mel.dft_launches = 0
