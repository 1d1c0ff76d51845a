"""Framed STFT and power spectra in PyTorch.

The reference frontend's STFT semantics (librosa-0.7 defaults): centered
frames with reflect padding of ``n_fft // 2`` samples, periodic Hann window
of length ``n_fft``, hop ``n_fft // 2``. Two formulations:

* ``power_spectrum_fft``: frame, window, ``torch.fft.rfft``;
* ``power_spectrum_matmul``: the windowed real DFT as two matrix products
  against cos/sin bases that absorb the window.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def hann_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic ("fftbins") Hann window, as librosa's STFT uses it."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(dtype)


def num_frames(n_samples: int, n_fft: int, hop: int, center: bool = True) -> int:
    padded = n_samples + (n_fft if center else 0)
    return 1 + (padded - n_fft) // hop


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy ``mode="reflect"`` padding of a 1-D signal (edge not repeated)."""
    if pad == 0:
        return y
    left = y[1 : pad + 1].flip(0)
    right = y[-pad - 1 : -1].flip(0)
    return torch.cat([left, y, right])


def frame_signal(y: torch.Tensor, n_fft: int, hop: int, center: bool = True) -> torch.Tensor:
    """Slice a 1-D signal into overlapping frames, ``(n_frames, n_fft)``."""
    if center:
        y = reflect_pad(y, n_fft // 2)
    n_frames = 1 + (y.shape[0] - n_fft) // hop
    if n_frames < 1:
        raise ValueError(f"signal of {y.shape[0]} samples is shorter than n_fft {n_fft}")
    return y.unfold(0, n_fft, hop)[:n_frames]


@lru_cache(maxsize=8)
def dft_bases(n_fft: int, windowed: bool) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin bases ``(n_fft, n_bins)``, optionally window-folded.
    The cached arrays are shared: callers must not write to them."""
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_b, sin_b = np.cos(ang), -np.sin(ang)
    if windowed:
        w = hann_window(n_fft, np.float64)[:, None]
        cos_b, sin_b = cos_b * w, sin_b * w
    return cos_b.astype(np.float32), sin_b.astype(np.float32)


def power_spectrum_fft(frames: torch.Tensor, n_fft: int, window: torch.Tensor) -> torch.Tensor:
    """``|rFFT(frames * window)|^2`` -> ``(n_frames, 1 + n_fft // 2)``."""
    spec = torch.fft.rfft(frames * window, n=n_fft)
    return spec.real ** 2 + spec.imag ** 2


def power_spectrum_matmul(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Windowed power spectrum as two matrix products."""
    cos_b, sin_b = (
        torch.from_numpy(b).to(frames.device) for b in dft_bases(n_fft, windowed=True)
    )
    re = frames @ cos_b
    im = frames @ sin_b
    return re * re + im * im


def stft_power(
    y: torch.Tensor, n_fft: int, hop: int, center: bool = True, backend: str = "fft"
) -> torch.Tensor:
    """Power spectrogram ``(n_frames, 1 + n_fft // 2)`` of a 1-D signal."""
    if backend not in ("fft", "matmul"):
        raise ValueError(f"unknown STFT backend {backend!r}; expected 'fft' or 'matmul'")
    frames = frame_signal(y, n_fft, hop, center=center)
    if backend == "matmul":
        return power_spectrum_matmul(frames, n_fft)
    window = torch.from_numpy(hann_window(n_fft)).to(y.device)
    return power_spectrum_fft(frames, n_fft, window)
