"""Slaney-style mel filterbank (numpy, float64 construction).

librosa-0.7 ``filters.mel`` defaults, as the reference frontend used them:
HTK=False (Slaney's auditory-toolbox mel scale, linear below 1 kHz and
logarithmic above) and area ("slaney") normalization. Built once on the
host and handed to the device as a constant.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

# Slaney mel scale: 200/3 Hz per mel below the 1 kHz break, then
# logarithmic with step log(6.4)/27 per mel.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq_hz) -> np.ndarray:
    f = np.asanyarray(freq_hz, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, 1e-300) / _MIN_LOG_HZ) / _LOGSTEP,
        mel,
    )


def mel_to_hz(mel) -> np.ndarray:
    m = np.asanyarray(mel, dtype=np.float64)
    hz = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), hz)


def mel_center_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """``n_mels`` band centers plus the two edge points (length n_mels + 2)."""
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    return mel_to_hz(mels)


@lru_cache(maxsize=16)
def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_mels, 1 + n_fft // 2)``.
    The cached array is shared: callers must not write to it."""
    if fmax is None:
        fmax = float(sr) / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, float(sr) / 2.0, n_bins, dtype=np.float64)
    band_edges = mel_center_frequencies(n_mels, fmin, fmax)       # (n_mels + 2,)

    # Triangle m rises from edge[m] to edge[m+1] and falls to edge[m+2].
    edge_diff = np.diff(band_edges)
    ramps = band_edges[:, None] - fft_freqs[None, :]
    rising = -ramps[:-2] / edge_diff[:-1, None]
    falling = ramps[2:] / edge_diff[1:, None]
    weights = np.maximum(0.0, np.minimum(rising, falling))        # (n_mels, bins)

    # Slaney area normalization: equal energy per band.
    enorm = 2.0 / (band_edges[2 : n_mels + 2] - band_edges[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)
