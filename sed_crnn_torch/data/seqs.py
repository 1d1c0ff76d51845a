"""Sequence and channel reshaping of frame arrays (the reference's
`utils.py:11-41` helpers), numpy in and numpy out.

Counterpart of the JAX package's `data/seqs.py`."""

from __future__ import annotations

import numpy as np


def reshape_3d_to_2d(a: np.ndarray) -> np.ndarray:
    """(N, T, C) -> (N*T, C)."""
    return a.reshape(a.shape[0] * a.shape[1], a.shape[2])


def split_multi_channels(data: np.ndarray, num_channels: int) -> np.ndarray:
    """(N, T, F*nch) -> (N, nch, T, F): per-channel features stacked along
    the last axis become an explicit channel axis."""
    if data.ndim != 3:
        raise ValueError(f"expected a 3-D array, got shape {data.shape}")
    n, t, fc = data.shape
    if fc % num_channels:
        raise ValueError(f"feature dim {fc} not divisible by {num_channels} channels")
    f = fc // num_channels
    return np.ascontiguousarray(data.reshape(n, t, num_channels, f).transpose(0, 2, 1, 3))


def split_in_seqs(data: np.ndarray, subdivs: int) -> np.ndarray:
    """Chop the leading (frame) axis into sequences of ``subdivs``, dropping
    the remainder: (N, ...) -> (N // subdivs, subdivs, ...). 1-D input gains
    a trailing feature axis of 1."""
    if data.ndim == 1:
        data = data[:, None]
    n = data.shape[0]
    keep = n - (n % subdivs)
    data = data[:keep]
    return data.reshape((keep // subdivs, subdivs) + data.shape[1:])
