"""Log-mel frontend and per-split normalization statistics.

The reference feature extractor's chain: STFT (n_fft 2048, hop 1024) ->
power spectrum -> 40-band slaney mel product -> natural log (no epsilon
unless ``log_floor`` is set) -> ``(frames, n_mels)``. Backends:

* ``"fft"``: ``torch.fft.rfft`` of windowed frames;
* ``"matmul"``: windowed DFT as two matrix products;
* ``"kernel"``: the fused log-mel of `ops/kernels/fused_logmel.py` (the CUDA
  kernel on a CUDA tensor, its plain version on a CPU tensor), at any hop
  and any signal length, by the JAX ``"pallas"`` backend's dispatch: the
  chunked DIF route for ``hop * 2 == n_fft``, the framed DIF route for
  other hops and short signals, the direct route for ``n_fft % 4 != 0``.

Centred framing reflects as numpy's ``mode="reflect"`` does, again and again
when the signal is shorter than ``n_fft / 2`` (`ops/stft.py::reflect_pad`).

Normalization follows sklearn's StandardScaler as the reference used it:
per-mel-bin mean and population variance from the train split only,
zero-variance bins left unscaled.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from sed_crnn_torch.core.config import FRONTEND_BACKENDS, FrontendConfig
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.ops import stft as stft_ops
from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel, fused_log_mel_frames
from sed_crnn_torch.ops.mel import mel_filterbank
from sed_crnn_torch.parallel import mesh as mesh_ops


def _mel_fb(cfg: FrontendConfig, device: torch.device) -> torch.Tensor:
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    return torch.from_numpy(fb).to(device)                      # (n_mels, bins)


def _mel_log(power: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    mel = power @ _mel_fb(cfg, power.device).T
    if cfg.log_floor is not None:
        mel = torch.clamp_min(mel, cfg.log_floor)
    return torch.log(mel)


def _check_backend(cfg: FrontendConfig) -> None:
    if cfg.backend not in FRONTEND_BACKENDS:
        raise ValueError(
            f"unknown frontend backend {cfg.backend!r}; expected one of {FRONTEND_BACKENDS}"
        )


def log_mel_energies(y: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Log mel-band energies of a 1-D waveform -> ``(n_frames, n_mels)``."""
    _check_backend(cfg)
    y = y.to(torch.float32)
    if cfg.backend == "kernel":
        return fused_log_mel(y, cfg)
    power = stft_ops.stft_power(
        y, cfg.n_fft, cfg.hop_length, center=cfg.center, backend=cfg.backend
    )
    return _mel_log(power, cfg)


def log_mel_from_frames(frames: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Log-mel rows from pre-framed windows ``(n, n_fft)``: the rows
    `log_mel_energies` gives for the same frames of a whole waveform.
    ``"kernel"``: `fused_log_mel_frames`, the framed route at stride n_fft;
    ``"fft"`` and ``"matmul"``: ``torch.fft.rfft`` rows, as the JAX package
    computes them for every backend."""
    _check_backend(cfg)
    if cfg.backend == "kernel":
        return fused_log_mel_frames(frames.to(torch.float32), cfg)
    window = torch.from_numpy(stft_ops.hann_window(cfg.n_fft)).to(frames.device)
    power = stft_ops.power_spectrum_fft(frames.to(torch.float32), cfg.n_fft, window)
    return _mel_log(power, cfg)


def extract(
    y,
    cfg: FrontendConfig,
    bucket_seconds: float = 30.0,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Waveform (numpy) -> log-mel ``(n_frames, n_mels)`` tensor on ``device``.

    The centre reflect padding is applied on the host, the padded signal is
    zero-extended to a multiple of ``bucket_seconds`` and run uncentered, and
    the output is trimmed to the true frame count: the JAX package's
    bucketing, which keeps one compiled program per bucket there and gives
    the same frames here. ``bucket_seconds=0`` runs the exact length.
    """
    dev = resolve_device(device)
    y = np.asarray(y, dtype=np.float32)
    if bucket_seconds <= 0:
        return log_mel_energies(torch.from_numpy(y).to(dev), cfg)
    true_frames = stft_ops.num_frames(len(y), cfg.n_fft, cfg.hop_length, cfg.center)
    if cfg.center:
        y = np.pad(y, cfg.n_fft // 2, mode="reflect")
    bucket = max(int(bucket_seconds * cfg.sample_rate), cfg.n_fft)
    padded_len = -(-len(y) // bucket) * bucket
    y = np.pad(y, (0, padded_len - len(y)))
    out = log_mel_energies(
        torch.from_numpy(y).to(dev), dataclasses.replace(cfg, center=False)
    )
    return out[:true_frames]


class NormStats(NamedTuple):
    """Per-feature standardization statistics."""

    mean: torch.Tensor   # (n_mels,)
    scale: torch.Tensor  # (n_mels,) std, zeros replaced by 1


def fit_norm_stats(x: torch.Tensor, group=None) -> NormStats:
    """Mean and population std over the frames of ``x (frames, n_mels)``,
    two-pass so that constant features give an exact zero (scale 1).

    ``group``: a `parallel.mesh.Mesh` whose ranks each hold a shard of the
    frames; the frame count and the sums are then all_reduced first, and
    the squared deviations from that global mean second (the JAX package's
    ``axis_name`` form), giving the whole corpus's statistics on every
    rank."""
    x = x.to(torch.float32)
    if group is None:
        n = float(x.shape[0])
        mean = x.sum(dim=0) / n
        var = ((x - mean) ** 2).sum(dim=0) / n
    else:
        first = mesh_ops.all_reduce_sum(torch.cat([x.sum(dim=0), x.new_full((1,), x.shape[0])]),
                                        group)
        n = first[-1]
        mean = first[:-1] / n
        var = mesh_ops.all_reduce_sum(((x - mean) ** 2).sum(dim=0), group) / n
    std = torch.sqrt(var)
    return NormStats(mean=mean, scale=torch.where(std == 0.0, torch.ones_like(std), std))


def normalize(x: torch.Tensor, stats) -> torch.Tensor:
    """``(x - mean) / scale``; ``stats`` is a `NormStats` or a (mean, scale)
    pair of arrays or tensors."""
    mean, scale = (torch.as_tensor(s, dtype=torch.float32, device=x.device) for s in stats)
    return (x - mean) / scale
