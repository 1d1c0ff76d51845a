"""Window sampling over fold arrays that live on the training device.

Counterpart of the JAX package's `data/sampler.py`. A batch is assembled
on the device from the fold's arrays: index draws, window gathers, label
max-pooling (``seq_len_in -> seq_len_out``) and SpecAugment. Index draws
and masks come from an explicit `torch.Generator` on the fold's device; the
two frameworks' random streams differ, so the tests hold the port to equal
windows given equal starts and to the sampling rules, not to equal draws.

* ``SequenceWindowSampler`` (the DCASE pipeline): the split is cut into
  aligned non-overlapping ``seq_len_in``-frame windows; a batch draws window
  indices uniformly; an epoch is ``ceil(N / batch)`` batches. The
  deterministic full-split sweep enumerates the same windows in time order.
* ``BalancedWindowSampler`` (the hit-detection pipelines): half the batch
  anchors a uniform window placement on a uniformly drawn positive frame,
  half takes a uniformly drawn clean-negative start (a window with no
  positive frame); an epoch is ``2 x #positive frames`` draws.

The JAX package's shape buckets (``frame_bucket``/``pos_bucket``/
``neg_bucket``), which let folds share one compiled program, have no
counterpart here: PyTorch runs eagerly, so each fold keeps its own sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def find_clean_negative_starts(label_vec: np.ndarray, seq_len: int) -> np.ndarray:
    """Window starts whose ``seq_len`` span holds no frame with any class
    active (a box filter over the label mask)."""
    mask = (np.asarray(label_vec).max(axis=1) > 0).astype(np.int64)
    if len(mask) < seq_len:
        return np.empty((0,), np.int64)
    window_sums = np.convolve(mask, np.ones(seq_len, dtype=np.int64), mode="valid")
    return np.flatnonzero(window_sums == 0)


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """What a batch draw needs to know besides the fold's arrays."""

    kind: str                   # "balanced" | "sequence"
    seq_len_in: int
    seq_len_out: int
    augment: bool = False
    time_mask_w: int = 8
    freq_mask_w: int = 8
    masks_per_example: int = 2


def gather_windows(spec: WindowSpec, data: Dict, starts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window gather + label max-pooling -> (x (B, T, F), y (B, T_out, C))."""
    idx = starts[:, None] + torch.arange(spec.seq_len_in, device=starts.device)[None, :]
    x = data["mel"][idx]
    y_win = data["lab"][idx]
    pool = spec.seq_len_in // spec.seq_len_out
    y = y_win.reshape(starts.shape[0], spec.seq_len_out, pool, -1).amax(dim=2)
    return x, y


def _balanced_starts(spec: WindowSpec, data: Dict, generator: torch.Generator,
                     batch_size: int) -> torch.Tensor:
    """Half positive-anchored, half clean-negative starts, interleaved (odd
    batch sizes get the extra positive)."""
    dev = data["mel"].device
    n_pos = (batch_size + 1) // 2
    ci = torch.randint(0, data["n_pos"], (n_pos,), generator=generator, device=dev)
    centers = data["pos"][ci]
    lo = torch.clamp_min(centers - spec.seq_len_in + 1, 0)
    hi = torch.clamp_max(centers, data["n_frames"] - spec.seq_len_in)
    hi = torch.maximum(hi, lo)
    u = torch.rand((n_pos,), generator=generator, device=dev)
    pos_starts = lo + torch.floor(u * (hi - lo + 1).float()).long()
    pos_starts = torch.minimum(pos_starts, hi)
    ni = torch.randint(0, data["n_neg"], (n_pos,), generator=generator, device=dev)
    neg_starts = data["neg"][ni]
    return torch.stack([pos_starts, neg_starts], dim=1).reshape(-1)[:batch_size]


def sample_batch_from(spec: WindowSpec, data: Dict, generator: torch.Generator,
                      batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random batch draw -> (x (B, T, F), y (B, T_out, C))."""
    if spec.kind == "balanced":
        starts = _balanced_starts(spec, data, generator, batch_size)
    elif spec.kind == "sequence":
        idx = torch.randint(0, data["n_frames"] // spec.seq_len_in, (batch_size,),
                            generator=generator, device=data["mel"].device)
        starts = idx * spec.seq_len_in
    else:
        raise ValueError(f"unknown sampler kind {spec.kind!r}")
    x, y = gather_windows(spec, data, starts)
    if spec.augment:
        x = spec_augment(generator, x, spec.time_mask_w, spec.freq_mask_w,
                         spec.masks_per_example)
    return x, y


def sweep_batch_from(spec: WindowSpec, data: Dict, idx: torch.Tensor):
    """Aligned windows by index for the full-split sweep (non-overlapping,
    tail truncated). Out-of-range indices are clamped and flagged invalid.
    Returns (x, y, valid)."""
    n_windows = data["n_frames"] // spec.seq_len_in
    valid = idx < n_windows
    idx_c = torch.clamp_max(idx, max(n_windows - 1, 0))
    x, y = gather_windows(spec, data, idx_c * spec.seq_len_in)
    return x, y, valid


def spec_augment(generator: torch.Generator, x: torch.Tensor, time_mask_w: int = 8,
                 freq_mask_w: int = 8, n_masks: int = 2) -> torch.Tensor:
    """SpecAugment on a batch of (T, F) windows: per example, ``n_masks``
    rounds each zeroing one time stripe and one frequency stripe at offsets
    uniform in ``[0, dim - width)``."""
    B, T, F = x.shape
    dev = x.device
    t_ids = torch.arange(T, device=dev)[None, :, None]
    f_ids = torch.arange(F, device=dev)[None, None, :]
    for _ in range(n_masks):
        if T > time_mask_w:
            t0 = torch.randint(0, T - time_mask_w, (B, 1, 1), generator=generator, device=dev)
            x = torch.where((t_ids >= t0) & (t_ids < t0 + time_mask_w), 0.0, x)
        if F > freq_mask_w:
            f0 = torch.randint(0, F - freq_mask_w, (B, 1, 1), generator=generator, device=dev)
            x = torch.where((f_ids >= f0) & (f_ids < f0 + freq_mask_w), 0.0, x)
    return x


def _split_arrays(mel, lab, device) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    lab_np = np.asarray(lab, np.float32)
    mel_t = torch.as_tensor(np.asarray(mel, np.float32), device=device)
    return mel_t, torch.as_tensor(lab_np, device=device), lab_np


class _Sampler:
    spec: WindowSpec
    data: Dict
    n_windows: int

    @property
    def sweep_windows(self) -> int:
        return self.n_windows

    def sweep_steps(self, batch_size: int) -> int:
        return max(1, -(-self.n_windows // batch_size))

    def sample_batch(self, generator: torch.Generator, batch_size: int):
        return sample_batch_from(self.spec, self.data, generator, batch_size)


class SequenceWindowSampler(_Sampler):
    """Uniform draws over the split's aligned ``seq_len_in`` windows."""

    def __init__(self, mel, lab, seq_len_in: int = 256, seq_len_out: int = 256,
                 augment: bool = False, device: Optional[torch.device] = None):
        mel_t, lab_t, lab_np = _split_arrays(mel, lab, device)
        self.total_frames = int(lab_np.shape[0])
        self.n_windows = self.total_frames // seq_len_in
        if self.n_windows < 1:
            raise ValueError(
                f"split has {self.total_frames} frames < one {seq_len_in}-frame sequence")
        self.spec = WindowSpec("sequence", seq_len_in, seq_len_out, augment)
        self.data = {"mel": mel_t, "lab": lab_t, "n_frames": self.total_frames}

    @property
    def epoch_examples(self) -> int:
        return self.n_windows

    def steps_per_epoch(self, batch_size: int, drop_last: bool = False) -> int:
        n = self.n_windows
        return max(1, n // batch_size if drop_last else -(-n // batch_size))


class BalancedWindowSampler(_Sampler):
    """Balanced positive / clean-negative window draws."""

    def __init__(self, mel, lab, seq_len_in: int = 64, seq_len_out: int = 8,
                 augment: bool = False, device: Optional[torch.device] = None):
        mel_t, lab_t, lab_np = _split_arrays(mel, lab, device)
        self.total_frames = int(lab_np.shape[0])
        if self.total_frames < seq_len_in:
            raise ValueError(f"split has {self.total_frames} frames < window {seq_len_in}")
        pos = np.flatnonzero(lab_np.max(axis=1) > 0)
        if pos.size == 0:
            raise ValueError("split contains no positive frames — cannot balance")
        neg = find_clean_negative_starts(lab_np, seq_len_in)
        if neg.size == 0:
            raise ValueError("split contains no clean negative windows")
        self.n_pos, self.n_neg = int(pos.size), int(neg.size)
        self.n_windows = self.total_frames // seq_len_in
        self.spec = WindowSpec("balanced", seq_len_in, seq_len_out, augment)
        self.data = {
            "mel": mel_t, "lab": lab_t,
            "pos": torch.as_tensor(pos, device=device),
            "neg": torch.as_tensor(neg, device=device),
            "n_pos": self.n_pos, "n_neg": self.n_neg, "n_frames": self.total_frames,
        }

    @property
    def epoch_examples(self) -> int:
        return 2 * self.n_pos

    def steps_per_epoch(self, batch_size: int, drop_last: bool = True) -> int:
        n = self.epoch_examples
        return n // batch_size if drop_last else -(-n // batch_size)
