"""Segment-based polyphonic SED metrics (Mesaros et al. 2016), the parts the
training loop uses.

Counterpart of the JAX package's `ops/metrics.py`, with the reference's
exact semantics, computed in float32 with the float64 machine epsilon:

* framewise F1 with ``TP = ((2T - O) == 1).sum()`` and eps guards on the
  precision/recall denominators;
* framewise ER with per-row substitutions/deletions/insertions and an
  unguarded ``Nref`` denominator (0/0 -> NaN, inf with only false
  positives);
* 1-second-segment variants that max-pool frames into blocks first, keeping
  the block-count asymmetry: F1 pads to ceil(N/block) blocks, ER truncates
  to floor(N/block) blocks.

3-D ``(N, T, C)`` inputs are flattened to ``(N*T, C)`` first. The threshold
sweeps are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

# Machine epsilon for float64: the reference's np.finfo(float).eps.
EPS = float(np.finfo(np.float64).eps)


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 3:
        return x.reshape(x.shape[0] * x.shape[1], x.shape[2])
    if x.ndim == 1:
        return x[:, None]
    return x


def _block_max(x: torch.Tensor, block: int, mode: str) -> torch.Tensor:
    """Max-pool frames into blocks: 'ceil' zero-pads the tail block (F1),
    'floor' drops the partial tail block (ER)."""
    n, c = x.shape
    if mode == "ceil":
        n_blocks = -(-n // block)
        x = F.pad(x, (0, 0, 0, n_blocks * block - n))
    else:
        n_blocks = n // block
        x = x[: n_blocks * block]
    return x.reshape(n_blocks, block, c).amax(dim=1)


def f1_framewise(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    o = _as_2d(outputs).float()
    t = _as_2d(targets).float()
    tp = ((2.0 * t - o) == 1.0).sum().float()
    nref, nsys = t.sum(), o.sum()
    prec = tp / (nsys + EPS)
    recall = tp / (nref + EPS)
    return 2.0 * prec * recall / (prec + recall + EPS)


def er_framewise(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    o = _as_2d(outputs).float()
    t = _as_2d(targets).float()
    fp = ((t == 0.0) & (o == 1.0)).sum(dim=1).float()
    fn = ((t == 1.0) & (o == 0.0)).sum(dim=1).float()
    subs = torch.minimum(fp, fn).sum()
    dels = torch.clamp_min(fn - fp, 0.0).sum()
    ins = torch.clamp_min(fp - fn, 0.0).sum()
    nref = t.sum()
    return (subs + dels + ins) / nref  # unguarded, as the reference


def f1_segment(outputs: torch.Tensor, targets: torch.Tensor, block_size: int) -> torch.Tensor:
    o, t = _as_2d(outputs), _as_2d(targets)
    return f1_framewise(_block_max(o, block_size, "ceil"), _block_max(t, block_size, "ceil"))


def er_segment(outputs: torch.Tensor, targets: torch.Tensor, block_size: int) -> torch.Tensor:
    o, t = _as_2d(outputs), _as_2d(targets)
    return er_framewise(_block_max(o, block_size, "floor"), _block_max(t, block_size, "floor"))


def all_scores(pred: torch.Tensor, y: torch.Tensor, frames_in_1_sec: int) -> Dict[str, torch.Tensor]:
    """Framewise + 1-second F1/ER and the binary confusion counts."""
    o, t = _as_2d(pred), _as_2d(y)
    ob, tb = o.bool(), t.bool()
    return {
        "f1_frame": f1_framewise(o, t),
        "er_frame": er_framewise(o, t),
        "f1_overall_1sec": f1_segment(o, t, frames_in_1_sec),
        "er_overall_1sec": er_segment(o, t, frames_in_1_sec),
        "tn": (~ob & ~tb).sum(),
        "fp": (ob & ~tb).sum(),
        "fn": (~ob & tb).sum(),
        "tp": (ob & tb).sum(),
    }


def all_scores_masked(
    pred: torch.Tensor, y: torch.Tensor, frames_in_1_sec: int, n_valid_rows: int
) -> Dict[str, torch.Tensor]:
    """`all_scores` over only the first ``n_valid_rows`` rows: rows past it
    are zeroed (they add nothing to the F1/ER sums and pad the F1 tail block
    as ceil pooling does), the ER path also zeroes the valid stream's partial
    tail block, and only the TN count needs the row mask."""
    o, t = _as_2d(pred).float(), _as_2d(y).float()
    rows = torch.arange(o.shape[0], device=o.device)[:, None]
    valid = rows < n_valid_rows
    o = torch.where(valid, o, 0.0)
    t = torch.where(valid, t, 0.0)
    ob, tb = o.bool(), t.bool()
    er_rows = (n_valid_rows // frames_in_1_sec) * frames_in_1_sec
    oe = torch.where(rows < er_rows, o, 0.0)
    te = torch.where(rows < er_rows, t, 0.0)
    return {
        "f1_frame": f1_framewise(o, t),
        "er_frame": er_framewise(o, t),
        "f1_overall_1sec": f1_segment(o, t, frames_in_1_sec),
        "er_overall_1sec": er_framewise(
            _block_max(oe, frames_in_1_sec, "floor"),
            _block_max(te, frames_in_1_sec, "floor"),
        ),
        "tn": (~ob & ~tb & valid).sum(),
        "fp": (ob & ~tb).sum(),
        "fn": (~ob & tb).sum(),
        "tp": (ob & tb).sum(),
    }
