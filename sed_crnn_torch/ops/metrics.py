"""Segment-based polyphonic SED metrics (Mesaros et al. 2016).

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

3-D ``(N, T, C)`` inputs are flattened to ``(N*T, C)`` first. Everything
runs on the inputs' device. The threshold sweeps binarize ``p > th`` in
float32 for every threshold at once, broadcast over a leading threshold
axis ``(n_th, frames, C)``, as the JAX package's ``vmap`` does.
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
    """Max-pool the frame axis (-2) into blocks: 'ceil' zero-pads the tail
    block (F1), 'floor' drops the partial tail block (ER). Leading axes (a
    threshold axis) pass through."""
    n, c = x.shape[-2:]
    if mode == "ceil":
        n_blocks = -(-n // block)
        x = F.pad(x, (0, 0, 0, n_blocks * block - n))
    else:
        n_blocks = n // block
        x = x[..., : n_blocks * block, :]
    return x.reshape(*x.shape[:-2], n_blocks, block, c).amax(dim=-2)


def _f1(o: torch.Tensor, t: torch.Tensor, dims) -> torch.Tensor:
    """F1 over ``dims`` of float 0/1 rolls (broadcast against each other)."""
    tp = ((2.0 * t - o) == 1.0).sum(dims).float()
    nref, nsys = t.sum(dims), o.sum(dims)
    prec = tp / (nsys + EPS)
    recall = tp / (nref + EPS)
    return 2.0 * prec * recall / (prec + recall + EPS)


def _er(o: torch.Tensor, t: torch.Tensor, per_class: bool = False) -> torch.Tensor:
    """ER of float 0/1 rolls (..., rows, C): substitutions, deletions and
    insertions counted per row over the classes, or per class alone (a
    one-column roll, where a row cannot substitute)."""
    fp = ((t == 0.0) & (o == 1.0)).float()
    fn = ((t == 1.0) & (o == 0.0)).float()
    if per_class:
        rows, nref = -2, t.sum(-2)
    else:
        fp, fn, rows, nref = fp.sum(-1), fn.sum(-1), -1, t.sum((-2, -1))
    subs = torch.minimum(fp, fn).sum(rows)
    dels = torch.clamp_min(fn - fp, 0.0).sum(rows)
    ins = torch.clamp_min(fp - fn, 0.0).sum(rows)
    return (subs + dels + ins) / nref  # unguarded, as the reference


def f1_framewise(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _f1(_as_2d(outputs).float(), _as_2d(targets).float(), (-2, -1))


def er_framewise(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _er(_as_2d(outputs).float(), _as_2d(targets).float())


def f1_segment(outputs: torch.Tensor, targets: torch.Tensor, block_size: int) -> torch.Tensor:
    o, t = _as_2d(outputs), _as_2d(targets)
    return f1_framewise(_block_max(o, block_size, "ceil"), _block_max(t, block_size, "ceil"))


def er_segment(outputs: torch.Tensor, targets: torch.Tensor, block_size: int) -> torch.Tensor:
    o, t = _as_2d(outputs), _as_2d(targets)
    return er_framewise(_block_max(o, block_size, "floor"), _block_max(t, block_size, "floor"))


def compute_scores(pred: torch.Tensor, y: torch.Tensor,
                   frames_in_1_sec: int = 50) -> Dict[str, torch.Tensor]:
    """The reference's `compute_scores` contract: 1-second F1 and ER."""
    return {
        "f1_overall_1sec": f1_segment(pred, y, frames_in_1_sec),
        "er_overall_1sec": er_segment(pred, y, frames_in_1_sec),
    }


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


def class_wise_scores(pred: torch.Tensor, y: torch.Tensor, frames_in_1_sec: int):
    """Per-class 1-second F1 (ceil-pooled blocks) and ER (floor-pooled; NaN
    or inf for a class absent from the reference) -> two (C,) tensors."""
    o, t = _as_2d(pred).float(), _as_2d(y).float()
    f1s = _f1(_block_max(o, frames_in_1_sec, "ceil"), _block_max(t, frames_in_1_sec, "ceil"), -2)
    ers = _er(_block_max(o, frames_in_1_sec, "floor"), _block_max(t, frames_in_1_sec, "floor"),
              per_class=True)
    return f1s, ers


def _present(t: torch.Tensor, frames_in_1_sec: int) -> torch.Tensor:
    """Classes with reference blocks on the ER path's floor-pooled blocks
    (a class positive only in the dropped tail has Nref == 0 there)."""
    return _block_max(t, frames_in_1_sec, "floor").sum(dim=-2) > 0


def class_wise_report(pred: torch.Tensor, y: torch.Tensor, frames_in_1_sec: int):
    """Per-class lists ``f1_1s`` / ``er_1s`` with ``None`` for classes
    absent from the reference, and the ``present`` flags."""
    f1s, ers = class_wise_scores(pred, y, frames_in_1_sec)
    present = _present(_as_2d(y).float(), frames_in_1_sec).tolist()
    return {
        "f1_1s": [v if p else None for v, p in zip(f1s.tolist(), present)],
        "er_1s": [v if p else None for v, p in zip(ers.tolist(), present)],
        "present": present,
    }


def _sweep_inputs(probs, targets, thresholds):
    """The flat float32 rolls and thresholds on the probabilities' device."""
    p, t = _as_2d(probs).float(), _as_2d(targets).float()
    return p, t, torch.as_tensor(thresholds, dtype=torch.float32, device=p.device).reshape(-1)


def _binarize(p: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """(frames, C) probabilities at every threshold -> (n_th, frames, C)."""
    return (p[None] > th[:, None, None]).float()


def threshold_sweep(probs, targets, thresholds, frames_in_1_sec: int):
    """(f1_1sec, er_1sec) at every threshold, each shaped like
    ``thresholds``."""
    p, t, th = _sweep_inputs(probs, targets, thresholds)
    o = _binarize(p, th)
    f1 = _f1(_block_max(o, frames_in_1_sec, "ceil"), _block_max(t, frames_in_1_sec, "ceil"),
             (-2, -1))
    er = _er(_block_max(o, frames_in_1_sec, "floor"), _block_max(t, frames_in_1_sec, "floor"))
    return f1, er


def best_threshold(probs, targets, thresholds, frames_in_1_sec: int):
    """The threshold of least 1-second ER (the first on ties, the first NaN
    when there is one), with the whole sweep."""
    p, t, th = _sweep_inputs(probs, targets, thresholds)
    f1s, ers = threshold_sweep(p, t, th, frames_in_1_sec)
    i = torch.argmin(ers)
    return {"threshold": th[i], "er": ers[i], "f1": f1s[i], "all_f1": f1s, "all_er": ers}


def threshold_sweep_per_class(probs, targets, thresholds, frames_in_1_sec: int):
    """Per-class 1-second scores at every threshold -> three (n_th, C)
    tensors: F1 (ceil-pooled blocks), ER (floor-pooled; NaN/inf for a class
    absent from the reference) and the floor-pooled false-positive block
    count, the tie-break for absent classes. Class c's scores depend on its
    own column only, so the global sweep decomposes exactly per class."""
    p, t, th = _sweep_inputs(probs, targets, thresholds)
    o = _binarize(p, th)
    o_floor, t_floor = _block_max(o, frames_in_1_sec, "floor"), _block_max(t, frames_in_1_sec,
                                                                          "floor")
    f1 = _f1(_block_max(o, frames_in_1_sec, "ceil"), _block_max(t, frames_in_1_sec, "ceil"), -2)
    er = _er(o_floor, t_floor, per_class=True)
    fp = ((o_floor == 1.0) & (t_floor == 0.0)).sum(dim=-2).float()
    return f1, er, fp


def best_per_class_thresholds(probs, targets, thresholds, frames_in_1_sec: int,
                              objective: str = "er"):
    """Each class's own threshold (least per-class 1-second ER, or most F1
    with ``objective="f1"``), then the overall 1-second scores at that
    threshold vector. A heuristic for the overall ER, whose substitutions
    couple classes. A class absent from the reference has no ER/F1 signal,
    so its threshold minimizes its false-positive blocks instead.

    Returns ``thresholds`` (C,), overall ``er`` / ``f1``, the per-class
    scores at the chosen points, ``class_present`` and the sweep tables."""
    if objective not in ("er", "f1"):
        raise ValueError(f"objective must be 'er' or 'f1', got {objective!r}")
    p, t, th = _sweep_inputs(probs, targets, thresholds)
    f1s, ers, fps = threshold_sweep_per_class(p, t, th, frames_in_1_sec)
    present = _present(t, frames_in_1_sec)
    if objective == "er":
        key = torch.where(torch.isfinite(ers), ers, torch.inf)
    else:
        key = -f1s
    idx = torch.argmin(torch.where(present[None, :], key, fps), dim=0)
    th_vec = th[idx]
    o = (p > th_vec[None, :]).float()

    def take(a):
        return a.gather(0, idx[None, :])[0]

    return {
        "thresholds": th_vec,
        "er": er_segment(o, t, frames_in_1_sec),
        "f1": f1_segment(o, t, frames_in_1_sec),
        "class_f1": take(f1s),
        "class_er": take(ers),
        "class_present": present,
        "all_f1": f1s,
        "all_er": ers,
    }
