"""Full-split evaluation with threshold sweeps (BASELINE config 4).

Counterpart of the JAX package's `train/evaluate.py`. Unlike validation
during training, this scores the whole split: sequential windows without
overlap, the ragged tail dropped (the reference's `split_in_seqs`), a
batched forward in eval mode, then the base scores at the configured
threshold, the global and per-class threshold sweeps, the class-wise report
and the event-based scores.

Two parts, so that a caller can score a probability roll it already has:

* `forward_probabilities`: the windows padded with zeros to whole batches,
  each batch through every member (a sequence of `CRNN`s is a probability
  ensemble: the members' sigmoids averaged in float32, where the JAX
  package stacks member trees under ``vmap``), the padding trimmed;
* `score_rolls`: the flat probability and label rolls -> the report. The
  median filter and both sweeps run on the rolls' device; only event
  decoding, matching and the JSON-ready values go to the host.

With a data mesh (`parallel/mesh.py`, one process per card), the windows are
padded to a multiple of ``batch_size x world``, rank r forwards its
contiguous block of batches (ensembles replicated on every rank), and the
probabilities are gathered in window order before scoring: each batch goes
through the same forward as on one device, so the report is the
single-device report, on every rank.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from sed_crnn_torch.core.config import ExperimentConfig
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.data.eventio import default_class_names, write_event_list
from sed_crnn_torch.models.crnn import CRNN
from sed_crnn_torch.ops import metrics as metrics_ops
from sed_crnn_torch.ops.event_metrics import (
    class_wise_event_scores,
    event_scores,
    events_from_roll,
)
from sed_crnn_torch.ops.postprocess import median_smooth
from sed_crnn_torch.parallel.mesh import Mesh, all_gather

DEFAULT_THRESHOLDS = np.round(np.arange(0.05, 0.96, 0.05), 3).astype(np.float32)


def window_split(x: np.ndarray, y: np.ndarray, seq_len_in: int, seq_len_out: int):
    """Full-split sequential windows: (frames, F) -> (N, T, F) and labels
    max-pooled to (N, T_out, C), the ragged tail dropped."""
    n = (x.shape[0] // seq_len_in) * seq_len_in
    xw = x[:n].reshape(-1, seq_len_in, x.shape[1])
    pool = seq_len_in // seq_len_out
    yw = y[:n].reshape(-1, seq_len_out, pool, y.shape[1]).max(axis=2)
    return xw, yw


def forward_probabilities(models: Sequence[CRNN], xw: np.ndarray, batch_size: int,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sigmoid probabilities (N, T_out, C) of every window on the models'
    device: eval mode, no autograd, ``ceil(N / batch_size)`` batches (the
    last padded with zero windows, trimmed from the result); with several
    models, the float32 mean of their sigmoids per batch. With a ``mesh``,
    the batches are padded to a multiple of its size, rank r forwards its
    contiguous share and every rank returns all windows in order."""
    dev = next(models[0].parameters()).device
    n = xw.shape[0]
    world, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    pad = (-n) % (batch_size * world)
    share = (n + pad) // world
    xw = xw[rank * share : (rank + 1) * share]
    x = torch.from_numpy(np.ascontiguousarray(xw, dtype=np.float32)).to(dev)
    if x.shape[0] < share:
        x = torch.cat([x, x.new_zeros((share - x.shape[0], *x.shape[1:]))])
    out = []
    with torch.no_grad():
        for i in range(0, x.shape[0], batch_size):
            xb = x[i : i + batch_size]
            out.append(torch.stack([torch.sigmoid(m(xb)[0]) for m in models]).mean(dim=0))
    probs = torch.cat(out)
    if mesh is not None:
        probs = all_gather(probs, mesh).reshape(-1, *probs.shape[1:])
    return probs[:n]


def evaluate_split(
    model: Union[CRNN, Sequence[CRNN]],
    x: np.ndarray,
    y: np.ndarray,
    cfg: ExperimentConfig,
    thresholds: Optional[np.ndarray] = None,
    batch_size: int = 256,
    event_matching: str = "optimal",
    mesh=None,
    median_filter: int = 0,
    dump_events_dir: Optional[str] = None,
    device=None,
) -> Dict:
    """Evaluate one (features, labels) split -> the report of `score_rolls`.

    ``model``: one `CRNN`, or a sequence of them scored as a probability
    ensemble; each is moved to ``device`` (None means ``cuda``, which
    raises without a GPU) and put in eval mode. ``event_matching``:
    "optimal" or "greedy" (sed_eval's pairing). ``median_filter``: an odd
    width > 1 median-smooths the probability tracks before all
    thresholding. ``dump_events_dir``: also write the decoded
    ``ref_events.txt`` / ``est_events.txt`` (rank 0 of a mesh). ``mesh``: a
    data mesh (`parallel/mesh.py`) whose ranks share the windows; the models
    go to its device, and every rank returns the single-device report."""
    dev = resolve_device(device) if mesh is None else mesh.device
    models = [model] if isinstance(model, CRNN) else list(model)
    if not models:
        raise ValueError("need at least one model")
    m = cfg.model
    xw, yw = window_split(x, y, m.seq_len_in, m.seq_len_out)
    n = xw.shape[0]
    if n == 0:
        raise ValueError(f"split has {x.shape[0]} frames < one {m.seq_len_in}-frame window")
    probs = forward_probabilities([mm.to(dev).eval() for mm in models], xw, batch_size, mesh)
    flat_p = probs.reshape(-1, probs.shape[-1])
    flat_y = torch.from_numpy(np.ascontiguousarray(yw.reshape(-1, yw.shape[-1]))).to(dev)
    if mesh is not None and mesh.rank != 0:
        dump_events_dir = None
    return score_rolls(flat_p, flat_y, cfg, n, thresholds, event_matching, median_filter,
                       dump_events_dir)


def _masked(values, present):
    return [v if p else None for v, p in zip(values, present)]


def score_rolls(
    flat_p: torch.Tensor,
    flat_y: torch.Tensor,
    cfg: ExperimentConfig,
    n_windows: int,
    thresholds: Optional[np.ndarray] = None,
    event_matching: str = "optimal",
    median_filter: int = 0,
    dump_events_dir: Optional[str] = None,
) -> Dict:
    """The report of a split from its flat probability roll ``flat_p`` and
    label roll ``flat_y`` (frames, C), time-contiguous window after window:
    scores at ``cfg.train.threshold`` with the confusion counts, the global
    sweep and its best-ER point, the per-class sweep (more than one class),
    the class-wise segment and event scores (``None`` for absent classes)
    and the event-based ER/F1, decoded at ``hop_length * pool /
    sample_rate`` seconds per output frame. Keys and JSON types as the JAX
    package's report."""
    tc = cfg.train
    thresholds = DEFAULT_THRESHOLDS if thresholds is None else np.asarray(thresholds)
    if median_filter > 1:
        # sequential non-overlapping windows: the running median crosses
        # window boundaries as it would on one long roll
        flat_p = median_smooth(flat_p, median_filter)
    flat_y = flat_y.float()
    binary = (flat_p > torch.tensor(tc.threshold, dtype=torch.float32,
                                    device=flat_p.device)).float()
    base = metrics_ops.all_scores(binary, flat_y, tc.frames_in_1_sec)
    sweep = metrics_ops.best_threshold(flat_p, flat_y, thresholds, tc.frames_in_1_sec)
    class_wise = metrics_ops.class_wise_report(binary, flat_y, tc.frames_in_1_sec)
    n_classes = int(flat_y.shape[-1])
    per_class_sweep = None
    if n_classes > 1:
        pc = metrics_ops.best_per_class_thresholds(flat_p, flat_y, thresholds,
                                                   tc.frames_in_1_sec)
        present = pc["class_present"].tolist()
        per_class_sweep = {
            "thresholds": pc["thresholds"].tolist(),
            "er_1s": float(pc["er"]),
            "f1_1s": float(pc["f1"]),
            "class_er_1s": _masked(pc["class_er"].tolist(), present),
            "class_f1_1s": _masked(pc["class_f1"].tolist(), present),
        }

    # Event-based scores on the host, over the time-ordered roll (window
    # boundaries' truncation gaps ignored).
    pool = cfg.model.seq_len_in // cfg.model.seq_len_out
    frame_hop_s = cfg.frontend.hop_length * pool / cfg.frontend.sample_rate
    sys_ev = events_from_roll(flat_p.cpu().numpy(), frame_hop_s, tc.threshold)
    ref_ev = events_from_roll(flat_y.cpu().numpy(), frame_hop_s, 0.5)
    ev = event_scores(ref_ev, sys_ev, matching=event_matching)
    cw_ev = class_wise_event_scores(ref_ev, sys_ev, n_classes=n_classes,
                                    matching=event_matching)
    class_wise_event = [
        {
            "f1_event": float(s["f1_event"]),
            # no reference events: ER is 0/0, None instead of NaN in JSON
            "er_event": float(s["er_event"]) if s["n_ref"] else None,
            "n_ref": s["n_ref"],
            "n_sys": s["n_sys"],
        }
        for _, s in sorted(cw_ev.items())
    ]
    if dump_events_dir is not None:
        names = default_class_names(n_classes)
        os.makedirs(dump_events_dir, exist_ok=True)
        write_event_list(os.path.join(dump_events_dir, "ref_events.txt"), ref_ev, names)
        write_event_list(os.path.join(dump_events_dir, "est_events.txt"), sys_ev, names)

    return {
        **({"per_class_sweep": per_class_sweep} if per_class_sweep else {}),
        "er_event": ev["er_event"],
        "f1_event": ev["f1_event"],
        "class_wise": class_wise,
        "class_wise_event": class_wise_event,
        "n_windows": int(n_windows),
        "median_filter": int(median_filter),
        "confusion": {k: int(base[k]) for k in ("tn", "fp", "fn", "tp")},
        "threshold": float(tc.threshold),
        "er_1s": float(base["er_overall_1sec"]),
        "f1_1s": float(base["f1_overall_1sec"]),
        "er_frame": float(base["er_frame"]),
        "f1_frame": float(base["f1_frame"]),
        "best_threshold": float(sweep["threshold"]),
        "best_er_1s": float(sweep["er"]),
        "best_f1_1s": float(sweep["f1"]),
        "sweep": {
            "thresholds": [float(v) for v in thresholds],
            "er_1s": sweep["all_er"].tolist(),
            "f1_1s": sweep["all_f1"].tolist(),
        },
    }
