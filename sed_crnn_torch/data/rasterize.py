"""Event intervals <-> frame labels: rasterization with the reference's
floor/ceil rule, and its inverse."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from sed_crnn_torch.ops.event_metrics import events_from_roll


def rasterize_events(
    events: Sequence[Tuple[float, float]],
    n_frames: int,
    sr: int,
    hop: int,
    n_classes: int = 1,
    class_ids: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Fill 1.0 over ``[floor(start*sr/hop), ceil(end*sr/hop))`` per event in
    column ``class_ids[i]`` (all zeros when None) -> (n_frames, n_classes)."""
    lbl = np.zeros((n_frames, n_classes), dtype=np.float32)
    if class_ids is None:
        class_ids = [0] * len(events)
    for (start, end), cls in zip(events, class_ids):
        s = max(int(np.floor(start * sr / hop)), 0)
        e = min(int(np.ceil(end * sr / hop)), n_frames)
        if e > s:
            lbl[s:e, cls] = 1.0
    return lbl


def events_from_labels(labels: np.ndarray, sr: int, hop: int, threshold=0.5):
    """Contiguous active runs -> ``(start_s, end_s, class)`` tuples.
    ``threshold``: one float, or a per-class vector (n_classes,)."""
    return events_from_roll(labels, hop / sr, threshold)
