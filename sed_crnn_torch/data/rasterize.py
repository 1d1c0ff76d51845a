"""Frame labels -> event intervals (the inverse of rasterization)."""

from __future__ import annotations

import numpy as np

from sed_crnn_torch.ops.event_metrics import events_from_roll


def events_from_labels(labels: np.ndarray, sr: int, hop: int, threshold=0.5):
    """Contiguous active runs -> ``(start_s, end_s, class)`` tuples.
    ``threshold``: one float, or a per-class vector (n_classes,)."""
    return events_from_roll(labels, hop / sr, threshold)
