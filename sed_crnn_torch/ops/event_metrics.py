"""Event decoding from frame rolls (the part of the JAX package's
`ops/event_metrics.py` that serving needs; the event-based metrics wait)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Event = Tuple[float, float, int]


def events_from_roll(roll: np.ndarray, frame_hop_s: float, threshold=0.5) -> List[Event]:
    """Binary/probability frame roll (frames, classes) -> event list of
    ``(start_s, end_s, class)``. ``threshold``: one global float, or a
    per-class vector (n_classes,)."""
    events: List[Event] = []
    active = np.asarray(roll) > np.asarray(threshold)
    for cls in range(active.shape[1]):
        col = active[:, cls].astype(np.int8)
        edges = np.flatnonzero(np.diff(np.concatenate([[0], col, [0]])))
        for s, e in zip(edges[::2], edges[1::2]):
            events.append((s * frame_hop_s, e * frame_hop_s, cls))
    return events
