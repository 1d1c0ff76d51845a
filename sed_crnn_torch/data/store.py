"""Feature-cache files: the fold packs' recorded normalization statistics
and per-video features (the readers serving needs; packing waits)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def load_video_features(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as data:
        return data["arr_0"], data["arr_1"]


def fold_path(cache_dir: str, fold_id: int, channel_tag: str = "mon") -> str:
    """1-based fold id, matching the reference's file naming."""
    return os.path.join(cache_dir, f"mbe_{channel_tag}_fold{fold_id}.npz")


def load_fold_stats(
    cache_dir: str, fold_id: int, channel_tag: str = "mon"
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The (mean, scale) this fold's features were standardized with, if the
    pack recorded them (``arr_4``/``arr_5``)."""
    path = fold_path(cache_dir, fold_id, channel_tag)
    if not os.path.exists(path):
        return None
    with np.load(path) as arr:
        if "arr_4" in arr.files and "arr_5" in arr.files:
            return arr["arr_4"], arr["arr_5"]
    return None
