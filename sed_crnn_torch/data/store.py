"""Feature-cache files: the fold packs (``mbe_<tag>_fold<k>.npz``: ``arr_0``
to ``arr_3`` = X_train, Y_train, X_test, Y_test, and optionally the recorded
normalization statistics ``arr_4``/``arr_5``) and per-video features. The
readers serving and training need; packing waits."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

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


def load_fold(cache_dir: str, fold_id: int, channel_tag: str = "mon") -> Dict[str, np.ndarray]:
    with np.load(fold_path(cache_dir, fold_id, channel_tag)) as arr:
        fold = {"train_x": arr["arr_0"], "train_y": arr["arr_1"],
                "val_x": arr["arr_2"], "val_y": arr["arr_3"]}
        if "arr_4" in arr.files and "arr_5" in arr.files:
            fold["norm_mean"], fold["norm_scale"] = arr["arr_4"], arr["arr_5"]
    return fold


def load_all_folds(
    cache_dir: str, fold_ids: Sequence[int] = (1, 2, 3, 4), channel_tag: str = "mon"
) -> Dict[int, Dict[str, np.ndarray]]:
    return {k: load_fold(cache_dir, k, channel_tag) for k in fold_ids}
