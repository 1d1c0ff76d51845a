"""Feature-cache files, in the JAX package's (and the reference's) layout:

* per-video ``{base}_{tag}.npz``: ``arr_0`` = log-mel ``(frames, n_feat)``,
  ``arr_1`` = labels ``(frames, n_classes)``;
* per-fold ``mbe_{tag}_fold{k}.npz``: ``arr_0`` to ``arr_3`` = X_train,
  Y_train, X_test, Y_test, the X's standardized with statistics fit on the
  train split only, and ``arr_4``/``arr_5`` = that fit's mean and scale, so
  that serving normalizes with the exact training statistics. Readers of
  the reference's packs read only ``arr_0`` to ``arr_3``.

The statistics are fit with `ops/frontend.py::fit_norm_stats` on the device
the caller names; the files hold numpy arrays.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.ops import frontend


def save_video_features(path: str, mbe: np.ndarray, label: np.ndarray) -> None:
    np.savez(path, mbe, label)


def load_video_features(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as data:
        return data["arr_0"], data["arr_1"]


def video_feature_path(cache_dir: str, video_name: str, channel_tag: str = "mon") -> str:
    base = os.path.splitext(video_name)[0]
    return os.path.join(cache_dir, f"{base}_{channel_tag}.npz")


def fold_path(cache_dir: str, fold_id: int, channel_tag: str = "mon") -> str:
    """1-based fold id, matching the reference's file naming."""
    return os.path.join(cache_dir, f"mbe_{channel_tag}_fold{fold_id}.npz")


def standardize(x_train: np.ndarray, x_test: np.ndarray, device=None):
    """Fit the statistics on ``x_train`` on ``device`` (None means ``cuda``)
    and standardize both splits -> numpy ``(x_train, x_test, mean, scale)``."""
    dev = resolve_device(device)
    train = torch.from_numpy(np.ascontiguousarray(x_train, np.float32)).to(dev)
    stats = frontend.fit_norm_stats(train)
    test = torch.from_numpy(np.ascontiguousarray(x_test, np.float32)).to(dev)
    return tuple(t.cpu().numpy() for t in (frontend.normalize(train, stats),
                                           frontend.normalize(test, stats),
                                           stats.mean, stats.scale))


def save_fold(path: str, x_train, y_train, x_test, y_test, mean, scale) -> None:
    np.savez(path, x_train, y_train, x_test, y_test, mean, scale)


def pack_folds(
    per_video: Mapping[str, Tuple[np.ndarray, np.ndarray, int]],
    cache_dir: str,
    channel_tag: str = "mon",
    device=None,
) -> Dict[int, str]:
    """Concatenate per-video ``(mbe, label, fold_id)`` into per-fold train /
    test packs with train-only standardization, and save them.

    Fold k's test split is the videos with ``fold_id == k - 1`` (0-based ids
    in, 1-based file names out, as in the reference).
    """
    os.makedirs(cache_dir, exist_ok=True)
    fold_ids = sorted({fold for (_, _, fold) in per_video.values()})
    paths: Dict[int, str] = {}
    for fold in fold_ids:
        train_x, train_y, test_x, test_y = [], [], [], []
        for mbe, lbl, f in per_video.values():
            (test_x if f == fold else train_x).append(mbe)
            (test_y if f == fold else train_y).append(lbl)
        if not train_x or not test_x:
            raise ValueError(f"fold {fold}: empty train or test split")
        x_train, x_test, mean, scale = standardize(
            np.concatenate(train_x, axis=0), np.concatenate(test_x, axis=0), device)
        out = fold_path(cache_dir, fold + 1, channel_tag)
        save_fold(out, x_train, np.concatenate(train_y, axis=0), x_test,
                  np.concatenate(test_y, axis=0), mean, scale)
        paths[fold + 1] = out
    return paths


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
