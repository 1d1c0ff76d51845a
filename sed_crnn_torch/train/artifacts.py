"""Training artifacts: structured jsonl logs, loss curves and metric panels.

Counterpart of the JAX package's `train/artifacts.py`. matplotlib is
imported inside the plot functions only, so that training runs where it is
not installed as long as plotting is off (``plot_every=0``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


def log_save(path: str) -> None:
    print(f"saved -> {path}")


def append_jsonl(path: str, record: Dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    record = dict(record)
    record.setdefault("time", round(time.time(), 3))
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_loss_curve(path: str, train_losses: List[float], val_losses: List[float]) -> None:
    plt = _pyplot()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    plt.figure(figsize=(5, 3))
    plt.plot(train_losses, label="train")
    plt.plot(val_losses, label="val")
    plt.grid()
    plt.xlabel("epoch")
    plt.ylabel("loss")
    plt.legend()
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


def _confusion_axes(ax, cm, title):
    import numpy as np

    cm = np.asarray(cm)
    ax.imshow(cm, cmap="Blues")
    peak = max(cm.max(), 1)
    for i in range(2):
        for j in range(2):
            ax.text(j, i, f"{int(cm[i][j])}", ha="center", va="center",
                    color="white" if cm[i][j] > peak / 2 else "black")
    ax.set_xticks([0, 1])
    ax.set_yticks([0, 1])
    ax.set_xlabel("Pred")
    ax.set_ylabel("True")
    ax.set_title(title)


def save_metrics_panel(
    path: str,
    track: Dict[str, List[float]],
    train_cm: Optional[List[List[float]]] = None,
    val_cm: Optional[List[List[float]]] = None,
    epoch: int = 0,
) -> None:
    """2x3 panel: loss / F1(1 s) / ER(1 s) curves, train and val confusion
    matrices, framewise F1 curve."""
    plt = _pyplot()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    plt.figure(figsize=(14, 6))

    def curves(ax, tr_key, val_key, title):
        ax.plot(track.get(tr_key, []), label="train")
        ax.plot(track.get(val_key, []), label="val")
        ax.set_title(title)
        ax.set_xlabel("Epoch")
        ax.grid()
        ax.legend()

    curves(plt.subplot(2, 3, 1), "loss_tr", "loss_val", "Loss")
    curves(plt.subplot(2, 3, 2), "f1_1s_tr", "f1_1s_val", "F1 (1 s)")
    curves(plt.subplot(2, 3, 3), "er_1s_tr", "er_1s_val", "ER (1 s)")
    if train_cm is not None:
        _confusion_axes(plt.subplot(2, 3, 4), train_cm, f"Train CM (e{epoch})")
    if val_cm is not None:
        _confusion_axes(plt.subplot(2, 3, 5), val_cm, f"Val CM (e{epoch})")
    curves(plt.subplot(2, 3, 6), "f1_fr_tr", "f1_fr_val", "F1 (frame)")
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
