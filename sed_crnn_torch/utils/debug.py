"""Debug-mode numerical guards: opt-in NaN/Inf detection and shape contracts
at the host boundary.

Counterpart of the JAX package's `utils/debug.py`, with its five names and
messages. Trees are nested dicts, lists and tuples whose leaves are torch
tensors (on any device), numpy arrays or Python numbers; ``None`` is an
empty subtree. A leaf's path is written as JAX's ``keystr`` writes it
(``['gru'][0]['fwd']['wh']``), with dict keys in sorted order as JAX
flattens them, so the same tree gives the same `NonFiniteError` text and
the same `tree_norms` keys in both packages.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch


class NonFiniteError(RuntimeError):
    pass


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) in JAX's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))


def assert_tree_finite(tree: Any, label: str = "tree") -> None:
    """Raise NonFiniteError naming every offending leaf path (one device
    fetch per leaf; intended for debug mode and post-mortems)."""
    bad = []
    for path, leaf in _leaves(tree):
        t = _tensor(leaf)
        n_bad = int((~torch.isfinite(t)).sum())
        if n_bad:
            bad.append(f"{path}: {n_bad}/{t.numel()} non-finite")
    if bad:
        raise NonFiniteError(f"{label} contains non-finite values:\n  " + "\n  ".join(bad))


def tree_norms(tree: Any) -> dict:
    """Per-leaf L2 norms (host floats) for drift monitoring."""
    return {path: float(torch.sqrt(torch.sum(_tensor(leaf).float() ** 2)))
            for path, leaf in _leaves(tree)}


def check_shape(x, expected: Tuple[int, ...], label: str = "array") -> None:
    got = tuple(x.shape)
    if len(got) != len(expected) or any(
        e not in (-1, g) for e, g in zip(expected, got)
    ):
        raise ValueError(f"{label}: expected shape {expected}, got {got}")


def guard_scores(scores: dict, epoch: int, fold: int) -> None:
    """Fail fast (with context) when a training epoch produces a non-finite
    loss: the hook `run_fold(debug=True)` installs."""
    loss = float(scores.get("loss", 0.0))
    if not np.isfinite(loss):
        raise NonFiniteError(
            f"fold {fold} epoch {epoch}: non-finite loss {loss} "
            "(inspect the last checkpoint and per-leaf grad norms)"
        )
