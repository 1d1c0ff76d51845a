"""Multi-seed training: the k-fold experiment repeated over N seeds and
reported as the mean and std over seeds of the cross-fold average ER/F1
(the reference README's "averaged over 4 cross-validation folds, mean of 5
runs").

Counterpart of the JAX package's `train/multiseed.py`, sequential mode: each
seed trains each fold through `run_fold(seed=s)` into
``<art_dir>/fold<k>/seed<s>/``, `run_fold`'s own layout (best and last
checkpoints, one jsonl record per epoch), so seed s of this experiment is
exactly ``run_fold(seed=s)`` and resumes as one. The JAX package's stacked
mode (all seeds of a fold as one ``vmap``-ed program) and its mode chooser,
whose split point is a TPU measurement, are not ported: ``mode="stacked"``
raises and ``mode="auto"`` means sequential.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from sed_crnn_torch.core.config import ExperimentConfig
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.train import artifacts
from sed_crnn_torch.train.loop import FoldResult, run_fold

# Spacing between generated run seeds. `run_fold` seeds each run from
# seed + fold_id, so consecutive run seeds would collide across (run, fold)
# pairs; a prime stride far above any fold count keeps them distinct.
SEED_STRIDE = 7919


def run_seeds(base_seed: int, n_runs: int) -> List[int]:
    """The default seed list for an N-run experiment."""
    return [base_seed + r * SEED_STRIDE for r in range(n_runs)]


def run_experiment_multiseed(
    cfg: ExperimentConfig,
    folds: Dict[int, Dict[str, np.ndarray]],
    art_dir: str,
    seeds: Optional[Sequence[int]] = None,
    n_runs: int = 5,
    verbose: bool = True,
    mode: str = "auto",
    device=None,
) -> Dict[str, Any]:
    """Train every fold once per seed (``seeds``, or ``run_seeds(cfg.train.
    seed, n_runs)``), one `run_fold` after another; returns the seed-major
    mean and std of the best ER/F1 (each seed's cross-fold mean first), the
    per-seed values, the seeds and the `FoldResult`s, and appends all but
    the results to ``experiment_multiseed.jsonl``.

    ``mode``: "sequential", or "auto", which is sequential until stacked
    mode is ported; "stacked" raises.
    ``device``: None means ``cuda`` (raises without a GPU)."""
    if mode not in ("auto", "stacked", "sequential"):
        raise ValueError(f"mode must be 'auto', 'stacked' or 'sequential', got {mode!r}")
    if mode == "stacked":
        raise NotImplementedError(
            "stacked multi-seed training is not yet ported (ROADMAP.md Queue 1 item 3); "
            "use mode='sequential'")
    dev = resolve_device(device)
    seeds = list(run_seeds(cfg.train.seed, n_runs) if seeds is None else seeds)
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"duplicate seeds in {seeds}: runs would be identical")
    per_fold: Dict[int, List[FoldResult]] = {}
    for fold_id, fold_data in sorted(folds.items()):
        fold_dir = os.path.join(art_dir, f"fold{fold_id}")
        per_fold[fold_id] = [
            run_fold(cfg, fold_data, fold_id, os.path.join(fold_dir, f"seed{s}"), seed=s,
                     verbose=verbose, device=dev)
            for s in seeds
        ]
    er_by_seed = [float(np.mean([per_fold[f][j].best_er for f in per_fold]))
                  for j in range(len(seeds))]
    f1_by_seed = [float(np.mean([per_fold[f][j].best_f1 for f in per_fold]))
                  for j in range(len(seeds))]
    out = {
        "mean_er": float(np.mean(er_by_seed)),
        "std_er": float(np.std(er_by_seed)),
        "mean_f1": float(np.mean(f1_by_seed)),
        "std_f1": float(np.std(f1_by_seed)),
        "er_by_seed": er_by_seed,
        "f1_by_seed": f1_by_seed,
        "seeds": seeds,
        "folds": per_fold,
    }
    if verbose:
        print(f"{len(seeds)}-run protocol: ER {out['mean_er']:.3f} ± {out['std_er']:.3f}"
              f" | F1 {out['mean_f1']:.3f} ± {out['std_f1']:.3f}")
    artifacts.append_jsonl(
        os.path.join(art_dir, "experiment_multiseed.jsonl"),
        {k: v for k, v in out.items() if k != "folds"} | {"experiment": cfg.name},
    )
    return out
