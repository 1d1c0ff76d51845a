"""Training CLI: k-fold training of a preset on cached fold packs or on
synthetic folds.

  python -m sed_crnn_torch.apps.train --preset sednet-dcase --cache-dir DIR
  python -m sed_crnn_torch.apps.train --preset sednet-dcase --synthetic --plot-every 0

Artifacts land under ``--art-dir/<timestamp>/fold<k>``: the JAX package's
npz checkpoints, one jsonl record per epoch and, with ``--plot-every`` > 0,
PNG plots (which need matplotlib). Runs on ``--device cuda`` by default and
raises without a GPU; ``--device cpu`` runs the kernels' plain versions.

``--runs N`` repeats the experiment over N seeds into ``fold<k>/seed<s>/``
and reports the mean and std over seeds (``experiment_multiseed.jsonl``):
``--runs-mode stacked`` trains all seeds of a fold as one stacked model,
``sequential`` one `run_fold` after another, and ``auto`` (the default)
picks by `train.multiseed.choose_runs_mode`. ``--data-parallel`` and
``--seed-parallel`` are not yet ported (ROADMAP.md Queue 1 item 4).
``--slow-prng`` is accepted and changes nothing: `torch.Generator` has one
PRNG, where JAX chooses between threefry and rbg.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os

import numpy as np

from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.data import store
from sed_crnn_torch.data.rasterize import rasterize_events
from sed_crnn_torch.train import loop as train_loop
from sed_crnn_torch.train import multiseed


def synthetic_folds(k: int = 2, frames: int = 8000, seed: int = 0, n_classes: int = 1,
                    n_mels: int = 40, in_channels: int = 1):
    """Planted-signature folds matching a preset's label width: each class
    paints its own mel band so the model has something learnable; binaural
    presets get channel-stacked features. The same numpy draws as the JAX
    package's `synthetic_folds`, so one seed gives one dataset in both."""
    rng = np.random.default_rng(seed)
    band = max(2, n_mels // max(n_classes, 1) // 2)

    def split(n):
        mel = rng.standard_normal((n, n_mels * in_channels)).astype(np.float32)
        events, cls_ids, t = [], [], 2.0
        while t * 43 < n - 100:
            events.append((t, t + rng.uniform(0.2, 0.5)))
            cls_ids.append(int(rng.integers(0, n_classes)))
            t += rng.uniform(2.0, 4.0)
        lab = rasterize_events(events, n, 44100, 1024, n_classes, cls_ids)
        for c in range(n_classes):
            lo = (c * band) % max(n_mels - band, 1)
            for ch in range(in_channels):
                off = ch * n_mels
                mel[lab[:, c] == 1, off + lo : off + lo + band] += 4.0
        return mel, lab

    folds = {}
    for f in range(1, k + 1):
        tr = split(frames)
        va = split(frames // 2)
        folds[f] = {"train_x": tr[0], "train_y": tr[1], "val_x": va[0], "val_y": va[1]}
    return folds


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="timepooled-v1",
                   help="timepooled-v1 | timepooled-v2 | sednet-dcase[-binaural|-binmul|-keras]")
    p.add_argument("--cache-dir", help="feature cache dir with mbe_*_fold*.npz")
    p.add_argument("--channel-tag", default="mon", help="mon | bin | binmul")
    p.add_argument("--art-dir", default="train_artifacts")
    p.add_argument("--folds", type=int, nargs="+", default=[1, 2, 3, 4])
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--plot-every", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume each fold from its last checkpoint if present")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated data (smoke/benchmark run)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--runs", type=int, default=1, metavar="N",
                   help="repeat the experiment over N seeds and report mean±std ER/F1 "
                        "(the reference README's 'mean of 5 runs' protocol)")
    p.add_argument("--runs-mode", choices=("auto", "stacked", "sequential"), default="auto",
                   help="with --runs: 'stacked' trains all seeds of a fold as one model, "
                        "'sequential' one after another; 'auto' (default) picks the one "
                        "measured faster for the preset (choose_runs_mode)")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="not yet ported (ROADMAP.md Queue 1 item 4)")
    p.add_argument("--seed-parallel", type=int, default=0,
                   help="not yet ported (ROADMAP.md Queue 1 item 4)")
    p.add_argument("--slow-prng", action="store_true",
                   help="accepted for the JAX CLI's command lines, where it keeps threefry in "
                        "place of rbg; torch.Generator has one PRNG, so it selects nothing here")
    args = p.parse_args(argv)

    for flag, value in (("--data-parallel", args.data_parallel),
                        ("--seed-parallel", args.seed_parallel)):
        if value:
            raise NotImplementedError(f"{flag} is not yet ported (ROADMAP.md Queue 1 item 4)")
    device = resolve_device(args.device)

    cfg = get_preset(args.preset)
    overrides = {k: v for k, v in (
        ("max_epochs", args.max_epochs), ("batch_size", args.batch_size),
        ("learning_rate", args.lr), ("seed", args.seed), ("plot_every", args.plot_every),
    ) if v is not None}
    if overrides:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **overrides))

    if args.synthetic:
        # enough frames that the sequence sampler fills one batch of
        # seq_len_in windows per epoch (sednet: 128 x 256-frame sequences)
        min_frames = int(cfg.train.batch_size * cfg.model.seq_len_in * 1.3)
        folds = {
            f: fd for f, fd in synthetic_folds(
                max(args.folds), frames=max(8000, min_frames), n_classes=cfg.model.n_classes,
                n_mels=cfg.model.n_mels, in_channels=cfg.model.in_channels,
            ).items() if f in args.folds
        }
    else:
        if not args.cache_dir:
            p.error("--cache-dir required unless --synthetic")
        folds = store.load_all_folds(args.cache_dir, args.folds, args.channel_tag)

    # --resume continues the most recent run under --art-dir
    art_root = None
    if args.resume and os.path.isdir(args.art_dir):
        runs = sorted(d for d in os.listdir(args.art_dir)
                      if os.path.isdir(os.path.join(args.art_dir, d)))
        if runs:
            art_root = os.path.join(args.art_dir, runs[-1])
            print(f"resuming run {art_root}")
    if art_root is None:
        art_root = os.path.join(args.art_dir, f"{datetime.datetime.now():%Y%m%d_%H%M%S}")
    os.makedirs(art_root, exist_ok=True)
    print(f"ARTIFACTS -> {art_root}")

    if args.runs > 1:
        if args.resume:
            p.error("--resume with --runs: resume individual seeds via "
                    "run_fold(resume_from=<seed dir>/last_fold<k>.npz) instead")
        return multiseed.run_experiment_multiseed(cfg, folds, art_root, n_runs=args.runs,
                                                  mode=args.runs_mode, device=device)
    if args.resume:
        results = []
        for fold_id, fold_data in sorted(folds.items()):
            fold_dir = os.path.join(art_root, f"fold{fold_id}")
            last = os.path.join(fold_dir, f"last_fold{fold_id}.npz")
            results.append(train_loop.run_fold(
                cfg, fold_data, fold_id, fold_dir,
                resume_from=last if os.path.exists(last) else None, device=device))
        print(f"average ER across folds: {float(np.mean([r.best_er for r in results])):.3f}")
        return results
    return train_loop.run_experiment(cfg, folds, art_root, device=device)


if __name__ == "__main__":
    main()
