"""Evaluation CLI: full-split metrics and threshold sweeps of a checkpoint on
a cached fold pack.

  python -m sed_crnn_torch.apps.evaluate --checkpoint best_fold1.npz \\
      --preset sednet-dcase --cache-dir cache/ --fold 1

Several checkpoints (e.g. the per-seed bests of ``apps.train --runs N``) are
scored each on its own (mean and std over members) and as a probability
ensemble (the members' sigmoids averaged):

  python -m sed_crnn_torch.apps.evaluate \\
      --checkpoint fold1/seed*/best_fold1.npz --preset ... --cache-dir ...

Checkpoints are the JAX package's npz files. Runs on ``--device cuda`` by
default and raises without a GPU; ``--device cpu`` runs the kernels' plain
versions. ``--data-parallel`` is not yet ported.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from sed_crnn_torch.core import checkpoint as ckpt_io
from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.data import store
from sed_crnn_torch.models.convert import load_model
from sed_crnn_torch.train.evaluate import evaluate_split


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, nargs="+",
                   help="one checkpoint, or several for per-member mean±std "
                        "plus a probability-ensemble score")
    p.add_argument("--preset", default="timepooled-v2")
    p.add_argument("--cache-dir", required=True)
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--channel-tag", default="mon")
    p.add_argument("--split", default="val", choices=["val", "train"])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--median", type=int, default=0,
                   help="odd width > 1 median-smooths the probability tracks before "
                        "all thresholding (0 = off)")
    p.add_argument("--event-matching", default="optimal", choices=["optimal", "greedy"],
                   help="event-metric pairing: 'optimal' (maximum bipartite, "
                        "order-independent) or 'greedy' (sed_eval's exact "
                        "first-eligible-in-order pairing)")
    p.add_argument("--data-parallel", action="store_true", help="not yet ported")
    p.add_argument("--dump-events",
                   help="directory for the decoded ref_events.txt / est_events.txt "
                        "(with several checkpoints, the ensemble's events)")
    p.add_argument("--out", help="write the JSON report here (default stdout)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    if args.data_parallel:
        raise NotImplementedError(
            "--data-parallel is not yet ported: ROADMAP.md Queue 1 item 4")
    device = resolve_device(args.device)
    cfg = get_preset(args.preset)
    loaded = [ckpt_io.load_checkpoint(c) for c in args.checkpoint]
    models = [load_model(tree, cfg.model, device) for tree, _ in loaded]
    fold = store.load_fold(args.cache_dir, args.fold, args.channel_tag)
    x, y = fold[f"{args.split}_x"], fold[f"{args.split}_y"]

    def run(model, dump=False):
        return evaluate_split(model, x, y, cfg, batch_size=args.batch_size,
                              event_matching=args.event_matching, median_filter=args.median,
                              dump_events_dir=args.dump_events if dump else None,
                              device=device)

    if len(models) == 1:
        report = run(models[0], dump=True)
        report["checkpoint"] = args.checkpoint[0]
        report["checkpoint_epoch"] = loaded[0][1].get("epoch")
    else:
        members = []
        for path, (_, meta), model in zip(args.checkpoint, loaded, models):
            r = run(model)
            members.append({
                "checkpoint": path,
                "checkpoint_epoch": meta.get("epoch"),
                "er_1s": r["er_1s"], "f1_1s": r["f1_1s"],
                "best_er_1s": r["best_er_1s"],
                "best_threshold": r["best_threshold"],
            })
        ers = [m["er_1s"] for m in members]
        f1s = [m["f1_1s"] for m in members]
        report = {
            "n_members": len(members),
            "members": members,
            "mean_er_1s": float(np.mean(ers)),
            "std_er_1s": float(np.std(ers)),
            "mean_f1_1s": float(np.mean(f1s)),
            "std_f1_1s": float(np.std(f1s)),
            "ensemble": run(models, dump=True),
        }
    report["fold"] = args.fold
    report["split"] = args.split

    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text)
    return report


if __name__ == "__main__":
    main()
