"""Export a trained checkpoint as a self-contained serving artifact.

  python -m sed_crnn_torch.apps.export --checkpoint best_fold1.npz \\
      --preset sednet-dcase --stats-from /path/to/cache --fold 1 \\
      --out model.sedart

The artifact (`models/export.py`) holds the weights, the fold's train-split
normalization statistics and the tuned thresholds; `apps/infer.py
--artifact` and `apps/serve.py` serve from it alone. Checkpoints are the JAX
package's npz files; several export their probability ensemble. The
artifact runs wherever this package runs (``cuda`` or ``cpu``), so there is
no ``--platforms``; ``--device`` is where the export builds the model
(``cuda`` by default). ``--format tf`` (a TF SavedModel) is not ported.
"""

from __future__ import annotations

import argparse
import json
import os

from sed_crnn_torch.apps.infer import stats_from_fold
from sed_crnn_torch.core import checkpoint as ckpt_io
from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.models.export import export_serving, stack_trees


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, nargs="+",
                   help="npz checkpoint path; several paths (e.g. the per-seed bests of "
                        "apps.train --runs N) export their probability ensemble")
    p.add_argument("--preset", default="timepooled-v1")
    p.add_argument("--out", required=True, help="output artifact path (.sedart)")
    p.add_argument("--stats-from", default=None,
                   help="feature-cache dir; folds the train-split norm stats into the "
                        "artifact (serving then takes raw log-mel features)")
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--channel-tag", default="mon")
    p.add_argument("--compute-dtype", default=None,
                   help="override the conv trunk's activation dtype (e.g. bfloat16)")
    p.add_argument("--format", choices=("sedart", "tf"), default="sedart",
                   help="sedart: the serving artifact; tf (a TF SavedModel) is not ported")
    p.add_argument("--threshold", type=float, nargs="+", default=None,
                   help="default binarization threshold baked into the artifact: one "
                        "global value, or one per class")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    if args.format == "tf":
        p.error("--format tf is not ported to sed_crnn_torch (the JAX package writes "
                "it through jax2tf); export --format sedart")
    default_threshold = None
    if args.threshold is not None:
        default_threshold = args.threshold[0] if len(args.threshold) == 1 else args.threshold

    cfg = get_preset(args.preset)
    loaded = [ckpt_io.load_checkpoint(c) for c in args.checkpoint]
    n_members = len(loaded) if len(loaded) > 1 else 0
    if n_members:
        params = stack_trees([t["params"] for t, _ in loaded])
        state = stack_trees([t["model_state"] for t, _ in loaded])
        meta = {"members": [m for _, m in loaded]}
    else:
        tree, meta = loaded[0]
        params, state = tree["params"], tree["model_state"]

    norm_stats = None
    if args.stats_from:
        norm_stats = stats_from_fold(args.stats_from, args.fold, channel_tag=args.channel_tag,
                                     device=args.device)
        if norm_stats is None:
            p.error(
                f"--stats-from {args.stats_from}: no fold pack or per-video features for "
                f"fold {args.fold} (tag {args.channel_tag!r}); refusing to export without "
                f"the requested statistics"
            )

    artifact = export_serving(
        cfg, params, state, norm_stats=norm_stats, preset=args.preset,
        compute_dtype=args.compute_dtype, ensemble_members=n_members,
        default_threshold=default_threshold, device=args.device,
    )
    artifact.save(args.out)
    out = {
        "artifact": args.out,
        "format": "sedart",
        "bytes": os.path.getsize(args.out),
        "platforms": artifact.meta["platforms"],
        "norm_folded": artifact.meta["norm_folded"],
        "default_threshold": artifact.meta["default_threshold"],
        "ensemble_members": n_members,
        "checkpoint_meta": meta,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
