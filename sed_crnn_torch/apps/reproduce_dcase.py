"""One-command reproduction of the reference's headline DCASE numbers.

Counterpart of the JAX package's ``scripts/reproduce_dcase.py``. The
reference's published table is the 1-second segment ER/F1 of SEDnet on DCASE
2017 Task 3 (street scene), 4-fold cross-validation, mean of 5 runs: ER 0.60
/ F1 0.57 single-channel, ER 0.60 / F1 0.59 binaural. This script runs that
protocol end to end on a local copy of the corpus (TUT Sound Events 2017,
development set) and prints the comparison.

  python -m sed_crnn_torch.apps.reproduce_dcase --dcase-root TUT-sound-events-2017-development
  python -m sed_crnn_torch.apps.reproduce_dcase --dcase-root ... --binaural --runs 5

Stages: (1) feature extraction (`apps.feature`; per-file work already cached
is skipped, and the default cache ``<dcase-root>/sedtpu_cache`` is the JAX
script's, whose files the port reads as they are), (2) the folds x N-seed
training (`run_experiment_multiseed`; `run_experiment` at ``--runs 1``),
(3) the protocol report against the published baseline, as one JSON line. ``--smoke`` shrinks the model and sequences for a fast
correctness pass on a miniature corpus. ``--seed-parallel N`` shards the
seeds over N devices, one process each: stage 1 runs once (rank 0 under
torch's launcher), then stage 2 spawns N local ranks, or runs as the
launcher's ranks; rank 0 prints the report and writes ``--out``. Runs on
``--device cuda`` by default and raises without a GPU. Stage 1 runs the
feature CLI's default frontend (``fft``), as the JAX script does. The
preset's per-epoch plots need matplotlib: where it is not installed, the
script says so on stderr before stage 1 and trains without them (the
numbers are the same).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys

from sed_crnn_torch.apps import feature as feature_app
from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.data import store
from sed_crnn_torch.parallel import mesh as mesh_mod
from sed_crnn_torch.train import loop as train_loop
from sed_crnn_torch.train import multiseed

BASELINES = {  # the reference README's published table
    "mon": {"er": 0.60, "f1": 0.57},
    "bin": {"er": 0.60, "f1": 0.59},
}


def _protocol(cfg, cache, folds, tag, art_dir, runs, n_ranks, device):
    """Stage 2 -> (mean ER, mean F1, std ER, std F1); with ``n_ranks``,
    over a seed mesh of this process's group (or world size 1)."""
    fold_data = store.load_all_folds(cache, folds, tag)
    if runs > 1:
        mesh = mesh_mod.make_mesh(n_ranks, mesh_mod.SEED_AXIS, device) if n_ranks else None
        try:
            out = multiseed.run_experiment_multiseed(
                cfg, fold_data, art_dir, n_runs=runs, device=device, mesh=mesh)
        finally:
            if mesh is not None:
                mesh.close()
        return out["mean_er"], out["mean_f1"], out["std_er"], out["std_f1"]
    out = train_loop.run_experiment(cfg, fold_data, art_dir, device=device)
    return out["mean_er"], out["mean_f1"], 0.0, 0.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dcase-root", required=True,
                   help="dataset root (audio/<scene>/ + evaluation_setup/)")
    p.add_argument("--cache-dir", default=None,
                   help="feature cache (default <dcase-root>/sedtpu_cache)")
    p.add_argument("--art-dir", default="reproduce_dcase_art")
    p.add_argument("--scene", default="street")
    p.add_argument("--binaural", action="store_true")
    p.add_argument("--preset", default=None,
                   help="default sednet-dcase[-binaural]")
    p.add_argument("--runs", type=int, default=5,
                   help="seeds in the mean-of-N protocol (README uses 5)")
    p.add_argument("--folds", type=int, nargs="+", default=[1, 2, 3, 4])
    p.add_argument("--max-epochs", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed-parallel", type=int, default=0,
                   help="shard the seed axis over N devices")
    p.add_argument("--smoke", action="store_true",
                   help="shrunken model + 64-frame sequences (CI-sized)")
    p.add_argument("--out", help="also write the report JSON here")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    device = resolve_device(args.device)
    if device.type == "cuda" and args.seed_parallel:
        mesh_mod.check_card_count(args.seed_parallel)
    tag = "bin" if args.binaural else "mon"
    preset = args.preset or ("sednet-dcase-binaural" if args.binaural else "sednet-dcase")
    cache = args.cache_dir or os.path.join(args.dcase_root, "sedtpu_cache")
    launched = mesh_mod.launched()
    rank0 = not launched or int(os.environ.get("RANK", 0)) == 0
    plots = importlib.util.find_spec("matplotlib") is not None
    if not plots and rank0:
        print("reproduce_dcase: matplotlib is not installed; training without the per-epoch "
              "plots", file=sys.stderr)

    # -- stage 1: features (per-file cache makes reruns cheap); under the
    # launcher rank 0 extracts before it joins the group, whose rendezvous
    # holds the other ranks until then
    if rank0:
        feat_args = ["--dcase-root", args.dcase_root, "--cache-dir", cache,
                     "--scene", args.scene, "--folds", *map(str, args.folds),
                     "--device", args.device]
        if args.binaural:
            feat_args.append("--binaural")
        feature_app.main(feat_args)

    # -- stage 2: the folds x N-seed protocol
    cfg = get_preset(preset)
    if args.smoke:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, conv_channels=(8, 8, 8), gru_hidden=(4, 4), seq_len_in=64))
    train = {"max_epochs": args.max_epochs}
    if not plots:
        train["plot_every"] = 0
    if args.batch_size:
        train["batch_size"] = args.batch_size
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train))
    if rank0:
        os.makedirs(args.art_dir, exist_ok=True)
    n_ranks = args.seed_parallel if args.runs > 1 else 0
    stage2 = (cfg, cache, args.folds, tag, args.art_dir, args.runs, n_ranks, args.device)
    if n_ranks > 1 and not launched:
        er, f1, std_er, std_f1 = mesh_mod.spawn_ranks(_protocol, n_ranks, stage2,
                                                      device=args.device)[0]
    else:
        er, f1, std_er, std_f1 = _protocol(*stage2)

    # -- stage 3: the comparison
    base = BASELINES[tag]
    report = {
        "protocol": f"{len(args.folds)}-fold x {args.runs}-seed, {preset}",
        "channel": "binaural" if args.binaural else "single",
        "er_1s": round(er, 4),
        "f1_1s": round(f1, 4),
        "std_er": round(std_er, 4),
        "std_f1": round(std_f1, 4),
        "baseline_er": base["er"],
        "baseline_f1": base["f1"],
        "delta_er": round(er - base["er"], 4),
        "delta_f1": round(f1 - base["f1"], 4),
        "smoke": bool(args.smoke),
    }
    if not rank0:
        return report
    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if not args.smoke:
        verdict = "MATCHES/BEATS" if (
            er <= base["er"] + 0.02 and f1 >= base["f1"] - 0.02
        ) else "BEHIND"
        print(f"vs published baseline: {verdict} "
              f"(ER {er:.3f} vs {base['er']}, F1 {f1:.3f} vs {base['f1']})")
    return report


if __name__ == "__main__":
    main()
