"""Streaming inference CLI: a long recording -> frame probabilities -> event
intervals, chunk by chunk with carried GRU state.

  python -m sed_crnn_torch.apps.infer --checkpoint best_fold1.npz \\
      --preset sednet-dcase --wav recording.wav --stats-from fold1-cache-dir

  python -m sed_crnn_torch.apps.infer --artifact model.sedart --wav recording.wav

Checkpoints are the JAX package's npz files; `models/convert.py` carries
their weights into the port's model. A serving artifact
(`apps/export.py`) replaces the checkpoint, the preset and the statistics.
Runs on ``--device cuda`` by default.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

import numpy as np
import torch

from sed_crnn_torch.core import checkpoint as ckpt_io
from sed_crnn_torch.core.config import FrontendConfig, get_preset
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.data import store
from sed_crnn_torch.data.eventio import default_class_names, format_event_list
from sed_crnn_torch.data.rasterize import events_from_labels
from sed_crnn_torch.data.wavio import decode_audio
from sed_crnn_torch.models.convert import load_model
from sed_crnn_torch.models.export import ServingArtifact
from sed_crnn_torch.models.streaming import stream_probabilities
from sed_crnn_torch.ops import frontend
from sed_crnn_torch.ops.postprocess import median_smooth


def _threshold_arg(threshold, n_classes: int):
    """One global float, or exactly one threshold per class."""
    if np.ndim(threshold) == 0:
        return float(threshold)
    arr = np.asarray(threshold, np.float32)
    if arr.shape != (n_classes,):
        raise ValueError(
            f"{arr.size} thresholds for {n_classes} classes — pass one "
            f"global threshold or exactly one per class"
        )
    return arr


def infer_file(
    wav_path: str,
    checkpoint,
    preset: str = "timepooled-v2",
    norm_stats=None,
    threshold=0.5,
    carry_backward: bool = False,
    lookahead: bool = False,
    log_floor: float = 1e-10,
    median: int = 0,
    device=None,
):
    """-> ``(probs (frames_out, n_classes) numpy, events, meta)``.

    ``log_floor`` clamps mel energies before the log, so that exact digital
    silence does not turn into -inf features; 0/None keeps the reference's
    strict no-epsilon log. ``checkpoint``: one path, or several, which
    stream as a probability ensemble (each member with its own carried
    state, probabilities averaged). ``device``: ``None`` means ``cuda``.
    """
    dev = resolve_device(device)
    cfg = get_preset(preset)
    if log_floor:
        cfg = cfg.replace(
            frontend=dataclasses.replace(cfg.frontend, log_floor=float(log_floor))
        )
    threshold = _threshold_arg(threshold, cfg.model.n_classes)
    paths = [checkpoint] if isinstance(checkpoint, str) else list(checkpoint)
    loaded = [ckpt_io.load_checkpoint(c) for c in paths]
    meta = loaded[0][1] if len(loaded) == 1 else {"members": [m for _, m in loaded]}

    pcm = decode_audio(wav_path, sr=cfg.frontend.sample_rate, mono=True)
    mel = frontend.extract(pcm, cfg.frontend, device=dev)
    if norm_stats is not None:
        mel = frontend.normalize(mel, norm_stats)

    probs = np.mean(
        [
            stream_probabilities(load_model(tree, cfg.model, dev), mel, carry_backward,
                                 lookahead=lookahead)
            for tree, _ in loaded
        ],
        axis=0,
    )
    if median > 1:
        probs = median_smooth(probs, median)
    pool = cfg.model.seq_len_in // cfg.model.seq_len_out
    out_hop = cfg.frontend.hop_length * pool  # samples per output frame
    events = events_from_labels(probs, cfg.frontend.sample_rate, out_hop, threshold)
    return probs, events, meta


def stats_from_fold(cache_dir: str, fold_id: int, channel_tag: str = "mon",
                    k_folds: int = 4, device=None):
    """The fold's train-split normalization statistics, for serving.

    First choice: the fold pack's recorded ``arr_4``/``arr_5``, the exact
    statistics training normalized with, valid for every pipeline.

    Packs written by the reference record none; then the statistics are
    refit (on ``device``, None means ``cuda``) from the per-video features
    under the Decorte fold rule: sorted names, round-robin, fold ``k``'s
    test videos at sorted index ``i`` with ``i % k_folds == k - 1``. That
    rule is wrong for DCASE caches (their folds follow the
    ``evaluation_setup`` lists), so multi-class per-file caches are refused.
    Returns (mean, scale), or None when the cache holds neither a pack with
    statistics nor per-video files."""
    recorded = store.load_fold_stats(cache_dir, fold_id, channel_tag)
    if recorded is not None:
        return recorded
    files = sorted(glob.glob(os.path.join(cache_dir, f"*_{channel_tag}.npz")))
    if not files:
        return None
    # DCASE caches share the per-file pattern but assign folds through the
    # evaluation_setup lists; their multi-class labels give them away.
    first_lbl = store.load_video_features(files[0])[1]
    if first_lbl.ndim == 2 and first_lbl.shape[1] > 1:
        fold_pack = os.path.basename(store.fold_path(cache_dir, fold_id, channel_tag))
        raise ValueError(
            f"{cache_dir} holds multi-class per-file caches (DCASE-style), whose fold "
            f"membership follows the evaluation_setup lists; the Decorte round-robin "
            f"refit would compute wrong statistics. Re-pack the folds with the feature "
            f"app (the pack {fold_pack} then records the exact train stats as arr_4/arr_5)."
        )
    train = [f for i, f in enumerate(files) if i % k_folds != (fold_id - 1) % k_folds]
    x = np.concatenate([store.load_video_features(f)[0] for f in train], axis=0)
    stats = frontend.fit_norm_stats(torch.from_numpy(x).to(resolve_device(device)))
    return stats.mean.cpu().numpy(), stats.scale.cpu().numpy()


def infer_file_artifact(
    wav_path: str,
    artifact_path: str,
    threshold=None,
    log_floor: float = 1e-10,
    lookahead: bool = False,
    median: int = 0,
    device=None,
):
    """Serve from a serving artifact (`apps/export.py`): its metadata carries
    the frontend parameters, its weights the model and, when exported with
    ``--stats-from``, the fold's normalization; the wav file and the
    artifact are the only inputs. ``threshold=None`` uses the artifact's
    ``default_threshold``, else 0.5. ``device``: None means ``cuda`` (the
    frontend and the artifact's programs both run there).
    -> ``(probs (frames_out, n_classes) numpy, events, meta)``."""
    art = ServingArtifact.load(artifact_path, device)
    if threshold is None:
        threshold = art.meta.get("default_threshold")
        if threshold is None:
            threshold = 0.5
    threshold = _threshold_arg(threshold, int(art.meta["n_classes"]))
    fcfg = FrontendConfig(**art.meta["frontend"])
    if log_floor:
        fcfg = dataclasses.replace(fcfg, log_floor=float(log_floor))

    pcm = decode_audio(wav_path, sr=fcfg.sample_rate, mono=True)
    probs = art.stream(frontend.extract(pcm, fcfg, device=art.device), lookahead=lookahead)
    if median > 1:
        probs = median_smooth(probs, median)
    pool = int(art.meta["seq_len_in"]) // int(art.meta["seq_len_out"])
    events = events_from_labels(probs, fcfg.sample_rate, fcfg.hop_length * pool, threshold)
    return probs, events, art.meta


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav", required=True)
    p.add_argument("--checkpoint", nargs="+",
                   help="npz checkpoint (with --preset); several paths "
                        "stream as a probability ensemble")
    p.add_argument("--artifact",
                   help="serving artifact from sed_crnn_torch.apps.export; replaces "
                        "--checkpoint/--preset/--stats-from")
    p.add_argument("--preset", default="timepooled-v2")
    p.add_argument("--threshold", type=float, nargs="+", default=None,
                   help="binarization threshold: one global value, or one per class "
                        "(default: the artifact's default_threshold with --artifact, "
                        "else 0.5)")
    p.add_argument("--median", type=int, default=0,
                   help="odd width > 1 median-smooths the probability tracks "
                        "before event decoding (0 = off)")
    p.add_argument("--stats-from", help="cache dir whose fold pack holds the norm stats")
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--carry-backward", action="store_true")
    p.add_argument("--lookahead", action="store_true",
                   help="emit each chunk one chunk late with bounded "
                        "bidirectional right context")
    p.add_argument("--log-floor", type=float, default=1e-10,
                   help="mel-energy floor before the log (0 = strict no-epsilon log)")
    p.add_argument("--format", choices=("json", "dcase"), default="json",
                   help="'dcase' writes onset<TAB>offset<TAB>label rows")
    p.add_argument("--class-names", help="comma-separated event labels for --format dcase")
    p.add_argument("--out", help="write events here (default stdout)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    if bool(args.checkpoint) == bool(args.artifact):
        p.error("pass exactly one of --checkpoint or --artifact")
    threshold = None
    if args.threshold is not None:
        threshold = (args.threshold[0] if len(args.threshold) == 1
                     else np.asarray(args.threshold, np.float32))
    if args.artifact:
        probs, events, meta = infer_file_artifact(
            args.wav, args.artifact, threshold, args.log_floor, args.lookahead,
            args.median, device=args.device,
        )
    else:
        stats = (stats_from_fold(args.stats_from, args.fold, device=args.device)
                 if args.stats_from else None)
        probs, events, meta = infer_file(
            args.wav, args.checkpoint, args.preset, stats,
            0.5 if threshold is None else threshold,
            args.carry_backward, args.lookahead, args.log_floor, args.median,
            device=args.device,
        )
    if args.format == "dcase":
        n_classes = int(probs.shape[1])
        names = (tuple(args.class_names.split(",")) if args.class_names
                 else default_class_names(n_classes))
        if len(names) != n_classes:
            p.error(f"{len(names)} class names for {n_classes} classes")
        text = format_event_list(events, names)
    else:
        text = json.dumps({
            "wav": args.wav,
            "checkpoint_epoch": meta.get("epoch"),
            "ensemble_members": len(meta["members"]) if "members" in meta else (
                meta.get("ensemble_members") or None),
            "n_output_frames": int(probs.shape[0]),
            "events": [
                {"start_s": round(s, 3), "end_s": round(e, 3), "class": c}
                for s, e, c in events
            ],
        }, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out} ({len(events)} events)")
    else:
        print(text)


if __name__ == "__main__":
    main()
