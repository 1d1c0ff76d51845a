"""Streaming inference CLI: a long recording -> frame probabilities -> event
intervals, chunk by chunk with carried GRU state.

  python -m sed_crnn_torch.apps.infer --checkpoint best_fold1.npz \\
      --preset sednet-dcase --wav recording.wav --stats-from fold1-cache-dir

Checkpoints are the JAX package's npz files; `models/convert.py` carries
their weights into the port's model. Runs on ``--device cuda`` by default.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

import numpy as np

from sed_crnn_torch.core import checkpoint as ckpt_io
from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.data import store
from sed_crnn_torch.data.eventio import default_class_names, format_event_list
from sed_crnn_torch.data.rasterize import events_from_labels
from sed_crnn_torch.data.wavio import decode_audio
from sed_crnn_torch.models import get_model
from sed_crnn_torch.models.convert import from_jax
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


def load_model(tree, model_cfg, device):
    """A `CRNN` on ``device`` holding the weights of a JAX checkpoint tree."""
    model = get_model(model_cfg)
    model.load_state_dict(from_jax(tree["params"], tree["model_state"], model_cfg))
    return model.to(device)


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


def stats_from_fold(cache_dir: str, fold_id: int, channel_tag: str = "mon"):
    """The fold's recorded train-split normalization statistics
    (``arr_4``/``arr_5`` of its pack), or None when the cache holds no pack
    and no per-video features. Refitting from per-video features (packs
    without recorded statistics) is not yet ported and raises."""
    recorded = store.load_fold_stats(cache_dir, fold_id, channel_tag)
    if recorded is not None:
        return recorded
    if glob.glob(os.path.join(cache_dir, f"*_{channel_tag}.npz")):
        raise NotImplementedError(
            f"{cache_dir}: the fold pack records no statistics; refitting them "
            "from per-video features is not yet ported"
        )
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav", required=True)
    p.add_argument("--checkpoint", nargs="+",
                   help="npz checkpoint (with --preset); several paths "
                        "stream as a probability ensemble")
    p.add_argument("--artifact", help="serving artifact (not yet ported)")
    p.add_argument("--preset", default="timepooled-v2")
    p.add_argument("--threshold", type=float, nargs="+", default=None,
                   help="binarization threshold: one global value, or one per class")
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

    if args.artifact:
        raise NotImplementedError("--artifact: serving artifacts are not yet ported")
    if not args.checkpoint:
        p.error("--checkpoint is required")
    threshold = 0.5
    if args.threshold is not None:
        threshold = (args.threshold[0] if len(args.threshold) == 1
                     else np.asarray(args.threshold, np.float32))
    stats = stats_from_fold(args.stats_from, args.fold) if args.stats_from else None
    probs, events, meta = infer_file(
        args.wav, args.checkpoint, args.preset, stats, threshold,
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
