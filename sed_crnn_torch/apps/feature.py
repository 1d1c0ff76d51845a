"""Feature-extraction CLI: media -> log-mel features on the card -> per-file
caches and per-fold packs, in the JAX package's cache layout.

Decodes each file (native WAV reader, polyphase resampling of other rates,
ffmpeg for other containers), runs the log-mel frontend on the device,
rasterizes event intervals to frame labels (floor/ceil), caches one npz per
file, logs timing to ``feature_log.jsonl``, and packs per-fold train/test
npz with train-only standardization: the files `apps/train.py --cache-dir`
reads, and the JAX package's too.

  python -m sed_crnn_torch.apps.feature --media-dir DIR --hits-csv F --cache-dir OUT
  python -m sed_crnn_torch.apps.feature --dcase-root DIR --cache-dir OUT [--binaural | --binmul | --multires N_FFT ...]

Runs on ``--device cuda`` by default and raises without a GPU; ``--device
cpu`` runs the plain versions. ``--backend`` names the frontend: ``fft``
(default, as in the JAX package), ``matmul`` or ``kernel`` (the fused
log-mel kernel; the JAX ``pallas``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import time
from typing import Dict, Tuple

import numpy as np
import torch

from sed_crnn_torch.core.config import FRONTEND_BACKENDS, FrontendConfig
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.data import catalog as catalog_mod
from sed_crnn_torch.data import store
from sed_crnn_torch.data.rasterize import rasterize_events
from sed_crnn_torch.data.resample import resample
from sed_crnn_torch.data.wavio import decode_audio, read_wav_multichannel
from sed_crnn_torch.ops import frontend
from sed_crnn_torch.train.artifacts import append_jsonl

# bin-mul-mbe resolutions: six stacked 40-band maps per frame, 2 binaural
# channels x 3 STFT resolutions (the sednet-dcase-binmul preset's input,
# in_channels 6). The hop stays fixed, so every resolution lands on the same
# frame grid (center=True: n_frames = 1 + len // hop whatever n_fft is).
BINMUL_N_FFTS = (1024, 2048, 4096)


def _log(log_path: str, name: str, n_frames: int, dt: float, saved: str) -> None:
    print(f"[audio] {name} -> {n_frames} frames in {dt:.2f}s")
    append_jsonl(log_path, {"video": name, "frames": int(n_frames),
                            "duration_sec": round(dt, 2), "saved": saved})


def extract_decorte(
    media_dir: str,
    hits_csv: str,
    cache_dir: str,
    assignments_csv: str = None,
    k_folds: int = 4,
    fcfg: FrontendConfig = FrontendConfig(),
    device=None,
) -> Dict[int, str]:
    """Per-video features, labels and fold packs for an event catalog. A
    file that cannot be decoded is reported and skipped, as the reference
    does; a failure of the frontend raises."""
    dev = resolve_device(device)
    os.makedirs(cache_dir, exist_ok=True)
    log_path = os.path.join(cache_dir, "feature_log.jsonl")
    cat = catalog_mod.load_event_catalog(media_dir, hits_csv, assignments_csv, k_folds=k_folds)

    per_video: Dict[str, Tuple[np.ndarray, np.ndarray, int]] = {}
    for name, entry in cat.items():
        out_npz = store.video_feature_path(cache_dir, name)
        if os.path.exists(out_npz):
            mbe, lbl = store.load_video_features(out_npz)
            print(f"[cached] {name} -> {mbe.shape[0]} frames")
        else:
            t0 = time.time()
            try:
                pcm = decode_audio(entry.path, sr=fcfg.sample_rate, mono=True)
            except (OSError, ValueError, RuntimeError, subprocess.CalledProcessError) as e:
                print(f"[error] {name}: {e}")
                continue
            mbe = frontend.extract(pcm, fcfg, device=dev).cpu().numpy()
            lbl = rasterize_events(entry.events, mbe.shape[0], fcfg.sample_rate,
                                   fcfg.hop_length)
            store.save_video_features(out_npz, mbe, lbl)
            _log(log_path, name, mbe.shape[0], time.time() - t0, out_npz)
        per_video[name] = (mbe, lbl, entry.fold_id)

    paths = store.pack_folds(per_video, cache_dir, device=dev)
    for k, p in sorted(paths.items()):
        print(f"[fold {k}] saved {p}")
    return paths


def _binaural_features(pcm: np.ndarray, fcfg: FrontendConfig, n_ffts, dev) -> np.ndarray:
    """Each channel at each resolution, stacked along the feature axis
    channel-major (ch0@r0, ch0@r1, ..., ch1@r0, ...), cut to the shortest."""
    chans = [
        frontend.extract(np.ascontiguousarray(pcm[:, c]),
                         fcfg if nf == fcfg.n_fft else dataclasses.replace(fcfg, n_fft=nf),
                         device=dev)
        for c in range(pcm.shape[1])
        for nf in n_ffts
    ]
    n_frames = min(ch.shape[0] for ch in chans)
    return torch.cat([ch[:n_frames] for ch in chans], dim=1).cpu().numpy()


def extract_dcase(
    dcase_root: str,
    cache_dir: str,
    scene: str = "street",
    folds=(1, 2, 3, 4),
    binaural: bool = False,
    fcfg: FrontendConfig = FrontendConfig(),
    multires=None,
    device=None,
) -> None:
    """DCASE 2017 Task 3 layout: per-fold train/evaluate file lists; features
    per wav (the channel mean, or each channel stacked along the feature axis
    for ``binaural``), multi-class frame labels; per-fold packs
    ``mbe_{mon|bin|binmul}_fold{k}.npz`` with train-only standardization.

    ``multires`` (with ``binaural=True``): n_fft values; each channel is
    featurized at every resolution (the bin-mul-mbe input of
    ``sednet-dcase-binmul``, in_channels = channels x resolutions). A wav at
    another sample rate is resampled on the host. A file's features are
    cached and logged once; a rerun reads them back and computes nothing."""
    dev = resolve_device(device)
    audio_dir = os.path.join(dcase_root, "audio", scene)
    setup_dir = os.path.join(dcase_root, "evaluation_setup")
    os.makedirs(cache_dir, exist_ok=True)
    if multires is not None and not binaural:
        raise ValueError("multires stacking requires binaural=True "
                         "(bin-mul-mbe is a multichannel contract)")
    n_ffts = tuple(int(n) for n in multires) if multires else (fcfg.n_fft,)
    tag = ("binmul" if multires else "bin") if binaural else "mon"
    n_classes = len(catalog_mod.DCASE_CLASSES)
    log_path = os.path.join(cache_dir, "feature_log.jsonl")
    feat_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def featurize(fname, events):
        if fname in feat_cache:
            return feat_cache[fname]
        out_npz = store.video_feature_path(cache_dir, fname, tag)
        if os.path.exists(out_npz):
            feat_cache[fname] = store.load_video_features(out_npz)
            print(f"[cached] {fname} -> {feat_cache[fname][0].shape[0]} frames")
            return feat_cache[fname]
        t0 = time.time()
        path = os.path.join(audio_dir, fname)
        if binaural:
            pcm, sr = read_wav_multichannel(path)
            if sr != fcfg.sample_rate:
                pcm = resample(pcm, sr, fcfg.sample_rate)
            mbe = _binaural_features(pcm, fcfg, n_ffts, dev)
        else:
            pcm = decode_audio(path, sr=fcfg.sample_rate, mono=True)
            mbe = frontend.extract(pcm, fcfg, device=dev).cpu().numpy()
        lbl = rasterize_events([(s, e) for s, e, _ in events], mbe.shape[0],
                               fcfg.sample_rate, fcfg.hop_length, n_classes=n_classes,
                               class_ids=[c for _, _, c in events])
        store.save_video_features(out_npz, mbe, lbl)
        _log(log_path, fname, mbe.shape[0], time.time() - t0, out_npz)
        feat_cache[fname] = (mbe, lbl)
        return mbe, lbl

    for fold in folds:
        X, Y = {}, {}
        for split, key in (("train", "train"), ("evaluate", "test")):
            file_events = catalog_mod.load_dcase_fold_list(setup_dir, fold, split, scene)
            pairs = [featurize(f, ev) for f, ev in sorted(file_events.items())]
            X[key] = np.concatenate([x for x, _ in pairs], axis=0)
            Y[key] = np.concatenate([y for _, y in pairs], axis=0)
        # The recorded statistics (arr_4/arr_5) are the ones to serve with:
        # DCASE folds follow the evaluation_setup lists, so a later refit
        # from the per-file caches by the round-robin rule would be wrong.
        x_train, x_test, mean, scale = store.standardize(X["train"], X["test"], dev)
        out = store.fold_path(cache_dir, fold, tag)
        store.save_fold(out, x_train, Y["train"], x_test, Y["test"], mean, scale)
        print(f"[fold {fold}] saved {out} | train={len(x_train)} test={len(x_test)}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--media-dir", help="directory of media files (Decorte-style)")
    p.add_argument("--hits-csv", help="hits table: filename,start,end")
    p.add_argument("--assignments-csv", default=None)
    p.add_argument("--dcase-root", help="DCASE 2017 Task 3 dataset root")
    p.add_argument("--scene", default="street")
    p.add_argument("--binaural", action="store_true")
    p.add_argument("--binmul", action="store_true",
                   help="bin-mul-mbe packs: each binaural channel featurized "
                        f"at n_fft {BINMUL_N_FFTS} and stacked to 6 feature "
                        "maps per frame (the sednet-dcase-binmul preset's "
                        "input); implies --binaural")
    p.add_argument("--multires", type=int, nargs="+", metavar="N_FFT",
                   help="override the --binmul resolution set; implies --binaural")
    p.add_argument("--cache-dir", required=True)
    p.add_argument("--k-folds", type=int, default=4)
    p.add_argument("--folds", type=int, nargs="+", default=[1, 2, 3, 4],
                   help="DCASE fold ids to pack")
    p.add_argument("--backend", default="fft", choices=FRONTEND_BACKENDS)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    fcfg = FrontendConfig(backend=args.backend)
    multires = None
    if args.binmul or args.multires:
        multires = tuple(args.multires) if args.multires else BINMUL_N_FFTS
    if args.dcase_root:
        extract_dcase(args.dcase_root, args.cache_dir, args.scene, folds=tuple(args.folds),
                      binaural=args.binaural or bool(multires), fcfg=fcfg,
                      multires=multires, device=device)
    elif args.media_dir and args.hits_csv:
        extract_decorte(args.media_dir, args.hits_csv, args.cache_dir,
                        args.assignments_csv, args.k_folds, fcfg, device=device)
    else:
        p.error("provide either --dcase-root or --media-dir + --hits-csv")


if __name__ == "__main__":
    main()
