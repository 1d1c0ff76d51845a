"""Dataset catalogs: the Decorte-style hit metadata loader and the
DCASE-2017-Task-3 folder layout, with deterministic fold assignment.

A copy of the JAX package's `data/catalog.py`: CSV (or XLSX) metadata
tables, per-video monotonicity checks of event intervals (raising on
out-of-order rows), media probing through ffprobe, round-robin fold
assignment over sorted video names, and the summary printout. Pure Python
csv parsing."""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

from sed_crnn_torch.data.wavio import probe_media_meta

MEDIA_EXTENSIONS = (".mp4", ".MP4", ".avi", ".mkv", ".wav", ".WAV", ".flac")


@dataclasses.dataclass
class VideoEntry:
    name: str                       # filename with extension
    path: str
    events: List[Tuple[float, float]]       # (start_s, end_s) hit intervals
    assignments: List[Dict[str, str]]        # auxiliary per-hit rows
    fold_id: int = -1
    duration_s: Optional[float] = None
    # video-stream metadata the reference's OpenCV probe collected
    # (`decorte_data_loader.py:86-99`); None for audio-only media
    fps: Optional[float] = None
    n_frames: Optional[int] = None
    width: Optional[int] = None
    height: Optional[int] = None


class CatalogError(ValueError):
    pass


def _read_csv(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def validate_monotone(values: Sequence[float], label: str) -> None:
    """Raise if a per-video column is not non-decreasing (the reference
    aborts the whole load on ordering errors, `decorte_data_loader.py:31-48`)."""
    bad = [
        (i, values[i], values[i + 1])
        for i in range(len(values) - 1)
        if values[i + 1] < values[i]
    ]
    if bad:
        detail = "; ".join(f"row {i}: {a:.2f} > next {b:.2f}" for i, a, b in bad[:5])
        raise CatalogError(f"monotonicity violated in {label}: {detail}")


def load_event_catalog(
    media_dir: str,
    hits_csv: str,
    assignments_csv: Optional[str] = None,
    k_folds: int = 4,
    probe_media: bool = False,
    verbose: bool = True,
) -> Dict[str, VideoEntry]:
    """Decorte-style catalog: media files + hits table (columns ``filename``,
    ``start``, ``end``) + optional assignments table (``video``,
    ``timestamp``). Folds assigned round-robin over sorted names."""
    if not os.path.exists(hits_csv):
        raise FileNotFoundError(hits_csv)
    hit_rows = _read_csv(hits_csv)
    hit_rows.sort(key=lambda r: (r["filename"], float(r["start"])))

    hits_by_video: Dict[str, List[Tuple[float, float]]] = {}
    for row in hit_rows:
        hits_by_video.setdefault(row["filename"], []).append(
            (float(row["start"]), float(row["end"]))
        )
    for vid, events in hits_by_video.items():
        validate_monotone([s for s, _ in events], f"HIT:{vid} start")
        validate_monotone([e for _, e in events], f"HIT:{vid} end")

    assigns_by_video: Dict[str, List[Dict[str, str]]] = {}
    if assignments_csv and os.path.exists(assignments_csv):
        if assignments_csv.lower().endswith((".xlsx", ".xlsm")):
            from sed_crnn_torch.data.xlsx import read_xlsx_rows

            rows = read_xlsx_rows(assignments_csv)
        else:
            rows = _read_csv(assignments_csv)
        rows.sort(key=lambda r: (r["video"], float(r["timestamp"])))
        for row in rows:
            assigns_by_video.setdefault(row["video"], []).append(row)
        for vid, rows in assigns_by_video.items():
            validate_monotone(
                [float(r["timestamp"]) for r in rows], f"ASSIGN:{vid} timestamp"
            )

    catalog: Dict[str, VideoEntry] = {}
    for fname in sorted(os.listdir(media_dir)):
        if not fname.endswith(MEDIA_EXTENSIONS):
            continue
        stem = os.path.splitext(fname)[0]
        path = os.path.join(media_dir, fname)
        meta = probe_media_meta(path) if probe_media else {}
        catalog[fname] = VideoEntry(
            name=fname,
            path=path,
            events=hits_by_video.get(fname, []),
            assignments=assigns_by_video.get(stem, []),
            duration_s=meta.get("duration_s"),
            fps=meta.get("fps"),
            n_frames=meta.get("n_frames"),
            width=meta.get("width"),
            height=meta.get("height"),
        )

    missing = [v for v, e in catalog.items() if not e.events]
    if missing and verbose:
        print(f"[catalog] {len(missing)} media files lack event rows")

    for idx, name in enumerate(sorted(catalog)):
        catalog[name].fold_id = idx % k_folds

    if verbose:
        n_events = sum(len(e.events) for e in catalog.values())
        fold_sizes = [
            sum(1 for e in catalog.values() if e.fold_id == f) for f in range(k_folds)
        ]
        print(
            f"[catalog] media={len(catalog)} events={n_events} "
            f"fold distribution: {fold_sizes}"
        )
    return catalog


# ---------------------------------------------------------------------------
# DCASE 2017 Task 3 layout (the legacy pipeline's dataset,
# reference README.md:47-58): audio/street/*.wav + evaluation_setup/
# street_fold{k}_{train,evaluate}.txt with tab-separated
# (filename, scene, start, end, label) annotation rows.
# ---------------------------------------------------------------------------

DCASE_CLASSES = ("brakes squeaking", "car", "children", "large vehicle",
                 "people speaking", "people walking")


def load_dcase_fold_list(
    setup_dir: str, fold: int, split: str, scene: str = "street"
) -> Dict[str, List[Tuple[float, float, int]]]:
    """Per-file event tuples (start, end, class_id) for one DCASE fold split
    (split in {'train', 'evaluate'})."""
    path = os.path.join(setup_dir, f"{scene}_fold{fold}_{split}.txt")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    out: Dict[str, List[Tuple[float, float, int]]] = {}
    class_index = {c: i for i, c in enumerate(DCASE_CLASSES)}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            fname = os.path.basename(parts[0])
            out.setdefault(fname, [])
            if len(parts) >= 5 and parts[2] and parts[3]:
                label = parts[4].strip()
                if label not in class_index:
                    raise CatalogError(f"{path}: unknown event label {label!r}")
                out[fname].append(
                    (float(parts[2]), float(parts[3]), class_index[label])
                )
    return out
