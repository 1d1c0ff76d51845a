"""Tab-separated event lists, the DCASE / sed_eval interchange format: one
event per row, ``onset<TAB>offset<TAB>event_label``, optionally prefixed
with the audio filename (and, in the TUT/DCASE meta files, a scene label
between filename and onset).

Counterpart of the JAX package's `data/eventio.py`. Readers take 2-5
columns, tab or whitespace delimited, with ``#`` comments; writers emit the
canonical 3- or 4-column tab form.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from sed_crnn_torch.data.catalog import DCASE_CLASSES

# (filename | None, onset_s, offset_s, label)
EventRow = Tuple[Optional[str], float, float, str]


def default_class_names(n_classes: int) -> Tuple[str, ...]:
    """Single-class models detect "hit"; 6 classes are the DCASE 2017 Task 3
    street set; anything else gets indices."""
    if n_classes == 1:
        return ("hit",)
    if n_classes == len(DCASE_CLASSES):
        return DCASE_CLASSES
    return tuple(str(i) for i in range(n_classes))


def _label_of(cls, class_names: Optional[Sequence[str]]) -> str:
    if isinstance(cls, str):
        return cls
    if class_names is not None:
        names = list(class_names)
        if not 0 <= int(cls) < len(names):
            raise ValueError(f"class index {cls} outside the {len(names)} provided names")
        return names[int(cls)]
    return str(int(cls))


def format_event_list(
    events: Sequence[Tuple],
    class_names: Optional[Sequence[str]] = None,
    filename: Optional[str] = None,
) -> str:
    """Event tuples ``(onset_s, offset_s, class)`` -> tab-separated text,
    sorted by onset, offset and label as written (1e-6 precision).
    ``filename`` prefixes every row (the 4-column cross-file form)."""
    rows = []
    for onset, offset, cls in sorted(
        events,
        key=lambda ev: (round(float(ev[0]), 6), round(float(ev[1]), 6), str(ev[2])),
    ):
        cells = [f"{float(onset):.6f}", f"{float(offset):.6f}", _label_of(cls, class_names)]
        if filename is not None:
            cells.insert(0, filename)
        rows.append("\t".join(cells))
    return "\n".join(rows) + ("\n" if rows else "")


def write_event_list(
    path: str,
    events: Sequence[Tuple],
    class_names: Optional[Sequence[str]] = None,
    filename: Optional[str] = None,
) -> str:
    with open(path, "w") as f:
        f.write(format_event_list(events, class_names, filename))
    return path


def _parse_row(cells: List[str], lineno: int, path: str) -> EventRow:
    """The column count decides the layout, so that numeric filenames or
    labels never shift the time columns:

    * 2 cells: ``onset offset``
    * 3 cells: ``onset offset label``
    * 4 cells: ``file onset offset label`` (``onset offset label extra``
      only when cells 1-2 are not a valid time pair)
    * 5+ cells: the TUT/DCASE meta form ``file [scene] onset offset label
      [...extras]``, the first valid time pair at index >= 1
    """
    def f(i):
        try:
            return float(cells[i])
        except (ValueError, IndexError):
            return None

    def is_pair(i):
        a, b = f(i), f(i + 1)
        return a is not None and b is not None and a <= b

    n = len(cells)
    if n in (2, 3):
        pair = 0 if is_pair(0) else None
    elif n == 4:
        pair = 1 if is_pair(1) else (0 if is_pair(0) else None)
    else:
        pair = next((i for i in range(1, n - 1) if is_pair(i)), None)
        if pair is None and is_pair(0):
            pair = 0
    if pair is None:
        raise ValueError(f"{path}:{lineno}: no onset/offset column pair in {cells!r}")
    onset, offset = float(cells[pair]), float(cells[pair + 1])
    label = cells[pair + 2] if pair + 2 < n else "0"
    fname = cells[0] if pair > 0 else None
    return fname, onset, offset, label


def read_event_list(path: str) -> List[EventRow]:
    """A delimited event-list file -> ``(filename | None, onset_s, offset_s,
    label)`` rows."""
    rows: List[EventRow] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cells = line.split("\t") if "\t" in line else line.split()
            rows.append(_parse_row([c.strip() for c in cells], lineno, path))
    return rows


def events_by_file(
    rows: Sequence[EventRow],
) -> Dict[Optional[str], List[Tuple[float, float, str]]]:
    """Group parsed rows by filename (files without events do not appear; a
    file-less list groups under ``None``)."""
    out: Dict[Optional[str], List[Tuple[float, float, str]]] = {}
    for fname, onset, offset, label in rows:
        out.setdefault(fname, []).append((onset, offset, label))
    return out


def map_labels(
    events: Sequence[Tuple[float, float, str]],
    class_names: Sequence[str],
) -> List[Tuple[float, float, int]]:
    """String labels -> class indices; an unknown label raises with the
    known vocabulary in the message."""
    index: Dict[str, int] = {n: i for i, n in enumerate(class_names)}
    out = []
    for onset, offset, label in events:
        if label not in index:
            raise ValueError(f"unknown event label {label!r}; known: {sorted(index)}")
        out.append((onset, offset, index[label]))
    return out
