"""Tab-separated event lists, the DCASE / sed_eval interchange format
(``onset<TAB>offset<TAB>label``); the writer and label helpers serving
needs. Readers wait."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

# DCASE 2017 Task 3 street classes, in the JAX package's catalog order.
DCASE_CLASSES = ("brakes squeaking", "car", "children", "large vehicle",
                 "people speaking", "people walking")


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
