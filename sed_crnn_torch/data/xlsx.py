"""Minimal XLSX reader: enough to load the reference's hit-assignments
workbook without pandas or openpyxl. A copy of the JAX package's
`data/xlsx.py`. XLSX is a zip of XML: parse sharedStrings and the selected
worksheet (by workbook sheet name, resolved through workbook.xml.rels) into
a list of row dicts keyed by the header row. Supports inline and shared
strings, numeric, boolean and formula-cached cells."""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
import zipfile
from typing import Dict, List, Optional

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}


def _column_index(cell_ref: str) -> int:
    """'B7' -> 1 (zero-based column)."""
    letters = re.match(r"[A-Z]+", cell_ref).group(0)
    idx = 0
    for ch in letters:
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def _sheet_target(zf: zipfile.ZipFile, sheet: Optional[str]) -> str:
    """Resolve a workbook sheet NAME (or None = first sheet in workbook
    order) to its worksheet part path via workbook.xml + its rels — the
    same resolution pandas/openpyxl perform. Falls back to numeric
    sheetN.xml ordering for minimal files with no workbook part."""
    rels_ns = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"
    if "xl/workbook.xml" in zf.namelist():
        wb = ET.fromstring(zf.read("xl/workbook.xml"))
        rel_map = {}
        if "xl/_rels/workbook.xml.rels" in zf.namelist():
            rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
            for rel in rels:
                tgt = rel.get("Target", "")
                rel_map[rel.get("Id")] = (
                    tgt if tgt.startswith("xl/") else "xl/" + tgt.lstrip("/")
                )
        entries = []
        for sh in wb.iter(f"{{{_NS['m']}}}sheet"):
            rid = sh.get(f"{{{rels_ns}}}id")
            entries.append((sh.get("name", ""), rel_map.get(rid)))
        if sheet is not None:
            for name, tgt in entries:
                if name == sheet and tgt:
                    return tgt
            raise ValueError(
                f"sheet {sheet!r} not found; workbook has "
                f"{[n for n, _ in entries]}"
            )
        if entries and entries[0][1]:
            return entries[0][1]
    # minimal files (no workbook part): numeric order, not lexicographic
    # (sheet10.xml must not sort before sheet2.xml)
    names = sorted(
        (n for n in zf.namelist()
         if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)),
        key=lambda n: int(re.search(r"(\d+)\.xml$", n).group(1)),
    )
    if not names:
        raise ValueError("no worksheets found")
    if sheet is not None:
        want = f"xl/worksheets/{sheet}.xml"
        if want in names:
            return want
        raise ValueError(f"sheet {sheet!r} not found among {names}")
    return names[0]


def read_xlsx_rows(path: str, sheet: Optional[str] = None) -> List[Dict[str, str]]:
    """Rows of the selected worksheet (by workbook sheet name; default the
    workbook's first sheet) as dicts keyed by the header row. Numbers come
    back as strings (callers convert, matching csv.DictReader); boolean
    cells as "TRUE"/"FALSE"."""
    with zipfile.ZipFile(path) as zf:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in zf.namelist():
            root = ET.fromstring(zf.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", _NS):
                shared.append("".join(t.text or "" for t in si.iter(f"{{{_NS['m']}}}t")))

        root = ET.fromstring(zf.read(_sheet_target(zf, sheet)))

    grid: List[List[str]] = []
    for row in root.iter(f"{{{_NS['m']}}}row"):
        cells: Dict[int, str] = {}
        for c in row.findall("m:c", _NS):
            ref = c.get("r", "")
            col = _column_index(ref) if ref else len(cells)
            ctype = c.get("t", "n")
            if ctype == "inlineStr":
                is_el = c.find("m:is", _NS)
                val = "".join(t.text or "" for t in is_el.iter(f"{{{_NS['m']}}}t")) if is_el is not None else ""
            else:
                v = c.find("m:v", _NS)
                raw = v.text if v is not None and v.text is not None else ""
                if ctype == "s" and raw:
                    val = shared[int(raw)]
                elif ctype == "b" and raw:
                    val = "TRUE" if raw.strip() == "1" else "FALSE"
                else:
                    val = raw
            cells[col] = val
        width = max(cells) + 1 if cells else 0
        grid.append([cells.get(i, "") for i in range(width)])

    grid = [r for r in grid if any(v != "" for v in r)]
    if not grid:
        return []
    header = [h or f"col{i}" for i, h in enumerate(grid[0])]
    out = []
    for r in grid[1:]:
        r = r + [""] * (len(header) - len(r))
        out.append(dict(zip(header, r)))
    return out
