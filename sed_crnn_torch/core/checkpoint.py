"""Single-file npz checkpoints in the JAX package's format, numpy only.

Arrays are stored under their flattened tree paths; each path component
carries its parent container's tag (``d:`` dict key, ``l:`` list index,
``t:`` tuple index) joined by ``/``, and a JSON metadata blob sits under
``__checkpoint_meta__`` as uint8 bytes. A checkpoint written by the JAX
training loop loads here unchanged, and one written here loads there.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

_META_KEY = "__checkpoint_meta__"
_SEP = "/"


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if _SEP in str(k):
                raise ValueError(f"dict key {k!r} may not contain {_SEP!r}")
            out.update(_flatten(v, f"{prefix}{_SEP}d:{k}" if prefix else f"d:{k}"))
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}{tag}:{i}" if prefix else f"{tag}:{i}"))
    elif tree is None:
        raise ValueError(f"None leaf at {prefix!r}: checkpoint trees may not hold None")
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    if set(flat) == {""}:
        return flat[""]
    root: Dict = {}
    kinds: Dict[int, str] = {}   # id(node) -> container tag

    for path, value in flat.items():
        node = root
        parts = path.split(_SEP)
        for i, part in enumerate(parts):
            kind, _, key = part.partition(":")
            if kinds.setdefault(id(node), kind) != kind:
                raise ValueError(f"inconsistent container kinds at {path!r}")
            k = key if kind == "d" else int(key)
            if i == len(parts) - 1:
                node[k] = value
            else:
                node = node.setdefault(k, {})

    def materialize(node):
        if not isinstance(node, dict):
            return node
        kind = kinds.get(id(node))   # None only for an empty tree -> ()
        items = {k: materialize(v) for k, v in node.items()}
        if kind == "d":
            return items
        seq = [items[i] for i in sorted(items)]
        return seq if kind == "l" else tuple(seq)

    return materialize(root)


def save_checkpoint(path: str, tree: Any, metadata: Optional[Dict] = None) -> str:
    """Atomic single-file save: write to a temp file, then rename."""
    flat = _flatten(tree)
    flat[_META_KEY] = np.frombuffer(
        json.dumps(metadata or {}).encode("utf-8"), dtype=np.uint8
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Tuple[Any, Dict]:
    meta: Dict = {}
    flat: Dict[str, np.ndarray] = {}
    with np.load(path) as data:
        for k in data.files:
            if k == _META_KEY:
                meta = json.loads(bytes(data[k]).decode("utf-8"))
            else:
                flat[k] = data[k]
    return _unflatten(flat), meta


def latest_checkpoint(directory: str, prefix: str = "") -> Optional[str]:
    """The most recently modified ``<prefix>*.npz`` in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    cands = [
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.startswith(prefix) and f.endswith(".npz")
    ]
    return max(cands, key=os.path.getmtime) if cands else None
