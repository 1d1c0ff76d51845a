"""Host-to-device feeds for corpora too large to live on the card.

Counterpart of the JAX package's `data/pipeline.py`. The default training
path keeps the whole fold on the device and samples there
(`data/sampler.py`), so it needs no feed. These helpers cover the other
regime: `device_prefetch` keeps ``depth`` batches in flight, each copied
from pinned host memory with ``non_blocking`` copies on a side stream, so
host preparation of batch k + depth overlaps device work on batch k; and
`sharded_prefetch` feeds a data mesh (`parallel/mesh.py`), yielding this
rank's contiguous slice of each batch's leading axis on its device: the
process-per-card counterpart of a batch-sharded global array.

A batch is an array or tensor, or a dict, list or tuple of them.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.parallel.mesh import DATA_AXIS, Mesh, local_batch_slice


_END = object()


def _tree_map(fn: Callable, batch: Any) -> Any:
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return fn(batch)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def device_prefetch(batches: Iterable, depth: int = 2, device=None) -> Iterator:
    """Yield each batch of ``batches`` on ``device`` (None means ``cuda``,
    which raises without a GPU) while the next ``depth`` are copied. On the
    card the copies run from pinned memory on a side stream, and a yielded
    batch is ready on the current stream."""
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (_tree_map(lambda a: _as_tensor(a).to(dev), b) for b in batches)
    return _cuda_prefetch(iter(batches), depth, dev)


def _cuda_prefetch(it: Iterator, depth: int, dev: torch.device) -> Iterator:
    side = torch.cuda.Stream(dev)

    def put(batch):
        with torch.cuda.stream(side):
            out = _tree_map(lambda a: _as_tensor(a).pin_memory().to(dev, non_blocking=True),
                            batch)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    queue = collections.deque()
    for batch in it:
        queue.append(put(batch))
        if len(queue) == depth:
            break
    while queue:
        out, done = queue.popleft()
        nxt = next(it, _END)
        if nxt is not _END:
            queue.append(put(nxt))
        current = torch.cuda.current_stream(dev)
        current.wait_event(done)
        _tree_map(lambda t: t.record_stream(current), out)
        yield out


def sharded_prefetch(batches: Iterable, mesh: Mesh, axis_name: str = DATA_AXIS,
                     depth: int = 2) -> Iterator:
    """Like `device_prefetch` onto this rank's device, each batch cut to this
    rank's contiguous ``1 / world`` of its leading axis (which the world
    size must divide)."""

    def mine(a):
        local = local_batch_slice(len(a), mesh, axis_name)
        return a[mesh.rank * local : (mesh.rank + 1) * local]

    return device_prefetch((_tree_map(mine, b) for b in batches), depth, mesh.device)
