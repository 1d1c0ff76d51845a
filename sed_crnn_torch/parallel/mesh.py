"""Process groups for data- and seed-parallel training, one process per card.

Counterpart of the JAX package's `parallel/mesh.py`. The JAX package runs one
process over N devices and reduces with `psum` / `pmean` over a named mesh
axis; the PyTorch idiom is one process per card in a `torch.distributed`
process group. A `Mesh` here is the small value that a rank needs: the
group, the axis name (``"data"`` or ``"seed"``), its size, this process's
rank and this rank's device. The backend is NCCL for CUDA devices and gloo
for the CPU (gloo also takes CUDA tensors, which lets two ranks share one
card: NCCL refuses two ranks on one GPU).

A run gets its ranks in one of two ways: under torch's launcher
(``python -m torch.distributed.run --nproc-per-node N ...``, which sets
``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``), each process
joins that group; otherwise `spawn_ranks` starts N local processes with the
``spawn`` start method and a free localhost port, rank r on ``cuda:r`` (or
on the CPU). A one-device mesh needs no second process: `make_mesh(1)`
initializes a world-size-1 group in this process.

Every group is initialized with a timeout (`GROUP_TIMEOUT`), so a
collective that one rank never joins fails the run instead of hanging it.

Collectives go through this module and are counted in ``counts``
(collective calls, and the bytes of each reduced or gathered result). gloo
takes CUDA tensors for both kinds, all_reduce and the flat all_gather.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import socket
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from sed_crnn_torch.core.device import resolve_device

DATA_AXIS = "data"
SEED_AXIS = "seed"
GROUP_TIMEOUT = datetime.timedelta(minutes=30)

# Collective calls, and bytes of their results, since the last `reset_counts`.
counts: Dict[str, int] = {"collectives": 0, "bytes": 0}


def reset_counts() -> None:
    counts.update(collectives=0, bytes=0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: ``size`` processes along
    ``axis_name``, this one ``rank`` on ``device``. ``owned``: the group was
    initialized by `make_mesh` itself (world size 1) and `close` ends it."""

    axis_name: str
    size: int
    rank: int
    device: torch.device
    group: Any
    owned: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis_name: size}``, as a JAX mesh's ``shape``."""
        return {self.axis_name: self.size}

    def close(self) -> None:
        """End the group if this mesh initialized it."""
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()

    def all_reduce_sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """`all_reduce_sum_grad` over this mesh: what cross-replica
        BatchNorm (`nn/layers.py`) calls on its ``sync_group``."""
        return all_reduce_sum_grad(t, self)


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def launched() -> bool:
    """True when this process is a rank of a group: initialized, or started
    by torch's launcher (or `spawn_ranks`) with ``WORLD_SIZE`` set."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def check_card_count(n_devices: int) -> None:
    have = torch.cuda.device_count()
    if n_devices > have:
        raise ValueError(f"requested {n_devices} devices, have {have}")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> None:
    """Join a group of ``num_processes`` ranks as ``process_id`` through the
    TCP rendezvous at ``coordinator_address`` (``host:port``). No-op when a
    group is already initialized, or when neither the arguments nor the
    launcher's variables (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``) name a group. ``backend``: None means NCCL when CUDA is
    available, else gloo; an NCCL rank first selects ``cuda:LOCAL_RANK``."""
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes is None:
        return
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=GROUP_TIMEOUT)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
              device=None) -> Mesh:
    """This rank's `Mesh` over the initialized group (joined first when the
    launcher's variables are set), or over a world-size-1 group initialized
    here when there is none and ``n_devices`` is None or 1. ``n_devices``,
    when given, must equal the group's size; on CUDA it may not exceed the
    visible cards. ``device``: None means ``cuda`` (raises without a GPU);
    ``cuda`` without an index means ``cuda:LOCAL_RANK``; an explicit index
    (two ranks on one card) is taken as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if n_devices is not None:
            check_card_count(n_devices)
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    owned = False
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            initialize_multihost(backend=backend_for(dev))
        elif n_devices in (None, 1):
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(backend_for(dev), store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=GROUP_TIMEOUT)
            owned = True
        else:
            raise ValueError(
                f"a {n_devices}-device mesh needs {n_devices} processes: start them with "
                f"spawn_ranks or python -m torch.distributed.run --nproc-per-node {n_devices}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices, the process group has {world}")
    return Mesh(axis_name, world, dist.get_rank(), dev, dist.group.WORLD, owned)


def local_batch_slice(global_batch: int, mesh: Mesh, axis_name: str = DATA_AXIS) -> int:
    n = mesh.shape[axis_name]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} devices")
    return global_batch // n


# ---- collectives ------------------------------------------------------------


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The SUM over ranks of ``t``, as a new tensor; invisible to autograd."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    counts["collectives"] += 1
    counts["bytes"] += out.numel() * out.element_size()
    return out


class _AllReduceSum(torch.autograd.Function):
    """SUM over ranks whose backward is the SUM over ranks of the
    cotangents: the transpose of `psum`, so that every rank's gradient
    carries the other ranks' terms through the reduced value."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_sum(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.mesh), None


def all_reduce_sum_grad(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`all_reduce_sum` that autograd differentiates (one collective
    forward, one backward)."""
    return _AllReduceSum.apply(t, mesh)


# the flat gather's newer name; older torch has only all_gather_into_tensor
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(size, *t.shape): every rank's ``t`` in rank order, on every rank."""
    flat = t.detach().reshape(-1).contiguous()
    out = flat.new_empty((mesh.size * flat.numel(),))
    _all_gather_flat(out, flat, group=mesh.group)
    counts["collectives"] += 1
    counts["bytes"] += out.numel() * out.element_size()
    return out.view(mesh.size, *t.shape)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (an all_reduce of one element)."""
    all_reduce_sum(torch.zeros(1, device=mesh.device), mesh)


def broadcast_object(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def gather_objects(obj: Any, mesh: Mesh) -> List[Any]:
    """Every rank's ``obj`` in rank order, on every rank."""
    out: List[Any] = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


# ---- local ranks ------------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, n: int, port: int, backend: str, fn, args, out_dir: str) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    initialize_multihost(f"127.0.0.1:{port}", n, rank, backend=backend)
    result = fn(*args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def spawn_ranks(fn: Callable, n: int, args: Sequence = (), device=None,
                backend: Optional[str] = None, timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``n`` new processes (``spawn`` start method),
    rank r joined to an ``n``-rank group on a free localhost port with
    ``LOCAL_RANK=r``, and return every rank's result in rank order. ``fn``
    and ``args`` must pickle; ``fn`` builds its mesh with `make_mesh`.
    ``device`` (None means ``cuda``) picks the default backend (NCCL for
    CUDA, gloo for the CPU) and, without an index, checks ``n`` against the
    visible cards. A rank that raises or dies fails the call (the others
    are stopped); ``timeout`` (seconds) bounds the whole run."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        check_card_count(n)
    backend = backend or backend_for(dev)
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _rank_entry, args=(n, free_port(), backend, fn, tuple(args), out_dir),
            nprocs=n, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(None if deadline is None else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{n} ranks did not finish within {timeout} s")
        results = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
