"""Data-parallel training over a 1-D mesh of processes, one per card.

Counterpart of the JAX package's `parallel/data_parallel.py`. Each rank
holds the whole fold on its device, draws its own ``local_batch`` windows
from its own generators (`train/loop.py::Rngs`, replica r), and computes the
local loss's gradients with `torch.autograd.grad`; those are flattened into
one buffer and joined by one SUM all_reduce per step, divided by the world
size: the JAX package's single gradient `psum`. Adam, with its clip norm,
then applies the same reduced gradient on every rank, so the parameters and
the optimizer state stay bitwise equal across ranks (every rank draws the
same initial parameters from the same CPU generator). BatchNorm normalizes
with the global batch's statistics (`nn/layers.py::BatchNorm2d.sync_group`,
a differentiable all_reduce), so the reduced gradient is the single-device
gradient of the same global batch; `DistributedDataParallel` is not used, as
its reducer hooks the ``.grad`` accumulators that `torch.autograd.grad`
never fills.

Scores come from every rank's losses, predictions and labels, gathered once
per epoch step-major (the JAX ``out_specs P(None, axis)``: step i holds
rank 0's windows, then rank 1's), so each rank scores the same tensors and
takes the same early-stop, plateau and checkpoint decisions. The sweep's
replica r takes windows ``i * batch + r * local_batch + arange(local_batch)``
of step i, and the gather puts them back in time order.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from sed_crnn_torch.core.config import TrainConfig
from sed_crnn_torch.data.sampler import find_clean_negative_starts
from sed_crnn_torch.models.crnn import CRNN
from sed_crnn_torch.nn.layers import BatchNorm2d
from sed_crnn_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_gather,
    all_reduce_sum,
    barrier,
    gather_objects,
    local_batch_slice,
)
from sed_crnn_torch.train.loop import Rngs, Trainer


class DataParallelTrainer(Trainer):
    """`Trainer` whose steps shard the global batch over ``mesh``; this
    process is replica ``mesh.rank`` and writes files only as rank 0."""

    def __init__(self, model: CRNN, tcfg: TrainConfig, train_sampler, val_sampler, mesh: Mesh,
                 axis_name: str = DATA_AXIS):
        super().__init__(model, tcfg, train_sampler, val_sampler)
        dev = train_sampler.data["mel"].device
        if dev != mesh.device:
            raise ValueError(f"the fold is on {dev}, the mesh's rank on {mesh.device}")
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_replicas = mesh.shape[axis_name]
        self.local_batch = local_batch_slice(tcfg.batch_size, mesh, axis_name)
        self.replica = mesh.rank
        self.is_writer = mesh.rank == 0

    @contextlib.contextmanager
    def _synced(self):
        bns = [m for m in self.model.modules() if isinstance(m, BatchNorm2d)]
        for m in bns:
            m.sync_group = self.mesh
        try:
            yield
        finally:
            for m in bns:
                m.sync_group = None

    def _reduce_grads(self, grads):
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), self.mesh)
        flat = flat / float(self.n_replicas)
        return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]

    def _collect(self, losses, preds, ys, extra=None):
        """One gather of every rank's per-step losses, predictions, labels
        and ``extra`` -> (the per-step mean loss over ranks, p and y as
        (steps, world x local_batch, T, C) step-major, ``extra`` summed)."""
        p, y = torch.stack(preds), torch.stack(ys)
        parts = [p.reshape(-1), y.reshape(-1)]
        if losses:
            parts.append(torch.stack(losses).float())
        if extra is not None:
            parts.append(extra.float())
        g = all_gather(torch.cat(parts), self.mesh)      # (world, n)
        w, n_p = self.n_replicas, p.numel()

        def interleave(flat):
            # (world, steps, local, ...) -> (steps, world * local, ...)
            t = flat.reshape(w, *p.shape).transpose(0, 1)
            return t.reshape(p.shape[0], w * p.shape[1], *p.shape[2:])

        gp, gy = interleave(g[:, :n_p]), interleave(g[:, n_p : 2 * n_p])
        i = 2 * n_p
        loss = None
        if losses:
            loss = g[:, i : i + len(losses)].sum(0) / float(w)
            i += len(losses)
        if extra is not None:
            extra = g[:, i:].sum(0)
        return loss, gp, gy, extra

    def rng_tree(self, rngs: Rngs) -> Dict:
        """Rank 0's states under ``torch_rng`` (what `run_fold` resumes on one
        device) and, past one replica, the others' under
        ``torch_rng_replicas``; every rank joins the gather."""
        tree = {"torch_rng": rngs.get_state()}
        if self.n_replicas > 1:
            states = gather_objects(rngs.get_state(), self.mesh)
            tree["torch_rng_replicas"] = states[1:]
        return tree

    def resume_rngs(self, rngs, tree, meta, device, fallback_seed):
        """Replica 0 resumes ``torch_rng``; replica r > 0 its entry of
        ``torch_rng_replicas`` when the checkpoint holds one per replica,
        else a reseed from ``key_seed``, child r."""
        if self.replica == 0:
            return super().resume_rngs(rngs, tree, meta, device, fallback_seed)
        others = tree.get("torch_rng_replicas")
        if others is not None and len(others) == self.n_replicas - 1:
            rngs.set_state(others[self.replica - 1])
            return rngs
        return self.replica_rngs(device, int(meta.get("key_seed", fallback_seed)))

    def barrier(self) -> None:
        barrier(self.mesh)


def shard_fold_data(
    fold_data: Dict[str, np.ndarray],
    mesh: Mesh,
    axis_name: str = DATA_AXIS,
    seq_len_in: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Per-process data sharding hook for multi-host data parallelism: each
    process keeps only its contiguous frame range of the train and val
    splits (its samplers then draw process-local windows). A world-size-1
    mesh returns the data unchanged.

    Contiguous slicing can starve a process when positives cluster in one
    region, so each shard is validated up front: any-class positive frames
    must remain, and with ``seq_len_in`` at least one clean-negative window
    start (`data/sampler.py::find_clean_negative_starts`), with the JAX
    package's errors, which name the host, the split and the counts."""
    n_proc = mesh.size
    if n_proc == 1:
        return fold_data
    pid = mesh.rank
    out = {}
    for split in ("train", "val"):
        x, y = fold_data[f"{split}_x"], fold_data[f"{split}_y"]
        chunk = x.shape[0] // n_proc
        sl = slice(pid * chunk, (pid + 1) * chunk)
        xs, ys = x[sl], y[sl]
        n_pos = int((np.asarray(ys).max(axis=1) > 0).sum())
        if n_pos == 0:
            raise ValueError(
                f"host {pid}/{n_proc}: contiguous {split} shard "
                f"(frames [{sl.start}, {sl.stop})) contains NO positive "
                f"frames — the balanced sampler cannot draw from it. "
                f"Interleave videos across hosts or rebalance the fold."
            )
        if seq_len_in is not None:
            n_neg = int(find_clean_negative_starts(ys, seq_len_in).size)
            if n_neg == 0:
                raise ValueError(
                    f"host {pid}/{n_proc}: contiguous {split} shard "
                    f"(frames [{sl.start}, {sl.stop}), {n_pos} positive "
                    f"frames) has no clean {seq_len_in}-frame negative "
                    f"window — the balanced sampler cannot draw negatives. "
                    f"Interleave videos across hosts or rebalance the fold."
                )
        out[f"{split}_x"], out[f"{split}_y"] = xs, ys
    return out
