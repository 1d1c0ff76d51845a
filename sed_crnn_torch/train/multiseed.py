"""Multi-seed training: the k-fold experiment repeated over N seeds and
reported as the mean and std over seeds of the cross-fold average ER/F1
(the reference README's "averaged over 4 cross-validation folds, mean of 5
runs").

Counterpart of the JAX package's `train/multiseed.py`, in its two modes:

* ``"sequential"``: each seed trains each fold through `run_fold(seed=s)`
  into ``<art_dir>/fold<k>/seed<s>/``;
* ``"stacked"``: `run_fold_multiseed` trains all seeds of a fold as one
  model (`models/stacked.py::StackedCRNN`), where the JAX package
  ``vmap``-s its epoch program. Every kernel launch, convolution and Adam
  pass then serves all seeds at once, which pays where a single seed's step
  leaves the card waiting on the host (small trunks).

Stacked seed s keeps `run_fold(seed=s)`'s semantics: its parameters drawn
from the generator ``s + fold_id``, its windows, SpecAugment masks, dropout
masks and random validation draws from its own `Rngs(s + fold_id)` in
`run_fold`'s order, its early stopping and plateau schedule tracked apart
(a stopped seed's history and checkpoints freeze while the others train
on), and its checkpoints and ``train_fold<k>.jsonl`` in `run_fold`'s layout
with its generator states, so `run_fold(resume_from=...)` continues it. The
numbers differ from `run_fold`'s by float32 rounding only (a grouped
convolution and batched products sum in other orders), which training
carries forward.

`choose_runs_mode` picks the mode from a rule measured on the card.

The seed axis is the cheapest multi-card axis: with a seed mesh
(`parallel/mesh.py::make_mesh(axis_name="seed")`, one process per card),
rank r trains its contiguous share of the seeds as one `StackedCRNN` and
writes those seeds' directories, exactly as a one-process
`run_fold_multiseed` of that share would. Training runs no collective; one
scalar all_reduce per epoch keeps the ranks in step until every rank's
seeds have stopped (a rank whose seeds all stopped trains nothing more),
and at the end every rank receives every seed's `FoldResult` in seed order.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from sed_crnn_torch.core import checkpoint as ckpt_io
from sed_crnn_torch.core.config import ExperimentConfig
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.data.sampler import sweep_batch_from
from sed_crnn_torch.models import get_model
from sed_crnn_torch.models.convert import opt_state_to_jax, to_jax
from sed_crnn_torch.models.stacked import StackedCRNN
from sed_crnn_torch.ops import metrics as metrics_ops
from sed_crnn_torch.parallel.mesh import Mesh, all_reduce_sum, gather_objects
from sed_crnn_torch.train import artifacts
from sed_crnn_torch.train.loop import (
    _TRACK_KEYS,
    FoldResult,
    Rngs,
    Trainer,
    TrainState,
    _use_full_sweep,
    make_samplers,
    run_fold,
)
from sed_crnn_torch.train.optim import PlateauState

# Spacing between generated run seeds. `run_fold` seeds each run from
# seed + fold_id, so consecutive run seeds would collide across (run, fold)
# pairs; a prime stride far above any fold count keeps them distinct.
SEED_STRIDE = 7919

# The stacked / sequential split, measured on one H100 80GB HBM3 at 700 W
# (chip_smoke.py [multiseed stacked], two runs, PERF.md §6): one train
# step at batch 128, stacked against the same seeds one after another, gave
# a stacked / sequential rate of 1.003 and 0.660 for timepooled-v1 x 2
# (effective batch 256), 1.187 and 0.846 for timepooled-v1 x 4 (512), and
# 0.609 and 0.625 for sednet-dcase x 2 (256); timepooled-v2 x 5 (conv 16)
# 4.41 and 3.33. A conv-128 trunk goes sequential once its stacked effective
# batch (batch_size x seeds) reaches this; smaller trunks always stack.
STACKED_SPLIT_BATCH = 256
_BIG_CONV_CHANNELS = 128  # the split was measured on conv-128 trunks


def run_seeds(base_seed: int, n_runs: int) -> List[int]:
    """The default seed list for an N-run experiment."""
    return [base_seed + r * SEED_STRIDE for r in range(n_runs)]


class MultiSeedTrainer(Trainer):
    """`Trainer` over a `StackedCRNN`: every step, score and loss carries a
    leading seed axis; ``rngs`` are the seeds' `Rngs`, and the state's
    ``lr_scale`` is a float32 (S,) tensor on the model's device."""

    def __init__(self, model: StackedCRNN, tcfg, train_sampler, val_sampler):
        super().__init__(model, tcfg, train_sampler, val_sampler)
        self.n_seeds = model.n_seeds

    def _losses(self, logits, y):
        """Each seed's mean loss, (S,)."""
        return self.loss_fn(logits, y, reduction="none").mean(dim=(1, 2, 3))

    def train_step(self, state: TrainState, x: torch.Tensor, y: torch.Tensor,
                   dropout_generators=None):
        """x (S, B, T, F), y (S, B, T_out, C) -> ``(state, losses (S,),
        probabilities)``; the parameters are updated in place."""
        self.model.train()
        params = self.params()
        logits = self.model(x, dropout_generators=dropout_generators)
        losses = self._losses(logits, y)
        grads = torch.autograd.grad(losses.sum(), list(params.values()))
        new_params, opt_state = self.adam.update_stacked(
            dict(zip(params, grads)), state.opt_state,
            {k: p.detach() for k, p in params.items()}, state.lr_scale)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        return state._replace(opt_state=opt_state), losses.detach(), torch.sigmoid(logits.detach())

    def _scores(self, losses, preds, ys, n_valid=None) -> Dict[str, torch.Tensor]:
        """Per seed `Trainer._scores` -> {name: (S,) tensor}."""
        p, y = torch.stack(preds, dim=1), torch.stack(ys, dim=1)   # (S, steps, B, T, C)
        c = p.shape[-1]
        n_valid = p[0, ..., 0].numel() if n_valid is None else n_valid
        per_seed = [metrics_ops.all_scores_masked(
            (p[s] > self.tcfg.threshold).reshape(-1, c), y[s].reshape(-1, c),
            self.tcfg.frames_in_1_sec, n_valid) for s in range(self.n_seeds)]
        scores = {k: torch.stack([sc[k] for sc in per_seed]) for k in per_seed[0]}
        scores["loss"] = losses
        return scores

    def draw_batch(self, sampler, generators):
        """One batch from ``sampler`` per seed generator -> x (S, B, T, F),
        y (S, B, T_out, C)."""
        xs, ys = zip(*(sampler.sample_batch(g, self.tcfg.batch_size) for g in generators))
        return torch.stack(xs), torch.stack(ys)

    def train_epoch(self, state: TrainState, rngs: Sequence[Rngs], n_steps: int):
        losses, preds, ys = [], [], []
        for _ in range(n_steps):
            x, y = self.draw_batch(self.train_sampler, [r.batch for r in rngs])
            state, loss, probs = self.train_step(state, x, y, [r.dropout for r in rngs])
            losses.append(loss)
            preds.append(probs)
            ys.append(y)
        return state, self._scores(torch.stack(losses).sum(0) / max(n_steps, 1), preds, ys)

    @torch.no_grad()
    def eval_epoch(self, state: TrainState, generators: Sequence[torch.Generator],
                   n_steps: int):
        """Random validation draws, each seed's from its own generator."""
        self.model.eval()
        losses, preds, ys = [], [], []
        for _ in range(n_steps):
            x, y = self.draw_batch(self.val_sampler, generators)
            logits = self.model(x)
            losses.append(self._losses(logits, y))
            preds.append(torch.sigmoid(logits))
            ys.append(y)
        return self._scores(torch.stack(losses).sum(0) / max(n_steps, 1), preds, ys)

    @torch.no_grad()
    def eval_sweep(self, state: TrainState, n_steps: Optional[int] = None):
        """`Trainer.eval_sweep` with the shared split fed to every seed."""
        self.model.eval()
        sampler, batch, S = self.val_sampler, self.tcfg.batch_size, self.n_seeds
        if n_steps is None:
            n_steps = sampler.sweep_steps(batch)
        dev = sampler.data["mel"].device
        t_out = sampler.spec.seq_len_out
        loss_sum = torch.zeros((S,), device=dev)
        n_elem = torch.zeros((), device=dev)
        preds, ys = [], []
        for i in range(n_steps):
            idx = i * batch + torch.arange(batch, device=dev)
            x, y, valid = sweep_batch_from(sampler.spec, sampler.data, idx)
            logits = self.model(x.expand(S, *x.shape))
            w = valid.float()[:, None, None]
            y = y.expand(S, *y.shape)
            loss_sum = loss_sum + (self.loss_fn(logits, y, reduction="none") * w).sum(
                dim=(1, 2, 3))
            n_elem = n_elem + w.sum() * (t_out * logits.shape[-1])
            preds.append(torch.sigmoid(logits) * w)
            ys.append(y * w)
        return self._scores(loss_sum / torch.clamp_min(n_elem, 1.0), preds, ys,
                            sampler.n_windows * t_out)


def _to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Every tensor on the host in one copy (float64 holds each float32 and
    count exactly), back in its own dtype and shape."""
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        dtype = np.float32 if t.dtype == torch.float32 else np.int64
        out.append(flat[i : i + n].reshape(tuple(t.shape)).astype(dtype))
        i += n
    return out


def _check_lanes(n_seeds: int, mesh: Mesh) -> None:
    if n_seeds % mesh.size:
        raise ValueError(
            f"{n_seeds} seeds cannot shard evenly over a {mesh.size}-device"
            f" mesh — pass a seed count divisible by the mesh size"
        )


def shard_lanes(tree, mesh: Mesh):
    """This rank's contiguous share of a lane-stacked host tree (dicts,
    lists and tuples of arrays whose leading axis is the lane axis)."""
    if isinstance(tree, dict):
        return {k: shard_lanes(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_lanes(v, mesh) for v in tree)
    n = len(tree)
    _check_lanes(n, mesh)
    k = n // mesh.size
    return tree[mesh.rank * k : (mesh.rank + 1) * k]


def run_fold_multiseed(
    cfg: ExperimentConfig,
    fold_data: Dict[str, np.ndarray],
    fold_id: int,
    art_dir: str,
    seeds: Sequence[int],
    verbose: bool = True,
    lr_scales: Optional[Sequence[float]] = None,
    device=None,
    mesh: Optional[Mesh] = None,
) -> List[FoldResult]:
    """Train ``len(seeds)`` independent runs of one fold as one stacked model;
    returns one `FoldResult` per seed, ordered like ``seeds``.

    ``lr_scales`` (optional, one per lane) multiplies each lane's base
    learning rate, so the lanes double as a learning-rate sweep (a seed may
    then repeat, and each lane writes ``seed<s>_lr<scale>/``). Under a
    plateau schedule each lane's schedule starts from its own base scale.
    ``device``: None means ``cuda`` (raises without a GPU). ``mesh``: a seed
    mesh; the seed count must divide by its size, rank r trains lanes
    ``[r * k, (r + 1) * k)`` on the mesh's device, and every rank returns
    every seed's result."""
    seeds = list(seeds)
    n = len(seeds)
    if n < 1:
        raise ValueError("need at least one seed")
    if lr_scales is not None and len(lr_scales) != n:
        raise ValueError(f"{len(lr_scales)} lr_scales for {n} seeds — need one per lane")
    if len(set(seeds)) != n and lr_scales is None:
        raise ValueError(f"duplicate seeds in {seeds} — runs would be identical")
    if len(set(zip(seeds, lr_scales or [0.0] * n))) != n:
        raise ValueError("duplicate (seed, lr_scale) lanes — runs would be identical")
    if mesh is None:
        return _run_lanes(cfg, fold_data, fold_id, art_dir, seeds, verbose, lr_scales,
                          resolve_device(device), None)
    _check_lanes(n, mesh)
    seeds = shard_lanes(np.asarray(seeds), mesh).tolist()
    if lr_scales is not None:
        lr_scales = shard_lanes(np.asarray(lr_scales, np.float64), mesh).tolist()
    mine = _run_lanes(cfg, fold_data, fold_id, art_dir, seeds, verbose, lr_scales,
                      mesh.device, mesh)
    return [r for share in gather_objects(mine, mesh) for r in share]


def _run_lanes(cfg, fold_data, fold_id, art_dir, seeds, verbose, lr_scales, dev, mesh):
    """`run_fold_multiseed`'s training of ``seeds`` on ``dev``; with a
    ``mesh``, one all_reduce per epoch of the live lane count keeps the
    ranks in step (no other collective)."""
    n = len(seeds)
    tcfg = cfg.train
    models = [get_model(cfg.model).init_parameters(torch.Generator().manual_seed(s + fold_id))
              for s in seeds]
    model = StackedCRNN.from_models(models).to(dev)
    train_sampler, val_sampler = make_samplers(cfg, fold_data, dev)
    trainer = MultiSeedTrainer(model, tcfg, train_sampler, val_sampler)
    rngs = [Rngs(dev, s + fold_id, model.n_dropout_sites) for s in seeds]
    base = np.ones(n, np.float32) if lr_scales is None else np.asarray(lr_scales, np.float32)
    state = TrainState(trainer.adam.init({k: p.detach() for k, p in trainer.params().items()}),
                       torch.from_numpy(base).to(dev))
    plateau = [PlateauState(float("inf"), 0, float(b)) for b in base] if trainer.plateau else None

    n_train_steps = train_sampler.steps_per_epoch(tcfg.batch_size)
    n_val_steps = max(1, val_sampler.steps_per_epoch(tcfg.batch_size, drop_last=False))
    if n_train_steps < 1:
        raise ValueError(f"fold {fold_id}: {train_sampler.epoch_examples} examples "
                         f"< batch size {tcfg.batch_size}")
    full_sweep = _use_full_sweep(tcfg)
    n_sweep_steps = val_sampler.sweep_steps(tcfg.batch_size)

    if lr_scales is None:
        seed_dirs = [os.path.join(art_dir, f"seed{s}") for s in seeds]
    else:
        seed_dirs = [os.path.join(art_dir, f"seed{s}_lr{lr:g}") for s, lr in zip(seeds, lr_scales)]
    for d in seed_dirs:
        os.makedirs(d, exist_ok=True)

    best_er = np.full(n, np.inf)
    best_f1 = np.zeros(n)
    best_epoch = np.zeros(n, np.int64)
    no_imp = np.zeros(n, np.int64)
    stop_epoch = np.zeros(n, np.int64)  # 0 = still running
    histories: List[Dict[str, List[float]]] = [
        {k: [] for pair in _TRACK_KEYS for k in pair[:2]} for _ in range(n)]
    frames_per_sec = cfg.frontend.sample_rate / cfg.frontend.hop_length
    audio_sec = n_train_steps * tcfg.batch_size * cfg.model.seq_len_in / frames_per_sec
    names = list(model.state_dict())
    t_start = time.time()

    epoch = 0
    live = n
    for epoch in range(1, tcfg.max_epochs + 1):
        if mesh is not None:
            everywhere = all_reduce_sum(torch.tensor([float(live)], device=dev), mesh)
            if float(everywhere[0]) == 0.0:
                break
        if live == 0:
            continue  # this rank's lanes stopped; it waits for the others
        t_ep = time.time()
        state, tr_scores = trainer.train_epoch(state, rngs, n_train_steps)
        if full_sweep:
            val_scores = trainer.eval_sweep(state, n_sweep_steps)
        else:
            val_scores = trainer.eval_epoch(state, [r.val for r in rngs], n_val_steps)

        # One host copy per epoch: every seed's scores, parameters, BatchNorm
        # statistics and Adam moments.
        keys = list(tr_scores)
        sd = model.state_dict()
        opt = state.opt_state
        host = _to_host([tr_scores[k] for k in keys] + [val_scores[k] for k in keys]
                        + [sd[k] for k in names] + list(opt.mu.values()) + list(opt.nu.values()))
        tr_h = dict(zip(keys, host[: len(keys)]))
        val_h = dict(zip(keys, host[len(keys) : 2 * len(keys)]))
        rest = iter(host[2 * len(keys) :])
        sd_h = {k: torch.from_numpy(next(rest)) for k in names}
        mu_h = {k: torch.from_numpy(next(rest)) for k in opt.mu}
        nu_h = {k: torch.from_numpy(next(rest)) for k in opt.nu}
        if plateau is not None:
            plateau = [trainer.plateau.step(p, float(val_h["loss"][i]))
                       for i, p in enumerate(plateau)]
            scales = np.asarray([p.lr_scale for p in plateau], np.float32)
            state = state._replace(lr_scale=torch.from_numpy(scales).to(dev))
        dt = time.time() - t_ep

        for i, s in enumerate(seeds):
            if stop_epoch[i]:
                continue  # frozen: this seed's own run already ended
            tr = {k: float(v[i]) for k, v in tr_h.items()}
            val = {k: float(v[i]) for k, v in val_h.items()}
            for tr_key, val_key, src in _TRACK_KEYS:
                histories[i][tr_key].append(tr[src])
                histories[i][val_key].append(val[src])
            val_er = val["er_overall_1sec"]
            improved = val_er < best_er[i]
            if improved:
                best_er[i], best_f1[i] = val_er, val["f1_overall_1sec"]
                best_epoch[i], no_imp[i] = epoch, 0
            else:
                no_imp[i] += 1
            lr_i = float(plateau[i].lr_scale) if plateau is not None else float(base[i])
            meta: Dict[str, Any] = {
                "epoch": epoch,
                "fold": fold_id,
                "seed": s,
                **({"base_lr_scale": float(lr_scales[i])} if lr_scales is not None else {}),
                "best_er": float(best_er[i]),
                "best_f1": float(best_f1[i]),
                "best_epoch": int(best_epoch[i]),
                "no_imp": int(no_imp[i]),
                "key_seed": s + fold_id + epoch * 10007,
                "history": histories[i],
            }
            if plateau is not None:
                meta["plateau"] = plateau[i]._asdict()
            params, model_state = to_jax(model.split(sd_h, i), cfg.model)
            opt_i = opt_state_to_jax(opt.step, model.split(mu_h, i), model.split(nu_h, i),
                                     cfg.model)
            # run_fold(resume_from=...) continues this seed from here.
            tree = {"params": params, "model_state": model_state, "opt_state": opt_i,
                    "lr_scale": np.asarray(lr_i, np.float32), "torch_rng": rngs[i].get_state()}
            if improved:
                ckpt_io.save_checkpoint(os.path.join(seed_dirs[i], f"best_fold{fold_id}.npz"),
                                        tree, meta)
            if tcfg.checkpoint_policy == "all":
                ckpt_io.save_checkpoint(
                    os.path.join(seed_dirs[i],
                                 f"epoch{epoch:03d}-valer{val_er:.3f}_fold{fold_id}.npz"),
                    tree, meta)
            ckpt_io.save_checkpoint(os.path.join(seed_dirs[i], f"last_fold{fold_id}.npz"),
                                    tree, meta)
            artifacts.append_jsonl(os.path.join(seed_dirs[i], f"train_fold{fold_id}.jsonl"), {
                "fold": fold_id,
                "seed": s,
                "epoch": epoch,
                "epoch_sec": round(dt, 3),
                "audio_hours_per_sec": round(n * audio_sec / 3600.0 / dt, 4),
                "train": tr,
                "val": val,
                "lr_scale": lr_i,
            })
            if tcfg.plot_every and epoch % tcfg.plot_every == 0:
                artifacts.save_loss_curve(os.path.join(seed_dirs[i], f"loss_fold{fold_id}.png"),
                                          histories[i]["loss_tr"], histories[i]["loss_val"])
            if (no_imp[i] > tcfg.early_stop_patience if tcfg.early_stop_strict_greater
                    else no_imp[i] >= tcfg.early_stop_patience):
                stop_epoch[i] = epoch

        live = int(np.sum(stop_epoch == 0))
        if verbose:
            ers = "/".join(f"{v:.3f}" for v in val_h["er_overall_1sec"])
            print(f"[Fold {fold_id}] [Epoch {epoch}/{tcfg.max_epochs}] "
                  f"dt={dt:.1f}s total={(time.time() - t_start) / 60:.1f}min | "
                  f"{n} seeds ({live} live) | val_ER={ers}")
        if live == 0 and mesh is None:
            break

    results = []
    for i, s in enumerate(seeds):
        best_path = os.path.join(seed_dirs[i], f"best_fold{fold_id}.npz")
        results.append(FoldResult(
            fold_id=fold_id,
            best_er=float(best_er[i]),
            best_f1=float(best_f1[i]),
            best_epoch=int(best_epoch[i]),
            epochs_run=int(stop_epoch[i]) if stop_epoch[i] else epoch,
            history=histories[i],
            best_checkpoint=best_path if os.path.exists(best_path) else None,
        ))
        if verbose:
            print(f"fold {fold_id} seed {s}: best ER={best_er[i]:.3f} @ epoch={int(best_epoch[i])}")
    return results


def choose_runs_mode(cfg: ExperimentConfig, n_runs: int, mesh: Optional[Mesh] = None) -> str:
    """The faster mode for ``n_runs`` seeds, by the JAX rule's shape with the
    card's own split: a seed mesh always stacks (sequential mode cannot use
    it); on one card a conv trunk under 128 channels always stacks, and a
    conv-128 trunk runs sequential once its stacked effective batch
    (batch_size x n_runs) reaches `STACKED_SPLIT_BATCH`."""
    if mesh is not None:
        return "stacked"
    if max(cfg.model.conv_channels) < _BIG_CONV_CHANNELS:
        return "stacked"
    if cfg.train.batch_size * n_runs >= STACKED_SPLIT_BATCH:
        return "sequential"
    return "stacked"


def run_experiment_multiseed(
    cfg: ExperimentConfig,
    folds: Dict[int, Dict[str, np.ndarray]],
    art_dir: str,
    seeds: Optional[Sequence[int]] = None,
    n_runs: int = 5,
    verbose: bool = True,
    mode: str = "auto",
    device=None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, Any]:
    """Train every fold once per seed (``seeds``, or ``run_seeds(cfg.train.
    seed, n_runs)``); returns the seed-major mean and std of the best ER/F1
    (each seed's cross-fold mean first), the per-seed values, the seeds and
    the `FoldResult`s, and appends all but the results to
    ``experiment_multiseed.jsonl``.

    ``mode``: "stacked" (`run_fold_multiseed` per fold), "sequential"
    (`run_fold` per seed and fold) or "auto" (`choose_runs_mode`); an
    explicit mode that contradicts the rule runs as asked but warns. Both
    write ``<art_dir>/fold<k>/seed<s>/`` in `run_fold`'s layout.
    ``device``: None means ``cuda`` (raises without a GPU). ``mesh``: a seed
    mesh for stacked mode (`run_fold_multiseed`), on its device; every rank
    returns the whole result and rank 0 alone prints the summary and
    appends the record."""
    if mode not in ("auto", "stacked", "sequential"):
        raise ValueError(f"mode must be 'auto', 'stacked' or 'sequential', got {mode!r}")
    dev = resolve_device(device) if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0
    verbose = verbose and writer
    seeds = list(run_seeds(cfg.train.seed, n_runs) if seeds is None else seeds)
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"duplicate seeds in {seeds}: runs would be identical")
    predicted = choose_runs_mode(cfg, len(seeds), mesh)
    if mode == "auto":
        mode = predicted
        if verbose:
            print(f"runs-mode auto -> {mode}")
    elif mode != predicted:
        warnings.warn(
            f"runs-mode {mode} is predicted slower than {predicted!r} here (conv "
            f"{max(cfg.model.conv_channels)}ch, stacked effective batch "
            f"{cfg.train.batch_size * len(seeds)} vs the measured split "
            f"{STACKED_SPLIT_BATCH}); proceeding as asked", stacklevel=2)
    if mode == "sequential" and mesh is not None:
        raise ValueError("mode='sequential' does not shard seeds; drop mesh")
    per_fold: Dict[int, List[FoldResult]] = {}
    for fold_id, fold_data in sorted(folds.items()):
        fold_dir = os.path.join(art_dir, f"fold{fold_id}")
        if mode == "stacked":
            per_fold[fold_id] = run_fold_multiseed(cfg, fold_data, fold_id, fold_dir, seeds,
                                                   verbose=verbose, device=dev, mesh=mesh)
        else:
            per_fold[fold_id] = [
                run_fold(cfg, fold_data, fold_id, os.path.join(fold_dir, f"seed{s}"), seed=s,
                         verbose=verbose, device=dev)
                for s in seeds
            ]
    er_by_seed = [float(np.mean([per_fold[f][j].best_er for f in per_fold]))
                  for j in range(len(seeds))]
    f1_by_seed = [float(np.mean([per_fold[f][j].best_f1 for f in per_fold]))
                  for j in range(len(seeds))]
    out = {
        "mean_er": float(np.mean(er_by_seed)),
        "std_er": float(np.std(er_by_seed)),
        "mean_f1": float(np.mean(f1_by_seed)),
        "std_f1": float(np.std(f1_by_seed)),
        "er_by_seed": er_by_seed,
        "f1_by_seed": f1_by_seed,
        "seeds": seeds,
        "folds": per_fold,
    }
    if verbose:
        print(f"{len(seeds)}-run protocol: ER {out['mean_er']:.3f} ± {out['std_er']:.3f}"
              f" | F1 {out['mean_f1']:.3f} ± {out['std_f1']:.3f}")
    if writer:
        artifacts.append_jsonl(
            os.path.join(art_dir, "experiment_multiseed.jsonl"),
            {k: v for k, v in out.items() if k != "folds"} | {"experiment": cfg.name},
        )
    return out
