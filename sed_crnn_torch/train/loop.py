"""The experiment runner: train and validation epochs, early stopping on
1-second segment ER, checkpointing, and the k-fold driver.

Counterpart of the JAX package's `train/loop.py` (`Trainer`, `run_fold`,
`run_experiment`), with its semantics: per epoch a training pass and a
validation pass (a deterministic full-split sweep for the sequence sampler,
random draws otherwise), scores on binarized sigmoid predictions, the
tracked history ``_TRACK_KEYS``, one jsonl record per epoch, best/all/last
checkpoints, strict or non-strict early stop on the validation 1-second
ER, the ReduceLROnPlateau schedule on the validation loss, and resume.

What differs, and why:

* The loop is the JAX package's sequential (``debug``) path. Its pipelined
  dispatch and its `CompilePlan` shape buckets exist to keep one compiled
  XLA program busy across epochs and folds; PyTorch runs eagerly and has no
  program to share, so neither is ported. Data parallelism
  (`parallel/data_parallel.py`) runs one process per card: a
  ``trainer_factory`` (`data_parallel_factory`) swaps in a trainer whose
  hooks below (`Trainer.local_batch`, ``_synced``, ``_reduce_grads``,
  ``_collect``, the generator and barrier hooks) reduce across ranks; the
  single-device trainer's hooks are identities. Multi-seed training
  (`train/multiseed.py`) runs `run_fold` per seed or all seeds of a fold as
  one stacked model.
* Random numbers come from `torch.Generator`s on the training device: one
  for batch draws, one for random validation draws and one per dropout site
  (`CRNN.n_dropout_sites`), seeded from ``seed + fold_id`` (data-parallel
  replica r > 0 from child r of that seed, `Rngs`). Parameters are
  drawn on the CPU from their own generator, so the card and the CPU start
  from the same weights. A checkpoint written here stores the generators'
  states under ``torch_rng`` and resumes exactly. A JAX ``rng_key`` cannot
  be continued by torch: resuming from a JAX checkpoint reseeds from its
  ``key_seed``, as the JAX package does for checkpoints without a key.

Checkpoints are the JAX package's npz format (``params``, ``model_state``,
``opt_state{step, mu, nu}``, ``lr_scale``), converted by
`models/convert.py`, so each package resumes and serves the other's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sed_crnn_torch.core import checkpoint as ckpt_io
from sed_crnn_torch.core.config import ExperimentConfig, TrainConfig
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.data.sampler import BalancedWindowSampler, SequenceWindowSampler, sweep_batch_from
from sed_crnn_torch.models import get_model
from sed_crnn_torch.models.convert import from_jax, opt_state_from_jax, opt_state_to_jax, to_jax
from sed_crnn_torch.models.crnn import CRNN
from sed_crnn_torch.ops import metrics as metrics_ops
from sed_crnn_torch.ops.losses import make_loss
from sed_crnn_torch.train import artifacts
from sed_crnn_torch.train.optim import Adam, AdamState, PlateauState, ReduceLROnPlateau
from sed_crnn_torch.utils.debug import assert_tree_finite, guard_scores

_TRACK_KEYS = (
    ("loss_tr", "loss_val", "loss"),
    ("f1_1s_tr", "f1_1s_val", "f1_overall_1sec"),
    ("er_1s_tr", "er_1s_val", "er_overall_1sec"),
    ("f1_fr_tr", "f1_fr_val", "f1_frame"),
    ("er_fr_tr", "er_fr_val", "er_frame"),
)


class TrainState(NamedTuple):
    """What the optimizer carries between steps; the parameters and the
    BatchNorm statistics live in the trainer's model."""

    opt_state: AdamState
    lr_scale: float


@dataclasses.dataclass
class FoldResult:
    fold_id: int
    best_er: float
    best_f1: float
    best_epoch: int
    epochs_run: int
    history: Dict[str, List[float]]
    best_checkpoint: Optional[str]


class Rngs:
    """The loop's random streams on one device: ``batch`` (training draws),
    ``val`` (random validation draws) and ``dropout`` (one per site), from
    ``np.random.SeedSequence(seed)``; data-parallel replica r > 0 draws from
    its child r (``spawn_key=(r,)``), so replica 0 draws `run_fold`'s
    streams."""

    def __init__(self, device: torch.device, seed: int, n_dropout: int, replica: int = 0):
        seq = np.random.SeedSequence(seed, spawn_key=(replica,) if replica else ())
        seeds = seq.generate_state(2 + n_dropout)
        gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
        self.batch, self.val, self.dropout = gens[0], gens[1], gens[2:]

    def _all(self) -> List[torch.Generator]:
        return [self.batch, self.val, *self.dropout]

    def get_state(self) -> List[np.ndarray]:
        return [g.get_state().numpy() for g in self._all()]

    def set_state(self, states: Sequence[np.ndarray]) -> None:
        gens = self._all()
        if len(states) != len(gens):
            raise ValueError(f"{len(states)} generator states for {len(gens)} generators")
        for g, s in zip(gens, states):
            g.set_state(torch.from_numpy(np.asarray(s, np.uint8)))


def make_samplers(cfg: ExperimentConfig, fold_data: Dict[str, np.ndarray], device):
    m, t = cfg.model, cfg.train
    if t.sampler == "balanced":
        cls = BalancedWindowSampler
    elif t.sampler == "sequence":
        cls = SequenceWindowSampler
    else:
        raise ValueError(f"unknown sampler {t.sampler!r}")
    train = cls(fold_data["train_x"], fold_data["train_y"], m.seq_len_in, m.seq_len_out,
                augment=t.spec_augment, device=device)
    val = cls(fold_data["val_x"], fold_data["val_y"], m.seq_len_in, m.seq_len_out,
              augment=False, device=device)
    return train, val


class Trainer:
    """Train and validation epochs for one fold; the model is on the
    samplers' device.

    The data-parallel hooks (identities here, `DataParallelTrainer`
    overrides them): ``replica`` and ``local_batch`` (this rank's index and
    its share of the batch), ``is_writer`` (the rank that writes
    checkpoints, jsonl and plots and prints), ``_synced`` (the train step's
    context: cross-replica BatchNorm), ``_reduce_grads``, ``_collect`` (the
    epoch's per-step losses, predictions and labels over every rank),
    ``replica_rngs`` / ``resume_rngs`` / ``rng_tree`` (each replica's
    generators, fresh, resumed and checkpointed) and ``barrier``."""

    replica = 0
    is_writer = True

    def __init__(self, model: CRNN, tcfg: TrainConfig, train_sampler, val_sampler):
        self.model = model
        self.local_batch = tcfg.batch_size
        self.tcfg = tcfg
        self.train_sampler = train_sampler
        self.val_sampler = val_sampler
        self.loss_fn = make_loss(tcfg.loss, tcfg.focal_alpha, tcfg.focal_gamma)
        self.adam = Adam(learning_rate=tcfg.learning_rate, weight_decay=tcfg.weight_decay,
                         grad_clip_norm=tcfg.grad_clip_norm)
        self.plateau = (ReduceLROnPlateau(tcfg.plateau_factor, tcfg.plateau_patience)
                        if tcfg.plateau_factor is not None else None)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    # ---- data-parallel hooks (identities on one device) -------------------
    def _synced(self):
        return contextlib.nullcontext()

    def _reduce_grads(self, grads: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        return grads

    def _collect(self, losses: Sequence[torch.Tensor], preds, ys, extra=None):
        """(losses (steps,), p (steps, B, T, C), y, extra) of an epoch;
        ``extra`` (sums, or None) summed over ranks."""
        return (torch.stack(losses) if losses else None, torch.stack(preds), torch.stack(ys),
                extra)

    def replica_rngs(self, device: torch.device, seed: int) -> "Rngs":
        return Rngs(device, seed, self.model.n_dropout_sites, self.replica)

    def resume_rngs(self, rngs: "Rngs", tree: Dict, meta: Dict, device: torch.device,
                    fallback_seed: int) -> "Rngs":
        """The generators a resumed run continues with: the checkpoint's
        ``torch_rng`` states, or a reseed from its ``key_seed`` (a JAX
        checkpoint's key cannot be continued by torch)."""
        if "torch_rng" in tree:
            rngs.set_state(tree["torch_rng"])
            return rngs
        return self.replica_rngs(device, int(meta.get("key_seed", fallback_seed)))

    def rng_tree(self, rngs: "Rngs") -> Dict:
        """Checkpoint entries for the generators."""
        return {"torch_rng": rngs.get_state()}

    def barrier(self) -> None:
        pass

    # ---- state ---------------------------------------------------------
    def init_state(self, generator: torch.Generator) -> TrainState:
        """Draw the model's parameters from ``generator`` (CPU) and start
        Adam and the learning-rate scale afresh."""
        self.model.init_parameters(generator)
        return TrainState(self.adam.init({k: p.detach() for k, p in self.params().items()}), 1.0)

    # ---- one optimizer step on a given batch -----------------------------
    def train_step(self, state: TrainState, x: torch.Tensor, y: torch.Tensor,
                   dropout_generators: Optional[Sequence[torch.Generator]] = None):
        """Forward in train mode (BatchNorm statistics updated), loss,
        gradients, Adam -> ``(state, loss, probabilities)``, the last two
        detached; the parameters are updated in place."""
        self.model.train()
        params = self.params()
        with self._synced():
            logits, _ = self.model(x, dropout_generators=dropout_generators)
            loss = self.loss_fn(logits, y)
            grads = self._reduce_grads(torch.autograd.grad(loss, list(params.values())))
        new_params, opt_state = self.adam.update(
            dict(zip(params, grads)), state.opt_state,
            {k: p.detach() for k, p in params.items()}, state.lr_scale)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        return state._replace(opt_state=opt_state), loss.detach(), torch.sigmoid(logits.detach())

    # ---- epochs ----------------------------------------------------------
    def _scores(self, losses, preds, ys) -> Dict[str, torch.Tensor]:
        losses, p, y, _ = self._collect(losses, preds, ys)
        c = p.shape[-1]
        scores = metrics_ops.all_scores_masked(
            (p > self.tcfg.threshold).reshape(-1, c), y.reshape(-1, c),
            self.tcfg.frames_in_1_sec, p[..., 0].numel())
        scores["loss"] = losses.sum() / max(losses.shape[0], 1)
        return scores

    def train_epoch(self, state: TrainState, rngs: Rngs, n_steps: int):
        """``n_steps`` optimizer steps on random batches -> (state, scores)."""
        losses, preds, ys = [], [], []
        for _ in range(n_steps):
            x, y = self.train_sampler.sample_batch(rngs.batch, self.local_batch)
            state, loss, probs = self.train_step(state, x, y, rngs.dropout)
            losses.append(loss)
            preds.append(probs)
            ys.append(y)
        return state, self._scores(losses, preds, ys)

    @torch.no_grad()
    def eval_epoch(self, state: TrainState, generator: torch.Generator, n_steps: int):
        """Validation on ``n_steps`` random batches (eval mode) -> scores."""
        self.model.eval()
        losses, preds, ys = [], [], []
        for _ in range(n_steps):
            x, y = self.val_sampler.sample_batch(generator, self.local_batch)
            logits, _ = self.model(x)
            losses.append(self.loss_fn(logits, y))
            preds.append(torch.sigmoid(logits))
            ys.append(y)
        return self._scores(losses, preds, ys)

    @torch.no_grad()
    def eval_sweep(self, state: TrainState, n_steps: Optional[int] = None):
        """Deterministic full-split validation: every aligned window of the
        validation split in time order, scored as one stream. Same
        parameters give the same scores. Replica r of a data-parallel run
        takes windows ``i * batch + r * local_batch + arange(local_batch)``
        of step i; `_collect` interleaves them back step by step."""
        self.model.eval()
        sampler, batch, local = self.val_sampler, self.tcfg.batch_size, self.local_batch
        if n_steps is None:
            n_steps = sampler.sweep_steps(batch)
        dev = sampler.data["mel"].device
        t_out = sampler.spec.seq_len_out
        loss_sum = torch.zeros((), device=dev)
        n_elem = torch.zeros((), device=dev)
        preds, ys = [], []
        for i in range(n_steps):
            idx = i * batch + self.replica * local + torch.arange(local, device=dev)
            x, y, valid = sweep_batch_from(sampler.spec, sampler.data, idx)
            logits, _ = self.model(x)
            w = valid.float()[:, None, None]
            loss_sum = loss_sum + (self.loss_fn(logits, y, reduction="none") * w).sum()
            n_elem = n_elem + w.sum() * (t_out * logits.shape[-1])
            preds.append(torch.sigmoid(logits) * w)
            ys.append(y * w)
        _, p, y, (loss_sum, n_elem) = self._collect([], preds, ys, torch.stack([loss_sum, n_elem]))
        c = p.shape[-1]
        scores = metrics_ops.all_scores_masked(
            (p > self.tcfg.threshold).reshape(-1, c), y.reshape(-1, c),
            self.tcfg.frames_in_1_sec, sampler.n_windows * t_out)
        scores["loss"] = loss_sum / torch.clamp_min(n_elem, 1.0)
        return scores


def _use_full_sweep(tcfg: TrainConfig) -> bool:
    if tcfg.val_full_sweep is not None:
        return tcfg.val_full_sweep
    return tcfg.sampler == "sequence"


def data_parallel_factory(mesh):
    """``trainer_factory`` for `run_fold` / `run_experiment` that trains
    each fold data-parallel over ``mesh`` (`parallel/data_parallel.py`);
    the fold's device is the mesh's."""

    def factory(model, tcfg, train_sampler, val_sampler):
        from sed_crnn_torch.parallel.data_parallel import DataParallelTrainer

        return DataParallelTrainer(model, tcfg, train_sampler, val_sampler, mesh)

    return factory


def checkpoint_tree(trainer: Trainer, state: TrainState, rngs: Optional[Rngs] = None) -> Dict:
    """The JAX checkpoint layout of the trainer's model and ``state``, plus
    the port's generator states under ``torch_rng``."""
    cfg = trainer.model.cfg
    params, model_state = to_jax(trainer.model.state_dict(), cfg)
    opt = state.opt_state
    tree = {
        "params": params,
        "model_state": model_state,
        "opt_state": opt_state_to_jax(opt.step, opt.mu, opt.nu, cfg),
        "lr_scale": np.asarray(state.lr_scale, np.float32),
    }
    if rngs is not None:
        tree["torch_rng"] = rngs.get_state()
    return tree


def restore_checkpoint(trainer: Trainer, tree: Dict) -> TrainState:
    """Load a JAX-layout checkpoint tree into the trainer's model -> state."""
    cfg = trainer.model.cfg
    dev = trainer.train_sampler.data["mel"].device
    trainer.model.load_state_dict(from_jax(tree["params"], tree["model_state"], cfg))
    opt = opt_state_from_jax(tree["opt_state"], cfg)
    moved = {k: {n: t.to(dev) for n, t in opt[k].items()} for k in ("mu", "nu")}
    return TrainState(AdamState(opt["step"], moved["mu"], moved["nu"]),
                      float(np.asarray(tree["lr_scale"])))


def run_fold(
    cfg: ExperimentConfig,
    fold_data: Dict[str, np.ndarray],
    fold_id: int,
    art_dir: str,
    seed: Optional[int] = None,
    resume_from: Optional[str] = None,
    verbose: bool = True,
    device=None,
    trainer_factory=None,
    debug: bool = False,
) -> FoldResult:
    """Train one fold to early stop; returns the best 1-second segment ER.
    ``device``: None means ``cuda`` (raises without a GPU); ``"cpu"`` runs
    the plain versions of the kernels. ``trainer_factory`` (``(model, tcfg,
    train_sampler, val_sampler) -> Trainer``, e.g. `data_parallel_factory`)
    replaces `Trainer`; under a data-parallel one, pass the mesh's device:
    every rank trains the same parameters and returns the same result, and
    only its writer rank writes files and prints. ``debug``: after each
    epoch's scores, raise `utils.debug.NonFiniteError` on a non-finite
    training or validation loss, or on a non-finite parameter (named by its
    path in the JAX layout); nothing else changes."""
    return _run_fold(cfg, fold_data, fold_id, art_dir, seed, resume_from, verbose, device,
                     trainer_factory, debug)[0]


def _run_fold(cfg, fold_data, fold_id, art_dir, seed, resume_from, verbose, device,
              trainer_factory, debug=False) -> Tuple[FoldResult, bool]:
    """`run_fold` -> (its result, whether this process wrote its files: the
    trainer's ``is_writer``)."""
    dev = resolve_device(device)
    tcfg = cfg.train
    model = get_model(cfg.model).to(dev)
    train_sampler, val_sampler = make_samplers(cfg, fold_data, dev)
    trainer = (trainer_factory or Trainer)(model, tcfg, train_sampler, val_sampler)
    writer = trainer.is_writer
    verbose = verbose and writer
    if writer:
        os.makedirs(art_dir, exist_ok=True)

    seed = tcfg.seed if seed is None else seed
    state = trainer.init_state(torch.Generator().manual_seed(seed + fold_id))
    rngs = trainer.replica_rngs(dev, seed + fold_id)
    plateau_state = trainer.plateau.init() if trainer.plateau else None

    start_epoch = 1
    best_er, best_f1, best_epoch, no_imp = float("inf"), 0.0, 0, 0
    history: Dict[str, List[float]] = {k: [] for pair in _TRACK_KEYS for k in pair[:2]}

    if resume_from:
        tree, meta = ckpt_io.load_checkpoint(resume_from)
        state = restore_checkpoint(trainer, tree)
        start_epoch = int(meta.get("epoch", 0)) + 1
        best_er = float(meta.get("best_er", float("inf")))
        best_f1 = float(meta.get("best_f1", 0.0))
        best_epoch = int(meta.get("best_epoch", 0))
        no_imp = int(meta.get("no_imp", 0))
        rngs = trainer.resume_rngs(rngs, tree, meta, dev, seed + fold_id + start_epoch)
        history = meta.get("history", history)
        if plateau_state is not None and "plateau" in meta:
            plateau_state = PlateauState(**meta["plateau"])

    n_train_steps = train_sampler.steps_per_epoch(tcfg.batch_size)
    n_val_steps = max(1, val_sampler.steps_per_epoch(tcfg.batch_size, drop_last=False))
    if n_train_steps < 1:
        raise ValueError(f"fold {fold_id}: {train_sampler.epoch_examples} examples "
                         f"< batch size {tcfg.batch_size}")
    full_sweep = _use_full_sweep(tcfg)
    n_sweep_steps = val_sampler.sweep_steps(tcfg.batch_size)

    best_ckpt_path = os.path.join(art_dir, f"best_fold{fold_id}.npz")
    jsonl_path = os.path.join(art_dir, f"train_fold{fold_id}.jsonl")
    t_start = time.time()
    epochs_run = start_epoch - 1
    frames_per_sec = cfg.frontend.sample_rate / cfg.frontend.hop_length
    audio_sec = n_train_steps * tcfg.batch_size * cfg.model.seq_len_in / frames_per_sec

    for epoch in range(start_epoch, tcfg.max_epochs + 1):
        t_ep = time.time()
        state, tr_scores = trainer.train_epoch(state, rngs, n_train_steps)
        if full_sweep:
            val_scores = trainer.eval_sweep(state, n_sweep_steps)
        else:
            val_scores = trainer.eval_epoch(state, rngs.val, n_val_steps)
        tr = {k: float(v) for k, v in tr_scores.items()}
        val = {k: float(v) for k, v in val_scores.items()}
        if debug:
            guard_scores(tr, epoch, fold_id)
            guard_scores(val, epoch, fold_id)
            assert_tree_finite(to_jax(trainer.model.state_dict(), cfg.model)[0],
                               f"fold {fold_id} epoch {epoch} params")
        if trainer.plateau:
            plateau_state = trainer.plateau.step(plateau_state, val["loss"])
            state = state._replace(lr_scale=plateau_state.lr_scale)
        epochs_run = epoch

        for tr_key, val_key, src in _TRACK_KEYS:
            history[tr_key].append(tr[src])
            history[val_key].append(val[src])
        val_er = val["er_overall_1sec"]
        improved = val_er < best_er
        if improved:
            best_er, best_f1, best_epoch, no_imp = val_er, val["f1_overall_1sec"], epoch, 0
        else:
            no_imp += 1

        dt = time.time() - t_ep
        rng_entries = trainer.rng_tree(rngs)   # every rank joins a data-parallel gather
        if verbose:
            print(
                f"[Fold {fold_id}] [Epoch {epoch}/{tcfg.max_epochs}] "
                f"dt={dt:.1f}s total={(time.time() - t_start) / 60:.1f}min | "
                f"train_loss={tr['loss']:.4f} val_loss={val['loss']:.4f} | "
                f"train_f1={tr['f1_overall_1sec']:.3f} val_f1={val['f1_overall_1sec']:.3f} | "
                f"val_ER={val_er:.3f}"
            )
        stop = (no_imp > tcfg.early_stop_patience if tcfg.early_stop_strict_greater
                else no_imp >= tcfg.early_stop_patience)
        if writer:
            artifacts.append_jsonl(jsonl_path, {
                "fold": fold_id,
                "epoch": epoch,
                "epoch_sec": round(dt, 3),
                "audio_hours_per_sec": round(audio_sec / 3600.0 / dt, 4),
                "train": tr,
                "val": val,
                "lr_scale": state.lr_scale,
            })

            meta: Dict[str, Any] = {
                "epoch": epoch,
                "fold": fold_id,
                "best_er": best_er,
                "best_f1": best_f1,
                "best_epoch": best_epoch,
                "no_imp": no_imp,
                "key_seed": seed + fold_id + epoch * 10007,
                "history": history,
            }
            if plateau_state is not None:
                meta["plateau"] = plateau_state._asdict()
            tree = {**checkpoint_tree(trainer, state), **rng_entries}
            if improved:
                ckpt_io.save_checkpoint(best_ckpt_path, tree, meta)
            if tcfg.checkpoint_policy == "all":
                ckpt_io.save_checkpoint(
                    os.path.join(art_dir,
                                 f"epoch{epoch:03d}-valer{val_er:.3f}_fold{fold_id}.npz"),
                    tree, meta)
            ckpt_io.save_checkpoint(os.path.join(art_dir, f"last_fold{fold_id}.npz"), tree, meta)

            if tcfg.plot_every and epoch % tcfg.plot_every == 0:
                artifacts.save_loss_curve(os.path.join(art_dir, f"loss_fold{fold_id}.png"),
                                          history["loss_tr"], history["loss_val"])
                artifacts.save_metrics_panel(
                    os.path.join(art_dir, f"metrics_fold{fold_id}.png"), history,
                    train_cm=[[tr["tn"], tr["fp"]], [tr["fn"], tr["tp"]]],
                    val_cm=[[val["tn"], val["fp"]], [val["fn"], val["tp"]]],
                    epoch=epoch,
                )
        if stop:
            break

    trainer.barrier()  # the writer's last checkpoint is on disk for every rank
    if verbose:
        print(f"fold {fold_id} best ER={best_er:.3f} @ epoch={best_epoch}")
    return FoldResult(
        fold_id=fold_id,
        best_er=best_er,
        best_f1=best_f1,
        best_epoch=best_epoch,
        epochs_run=epochs_run,
        history=history,
        best_checkpoint=best_ckpt_path if os.path.exists(best_ckpt_path) else None,
    ), writer


def run_experiment(
    cfg: ExperimentConfig,
    folds: Dict[int, Dict[str, np.ndarray]],
    art_dir: str,
    verbose: bool = True,
    device=None,
    trainer_factory=None,
) -> Dict[str, Any]:
    """K-fold driver: trains every fold, reports per-fold best ER and the
    cross-fold mean, and appends them to ``experiment.jsonl`` (the writer
    rank's, under a data-parallel ``trainer_factory``)."""
    runs = [
        _run_fold(cfg, fold_data, fold_id, os.path.join(art_dir, f"fold{fold_id}"), None, None,
                  verbose, device, trainer_factory)
        for fold_id, fold_data in sorted(folds.items())
    ]
    results = [r for r, _ in runs]
    writer = all(w for _, w in runs)
    mean_er = float(np.mean([r.best_er for r in results]))
    mean_f1 = float(np.mean([r.best_f1 for r in results]))
    if verbose and writer:
        print(f"average ER across folds: {mean_er:.3f} (F1 {mean_f1:.3f})")
    if writer:
        artifacts.append_jsonl(os.path.join(art_dir, "experiment.jsonl"), {
            "experiment": cfg.name,
            "mean_er": mean_er,
            "mean_f1": mean_f1,
            "folds": {str(r.fold_id): {"best_er": r.best_er, "best_epoch": r.best_epoch}
                      for r in results},
        })
    return {"mean_er": mean_er, "mean_f1": mean_f1, "folds": results}
