"""Serving export: a trained checkpoint -> one self-contained serving artifact.

Counterpart of the JAX package's `models/export.py`, with its programs under
the same names and semantics, as methods of `ServingArtifact`:

  forward(windows)      (b, T, F*C) float32 -> probabilities (b, T_out, K),
                        any b;
  stream_init()         the zero carry: one {"fwd", "bwd"} dict per BiGRU,
                        (1, H) per leaf; (n_members, 1, H) for an ensemble;
  stream_step(carry, chunk)
                        one chunk of a long recording -> (new_carry,
                        probabilities (T_out, K)); the forward-GRU state
                        carries across chunks, the backward state restarts
                        from zero in every chunk (`models/streaming.py`);
  stream_init_batch(b), stream_step_batch(carry, chunks)
                        b concurrent streams, one chunk each: every carry
                        leaf gains a leading batch axis, and the b chunks run
                        as one batch (kernel B sees b rows);
  stream_step_lookahead(carry, pair)
                        [chunk_k, chunk_k+1] -> chunk k's probabilities; the
                        forward carry for the next pair is read out of the
                        pair pass at the chunk boundary (``carry_at``);
  stream(mel, lookahead=False)
                        the host loop over a recording's chunks, trimmed to
                        the true length.

The fold's normalization statistics are folded in (callers feed raw log-mel
features), and an ensemble (``ensemble_members`` > 0) carries one state per
member and averages the members' sigmoids in float32. The programs run on
the artifact's device: on the card every GRU runs kernel B, on the CPU its
plain version.

Format ``"sed_crnn_torch.serving/1"``, one zip holding

  meta.json    the JAX artifact's metadata schema, every key, with this
               package's config values (backend names of `core/config.py`);
  weights.npz  the checkpoint tree ``{"params", "model_state"}`` under the
               JAX checkpoint's flattened keys (`core/checkpoint.py`),
               stacked on a leading member axis for an ensemble;
  norm.npz     the folded ``mean`` and ``scale``, when there are any.

The model is rebuilt from the weights at load time (`models/convert.py`).
A traced program would not make the artifact independent of this package:
one that calls the kernels through custom operators needs the package
imported to load, and it ties the artifact to one torch version. A JAX
artifact (``"sed_crnn_tpu.serving/1"``, StableHLO programs) is refused.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sed_crnn_torch.core.checkpoint import _flatten, _unflatten
from sed_crnn_torch.core.config import ExperimentConfig, ModelConfig
from sed_crnn_torch.core.device import resolve_device
from sed_crnn_torch.models.convert import load_model

FORMAT = "sed_crnn_torch.serving/1"
JAX_FORMAT = "sed_crnn_tpu.serving/1"
PLATFORMS = ("cuda", "cpu")

Carry = List[Dict[str, torch.Tensor]]
_DIRS = ("fwd", "bwd")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def stack_trees(trees: Sequence[Any]) -> Any:
    """N trees of one structure -> one tree whose leaves stack the N leaves
    on a new leading (member) axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees([t[i] for t in trees]) for i in range(len(first)))
    return np.stack([np.asarray(t) for t in trees])


def _model_config(meta: Dict[str, Any]) -> ModelConfig:
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in meta["model"].items()})


def _threshold_meta(default_threshold, n_classes: int):
    """One float, or one value per class, as the metadata records it."""
    if default_threshold is None:
        return None
    if np.ndim(default_threshold) == 0:
        return float(default_threshold)
    arr = np.asarray(default_threshold, np.float64)
    if arr.shape != (n_classes,):
        raise ValueError(
            f"{arr.size} default thresholds for {n_classes} classes — pass one "
            f"value or exactly one per class"
        )
    return [float(v) for v in arr]


class ServingArtifact:
    """The serving programs of one model or ensemble on one device.

    ``tree`` is ``{"params", "model_state"}`` in the JAX layout (numpy
    leaves, stacked on a leading member axis when ``meta["ensemble_members"]``
    > 0), ``norm_stats`` the folded ``(mean, scale)`` or None. ``device``:
    None means ``cuda``."""

    def __init__(self, meta: Dict[str, Any], tree: Dict[str, Any],
                 norm_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None, device=None):
        self.meta = meta
        self.tree = tree
        self.norm_stats = norm_stats
        self.device = resolve_device(device)
        mcfg = _model_config(meta)
        n_members = int(meta["ensemble_members"])
        members = ([_map(lambda a, m=m: a[m], tree) for m in range(n_members)]
                   if n_members else [tree])
        self.models = [load_model(t, mcfg, self.device) for t in members]
        self._ensemble = n_members > 0
        self._hidden = tuple(mcfg.gru_hidden)
        self._t_chunk = self.models[0].seq_len_out   # GRU steps per chunk
        feat = mcfg.n_mels * mcfg.in_channels
        self._norm = None if norm_stats is None else tuple(
            torch.as_tensor(np.asarray(s, np.float32).reshape(1, 1, feat), device=self.device)
            for s in norm_stats)

    # -- programs -------------------------------------------------------------
    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _run(self, x: torch.Tensor, states, carry_at: Optional[int] = None):
        """Every member on ``x (b, T, F*C)`` (normalized here) from its
        states -> (probabilities averaged over the members, each member's
        new carry)."""
        if self._norm is not None:
            x = (x - self._norm[0]) / self._norm[1]
        probs, carries = [], []
        with torch.no_grad():
            for model, st in zip(self.models, states):
                logits, carry = model(x, rnn_carry=st, carry_at=carry_at)
                probs.append(torch.sigmoid(logits))
                carries.append(carry)
        return (torch.stack(probs).mean(0) if self._ensemble else probs[0]), carries

    def _states(self, carry: Carry, batched: bool):
        """Carry leaves -> each member's states, (rows, H) per leaf."""
        def member(a, m):
            a = self._tensor(a)
            if self._ensemble:
                a = a[:, m] if batched else a[m]
            return a.reshape(-1, a.shape[-1])

        return [[{d: member(c[d], m) for d in _DIRS} for c in carry]
                for m in range(len(self.models))]

    def _carry(self, carries, batched: bool) -> Carry:
        """Each member's forward states -> carry leaves (the JAX shapes),
        the backward state zero."""
        out = []
        for i in range(len(self._hidden)):
            fwd = [c[i]["fwd"][:, None] if batched else c[i]["fwd"] for c in carries]
            leaf = torch.stack(fwd, dim=1 if batched else 0) if self._ensemble else fwd[0]
            out.append({"fwd": leaf, "bwd": torch.zeros_like(leaf)})
        return out

    def forward(self, windows) -> torch.Tensor:
        """(b, T, F*C) float32 windows -> (b, T_out, K) sigmoid probabilities."""
        return self._run(self._tensor(windows), [None] * len(self.models))[0]

    def stream_init(self) -> Carry:
        lead = (len(self.models), 1) if self._ensemble else (1,)
        return [{d: torch.zeros((*lead, h), device=self.device) for d in _DIRS}
                for h in self._hidden]

    def stream_init_batch(self, batch: int) -> Carry:
        """Zero carry for ``batch`` concurrent streams (leading axis)."""
        return [{d: torch.zeros((batch, *a.shape), device=self.device) for d, a in c.items()}
                for c in self.stream_init()]

    def stream_step(self, carry: Carry, chunk) -> Tuple[Carry, torch.Tensor]:
        probs, carries = self._run(self._tensor(chunk)[None], self._states(carry, False))
        return self._carry(carries, False), probs[0]

    def stream_step_batch(self, carry: Carry, chunks) -> Tuple[Carry, torch.Tensor]:
        """One chunk from each of b concurrent streams: carry leaves with a
        leading batch axis, ``chunks (b, T, F*C)`` -> (new_carry, probabilities
        (b, T_out, K))."""
        probs, carries = self._run(self._tensor(chunks), self._states(carry, True))
        return self._carry(carries, True), probs

    def stream_step_lookahead(self, carry: Carry, chunk_pair) -> Tuple[Carry, torch.Tensor]:
        """Pair step ([chunk_k, chunk_k+1], 2T frames): chunk k's probabilities
        with one chunk of real right context; the returned carry is the
        forward state at the chunk boundary (one chunk of latency)."""
        probs, carries = self._run(self._tensor(chunk_pair)[None], self._states(carry, False),
                                   carry_at=self._t_chunk - 1)
        return self._carry(carries, False), probs[0, : self._t_chunk]

    def stream(self, mel, lookahead: bool = False) -> np.ndarray:
        """Host loop over chunks: (frames, F*C) -> (out_frames, K) numpy
        probabilities, trimmed to the true length. ``lookahead=True`` runs the
        pair steps."""
        chunk = int(self.meta["seq_len_in"])
        mel = self._tensor(mel)
        n = mel.shape[0]
        n_chunks = -(-n // chunk)
        mel = torch.nn.functional.pad(mel, (0, 0, 0, n_chunks * chunk - n))
        carry, outs = self.stream_init(), [mel.new_zeros((0, int(self.meta["n_classes"])))]
        for k in range(n_chunks):
            cur = mel[k * chunk:(k + 1) * chunk]
            if lookahead:
                nxt = mel[(k + 1) * chunk:(k + 2) * chunk] if k + 1 < n_chunks else torch.zeros_like(cur)
                carry, probs = self.stream_step_lookahead(carry, torch.cat([cur, nxt]))
            else:
                carry, probs = self.stream_step(carry, cur)
            outs.append(probs)
        pool = chunk // int(self.meta["seq_len_out"])
        return torch.cat(outs)[: n // pool].cpu().numpy()

    # -- persistence ----------------------------------------------------------
    def save(self, path: str) -> None:
        with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("meta.json", json.dumps(self.meta, indent=1))
            buf = io.BytesIO()
            np.savez(buf, **_flatten(self.tree))
            zf.writestr("weights.npz", buf.getvalue())
            if self.norm_stats is not None:
                buf = io.BytesIO()
                np.savez(buf, mean=self.norm_stats[0], scale=self.norm_stats[1])
                zf.writestr("norm.npz", buf.getvalue())

    @classmethod
    def load(cls, path: str, device=None) -> "ServingArtifact":
        """Read an artifact that `save` wrote; its programs run on ``device``
        (None means ``cuda``)."""
        try:
            zf = zipfile.ZipFile(path, "r")
        except (zipfile.BadZipFile, IsADirectoryError) as e:
            raise ValueError(
                f"{path}: not a serving artifact ({e}); expected the zip container "
                f"written by ServingArtifact.save / sed_crnn_torch.apps.export"
            ) from e
        with zf:
            try:
                meta = json.loads(zf.read("meta.json").decode("utf-8"))
            except KeyError as e:
                raise ValueError(f"{path}: not a serving artifact (no meta.json)") from e
            if meta.get("format") == JAX_FORMAT:
                raise ValueError(
                    f"{path}: a JAX serving artifact ({JAX_FORMAT}); its programs are "
                    f"StableHLO, which this package cannot run. Re-export the checkpoint "
                    f"with `python -m sed_crnn_torch.apps.export`"
                )
            if meta.get("format") != FORMAT:
                raise ValueError(f"{path}: not a {FORMAT} artifact "
                                 f"(format={meta.get('format')!r})")
            with np.load(io.BytesIO(zf.read("weights.npz"))) as data:
                tree = _unflatten({k: data[k] for k in data.files})
            norm = None
            if meta["norm_folded"]:
                with np.load(io.BytesIO(zf.read("norm.npz"))) as data:
                    norm = (data["mean"], data["scale"])
        return cls(meta, tree, norm, device)


def export_serving(
    cfg: ExperimentConfig,
    params,
    state,
    norm_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    preset: Optional[str] = None,
    compute_dtype: Optional[str] = None,
    ensemble_members: int = 0,
    default_threshold=None,
    device=None,
) -> ServingArtifact:
    """The serving artifact of a trained model, on ``device`` (None means
    ``cuda``).

    ``params``/``state``: the JAX-layout trees of a checkpoint; with
    ``ensemble_members`` > 0, N checkpoints stacked on a leading member axis
    (`stack_trees`). ``norm_stats`` = (mean, scale) over the F*C feature
    axis, the fold's train-split statistics, folded into the programs.
    ``compute_dtype`` overrides the model's conv-trunk dtype.
    ``default_threshold``: one float, or one value per class, recorded in the
    metadata and used by `apps/infer.py --artifact` and `apps/serve.py` when
    the caller gives none."""
    mcfg = cfg.model
    if compute_dtype is not None:
        mcfg = dataclasses.replace(mcfg, compute_dtype=compute_dtype)
    tree = _map(np.asarray, {"params": params, "model_state": state})
    norm = None if norm_stats is None else tuple(np.asarray(s, np.float32) for s in norm_stats)
    meta = {
        "format": FORMAT,
        "preset": preset,
        "platforms": list(PLATFORMS),
        "seq_len_in": mcfg.seq_len_in,
        "seq_len_out": mcfg.seq_len_out,
        "n_classes": mcfg.n_classes,
        "n_mels": mcfg.n_mels,
        "in_channels": mcfg.in_channels,
        "sample_rate": cfg.frontend.sample_rate,
        "hop_length": cfg.frontend.hop_length,
        "norm_folded": norm is not None,
        "ensemble_members": ensemble_members,
        "default_threshold": _threshold_meta(default_threshold, mcfg.n_classes),
        # The frontend parameters, so that a serving host extracts features
        # with no other configuration (`apps/infer.py --artifact`).
        "frontend": dataclasses.asdict(cfg.frontend),
        "model": {k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in dataclasses.asdict(mcfg).items()},
    }
    return ServingArtifact(meta, tree, norm, device)


def export_tf_savedmodel(*args, **kwargs):
    """Not ported: the JAX package writes the TF SavedModel through jax2tf."""
    raise NotImplementedError(
        "export_tf_savedmodel is not ported to sed_crnn_torch (the JAX package converts "
        "its programs with jax2tf); see ROADMAP.md Queue 1, 'TF SavedModel export'"
    )
