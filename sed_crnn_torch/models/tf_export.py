"""TensorFlow SavedModel export of the windowed forward.

Counterpart of the JAX package's `models/export.py::export_tf_savedmodel`,
which converts its forward with jax2tf. The port builds the same function
as a `tf.Module` straight from the numpy weight tree in the JAX checkpoint
layout (no ONNX route): SAME 3x3 convolutions, BatchNorm with the running
statistics, ReLU and max pooling over the pooled axis in NHWC (the JAX
package's own layout, which TF's CPU ``Conv2D`` requires), the flatten in
the JAX order [B, T, C, F], the BiGRUs as a `tf.scan` over T in either
convention (``reset_after`` False for SEDnet) with sigmoid or keras-2.2
hard_sigmoid gates, and the dense head. A reduced-precision trunk
(``compute_dtype="bfloat16"``) is computed in float32 and rounded to its
dtype where the port's trunk rounds (`models/crnn.py`): the input, the
convolution weights and each block's output after BatchNorm.

``tensorflow`` is imported inside `export_tf_savedmodel` only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from sed_crnn_torch.core.config import ExperimentConfig, ModelConfig


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32)
    return np.asarray(a, np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _forward_module(tf, mcfg: ModelConfig, members, norm):
    """A `tf.Module` whose ``f`` maps (b, T, F*C) float32 windows to
    (b, T_out, K) probabilities: the float32 mean of the members' sigmoids
    (one member: its sigmoid)."""
    trunk_dtype = tf.as_dtype(mcfg.compute_dtype)
    reset_after = mcfg.name != "sednet"   # the legacy keras SEDnet convention
    t_in, feat = mcfg.seq_len_in, mcfg.n_mels * mcfg.in_channels

    def round_trunk(x):
        return x if trunk_dtype == tf.float32 else tf.cast(tf.cast(x, trunk_dtype), tf.float32)

    def gate(v):
        if mcfg.gru_gate_activation == "hard_sigmoid":
            return tf.clip_by_value(0.2 * v + 0.5, 0.0, 1.0)
        return tf.sigmoid(v)

    def gru(x, w, reverse):
        """One direction over time-major xp -> outputs (T, b, H)."""
        wh = w["wh"]
        H = wh.shape[0]
        xp = tf.transpose(tf.einsum("bti,ig->btg", x, w["wi"]) + w["bi"], (1, 0, 2))
        h0 = tf.zeros(tf.stack([tf.shape(x)[0], H]), tf.float32)

        def step(h, xt):
            xr, xz, xn = xt[:, :H], xt[:, H : 2 * H], xt[:, 2 * H :]
            if reset_after:
                hp = tf.matmul(h, wh) + w["bh"]
                r = gate(xr + hp[:, :H])
                z = gate(xz + hp[:, H : 2 * H])
                n = tf.tanh(xn + r * hp[:, 2 * H :])
            else:
                r = gate(xr + tf.matmul(h, wh[:, :H]))
                z = gate(xz + tf.matmul(h, wh[:, H : 2 * H]))
                n = tf.tanh(xn + tf.matmul(r * h, wh[:, 2 * H :]))
            return (1.0 - z) * n + z * h

        return tf.scan(step, xp, initializer=h0, reverse=reverse)

    act = {"none": lambda v: v, "relu": tf.nn.relu, "tanh": tf.tanh}[mcfg.head_activation]

    def one(x, p, s):
        """Logits of one member, x normalized (b, T, F*C)."""
        x = round_trunk(x)
        b = tf.shape(x)[0]
        x = tf.transpose(tf.reshape(x, tf.stack([b, t_in, mcfg.in_channels, mcfg.n_mels])),
                         (0, 2, 1, 3))                                      # (b, C, T, F)
        x = tf.transpose(x, (0, 3, 2, 1) if mcfg.pool_axis == "time" else (0, 2, 3, 1))
        for conv, bn, st, pool in zip(p["conv"], p["bn"], s["bn"], mcfg.pool):
            x = tf.nn.conv2d(x, round_trunk(conv["w"]), strides=1, padding="SAME") + conv["b"]
            inv = tf.math.rsqrt(st["var"] + mcfg.bn_eps) * bn["scale"]
            x = round_trunk((x - st["mean"]) * inv + bn["bias"])
            x = tf.nn.max_pool2d(tf.nn.relu(x), (1, pool), (1, pool), "VALID")
        # NHWC -> (b, T_out, C, F) -> (b, T_out, C*F), the JAX flatten order
        x = tf.transpose(x, (0, 2, 3, 1) if mcfg.pool_axis == "time" else (0, 1, 3, 2))
        x = tf.reshape(x, tf.stack([b, mcfg.seq_len_out, -1]))
        for layer in p["gru"]:
            yf = gru(x, layer["fwd"], reverse=False)
            yb = gru(x, layer["bwd"], reverse=True)
            x = tf.transpose(tf.concat([yf, yb], -1), (1, 0, 2))
        for i, dense in enumerate(p["head"]):
            x = tf.einsum("bti,io->bto", x, dense["w"]) + dense["b"]
            if i < len(p["head"]) - 1:
                x = act(x)
        return x

    class Forward(tf.Module):
        def __init__(self):
            super().__init__()
            # Weights as non-trainable variables, so the SavedModel stores them
            # once as checkpointed values rather than as graph constants.
            self.members = _map(lambda a: tf.Variable(a, trainable=False), members)
            self.norm = None if norm is None else [tf.Variable(a.reshape(1, 1, feat),
                                                               trainable=False) for a in norm]

        @tf.function(input_signature=[tf.TensorSpec([None, t_in, feat], tf.float32)],
                     autograph=False)
        def f(self, x):
            if self.norm is not None:
                x = (x - self.norm[0]) / self.norm[1]
            probs = [tf.sigmoid(one(x, p, s)) for p, s in self.members]
            return probs[0] if len(probs) == 1 else tf.reduce_mean(tf.stack(probs), 0)

    return Forward()


def export_tf_savedmodel(
    cfg: ExperimentConfig,
    params: Any,
    state: Any,
    out_dir: str,
    norm_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    compute_dtype: Optional[str] = None,
    ensemble_members: int = 0,
) -> str:
    """Export the windowed forward as a TensorFlow SavedModel in ``out_dir``.

    For users deploying behind TF Serving / TFX: the single signature
    ``serving_default`` maps windows (None, T, F*C) float32 -> probabilities
    (None, T_out, K), the batch dimension free, weights and the fold's
    normalization statistics (``norm_stats`` = (mean, scale), folded in)
    baked in. ``compute_dtype`` overrides the trunk's activation dtype.
    ``ensemble_members`` > 0: params / state carry a leading member axis
    (`models/export.py::stack_trees`) and the model serves the float32 mean
    of the members' sigmoids. Streaming state is not exported (use the
    serving artifact for streaming). Returns ``out_dir``."""
    mcfg = cfg.model
    if compute_dtype is not None:
        mcfg = dataclasses.replace(mcfg, compute_dtype=compute_dtype)
    tree = _map(_np, {"params": params, "model_state": state})
    leaves = []
    _map(leaves.append, tree)
    if ensemble_members > 0 and any(a.shape[:1] != (ensemble_members,) for a in leaves):
        raise ValueError(f"ensemble_members={ensemble_members}: every weight needs a leading "
                         f"member axis of {ensemble_members} (models/export.py::stack_trees)")
    import tensorflow as tf  # deferred: only this format needs it

    if ensemble_members > 0:
        members = [_map(lambda a: a[i], (tree["params"], tree["model_state"]))
                   for i in range(ensemble_members)]
    else:
        members = [(tree["params"], tree["model_state"])]
    norm = None if norm_stats is None else tuple(_np(a) for a in norm_stats)
    module = _forward_module(tf, mcfg, members, norm)
    tf.saved_model.save(module, out_dir, signatures={"serving_default": module.f})
    return out_dir
