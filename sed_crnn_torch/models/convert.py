"""Carry weights between the JAX package's parameter trees and `CRNN`.

`from_jax` takes the ``params`` and ``model_state`` trees as numpy arrays,
exactly as `core/checkpoint.py` stores them, and returns a ``state_dict``
for the port's `CRNN` (`load_model` builds the model from one); `to_jax` is
its inverse:

* conv ``w`` HWIO <-> ``weight`` OIHW, ``b`` <-> ``bias``;
* BatchNorm ``scale``/``bias`` <-> ``weight``/``bias``, state
  ``mean``/``var`` <-> ``running_mean``/``running_var``;
* GRU ``wi``/``wh``/``bi``/``bh`` keep their layout and names;
* dense ``w`` (in, out) <-> ``weight`` (out, in), ``b`` <-> ``bias``.

Both also take any params-shaped tree without a ``model_state`` (pass
``state=None``; `to_jax` then returns ``state`` None), which is how Adam's
``mu``/``nu`` travel: `opt_state_from_jax` and `opt_state_to_jax` convert the
JAX checkpoint's ``opt_state{step, mu, nu}``, so a checkpoint written by the
port's training loop resumes in the JAX package and the reverse.

The flatten order needs no permutation of the first GRU's ``wi``: the port
flattens the trunk output in the JAX order [B, T, C, F] (`models/crnn.py`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sed_crnn_torch.core.config import ModelConfig
from sed_crnn_torch.models import get_model
from sed_crnn_torch.models.crnn import CRNN

_GRU_KEYS = ("wi", "wh", "bi", "bh")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def from_jax(params: Mapping, state: Optional[Mapping],
             model_cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    n_blocks = len(model_cfg.conv_channels)
    if len(params["conv"]) != n_blocks or len(params["gru"]) != len(model_cfg.gru_hidden):
        raise ValueError("parameter tree does not match the model configuration")
    sd: Dict[str, torch.Tensor] = {}
    for i, (conv, bn) in enumerate(zip(params["conv"], params["bn"])):
        sd[f"conv.{i}.weight"] = _t(np.transpose(conv["w"], (3, 2, 0, 1)))
        sd[f"conv.{i}.bias"] = _t(conv["b"])
        sd[f"bn.{i}.weight"] = _t(bn["scale"])
        sd[f"bn.{i}.bias"] = _t(bn["bias"])
        if state is not None:
            sd[f"bn.{i}.running_mean"] = _t(state["bn"][i]["mean"])
            sd[f"bn.{i}.running_var"] = _t(state["bn"][i]["var"])
    for i, bigru in enumerate(params["gru"]):
        for d in ("fwd", "bwd"):
            for k, v in bigru[d].items():
                sd[f"gru.{i}.{d}.{k}"] = _t(v)
    for i, dense in enumerate(params["head"]):
        sd[f"head.{i}.weight"] = _t(np.transpose(dense["w"]))
        sd[f"head.{i}.bias"] = _t(dense["b"])
    return sd


def load_model(tree: Mapping, model_cfg: ModelConfig, device) -> CRNN:
    """A `CRNN` on ``device`` holding the weights of a JAX checkpoint tree
    (``{"params", "model_state"}``), in eval mode."""
    model = get_model(model_cfg)
    model.load_state_dict(from_jax(tree["params"], tree["model_state"], model_cfg))
    return model.to(device)


def to_jax(sd: Mapping[str, torch.Tensor],
           model_cfg: ModelConfig) -> Tuple[Dict, Optional[Dict]]:
    """A port ``state_dict`` (or a params-shaped dict such as Adam's moments)
    -> ``(params, model_state)`` numpy trees in the JAX layout; ``model_state``
    is None when ``sd`` holds no BatchNorm running statistics."""
    n_blocks = len(model_cfg.conv_channels)
    params: Dict = {"conv": [], "bn": [], "gru": [], "head": []}
    for i in range(n_blocks):
        params["conv"].append({"w": np.transpose(_np(sd[f"conv.{i}.weight"]), (2, 3, 1, 0)),
                               "b": _np(sd[f"conv.{i}.bias"])})
        params["bn"].append({"scale": _np(sd[f"bn.{i}.weight"]),
                             "bias": _np(sd[f"bn.{i}.bias"])})
    for i in range(len(model_cfg.gru_hidden)):
        params["gru"].append({
            d: {k: _np(sd[f"gru.{i}.{d}.{k}"]) for k in _GRU_KEYS if f"gru.{i}.{d}.{k}" in sd}
            for d in ("fwd", "bwd")
        })
    for i in range(len(model_cfg.head_dims)):
        params["head"].append({"w": np.transpose(_np(sd[f"head.{i}.weight"])),
                               "b": _np(sd[f"head.{i}.bias"])})
    if "bn.0.running_mean" not in sd:
        return params, None
    state = {"bn": [{"mean": _np(sd[f"bn.{i}.running_mean"]),
                     "var": _np(sd[f"bn.{i}.running_var"])} for i in range(n_blocks)]}
    return params, state


def opt_state_from_jax(opt_state: Mapping, model_cfg: ModelConfig) -> Dict:
    """A JAX checkpoint's ``opt_state{step, mu, nu}`` -> ``{"step": int,
    "mu": {name: tensor}, "nu": {name: tensor}}`` keyed like the model's
    parameters (`train/optim.py`'s `AdamState` fields)."""
    return {
        "step": int(np.asarray(opt_state["step"])),
        "mu": from_jax(opt_state["mu"], None, model_cfg),
        "nu": from_jax(opt_state["nu"], None, model_cfg),
    }


def opt_state_to_jax(step: int, mu: Mapping[str, torch.Tensor],
                     nu: Mapping[str, torch.Tensor], model_cfg: ModelConfig) -> Dict:
    """The inverse of `opt_state_from_jax`: ``step`` as an int32 scalar and
    the moments as params-shaped JAX trees."""
    return {
        "step": np.asarray(step, np.int32),
        "mu": to_jax(mu, model_cfg)[0],
        "nu": to_jax(nu, model_cfg)[0],
    }
