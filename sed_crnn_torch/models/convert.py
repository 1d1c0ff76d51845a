"""Carry weights from the JAX package's parameter tree into `CRNN`.

`from_jax` takes the ``params`` and ``model_state`` trees as numpy arrays,
exactly as `core/checkpoint.py` stores them, and returns a ``state_dict``
for the port's `CRNN`:

* conv ``w`` HWIO -> ``weight`` OIHW, ``b`` -> ``bias``;
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, state
  ``mean``/``var`` -> ``running_mean``/``running_var``;
* GRU ``wi``/``wh``/``bi``/``bh`` keep their layout and names;
* dense ``w`` (in, out) -> ``weight`` (out, in), ``b`` -> ``bias``.

The flatten order needs no permutation of the first GRU's ``wi``: the port
flattens the trunk output in the JAX order [B, T, C, F] (`models/crnn.py`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from sed_crnn_torch.core.config import ModelConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_jax(params: Mapping, state: Mapping, model_cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    n_blocks = len(model_cfg.conv_channels)
    if len(params["conv"]) != n_blocks or len(params["gru"]) != len(model_cfg.gru_hidden):
        raise ValueError("parameter tree does not match the model configuration")
    sd: Dict[str, torch.Tensor] = {}
    for i, (conv, bn, bn_s) in enumerate(zip(params["conv"], params["bn"], state["bn"])):
        sd[f"conv.{i}.weight"] = _t(np.transpose(conv["w"], (3, 2, 0, 1)))
        sd[f"conv.{i}.bias"] = _t(conv["b"])
        sd[f"bn.{i}.weight"] = _t(bn["scale"])
        sd[f"bn.{i}.bias"] = _t(bn["bias"])
        sd[f"bn.{i}.running_mean"] = _t(bn_s["mean"])
        sd[f"bn.{i}.running_var"] = _t(bn_s["var"])
    for i, bigru in enumerate(params["gru"]):
        for d in ("fwd", "bwd"):
            for k, v in bigru[d].items():
                sd[f"gru.{i}.{d}.{k}"] = _t(v)
    for i, dense in enumerate(params["head"]):
        sd[f"head.{i}.weight"] = _t(np.transpose(dense["w"]))
        sd[f"head.{i}.bias"] = _t(dense["b"])
    return sd
