"""timepooled-v2's bf16 conv trunk: the port's distance from its own float32
forward against the JAX package's distance from its float32 forward, on the
same weights and inputs.

The band: for each weight seed and mode, max |logits_bf16 - logits_f32| of
the port is at most 1.25 x the JAX package's (jitted, as it trains and
serves). Full width, batch 32, weights from `chip_smoke.model_tree` (numpy
seeds 0-2, carried across by `models/convert.py`), inputs from numpy seed
100 + seed; eval mode (running statistics) and a train-mode forward with
dropout 0 (batch statistics). `chip_smoke.py` holds the card's bf16 forward
to the same band with the JAX distances recorded in `BF16_JAX_DIST`, which
this file checks against JAX. The serving artifact exported with
``compute_dtype="bfloat16"`` runs the same trunk and meets the band on
probabilities.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from sed_crnn_tpu.core import config as jcfg_mod
from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.nn.layers import Ctx

from sed_crnn_torch.core import config as tcfg_mod
from sed_crnn_torch.models import get_model
from sed_crnn_torch.models.convert import from_jax
from sed_crnn_torch.models.export import export_serving

BAND = 1.25


def _cfgs(dtype):
    jc = jcfg_mod.get_preset("timepooled-v2").model
    tc = tcfg_mod.get_preset("timepooled-v2").model
    over = dict(compute_dtype=dtype, dropout=0.0)
    return dataclasses.replace(jc, gru_backend="xla", **over), dataclasses.replace(tc, **over)


_JAX_APPLY = {}


def _jax_logits(dtype, train, params, state, x):
    if (dtype, train) not in _JAX_APPLY:
        jm = jax_get_model(_cfgs(dtype)[0])
        _JAX_APPLY[dtype, train] = jax.jit(
            lambda p, s, x: jm.apply(p, s, x, Ctx(train=train))[0])
    return np.asarray(_JAX_APPLY[dtype, train](params, state, x))


def _port_logits(dtype, train, params, state, x):
    tc = _cfgs(dtype)[1]
    model = get_model(tc)
    model.load_state_dict(from_jax(params, state, tc))
    with torch.no_grad():
        return model.train(train)(torch.from_numpy(x))[0].numpy()


def _case(seed):
    params, state = chip_smoke.model_tree(_cfgs("float32")[1], seed)
    return params, state, chip_smoke.bf16_input(seed)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_trunk_within_band_of_jax(seed, train):
    params, state, x = _case(seed)
    jax_dist = float(np.abs(_jax_logits("bfloat16", train, params, state, x)
                            - _jax_logits("float32", train, params, state, x)).max())
    ref = _port_logits("float32", train, params, state, x)
    port_dist = float(np.abs(_port_logits("bfloat16", train, params, state, x) - ref).max())
    assert 0.0 < port_dist <= BAND * jax_dist, (port_dist, jax_dist)
    # the card's check in chip_smoke.py reads this distance from its table
    np.testing.assert_allclose(chip_smoke.BF16_JAX_DIST[seed, train], jax_dist, rtol=1e-3)
    assert chip_smoke.BF16_BAND == BAND


def test_bf16_serving_artifact_within_band():
    params, state, x = _case(0)
    cfg = tcfg_mod.get_preset("timepooled-v2")
    art = export_serving(cfg, params, state, compute_dtype="bfloat16", device="cpu")
    got = art.forward(x).numpy()
    want = 1.0 / (1.0 + np.exp(-_port_logits("float32", False, params, state, x)))
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    jax_dist = np.abs(sig(_jax_logits("bfloat16", False, params, state, x))
                      - sig(_jax_logits("float32", False, params, state, x))).max()
    assert np.abs(got - want).max() <= BAND * jax_dist
