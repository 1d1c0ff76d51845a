"""The port's CRNN (sed_crnn_torch/models/crnn.py) against the JAX CRNN on the
same weights: JAX parameter trees filled from a numpy seed, carried across by
`models/convert.py::from_jax`, and an eval forward on the same seeded input.

Narrowed configurations keep each preset's name, pools and layout (fewer
conv channels, GRU width 8) so the CPU forward stays small. Tolerance: 2e-5
absolute on logits of order 1, room for float32 reassociation between the
two frameworks' CPU convolutions and matrix products.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sed_crnn_tpu.core import config as jcfg_mod
from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.nn.layers import Ctx

from sed_crnn_torch.core import config as tcfg_mod
from sed_crnn_torch.models import count_params, get_model, model_flops_per_example
from sed_crnn_torch.models.convert import from_jax

ATOL = 2e-5
_GRU_BACKEND_TO_PORT = {"xla": "auto", "pallas": "auto", "auto": "auto"}


def narrowed(preset: str, **model_overrides):
    """(JAX ExperimentConfig, port ExperimentConfig) of a preset with its
    widths cut, the JAX side on the XLA GRU scan."""
    fields = dict(conv_channels=(8, 8, 8), gru_hidden=(8, 8), **model_overrides)
    if preset.startswith("sednet"):
        fields["head_dims"] = (4, model_overrides.get("n_classes", 6))
    j = jcfg_mod.get_preset(preset)
    j = j.replace(model=dataclasses.replace(j.model, gru_backend="xla", **fields))
    t = tcfg_mod.get_preset(preset)
    t = t.replace(model=dataclasses.replace(t.model, **fields))
    return j, t


def port_config_of(jax_cfg):
    """The port's ExperimentConfig with every field of a JAX one."""
    fe = dict(dataclasses.asdict(jax_cfg.frontend))
    if fe["backend"] == "pallas":
        fe["backend"] = "kernel"
    mo = dict(dataclasses.asdict(jax_cfg.model))
    mo["gru_backend"] = _GRU_BACKEND_TO_PORT[mo["gru_backend"]]
    return tcfg_mod.ExperimentConfig(
        name=jax_cfg.name,
        frontend=tcfg_mod.FrontendConfig(**fe),
        model=tcfg_mod.ModelConfig(**mo),
        train=tcfg_mod.TrainConfig(**dataclasses.asdict(jax_cfg.train)),
    )


def seeded_tree(jax_model, seed: int):
    """JAX (params, state) with every leaf drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    params, state = jax_model.init(jax.random.PRNGKey(0))

    def draw(a, scale):
        return (scale * rng.standard_normal(np.shape(a))).astype(np.float32)

    params = jax.tree_util.tree_map(lambda a: draw(a, 0.3), params)
    for bn in params["bn"]:
        bn["scale"] = (1.0 + draw(bn["scale"], 0.1)).astype(np.float32)
    state = {"bn": [
        {"mean": draw(s["mean"], 0.1),
         "var": rng.uniform(0.5, 1.5, np.shape(s["var"])).astype(np.float32)}
        for s in state["bn"]
    ]}
    return params, state


def port_model(tcfg, params, state):
    model = get_model(tcfg.model)
    model.load_state_dict(from_jax(params, state, tcfg.model))
    return model


def _carry(rng, hidden, batch):
    return [
        {d: (0.5 * rng.standard_normal((batch, h))).astype(np.float32) for d in ("fwd", "bwd")}
        for h in hidden
    ]


@pytest.mark.parametrize("preset", ["sednet-dcase", "sednet-dcase-keras", "timepooled-v1"])
def test_forward_matches_jax(preset):
    jc, tc = narrowed(preset)
    jm = jax_get_model(jc.model)
    params, state = seeded_tree(jm, 1)
    model = port_model(tc, params, state)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, jc.model.seq_len_in, 40)).astype(np.float32)
    want, _, want_carry = jm.apply(params, state, x, Ctx(train=False))
    with torch.no_grad():
        got, got_carry = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for g, w in zip(got_carry, want_carry):
        for d in ("fwd", "bwd"):
            np.testing.assert_allclose(g[d].numpy(), np.asarray(w[d]), atol=ATOL)


@pytest.mark.parametrize("preset", ["sednet-dcase", "sednet-dcase-keras"])
def test_forward_with_carry_and_carry_at(preset):
    jc, tc = narrowed(preset)
    jm = jax_get_model(jc.model)
    params, state = seeded_tree(jm, 3)
    model = port_model(tc, params, state)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 2 * 256, 40)).astype(np.float32)
    carry = _carry(rng, jc.model.gru_hidden, 1)
    want, _, want_carry = jm.apply(params, state, x, Ctx(train=False),
                                   rnn_carry=carry, carry_at=255)
    with torch.no_grad():
        got, got_carry = model(
            torch.from_numpy(x),
            rnn_carry=[{k: torch.from_numpy(v) for k, v in c.items()} for c in carry],
            carry_at=255,
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for g, w in zip(got_carry, want_carry):
        for d in ("fwd", "bwd"):
            np.testing.assert_allclose(g[d].numpy(), np.asarray(w[d]), atol=ATOL)


def test_binaural_channel_stacked_input():
    jc, tc = narrowed("sednet-dcase-binaural")
    jm = jax_get_model(jc.model)
    params, state = seeded_tree(jm, 5)
    model = port_model(tc, params, state)
    x = np.random.default_rng(6).standard_normal((1, 256, 80)).astype(np.float32)
    want = jm.apply(params, state, x, Ctx(train=False))[0]
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("preset", sorted(tcfg_mod.PRESETS))
def test_param_count_flops_and_shapes_match_full_width(preset):
    from sed_crnn_tpu.models import count_params as jax_count
    from sed_crnn_tpu.models import model_flops_per_example as jax_flops

    jm = jax_get_model(preset)
    params, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    model = get_model(preset)
    assert count_params(model) == jax_count(params)
    assert model_flops_per_example(model) == jax_flops(jm)
    assert (model.flat_dim, model.seq_len_out) == (jm.flat_dim, jm.seq_len_out)


def test_presets_match_field_by_field():
    for name in jcfg_mod.PRESETS:
        assert port_config_of(jcfg_mod.get_preset(name)) == tcfg_mod.get_preset(name)
