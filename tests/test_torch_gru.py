"""The port's GRU recurrence (plain version of the kernel,
sed_crnn_torch/ops/kernels/gru_scan.py) and GRU modules against the JAX
package: its Pallas `gru_scan` run interpreted on the CPU, and its
`GRU.apply(backend="xla")` scan. Tiny shapes (T=12, B=3, H=4) keep the
interpreted time loop short. Tolerance 1e-5 absolute: both sides are float32
with the same operation order, up to reassociation inside the small
products.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.nn.gru import GRU as JaxGRU
from sed_crnn_tpu.nn.gru import BiGRU as JaxBiGRU
from sed_crnn_tpu.ops.pallas.gru_scan import gru_scan as jax_gru_scan

from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.models import get_model
from sed_crnn_torch.nn.gru import GRU, BiGRU
from sed_crnn_torch.ops.kernels.gru_scan import gru_scan, gru_scan_plain, hard_sigmoid

ATOL = 1e-5
B, T, IN, H = 3, 12, 6, 4


def _weights(rng, reset_after, in_dim=IN, hidden=H):
    p = {
        "wi": (0.5 * rng.standard_normal((in_dim, 3 * hidden))).astype(np.float32),
        "wh": (0.5 * rng.standard_normal((hidden, 3 * hidden))).astype(np.float32),
        "bi": (0.1 * rng.standard_normal(3 * hidden)).astype(np.float32),
    }
    if reset_after:
        p["bh"] = (0.1 * rng.standard_normal(3 * hidden)).astype(np.float32)
    return p


def _port_gru(p, reset_after, gate):
    g = GRU(p["wi"].shape[0], p["wh"].shape[0], reset_after, gate)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    return g


@pytest.mark.parametrize("reset_after", [True, False])
@pytest.mark.parametrize("gate", ["sigmoid", "hard_sigmoid"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_recurrence_matches_jax_kernel_and_scan(reset_after, gate, reverse):
    rng = np.random.default_rng(10)
    p = _weights(rng, reset_after)
    xp = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    bh = p.get("bh")

    ys, hl = gru_scan_plain(torch.from_numpy(xp), torch.from_numpy(p["wh"]),
                            None if bh is None else torch.from_numpy(bh),
                            torch.from_numpy(h0), reset_after, gate, reverse)
    # the JAX Pallas kernel, interpreted on the CPU
    kys, khl = jax_gru_scan(jnp.asarray(xp), jnp.asarray(p["wh"]),
                            None if bh is None else jnp.asarray(bh), jnp.asarray(h0),
                            reset_after=reset_after, gate_activation=gate, reverse=reverse)
    np.testing.assert_allclose(ys.numpy(), np.asarray(kys), atol=ATOL)
    np.testing.assert_allclose(hl.numpy(), np.asarray(khl), atol=ATOL)

    # the module (input projection + recurrence) against the XLA scan
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    want_ys, want_hl = JaxGRU(IN, H, reset_after, gate, backend="xla").apply(
        p, jnp.asarray(x), jnp.asarray(h0), reverse=reverse)
    with torch.no_grad():
        got_ys, got_hl = _port_gru(p, reset_after, gate)(
            torch.from_numpy(x), torch.from_numpy(h0), reverse=reverse)
    np.testing.assert_allclose(got_ys.numpy(), np.asarray(want_ys), atol=ATOL)
    np.testing.assert_allclose(got_hl.numpy(), np.asarray(want_hl), atol=ATOL)


@pytest.mark.parametrize("reset_after", [False, True])
def test_cpu_tensors_take_the_plain_path(reset_after):
    """On a CPU tensor the module computes the plain recurrence bit for bit."""
    rng = np.random.default_rng(11)
    p = _weights(rng, reset_after)
    x = torch.from_numpy(rng.standard_normal((B, T, IN)).astype(np.float32))
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    with torch.no_grad():
        want = gru_scan_plain(torch.matmul(x, t["wi"]) + t["bi"], t["wh"], t.get("bh"),
                              x.new_zeros((B, H)), reset_after, "sigmoid", False)
        got = _port_gru(p, reset_after, "sigmoid")(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    launches = gru_scan.launches
    gru_scan(torch.zeros(1, 2, 3), torch.zeros(1, 3), None, torch.zeros(1, 1),
             False, "sigmoid", False)
    assert gru_scan.launches == launches  # the CPU path launches nothing


def test_bigru_with_carry_matches_jax():
    rng = np.random.default_rng(12)
    p = {"fwd": _weights(rng, False), "bwd": _weights(rng, False)}
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    carry = {d: (0.5 * rng.standard_normal((B, H))).astype(np.float32) for d in ("fwd", "bwd")}
    want, want_c = JaxBiGRU(IN, H, False, "hard_sigmoid", backend="xla").apply(
        p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in carry.items()})
    m = BiGRU(IN, H, False, "hard_sigmoid")
    m.load_state_dict({f"{d}.{k}": torch.from_numpy(v) for d in p for k, v in p[d].items()})
    with torch.no_grad():
        got, got_c = m(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in carry.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for d in ("fwd", "bwd"):
        np.testing.assert_allclose(got_c[d].numpy(), np.asarray(want_c[d]), atol=ATOL)


def test_hard_sigmoid_is_keras_not_torch():
    v = torch.tensor([-3.0, -2.5, 0.0, 1.0, 2.5, 3.0])
    np.testing.assert_allclose(hard_sigmoid(v).numpy(), [0.0, 0.0, 0.5, 0.7, 1.0, 1.0], atol=1e-7)
    assert not torch.allclose(hard_sigmoid(v), torch.nn.functional.hardsigmoid(v))


def test_unknown_backend_and_gate_raise():
    with pytest.raises(ValueError):
        get_model(dataclasses.replace(get_preset("sednet-dcase").model, gru_backend="xla"))
    with pytest.raises(ValueError):
        GRU(2, 2, gate_activation="relu")
