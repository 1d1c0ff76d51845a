"""The GRU recurrence's gradient in the port (sed_crnn_torch/ops/kernels/
gru_scan.py): the plain backward `gru_scan_bwd_plain` and the autograd
Function `GruScanFn` on CPU tensors, against `jax.grad` through the JAX
package's Pallas `gru_scan` (its custom-VJP backward kernel, interpreted on
the CPU), against autograd through the plain step loop, and a float64
`gradcheck`.

Tiny shapes (T=12, B=3, H=4; the gradcheck smaller still) keep the loops
short. Tolerance 1e-5 absolute: float32 on both sides, the same per-step
arithmetic up to reassociation inside the small products and the batch
sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.ops.pallas.gru_scan import gru_scan as jax_gru_scan

from sed_crnn_torch.ops.kernels.gru_scan import (
    GruScanFn,
    gru_dwh_plain,
    gru_scan,
    gru_scan_bwd_plain,
    gru_scan_fwd_res_plain,
    gru_scan_plain,
)

ATOL = 1e-5
B, T, H = 3, 12, 4
VARIANTS = [(ra, gate, rev) for ra in (False, True)
            for gate in ("sigmoid", "hard_sigmoid") for rev in (False, True)]


def _case(seed, reset_after, dtype=np.float32, b=B, t=T, h=H):
    rng = np.random.default_rng(seed)
    return {
        "xp": rng.standard_normal((b, t, 3 * h)).astype(dtype),
        "wh": (0.5 * rng.standard_normal((h, 3 * h))).astype(dtype),
        "bh": (0.1 * rng.standard_normal(3 * h)).astype(dtype) if reset_after else None,
        "h0": (0.5 * rng.standard_normal((b, h))).astype(dtype),
        "dys": rng.standard_normal((b, t, h)).astype(dtype),
        "dhl": rng.standard_normal((b, h)).astype(dtype),
    }


def _jax_grads(c, reset_after, gate, reverse):
    names = ["xp", "wh", "h0"] + (["bh"] if reset_after else [])

    def f(*args):
        a = dict(zip(names, args))
        ys, hl = jax_gru_scan(a["xp"], a["wh"], a.get("bh"), a["h0"], reset_after=reset_after,
                              gate_activation=gate, reverse=reverse)
        return jnp.sum(ys * c["dys"]) + jnp.sum(hl * c["dhl"])

    grads = jax.grad(f, argnums=tuple(range(len(names))))(*(jnp.asarray(c[n]) for n in names))
    return dict(zip(names, (np.asarray(g) for g in grads)))


@pytest.mark.parametrize("reset_after,gate,reverse", VARIANTS)
def test_gradients_match_jax_pallas_and_plain_autograd(reset_after, gate, reverse):
    c = _case(30, reset_after)
    want = _jax_grads(c, reset_after, gate, reverse)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in c.items()}
    conf = (reset_after, gate, reverse)

    # the explicit reverse-time loop over stored residuals
    ys, res, _ = gru_scan_fwd_res_plain(t["xp"], t["wh"], t["bh"], t["h0"], *conf)
    dxp, dwh, dbh, dh0 = gru_scan_bwd_plain(ys, res, t["wh"], t["h0"], t["dys"], t["dhl"], *conf)
    plain = {"xp": dxp, "wh": dwh, "h0": dh0, "bh": dbh}
    if not reset_after:
        assert not bool(dbh.any())

    # GruScanFn through the wrapper, and autograd through the step loop
    leaves = {k: v.clone().requires_grad_() for k, v in t.items()
              if k in want}
    bh = leaves.get("bh")
    names = list(want)

    def grads_of(fn):
        ys, hl = fn(leaves["xp"], leaves["wh"], bh, leaves["h0"], *conf)
        out = torch.autograd.grad((ys * t["dys"]).sum() + (hl * t["dhl"]).sum(),
                                  [leaves[n] for n in names])
        return dict(zip(names, out))

    fn = grads_of(gru_scan)
    auto = grads_of(gru_scan_plain)
    for n in names:
        for got in (plain[n], fn[n], auto[n]):
            np.testing.assert_allclose(got.numpy(), want[n], atol=ATOL, err_msg=n)
        assert torch.equal(fn[n], plain[n])  # GruScanFn on the CPU is the plain pair


@pytest.mark.parametrize("reset_after", [False, True])
@pytest.mark.parametrize("gate", ["sigmoid", "hard_sigmoid"])
def test_gradcheck_float64(reset_after, gate):
    c = _case(31, reset_after, np.float64, b=2, t=5, h=3)
    ins = [torch.from_numpy(c[k]).requires_grad_() for k in ("xp", "wh", "h0")]
    bh = torch.from_numpy(c["bh"]).requires_grad_() if reset_after else None

    def fn(xp, wh, h0, *rest):
        return GruScanFn.apply(xp, wh, rest[0] if rest else None, h0, reset_after, gate, True)

    assert torch.autograd.gradcheck(fn, ins + ([bh] if reset_after else []),
                                    eps=1e-6, atol=1e-6)


def test_unused_outputs_and_absent_bias():
    """A cotangent autograd leaves as None (ys or h_last unused) counts as
    zeros; no bh means no bh gradient, and a bh given with
    ``reset_after=False`` gets zeros."""
    c = _case(32, True)
    xp = torch.from_numpy(c["xp"]).requires_grad_()
    wh = torch.from_numpy(c["wh"]).requires_grad_()
    h0 = torch.from_numpy(c["h0"])
    dys = torch.from_numpy(c["dys"])
    dhl = torch.from_numpy(c["dhl"])
    for reset_after in (False, True):
        ys, hl = gru_scan(xp, wh, None, h0, reset_after, "sigmoid", False)
        g_ys = torch.autograd.grad((ys * dys).sum(), [xp, wh])
        ys2, res, _ = gru_scan_fwd_res_plain(xp.detach(), wh.detach(), None if not reset_after
                                             else torch.zeros(3 * H), h0, reset_after,
                                             "sigmoid", False)
        want = gru_scan_bwd_plain(ys2, res, wh.detach(), h0, dys, torch.zeros_like(h0),
                                  reset_after, "sigmoid", False)
        assert torch.equal(g_ys[0], want[0]) and torch.equal(g_ys[1], want[1])
        ys, hl = gru_scan(xp, wh, None, h0, reset_after, "sigmoid", False)
        g_hl = torch.autograd.grad((hl * dhl).sum(), [xp])[0]
        assert g_hl.shape == xp.shape and bool(g_hl.any())
    bh = torch.zeros(3 * H, requires_grad=True)
    ys, _ = gru_scan(xp, wh, bh, h0, False, "sigmoid", False)
    (g_bh,) = torch.autograd.grad(ys.sum(), [bh])
    assert g_bh.shape == (3 * H,) and not bool(g_bh.any())


@pytest.mark.parametrize("reset_after,gate,reverse", VARIANTS)
def test_dwh_plain_matches_jax_kernel(reset_after, gate, reverse):
    """`gru_dwh_plain` (dwh/dbh after the chain, the CUDA reduction's
    reference) from the JAX kernel's own dxp gives the JAX `_bwd_kernel`'s
    dwh and dbh."""
    c = _case(33, reset_after)
    want = _jax_grads(c, reset_after, gate, reverse)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in c.items()}
    ys, res, _ = gru_scan_fwd_res_plain(t["xp"], t["wh"], t["bh"], t["h0"], reset_after, gate,
                                        reverse)
    dwh, dbh = gru_dwh_plain(ys, res, t["h0"], torch.from_numpy(want["xp"]), reset_after,
                             reverse)
    np.testing.assert_allclose(dwh.numpy(), want["wh"], atol=ATOL)
    if reset_after:
        np.testing.assert_allclose(dbh.numpy(), want["bh"], atol=ATOL)
    else:
        assert dbh.shape == (3 * H,) and not bool(dbh.any())
