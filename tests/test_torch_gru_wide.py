"""Kernel B above the warp body (H > 32: ``csrc/gru_wide.cu``, and
``csrc/gru_cluster.cu`` at 129 and 256) on CPU tensors: the port's `BiGRU`
and its pair entry points (`gru_scan_pair`, `gru_scan_pair_fwd_res`,
`gru_scan_pair_bwd`, through `GruScanPairFn`) against the JAX package's `BiGRU.apply` on its Pallas
`gru_scan` (interpreted on the CPU, gradients through its custom-VJP
backward kernel); `StackedCRNN` with wide GRUs against ``jax.vmap`` of the
JAX model; the dispatch and the source's build rules.

Small shapes (T=12, B=3), weights scaled by 1/sqrt(fan-in) so that the
activations stay in range at H=256. Tolerance 1e-5 absolute, as in
tests/test_torch_gru_warp.py: float32 on both sides, the same per-step
arithmetic up to reassociation in the products and the batch sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.nn.gru import BiGRU as JaxBiGRU
from sed_crnn_tpu.nn.layers import Ctx
from sed_crnn_tpu.ops import losses as jax_losses
from sed_crnn_tpu.ops.pallas import gru_scan as jax_gru_scan

from sed_crnn_torch.models.stacked import StackedCRNN
from sed_crnn_torch.models.convert import to_jax
from sed_crnn_torch.nn.gru import BiGRU
from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.kernels.gru_scan import (
    gru_body,
    gru_scan_pair,
    gru_scan_pair_bwd,
    gru_scan_pair_fwd_res,
)
from sed_crnn_torch.ops.losses import make_loss
from tests.test_torch_model import narrowed, port_model

ATOL = 1e-5
B, T, IN = 3, 12, 10
DIRS = ("fwd", "bwd")
WIDTHS = [33, 64, 96, 128, 129, 256]   # 129 and 256: the cluster tier on the card
# (reset_after, gate, carried h0): both conventions, both gates.
CASES = [(False, "hard_sigmoid", True), (False, "sigmoid", False),
         (True, "sigmoid", True), (True, "hard_sigmoid", False)]


def _weights(rng, H, reset_after):
    p = {"wi": rng.standard_normal((IN, 3 * H)) / np.sqrt(IN),
         "wh": rng.standard_normal((H, 3 * H)) / np.sqrt(H),
         "bi": 0.1 * rng.standard_normal(3 * H)}
    if reset_after:
        p["bh"] = 0.1 * rng.standard_normal(3 * H)
    return {k: v.astype(np.float32) for k, v in p.items()}


def test_jax_reference_runs_its_pallas_kernel_at_these_shapes():
    """The JAX side of the BiGRU cases below takes its Pallas kernel (its
    VMEM estimate fits), not the XLA scan fallback."""
    for H in WIDTHS:
        for reset_after in (False, True):
            assert jax_gru_scan.fits_vmem(T, B, H, reset_after)


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("reset_after,gate,carry", CASES)
def test_wide_bigru_matches_jax_outputs_states_and_gradients(H, reset_after, gate, carry):
    rng = np.random.default_rng(1000 + H)
    p = {d: _weights(rng, H, reset_after) for d in DIRS}
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    h0 = {d: (0.5 * rng.standard_normal((B, H))).astype(np.float32) for d in DIRS}
    g_out = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    g_h = {d: rng.standard_normal((B, H)).astype(np.float32) for d in DIRS}

    jax_bigru = JaxBiGRU(IN, H, reset_after, gate, backend="pallas")

    def loss(params, x, h0):
        out, hl = jax_bigru.apply(params, x, h0)
        return jnp.sum(out * g_out) + sum(jnp.sum(hl[d] * g_h[d]) for d in DIRS)

    args = (jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
            {d: jnp.asarray(v) for d, v in h0.items()} if carry else None)
    want_out, want_h = jax_bigru.apply(*args)
    want_g = jax.grad(loss, argnums=(0, 1, 2) if carry else (0, 1))(*args)

    m = BiGRU(IN, H, reset_after, gate)
    m.load_state_dict({f"{d}.{k}": torch.from_numpy(v) for d in p for k, v in p[d].items()})
    xt = torch.from_numpy(x).requires_grad_()
    h0t = {d: torch.from_numpy(v).requires_grad_() for d, v in h0.items()} if carry else None
    out, hl = m(xt, h0t)
    assert "GruScanPairFn" in type(out.grad_fn.next_functions[0][0]).__name__
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=ATOL)
    for d in DIRS:
        np.testing.assert_allclose(hl[d].detach().numpy(), np.asarray(want_h[d]), atol=ATOL)

    total = (out * torch.from_numpy(g_out)).sum() + sum(
        (hl[d] * torch.from_numpy(g_h[d])).sum() for d in DIRS)
    names = [f"{d}.{k}" for d in DIRS for k in p[d]]
    leaves = [dict(m.named_parameters())[n] for n in names] + [xt]
    leaves += [h0t[d] for d in DIRS] if carry else []
    got = dict(zip(names + ["x"] + [f"h0.{d}" for d in DIRS], torch.autograd.grad(total, leaves)))
    for n in names:
        d, k = n.split(".")
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want_g[0][d][k]), atol=ATOL,
                                   err_msg=n)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want_g[1]), atol=ATOL)
    if carry:
        for d in DIRS:
            np.testing.assert_allclose(got[f"h0.{d}"].numpy(), np.asarray(want_g[2][d]),
                                       atol=ATOL)

    with torch.no_grad():     # no grad: `gru_scan_pair` without the Function
        out_ng, hl_ng = m(xt, h0t)
    assert torch.equal(out_ng, out.detach())
    assert all(torch.equal(hl_ng[d], hl[d].detach()) for d in DIRS)


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("reset_after", [False, True])
def test_wide_pair_functions_match_jax_kernel_per_direction(H, reset_after):
    """The pair entry points on pre-projected inputs against the JAX Pallas
    `gru_scan` (forward) and its VJP (backward) of each direction."""
    rng = np.random.default_rng(2000 + H)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    xp = [f32(rng.standard_normal((B, T, 3 * H))) for _ in DIRS]
    wh = [f32(rng.standard_normal((H, 3 * H)) / np.sqrt(H)) for _ in DIRS]
    bh = [f32(0.1 * rng.standard_normal(3 * H)) if reset_after else None for _ in DIRS]
    h0 = [f32(0.5 * rng.standard_normal((B, H))) for _ in DIRS]
    dys = [f32(rng.standard_normal((B, T, H))) for _ in DIRS]
    dhl = [f32(rng.standard_normal((B, H))) for _ in DIRS]
    t = lambda arrs: tuple(None if a is None else torch.from_numpy(a) for a in arrs)  # noqa: E731

    fwd = gru_scan_pair(t(xp), t(wh), t(bh), t(h0), reset_after, "sigmoid")
    res = gru_scan_pair_fwd_res(t(xp), t(wh), t(bh), t(h0), reset_after, "sigmoid")
    grads = gru_scan_pair_bwd(tuple(r[0] for r in res), tuple(r[1] for r in res), t(wh), t(h0),
                              t(dys), t(dhl), reset_after, "sigmoid")
    for k, rev in enumerate((False, True)):
        def run(xp_, wh_, bh_, h0_):
            return jax_gru_scan.gru_scan(xp_, wh_, bh_, h0_, reset_after=reset_after,
                                         gate_activation="sigmoid", reverse=rev)

        (ys, hl), vjp = jax.vjp(run, xp[k], wh[k], bh[k] if reset_after else None, h0[k])
        for got in (fwd[k], (res[k][0], res[k][2])):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(ys), atol=ATOL)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(hl), atol=ATOL)
        dxp, dwh, dbh, dh0 = vjp((jnp.asarray(dys[k]), jnp.asarray(dhl[k])))
        for name, g, w in (("dxp", grads[k][0], dxp), ("dwh", grads[k][1], dwh),
                           ("dh0", grads[k][3], dh0)) + ((("dbh", grads[k][2], dbh),)
                                                         if reset_after else ()):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)
        if not reset_after:
            assert not bool(grads[k][2].any())


def test_stacked_crnn_with_wide_grus_matches_jax_vmap():
    """`StackedCRNN` at gru_hidden=(48, 40), 3 seeds, train mode without
    dropout, against ``jax.vmap`` of the JAX model on the same weights:
    logits 2e-5, losses 1e-5 relative, gradients 1e-4 of each leaf's largest
    (the bands of tests/test_torch_multiseed_stacked.py)."""
    S = 3
    wide = dict(conv_channels=(8, 8, 8), gru_hidden=(48, 40))
    jc, tc = narrowed("timepooled-v2", dropout=0.0, compute_dtype="float32")
    jc = jc.replace(model=dataclasses.replace(jc.model, **wide))
    tc = tc.replace(model=dataclasses.replace(tc.model, **wide))
    jm = jax_get_model(jc.model)
    params, state = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(7), S))
    rng = np.random.default_rng(8)
    nb = 3
    x = rng.standard_normal((S, nb, jc.model.seq_len_in, jc.model.n_mels)).astype(np.float32)
    y = (rng.random((S, nb, jm.seq_len_out, jc.model.n_classes)) > 0.7).astype(np.float32)
    jloss = jax_losses.make_loss(jc.train.loss)

    def objective(p, st, xs, ys):
        logits, _, _ = jm.apply(p, st, xs, Ctx(train=True))
        return jloss(logits, ys), logits

    (want_loss, want_logits), want_grads = jax.jit(jax.vmap(
        jax.value_and_grad(objective, has_aux=True)))(params, state, jnp.asarray(x), jnp.asarray(y))

    def one(tree, s):
        return jax.tree_util.tree_map(lambda a: np.asarray(a)[s], tree)

    model = StackedCRNN.from_models(
        [port_model(tc, one(params, s), one(state, s)) for s in range(S)]).train()
    logits = model(torch.from_numpy(x))
    losses = make_loss(tc.train.loss)(logits, torch.from_numpy(y), reduction="none").mean(
        dim=(1, 2, 3))
    losses.sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=2e-5)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want_loss), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    for s in range(S):
        got_g, _ = to_jax(model.split(grads, s), tc.model)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(one(want_grads, s)),
                                jax.tree_util.tree_leaves(got_g)):
            if "conv" in str(path) and path[-1].key == "b":
                continue   # a bias ahead of train-mode BatchNorm: its gradient is 0 (noise)
            scale = max(np.abs(w).max(), 1e-12)
            assert np.abs(g - w).max() <= 1e-4 * scale, (s, path)


@pytest.mark.parametrize("H_", [33, 48, 64, 96, 128, 129, 256, 1000])
def test_every_width_above_32_runs_the_wide_body(H_):
    """The wide body up to H = 128; the cluster body to CLUSTER_MAX_H (512,
    tests/test_torch_gru_cluster.py) and the grid body above
    (tests/test_torch_gru_grid.py)."""
    want = "wide" if H_ <= 128 else "cluster" if H_ <= 512 else "grid"
    assert gru_body(H_) == want
    assert gru_body(H_, backward=True) == want


def test_wide_source_is_built_and_calls_no_library():
    """csrc/gru_wide.cu is one of the built sources, for sm_90a, and calls
    no cuDNN, cuBLAS, CUTLASS or other finished kernel."""
    assert "gru_wide" in _build.KERNEL_SOURCES
    assert "gru_scan" not in _build.KERNEL_SOURCES
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = (_build.CSRC_DIR / "gru_wide.cu").read_text()
    includes = sorted(ln.split()[1] for ln in src.splitlines() if ln.startswith("#include"))
    assert includes == ["<cuda_runtime.h>", "<math.h>", "<mutex>", "<vector>"]
    for word in ("cudnn", "cublas", "cutlass", "matmul", "wgmma"):
        assert word not in src.lower()
    assert not (_build.CSRC_DIR / "gru_scan.cu").exists()
