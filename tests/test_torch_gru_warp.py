"""The port's two-direction GRU entry points (`gru_scan_pair`,
`gru_scan_pair_fwd_res`, `gru_scan_pair_bwd`, `GruScanPairFn`, and
`BiGRU`, which runs through them) on CPU tensors, against the JAX package's
`BiGRU.apply` on its Pallas `gru_scan` (interpreted on the CPU, gradients
through its custom-VJP backward kernel); and `gru_body`, which picks the CUDA
body (``csrc/gru_warp.cu`` up to H=32, ``csrc/gru_wide.cu`` above).

Tiny shapes (T=12, B=3, H=4). Tolerance 1e-5 absolute, as in
tests/test_torch_gru.py: float32 on both sides, the same per-step arithmetic
up to reassociation inside the small products and the batch sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.nn.gru import BiGRU as JaxBiGRU

from sed_crnn_torch.nn.gru import BiGRU
from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.kernels.gru_scan import (
    gru_body,
    gru_scan,
    gru_scan_bwd_plain,
    gru_scan_fwd_res,
    gru_scan_fwd_res_plain,
    gru_scan_pair,
    gru_scan_pair_bwd,
    gru_scan_pair_fwd_res,
    gru_scan_plain,
)

ATOL = 1e-5
B, T, IN, H = 3, 12, 6, 4
DIRS = ("fwd", "bwd")
# (reset_after, gate, carried h0): both conventions, both gates, with and
# without a carried state.
CASES = [(False, "hard_sigmoid", True), (False, "sigmoid", False),
         (True, "sigmoid", True), (True, "hard_sigmoid", False)]


def _weights(rng, reset_after):
    p = {"wi": 0.5 * rng.standard_normal((IN, 3 * H)), "wh": 0.5 * rng.standard_normal((H, 3 * H)),
         "bi": 0.1 * rng.standard_normal(3 * H)}
    if reset_after:
        p["bh"] = 0.1 * rng.standard_normal(3 * H)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("reset_after,gate,carry", CASES)
def test_bigru_pair_matches_jax_outputs_states_and_gradients(reset_after, gate, carry):
    rng = np.random.default_rng(40)
    p = {d: _weights(rng, reset_after) for d in DIRS}
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


@pytest.mark.parametrize("reset_after", [False, True])
def test_pair_functions_on_cpu_are_two_plain_directions(reset_after):
    """On CPU tensors each pair function is the single-direction plain
    version run forward and reversed, bit for bit, and launches nothing."""
    rng = np.random.default_rng(41)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    xp = tuple(t(rng.standard_normal((B, T, 3 * H))) for _ in DIRS)
    wh = tuple(t(0.5 * rng.standard_normal((H, 3 * H))) for _ in DIRS)
    bh = tuple(t(0.1 * rng.standard_normal(3 * H)) if reset_after else None for _ in DIRS)
    h0 = tuple(t(0.5 * rng.standard_normal((B, H))) for _ in DIRS)
    dys = tuple(t(rng.standard_normal((B, T, H))) for _ in DIRS)
    dhl = tuple(t(rng.standard_normal((B, H))) for _ in DIRS)
    counts = (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan.wide_launches)
    pair = gru_scan_pair(xp, wh, bh, h0, reset_after, "sigmoid")
    pair_res = gru_scan_pair_fwd_res(xp, wh, bh, h0, reset_after, "sigmoid")
    grads = gru_scan_pair_bwd(tuple(r[0] for r in pair_res), tuple(r[1] for r in pair_res), wh,
                              h0, dys, dhl, reset_after, "sigmoid")
    for k, rev in enumerate((False, True)):
        single = gru_scan_plain(xp[k], wh[k], bh[k], h0[k], reset_after, "sigmoid", rev)
        single_res = gru_scan_fwd_res_plain(xp[k], wh[k], bh[k], h0[k], reset_after, "sigmoid",
                                            rev)
        single_grads = gru_scan_bwd_plain(single_res[0], single_res[1], wh[k], h0[k], dys[k],
                                          dhl[k], reset_after, "sigmoid", rev)
        for a, b in zip(pair[k] + pair_res[k] + grads[k], single + single_res + single_grads):
            assert torch.equal(a, b)
    assert (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan.wide_launches) == counts


@pytest.mark.parametrize("H_,forward,backward", [
    (4, "warp", "warp"), (8, "warp", "warp"), (16, "warp", "warp"), (32, "warp", "warp"),
    (33, "wide", "wide"), (64, "wide", "wide")])
def test_gru_body_by_hidden_width(H_, forward, backward):
    assert gru_body(H_) == forward
    assert gru_body(H_, backward=True) == backward


def test_gru_body_rejects_widths_no_body_takes():
    """Every positive width has a body; only H <= 0 raises here. (The grid
    body has a plan at every width: above 256 units a CTA, a pair above
    H = 16,896, its CTAs walk their units in blocks; tests/test_torch_gru_grid.py.)"""
    assert gru_body(1) == "warp"
    for h, bwd, body in ((128, False, "wide"), (129, False, "cluster"), (65, True, "wide"),
                         (4096, True, "grid")):
        assert gru_body(h, backward=bwd) == body
    for h, bwd in ((0, False), (-1, False), (0, True)):
        with pytest.raises(ValueError):
            gru_body(h, backward=bwd)


def test_warp_source_is_built_and_calls_no_library():
    """csrc/gru_warp.cu is one of the built sources, for sm_90a, and calls
    no cuDNN, cuBLAS or other finished kernel."""
    assert "gru_warp" in _build.KERNEL_SOURCES
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = (_build.CSRC_DIR / "gru_warp.cu").read_text()
    includes = sorted(ln.split()[1] for ln in src.splitlines() if ln.startswith("#include"))
    assert includes == ["<cuda_runtime.h>", "<math.h>"]
    for word in ("cudnn", "cublas", "cutlass", "matmul", "wgmma"):
        assert word not in src.lower()
