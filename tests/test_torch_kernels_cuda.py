"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside the
fixture). On a machine with one, and without JAX, run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances as in chip_smoke.py: 1e-5 absolute for the GRU recurrence
(float32, same operation order up to reassociation in the small products)
and 1e-4 of each gradient's largest magnitude for its backward (a long
gradient chain, and dwh/dbh summed over B*T terms in another order),
5e-4 in the log domain for the fused log-mel at finite entries, with an
identical -inf pattern (against the DIF / direct plain version; 1e-5
against `fft_log_mel_plain`, which repeats the FFT body's float32
operations, so only ``logf`` against ``torch.log`` differs; bitwise against
`mixed_log_mel_plain`, which repeats the mixed and cluster bodies').
"""

import dataclasses

import numpy as np
import pytest
import torch

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels.fused_logmel import (
    CLUSTER_MAX,
    MIXED_MAX_SMEM,
    _launch_cluster,
    _launch_fft,
    _launch_mixed,
    body,
    cluster_resident,
    cluster_size,
    cluster_split,
    fft_log_mel_plain,
    frame_source,
    fused_log_mel,
    fused_log_mel_frames,
    fused_log_mel_frames_plain,
    fused_log_mel_plain,
    mixed_log_mel_plain,
    mixed_plan,
    route,
)
from sed_crnn_torch.ops.mel import mel_filterbank
from sed_crnn_torch.ops.stft import frame_signal, hann_window
from sed_crnn_torch.nn.gru import BiGRU
from sed_crnn_torch.ops.kernels.gru_scan import (
    _bwd,
    _fwd,
    gru_body,
    gru_dwh_plain,
    gru_scan,
    gru_scan_bwd,
    gru_scan_bwd_plain,
    gru_scan_fwd_res,
    gru_scan_fwd_res_plain,
    gru_scan_pair,
    gru_scan_pair_bwd,
    gru_scan_pair_fwd_res,
    gru_scan_plain,
    gru_scan_stack,
    gru_scan_stack_bwd,
    gru_scan_stack_fwd_res,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# H <= 32 runs the warp body (csrc/gru_warp.cu), 32 < H <= 128 the wide one
# (csrc/gru_wide.cu, registers), 128 < H <= 512 the cluster body
# (csrc/gru_cluster.cu), H > 512 the grid body (csrc/gru_grid.cu).
GRU_SHAPES = [(1, 1, 4), (3, 7, 8), (7, 45, 16), (5, 300, 32), (2, 20, 64), (3, 30, 129)]


@pytest.mark.parametrize("B,T,H", GRU_SHAPES)
@pytest.mark.parametrize("reset_after", [False, True])
@pytest.mark.parametrize("gate", ["sigmoid", "hard_sigmoid"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_kernel_matches_plain(cuda, B, T, H, reset_after, gate, reverse):
    rng = np.random.default_rng(B * 1000 + T)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    xp = t(rng.standard_normal((B, T, 3 * H)))
    wh = t(rng.standard_normal((H, 3 * H)) / np.sqrt(H))
    bh = t(0.1 * rng.standard_normal(3 * H)) if reset_after else None
    h0 = t(0.5 * rng.standard_normal((B, H)))
    launches, wide = gru_scan.launches, gru_scan.wide_launches
    cluster = gru_scan.cluster_launches
    ys, hl = gru_scan(xp, wh, bh, h0, reset_after, gate, reverse)
    torch.cuda.synchronize()
    assert gru_scan.launches == launches + 1
    assert gru_scan.wide_launches == wide + (gru_body(H) == "wide")
    assert gru_scan.cluster_launches == cluster + (gru_body(H) == "cluster")
    ys_p, hl_p = gru_scan_plain(xp, wh, bh, h0, reset_after, gate, reverse)
    torch.testing.assert_close(ys, ys_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(hl, hl_p, rtol=0, atol=1e-5)


def _gru_case(dev, B, T, H, reset_after, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    return (t(rng.standard_normal((B, T, 3 * H))), t(rng.standard_normal((H, 3 * H)) / np.sqrt(H)),
            t(0.1 * rng.standard_normal(3 * H)) if reset_after else None,
            t(0.5 * rng.standard_normal((B, H))), t(rng.standard_normal((B, T, H))),
            t(rng.standard_normal((B, H))))


@pytest.mark.parametrize("B,T,H", GRU_SHAPES)
@pytest.mark.parametrize("reset_after", [False, True])
@pytest.mark.parametrize("gate", ["sigmoid", "hard_sigmoid"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_train_kernels_match_plain(cuda, B, T, H, reset_after, gate, reverse):
    """The residual forward and the backward against their plain versions:
    ys/res/h_last within 1e-5; dxp/dh0/dwh/dbh within 1e-4 of each one's
    largest magnitude (a 300-step gradient chain, and sums over B*T terms
    taken in another order)."""
    xp, wh, bh, h0, dys, dhl = _gru_case(cuda, B, T, H, reset_after, B * 1000 + T)
    conf = (reset_after, gate, reverse)
    n_fwd, n_bwd, n_sum = (gru_scan_fwd_res.launches, gru_scan_bwd.launches,
                           gru_scan_bwd.sum_launches)
    n_dwh, n_wide = gru_scan_bwd.dwh_launches, gru_scan.wide_launches
    n_cluster, n_grid = gru_scan.cluster_launches, gru_scan.grid_launches
    ys, res, hl = gru_scan_fwd_res(xp, wh, bh, h0, *conf)
    torch.cuda.synchronize()
    ys_p, res_p, hl_p = gru_scan_fwd_res_plain(xp, wh, bh, h0, *conf)
    for got, want in ((ys, ys_p), (res, res_p), (hl, hl_p)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    ys0, hl0 = gru_scan(xp, wh, bh, h0, *conf)
    assert torch.equal(ys0, ys) and torch.equal(hl0, hl)  # one templated body
    grads = gru_scan_bwd(ys, res, wh, h0, dys, dhl, *conf)
    torch.cuda.synchronize()
    want = gru_scan_bwd_plain(ys, res, wh, h0, dys, dhl, *conf)
    for got, w in zip(grads, want):
        scale = max(float(w.abs().max()), 1e-6)
        torch.testing.assert_close(got, w, rtol=0, atol=1e-4 * scale)
    if not reset_after:
        assert not bool(grads[2].any())
    assert (gru_scan_fwd_res.launches, gru_scan_bwd.launches, gru_scan_bwd.sum_launches) == (
        n_fwd + 1, n_bwd + 1, n_sum + 1)
    assert gru_scan_bwd.dwh_launches == n_dwh + 1
    wide = gru_body(H) == "wide"
    assert gru_scan.wide_launches == n_wide + 3 * wide  # fwd_res, fwd, bwd
    assert gru_scan.cluster_launches == n_cluster + 3 * (gru_body(H) == "cluster")
    assert gru_scan.grid_launches == n_grid + 3 * (gru_body(H) == "grid")


@pytest.mark.parametrize("reset_after", [False, True])
def test_gru_backward_is_deterministic(cuda, reset_after):
    """dwh is summed from per-block partials in a fixed order: bitwise equal
    from run to run."""
    xp, wh, bh, h0, dys, dhl = _gru_case(cuda, 128, 256, 32, reset_after, 5)
    conf = (reset_after, "sigmoid", False)
    ys, res, _ = gru_scan_fwd_res(xp, wh, bh, h0, *conf)
    first = gru_scan_bwd(ys, res, wh, h0, dys, dhl, *conf)
    second = gru_scan_bwd(ys, res, wh, h0, dys, dhl, *conf)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("reset_after", [False, True])
def test_gru_autograd_goes_through_the_kernels(cuda, reset_after):
    """With grad enabled `gru_scan` runs GruScanFn: the residual forward and
    the backward kernel, with gradients equal to autograd through the plain
    step loop within the backward's band."""
    xp, wh, bh, h0, dys, _ = _gru_case(cuda, 6, 40, 16, reset_after, 9)
    ins = [a.clone().requires_grad_() for a in (xp, wh, h0) + ((bh,) if reset_after else ())]
    bh_in = ins[3] if reset_after else None
    n_fwd, n_bwd, n_plain = gru_scan_fwd_res.launches, gru_scan_bwd.launches, gru_scan.launches
    ys, _ = gru_scan(ins[0], ins[1], bh_in, ins[2], reset_after, "hard_sigmoid", True)
    got = torch.autograd.grad((ys * dys).sum(), ins)
    assert (gru_scan_fwd_res.launches, gru_scan_bwd.launches, gru_scan.launches) == (
        n_fwd + 1, n_bwd + 1, n_plain)
    ys_p, _ = gru_scan_plain(ins[0], ins[1], bh_in, ins[2], reset_after, "hard_sigmoid", True)
    want = torch.autograd.grad((ys_p * dys).sum(), ins)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))
    with torch.no_grad():
        gru_scan(ins[0], ins[1], bh_in, ins[2], reset_after, "hard_sigmoid", True)
    assert gru_scan.launches == n_plain + 1


def test_gru_kernel_rejects_bad_inputs(cuda):
    xp = torch.zeros(2, 3, 12, device=cuda)
    with pytest.raises(TypeError):
        gru_scan(xp.double(), torch.zeros(4, 12, device=cuda, dtype=torch.float64), None,
                 torch.zeros(2, 4, device=cuda, dtype=torch.float64), False, "sigmoid", False)
    with pytest.raises(ValueError):
        gru_scan(xp, torch.zeros(4, 12), None, torch.zeros(2, 4, device=cuda),
                 False, "sigmoid", False)


def _pair_case(dev, B, T, H, reset_after, seed):
    a = _gru_case(dev, B, T, H, reset_after, seed)
    b = _gru_case(dev, B, T, H, reset_after, seed + 1)
    return tuple(zip(a, b))


@pytest.mark.parametrize("B,T,H", [(1, 256, 32), (8, 256, 16), (128, 256, 8), (3, 20, 64),
                                   (128, 64, 128), (8, 40, 256)])
@pytest.mark.parametrize("reset_after", [False, True])
@pytest.mark.parametrize("gate", ["sigmoid", "hard_sigmoid"])
def test_gru_pair_launches_match_two_plain_directions(cuda, B, T, H, reset_after, gate):
    """One pair launch of each kernel, on either body, against the
    single-direction plain versions run forward and reversed."""
    xp, wh, bh, h0, dys, dhl = _pair_case(cuda, B, T, H, reset_after, 70 + H)
    wide, cluster = gru_body(H) == "wide", gru_body(H) == "cluster"
    before = (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
              gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches, gru_scan.wide_launches,
              gru_scan.cluster_launches)
    pair = gru_scan_pair(xp, wh, bh, h0, reset_after, gate)
    pair_res = gru_scan_pair_fwd_res(xp, wh, bh, h0, reset_after, gate)
    ys, res = tuple(r[0] for r in pair_res), tuple(r[1] for r in pair_res)
    grads = gru_scan_pair_bwd(ys, res, wh, h0, dys, dhl, reset_after, gate)
    torch.cuda.synchronize()
    assert (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
            gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches,
            gru_scan.wide_launches, gru_scan.cluster_launches) == tuple(
                b + 1 for b in before[:5]) + (before[5] + 3 * wide, before[6] + 3 * cluster)
    for k, rev in enumerate((False, True)):
        conf = (reset_after, gate, rev)
        want = gru_scan_fwd_res_plain(xp[k], wh[k], bh[k], h0[k], *conf)
        for got, w in zip(pair_res[k], want):
            torch.testing.assert_close(got, w, rtol=0, atol=1e-5)
        assert torch.equal(pair[k][0], pair_res[k][0]) and torch.equal(pair[k][1], pair_res[k][2])
        want = gru_scan_bwd_plain(ys[k], res[k], wh[k], h0[k], dys[k], dhl[k], *conf)
        for got, w in zip(grads[k], want):
            torch.testing.assert_close(got, w, rtol=0, atol=1e-4 * max(float(w.abs().max()), 1e-6))


@pytest.mark.parametrize("reset_after", [False, True])
def test_gru_pair_forward_at_the_eval_batch(cuda, reset_after):
    """The evaluation path's shape: B=256 (`evaluate_split`'s default
    batch), T=256, H=32, one pair launch on the warp body (512 warps)."""
    xp, wh, bh, h0, _, _ = _pair_case(cuda, 256, 256, 32, reset_after, 256)
    launches, wide = gru_scan.launches, gru_scan.wide_launches
    pair = gru_scan_pair(xp, wh, bh, h0, reset_after, "sigmoid")
    torch.cuda.synchronize()
    assert (gru_scan.launches, gru_scan.wide_launches) == (launches + 1, wide)
    for k, rev in enumerate((False, True)):
        want = gru_scan_plain(xp[k], wh[k], bh[k], h0[k], reset_after, "sigmoid", rev)
        for got, w in zip(pair[k], want):
            torch.testing.assert_close(got, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,T", [(1, 512), (8, 256), (8, 512)])
@pytest.mark.parametrize("reset_after", [False, True])
def test_gru_pair_forward_at_the_live_serving_shapes(cuda, B, T, reset_after):
    """The live serving path's shapes, H=32, from carried (non-zero) states:
    the lookahead pair step (T=512) and `stream_step_batch` over B=8
    concurrent streams, one pair launch on the warp body each."""
    xp, wh, bh, h0, _, _ = _pair_case(cuda, B, T, 32, reset_after, 500 + B + T)
    launches, wide = gru_scan.launches, gru_scan.wide_launches
    pair = gru_scan_pair(xp, wh, bh, h0, reset_after, "sigmoid")
    torch.cuda.synchronize()
    assert (gru_scan.launches, gru_scan.wide_launches) == (launches + 1, wide)
    for k, rev in enumerate((False, True)):
        want = gru_scan_plain(xp[k], wh[k], bh[k], h0[k], reset_after, "sigmoid", rev)
        for got, w in zip(pair[k], want):
            torch.testing.assert_close(got, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,T,H", [(1, 256, 32), (128, 256, 32), (8, 256, 16), (5, 77, 8)])
@pytest.mark.parametrize("reset_after", [False, True])
def test_gru_dwh_reduction_matches_plain_and_is_bitwise_stable(cuda, B, T, H, reset_after):
    """The warp body's dwh/dbh (reduction kernel + fixed-order sum) against
    `gru_dwh_plain` on the kernel's own dxp, within 1e-4 of the largest
    magnitude (B*T terms summed in another order); two runs bitwise equal."""
    xp, wh, bh, h0, dys, dhl = _pair_case(cuda, B, T, H, reset_after, 90 + B)
    pair_res = gru_scan_pair_fwd_res(xp, wh, bh, h0, reset_after, "sigmoid")
    ys, res = tuple(r[0] for r in pair_res), tuple(r[1] for r in pair_res)
    first = gru_scan_pair_bwd(ys, res, wh, h0, dys, dhl, reset_after, "sigmoid")
    second = gru_scan_pair_bwd(ys, res, wh, h0, dys, dhl, reset_after, "sigmoid")
    torch.cuda.synchronize()
    for k, rev in enumerate((False, True)):
        dxp, dwh, dbh, _ = first[k]
        want_dwh, want_dbh = gru_dwh_plain(ys[k], res[k], h0[k], dxp, reset_after, rev)
        torch.testing.assert_close(dwh, want_dwh, rtol=0,
                                   atol=1e-4 * float(want_dwh.abs().max()))
        torch.testing.assert_close(dbh, want_dbh, rtol=0,
                                   atol=1e-4 * max(float(want_dbh.abs().max()), 1e-6))
        assert all(torch.equal(a, b) for a, b in zip(first[k], second[k]))


@pytest.mark.parametrize("B,T,H", [(3, 100, 33), (128, 64, 128), (5, 70, 257), (5, 70, 260),
                                   (64, 256, 1024)])
@pytest.mark.parametrize("reset_after", [False, True])
def test_mma_dwh_reduction_matches_plain_and_is_bitwise_stable(cuda, B, T, H, reset_after):
    """csrc/gru_dwh.cu (3xTF32 on the tensor cores, split-K, fixed-order
    sum) on a pair's stored rows and its own dxp, on the body `dwh_body`
    picks (the mma.sync tile at the odd widths 33 and 257, the wgmma body at
    128, 260 (a partial tile) and 1024): dwh/dbh within 1e-4 of the largest
    entry of `gru_dwh_plain`, two runs bitwise equal, one launch of the
    reduction and of the sum (the wgmma body's counted apart, by the body the
    library launched, as the Python mirror says); the card's split count is
    the Python mirror's; a stack of two seeds whose
    seed 0 is this pair gives seed 0 bitwise the pair's. At H = 1024 one
    split walks all 16,384 rows, where a single tensor-core accumulator
    drifts out of the band."""
    from sed_crnn_torch.ops.kernels.gru_scan import _dwh_lib, dwh_body, dwh_split_plan

    assert _dwh_lib().gru_dwh_splits(B, T, H) == dwh_split_plan(B, T, H)[0]
    cases = [_pair_case(cuda, B, T, H, reset_after, 130 + H + 7 * s) for s in range(2)]
    xp, wh, bh, h0, dys, dhl = cases[0]
    pair_res = gru_scan_pair_fwd_res(xp, wh, bh, h0, reset_after, "sigmoid")
    ys, res = tuple(r[0] for r in pair_res), tuple(r[1] for r in pair_res)
    before = (gru_scan_bwd.dwh_launches, gru_scan_bwd.mma_dwh_launches,
              gru_scan_bwd.wgmma_dwh_launches, gru_scan_bwd.sum_launches)
    first = gru_scan_pair_bwd(ys, res, wh, h0, dys, dhl, reset_after, "sigmoid")
    wgmma = int(dwh_body(H) == "wgmma")
    assert (gru_scan_bwd.dwh_launches, gru_scan_bwd.mma_dwh_launches,
            gru_scan_bwd.wgmma_dwh_launches, gru_scan_bwd.sum_launches) == (
        before[0] + 1, before[1] + 1, before[2] + wgmma, before[3] + 1)
    second = gru_scan_pair_bwd(ys, res, wh, h0, dys, dhl, reset_after, "sigmoid")
    torch.cuda.synchronize()
    for k, rev in enumerate((False, True)):
        dxp, dwh, dbh, _ = first[k]
        want_dwh, want_dbh = gru_dwh_plain(ys[k], res[k], h0[k], dxp, reset_after, rev)
        torch.testing.assert_close(dwh, want_dwh, rtol=0,
                                   atol=1e-4 * float(want_dwh.abs().max()))
        torch.testing.assert_close(dbh, want_dbh, rtol=0,
                                   atol=1e-4 * max(float(want_dbh.abs().max()), 1e-6))
        assert all(torch.equal(a, b) for a, b in zip(first[k], second[k]))

    def stacked(i):   # operand i of both directions, seeds stacked
        if cases[0][i][0] is None:
            return None, None
        return tuple(torch.stack([c[i][k] for c in cases]) for k in range(2))

    s_xp, s_wh, s_bh, s_h0, s_dys, s_dhl = (stacked(i) for i in range(6))
    s_res = gru_scan_stack_fwd_res(s_xp, s_wh, s_bh, s_h0, reset_after, "sigmoid")
    s_ys, s_rs = tuple(r[0] for r in s_res), tuple(r[1] for r in s_res)
    stack = gru_scan_stack_bwd(s_ys, s_rs, s_wh, s_h0, s_dys, s_dhl, reset_after, "sigmoid")
    torch.cuda.synchronize()
    for k in range(2):
        assert torch.equal(s_ys[k][0], ys[k]) and torch.equal(s_rs[k][0], res[k])
        assert all(torch.equal(a[0], b) for a, b in zip(stack[k], first[k]))


@pytest.mark.parametrize("B,T,H,offset", [(3, 50, 512, 1), (3, 50, 512, 0), (2, 200, 132, 0),
                                          (1, 4, 384, 0), (1, 4, 384, 1), (4, 33, 1024, 0),
                                          (1, 1, 520, 0), (2, 40, 129, 0)])
@pytest.mark.parametrize("reset_after", [False, True])
def test_dwh_dispatch_matches_plain(cuda, B, T, H, offset, reset_after):
    """csrc/gru_dwh.cu through its one entry, `gru_dwh_launch`, on a pair's
    operands: the body `gru_dwh_body` names is the Python mirror's
    (`dwh_body`); within 1e-4 of `gru_dwh_plain`'s largest entry, bitwise
    run to run. T = 1 and 4 put several sequence starts (h0's rows) in a
    chunk, T = 33 one that crosses chunks; operands one float off a 16-byte
    boundary (offset 1) go to the tile, whose 4-byte copies take them, as
    H = 129 does."""
    from sed_crnn_torch.ops.kernels import gru_scan as gs

    lib = gs._dwh_lib()
    gen = torch.Generator(device=cuda).manual_seed(B + T + H + offset)

    def placed(t):   # a copy of t that starts `offset` floats into its storage
        buf = torch.empty(t.numel() + offset, device=cuda)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view

    ops = [tuple(placed(t) for t in (
        torch.tanh(torch.randn((B, T, H), generator=gen, device=cuda)),
        torch.rand((B, T, gs.res_width(reset_after, H)), generator=gen, device=cuda),
        0.5 * torch.randn((B, H), generator=gen, device=cuda),
        torch.randn((B, T, 3 * H), generator=gen, device=cuda))) for _ in range(2)]
    n_part, n = lib.gru_dwh_splits(B, T, H), 3 * H * H + 3 * H
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for _ in range(2):
        part = torch.full((2, 1, n_part, n), float("nan"), device=cuda)
        sums = torch.empty((2, 1, n), device=cuda)
        arr = (gs._DwhDir * 2)(*(gs._DwhDir(y.data_ptr(), r.data_ptr(), h.data_ptr(),
                                            x.data_ptr(), part[k].data_ptr(), k)
                                 for k, (y, r, h, x) in enumerate(ops)))
        assert gs.DWH_BODIES[lib.gru_dwh_body(arr, 2, H)] == gs.dwh_body(H, offset == 0)
        gs._raise_on(lib.gru_dwh_launch(arr, 2, 1, B, T, H, int(reset_after), stream),
                     "gru_dwh", lib.gru_dwh_error_string)
        gs._raise_on(lib.gru_dwh_sum_partials(part.data_ptr(), sums.data_ptr(), 2, n_part, n,
                                              stream), "gru_dwh_sum", lib.gru_dwh_error_string)
        outs.append(sums)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    for k in range(2):
        want_dwh, want_dbh = gru_dwh_plain(*ops[k], reset_after, k == 1)
        torch.testing.assert_close(outs[0][k, 0, : 3 * H * H].view(H, 3 * H), want_dwh, rtol=0,
                                   atol=1e-4 * float(want_dwh.abs().max()))
        torch.testing.assert_close(outs[0][k, 0, 3 * H * H :], want_dbh, rtol=0,
                                   atol=1e-4 * max(float(want_dbh.abs().max()), 1e-6))


def test_dwh_bodies_build_without_spills(cuda, tmp_path):
    """csrc/gru_dwh.cu built as the port builds it (sm_90a): ptxas reports
    no spill in the wgmma body, whose consumers hold 64 + 64 accumulators
    and 32 A registers a thread under setmaxnreg, nor in either tile."""
    import subprocess

    from sed_crnn_torch.ops.kernels import _build

    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp_path / "libgru_dwh.so"),
         str(_build.CSRC_DIR / "gru_dwh.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=600)
    assert done.returncode == 0, done.stdout
    lines = done.stdout.splitlines()
    spills = {ln.rsplit(" ", 1)[-1]: lines[i + 1] for i, ln in enumerate(lines[:-1])
              if "Function properties for" in ln}
    bodies = {k: v for k, v in spills.items() if "gru_dwh_wgmma" in k or "gru_dwh_kernel" in k}
    assert sum("gru_dwh_wgmma" in k for k in bodies) == 1, spills
    assert sum("gru_dwh_kernel" in k for k in bodies) == 2, spills
    for name, line in bodies.items():
        assert "0 bytes spill stores, 0 bytes spill loads" in line, (name, line)


WIDE_WIDTHS =[33, 48, 64, 96, 128, 129, 256, 512, 520, 768, 1024, 1536, 2048]


@pytest.mark.parametrize("H", WIDE_WIDTHS)
@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("reset_after", [False, True])
@pytest.mark.parametrize("gate", ["sigmoid", "hard_sigmoid"])
def test_wide_body_pair_matches_plain(cuda, H, B, reset_after, gate):
    """The bodies above the warp body at every width they serve: the wide
    body's register tier (H <= 128), the cluster body (128 < H <= 512) and
    the grid body (above; resident to 1056, streamed at 1536 and 2048): a
    pair's forward, residual forward and backward against the plain
    versions of both directions (1e-5; gradients 1e-4 of each one's largest
    magnitude), the backward bitwise equal run to run, one launch of each
    kernel on the body `gru_body` names."""
    T = 64
    xp, wh, bh, h0, dys, dhl = _pair_case(cuda, B, T, H, reset_after, 700 + H + B)
    body = "wide" if H <= 128 else "cluster" if H <= 512 else "grid"
    assert gru_body(H) == gru_body(H, backward=True) == body
    before = (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
              gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches, gru_scan.wide_launches,
              gru_scan.cluster_launches, gru_scan.grid_launches)
    pair = gru_scan_pair(xp, wh, bh, h0, reset_after, gate)
    pair_res = gru_scan_pair_fwd_res(xp, wh, bh, h0, reset_after, gate)
    ys, res = tuple(r[0] for r in pair_res), tuple(r[1] for r in pair_res)
    first = gru_scan_pair_bwd(ys, res, wh, h0, dys, dhl, reset_after, gate)
    torch.cuda.synchronize()
    assert (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
            gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches, gru_scan.wide_launches,
            gru_scan.cluster_launches, gru_scan.grid_launches) == tuple(
                b + 1 for b in before[:5]) + tuple(
                before[5 + i] + 3 * (body == name) for i, name in
                enumerate(("wide", "cluster", "grid")))
    second = gru_scan_pair_bwd(ys, res, wh, h0, dys, dhl, reset_after, gate)
    for k, rev in enumerate((False, True)):
        conf = (reset_after, gate, rev)
        want = gru_scan_fwd_res_plain(xp[k], wh[k], bh[k], h0[k], *conf)
        for got, w in zip(pair_res[k], want):
            torch.testing.assert_close(got, w, rtol=0, atol=1e-5)
        assert torch.equal(pair[k][0], pair_res[k][0]) and torch.equal(pair[k][1], pair_res[k][2])
        want = gru_scan_bwd_plain(ys[k], res[k], wh[k], h0[k], dys[k], dhl[k], *conf)
        for got, w in zip(first[k], want):
            torch.testing.assert_close(got, w, rtol=0, atol=1e-4 * max(float(w.abs().max()), 1e-6))
        assert all(torch.equal(a, b) for a, b in zip(first[k], second[k]))


@pytest.mark.parametrize("H,ctas", [(129, 16), (256, 16), (256, 4)])
@pytest.mark.parametrize("reset_after", [False, True])
def test_cluster_body_gives_the_same_bits_at_every_cluster_size(cuda, H, ctas, reset_after):
    """The cluster body's sums run in an order that depends on H alone: a
    forced cluster size (the private launch's ``ctas``) gives the rule's
    bits, forward and backward chain; a cluster the body cannot launch (C = 4
    at H = 256 needs 512 threads a CTA) raises and runs nothing else."""
    xp, wh, bh, h0, dys, dhl = _gru_case(cuda, 8, 40, H, reset_after, 90 + H)
    conf = (reset_after, "sigmoid")
    if ctas == 4:
        with pytest.raises(RuntimeError, match="gru_cluster_fwd"):
            _fwd([xp], [wh], [bh], [h0], [False], *conf, True, "cluster", None, ctas)
        return
    outs = {}
    for c in (0, ctas):
        (fwd,), _ = _fwd([xp], [wh], [bh], [h0], [False], *conf, True, "cluster", None, c)
        (bwd,) = _bwd([fwd[0]], [fwd[1]], [wh], [h0], [dys], [dhl], [False], *conf, "cluster",
                      None, c)
        outs[c] = fwd + bwd
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[ctas]))


@pytest.mark.parametrize("H,B", [(520, 8), (1024, 1), (1024, 128), (2048, 8)])
@pytest.mark.parametrize("reset_after", [False, True])
def test_grid_body_gives_the_same_bits_at_every_k(cuda, H, B, reset_after):
    """The grid body's sums run in an order that depends on H alone: a pair
    at forced K (the private launch's ``ctas``: other units a CTA, another
    body or resident against streamed weights) gives the rule's bits,
    forward and backward chain; a grid the card cannot hold at once (a pair
    of 67 CTAs on 132 SMs) is refused by the cooperative launch and raises."""
    xp, wh, bh, h0, dys, dhl = _pair_case(cuda, B, 24, H, reset_after, 95 + H)
    conf = (reset_after, "sigmoid")
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    with pytest.raises(RuntimeError, match="gru_grid_fwd"):
        _fwd(xp, wh, bh, h0, (False, True), *conf, True, "grid", None, n_sms // 2 + 1)
    outs = {}
    for k in (0, 40, n_sms // 2):
        fwd, _ = _fwd(xp, wh, bh, h0, (False, True), *conf, True, "grid", None, k)
        bwd = _bwd(tuple(f[0] for f in fwd), tuple(f[1] for f in fwd), wh, h0, dys, dhl,
                   (False, True), *conf, "grid", None, k)
        outs[k] = [t for f, b in zip(fwd, bwd) for t in f + b]
    for k in (40, n_sms // 2):
        assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[k]))


@pytest.mark.parametrize("n_dir", [1, 2])
def test_grid_plan_refuses_what_a_cta_cannot_hold(cuda, n_dir):
    """The card's plan is the Python mirror's at the widest width of one
    block of 256 units a CTA on every CTA a direction gets, one unit wider
    (two blocks a CTA: nothing is refused for width any more), and at a
    forced K that leaves more than 256 units a CTA; that forced K walks its
    units in blocks and gives the rule's bits, forward and backward chain."""
    from sed_crnn_torch.ops.kernels.gru_scan import grid_plan, grid_plan_card

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    widest = sms // n_dir * 256
    for backward in (False, True):
        for H, k in ((widest, 0), (widest + 1, 0), (520, 2)):
            assert grid_plan_card(n_dir, 1, 8, H, backward, ctas=k) == grid_plan(
                n_dir, 1, 8, H, backward, ctas=k, sms=sms)
    xp, wh, bh, h0, dys, dhl = _gru_case(cuda, 3, 6, 520, True, 17)
    outs = {}
    for k in (0, 2):
        fwd, _ = _fwd([xp] * n_dir, [wh] * n_dir, [bh] * n_dir, [h0] * n_dir,
                      (False, True)[:n_dir], True, "sigmoid", True, "grid", None, k)
        bwd = _bwd([f[0] for f in fwd], [f[1] for f in fwd], [wh] * n_dir, [h0] * n_dir,
                   [dys] * n_dir, [dhl] * n_dir, (False, True)[:n_dir], True, "sigmoid", "grid",
                   None, k)
        outs[k] = [t for f, b in zip(fwd, bwd) for t in f + b]
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[2]))


@pytest.mark.parametrize("H", [8, 32])
def test_retained_body_still_matches_plain_at_warp_widths(cuda, H):
    """The private launchers put the wide and cluster bodies on a width the
    warp body takes (as chip_smoke.py times bodies side by side): same
    function."""
    xp, wh, bh, h0, dys, dhl = _gru_case(cuda, 4, 50, H, True, 11)
    outs = {}
    for body in ("warp", "wide", "cluster"):
        (fwd,), _ = _fwd([xp], [wh], [bh], [h0], [True], True, "sigmoid", True, body)
        (bwd,) = _bwd([fwd[0]], [fwd[1]], [wh], [h0], [dys], [dhl], [True], True, "sigmoid", body)
        outs[body] = fwd + bwd
    for other in ("wide", "cluster"):
        for a, b in zip(outs["warp"], outs[other]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(float(b.abs().max()), 1e-6))


@pytest.mark.parametrize("reset_after", [False, True])
def test_bigru_autograd_launches_one_pair_per_kernel(cuda, reset_after):
    """Autograd through a two-layer BiGRU stack on the card: per layer one
    pair residual forward, one pair backward (chain, dwh reduction, partial
    sum), none on the wide body; gradients as the CPU's plain versions."""
    gen = torch.Generator().manual_seed(3)
    layers = [BiGRU(10, 16, reset_after, "sigmoid"), BiGRU(32, 8, reset_after, "sigmoid")]
    for m in layers:
        m.init_parameters(gen)
    x = torch.randn(4, 64, 10, generator=gen)
    grads = {}
    for dev in ("cpu", "cuda"):
        ms = [BiGRU(10, 16, reset_after, "sigmoid"), BiGRU(32, 8, reset_after, "sigmoid")]
        for m, src in zip(ms, layers):
            m.load_state_dict(src.state_dict())
            m.to(dev)
        before = (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
                  gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches, gru_scan.wide_launches)
        h = x.to(dev)
        for m in ms:
            h, _ = m(h)
        params = [p for m in ms for p in m.parameters()]
        grads[dev] = torch.autograd.grad(h.square().sum(), params)
        after = (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
                 gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches, gru_scan.wide_launches)
        steps = tuple(a - b for a, b in zip(after, before))
        assert steps == ((0, 0, 0, 0, 0, 0) if dev == "cpu" else (0, 2, 2, 2, 2, 0))
    for g, w in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4 * float(w.abs().max()))


def _signal(n, sr, seed, silent=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    y = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(n)
    if silent:
        y[silent[0] : silent[1]] = 0.0
    return y.astype(np.float32)


@pytest.mark.parametrize("cfg", [
    FrontendConfig(sample_rate=16000, n_fft=256, hop_length=128, n_mels=16),
    FrontendConfig(),
    FrontendConfig(center=False),
    FrontendConfig(n_mels=128),
])
@pytest.mark.parametrize("log_floor", [None, 1e-10])
def test_logmel_kernel_matches_plain(cuda, cfg, log_floor):
    cfg = dataclasses.replace(cfg, log_floor=log_floor)
    y = torch.from_numpy(_signal(3 * cfg.sample_rate + 777, cfg.sample_rate, 1,
                                 silent=(cfg.sample_rate, 2 * cfg.sample_rate))).to(cuda)
    launches, cluster = fused_log_mel.launches, fused_log_mel.cluster_launches
    got = fused_log_mel(y, cfg)
    torch.cuda.synchronize()
    assert (fused_log_mel.launches, fused_log_mel.cluster_launches) == (launches + 1, cluster)
    want = fused_log_mel_plain(y, cfg)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    if log_floor is None:
        assert not bool(fin.all())
    torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=5e-4)


def _counts():
    return (fused_log_mel.launches, fused_log_mel.framed_launches, fused_log_mel.exact_launches,
            fused_log_mel.mixed_launches, fused_log_mel.cluster_launches)


def _assert_logmel_close(got, want):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=5e-4)


@pytest.mark.parametrize("n_fft,hop,mode", [
    (1024, 1024, "dif"), (4096, 1024, "dif"), (2048, 512, "dif"), (2048, 1024, "exact"),
    (1034, 517, "dif"), (4096, 1024, "exact"), (1024, 441, "dif"),
])
@pytest.mark.parametrize("center,n", [(True, 3 * 44100 + 777), (False, 3 * 44100 + 777),
                                      (True, 1500)])
@pytest.mark.parametrize("log_floor", [None, 1e-10])
def test_framed_and_exact_kernels_match_plain(cuda, n_fft, hop, mode, center, n, log_floor):
    """The framed DIF route (stride hop on the padded waveform) and the
    direct route against their plain versions: ragged lengths, a silent
    stretch, short signals (centred), an unaligned hop (scalar loads), each
    launch counted on its route and, at n_fft 1034, on the mixed body."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=center, log_floor=log_floor)
    y = torch.from_numpy(_signal(n, 44100, 2, silent=(44100 // 2, 44100) if n > 44100 else None))
    y = y.to(cuda)
    r = route(n, cfg, mode)
    before = _counts()
    got = fused_log_mel(y, cfg, mode)
    torch.cuda.synchronize()
    want = fused_log_mel_plain(y, cfg, mode)
    after = list(before)
    after[("chunked", "framed", "exact").index(r)] += 1
    after[3] += body(n_fft) == "mixed"
    assert _counts() == tuple(after)
    assert got.shape[0] == 1 + (n + (n_fft if center else 0) - n_fft) // hop
    _assert_logmel_close(got, want)


@pytest.mark.parametrize("n_fft,hop,mode", [(2048, 1024, "dif"), (1024, 1024, "dif"),
                                            (4096, 1024, "dif"), (2048, 1024, "exact"),
                                            (1034, 517, "dif")])
def test_frame_matrix_kernel_matches_plain(cuda, n_fft, hop, mode):
    """Stride n_fft on a materialized frame matrix; for hop == n_fft / 2 it
    equals the chunked route (stride M on the waveform) bit for bit."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, log_floor=1e-10)
    y = torch.from_numpy(_signal(2 * 44100 + 123, 44100, 3)).to(cuda)
    frames = frame_signal(y, n_fft, hop, center=True).contiguous()
    got = fused_log_mel_frames(frames, cfg, mode)
    torch.cuda.synchronize()
    _assert_logmel_close(got, fused_log_mel_frames_plain(frames, cfg, mode))
    if route(y.shape[0], cfg, mode) == "chunked":
        assert torch.equal(got, fused_log_mel(y, cfg, mode))


LOGMEL_SHAPES = [
    (dict(sample_rate=16000, n_fft=256, hop_length=128, n_mels=16), True),
    (dict(), True), (dict(), False), (dict(n_mels=128), True),
    (dict(n_fft=1024, hop_length=1024), True), (dict(n_fft=4096, hop_length=1024), False),
    (dict(n_fft=2048, hop_length=512), True), (dict(n_fft=1024, hop_length=441), True),
    (dict(n_fft=1024, hop_length=441), False), (dict(n_fft=16384, hop_length=4096), True),
]


@pytest.mark.parametrize("kw,center", LOGMEL_SHAPES)
@pytest.mark.parametrize("log_floor", [None, 1e-10])
def test_fft_kernel_matches_fft_plain_and_is_deterministic(cuda, kw, center, log_floor):
    """The FFT body against `fft_log_mel_plain` (the same float32
    operations, only the log differs), bitwise equal across two runs, and
    launched as the fft body."""
    cfg = FrontendConfig(center=center, log_floor=log_floor, **kw)
    sr = cfg.sample_rate
    y = torch.from_numpy(_signal(3 * sr + 777, sr, 4, silent=(sr, 2 * sr))).to(cuda)
    assert body(cfg.n_fft) == "fft"
    before = _counts()
    first = fused_log_mel(y, cfg)
    second = fused_log_mel(y, cfg)
    torch.cuda.synchronize()
    assert _counts()[3:] == before[3:]
    assert torch.equal(first, second)
    _assert_logmel_close(first, fused_log_mel_plain(y, cfg))
    want = fft_log_mel_plain(y, cfg)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(first), fin)
    torch.testing.assert_close(first[fin], want[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_fft,hop,other", [
    (32768, 8192, "mixed"), (1000, 500, "mixed"), (3072, 1024, "mixed"),
    (12865, 6432, "mixed"), (23042, 11521, "mixed"), (12867, 6433, "mixed"),
    (23044, 11522, "mixed"), (23054, 11527, "mixed"), (25734, 12867, "cluster"),
    (31290, 15645, "cluster"),
])
def test_other_sizes_launch_the_dft_body(cuda, n_fft, hop, other):
    """Above 16384 or not a power of two: the mixed body up to its
    shared-memory limit, the cluster body (which took the retired dft
    body's sizes) beyond it, each counted once, and within its band of the
    plain version."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, log_floor=1e-10)
    y = torch.from_numpy(_signal(3 * 44100, 44100, 5)).to(cuda)
    assert body(n_fft) == other
    before = _counts()
    got = fused_log_mel(y, cfg)
    torch.cuda.synchronize()
    assert (_counts()[3] - before[3], _counts()[4] - before[4]) == (
        (1, 0) if other == "mixed" else (0, 1))
    _assert_logmel_close(got, fused_log_mel_plain(y, cfg))


def test_both_bodies_agree_at_a_power_of_two(cuda):
    """The mixed body and the cluster body, launched through their private
    launchers at a size the fft body takes, compute the same function: the
    cluster body bitwise the mixed body's, both within 5e-4 of the FFT
    body."""
    cfg = FrontendConfig(n_fft=4096, hop_length=1024, center=False, log_floor=1e-10)
    y = torch.from_numpy(_signal(3 * 44100, 44100, 6)).to(cuda)
    n_frames = 1 + (y.shape[0] - 4096) // 1024
    fft = _launch_fft(y, 1024, n_frames, 4096, cfg)
    mixed = _launch_mixed(y, 1024, n_frames, 4096, cfg)
    cluster = _launch_cluster(y, 1024, n_frames, 4096, cfg, ctas=2)
    torch.cuda.synchronize()
    assert torch.equal(cluster, mixed)
    _assert_logmel_close(fft, mixed)


# The mixed body's shapes: chip_smoke.py's (1034: 11 and a matrix stage of
# 47; direct 1764 and 3072; 1001: 7, 11, 13), 25 ms at 16 kHz, an odd direct
# plan (1575), 2050 (5, 5 and a matrix stage of 41), the largest plans (n_fft
# 32768 direct, 1,024 threads a frame; 22000 direct with radix 11, 132 KB of
# shared memory), matrix stages of 19 and 29 (1102), of 31 and 83 (12865),
# Rader stages (2206 and 1103: L 1103 prime, over 2 x 19 x 29; 12867: 3, and
# 4289 over 4 x 4 x 4 x 67; 23054: L 11527 over 2 x 3 x 17 x 113) and a
# Bluestein plan (4126, L 2063 prime, 2062 = 2 x 1031).
MIXED_SHAPES = [
    dict(n_fft=1034, hop_length=517), dict(n_fft=1764, hop_length=882),
    dict(n_fft=3072, hop_length=1024), dict(n_fft=1001, hop_length=500),
    dict(sample_rate=16000, n_fft=400, hop_length=160), dict(n_fft=1575, hop_length=700),
    dict(n_fft=2050, hop_length=1024), dict(n_fft=32768, hop_length=8192),
    dict(n_fft=22000, hop_length=11000), dict(n_fft=1102, hop_length=551),
    dict(n_fft=12865, hop_length=6432), dict(n_fft=2206, hop_length=1103),
    dict(n_fft=1103, hop_length=551), dict(n_fft=12867, hop_length=6433),
    dict(n_fft=23054, hop_length=11527), dict(n_fft=4126, hop_length=2063),
    dict(n_fft=12895, hop_length=6447),
]
# A plan with matrix stages against `mixed_log_mel_plain` (chip_smoke.py's
# MATRIX_ATOL): three TF32 products are not float32's bits. Their error is
# float32's against a frame's largest outputs, so the log-domain tolerance
# holds for bands that are not far below the frame's largest: at the small
# frames of the matrix stage's forms, the bands of at least
# MATRIX_BAND_FLOOR of it.
MATRIX_ATOL = 1e-4
MATRIX_BAND_FLOOR = 1e-2


def _assert_plain(got, plain, n_fft):
    """Bitwise the plain version, or within MATRIX_ATOL with matrix stages
    (a Rader stage's inner ones too) and the same -inf entries."""
    if not mixed_plan(n_fft).tensor_cores:
        assert torch.equal(got, plain)
        return
    fin = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], plain[~fin])
    torch.testing.assert_close(got[fin], plain[fin], rtol=0, atol=MATRIX_ATOL)


@pytest.mark.parametrize("kw", MIXED_SHAPES)
@pytest.mark.parametrize("center,n", [(True, 3 * 44100 + 777), (False, 3 * 44100 + 777),
                                      (True, 1500)])
@pytest.mark.parametrize("log_floor", [None, 1e-10])
def test_mixed_kernel_matches_its_plain_version_bitwise(cuda, kw, center, n, log_floor):
    """The mixed body against `mixed_log_mel_plain` bit for bit (within
    MATRIX_ATOL with matrix stages), twice bitwise equal, one mixed launch
    per call and no cluster launch, and within 5e-4 of the DIF / direct
    plain version (torch's FFT + mel above n_fft 4096); a silent stretch
    gives the same -inf rows."""
    cfg = FrontendConfig(center=center, log_floor=log_floor, **kw)
    sr = cfg.sample_rate
    y = torch.from_numpy(_signal(n, sr, 7, silent=(sr // 2, sr) if n > sr else None)).to(cuda)
    assert body(cfg.n_fft) == "mixed"
    before = _counts()
    first = fused_log_mel(y, cfg)
    second = fused_log_mel(y, cfg)
    torch.cuda.synchronize()
    assert (_counts()[3] - before[3], _counts()[4] - before[4]) == (2, 0)
    assert torch.equal(first, second)
    _assert_plain(first, mixed_log_mel_plain(y, cfg), cfg.n_fft)
    if cfg.n_fft <= 4096:
        _assert_logmel_close(first, fused_log_mel_plain(y, cfg))
    else:
        _assert_logmel_close(first, _fft_log_mel64(y, cfg))


@pytest.mark.parametrize("kw", MIXED_SHAPES[:4])
def test_mixed_kernel_on_a_frame_matrix(cuda, kw):
    """Stride n_fft on a materialized frame matrix: the waveform's rows bit
    for bit, counted on the framed or exact route and on the mixed body."""
    cfg = FrontendConfig(log_floor=1e-10, **kw)
    y = torch.from_numpy(_signal(2 * 44100 + 123, 44100, 8)).to(cuda)
    frames = frame_signal(y, cfg.n_fft, cfg.hop_length, center=True).contiguous()
    before = _counts()
    got = fused_log_mel_frames(frames, cfg)
    torch.cuda.synchronize()
    assert _counts()[3] == before[3] + 1
    assert torch.equal(got, fused_log_mel(y, cfg))
    _assert_plain(got, mixed_log_mel_plain(frames, cfg), cfg.n_fft)
    _assert_logmel_close(got, fused_log_mel_frames_plain(frames, cfg))


def test_mixed_launcher_refuses_a_plan_over_the_limit(cuda):
    """A plan whose frame takes more than 227 KB of shared memory is refused
    by the launcher, which raises its error: nothing falls back (12941:
    every plan of it beyond one block)."""
    cfg = FrontendConfig(n_fft=12941, hop_length=6470, center=False)
    assert mixed_plan(12941).smem_bytes > MIXED_MAX_SMEM
    y = torch.zeros(4 * 12941, device=cuda)
    before = _counts()
    with pytest.raises(RuntimeError, match="logmel_mixed launch failed"):
        _launch_mixed(y, 6470, 2, 12941, cfg)
    assert _counts() == before


def _fft_log_mel64(y, cfg):
    """The library's log-mel in float64 on the card: frames as the kernel
    cuts them (`frame_source`), windowed, each one complex transform
    (`torch.fft.fft`; cuFFT's batched real-to-complex transform at an odd
    n_fft leaks a neighbouring frame's rounding into an all-zero frame),
    power, mel, floor, log; an independent reference at sizes whose plain
    bases would not fit."""
    src, _ = frame_source(y, cfg)
    window = torch.from_numpy(hann_window(cfg.n_fft, np.float64)).to(y.device)
    fb = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                                         cfg.fmax, np.float64)).to(y.device)
    frames = src.double().unfold(0, cfg.n_fft, cfg.hop_length) * window
    spec = torch.fft.fft(frames.to(torch.complex128))[:, : cfg.n_fft // 2 + 1]
    mel = spec.abs().square() @ fb.T
    if cfg.log_floor is not None:
        mel = torch.clamp_min(mel, cfg.log_floor)
    return torch.log(mel).float()


# The matrix stage's forms (`matrix_stage` in csrc/logmel_stages.cuh), each
# radix alone or nearly so in a forced plan: 17, 23, 31 (one or two column
# tiles, warp by warp), 373 (24 tiles: the A operands shared, two bands)
# and 647 (41 tiles, four bands) as the only stage (n_fft 2 R), 373 after a
# radix-3 stage (2238), and 373 in a Rader stage's inner transforms, forward
# and transposed (4478: L 2239, 2238 = 2 x 3 x 373).
MATRIX_FORMS = [(34, "direct", 17), (46, "direct", 23), (62, "direct", 31),
                (746, "direct", 373), (1294, "direct", 647), (2238, "direct", 373),
                (4478, "rader", 373)]


@pytest.mark.parametrize("n_fft,kind,radix", MATRIX_FORMS)
def test_matrix_stage_forms_match_plain_on_both_bodies(cuda, n_fft, kind, radix):
    """Each form of the matrix stage in the mixed body against
    `mixed_log_mel_plain` (-inf entries equal; mel energies within 1e-5 of
    the frame's largest, and within MATRIX_ATOL in the log domain at every
    band of at least MATRIX_BAND_FLOOR of the frame's largest: three TF32
    products hold float32's precision against a frame's largest outputs,
    so a weaker band of these small frames, one bin wide, can be further
    off in the log domain, 1.1e-4 at n_fft 46), twice bitwise, and the
    cluster body forced to the same plan over 1, 2, 3, 4 and 8 CTAs bitwise
    the mixed body's (the butterflies split otherwise, and crossing
    CTAs)."""
    plan = mixed_plan(n_fft, kind)
    assert radix in plan.matrix + plan.rader_matrix
    cfg = FrontendConfig(n_fft=n_fft, hop_length=n_fft // 2, center=False, log_floor=None)
    y = torch.from_numpy(_signal(2 * 44100, 44100, 12, silent=(20000, 30000))).to(cuda)
    src, n_frames = frame_source(y, cfg)
    got = _launch_mixed(src, n_fft // 2, n_frames, n_fft, cfg, plan=kind)
    again = _launch_mixed(src, n_fft // 2, n_frames, n_fft, cfg, plan=kind)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    plain = mixed_log_mel_plain(y, cfg, plan=kind)
    fin = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], plain[~fin])
    e_got, e_plain = got.double().exp(), plain.double().exp()
    largest = e_plain.amax(1, keepdim=True)
    assert ((e_got - e_plain).abs() <= 1e-5 * largest).all()
    strong = e_plain >= MATRIX_BAND_FLOOR * largest
    assert strong.sum() >= n_frames
    torch.testing.assert_close(got[strong], plain[strong], rtol=0, atol=MATRIX_ATOL)
    for c in (1, 2, 3, 4, 8):
        cluster = _launch_cluster(src, n_fft // 2, n_frames, n_fft, cfg, ctas=c, plan=kind)
        assert torch.equal(cluster, got), c


# The cluster body's sizes (n_fft, hop): L 12867 at an even n_fft (25734:
# a Rader stage of 4289 over 4 x 4 x 4 x 67 under `plan_cost`'s refitted
# weights), a matrix stage of 17 before a Rader stage of 757 (25738), a matrix
# stage of 149 (31290), an odd size beyond the mixed body's limit (12941,
# Bluestein on radices 8 and 9), 1 s at 44.1 and 48 kHz (direct, C = 2), 2
# s at 44.1 kHz (C = 3), a power of two (C = 4), a direct plan with radix
# 11 (44000, L 22000), and 21599 (Bluestein at M 43,200).
CLUSTER_SHAPES = [(25734, 12867), (25738, 12869), (31290, 15645), (12941, 6470),
                  (44100, 22050), (48000, 24000), (88200, 44100), (131072, 32768),
                  (44000, 22000), (21599, 10799)]


@pytest.mark.parametrize("n_fft,hop", CLUSTER_SHAPES)
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("log_floor", [None, 1e-10])
def test_cluster_kernel_matches_its_plain_version_bitwise(cuda, n_fft, hop, center, log_floor):
    """The cluster body through `fused_log_mel` against `mixed_log_mel_plain`
    bit for bit (within MATRIX_ATOL with matrix stages), twice bitwise, one
    cluster launch per call and no mixed launch, and
    within 5e-4 of torch's FFT + mel in float64 with the same -inf rows (a
    silent stretch of two frames' length)."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=center, log_floor=log_floor)
    y = torch.from_numpy(_signal(3 * n_fft + 777, 44100, 9, silent=(n_fft, 3 * n_fft))).to(cuda)
    assert body(n_fft) == "cluster"
    before = _counts()
    first = fused_log_mel(y, cfg)
    second = fused_log_mel(y, cfg)
    torch.cuda.synchronize()
    assert (_counts()[3] - before[3], _counts()[4] - before[4]) == (0, 2)
    assert torch.equal(first, second)
    _assert_plain(first, mixed_log_mel_plain(y, cfg), n_fft)
    _assert_logmel_close(first, _fft_log_mel64(y, cfg))
    assert bool(torch.isinf(first).any()) == (log_floor is None)


@pytest.mark.parametrize("n_fft,hop,ctas", [(25734, 12867, (2, 3, 4, 5, 8, 16)),
                                            (31290, 15645, (2, 3, 4, 8)),
                                            (44100, 22050, (2, 3, 4, 7, 9)),
                                            (88200, 44100, (3, 4, 6, 12)),
                                            (44000, 22000, (2, 3, 5))])
def test_cluster_kernel_bits_do_not_depend_on_the_cluster_size(cuda, n_fft, hop, ctas):
    """The same frames split over every cluster size tried give the same
    bits as the default split: the stages that cross CTAs change (at 44100
    over 4 CTAs, which do not divide N, all 7 do), the operations do not."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
    y = torch.from_numpy(_signal(5 * n_fft, 44100, 10)).to(cuda)
    src, n_frames = frame_source(y, cfg)
    want = fused_log_mel(y, cfg)
    for c in ctas:
        assert torch.equal(_launch_cluster(src, hop, n_frames, n_fft, cfg, ctas=c), want), c


@pytest.mark.parametrize("kw", MIXED_SHAPES[:4] + MIXED_SHAPES[12:15])
@pytest.mark.parametrize("ctas", [1, 2, 3, 4, 8])
def test_cluster_kernel_forced_small_is_the_mixed_body(cuda, kw, ctas):
    """The mixed body's shapes forced onto the cluster body, one frame split
    over 1 to 8 CTAs (3 and 8 do not divide every transform length, so
    nearly every stage crosses CTAs there): bitwise the mixed body's, and
    the plain version's (within MATRIX_ATOL with matrix stages). Plans with
    a matrix stage (1034) or a Rader stage (1103, 12867, 23054) run too, and
    where such a plan's Bluestein plan fits one block (1034, 1103) that plan
    runs forced, bitwise the mixed body's and the plain version's."""
    cfg = FrontendConfig(center=False, log_floor=None, **kw)
    y = torch.from_numpy(_signal(2 * 44100, 44100, 11, silent=(20000, 30000))).to(cuda)
    src, n_frames = frame_source(y, cfg)
    got = _launch_cluster(src, cfg.hop_length, n_frames, cfg.n_fft, cfg, ctas=ctas)
    assert torch.equal(got, _launch_mixed(src, cfg.hop_length, n_frames, cfg.n_fft, cfg))
    _assert_plain(got, mixed_log_mel_plain(y, cfg), cfg.n_fft)
    if mixed_plan(cfg.n_fft).tensor_cores and (
            mixed_plan(cfg.n_fft, "bluestein").smem_bytes <= MIXED_MAX_SMEM):
        blue = _launch_cluster(src, cfg.hop_length, n_frames, cfg.n_fft, cfg, ctas=ctas,
                               plan="bluestein")
        assert torch.equal(blue, _launch_mixed(src, cfg.hop_length, n_frames, cfg.n_fft, cfg,
                                               plan="bluestein"))
        assert torch.equal(blue, mixed_log_mel_plain(y, cfg, plan="bluestein"))


# A register-only plan (44100: bitwise the plain version) and a Rader plan
# with matrix stages inside (23201: L prime, 23200 over 4 x 4 x 2 x 5 x 5 x
# 29; within MATRIX_ATOL), each with the launch counts of its route on a
# frame matrix (framed: n_fft % 4 == 0; exact otherwise) and the cluster
# body.
CLUSTER_ROUTES = [(44100, 22050, [0, 1, 0, 0, 1]), (23201, 11600, [0, 0, 1, 0, 1])]


@pytest.mark.parametrize("n_fft,hop,counts", CLUSTER_ROUTES)
def test_cluster_kernel_on_a_frame_matrix(cuda, n_fft, hop, counts):
    """Stride n_fft on a frame matrix: the waveform's rows bit for bit,
    counted on the route and the cluster body, and the plain version's bit
    for bit at 44100 (within MATRIX_ATOL at 23201)."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, log_floor=1e-10)
    assert body(n_fft) == "cluster" and mixed_plan(n_fft).tensor_cores == (n_fft == 23201)
    y = torch.from_numpy(_signal(5 * n_fft, 44100, 12)).to(cuda)
    frames = frame_signal(y, cfg.n_fft, cfg.hop_length, center=True).contiguous()
    before = _counts()
    got = fused_log_mel_frames(frames, cfg)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == counts
    assert torch.equal(got, fused_log_mel(y, cfg))
    if n_fft == 44100:
        assert torch.equal(got, mixed_log_mel_plain(frames, cfg))
    else:
        _assert_plain(got, mixed_log_mel_plain(frames, cfg), n_fft)


@pytest.mark.parametrize("n_fft,hop", [(44100, 22050), (23201, 11600)])
def test_cluster_kernel_takes_more_than_256_mels(cuda, n_fft, hop):
    """No body limits the mel count (the retired dft body's 256): 300 mels,
    bitwise the plain version's at 44100 (a register-only plan), within
    MATRIX_ATOL at 23201 (a Rader stage with matrix stages inside)."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, n_mels=300, log_floor=1e-10)
    assert body(n_fft) == "cluster" and mixed_plan(n_fft).tensor_cores == (n_fft == 23201)
    y = torch.from_numpy(_signal(4 * n_fft, 44100, 13)).to(cuda)
    got = fused_log_mel(y, cfg)
    assert got.shape[1] == 300
    if n_fft == 44100:
        assert torch.equal(got, mixed_log_mel_plain(y, cfg))
    else:
        _assert_plain(got, mixed_log_mel_plain(y, cfg), n_fft)


def test_card_holds_the_largest_cluster_at_full_shared_memory(cuda):
    """Every cluster size the body may pick, up to CLUSTER_MAX, fits on the
    card at 1,024 threads and 227 KB of shared memory a CTA: the body's
    limit stands as `body` states it."""
    assert cluster_size(617400) == CLUSTER_MAX
    assert [c for c in range(1, CLUSTER_MAX + 1) if cluster_resident(c) < 1] == []


# Nested Rader plans (forced), each in one block: 2579, 4126, 12895, 12899
# (each Rader prime's p - 1 has a prime above MATRIX_MAX), 23158 (L 11579,
# 11578 = 2 x 7 x 827, 826 = 2 x 7 x 59) and 1034 (L 11 x 47, 46 = 2 x 23,
# 22 = 2 x 11: register stages only).
NESTED_SHAPES = [(2579, 1289), (4126, 2063), (12895, 6447), (12899, 6449), (23158, 11579),
                 (1034, 517)]


@pytest.mark.parametrize("n_fft,hop", NESTED_SHAPES)
def test_nested_plans_match_their_plain_versions(cuda, n_fft, hop):
    """The nested plan forced on the mixed body: against
    `mixed_log_mel_plain` forced alike (within MATRIX_ATOL: its nested
    stage's matrix stages; bitwise without them) with the same -inf rows,
    twice bitwise, within 5e-4 of torch's FFT + mel in float64; the cluster
    body refuses it (it runs no nested stage) and launches nothing."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=None)
    y = torch.from_numpy(_signal(6 * hop + n_fft, 44100, 12, silent=(n_fft, 2 * n_fft))).to(cuda)
    src, n_frames = frame_source(y, cfg)
    plan = mixed_plan(n_fft, "nested")
    assert plan.nested and plan.smem_bytes <= MIXED_MAX_SMEM
    first = _launch_mixed(src, hop, n_frames, n_fft, cfg, plan="nested")
    assert torch.equal(first, _launch_mixed(src, hop, n_frames, n_fft, cfg, plan="nested"))
    plain = mixed_log_mel_plain(y, cfg, plan="nested")
    fin = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(first), fin) and torch.equal(first[~fin], plain[~fin])
    if plan.tensor_cores:
        torch.testing.assert_close(first[fin], plain[fin], rtol=0, atol=MATRIX_ATOL)
    else:
        assert torch.equal(first, plain)
    _assert_logmel_close(first, _fft_log_mel64(y, cfg))
    before = _counts()
    with pytest.raises(ValueError, match="runs no nested Rader stage"):
        _launch_cluster(src, hop, n_frames, n_fft, cfg, ctas=2, plan="nested")
    assert _counts() == before


# Plans on the composite radices: Bluestein at 12895 (M 25,920 = 8 x 8 x 9
# x 9 x 5, the cluster body), 2579 (M 5,184, one block) and 21599 (M
# 43,200 = 8 x 8 x 9 x 3 x 5 x 5); direct at 1764 (L 882 = 2 x 9 x 7 x 7)
# and 3072 (L 1536 = 8 x 8 x 8 x 3), and radix 16 in 12899's nested stage
# (6448 = 16 x 13 x 31).
COMPOSITE_SHAPES = [(12895, 6447, "bluestein"), (2579, 1289, "bluestein"),
                    (21599, 10799, "bluestein"), (1764, 882, None), (3072, 1024, None),
                    (12899, 6449, "nested")]


@pytest.mark.parametrize("n_fft,hop,plan", COMPOSITE_SHAPES)
def test_composite_radices_match_their_plain_versions(cuda, n_fft, hop, plan):
    """Radices 8, 9 and 16 on both bodies: bitwise the plain version (within
    MATRIX_ATOL with a matrix stage), twice bitwise, the same bits on the
    cluster body at 2 and 4 CTAs (but for the nested plan, which it does not
    run)."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
    y = torch.from_numpy(_signal(6 * hop + n_fft, 44100, 13)).to(cuda)
    src, n_frames = frame_source(y, cfg)
    mp = mixed_plan(n_fft, plan)
    assert set(mp.radices + mp.rader + mp.nested) & {8, 9, 16}
    launch = _launch_mixed if mp.smem_bytes <= MIXED_MAX_SMEM else _launch_cluster
    first = launch(src, hop, n_frames, n_fft, cfg, plan=plan)
    assert torch.equal(first, launch(src, hop, n_frames, n_fft, cfg, plan=plan))
    plain = mixed_log_mel_plain(y, cfg, plan=plan)
    if mp.tensor_cores:
        torch.testing.assert_close(first, plain, rtol=0, atol=MATRIX_ATOL)
    else:
        assert torch.equal(first, plain)
    for c in (() if mp.nested else (2, 4)):
        assert torch.equal(_launch_cluster(src, hop, n_frames, n_fft, cfg, ctas=c, plan=plan),
                           first), c


def test_cluster_body_beyond_its_limit_raises(cuda):
    """n_fft 206,215, the first plan that 16 CTAs do not hold, raises a
    ValueError naming the limit, launches nothing, and falls back to
    nothing; so does a split the launcher refuses (25734 on one CTA)."""
    y = torch.zeros(2 * 206215, device=cuda)
    before = _counts()
    with pytest.raises(ValueError, match="beyond the cluster body's limit"):
        fused_log_mel(y, FrontendConfig(n_fft=206215, hop_length=103107, center=False))
    with pytest.raises(RuntimeError, match="logmel_cluster launch failed"):
        _launch_cluster(y, 12867, 2, 25734, FrontendConfig(n_fft=25734, hop_length=12867),
                        ctas=1)
    assert _counts() == before


@pytest.mark.parametrize("n_fft,hop,ctas", [(25734, 12867, 2), (88200, 44100, 3)])
def test_cluster_launcher_checks_the_split_it_is_given(cuda, monkeypatch, n_fft, hop, ctas):
    """The launcher takes `cluster_split`'s split and checks it: a crossing
    stage marked as inside the CTAs, a chunk that leaves points uncovered
    or a share over 227 KB is refused (no launch counted); every stage
    marked crossing is allowed and gives the same bits."""
    import sed_crnn_torch.ops.kernels.fused_logmel as fl

    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
    src, n_frames = frame_source(torch.from_numpy(_signal(n_fft + 3 * hop, 44100, 5)).to(cuda), cfg)
    want = _launch_cluster(src, hop, n_frames, n_fft, cfg, ctas=ctas)
    sp = cluster_split(n_fft, ctas)
    assert any(sp.cross)
    bad = (sp._replace(cross=(False,) * len(sp.cross)),
           sp._replace(chunk=sp.chunk - 1),
           sp._replace(chunk=sp.chunk + 30000, smem_bytes=sp.smem_bytes + 240000))
    for split in bad:
        monkeypatch.setattr(fl, "split_plan", lambda mp, c, split=split: split)
        before = _counts()
        with pytest.raises(RuntimeError, match="logmel_cluster launch failed"):
            _launch_cluster(src, hop, n_frames, n_fft, cfg, ctas=ctas)
        assert _counts() == before
    every = sp._replace(cross=(True,) * len(sp.cross))
    monkeypatch.setattr(fl, "split_plan", lambda mp, c: every)
    assert torch.equal(_launch_cluster(src, hop, n_frames, n_fft, cfg, ctas=ctas), want)


def test_logmel_kernel_rejects_bad_inputs(cuda):
    with pytest.raises(TypeError):
        fused_log_mel(torch.zeros(8192, device=cuda, dtype=torch.float64), FrontendConfig())
    with pytest.raises(ValueError):
        fused_log_mel(torch.zeros(100, device=cuda), FrontendConfig(center=False))
    with pytest.raises(ValueError):
        fused_log_mel_frames(torch.zeros(4, 2048, device=cuda), FrontendConfig(), "bf16x3")


@pytest.mark.parametrize("S,B,T,H",
                         [(1, 128, 8, 16), (3, 128, 8, 8), (5, 9, 8, 16), (2, 33, 256, 32),
                          (5, 128, 16, 64), (3, 9, 20, 48), (2, 5, 12, 160)])
@pytest.mark.parametrize("reset_after", [False, True])
def test_gru_stack_launches_once_for_every_seed(cuda, S, B, T, H, reset_after):
    """Kernel B with a seed axis: S BiGRUs' forward, residual forward and
    backward each in one launch (grid.y = 2S), against the
    plain versions seed by seed (1e-5; gradients 1e-4 of each one's largest
    magnitude); dwh bitwise equal from run to run; seed s of the stack is
    bitwise the unstacked pair on seed s's operands."""
    cases = [_pair_case(cuda, B, T, H, reset_after, 300 + 10 * s + H) for s in range(S)]

    def stacked(i):   # operand i of both directions, seeds stacked
        if cases[0][i][0] is None:
            return None, None
        return tuple(torch.stack([c[i][k] for c in cases]) for k in range(2))

    xp, wh, bh, h0, dys, dhl = (stacked(i) for i in range(6))
    before = (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
              gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches, gru_scan.wide_launches)
    fwd = gru_scan_stack(xp, wh, bh, h0, reset_after, "sigmoid")
    res = gru_scan_stack_fwd_res(xp, wh, bh, h0, reset_after, "sigmoid")
    ys, rs = tuple(r[0] for r in res), tuple(r[1] for r in res)
    first = gru_scan_stack_bwd(ys, rs, wh, h0, dys, dhl, reset_after, "sigmoid")
    torch.cuda.synchronize()
    assert (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
            gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches,
            gru_scan.wide_launches) == tuple(b + 1 for b in before[:5]) + (
        before[5] + 3 * (gru_body(H) == "wide"),)
    second = gru_scan_stack_bwd(ys, rs, wh, h0, dys, dhl, reset_after, "sigmoid")
    for k, rev in enumerate((False, True)):
        assert all(torch.equal(a, b) for a, b in zip(first[k], second[k]))
        for s in range(S):
            args = (xp[k][s], wh[k][s], None if bh[k] is None else bh[k][s], h0[k][s])
            want = gru_scan_fwd_res_plain(*args, reset_after, "sigmoid", rev)
            for got, w in zip(res[k], want):
                torch.testing.assert_close(got[s], w, rtol=0, atol=1e-5)
            assert torch.equal(fwd[k][0][s], res[k][0][s]) and torch.equal(fwd[k][1][s],
                                                                            res[k][2][s])
            want = gru_scan_bwd_plain(ys[k][s], rs[k][s], wh[k][s], h0[k][s], dys[k][s],
                                      dhl[k][s], reset_after, "sigmoid", rev)
            for got, w in zip(first[k], want):
                torch.testing.assert_close(got[s], w, rtol=0,
                                           atol=1e-4 * max(float(w.abs().max()), 1e-6))
    for s in range(S):
        one = lambda t: tuple(None if a is None else a[s] for a in t)  # noqa: E731
        pair = gru_scan_pair_fwd_res(one(xp), one(wh), one(bh), one(h0), reset_after, "sigmoid")
        for k in range(2):
            assert all(torch.equal(a, b[s]) for a, b in zip(pair[k], res[k]))
