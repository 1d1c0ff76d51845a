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
operations, so only ``logf`` against ``torch.log`` differs).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels.fused_logmel import (
    _launch_dft,
    _launch_fft,
    body,
    fft_log_mel_plain,
    fused_log_mel,
    fused_log_mel_frames,
    fused_log_mel_frames_plain,
    fused_log_mel_plain,
    route,
)
from sed_crnn_torch.ops.stft import frame_signal
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


# H <= 32 runs the warp body (csrc/gru_warp.cu), H=64 the retained one.
GRU_SHAPES = [(1, 1, 4), (3, 7, 8), (7, 45, 16), (5, 300, 32), (2, 20, 64)]


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
    launches, retained = gru_scan.launches, gru_scan.retained_launches
    ys, hl = gru_scan(xp, wh, bh, h0, reset_after, gate, reverse)
    torch.cuda.synchronize()
    assert gru_scan.launches == launches + 1
    assert gru_scan.retained_launches == retained + (gru_body(H) == "retained")
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
    n_dwh, n_retained = gru_scan_bwd.dwh_launches, gru_scan.retained_launches
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
    warp = gru_body(H) == "warp"
    assert gru_scan_bwd.dwh_launches == n_dwh + warp
    assert gru_scan.retained_launches == n_retained + 3 * (not warp)  # fwd_res, fwd, bwd


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


@pytest.mark.parametrize("B,T,H", [(1, 256, 32), (8, 256, 16), (128, 256, 8), (3, 20, 64)])
@pytest.mark.parametrize("reset_after", [False, True])
@pytest.mark.parametrize("gate", ["sigmoid", "hard_sigmoid"])
def test_gru_pair_launches_match_two_plain_directions(cuda, B, T, H, reset_after, gate):
    """One pair launch (two on the retained body) of each kernel against the
    single-direction plain versions run forward and reversed."""
    xp, wh, bh, h0, dys, dhl = _pair_case(cuda, B, T, H, reset_after, 70 + H)
    warp = gru_body(H) == "warp"
    before = (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
              gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches, gru_scan.retained_launches)
    pair = gru_scan_pair(xp, wh, bh, h0, reset_after, gate)
    pair_res = gru_scan_pair_fwd_res(xp, wh, bh, h0, reset_after, gate)
    ys, res = tuple(r[0] for r in pair_res), tuple(r[1] for r in pair_res)
    grads = gru_scan_pair_bwd(ys, res, wh, h0, dys, dhl, reset_after, gate)
    torch.cuda.synchronize()
    n = 1 if warp else 2
    assert (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
            gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches,
            gru_scan.retained_launches) == (
        before[0] + n, before[1] + n, before[2] + n, before[3] + warp, before[4] + n,
        before[5] + (0 if warp else 6))
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
    launches, retained = gru_scan.launches, gru_scan.retained_launches
    pair = gru_scan_pair(xp, wh, bh, h0, reset_after, "sigmoid")
    torch.cuda.synchronize()
    assert (gru_scan.launches, gru_scan.retained_launches) == (launches + 1, retained)
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
    launches, retained = gru_scan.launches, gru_scan.retained_launches
    pair = gru_scan_pair(xp, wh, bh, h0, reset_after, "sigmoid")
    torch.cuda.synchronize()
    assert (gru_scan.launches, gru_scan.retained_launches) == (launches + 1, retained)
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


@pytest.mark.parametrize("H", [8, 32])
def test_retained_body_still_matches_plain_at_warp_widths(cuda, H):
    """The private launchers put the retained body on a width the warp body
    takes (as chip_smoke.py times them side by side): same function."""
    xp, wh, bh, h0, dys, dhl = _gru_case(cuda, 4, 50, H, True, 11)
    outs = {}
    for body in ("warp", "retained"):
        (fwd,), _ = _fwd([xp], [wh], [bh], [h0], [True], True, "sigmoid", True, body)
        (bwd,) = _bwd([fwd[0]], [fwd[1]], [wh], [h0], [dys], [dhl], [True], True, "sigmoid", body)
        outs[body] = fwd + bwd
    for a, b in zip(outs["warp"], outs["retained"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(float(b.abs().max()), 1e-6))


@pytest.mark.parametrize("reset_after", [False, True])
def test_bigru_autograd_launches_one_pair_per_kernel(cuda, reset_after):
    """Autograd through a two-layer BiGRU stack on the card: per layer one
    pair residual forward, one pair backward (chain, dwh reduction, partial
    sum), none on the retained body; gradients as the CPU's plain versions."""
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
                  gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches, gru_scan.retained_launches)
        h = x.to(dev)
        for m in ms:
            h, _ = m(h)
        params = [p for m in ms for p in m.parameters()]
        grads[dev] = torch.autograd.grad(h.square().sum(), params)
        after = (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
                 gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches, gru_scan.retained_launches)
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
    launches, dft = fused_log_mel.launches, fused_log_mel.dft_launches
    got = fused_log_mel(y, cfg)
    torch.cuda.synchronize()
    assert (fused_log_mel.launches, fused_log_mel.dft_launches) == (launches + 1, dft)
    want = fused_log_mel_plain(y, cfg)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    if log_floor is None:
        assert not bool(fin.all())
    torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=5e-4)


def _counts():
    return (fused_log_mel.launches, fused_log_mel.framed_launches, fused_log_mel.exact_launches,
            fused_log_mel.dft_launches)


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
    launch counted on its route and, at n_fft 1034, on the dft body."""
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
    after[3] += body(n_fft) == "dft"
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
    assert _counts()[3] == before[3]
    assert torch.equal(first, second)
    _assert_logmel_close(first, fused_log_mel_plain(y, cfg))
    want = fft_log_mel_plain(y, cfg)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(first), fin)
    torch.testing.assert_close(first[fin], want[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_fft,hop", [(32768, 8192), (1000, 500), (3072, 1024)])
def test_other_sizes_launch_the_dft_body(cuda, n_fft, hop):
    """Above 16384 or not a power of two: the dft body, counted, and within
    its band of the plain version."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, log_floor=1e-10)
    y = torch.from_numpy(_signal(3 * 44100, 44100, 5)).to(cuda)
    assert body(n_fft) == "dft"
    before = _counts()
    got = fused_log_mel(y, cfg)
    torch.cuda.synchronize()
    assert _counts()[3] == before[3] + 1
    _assert_logmel_close(got, fused_log_mel_plain(y, cfg))


def test_both_bodies_agree_at_a_power_of_two(cuda):
    """The retained dft body, launched through its private launcher at a
    size the fft body takes, computes the same function."""
    cfg = FrontendConfig(n_fft=4096, hop_length=1024, center=False, log_floor=1e-10)
    y = torch.from_numpy(_signal(3 * 44100, 44100, 6)).to(cuda)
    n_frames = 1 + (y.shape[0] - 4096) // 1024
    fft = _launch_fft(y, 1024, n_frames, 4096, cfg)
    dft = _launch_dft(y, 1024, n_frames, 4096, cfg, False)
    torch.cuda.synchronize()
    _assert_logmel_close(fft, dft)


def test_logmel_kernel_rejects_bad_inputs(cuda):
    with pytest.raises(TypeError):
        fused_log_mel(torch.zeros(8192, device=cuda, dtype=torch.float64), FrontendConfig())
    with pytest.raises(ValueError):
        fused_log_mel(torch.zeros(100, device=cuda), FrontendConfig(center=False))
    with pytest.raises(ValueError):
        fused_log_mel_frames(torch.zeros(4, 2048, device=cuda), FrontendConfig(), "bf16x3")


@pytest.mark.parametrize("S,B,T,H",
                         [(1, 128, 8, 16), (3, 128, 8, 8), (5, 9, 8, 16), (2, 33, 256, 32)])
@pytest.mark.parametrize("reset_after", [False, True])
def test_gru_stack_launches_once_for_every_seed(cuda, S, B, T, H, reset_after):
    """Kernel B with a seed axis: S BiGRUs' forward, residual forward and
    backward each in one launch on the warp body (grid.y = 2S), against the
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
              gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches, gru_scan.retained_launches)
    fwd = gru_scan_stack(xp, wh, bh, h0, reset_after, "sigmoid")
    res = gru_scan_stack_fwd_res(xp, wh, bh, h0, reset_after, "sigmoid")
    ys, rs = tuple(r[0] for r in res), tuple(r[1] for r in res)
    first = gru_scan_stack_bwd(ys, rs, wh, h0, dys, dhl, reset_after, "sigmoid")
    torch.cuda.synchronize()
    assert (gru_scan.launches, gru_scan_fwd_res.launches, gru_scan_bwd.launches,
            gru_scan_bwd.dwh_launches, gru_scan_bwd.sum_launches,
            gru_scan.retained_launches) == tuple(b + 1 for b in before[:5]) + before[5:]
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
