"""The plan of kernel A's mixed and cluster bodies on the CPU: register
radices 2-13, matrix stages for the primes above (``matrix_stage`` of
``csrc/logmel_stages.cuh``: two real products on the tensor cores), Bluestein
only where a prime above ``MATRIX_MAX`` divides L or the cost model says so;
the body by size; the matrix stages' host tables; the mel sums' lane order;
and `mixed_log_mel_plain` at the new plans against float64 rFFT + mel, the
JAX package's `extract` and its fused kernel (interpreted).

Bands, in the log domain at finite entries, -inf entries equal: 1e-4
against ``np.fft.rfft`` + mel in float64 (float32 rounding of the register
stages, the float64 matrix product rounded once, the mel sums); 5e-4
against the JAX package (the band every kernel A route is held to,
tests/test_frontend_parity.py). The JAX kernel is not run at 12865: it
builds dense (n_fft, n_fft / 2) float64 bases (1.3 GB) before its
interpreted kernel runs; `extract` is.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.core.config import FrontendConfig as JaxFrontendConfig
from sed_crnn_tpu.ops import frontend as jax_frontend
from sed_crnn_tpu.ops.pallas.fused_logmel import fused_log_mel as jax_fused_log_mel

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels import fused_logmel as fl
from sed_crnn_torch.ops.kernels.fused_logmel import (
    MATRIX_MAX,
    MATRIX_TILES,
    MIXED_MAX_SMEM,
    REGISTER_RADICES,
    _launch_cluster,
    _next_smooth,
    _tf32,
    body,
    matrix_table,
    matrix_tiles,
    mel_csr,
    mixed_log_mel_plain,
    mixed_operands,
    mixed_plan,
    pair_matrices,
    plan_cost,
)
from sed_crnn_torch.ops.mel import mel_filterbank
from sed_crnn_torch.ops.stft import hann_window


def _signal(n, sr, seed, silent=True):
    """Two tones and noise; with ``silent``, an exactly silent middle half."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    y = (0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 3517.0 * t + 0.3)
         + 0.05 * rng.standard_normal(n))
    if silent:
        y[n // 4 : 3 * n // 4] = 0.0
    return y.astype(np.float32)


def _rfft_log_mel(y, cfg):
    """Frame, window, ``np.fft.rfft``, power, mel, floor, log, in float64."""
    y = y.astype(np.float64)
    if cfg.center:
        y = np.pad(y, cfg.n_fft // 2, mode="reflect")
    n = 1 + (len(y) - cfg.n_fft) // cfg.hop_length
    idx = np.arange(n)[:, None] * cfg.hop_length + np.arange(cfg.n_fft)[None, :]
    power = np.abs(np.fft.rfft(y[idx] * hann_window(cfg.n_fft, np.float64), axis=1)) ** 2
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, np.float64)
    mel = power @ fb.T
    if cfg.log_floor is not None:
        mel = np.maximum(mel, cfg.log_floor)
    with np.errstate(divide="ignore"):
        return np.log(mel)


def _assert_log_close(got, want, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol)


# n_fft: (radices, Bluestein, body). L 1001 = 7 x 11 x 13 (register radices
# only), 517 = 11 x 47, 551 = 19 x 29, 12865 = 5 x 31 x 83 (two work arrays
# and the power row, 231,572 bytes: one block), 13 (one radix-13 stage),
# 1103 (a prime above MATRIX_MAX: Bluestein at M 2,205), 11522 = 2 x 7 x 823
# (a matrix stage of 823: cheaper than Bluestein on the cluster body), and
# 12867 = 3 x 4289 and 11527 (prime) (the first odd and even sizes beyond
# one block: Bluestein on the cluster body).
PLANS = {
    1001: ((7, 11, 13), False, "mixed"),
    1034: ((11, 47), False, "mixed"),
    1102: ((19, 29), False, "mixed"),
    12865: ((5, 31, 83), False, "mixed"),
    26: ((13,), False, "mixed"),
    2206: ((3, 3, 5, 7, 7), True, "mixed"),
    12867: ((4, 4, 4, 3, 3, 3, 3, 5), True, "cluster"),
    23044: ((2, 7, 823), False, "mixed"),
    23054: ((4, 4, 2, 3, 3, 3, 3, 3, 3), True, "cluster"),
}


@pytest.mark.parametrize("n_fft", list(PLANS))
def test_new_plans(n_fft):
    """Direct plans take the register radices and, above 13, matrix stages
    (ascending, after the register stages); Bluestein keeps 7-smooth M."""
    radices, blue, where = PLANS[n_fft]
    plan = mixed_plan(n_fft)
    assert (plan.radices, plan.bluestein, body(n_fft)) == (radices, blue, where)
    assert math.prod(plan.radices) == plan.n and len(plan.radices) <= fl.MIXED_MAX_STAGES
    assert plan.matrix == tuple(r for r in radices if r > 13)
    arrays = 2 if plan.matrix else 1     # a matrix stage writes out of place
    assert plan.smem_bytes == 8 * arrays * plan.n + 4 * (n_fft // 2 + 1)
    if blue:
        assert plan.n == _next_smooth(2 * plan.points - 1) and set(plan.radices) <= {2, 3, 4, 5, 7}
    else:
        assert plan.n == plan.points and list(plan.matrix) == sorted(plan.matrix)


def test_1103_has_a_prime_above_the_bound():
    """An odd prime n_fft above MATRIX_MAX: no direct plan, so Bluestein."""
    assert MATRIX_MAX < 1103 <= 2 * MATRIX_MAX
    plan = mixed_plan(1103)
    assert plan.bluestein and plan.n == 2205 and body(1103) == "mixed"
    with pytest.raises(ValueError, match="no direct plan"):
        mixed_plan(1103, bluestein=False)


def test_matrix_bound_is_the_kernels_tile_limit():
    """MATRIX_MAX is the largest prime whose column tiles the mixed body's
    launcher takes (MATRIX_TILES)."""
    assert matrix_tiles(MATRIX_MAX) <= MATRIX_TILES
    nxt = next(p for p in range(MATRIX_MAX + 1, 4 * MATRIX_MAX)
               if all(p % q for q in range(2, int(p ** 0.5) + 1)))
    assert matrix_tiles(nxt) > MATRIX_TILES
    assert set(REGISTER_RADICES) == {2, 3, 4, 5, 7, 11, 13}


def test_a_matrix_plan_beyond_one_block_takes_bluestein():
    """L 31,744 = 31 x 1024 has a direct plan with a matrix stage, 380,932
    bytes: more than one block, and the cluster body has no matrix stage,
    so `mixed_plan` gives Bluestein and the cluster body runs it."""
    direct = mixed_plan(63488, bluestein=False)
    assert direct.matrix == (31,) and direct.smem_bytes > MIXED_MAX_SMEM
    plan = mixed_plan(63488)
    assert plan.bluestein and body(63488) == "cluster"


@pytest.mark.parametrize("n_fft", [1034, 12865])
def test_cluster_launcher_refuses_a_matrix_stage(n_fft):
    """Forced onto the cluster body, a plan with a matrix stage raises before
    any launch; nothing falls back."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=n_fft // 2, center=False)
    before = fl.fused_log_mel.cluster_launches
    with pytest.raises(ValueError, match="no matrix stage"):
        _launch_cluster(torch.zeros(2 * n_fft), n_fft // 2, 2, n_fft, cfg, ctas=2)
    assert fl.fused_log_mel.cluster_launches == before


def test_cost_model_picks_the_cheaper_plan():
    """`mixed_plan` keeps the cheaper plan by `plan_cost` wherever both fit
    one block: a lone prime near the bound (L 509) costs more direct than
    Bluestein's two 7-smooth transforms; the sizes above cost less direct."""
    for n_fft in (1034, 1102, 12865, 1018, 2050, 4418, 10006):
        blue = mixed_plan(n_fft, bluestein=True)
        try:
            direct = mixed_plan(n_fft, bluestein=False)
        except ValueError:
            continue
        want = blue if plan_cost(blue.n, blue.radices, True) < plan_cost(
            direct.n, direct.radices, False) else direct
        assert mixed_plan(n_fft) == want, n_fft
    assert mixed_plan(1018).bluestein
    assert not any(mixed_plan(n).bluestein for n in (1034, 1102, 12865))


@pytest.mark.parametrize("radix", [17, 19, 31, 47, 83, 281])
def test_pair_matrices_give_the_dft(radix):
    """P = a cos and Q = b sin, with a_0 = v_0, a_r = v_r + v_{R-r} and b_r =
    v_r - v_{R-r}, give X_0 = P_0, X_s = P_s - i Q_s and X_{R-s} = P_s + i
    Q_s: the R-point DFT, in float64."""
    rng = np.random.default_rng(radix)
    v = rng.standard_normal((5, radix)) + 1j * rng.standard_normal((5, radix))
    h = (radix - 1) // 2
    cos, sin = pair_matrices(radix)
    kp = cos.shape[0]
    assert kp == 8 * matrix_tiles(radix) >= h + 1
    a = np.zeros((5, kp), complex)
    b = np.zeros((5, kp), complex)
    a[:, 0] = v[:, 0]
    a[:, 1 : h + 1] = v[:, 1 : h + 1] + v[:, radix - 1 : radix - h - 1 : -1]
    b[:, 1 : h + 1] = v[:, 1 : h + 1] - v[:, radix - 1 : radix - h - 1 : -1]
    p, q = a @ cos, b @ sin
    x = np.empty((5, radix), complex)
    x[:, 0] = p[:, 0]
    x[:, 1 : h + 1] = p[:, 1 : h + 1] - 1j * q[:, 1 : h + 1]
    x[:, radix - 1 : radix - h - 1 : -1] = p[:, 1 : h + 1] + 1j * q[:, 1 : h + 1]
    np.testing.assert_allclose(x, np.fft.fft(v, axis=1), atol=1e-10 * radix)


def test_tf32_rounds_to_nearest_ties_away():
    """`_tf32` keeps 10 mantissa bits, to nearest, ties away from zero (as
    ``cvt.rna.tf32.f32``), and maps TF32 values to themselves."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -20, -(1.0 + 2.0 ** -11),
                  1.0 + 3 * 2.0 ** -11], np.float32)
    np.testing.assert_array_equal(_tf32(x), [one + ulp, one, -(one + ulp), one + 2 * ulp])
    rng = np.random.default_rng(0)
    r = _tf32(rng.standard_normal(1000).astype(np.float32))
    np.testing.assert_array_equal(_tf32(r), r)
    assert not np.any(r.view(np.uint32) & np.uint32(0x1FFF))


@pytest.mark.parametrize("radix", [17, 47, 83])
def test_matrix_table_is_the_fragments_of_both_matrices(radix):
    """Read back in mma.m16n8k8 B-fragment order, the table gives cos and sin
    with hi + lo within 2^-21 of each float64 value's magnitude, both parts
    TF32 values."""
    t = matrix_tiles(radix)
    table = matrix_table(radix).reshape(t, t, 32, 8)
    assert table.dtype == np.float32
    assert not np.any(table.view(np.uint32) & np.uint32(0x1FFF))
    for g, (h0, h1, l0, l1) in zip(pair_matrices(radix), ((0, 1, 2, 3), (4, 5, 6, 7))):
        back = np.zeros_like(g)
        for lane in range(32):
            k = 8 * np.arange(t)[:, None] + lane % 4
            n = 8 * np.arange(t)[None, :] + lane // 4
            back[k, n] = table[:, :, lane, h0].astype(np.float64) + table[:, :, lane, l0]
            back[k + 4, n] = table[:, :, lane, h1].astype(np.float64) + table[:, :, lane, l1]
        assert np.all(np.abs(back - g) <= 2.0 ** -21 * np.abs(g))


@pytest.mark.parametrize("sr,n_fft,group", [
    (16000, 400, 4), (44100, 1001, 4), (44100, 1764, 4), (44100, 3072, 8), (44100, 4410, 8),
    (44100, 12865, 32), (44100, 23042, 32),
])
def test_mel_group_follows_the_bands_mean_width(sr, n_fft, group):
    """4 lanes a band, doubled while the bands' mean width is at least 16
    bins a lane: 4 at 400 / 16 kHz (9.6 bins), 8 at 3072 (73), 32 from
    12865 (305); the operands carry it."""
    first, ptr, w = mel_csr(sr, n_fft, 40, 0.0, None)
    assert fl.mel_group(ptr) == group
    assert mixed_operands(sr, n_fft, 40, 0.0, None)["mel_group"] == group


def test_operands_carry_the_tables_in_stage_order():
    ops = mixed_operands(44100, 12865, 40, 0.0, None)
    np.testing.assert_array_equal(ops["dft"], np.concatenate([matrix_table(31),
                                                              matrix_table(83)]))
    assert "chirp" not in ops and sorted(ops["pos"].tolist()) == list(range(12865))
    assert "dft" not in mixed_operands(44100, 1001, 40, 0.0, None)


@pytest.mark.parametrize("radix,ls", [(7, 49), (7, 7), (11, 121)])
def test_matrix_stage_plain_is_the_stage(radix, ls):
    """`_matrix_stage` (the exact product, rounded once) is the register
    stage `_mixed_stage` to float32 rounding, twiddles and positions alike."""
    rng = np.random.default_rng(radix + ls)
    n = 2 * ls
    re = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    tw = torch.from_numpy(fl._unit_roots(n, n))
    want = fl._mixed_stage(re, im, radix, ls, tw[:, 0], tw[:, 1], False)
    got = fl._matrix_stage(re, im, radix, ls, tw[:, 0], tw[:, 1])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-6)


def test_lane_mel_order_is_the_kernels():
    """`_lane_mel`: bin i of a band into partial i mod 32, in bin order, then
    the fixed tree p_l + p_{l+s} (s = 16 .. 1); bitwise that order in numpy
    float32, within 1e-6 of float64 sums."""
    first, ptr, w = mel_csr(44100, 12865, 40, 0.0, None)
    rng = np.random.default_rng(1)
    power = rng.random((3, 12865 // 2 + 1)).astype(np.float32) ** 4
    ops = {"mel_first": torch.from_numpy(first), "mel_ptr": torch.from_numpy(ptr),
           "mel_w": torch.from_numpy(w)}
    got = fl._lane_mel(torch.from_numpy(power), ops, 40).numpy()
    want = np.zeros((3, 40), np.float32)
    for f in range(3):
        for m in range(40):
            part = np.zeros(32, np.float32)
            for i in range(ptr[m + 1] - ptr[m]):
                part[i % 32] = np.float32(part[i % 32] + np.float32(w[ptr[m] + i]
                                                                     * power[f, first[m] + i]))
            s = 16
            while s:
                part[:s] = part[:s] + part[s : 2 * s]
                s //= 2
            want[f, m] = part[0]
    np.testing.assert_array_equal(got, want)
    exact = np.zeros((3, 40))
    for m in range(40):
        exact[:, m] = power[:, first[m] : first[m] + ptr[m + 1] - ptr[m]].astype(np.float64) @ w[
            ptr[m] : ptr[m + 1]]
    np.testing.assert_allclose(got, exact, rtol=1e-6)


CONFIGS = {
    "1001": dict(n_fft=1001, hop_length=500),
    "1034": dict(n_fft=1034, hop_length=517),
    "1102": dict(n_fft=1102, hop_length=551),
    "1103": dict(n_fft=1103, hop_length=551),
    "12865": dict(n_fft=12865, hop_length=6432),
}


@pytest.mark.parametrize("log_floor", [None, 1e-10])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("case", list(CONFIGS))
def test_new_plans_plain_matches_references(case, center, log_floor):
    """A short clip (at least 5 frames) with a silent middle half: the plain
    version at the new plans against float64 rFFT + mel and the JAX
    package's `extract` (fft backend), -inf patterns equal."""
    kw = dict(CONFIGS[case], center=center, log_floor=log_floor)
    cfg = FrontendConfig(**kw)
    n = max(11025, 4 * cfg.n_fft + (0 if center else cfg.n_fft))
    y = _signal(n, cfg.sample_rate, seed=len(case) + 3 * center)
    got = mixed_log_mel_plain(torch.from_numpy(y), cfg).numpy()
    _assert_log_close(got, _rfft_log_mel(y, cfg), 1e-4)
    _assert_log_close(got, jax_frontend.extract(y, JaxFrontendConfig(**kw), bucket_seconds=0),
                      5e-4)
    assert np.isneginf(got).any() == (log_floor is None)


@pytest.mark.parametrize("case", ["1001", "1034", "1102", "1103"])
def test_new_plans_plain_against_the_jax_kernel(case):
    """A 1,500-sample clip, centred, against the JAX fused Pallas kernel run
    interpreted (its exact route: n_fft % 4 != 0)."""
    cfg = FrontendConfig(**CONFIGS[case])
    y = _signal(1500, cfg.sample_rate, seed=5, silent=False)
    got = mixed_log_mel_plain(torch.from_numpy(y), cfg).numpy()
    want = jax.jit(lambda w: jax_fused_log_mel(w, JaxFrontendConfig(**CONFIGS[case])))(
        jnp.asarray(y))
    _assert_log_close(got, want, 5e-4)


def test_phases_tool_cuts_the_mixed_body():
    """`sed_crnn_torch.tools.logmel_phases` builds the mixed body at each of
    its named profiling cuts; the source defines the macro as 0 (no cut) and
    guards each phase the tool names with its level; every size it times
    takes the mixed body."""
    from sed_crnn_torch.ops.kernels import _build
    from sed_crnn_torch.tools import logmel_phases as tool

    src = (_build.CSRC_DIR / "logmel_mixed.cu").read_text()
    assert "#define LOGMEL_MIXED_CUT 0" in src
    assert tool.MIXED_VARIANTS == {"full": 0, "no_mel": 1, "no_power": 2, "no_matrix": 3,
                                   "no_bluestein": 4, "no_stages": 5}
    for level in (1, 2, 3, 4, 5):
        assert f"CUT < {level}" in src, level
    assert all(body(n) == "mixed" for n, _ in tool.MIXED_SIZES)
    plan = mixed_plan(12865)
    assert fl.plan_counts(plan.n, plan.radices, False) == (12865, 52 * 4 + 20 * 36)
    blue = mixed_plan(12865, bluestein=True)
    assert fl.plan_counts(blue.n, blue.radices, True) == (2 * 8 * 25920 + 25920, 0)
