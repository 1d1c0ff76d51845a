"""The mixed-radix / Bluestein body of the fused log-mel
(``csrc/logmel_mixed.cu``) on the CPU: its plan, the body choice, its host
tables, and its plain version `mixed_log_mel_plain` (the kernel's arithmetic
stage by stage) against four references on the same seeded waveforms.

Bands, in the log domain at finite entries, -inf entries equal:

* 1e-4 against ``np.fft.rfft`` + mel in float64: float32 rounding of the
  transform (two of them and the chirp products for Bluestein) and of the
  mel sums; measured up to 6e-6 here;
* 5e-4 against the JAX package's ``ops/frontend.py::extract`` (fft
  backend, float32), against the JAX `fused_log_mel` run interpreted (bf16x3
  products on its DIF route), and against `fused_log_mel_plain` (the DIF /
  direct plain version the wrapper runs on a CPU tensor): the band every
  kernel A route is held to (tests/test_frontend_parity.py).
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
from sed_crnn_torch.ops.kernels.fused_logmel import (
    MATRIX_MAX,
    MIXED_MAX_SMEM,
    MIXED_MAX_STAGES,
    REGISTER_RADICES,
    bluestein_chirp,
    bluestein_filter,
    body,
    dif_positions,
    fused_log_mel,
    fused_log_mel_frames,
    fused_log_mel_frames_plain,
    fused_log_mel_plain,
    mixed_log_mel_plain,
    mixed_operands,
    mixed_plan,
)
from sed_crnn_torch.ops.mel import mel_filterbank
from sed_crnn_torch.ops.stft import frame_signal, hann_window

# n_fft, hop, sample rate: 40 ms / 20 ms at 44.1 kHz (1764, 882),
# chip_smoke.py's Bluestein and odd shapes (1034, 1001), a framed 3072, and
# 25 ms at 16 kHz (400).
CONFIGS = {
    "1034": dict(n_fft=1034, hop_length=517),
    "1764": dict(n_fft=1764, hop_length=882),
    "3072": dict(n_fft=3072, hop_length=1024),
    "1001": dict(n_fft=1001, hop_length=500),
    "882": dict(n_fft=882, hop_length=441),
    "400/16k": dict(sample_rate=16000, n_fft=400, hop_length=160),
}


def _smooth(n):
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


def _signal(n, sr, seed, silent=False):
    """Two tones and noise; with ``silent``, an exactly silent middle half
    (-inf rows without a floor)."""
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


def _within_ulp(table, exact):
    table = np.asarray(table)
    assert table.dtype == np.float32 and table.shape == exact.shape
    ulp = np.spacing(np.abs(table)).astype(np.float64)
    assert np.all(np.abs(table.astype(np.float64) - exact) <= ulp)


@pytest.mark.parametrize("n_fft,points,n,radices,bluestein", [
    (1034, 517, 517, (11, 47), False),
    (1764, 882, 882, (2, 9, 7, 7), False),
    (3072, 1536, 1536, (8, 8, 8, 3), False),
    (1001, 1001, 1001, (7, 11, 13), False),
    (882, 441, 441, (9, 7, 7), False),
    (400, 200, 200, (8, 5, 5), False),
    (2050, 1025, 1025, (5, 5, 41), False),
    (32768, 16384, 16384, (8, 8, 8, 8, 4), False),
    (26, 13, 13, (13,), False),
    (2, 1, 1, (), False),
    (2206, 1103, 1103, (1103,), False),
    (4126, 2063, 4200, (8, 3, 5, 5, 7), True),
])
def test_plan_factors_and_picks_direct_or_bluestein(n_fft, points, n, radices, bluestein):
    """L is n_fft / 2 (even) or n_fft (odd); L is transformed directly by
    register radices (the 2s and 3s by `_power_radices`: 8, 4, 2 and 9, 3,
    largest first; then 5, 7, 11, 13) and matrix stages for its primes
    above 13, ascending, or with a Rader stage last for its largest prime,
    unless Bluestein costs less, at M, the smallest 7-smooth length >= 2L -
    1 (L 1103: Bluestein on 9, 5, 7, 7 costs less than a Rader stage over
    1102 = 2 x 19 x 29; L 2063: than the nested Rader plan over 2062 = 2 x
    1031); the radices multiply to the length."""
    plan = mixed_plan(n_fft)
    assert (plan.points, plan.n, plan.radices, plan.bluestein) == (points, n, radices, bluestein)
    assert math.prod(plan.radices) == plan.n
    assert plan.radices.count(2) <= 1 and len(plan.radices) <= MIXED_MAX_STAGES
    if bluestein:
        assert set(plan.radices) <= {2, 3, 4, 5, 7, 8, 9} and not plan.rader
        assert not any(_smooth(m) for m in range(2 * points - 1, n)) and _smooth(n)
    else:
        outer = radices[:-1] if plan.rader else radices
        assert n == points and all(r in REGISTER_RADICES or r <= MATRIX_MAX for r in outer)
        if plan.rader:
            assert math.prod(plan.rader) == radices[-1] - 1
            assert all(r in REGISTER_RADICES or r <= MATRIX_MAX for r in plan.rader)
    arrays = 2 if plan.matrix or plan.rader else 1
    assert plan.smem_bytes == 8 * arrays * plan.n + 4 * (n_fft // 2 + 1)


@pytest.mark.parametrize("n_fft,fits", [
    (12863, True), (12864, True), (12865, True), (23040, True), (23042, True),
    (21875, True), (38416, True), (25725, False), (40000, False), (65536, False),
    (12867, True), (23044, True), (23052, True), (23054, True), (12895, True),
    (23082, True), (12915, False), (23228, False), (12911, True), (23098, True),
    (23174, False),
])
def test_size_limit_is_the_shared_memory_of_one_frame(n_fft, fits):
    """A plan fits when one frame's work arrays and power row take at most
    227 KB: every n_fft to 12,913 (12,863: Bluestein at M 25,725, 231,528
    bytes; 12,865 direct with matrix stages, 231,572; 12,867 = 3 x 4289, a
    Rader stage, 231,608; 12,895 = 5 x 2579, a Rader stage of 2579 with one
    of 1289 nested in it, 232,112; 12,911, prime, a Rader stage with one of
    1291 nested in it, 232,400, since the refitted weights price it below
    Bluestein), every even one to 23,172 (23,044: a Rader stage of
    823, 230,444 bytes; 23,054: L 11,527, a Rader stage, 230,544; 23,082: L
    3 x 3847, a nested Rader plan, 230,824; 23,098: L 11,549, nested,
    230,984), and beyond them the sizes whose plan is small enough (21,875
    and 38,416 direct; 40,000, L 20,000, is not); 12,915 (L 3^2 x 5 x 7 x
    41, direct with a matrix stage, 232,472 bytes) and 23,174 (L 11,587:
    Bluestein at M 23,328) are the first odd and even sizes that do not,
    23,228 (L 11,614: Bluestein at M 23,328) the first even one under
    older weights; a plan that does not fit goes to the cluster body."""
    assert (mixed_plan(n_fft).smem_bytes <= MIXED_MAX_SMEM) == fits
    assert body(n_fft) == ("mixed" if fits else "cluster") or body(n_fft) == "fft"


@pytest.mark.parametrize("n_fft,want", [
    (1034, "mixed"), (1764, "mixed"), (882, "mixed"), (400, "mixed"), (960, "mixed"),
    (1920, "mixed"), (1001, "mixed"), (128, "mixed"), (1, "mixed"), (20000, "mixed"),
    (2048, "fft"), (256, "fft"), (16384, "fft"), (12865, "mixed"), (23042, "mixed"),
    (12867, "mixed"), (23044, "mixed"), (23054, "mixed"), (12895, "mixed"),
    (25734, "cluster"),
])
def test_body_by_size(n_fft, want):
    assert body(n_fft) == want


def test_body_below_the_limit_is_never_the_dft_body():
    """No n_fft up to 12,866 leaves one block for the cluster body (and no
    n_fft reaches the retired dft body: `body` no longer names it)."""
    assert {body(n) for n in range(1, 12867)} == {"fft", "mixed"}


@pytest.mark.parametrize("n_fft", [1034, 1764, 1001, 3072, 400, 2206, 4126])
def test_tables_round_float64_once(n_fft):
    """The stage twiddles, the untangle twiddles and the chirp lie within one
    float32 ulp of their float64 values, the window is the float64 Hann
    window rounded, and the positions are a permutation."""
    plan = mixed_plan(n_fft)
    ops = mixed_operands(44100, n_fft, 40, 0.0, None)
    ang = 2.0 * np.pi * np.arange(plan.n) / plan.n
    _within_ulp(ops["tw"], np.stack([np.cos(ang), -np.sin(ang)], axis=1))
    if n_fft % 2 == 0:
        ang = 2.0 * np.pi * np.arange(plan.points + 1) / n_fft
        _within_ulp(ops["utw"], np.stack([np.cos(ang), -np.sin(ang)], axis=1))
    else:
        assert "utw" not in ops
    np.testing.assert_array_equal(ops["window"], hann_window(n_fft, np.float64).astype(np.float32))
    if plan.bluestein:
        q = np.array([n * n % (2 * plan.points) for n in range(plan.points)], np.float64)
        ang = np.pi * q / plan.points
        _within_ulp(ops["chirp"], np.stack([np.cos(ang), -np.sin(ang)], axis=1))
        assert "pos" not in ops and ops["bspec"].shape == (plan.n, 2)
    else:
        assert sorted(ops["pos"].tolist()) == list(range(plan.n))


@pytest.mark.parametrize("points", [46349, 50021])
def test_chirp_phase_above_int32_squares(points):
    """n^2 mod 2L in int64: from L = 46,341 a square overflows int32 and a
    float angle of n^2 loses the phase; against Python's exact integers."""
    table = bluestein_chirp(points)
    n = np.arange(points - 1000, points)
    q = np.array([int(k) * int(k) % (2 * points) for k in n], np.float64)
    ang = np.pi * q / points
    _within_ulp(table[n], np.stack([np.cos(ang), -np.sin(ang)], axis=1))


@pytest.mark.parametrize("n_fft", [1034, 1001, 26])
def test_filter_spectrum_against_a_float64_dft(n_fft):
    """B = DFT_M(b) / M with b_m = conj(w_m) wrapped at both ends, summed
    directly in float64 with the phase reduced mod M exactly, and read back
    through the DIF positions: each part of each entry within one float32
    ulp of the entry's magnitude (a part near zero has no ulp of its own to
    be held to)."""
    plan = mixed_plan(n_fft, "bluestein")
    L, M = plan.points, plan.n
    q = np.array([n * n % (2 * L) for n in range(L)], np.float64)
    w = np.exp(-1j * np.pi * q / L)
    b = np.zeros(M, np.complex128)
    for m in range(L):
        b[m] = np.conj(w[m])
        b[(M - m) % M] = np.conj(w[m])
    km = np.outer(np.arange(M), np.arange(M)) % M
    want = (np.exp(-2j * np.pi * km / M) @ b) / M
    got = bluestein_filter(L, plan.radices)[dif_positions(plan.radices)]
    assert got.dtype == np.float32
    err = np.maximum(np.abs(got[:, 0] - want.real), np.abs(got[:, 1] - want.imag))
    assert np.all(err <= np.spacing(np.abs(want).astype(np.float32)))


@pytest.mark.parametrize("radices", [(2, 3, 5, 5, 7), (4, 4, 2, 3), (7, 5, 3), (3,)])
def test_dif_positions_follow_the_stages(radices):
    """A float64 in-place DIF with these radices leaves X_k at pos[k]."""
    n = math.prod(radices)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    z = x.copy()
    ls = n
    for r in radices:
        m = ls // r
        for g in range(n // ls):
            for j in range(m):
                idx = g * ls + j + m * np.arange(r)
                v = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r) @ z[idx]
                z[idx] = v * np.exp(-2j * np.pi * j * np.arange(r) / ls)
        ls = m
    np.testing.assert_allclose(z[dif_positions(radices)], np.fft.fft(x), atol=1e-9)


def _jax_extract(y, kw):
    return jax_frontend.extract(y, JaxFrontendConfig(**kw), bucket_seconds=0)


@pytest.mark.parametrize("log_floor", [None, 1e-10])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("case", list(CONFIGS))
def test_mixed_plain_matches_references(case, center, log_floor):
    """A quarter second (at least 4 frames) with a silent middle half, every
    configuration: the mixed plain version against float64 rFFT + mel, the
    JAX package's `extract` (fft backend) and the DIF / direct plain
    version, -inf patterns equal."""
    kw = dict(CONFIGS[case], center=center, log_floor=log_floor)
    cfg = FrontendConfig(**kw)
    n = max(cfg.sample_rate // 4, 4 * cfg.n_fft)
    y = _signal(n, cfg.sample_rate, seed=len(case) + 7 * center, silent=True)
    got = mixed_log_mel_plain(torch.from_numpy(y), cfg).numpy()
    assert body(cfg.n_fft) == "mixed"
    _assert_log_close(got, _rfft_log_mel(y, cfg), 1e-4)
    _assert_log_close(got, _jax_extract(y, kw), 5e-4)
    _assert_log_close(got, fused_log_mel_plain(torch.from_numpy(y), cfg).numpy(), 5e-4)
    assert np.isneginf(got).any() == (log_floor is None)


@pytest.mark.parametrize("case", ["1034", "1764"])
def test_mixed_plain_against_the_jax_kernel_on_a_short_clip(case):
    """A 1,500-sample clip, centred (frames of repeated reflections), against
    the JAX fused Pallas kernel run interpreted: its exact route at 1034, its
    chunked DIF route at 1764."""
    cfg = FrontendConfig(**CONFIGS[case])
    y = _signal(1500, cfg.sample_rate, seed=3)
    got = mixed_log_mel_plain(torch.from_numpy(y), cfg).numpy()
    assert got.shape == (1 + 1500 // cfg.hop_length, cfg.n_mels)
    want = jax.jit(lambda w: jax_fused_log_mel(w, JaxFrontendConfig(**CONFIGS[case])))(
        jnp.asarray(y))
    _assert_log_close(got, want, 5e-4)
    _assert_log_close(got, _rfft_log_mel(y, cfg), 1e-4)


@pytest.mark.parametrize("case", ["1034", "1001", "3072"])
def test_mixed_plain_on_a_frame_matrix(case):
    """The frame-matrix entry (stride n_fft) gives the waveform's rows bit
    for bit, and the framed plain version's within 5e-4."""
    cfg = FrontendConfig(log_floor=1e-10, **CONFIGS[case])
    y = torch.from_numpy(_signal(6 * cfg.n_fft, cfg.sample_rate, seed=5))
    frames = frame_signal(y, cfg.n_fft, cfg.hop_length, center=True).contiguous()
    got = mixed_log_mel_plain(frames, cfg)
    assert torch.equal(got, mixed_log_mel_plain(y, cfg))
    _assert_log_close(got.numpy(), fused_log_mel_frames_plain(frames, cfg).numpy(), 5e-4)


@pytest.mark.parametrize("n_fft", [2048, 16384])
def test_mixed_plain_refuses_sizes_it_does_not_take(n_fft):
    """The FFT body's sizes; the cluster body's (12,865 and up) are taken."""
    with pytest.raises(ValueError, match="mixed and cluster bodies"):
        mixed_log_mel_plain(torch.zeros(4 * n_fft), FrontendConfig(n_fft=n_fft, hop_length=512))


def test_cpu_wrapper_runs_the_dif_direct_plain_version():
    """At a size the mixed body takes, a CPU tensor still runs the DIF /
    direct plain version (the JAX kernels' function), counting no launch."""
    counts = lambda: (fused_log_mel.launches, fused_log_mel.framed_launches,  # noqa: E731
                      fused_log_mel.exact_launches, fused_log_mel.mixed_launches,
                      fused_log_mel.cluster_launches)
    before = counts()
    for case in ("1764", "1034"):
        cfg = FrontendConfig(log_floor=1e-10, **CONFIGS[case])
        y = torch.from_numpy(_signal(20000, 44100, seed=4))
        assert torch.equal(fused_log_mel(y, cfg), fused_log_mel_plain(y, cfg))
        frames = frame_signal(y, cfg.n_fft, cfg.hop_length, center=True).contiguous()
        assert torch.equal(fused_log_mel_frames(frames, cfg),
                           fused_log_mel_frames_plain(frames, cfg))
    assert counts() == before
