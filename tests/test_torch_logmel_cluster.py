"""The cluster body of the fused log-mel (``csrc/logmel_cluster.cu``) on the
CPU: its split of the mixed body's plan over a thread-block cluster, the
cluster size and the body's limit by n_fft, the body choice beyond one
block's shared memory, and its plain version `mixed_log_mel_plain` (the
kernel's arithmetic stage by stage, the same as the mixed body's) against
two references on the same seeded waveforms.

Bands, in the log domain at finite entries, -inf entries equal:

* 1e-4 against ``np.fft.rfft`` + mel in float64: float32 rounding of the
  transform (two of them and the chirp products for Bluestein) and of the
  mel sums over bands of up to thousands of bins at these sizes;
* 5e-4 against the JAX package's ``ops/frontend.py::extract`` (fft backend,
  float32), the band every kernel A route is held to
  (tests/test_frontend_parity.py).

The JAX `fused_log_mel` itself is not run here: at these sizes it builds
dense (n_fft, n_fft / 2) bases in float64 (1.3 GB at n_fft 12,865) before
its interpreted kernel runs.
"""

import math

import numpy as np
import pytest
import torch

from sed_crnn_tpu.core.config import FrontendConfig as JaxFrontendConfig
from sed_crnn_tpu.ops import frontend as jax_frontend

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels.fused_logmel import (
    BIN_TILE,
    CLUSTER_MAX,
    MIXED_MAX_SMEM,
    _launch_cluster,
    _next_smooth,
    body,
    cluster_size,
    cluster_split,
    mixed_log_mel_plain,
    mixed_plan,
)
from sed_crnn_torch.ops.kernels import fused_logmel as fl
from sed_crnn_torch.ops.mel import mel_filterbank
from sed_crnn_torch.ops.stft import hann_window

# The first n_fft whose plans 16 CTAs of 227 KB do not hold: odd, L = 5 x
# 41,243 (41,242 = 2 x 17 x 1,213: no direct plan for p - 1, so no Rader
# stage; its nested Rader plan, 1,213 within 41,243, is beyond one block,
# where the cluster body runs no nested stage), Bluestein at M = 413,343
# (3^10 x 7), 3,719,164 bytes. The six below it from 206,209 (where
# Bluestein first does not fit) run direct or Rader plans.
FIRST_BEYOND = 206215


def _signal(n, sr, seed):
    """Two tones and noise, with an exactly silent stretch from n / 4 to
    3 n / 4 (-inf rows without a floor where a frame lies inside it)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    y = (0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 3517.0 * t + 0.3)
         + 0.05 * rng.standard_normal(n))
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


# n_fft: (L, N, Bluestein, C, stages that cross CTAs, bytes a CTA, chunk,
# Rader inner stages that cross). The sizes chip_smoke.py times (25734:
# a Rader stage of 4289 over 4 x 4 x 4 x 67, its chunk whole inner
# transforms, under the refitted weights; 25738: a Rader stage of 757 after a matrix stage of
# 17, its chunk whole inner transforms so that none of them crosses; 31290:
# a matrix stage; 44100, 48000, and 88200 at C = 3), a power
# of two, sizes whose smallest cluster does not divide N, so that most
# stages cross CTAs (141000: C 7, a matrix stage of 47; 141001: C 16, as
# every plan with a wgmma stage that 8 CTAs do not hold (it fits 11), here
# 373 inside a Rader stage of 20143 whose inner stages mostly cross), and
# the largest
# plans (206208 (a matrix stage of 179), 206209 (Rader) and 617400 fill 9,
# 16 and 16 CTAs; 206209 with one B slab). Plans beyond one block with a
# matrix or Rader stage take no composite radix. A CTA's bytes: its shares
# of the work arrays, and of the power row, or the B ring of its wgmma
# stages in its place where that is larger (141001: two slabs of 373's).
SPLITS = {
    25734: (12867, 12867, False, 2, 2, 162952, 8576, 0),
    25738: (12869, 12869, False, 2, 2, 134604, 6804, 0),
    31290: (15645, 15645, False, 2, 4, 156460, 7823, 0),
    44100: (22050, 22050, False, 2, 1, 132304, 11025, 0),
    48000: (24000, 24000, False, 2, 1, 144004, 12000, 0),
    88200: (44100, 44100, False, 3, 2, 176404, 14700, 0),
    131072: (65536, 65536, False, 4, 1, 196612, 16384, 0),
    141000: (70500, 70500, False, 7, 6, 201440, 10072, 0),
    141001: (141001, 141001, False, 16, 2, 190416, 8813, 5),
    206208: (103104, 103104, False, 9, 5, 229124, 11456, 0),
    206209: (206209, 206209, False, 16, 1, 232004, 12889, 7),
    617400: (308700, 308700, False, 16, 7, 231528, 19294, 0),
}


@pytest.mark.parametrize("n_fft", list(SPLITS))
def test_split_by_size(n_fft):
    """The plan is the mixed body's; C is the smallest cluster whose share
    fits in 227 KB a CTA, of 2-8 and 16 alone where the plan has wgmma
    matrix stages (a double B ring where it fits); the chunk is ceil(N / C),
    or whole inner
    transforms of a Rader stage where those fit; a stage crosses CTAs when
    its sub-transform length does not divide the chunk, so the first always
    does, and a Rader stage always does (its gather and product)."""
    points, n, blue, ctas, crossing, smem, chunk, inner = SPLITS[n_fft]
    plan = mixed_plan(n_fft)
    assert (plan.points, plan.n, plan.bluestein) == (points, n, blue)
    assert body(n_fft) == "cluster" and plan.smem_bytes > MIXED_MAX_SMEM
    sp = cluster_split(n_fft, cluster_size(n_fft))
    assert (sp.ctas, sum(sp.cross), sp.smem_bytes, sp.chunk, sum(sp.rader_cross)) == (
        ctas, crossing, smem, chunk, inner)
    assert sp.chunk * ctas >= n and sp.bin_chunk == -(-(n_fft // 2 + 1) // ctas)
    if plan.rader:
        assert sp.chunk in (-(-n // ctas), (plan.rader_prime - 1) * -(-(n // plan.rader_prime)
                                                                       // ctas))
    else:
        assert sp.chunk == -(-n // ctas)
    arrays = 2 if plan.matrix or plan.rader else 1
    assert sp.ring == fl.ring_plan(plan, 8 * arrays * sp.chunk)
    ring = 256 + sp.ring if sp.ring else 0
    assert sp.smem_bytes == 8 * arrays * sp.chunk + max(4 * sp.bin_chunk, ring) <= MIXED_MAX_SMEM
    assert sp.cross[0]
    ls = n
    for s, (r, cross) in enumerate(zip(plan.radices, sp.cross)):
        assert cross == (sp.chunk % ls != 0 or (bool(plan.rader) and s == len(plan.radices) - 1))
        ls //= r
    ls = plan.rader_prime - 1
    for r, cross in zip(plan.rader, sp.rader_cross):
        assert cross == (sp.chunk % ls != 0)
        ls //= r
    if ring:
        assert ctas == next(c for c in fl.WGMMA_CLUSTERS
                            if fl._cluster_bytes(plan, c) <= MIXED_MAX_SMEM)
    else:
        assert all(cluster_split(n_fft, c).smem_bytes > MIXED_MAX_SMEM for c in range(2, ctas))


@pytest.mark.parametrize("n_fft,fits", [
    (206208, True), (FIRST_BEYOND, False), (FIRST_BEYOND + 1, True), (617400, True),
    (617402, False), (1 << 20, False),
])
def test_limit_is_sixteen_ctas_of_shared_memory(n_fft, fits):
    """The body's limit: a plan whose share in 16 CTAs fits in 227 KB each.
    206,215 is the first n_fft beyond it; above it the sizes whose plan
    still fits are taken (206,216: L 103,108 = 4 x 149 x 173 direct), the
    largest a 7-smooth half (617,400, L 308,700 direct). Beyond it the
    wrapper raises a ValueError that names the limit, before any launch."""
    assert body(n_fft) == "cluster"
    assert (cluster_split(n_fft, CLUSTER_MAX).smem_bytes <= MIXED_MAX_SMEM) == fits
    if fits:
        assert 2 <= cluster_size(n_fft) <= CLUSTER_MAX
        return
    with pytest.raises(ValueError, match=f"{CLUSTER_MAX} CTAs of {MIXED_MAX_SMEM:,} bytes"):
        cluster_size(n_fft)
    cfg = FrontendConfig(n_fft=n_fft, hop_length=n_fft // 2, center=False)
    with pytest.raises(ValueError, match="beyond the cluster body's limit"):
        _launch_cluster(torch.zeros(n_fft), n_fft // 2, 1, n_fft, cfg)


def test_first_beyond_is_the_first():
    """Every n_fft below 206,215 is served: by byte counts alone (points, the
    next 7-smooth length from a table, no plan built and nothing allocated),
    the Bluestein plan of every n_fft below 206,209 fits 16 CTAs, and
    `mixed_plan` picks a plan 16 CTAs hold wherever one exists; from 206,209
    to 206,214 a direct or Rader plan fits where Bluestein does not; at
    206,215 none does. Checked against `mixed_plan` on a sample: the plan
    is held, and it is Bluestein's (or, in one block, a nested Rader plan)
    where L has a prime above MATRIX_MAX whose p - 1 has one too."""
    n_fft = np.arange(1, FIRST_BEYOND + 1, dtype=np.int64)
    points = np.where(n_fft % 2 == 1, n_fft, n_fft // 2)
    smooth7 = np.array(sorted(2**a * 3**b * 5**c * 7**d for a in range(21) for b in range(14)
                              for c in range(10) for d in range(9)
                              if 2**a * 3**b * 5**c * 7**d < 1 << 21), np.int64)
    blue = smooth7[np.searchsorted(smooth7, 2 * points - 1)]
    share = 8 * -(-blue // CLUSTER_MAX) + 4 * -(-(n_fft // 2 + 1) // CLUSTER_MAX)
    blue_fits = share <= MIXED_MAX_SMEM
    assert blue_fits[: 206208].all() and not blue_fits[206208]
    for n in range(206209, FIRST_BEYOND + 1):
        assert (cluster_split(n, CLUSTER_MAX).smem_bytes <= MIXED_MAX_SMEM) == (n < FIRST_BEYOND)
    from sed_crnn_torch.ops.kernels.fused_logmel import MATRIX_MAX, _prime_factors

    rng = np.random.default_rng(0)
    for i in rng.integers(0, FIRST_BEYOND - 1, 300):
        n = int(n_fft[i])
        plan = mixed_plan(n)
        assert cluster_split(n, CLUSTER_MAX).smem_bytes <= MIXED_MAX_SMEM
        primes = _prime_factors(int(points[i]))
        big = [p for p in primes if p > MATRIX_MAX]
        if big and any(q > MATRIX_MAX for q in _prime_factors(big[0] - 1)):
            assert plan.bluestein and plan.n == blue[i] or plan.nested
        if plan.bluestein:
            assert plan.n == blue[i]
        else:
            assert plan.n == points[i]


def test_every_size_the_retired_body_held_on_the_card_is_served():
    """The retired dft body kept two dense (n_fft, NB) float32 bases on the
    card (NB the bins padded to 64), so it could run only where they fit
    in 80 GiB: n_fft up to about 146,000. Every such n_fft lies below the
    cluster body's first refused size, so none that used to run raises."""
    n_fft = np.arange(1, 400000, dtype=np.int64)
    bases = 2 * 4 * n_fft * (-(-(n_fft // 2 + 1) // BIN_TILE) * BIN_TILE)
    held = n_fft[bases <= 80 * 2**30]
    assert held.max() < FIRST_BEYOND
    assert 140000 < held.max() < 150000


def test_body_never_names_the_dft_body():
    """`body` is "fft", "mixed" or "cluster" at every n_fft from 1 to the
    limit (every size to 12,864, sampled above), and the cluster body takes
    every sampled size beyond the mixed body's limit."""
    assert {body(n) for n in range(1, 12865)} == {"fft", "mixed"}
    sampled = list(range(12865, FIRST_BEYOND, 97)) + [FIRST_BEYOND - 1]
    bodies = {n: body(n) for n in sampled}
    assert set(bodies.values()) <= {"mixed", "cluster"}
    assert sum(b == "cluster" for b in bodies.values()) > 0.9 * len(sampled)
    for n, b in bodies.items():
        if b == "cluster":
            assert cluster_split(n, cluster_size(n)).smem_bytes <= MIXED_MAX_SMEM


def _seven_smooth(k):
    for p in (2, 3, 5, 7):
        while k % p == 0:
            k //= p
    return k == 1


def test_next_smooth_is_the_smallest_seven_smooth_length():
    for n in list(range(1, 3000)) + [25719, 100003, 412417, 413000]:
        m = _next_smooth(n)
        assert m >= n and mixed_plan(2 * m).n == m   # 2m: L = m, 7-smooth, direct
        assert _seven_smooth(m) and not any(_seven_smooth(k) for k in range(max(n, 1), m))


# n_fft, hop: the sizes that matrix stages (12865, 23042) and Rader stages
# (12867, 23054) put on the mixed body, 1 s at 44.1 and 48 kHz (direct), and
# the cluster body's Bluestein (25734, on radices 8, 9, 5) and matrix
# (31290) plans.
SIZES = [(12865, 6432), (23042, 11521), (44100, 22050), (48000, 24000), (12867, 6433),
         (23054, 11527), (25734, 12867), (31290, 15645)]


@pytest.mark.parametrize("log_floor", [None, 1e-10])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n_fft,hop", SIZES)
def test_cluster_plain_matches_references(n_fft, hop, center, log_floor):
    """A clip of 7 frames with a silent middle half: the plain version both
    bodies repeat, against float64 rFFT + mel and the JAX package's
    `extract` (fft backend), -inf rows equal."""
    kw = dict(n_fft=n_fft, hop_length=hop, center=center, log_floor=log_floor)
    cfg = FrontendConfig(**kw)
    y = _signal(6 * hop + (1 if center else n_fft), cfg.sample_rate, seed=n_fft % 97)
    got = mixed_log_mel_plain(torch.from_numpy(y), cfg).numpy()
    assert got.shape == (7, cfg.n_mels)
    _assert_log_close(got, _rfft_log_mel(y, cfg), 1e-4)
    jax_got = jax_frontend.extract(y, JaxFrontendConfig(**kw), bucket_seconds=0)
    _assert_log_close(got, jax_got, 5e-4)
    assert np.isneginf(got).any() == (log_floor is None)


def test_plan_tables_multiply_to_the_transform():
    """The radices of every timed size multiply to N and are the mixed
    body's; at most 16 stages."""
    for n_fft, _ in SIZES + [(88200, 44100), (131072, 32768)]:
        plan = mixed_plan(n_fft)
        assert math.prod(plan.radices) == plan.n and len(plan.radices) <= 16


def test_phases_tool_builds_the_kernels_own_cuts():
    """`sed_crnn_torch.tools.logmel_phases` builds the cluster body at each of
    its named profiling cuts (the matrix and Rader stages among them); the
    source defines the macro as 0 (no cut) and guards each phase the tool
    names with its level; its sizes are the cluster body's, a Rader and a
    matrix plan among them."""
    from sed_crnn_torch.ops.kernels import _build
    from sed_crnn_torch.tools import logmel_phases as tool

    src = (_build.CSRC_DIR / "logmel_cluster.cu").read_text()
    assert "#define LOGMEL_CLUSTER_CUT 0" in src
    assert tool.VARIANTS == {"full": 0, "no_mel": 1, "no_power": 2, "no_matrix": 3,
                             "no_rader": 4, "no_stages": 5}
    for level in (1, 2, 3, 4, 5):
        assert f"CUT < {level}" in src, level
    assert [n for n, _ in tool.SIZES] == [25734, 31290, 44100, 48000, 88200, 12941, 23792,
                                          21599, 24763, 29517, 141001]
    assert all(body(n) == "cluster" for n, _ in tool.SIZES)
    assert mixed_plan(25734, "rader").rader and mixed_plan(31290).matrix == (149,)
    assert mixed_plan(12941, "rader").rader_matrix == (647,) and mixed_plan(21599).bluestein
    with pytest.raises(ValueError, match="no nested plan"):   # beyond one block
        mixed_plan(12941, "nested")


def test_phases_tool_refuses_without_a_card(monkeypatch, capsys):
    """Without a CUDA card the tool builds and launches nothing: exit 2."""
    from sed_crnn_torch.tools import logmel_phases as tool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tool, "build_variants", lambda *a: pytest.fail("built without a card"))
    assert tool.main([]) == 2
    assert "a CUDA card is required" in capsys.readouterr().err


@pytest.mark.parametrize("bad", [1, FIRST_BEYOND])
def test_phases_tool_refuses_a_size_no_body_takes(monkeypatch, capsys, bad):
    """``--sizes`` takes any n_fft a body of kernel A takes (its lists' own
    and others, such as 4001, at hop n_fft / 2); n_fft 1 (hop 0) and the
    first size beyond the cluster body's limit are an argument error (exit
    2) before anything is built, and the sizes it takes meet the card
    check."""
    from sed_crnn_torch.tools import logmel_phases as tool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tool, "build_variants", lambda *a: pytest.fail("built"))
    with pytest.raises(SystemExit) as exc:
        tool.main(["--sizes", "1103", str(bad)])
    assert exc.value.code == 2 and f"--sizes [{bad}]" in capsys.readouterr().err
    assert tool.main(["--sizes", "1103", "4001", "25734", "--body", "mixed"]) == 2
    assert "a CUDA card is required" in capsys.readouterr().err
