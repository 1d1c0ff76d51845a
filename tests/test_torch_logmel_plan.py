"""The plan of kernel A's mixed and cluster bodies on the CPU: register
radices 2-13, matrix stages for the primes above (``matrix_stage`` of
``csrc/logmel_stages.cuh``: two real products on the tensor cores), a Rader
stage for the largest prime where the cost model says so (and for the primes
above ``MATRIX_MAX`` whose p - 1 has a direct plan), Bluestein for the rest
or where the cost model says so; the body by size; the matrix stages' host
tables; the mel sums' lane order; and `mixed_log_mel_plain` at the new
plans against float64 rFFT + mel, the JAX package's `extract` and its fused
kernel (interpreted).

Bands, in the log domain at finite entries, -inf entries equal: 1e-4
against ``np.fft.rfft`` + mel in float64 (float32 rounding of the register
stages, the float64 matrix product rounded once, the mel sums); 5e-4
against the JAX package (the band every kernel A route is held to,
tests/test_frontend_parity.py). The JAX kernel is not run from 12865 on:
it builds dense (n_fft, n_fft / 2) float64 bases (1.3 GB at 12865) before
its interpreted kernel runs; `extract` is.
"""

import math
import re
from pathlib import Path

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
    PLAN_KINDS,
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


# n_fft: (radices, Rader inner radices, Bluestein, body). L 1001 = 7 x 11 x
# 13 (register radices only), 517 = 11 x 47, 551 = 19 x 29, 12865 = 5 x 31 x
# 83 (two work arrays and the power row, 231,572 bytes: one block), 13 (one
# radix-13 stage), 1103 and 2206 (L 1103, a prime above MATRIX_MAX: its
# Rader stage over 1102 = 2 x 19 x 29 costs less than Bluestein on radices
# 9, 5, 7, 7 under the refitted weights, as the card timed it at
# 1103), 11522 = 2 x 7 x 823 (a Rader stage of 823, cheaper than
# its matrix stage), 12867 = 3 x 4289 and 11527 (prime) (the first odd and
# even sizes that were Bluestein on the cluster body: Rader stages in one
# block, 4288 over 8 x 8 x 67), 25734 (L 12867 at an even n_fft: on the
# cluster body a Rader stage over 4 x 4 x 4 x 67 under the refitted
# weights, 3.2 % slower there than Bluestein at M 25,920),
# 31290 (L 3 x 5 x 7 x 149: a matrix stage on the cluster body) and 4126 (L
# 2063, prime, 2062 = 2 x 1031: its nested Rader plan costs more than
# Bluestein).
PLANS = {
    1001: ((7, 11, 13), (), False, "mixed"),
    1034: ((11, 47), (), False, "mixed"),
    1102: ((19, 29), (), False, "mixed"),
    12865: ((5, 31, 83), (), False, "mixed"),
    26: ((13,), (), False, "mixed"),
    2206: ((1103,), (2, 19, 29), False, "mixed"),
    12867: ((3, 4289), (8, 8, 67), False, "mixed"),
    23044: ((2, 7, 823), (2, 3, 137), False, "mixed"),
    23054: ((11527,), (2, 3, 17, 113), False, "mixed"),
    1103: ((1103,), (2, 19, 29), False, "mixed"),
    25734: ((3, 4289), (4, 4, 4, 67), False, "cluster"),
    31290: ((3, 5, 7, 149), (), False, "cluster"),
    4126: ((8, 3, 5, 5, 7), (), True, "mixed"),
}


@pytest.mark.parametrize("n_fft", list(PLANS))
def test_new_plans(n_fft):
    """Direct plans take the register radices and, above 13, matrix stages
    (ascending, after the register stages), or a Rader stage last for the
    largest prime (its inner radices `_direct_radices` (p - 1)); Bluestein
    keeps 7-smooth M. Two work arrays with a matrix or Rader stage."""
    radices, inner, blue, where = PLANS[n_fft]
    plan = mixed_plan(n_fft)
    assert (plan.radices, plan.rader, plan.bluestein, body(n_fft)) == (radices, inner, blue, where)
    assert math.prod(plan.radices) == plan.n and len(plan.radices) <= fl.MIXED_MAX_STAGES
    rader = radices[-1] if inner else 0
    assert plan.rader_prime == rader
    assert plan.matrix == tuple(r for r in radices[: len(radices) - bool(inner)] if r > 13)
    assert plan.kinds == tuple("rader" if r == rader and s == len(radices) - 1 else
                               "matrix" if r > 13 else "register" for s, r in enumerate(radices))
    arrays = 2 if plan.matrix or inner else 1   # matrix and Rader stages write out of place
    # the power row's place holds the wgmma stages' B slab where that is larger
    assert plan.smem_bytes == 8 * arrays * plan.n + max(4 * (n_fft // 2 + 1), fl.ring_bytes(plan))
    if blue:
        assert plan.n == _next_smooth(2 * plan.points - 1)
        assert set(plan.radices) <= {2, 3, 4, 5, 7, 8, 9}
    else:
        assert plan.n == plan.points and list(plan.matrix) == sorted(plan.matrix)
    if inner:
        # composite radices only in one block (`mixed_plan`)
        one_block = plan.smem_bytes <= MIXED_MAX_SMEM
        assert math.prod(inner) == rader - 1
        assert inner == fl._direct_radices(rader - 1, True, one_block)
        assert rader == max(fl._prime_factors(plan.points)) > 13


def test_1103_has_a_prime_above_the_bound():
    """An odd prime n_fft above MATRIX_MAX: no direct plan without a Rader
    stage; its Rader stage runs over 1102 = 2 x 19 x 29 (a register stage
    and two matrix stages), and costs less by the refitted cost model than
    Bluestein at M 2,205 on radices 9, 5, 7, 7 (narrow, in one
    block): the card timed it 3.8 % faster (PERF.md §6)."""
    assert MATRIX_MAX < 1103 <= 2 * MATRIX_MAX
    plan = mixed_plan(1103, "rader")
    assert not plan.bluestein and plan.radices == (1103,) and plan.rader == (2, 19, 29)
    assert plan.kinds == ("rader",) and plan.rader_matrix == (19, 29) and body(1103) == "mixed"
    with pytest.raises(ValueError, match="L = 1103 has no direct plan"):
        mixed_plan(1103, "direct")
    blue = mixed_plan(1103, "bluestein")
    assert plan == mixed_plan(1103) and blue.radices == (9, 5, 7, 7)
    assert blue.n == 2205 and plan_cost(plan.n, plan.radices, False, rader=plan.rader) < plan_cost(
        blue.n, blue.radices, True)


def test_matrix_bound_is_the_kernels_tile_limit():
    """MATRIX_MAX is the largest prime whose column tiles the mixed body's
    launcher takes (MATRIX_TILES)."""
    assert matrix_tiles(MATRIX_MAX) <= MATRIX_TILES
    nxt = next(p for p in range(MATRIX_MAX + 1, 4 * MATRIX_MAX)
               if all(p % q for q in range(2, int(p ** 0.5) + 1)))
    assert matrix_tiles(nxt) > MATRIX_TILES
    assert set(REGISTER_RADICES) == {2, 3, 4, 5, 7, 8, 9, 11, 13, 16}


def test_a_matrix_plan_beyond_one_block_takes_bluestein():
    """L 31,744 = 31 x 1024 has a direct plan with a matrix stage, 634,884
    bytes: more than one block. The cluster body has matrix stages, so
    `mixed_plan` keeps it where it costs less than Bluestein there, and the
    cluster body runs it at 3 CTAs: two work arrays a CTA, the matrix stage
    the last, crossing CTAs (a chunk of 10,582 points is no multiple of
    31)."""
    direct = mixed_plan(63488, "direct")
    assert direct.matrix == (31,) and direct.smem_bytes > MIXED_MAX_SMEM
    blue = mixed_plan(63488, "bluestein")
    assert plan_cost(direct.n, direct.radices, False, True) < plan_cost(blue.n, blue.radices,
                                                                        True, True)
    plan = mixed_plan(63488)
    assert plan == direct and body(63488) == "cluster"
    sp = fl.cluster_split(63488, fl.cluster_size(63488))
    assert sp.smem_bytes == 16 * sp.chunk + max(4 * sp.bin_chunk, 256 + sp.ring if sp.ring else 0)
    assert sp.smem_bytes <= MIXED_MAX_SMEM
    assert (sp.ctas, sp.chunk) == (3, 10582) and sp.cross[-1] and sp.chunk % 31 != 0


class _FakeClusterLib:
    """Stands in for the built ``logmel_cluster`` library: records the
    arguments of one launch and of its forms query, returns success and
    the mma.sync form."""

    def __init__(self):
        self.calls, self.forms = [], []

    def logmel_cluster(self, *args):
        self.calls.append(args)
        return 0

    def logmel_cluster_forms(self, *args):
        self.forms.append(args)
        return 1


@pytest.mark.parametrize("n_fft", [1034, 12865, 1103, 25734])
def test_cluster_launcher_takes_matrix_and_rader_plans(n_fft, monkeypatch):
    """Forced onto the cluster body, a plan with a matrix or Rader stage is
    no longer refused: the wrapper hands the launcher the plan's radices,
    the Rader stage's inner radices, the split (chunk, crossing bits) and
    the value tables (no nested stage's: the cluster body runs none), and
    counts one cluster launch (1103 and 25734: their Rader plans,
    forced)."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=n_fft // 2, center=False)
    kind = "rader" if n_fft in (1103, 25734) else None
    plan = mixed_plan(n_fft, kind)
    assert plan.tensor_cores
    fake = _FakeClusterLib()
    monkeypatch.setattr(fl, "_cluster_lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: __import__("types").SimpleNamespace(cuda_stream=0))
    before = fl.fused_log_mel.cluster_launches
    _launch_cluster(torch.zeros(2 * n_fft), n_fft // 2, 2, n_fft, cfg, ctas=2, plan=kind)
    assert fl.fused_log_mel.cluster_launches == before + 1
    (args,) = fake.calls
    assert fake.forms == [args[3:10]]    # the forms query takes the launch's plan
    sp = fl.cluster_split(n_fft, 2, kind)
    assert args[3:6] == (n_fft, plan.n, len(plan.radices))
    assert list(args[6][: len(plan.radices)]) == list(plan.radices) and args[7] == 0
    assert args[8] == len(plan.rader) and list(args[9][: len(plan.rader)]) == list(plan.rader)
    assert args[10:13] == (2, sp.chunk, sp.bin_chunk)
    assert args[13] == sum(1 << s for s, c in enumerate(sp.cross) if c)
    assert args[14] == sum(1 << s for s, c in enumerate(sp.rader_cross) if c)
    assert len(args) == 15 + 13 + 5    # the 13 tables, then n_mels, floor, out, stream
    tables = args[15:28]
    assert tables[6] is not None                       # the matrix stages' fragments
    assert (tables[7] is not None) == bool(plan.rader)  # the gather, twiddles, spectrum
    assert sp.smem_bytes == 16 * sp.chunk + max(4 * sp.bin_chunk, 256 + sp.ring if sp.ring else 0)


class _FakeFunction:
    """A C function of a stand-in library: takes ``argtypes`` and
    ``restype`` and returns ``value`` when called."""

    def __init__(self, value=0):
        self.value, self.argtypes, self.restype = value, None, None

    def __call__(self, *args):
        return self.value


class _FakeLibrary:
    """Stands in for a built library: each function a `_FakeFunction`, the
    limits the wrappers check set to the values they expect."""

    def __init__(self, values):
        self.values, self.functions = values, {}

    def __getattr__(self, name):
        return self.functions.setdefault(name, _FakeFunction(self.values.get(name, 0)))


@pytest.mark.parametrize("source,function", [("logmel_mixed", "_mixed_lib"),
                                             ("logmel_cluster", "_cluster_lib"),
                                             ("logmel_fft", "_fft_lib")])
def test_argtypes_match_the_c_signatures(source, function, monkeypatch):
    """Each kernel A wrapper declares as many ctypes arguments for its
    launcher as the C interface in the source takes (ctypes refuses a call
    with fewer only on the card)."""
    from sed_crnn_torch.ops.kernels import _build

    values = {f"{source}_max_smem": MIXED_MAX_SMEM, f"{source}_max_stages": fl.MIXED_MAX_STAGES,
              f"{source}_matrix_tiles": fl.MATRIX_TILES, "logmel_cluster_max_ctas": fl.CLUSTER_MAX,
              "logmel_fft_min_log_n": fl.FFT_LOG_N[0], "logmel_fft_max_log_n": fl.FFT_LOG_N[1]}
    fake = _FakeLibrary(values)
    monkeypatch.setattr(_build, "load", lambda name: fake)
    getattr(fl, function).__wrapped__()
    text = (_build.CSRC_DIR / f"{source}.cu").read_text()
    head = text[text.index(f"\nint {source}(") :]
    params = head[head.index("(") + 1 : head.index(")")]
    assert len(fake.functions[source].argtypes) == params.count(",") + 1


@pytest.mark.parametrize("n_fft,kinds", [(1103, ("rader", "nested", "bluestein")),
                                          (1034, ("direct", "rader", "nested", "bluestein")),
                                          (4126, ("rader", "nested", "bluestein")),
                                          (44100, ("direct", "bluestein"))])
def test_a_forced_plan_kind_is_that_kind_or_raises(n_fft, kinds):
    """`mixed_plan`'s ``plan`` gives the plan of that kind where L has one
    (direct: register and matrix stages only; rader: a Rader stage last,
    the nested one where L has no other (4126); nested: a Rader stage
    nested in its inner transforms; bluestein), raises ValueError naming the
    kind where it has none, and raises on a kind it does not know; the
    size's own plan is one of them."""
    got = {}
    for kind in PLAN_KINDS:
        if kind in kinds:
            got[kind] = mixed_plan(n_fft, kind)
        else:
            with pytest.raises(ValueError, match=f"has no {kind} plan"):
                mixed_plan(n_fft, kind)
    assert set(got) == set(kinds)
    assert got["bluestein"].bluestein and not got["bluestein"].rader
    if "direct" in got:
        assert not got["direct"].bluestein and not got["direct"].rader
    if "rader" in got:
        assert not got["rader"].bluestein and got["rader"].kinds[-1] == "rader"
        assert bool(got["rader"].nested) == (got["rader"] == got["nested"])
    if "nested" in got:
        assert got["nested"].nested and got["nested"].kinds[-1] == "rader"
    assert mixed_plan(n_fft) in got.values()
    with pytest.raises(ValueError, match="unknown plan kind"):
        mixed_plan(n_fft, "matrix")


def test_cost_model_picks_the_cheaper_plan():
    """`mixed_plan` keeps the cheapest plan by `plan_cost` (on the body each
    would run on) among the matrix, Rader and Bluestein plans a size has: a
    lone prime near the bound (L 509) costs less by Bluestein's two 1,024
    point transforms on radices 8 and 4 than by a Rader stage over 508 = 4 x
    127 or its matrix stage; the sizes above keep their matrix stages."""
    for n_fft in (1034, 1102, 12865, 1018, 2050, 4418, 10006, 23042, 23044):
        plans = []
        for kind in PLAN_KINDS:
            try:
                plans.append(mixed_plan(n_fft, kind))
            except ValueError:
                continue
        want = min(plans, key=fl._plan_cost_on_body)
        assert mixed_plan(n_fft) == want, n_fft
    assert mixed_plan(1018, "rader").rader == (4, 127) and mixed_plan(1018).bluestein
    assert mixed_plan(1018).radices == (8, 8, 4, 4)
    assert not any(mixed_plan(n).bluestein or mixed_plan(n).rader for n in (1034, 1102, 12865))


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


@pytest.mark.parametrize("radix", [17, 31, 47, 67, 83, 113, 149, 373])
def test_wgmma_table_is_both_matrices_in_the_swizzle(radix):
    """Read back from the wgmma form's slabs (k step ks, part cos hi / lo,
    sin hi / lo, row n = column s, the 8 k of row n at float k, or k ^ 4
    where bit 2 of n is set: the 32-byte swizzle), every position holds
    `pair_matrices`' value as `matrix_table` splits it: the same TF32 hi and
    lo parts, zero in the padding to whole column groups."""
    t, cols = matrix_tiles(radix), fl.WGMMA_COLS
    rows = -(-t // cols) * cols * 8
    assert fl.wgmma_slab_bytes(radix) == 4 * rows * 32
    slabs = fl.wgmma_table(radix).reshape(t, 4, rows, 8)
    assert slabs.dtype == np.float32
    assert not np.any(slabs.view(np.uint32) & np.uint32(0x1FFF))
    frag = matrix_table(radix).reshape(t, t, 32, 8)
    for i, g in enumerate(pair_matrices(radix)):
        hi = _tf32(g.astype(np.float32))
        lo = _tf32((g - hi.astype(np.float64)).astype(np.float32))
        for j, want in enumerate((hi, lo)):
            back = np.zeros((8 * t, rows), np.float32)
            for n in range(rows):
                for k in range(8):
                    back[8 * np.arange(t) + k, n] = slabs[:, 2 * i + j, n, k ^ (4 * ((n >> 2) & 1))]
            np.testing.assert_array_equal(back[:, : 8 * t], want)
            assert not back[:, 8 * t:].any()
            # the mma.sync fragments hold the same parts: lane 4 g + u, k = 8 kt + u, n = 8 nt + g
            lane = np.arange(32)
            k = 8 * np.arange(t)[:, None, None] + (lane % 4)[None, None, :]
            n = 8 * np.arange(t)[None, :, None] + (lane // 4)[None, None, :]
            np.testing.assert_array_equal(frag[..., 4 * i + 2 * j], back[k, n])
            np.testing.assert_array_equal(frag[..., 4 * i + 2 * j + 1], back[k + 4, n])
    assert fl.stage_table(radix) is not None and np.array_equal(
        fl.stage_table(radix), fl.wgmma_table(radix) if fl.wgmma_radix(radix) else frag.reshape(-1))


@pytest.mark.parametrize("n_fft,kind,wgmma,mma", [
    (746, "direct", 1, 0), (141001, None, 1, 0), (4478, "rader", 1, 0), (206213, None, 0, 1),
    (12865, None, 0, 1), (1294, "direct", 0, 1), (12941, "bluestein", 0, 0), (4126, None, 0, 0)])
def test_launches_are_counted_by_form(n_fft, kind, wgmma, mma, monkeypatch):
    """A mixed or cluster launch counts in ``wgmma_launches`` where the
    library says one of its matrix stages ran on wgmma (373 at 746 and, in a
    Rader stage, at 4478 and 141001), in ``mma_launches`` where one ran on
    mma.sync (89 and 331 at 206213; 31 and 83 at 12865; 647 at 1294's direct
    plan), in neither without matrix stages (12941's Bluestein plan; 4126's
    composite plan): the wrapper passes the launch's plan to the library's
    forms query (here a stand-in that applies `wgmma_radix` to the matrix
    stages it is given, as ``make_plan`` does) and counts its bits."""
    plan = mixed_plan(n_fft, kind)

    def forms(n_fft, n, n_stages, radices, bluestein, rader_stages, rader, nested_stages=0,
              nested=None):
        stages = list(radices[: n_stages - (rader_stages > 0)])
        stages += list(rader[: rader_stages - (nested_stages > 0)])
        stages += list(nested[:nested_stages]) if nested_stages else []
        stages = [r for r in stages if r not in fl.REGISTER_RADICES]
        return (any(not fl.wgmma_radix(r) for r in stages)
                | 2 * any(fl.wgmma_radix(r) for r in stages))

    fake = type("Lib", (), {"logmel_mixed": lambda self, *a: 0,
                            "logmel_cluster": lambda self, *a: 0,
                            "logmel_mixed_forms": lambda self, *a: forms(*a),
                            "logmel_cluster_forms": lambda self, *a: forms(*a)})()
    monkeypatch.setattr(fl, "_mixed_lib", lambda: fake)
    monkeypatch.setattr(fl, "_cluster_lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: __import__("types").SimpleNamespace(cuda_stream=0))
    cfg = FrontendConfig(n_fft=n_fft, hop_length=n_fft // 2, center=False)
    ops = fl.plan_operands(cfg.sample_rate, cfg.n_mels, cfg.fmin, cfg.fmax, plan)
    ops = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in ops.items()}
    before = (fl.fused_log_mel.wgmma_launches, fl.fused_log_mel.mma_launches)
    src = torch.zeros(2 * n_fft)
    if plan.smem_bytes <= MIXED_MAX_SMEM:
        fl.launch_mixed_plan(src, n_fft // 2, 2, cfg, plan, ops)
    else:
        fl.launch_cluster_plan(src, n_fft // 2, 2, cfg, plan, ops)
    assert (fl.fused_log_mel.wgmma_launches - before[0],
            fl.fused_log_mel.mma_launches - before[1]) == (wgmma, mma)


@pytest.mark.parametrize("source", ["logmel_mixed", "logmel_cluster"])
def test_forms_query_is_the_launchers_rule(source):
    """The forms a launch is counted by come from the library's own rule:
    ``<source>_forms`` builds the plan with ``make_plan`` from the launch's
    plan arguments and returns ``plan_forms``, which reads ``plan.slab``
    (set by a wgmma stage), the field by which the launcher picks the WG
    instantiations, and ``plan.mma`` (set by a matrix stage ``wgmma_radix``
    does not name); the wrapper declares the query's arguments as the
    launcher's plan arguments."""
    from sed_crnn_torch.ops.kernels import _build

    text = (_build.CSRC_DIR / f"{source}.cu").read_text()
    head = text[text.index(f"\nint {source}_forms("):]
    body = head[head.index("{"): head.index("\n}\n")]
    assert "logmel::make_plan(plan" in body and "return logmel::plan_forms(plan);" in body
    params = head[head.index("(") + 1: head.index(")")]
    launcher = text[text.index(f"\nint {source}("):]
    launch_params = launcher[launcher.index("(") + 1: launcher.index(")")]
    for name in ("n_fft", "n", "n_stages", "radices", "bluestein", "rader_stages",
                 "rader_radices"):
        assert re.search(rf"\b{name}\b", params) and re.search(rf"\b{name}\b", launch_params)
    assert ("wg = plan.slab > 0" in text) if source == "logmel_cluster" else \
        ("if (plan.slab)" in text)
    stages = (_build.CSRC_DIR / "logmel_stages.cuh").read_text()
    assert re.search(r"int plan_forms\(const Plan& plan\) \{ return \(plan\.mma \? 1 : 0\) \| "
                     r"\(plan\.slab \? 2 : 0\); \}", stages)
    assert "if (!wgmma_radix(r)) plan.mma = 1;" in stages
    lib_text = Path(fl.__file__).read_text()
    decl = re.search(rf"lib\.{source}_forms\.argtypes = \[(.*?)\]\n", lib_text, re.S).group(1)
    assert len(re.findall(r"ctypes\.POINTER\(i\)|\bi\b", decl)) == params.count(",") + 1


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
    np.testing.assert_array_equal(ops["dft"], np.concatenate([fl.stage_table(31),
                                                              fl.stage_table(83)]))
    assert "chirp" not in ops and sorted(ops["pos"].tolist()) == list(range(12865))
    assert "dft" not in mixed_operands(44100, 1001, 40, 0.0, None)
    # A Rader plan: the outer matrix tables, then the inner ones; its tables.
    ops = mixed_operands(44100, 23042, 40, 0.0, None, plan="rader")
    np.testing.assert_array_equal(ops["dft"], fl.stage_table(41))
    assert ops["rgather"].shape == (280,) and ops["rspec"].shape == (280, 2)
    ops = mixed_operands(44100, 23054, 40, 0.0, None)
    np.testing.assert_array_equal(ops["dft"], np.concatenate([fl.stage_table(17),
                                                              fl.stage_table(113)]))
    assert sorted(ops["pos"].tolist()) == list(range(11527)) and "rspec" in ops


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
    "2206": dict(n_fft=2206, hop_length=1103),
    "12867": dict(n_fft=12867, hop_length=6433),
    "23054": dict(n_fft=23054, hop_length=11527),
    "25734": dict(n_fft=25734, hop_length=12867),
    "31290": dict(n_fft=31290, hop_length=15645),
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


@pytest.mark.parametrize("case", ["1001", "1034", "1102", "1103", "2206"])
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
    takes the mixed body, Rader plans among them; `plan_counts` counts a
    Rader stage's two inner transforms and its two passes."""
    from sed_crnn_torch.ops.kernels import _build
    from sed_crnn_torch.tools import logmel_phases as tool

    src = (_build.CSRC_DIR / "logmel_mixed.cu").read_text()
    assert "#define LOGMEL_MIXED_CUT 0" in src
    assert tool.MIXED_VARIANTS == {"full": 0, "no_mel": 1, "no_power": 2, "no_matrix": 3,
                                   "no_nested": 4, "no_rader": 5, "no_bluestein": 6,
                                   "no_stages": 7}
    for level in (1, 2, 3, 4, 5, 6, 7):
        assert f"CUT < {level}" in src, level
    assert all(body(n) == "mixed" for n, _ in tool.MIXED_SIZES)
    assert {12867, 23054, 1103} <= {n for n, _ in tool.MIXED_SIZES}
    plan = mixed_plan(12865)
    assert fl.plan_counts(plan.n, plan.radices, False) == (12865, 52 * 4 + 20 * 36)
    blue = mixed_plan(12865, "bluestein")     # M 25,920 = 8 x 8 x 9 x 9 x 5
    w = fl.RADIX_WEIGHT
    assert fl.plan_counts(blue.n, blue.radices, True) == pytest.approx(
        (2 * 25920 * (2 * w[8] + 2 * w[9] + w[5]) + 25920, 0))
    rader = mixed_plan(12867)                 # 3, Rader 4289 over 8, 8, 67
    inner = 3 * 4288
    assert fl.plan_counts(rader.n, rader.radices, False, rader.rader) == pytest.approx((
        12867 + 2 * 2 * w[8] * inner + 2 * inner, 2 * (-(-(inner // 67) // 8) * 5 * 5)))
