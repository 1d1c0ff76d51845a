"""Kernel A's nested Rader stage and composite register radices on the CPU.

A Rader stage's p - 1 point inner transforms may end in a Rader stage of
their own, for p - 1's largest prime q (`_rader_radices` (L, nested=True)):
its gather, its q - 1 point transforms, its product and, in the transposed
inner transform, its scatter back to the runs of q points; in one block
only (the mixed body: the cluster body runs no nested stage). And the
register stages take the composite radices 8, 9 and 16 (`COMPOSITE`; 16
only where the plan runs in the wide instantiations). These tests hold the
plan, its host tables, the launchers' arguments and the plain version the
bodies repeat (`mixed_log_mel_plain`) against float64 and against the JAX
package.

Bands, in the log domain at finite entries, -inf entries equal: 1e-4
against ``np.fft.rfft`` + mel in float64, 5e-4 against the JAX package's
``extract`` (fft backend), as in tests/test_torch_logmel_cluster.py.
"""

import math

import numpy as np
import pytest
import torch

from sed_crnn_tpu.core.config import FrontendConfig as JaxFrontendConfig
from sed_crnn_tpu.ops import frontend as jax_frontend

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels import fused_logmel as fl
from sed_crnn_torch.ops.kernels.fused_logmel import (
    CLUSTER_MAX,
    COMPOSITE,
    MATRIX_MAX,
    MIXED_MAX_SMEM,
    REGISTER_RADICES,
    body,
    cluster_size,
    mixed_log_mel_plain,
    mixed_plan,
    nested_tables,
    plan_positions,
    rader_tables,
)
from sed_crnn_torch.ops.mel import mel_filterbank
from sed_crnn_torch.ops.stft import hann_window

# n_fft: (L, the Rader prime p, the nested prime q). 2579 (odd, L prime:
# 2578 = 2 x 1289, 1288 = 2^3 x 7 x 23), 4126 (L 2063: 2062 = 2 x 1031, 1030
# = 2 x 5 x 103), 12895 (L 5 x 2579) and 12899 (L prime: 12898 = 2 x 6449,
# 6448 = 2^4 x 13 x 31): each Rader prime's p - 1 has a prime above
# MATRIX_MAX, so before the nested stage Bluestein was their only plan.
NESTED = {2579: (2579, 2579, 1289), 4126: (2063, 2063, 1031), 12895: (12895, 2579, 1289),
          12899: (12899, 12899, 6449)}


@pytest.mark.parametrize("n_fft", list(NESTED))
def test_nested_plans(n_fft):
    """The forced nested plan: the outer radices, the Rader prime p last;
    the inner radices end in the nested prime q (p - 1's largest, above
    MATRIX_MAX here); q - 1's radices direct; every kind where it belongs,
    two work arrays and nothing more, one block; "rader" forces the same
    plan where it is L's only Rader plan."""
    points, p, q = NESTED[n_fft]
    plan = mixed_plan(n_fft, "nested")
    assert plan.points == points == plan.n and not plan.bluestein
    assert plan.rader_prime == p and plan.nested_prime == q and plan.rader[-1] == q
    assert math.prod(plan.radices) == points and math.prod(plan.rader) == p - 1
    assert math.prod(plan.nested) == q - 1 and q > MATRIX_MAX
    assert q == fl._prime_factors(p - 1)[-1]
    assert plan.nested == fl._direct_radices(q - 1, wide=True)
    assert plan.rader[:-1] == fl._direct_radices((p - 1) // q, wide=True)
    assert plan.kinds[-1] == "rader" and all(k != "rader" for k in plan.kinds[:-1])
    assert plan.rader_matrix == () and plan.nested_matrix == tuple(
        r for r in plan.nested if r > 13 and r % 2)
    assert plan.smem_bytes == 16 * points + 4 * (n_fft // 2 + 1) <= MIXED_MAX_SMEM
    assert body(n_fft) == "mixed"
    assert mixed_plan(n_fft, "rader") == plan
    assert plan.tensor_cores == bool(plan.nested_matrix)


def test_nested_plan_radices_at_the_sizes_of_the_sweep():
    """The plans `mixed_plan` builds for the sizes the card timed (its
    choice among them by `plan_cost`: PERF.md §6)."""
    got = {n: (mixed_plan(n, "nested").radices, mixed_plan(n, "nested").rader,
               mixed_plan(n, "nested").nested) for n in NESTED}
    assert got == {2579: ((2579,), (2, 1289), (8, 7, 23)),
                   4126: ((2063,), (2, 1031), (2, 5, 103)),
                   12895: ((5, 2579), (2, 1289), (8, 7, 23)),
                   12899: ((12899,), (2, 6449), (16, 13, 31))}


@pytest.mark.parametrize("n_fft", [1018, 23158, 1034])
def test_nested_plan_against_a_matrix_stage(n_fft):
    """Where q is at most MATRIX_MAX, L has both Rader plans in one block:
    the inner transforms end in a matrix stage of q ("rader") or in a
    nested Rader stage of q ("nested"); the two differ only there."""
    rader, nested = mixed_plan(n_fft, "rader"), mixed_plan(n_fft, "nested")
    assert rader.radices == nested.radices and rader.rader == nested.rader
    q = nested.nested_prime
    assert q <= MATRIX_MAX and rader.rader_matrix[-1] == q and not rader.nested
    assert q not in nested.rader_matrix and math.prod(nested.nested) == q - 1


def _dft64(x):
    """A direct float64 DFT, the phases reduced exactly."""
    n = len(x)
    km = np.outer(np.arange(n), np.arange(n)) % n
    return np.exp(-2j * np.pi * km / n) @ x


@pytest.mark.parametrize("n_fft", [2579, 4126])
def test_nested_tables_within_one_ulp_of_float64(n_fft):
    """The outer stage's filter spectrum stored where its nested inner
    transforms leave each frequency, and the nested stage's own tables
    (generator powers, twiddles, filter spectrum at its inner DIF
    positions), each part within one float32 ulp of a direct float64
    DFT."""
    plan = mixed_plan(n_fft, "nested")
    for p, inner, nested, tables in (
            (plan.rader_prime, plan.rader, plan.nested,
             rader_tables(plan.rader_prime, plan.rader, plan.nested)),
            (plan.nested_prime, plan.nested, (),
             {k[0].replace("n", "r", 1) + k[1:]: v
              for k, v in nested_tables(plan.nested_prime, plan.nested).items()})):
        count = p - 1
        g = int(tables["rgather"][1])
        assert g == fl._primitive_root(p)
        assert sorted(tables["rgather"].tolist()) == list(range(1, p))
        ginv = pow(g, p - 2, p)
        b = np.exp(-2j * np.pi * np.array([pow(ginv, m, p) for m in range(count)],
                                          np.float64) / p)
        want = _dft64(b) / count
        got = tables["rspec"][plan_positions(tuple(inner), tuple(nested))]
        assert got.dtype == np.float32 and got.shape == (count, 2)
        err = np.maximum(np.abs(got[:, 0] - want.real), np.abs(got[:, 1] - want.imag))
        assert np.all(err <= np.spacing(np.abs(want).astype(np.float32)))
        ang = 2.0 * np.pi * np.arange(count) / count
        assert np.all(np.abs(tables["rtw"].astype(np.float64)
                             - np.stack([np.cos(ang), -np.sin(ang)], 1))
                      <= np.spacing(np.abs(tables["rtw"])))


@pytest.mark.parametrize("n_fft", [2579, 4126, 1034])
def test_inner_transform_leaves_frequencies_where_the_tables_say(n_fft):
    """The inner (p - 1)-point transform with its nested stage, run by the
    plain version on a batch of random sequences: forward, frequency k of
    sequence b at the global layout the product reads (transform b's body
    at b s + l, its tail after every body), each within 1e-4 of its
    float64 DFT's scale; transposed, that layout taken back to the DFT in
    natural order (the DFT matrix is symmetric)."""
    plan = mixed_plan(n_fft, "nested")
    p, q = plan.rader_prime, plan.nested_prime
    count, batches = p - 1, 3
    ops = fl.plan_operands(16000, 40, 0.0, None, plan)
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((1, batches * count)) + 1j * rng.standard_normal((1, batches * count))
    nest = tuple(torch.from_numpy(ops[k]) for k in ("ngather", "ntw", "nspec"))
    rtw = torch.from_numpy(ops["rtw"])
    ar, ai = fl._inner_transform(torch.from_numpy(x.real).float(), torch.from_numpy(x.imag).float(),
                                 plan.rader, plan.nested, rtw, nest, False)
    local = plan_positions(plan.rader, plan.nested)
    split = count - count // q
    body_end = batches * split
    for b in range(batches):
        want = np.fft.fft(x[0, b * count:(b + 1) * count])
        glob = np.where(local < split, b * split + local,
                        body_end + b * (count - split) + (local - split))
        got = ar[0, glob].double().numpy() + 1j * ai[0, glob].double().numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    layout = np.empty(batches * count, np.complex128)
    for b in range(batches):
        glob = np.where(local < split, b * split + local,
                        body_end + b * (count - split) + (local - split))
        layout[glob] = x[0, b * count:(b + 1) * count]
    tr, ti = fl._inner_transform(torch.from_numpy(layout.real[None]).float(),
                                 torch.from_numpy(layout.imag[None]).float(), plan.rader,
                                 plan.nested, rtw, nest, True)
    for b in range(batches):
        want = np.fft.fft(x[0, b * count:(b + 1) * count])
        got = (tr[0, b * count:(b + 1) * count].double().numpy()
               + 1j * ti[0, b * count:(b + 1) * count].double().numpy())
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("radix", sorted(COMPOSITE))
def test_composite_butterflies_are_the_dft(radix):
    """`_radix_butterfly` at 8, 9 and 16 (the kernels' ``butterfly<R>``: B
    A-point butterflies, the twiddles, A B-point ones) within 1e-6 of a
    float64 DFT; its float32 constants are those of cos and sin rounded
    once."""
    n = radix * 5
    tw = torch.from_numpy(fl._unit_roots(n, n))
    rng = np.random.default_rng(radix)
    v = rng.standard_normal((radix, 7)) + 1j * rng.standard_normal((radix, 7))
    vr = [torch.from_numpy(v[r].real).float() for r in range(radix)]
    vi = [torch.from_numpy(v[r].imag).float() for r in range(radix)]
    out_r, out_i = fl._radix_butterfly(radix, vr, vi, tw[:, 0], tw[:, 1])
    got = np.stack([o.double().numpy() for o in out_r]) + 1j * np.stack(
        [o.double().numpy() for o in out_i])
    np.testing.assert_allclose(got, np.fft.fft(v, axis=0), rtol=0, atol=1e-5)
    assert fl._C8 == float(np.float32(np.cos(np.pi / 4)))
    assert (fl._C16, fl._S16) == (float(np.float32(np.cos(np.pi / 8))),
                                  float(np.float32(np.sin(np.pi / 8))))


def test_power_radices_by_weight():
    """Powers of 2 and 3 split into the radices of least total weight;
    radix 16 only where the plan runs wide; with the composite radices
    weighed out, the split of radices 4, 2 and 3 alone (the plans before
    them)."""
    inf = math.inf
    old = dict(fl.RADIX_WEIGHT)
    try:
        fl.RADIX_WEIGHT.update({8: inf, 9: inf, 16: inf})
        fl._power_radices.cache_clear()
        assert fl._power_radices(2, 7) == (4, 4, 4, 2) and fl._power_radices(3, 4) == (3,) * 4
        fl.RADIX_WEIGHT.update({8: 1.2, 9: 1.2, 16: 1.5})
        fl._power_radices.cache_clear()
        assert fl._power_radices(2, 6) == (8, 8) and fl._power_radices(2, 8, True) == (16, 16)
        assert fl._power_radices(2, 8) == (8, 8, 4) and fl._power_radices(3, 5) == (9, 9, 3)
    finally:
        fl.RADIX_WEIGHT.clear()
        fl.RADIX_WEIGHT.update(old)
        fl._power_radices.cache_clear()
    assert set(COMPOSITE) <= set(REGISTER_RADICES)
    for n in range(1, 400):
        radices = fl._smooth_radices(fl._next_smooth(n))
        assert 16 not in radices and math.prod(radices) == fl._next_smooth(n)


def test_plan_counts_of_a_nested_plan():
    """`plan_counts` counts a nested stage's gather (or scatter), product
    and inner transforms within each inner transform (12895: radix 5, then
    Rader 2579 over 2 and Rader 1289 over 8, 7 and 23)."""
    plan = mixed_plan(12895, "nested")
    n1 = 12895 - 12895 // 2579           # the Rader stage's N'
    n2 = n1 - n1 // 1289                 # the nested stage's N''
    w = fl.RADIX_WEIGHT
    reg, mat = fl.plan_counts(plan.n, plan.radices, False, plan.rader, plan.nested)
    nested_reg = n2 * (w[8] + w[7])
    assert reg == pytest.approx(12895 * w[5] + 2 * (n1 * w[2] + 2 * nested_reg + 2 * n2) + 2 * n1)
    assert mat == 2 * 2 * (-(-(n2 // 23) // 8) * fl.matrix_tiles(23) ** 2)
    assert not fl._narrow(plan.radices, plan.rader)
    blue = mixed_plan(12895, "bluestein")
    assert fl._narrow(blue.radices) and fl.plan_cost(
        blue.n, blue.radices, True) == pytest.approx(fl.COST_NARROW * fl.COST_REGISTER * (
            2 * sum(blue.n * w[r] for r in blue.radices) + blue.n))


# Cluster-body sizes whose L has a nested Rader plan beyond one block
# (12941: 12941 over 4 x 5 x 647, 646 = 2 x 17 x 19; 23792: 1487 over 2 x
# 743; 25734; 31290; 141000; 141001; 206215, the first n_fft beyond the
# cluster body's limit).
BEYOND_ONE_BLOCK = (12941, 23792, 25734, 31290, 141000, 141001, 206215)


@pytest.mark.parametrize("n_fft", BEYOND_ONE_BLOCK)
def test_no_nested_plan_beyond_one_block(n_fft):
    """The cluster body runs no nested stage: where L's nested Rader plan
    takes more than one block, `mixed_plan` has none (a forced "nested"
    raises, its own plan is not nested) and the cluster wrapper refuses
    such a plan before any launch."""
    points = n_fft if n_fft % 2 else n_fft // 2
    outer, inner, nested = fl._rader_radices(points, nested=True)
    plan = fl._make_plan(n_fft, points, outer, False, inner, nested)
    assert plan.nested and plan.smem_bytes > MIXED_MAX_SMEM
    with pytest.raises(ValueError, match="no nested plan"):
        mixed_plan(n_fft, "nested")
    if n_fft < 206215:
        assert not mixed_plan(n_fft).nested
    cfg = FrontendConfig(n_fft=n_fft, hop_length=n_fft // 2, center=False)
    with pytest.raises(ValueError, match="runs no nested Rader stage"):
        fl.launch_cluster_plan(torch.zeros(2 * n_fft), n_fft // 2, 2, cfg, plan, {})


def test_mixed_launcher_takes_a_nested_plan(monkeypatch):
    """The wrapper hands the mixed launcher the nested stage's radices and
    tables after the Rader stage's (a stand-in library records the call)."""
    calls = []

    class Fake:
        def logmel_mixed(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fl, "_mixed_lib", lambda: Fake())
    monkeypatch.setattr(torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    n_fft = 12895
    cfg = FrontendConfig(n_fft=n_fft, hop_length=6447, center=False)
    before = fl.fused_log_mel.mixed_launches
    fl._launch_mixed(torch.zeros(2 * n_fft), 6447, 2, n_fft, cfg, plan="nested")
    assert fl.fused_log_mel.mixed_launches == before + 1
    (args,) = calls
    plan = mixed_plan(n_fft, "nested")
    assert args[3:6] == (n_fft, plan.n, len(plan.radices)) and args[7] == 0
    assert args[8] == len(plan.rader) and list(args[9][: len(plan.rader)]) == list(plan.rader)
    assert args[10] == len(plan.nested) and list(args[11][: len(plan.nested)]) == list(plan.nested)
    tables = dict(zip(fl._MIXED_TABLES, args[12:28]))
    assert all(tables[k] is not None for k in ("ngather", "ntw", "nspec", "rgather", "pos", "dft"))
    assert tables["chirp"] is None and tables["bspec"] is None


def _signal(n, sr, seed):
    """Two tones and noise, silent from n / 4 to 3 n / 4."""
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


# (n_fft, forced plan): nested plans (register-only inner transforms at
# 1034: 517 = 11 x 47, 46 = 2 x 23, 22 = 2 x 11; a nested matrix stage at
# 4126, 12895, 12899, 23158), and plans on the composite radices: Bluestein
# at 12895 (M 25,920) and 2579 (M 5,184), direct at 1764 (L 882 = 2 x 9 x 7
# x 7) and 3072 (L 1536 = 2^9 x 3), radix 16 in a nested stage (12899).
PLAIN_CASES = [(1034, "nested"), (2579, "nested"), (4126, "nested"), (12895, "nested"),
               (12899, "nested"), (23158, "nested"), (12895, "bluestein"), (2579, "bluestein"),
               (1764, None), (3072, None)]


@pytest.mark.parametrize("log_floor", [None, 1e-10])
@pytest.mark.parametrize("n_fft,plan", PLAIN_CASES)
def test_plain_matches_float64(n_fft, plan, log_floor):
    """A half-silent clip of 7 frames through the plain version both bodies
    repeat, forced to the plan: within 1e-4 of float64 rFFT + mel, -inf
    rows equal."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=n_fft // 2, center=False, log_floor=log_floor)
    y = _signal(6 * (n_fft // 2) + n_fft, cfg.sample_rate, seed=n_fft % 89)
    got = mixed_log_mel_plain(torch.from_numpy(y), cfg, plan=plan).numpy()
    assert got.shape == (7, cfg.n_mels)
    _assert_log_close(got, _rfft_log_mel(y, cfg), 1e-4)
    assert np.isneginf(got).any() == (log_floor is None)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n_fft,hop", [(4126, 2063), (12895, 6447)])
def test_plain_matches_the_jax_extract(n_fft, hop, center):
    """The chosen plan's plain version (and the forced nested plan's) against
    the JAX package's `extract` (fft backend) within 5e-4, -inf rows
    equal."""
    kw = dict(n_fft=n_fft, hop_length=hop, center=center, log_floor=None)
    cfg = FrontendConfig(**kw)
    y = _signal(6 * hop + (1 if center else n_fft), cfg.sample_rate, seed=n_fft % 97)
    want = jax_frontend.extract(y, JaxFrontendConfig(**kw), bucket_seconds=0)
    for plan in (None, "nested"):
        got = mixed_log_mel_plain(torch.from_numpy(y), cfg, plan=plan).numpy()
        _assert_log_close(got, want, 5e-4)


# The n_fft below 40,000 whose own plan is nested under the refitted
# weights (`plan_cost`; PERF.md §6): sizes from 3,269 up whose nested plan
# costs less than Bluestein, and those just above the sizes whose
# Bluestein plan fits one block, where the nested plan keeps the frame in
# one block.
NESTED_CHOSEN = (3269, 3736, 4197, 4203, 4937, 5137, 5393, 5411, 5417, 6071, 6538, 6995, 7457,
                 7472, 7939, 8389, 8391, 8394, 8406, 8445, 8457, 8503, 9335, 9340, 9371, 9627,
                 9679, 9793, 9807, 9874, 10119, 10253, 10274, 10741, 10779, 10786, 10822, 10834,
                 11208, 11675, 11823, 12142, 12591, 12609, 12893, 12895, 12899, 12911, 13076,
                 13990, 14914, 14944, 15878, 16778, 16782, 16812, 16890, 16914, 17006, 18670,
                 18680, 18742, 19254, 19358, 19586, 19614, 20238, 20506, 20548, 21482, 21558,
                 21668, 22376, 22384, 22416, 23062, 23082, 23090, 23094, 23098, 23152, 23158,
                 23164, 23172, 23190, 23224)


def test_every_size_keeps_a_plan_sixteen_ctas_hold():
    """Every n_fft up to 206,214 (a stride of 29, every size within 2 of a
    multiple of 4,096, and `NESTED_CHOSEN`) gets a plan: where one of the
    plans without a nested stage was held by 16 CTAs, the chosen one is too
    (so no n_fft that ran before is refused); a nested plan only in one
    block, for a
    Rader prime whose p - 1 has its largest prime q above 13 with a direct
    plan for q - 1, and at each of `NESTED_CHOSEN`."""
    sizes = sorted(set(range(2, 206215, 29)) |
                   {k * 4096 + d for k in range(1, 51) for d in range(-2, 3)} |
                   set(NESTED_CHOSEN) | {206214})
    nested = 0
    for n_fft in sizes:
        plan = mixed_plan(n_fft)
        held_before = [fl._cluster_bytes(mixed_plan(n_fft, k), CLUSTER_MAX) <= MIXED_MAX_SMEM
                       for k in ("direct", "bluestein")
                       if k == "bluestein" or fl._direct_radices(plan.points) is not None]
        with_rader = fl._rader_radices(plan.points)
        if with_rader is not None:
            held_before.append(fl._cluster_bytes(
                fl._make_plan(n_fft, plan.points, with_rader[0], False, with_rader[1]),
                CLUSTER_MAX) <= MIXED_MAX_SMEM)
        if any(held_before):
            assert fl._cluster_bytes(plan, CLUSTER_MAX) <= MIXED_MAX_SMEM, n_fft
            if body(n_fft) == "cluster":
                assert cluster_size(n_fft) <= CLUSTER_MAX
        if plan.nested:
            nested += 1
            q = plan.nested_prime
            assert plan.smem_bytes <= MIXED_MAX_SMEM and body(n_fft) == "mixed"
            assert q == fl._prime_factors(plan.rader_prime - 1)[-1] > 13
            assert all(r <= MATRIX_MAX for r in fl._prime_factors(q - 1))
    assert nested >= len(NESTED_CHOSEN)
    assert all(mixed_plan(n).nested for n in NESTED_CHOSEN)
