"""Kernel A's Rader stage on the CPU: the plan rule that gives a prime its
Rader stage, the stage's host tables (the generator's powers, the filter
spectrum), where the stage leaves X_k (`output_positions`, the ``pos`` table
the bins' power reads), a sweep showing that every n_fft still gets a plan
and a body, and the plain version at Rader plans against float64 rFFT + mel.

Bands: the tables within one float32 ulp of float64 values (a part near
zero is held to its entry's magnitude); the positions exact (a float64
mirror of the kernels' data movement against ``np.fft.fft`` within 1e-9 of
the transform's scale); log-mel within 1e-4 of float64 rFFT + mel at finite
entries, -inf entries equal.
"""

import math

import numpy as np
import pytest
import torch

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels import fused_logmel as fl
from sed_crnn_torch.ops.kernels.fused_logmel import (
    CLUSTER_MAX,
    MATRIX_MAX,
    MIXED_MAX_SMEM,
    body,
    cluster_size,
    cluster_split,
    dif_positions,
    mixed_log_mel_plain,
    mixed_plan,
    output_positions,
    rader_tables,
)
from sed_crnn_torch.ops.mel import mel_filterbank
from sed_crnn_torch.ops.stft import hann_window

# (prime, its inner radices): small, the plans' primes, and the largest a
# one-block plan takes.
PRIMES = [(17, (4, 4)), (19, (2, 3, 3)), (47, (2, 23)), (281, (4, 2, 5, 7)),
          (1103, (2, 19, 29)), (4289, (4, 4, 4, 67)), (11527, (2, 3, 17, 113))]


@pytest.mark.parametrize("p,inner", PRIMES)
def test_generator_powers_visit_every_residue(p, inner):
    """``rgather`` is g^m mod p for m < p - 1, g the smallest generator:
    every nonzero residue once, and no smaller g has order p - 1."""
    gather = rader_tables(p, inner)["rgather"]
    g = int(gather[1])
    assert gather.dtype == np.int32 and gather[0] == 1
    assert sorted(gather.tolist()) == list(range(1, p))
    assert all(int(gather[m]) == pow(g, m, p) for m in range(p - 1))
    for h in range(2, g):
        assert len({pow(h, m, p) for m in range(p - 1)}) < p - 1


@pytest.mark.parametrize("p,inner", PRIMES[:5])
def test_rader_filter_spectrum_against_a_float64_dft(p, inner):
    """``rspec`` = DFT_{p-1}(b) / (p - 1), b_m = e^{-2 pi i g^{-m} / p}, summed
    directly in float64 with the phases reduced exactly, read back through
    the inner DIF positions: each part within one float32 ulp of its entry's
    magnitude; ``rtw`` the inner twiddles within one ulp."""
    tables = rader_tables(p, inner)
    count = p - 1
    g = int(tables["rgather"][1])
    ginv = pow(g, p - 2, p)
    b = np.exp(-2j * np.pi * np.array([pow(ginv, m, p) for m in range(count)], np.float64) / p)
    km = np.outer(np.arange(count), np.arange(count)) % count
    want = (np.exp(-2j * np.pi * km / count) @ b) / count
    got = tables["rspec"][dif_positions(inner)]
    assert got.dtype == np.float32 and got.shape == (count, 2)
    err = np.maximum(np.abs(got[:, 0] - want.real), np.abs(got[:, 1] - want.imag))
    assert np.all(err <= np.spacing(np.abs(want).astype(np.float32)))
    ang = 2.0 * np.pi * np.arange(count) / count
    tw = tables["rtw"].astype(np.float64)
    assert np.all(np.abs(tw - np.stack([np.cos(ang), -np.sin(ang)], 1))
                  <= np.spacing(np.abs(tables["rtw"])))


def _dif(z, radices, ls):
    """In-place DIF stages (exact DFT a butterfly, then the twiddles) on the
    batch of transforms of length ``ls`` that ``z`` holds, in float64."""
    n = len(z)
    for r in radices:
        m = ls // r
        for g in range(n // ls):
            for j in range(m):
                idx = g * ls + j + m * np.arange(r)
                v = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r) @ z[idx]
                z[idx] = v * np.exp(-2j * np.pi * j * np.arange(r) / ls)
        ls = m
    return z


@pytest.mark.parametrize("n_fft", [34, 1103, 2206, 1018, 282, 578])
def test_output_positions_follow_the_rader_stage(n_fft):
    """A float64 mirror of the kernels' data movement: the outer DIF stages in
    place, then the Rader stage as ``csrc/logmel_stages.cuh`` moves its data
    (a_m = v_{g^m} gathered to b (p - 1) + m, x_0 to the tail N' + b, the
    inner forward transform, X_0 = x_0 + A_0, the product with B, x_0 added
    to its DC term, a forward DFT of that in natural order): X_k read at
    ``pos[k]`` is ``np.fft.fft``'s, and ``pos`` is a permutation."""
    plan = mixed_plan(n_fft, "rader")
    p, count = plan.rader_prime, plan.rader_prime - 1
    n = plan.n
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    z = _dif(x.copy(), plan.radices[:-1], n)
    tables = rader_tables(p, plan.rader)
    gather = tables["rgather"].astype(np.int64)
    g = int(gather[1])
    ginv = pow(g, p - 2, p)
    bspec = np.fft.fft(np.exp(-2j * np.pi * np.array([pow(ginv, m, p) for m in range(count)])
                              / p)) / count
    inner_pos = dif_positions(plan.rader)
    out = np.empty(n, complex)
    batches = n // p
    for b in range(batches):
        a = z[b * p + gather]
        v0 = z[b * p]
        a_dif = _dif(a.copy(), plan.rader, count)            # A_k at inner_pos[k]
        out[n - batches + b] = v0 + a_dif[0]
        y = a_dif[inner_pos] * bspec                         # A_k B_k, k in order
        y[0] += v0
        out[b * count: (b + 1) * count] = np.fft.fft(y)      # D_m = X_{g^m}
    pos = output_positions(plan)
    assert sorted(pos.tolist()) == list(range(n))
    np.testing.assert_allclose(out[pos], np.fft.fft(x), rtol=0, atol=1e-9 * math.sqrt(n) * 10)


@pytest.mark.parametrize("points,want", [
    (1103, ((1103,), (2, 19, 29), ())), (12867, ((3, 4289), (8, 8, 67), ())),
    (11527, ((11527,), (2, 3, 17, 113), ())), (15645, ((3, 5, 7, 149), (4, 37), ())),
    (2063, None), (1001, None), (6400, None), (17 * 17, ((17, 17), (16,), ())),
])
def test_rader_radices(points, want):
    """A Rader stage takes L's largest prime, above 13, last; its inner
    radices are the direct plan of p - 1 (wide: radix 16 among them), and no
    nested stage; none where p - 1 has a prime above MATRIX_MAX (2063: 2062
    = 2 x 1031, which only a nested plan takes) or L is 13-smooth (1001,
    6400)."""
    assert fl._rader_radices(points) == want


def test_every_size_gets_a_plan_and_a_body():
    """Every n_fft from 1 to 206,208 (a stride of 13, and every size within
    3 of a multiple of 1,024) gets a plan whose radices multiply to its
    length, and a body that takes it: the mixed body's plans fit one block,
    the cluster body's fit 16 CTAs; a Rader stage only for a prime above
    13 whose p - 1 has a direct plan, and Bluestein only where L has no
    direct plan or costs less."""
    sizes = sorted(set(range(1, 206209, 13)) |
                   {k * 1024 + d for k in range(1, 202) for d in range(-3, 4)})
    kinds = set()
    for n_fft in sizes:
        plan = mixed_plan(n_fft)
        where = body(n_fft)
        assert math.prod(plan.radices) == plan.n
        if where == "mixed":
            assert plan.smem_bytes <= MIXED_MAX_SMEM
        elif where == "cluster":
            assert plan.smem_bytes > MIXED_MAX_SMEM
            assert cluster_split(n_fft, cluster_size(n_fft)).smem_bytes <= MIXED_MAX_SMEM
        else:
            assert where == "fft" and n_fft & (n_fft - 1) == 0
        if plan.nested:
            p, q = plan.rader_prime, plan.nested_prime
            assert p > 13 and q == fl._prime_factors(p - 1)[-1] > 13
            assert all(r <= MATRIX_MAX for r in fl._prime_factors(q - 1))
            kinds.add(("nested", where))
        elif plan.rader:
            p = plan.rader_prime
            assert p > 13 and all(q <= MATRIX_MAX for q in fl._prime_factors(p - 1))
            kinds.add(("rader", where))
        elif plan.bluestein:
            kinds.add(("bluestein", where))
        elif plan.matrix:
            kinds.add(("matrix", where))
    assert kinds >= {("rader", "mixed"), ("rader", "cluster"), ("matrix", "mixed"),
                     ("matrix", "cluster"), ("bluestein", "mixed"), ("bluestein", "cluster")}
    assert cluster_size(206208) <= CLUSTER_MAX


def _rfft_log_mel(y, cfg):
    y = y.astype(np.float64)
    n = 1 + (len(y) - cfg.n_fft) // cfg.hop_length
    idx = np.arange(n)[:, None] * cfg.hop_length + np.arange(cfg.n_fft)[None, :]
    power = np.abs(np.fft.rfft(y[idx] * hann_window(cfg.n_fft, np.float64), axis=1)) ** 2
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, np.float64)
    with np.errstate(divide="ignore"):
        return np.log(power @ fb.T)


@pytest.mark.parametrize("n_fft,kw", [(34, {"plan": "rader"}), (38, {"plan": "rader"}),
                                      (578, {"plan": "rader"}),
                                      (1034, {"plan": "rader"}), (1102, {"plan": "rader"}),
                                      (12865, {"plan": "rader"})])
def test_forced_rader_plans_plain_matches_rfft(n_fft, kw):
    """Rader plans with register-only and matrix inner stages (17 over 16,
    19 over 2 x 9, 47 over 2 x 23, 29 over 4 x 7, 83 over 2 x 41), forced,
    through `mixed_log_mel_plain` within 1e-4 of float64 rFFT + mel, with a
    silent frame's -inf kept."""
    cfg = FrontendConfig(n_fft=n_fft, hop_length=n_fft // 2, center=False, log_floor=None)
    assert mixed_plan(n_fft, **kw).rader
    rng = np.random.default_rng(n_fft)
    y = (0.3 * rng.standard_normal(6 * n_fft)).astype(np.float32)
    y[: 2 * n_fft] = 0.0
    got = mixed_log_mel_plain(torch.from_numpy(y), cfg, **kw).numpy().astype(np.float64)
    want = _rfft_log_mel(y, cfg)
    fin = np.isfinite(want)
    assert (~fin).any()
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)
