"""Fused log-mel: the CUDA kernels (``csrc/logmel_fft.cu``,
``csrc/logmel_mixed.cu`` and ``csrc/logmel_cluster.cu``) and their plain
PyTorch versions.

The JAX package's `ops/pallas/fused_logmel.py` has three TPU kernels, which
all compute one function: windowed real DFT, power, mel, floor, log. Three
CUDA bodies replace them, each in float32, chosen by `body` from ``n_fft``
whatever the route:

* ``"fft"`` (``csrc/logmel_fft.cu``), every power-of-two ``n_fft`` from 256
  to 16384: the frame windowed on load and packed as ``n_fft / 2`` complex
  points, a radix-4 Stockham FFT in shared memory, the real-to-complex
  untangle, power, the mel filterbank as CSR rows, floor, log.
  `fft_log_mel_plain` repeats its arithmetic operation by operation;
* ``"mixed"`` (``csrc/logmel_mixed.cu``), every other ``n_fft`` whose plan
  (`mixed_plan`) fits in a block's shared memory: the same packing (or, at
  an odd ``n_fft``, the real frame as ``n_fft`` complex points), a
  mixed-radix FFT of the transform length L (register radices 4, 2, 3, 5,
  7, 11, 13 in place, then a matrix stage on the tensor cores for each
  prime factor above 13 up to ``MATRIX_MAX``, or a Rader stage last for the
  largest prime: its p-point DFTs as cyclic convolutions of p - 1 points,
  two inner transforms on the same stages), or Bluestein's chirp
  convolution through two FFTs of a 7-smooth length M >= 2L - 1 where L has
  a prime above ``MATRIX_MAX`` whose p - 1 has one too, or `plan_cost` finds
  it cheaper, then the same power, mel (lanes a band), floor, log.
  `mixed_log_mel_plain` repeats its arithmetic operation by operation (a
  matrix stage as one float64 product, which the kernel's TF32 products
  approximate);
* ``"cluster"`` (``csrc/logmel_cluster.cu``), every n_fft beyond that limit:
  the mixed body's plan and operations (matrix and Rader stages included)
  with one frame split over a thread-block cluster of `cluster_size` CTAs,
  each holding its share of the work arrays and power row in its own shared
  memory and reaching its partners' through distributed shared memory;
  bitwise the mixed body's at every cluster size.

Modes, renamed from the JAX package's (as `core/config.py` renames the
backends): ``"dif"`` is the JAX ``"bf16x3"`` and ``"exact"`` keeps its
name. Dispatch follows the JAX ``fused_log_mel`` / ``fused_log_mel_frames``:

* ``"chunked"``: mode ``"dif"``, ``hop * 2 == n_fft``, ``n_fft % 4 == 0`` and
  a signal of at least ``n_fft`` samples: stride ``n_fft / 2`` on the
  (padded) waveform, frame t is hop rows t and t+1;
* ``"framed"``: mode ``"dif"`` otherwise (any hop, short signals): stride
  ``hop`` on the padded waveform, or ``n_fft`` on a frame matrix;
* ``"exact"``: mode ``"exact"``, or any ``n_fft % 4 != 0``.

The route sets the frame stride of a launch and the plain version a CPU
tensor runs: `fused_log_mel` and `fused_log_mel_frames` launch a kernel for
a CUDA tensor and run the DIF / direct plain version (`fused_log_mel_plain`:
the JAX kernels' radix-2 decimation in frequency, or the direct DFT for the
exact route, as products) only for a CPU tensor, the function the JAX
kernels compute, as the JAX package runs it. Launches are counted per route
on `fused_log_mel`: ``launches`` (chunked), ``framed_launches`` and
``exact_launches``, whichever of the two wrappers launched and whichever
body ran; ``mixed_launches`` and ``cluster_launches`` count the launches of
the ``"mixed"`` and ``"cluster"`` bodies among them.
"""

from __future__ import annotations

import ctypes
import math
import threading
from functools import lru_cache, partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.mel import mel_filterbank
from sed_crnn_torch.ops.stft import dft_bases, hann_window, reflect_pad

BIN_TILE = 64     # the JAX kernels' bin tile: the plain version's bases pad to it
MODES = ("dif", "exact")
FFT_LOG_N = (8, 14)   # csrc/logmel_fft.cu: n_fft 256 .. 16384
MIXED_MAX_SMEM = 232448           # csrc/logmel_mixed.cu MAX_SMEM: 227 KB a block
MIXED_MAX_STAGES = 16             # csrc/logmel_stages.cuh MAX_STAGES
CLUSTER_MAX = 16                  # csrc/logmel_cluster.cu MAX_CLUSTER: CTAs a cluster
REGISTER_RADICES = (2, 3, 4, 5, 7, 8, 9, 11, 13, 16)   # csrc/logmel_stages.cuh `butterfly<R>`
PRIME_REGISTER_MAX = 13           # the largest prime a register stage takes
# The composite register radices (`butterfly<R>`: R = A B, n = n1 + B n2):
# B A-point butterflies, the twiddles W_R^(n1 k2), then A B-point ones.
COMPOSITE = {8: (2, 4), 9: (3, 3), 16: (4, 4)}
# A register pass's cost a point, in COST_REGISTER: for the composite
# radices the time of a pass over that of a radix-4 pass on an H100, the
# means `tools/logmel_phases.py --radix` printed from its per-radix cuts at
# 25,920, 1,288 and 6,448 points (PERF.md §6), to two decimals; 1 for the
# rest. `_power_radices` splits powers of 2 and 3 into the radices of
# least total weight.
RADIX_WEIGHT = {2: 1.0, 3: 1.0, 4: 1.0, 5: 1.0, 7: 1.0, 11: 1.0, 13: 1.0,
                8: 1.07, 9: 1.38, 16: 1.29}
MEL_LANES = 32                    # a band's partial sums: the lanes of a warp
MEL_BINS_PER_LANE = 16            # `mel_group`: a band's mean bins a lane, to widen the group
# csrc/logmel_mixed.cu `logmel_mixed_matrix_tiles`: the most column tiles a
# matrix stage takes (`matrix_tiles`), so every odd R up to 1,023.
MATRIX_TILES = 64
MATRIX_MAX = 1021                 # the largest prime a matrix stage takes
# `plan_cost`'s weights, ns a frame on one SM, as `tools/logmel_phases.py`'s
# `fit_choice` printed them from an H100's run (PERF.md §6): COST_REGISTER
# the least-squares fit of the mixed body's transform times; the others
# the values of its grid that pick the plans the card timed fastest, in
# turns, at every size the tool times, nearest the least-squares fits among
# equals. COST_NARROW: a register point of a plan in the narrow
# instantiations (radices to 9 only, 1,024 threads a frame at 64
# registers, more frames in flight) against one in the wide ones;
# COST_MATRIX a matrix tile step; COST_CROSS a point of a stage that
# crosses CTAs, and COST_CROSS_BLUESTEIN one of a Bluestein plan's (its
# first M-point stages, each butterfly's points far apart, twice);
# COST_CLUSTER the cluster body against the mixed body.
COST_REGISTER = 0.346
COST_MATRIX = 25.9
COST_NARROW = 0.8
COST_CROSS = 0.173
COST_CROSS_BLUESTEIN = 0.346
COST_CLUSTER = 1.25

# Serving threads call the wrappers concurrently: the operand cache and the
# launch counters are read-modify-write.
_lock = threading.Lock()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def dif_operands(sr: int, n_fft: int, n_mels: int, fmin: float, fmax) -> dict:
    """Window halves, packed sub-DFT bases and mel rows, built in float64.

    ``bc``/``bs`` are (M, NB): the cos and -sin bases of the even bins in
    columns [0, n_even) and of the odd (half-bin-shifted) bins in columns
    [ne_pad, ne_pad + n_odd), every other column zero. ``melw`` (NB, n_mels)
    holds ``fb[:, 0::2].T`` and ``fb[:, 1::2].T`` in the matching rows, so
    padded columns contribute nothing.
    """
    M = n_fft // 2
    n_even, n_odd = M // 2 + 1, M // 2
    ne_pad = _round_up(n_even, BIN_TILE)
    nb = ne_pad + _round_up(n_odd, BIN_TILE)
    k = np.arange(M, dtype=np.float64)[:, None]
    ang_e = 2.0 * np.pi * k * np.arange(n_even, dtype=np.float64)[None, :] / M
    ang_o = 2.0 * np.pi * k * (np.arange(n_odd, dtype=np.float64)[None, :] + 0.5) / M
    bc = np.zeros((M, nb), np.float32)
    bs = np.zeros((M, nb), np.float32)
    bc[:, :n_even], bs[:, :n_even] = np.cos(ang_e), -np.sin(ang_e)
    bc[:, ne_pad : ne_pad + n_odd], bs[:, ne_pad : ne_pad + n_odd] = np.cos(ang_o), -np.sin(ang_o)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)            # (n_mels, bins)
    melw = np.zeros((nb, n_mels), np.float32)
    melw[:n_even] = fb.T[0::2]
    melw[ne_pad : ne_pad + n_odd] = fb.T[1::2]
    w = hann_window(n_fft, np.float64)
    return {
        "wa": w[:M].astype(np.float32), "wb": w[M:].astype(np.float32),
        "bc": bc, "bs": bs, "melw": melw, "n_even_tiles": ne_pad // BIN_TILE,
    }


def exact_operands(sr: int, n_fft: int, n_mels: int, fmin: float, fmax) -> dict:
    """The direct formulation's operands (the JAX ``_padded_operands``):
    window-folded cos / -sin bases of the full DFT, ``(n_fft, NB)``, and the
    transposed mel filterbank ``(NB, n_mels)``, the bin axis padded with
    zeros to a multiple of the 64-bin tile (1025 -> 1088), so padded bins
    contribute nothing."""
    n_bins = 1 + n_fft // 2
    nb = _round_up(n_bins, BIN_TILE)
    cos_b, sin_b = dft_bases(n_fft, windowed=True)                 # (n_fft, n_bins)
    bc = np.zeros((n_fft, nb), np.float32)
    bs = np.zeros((n_fft, nb), np.float32)
    bc[:, :n_bins], bs[:, :n_bins] = cos_b, sin_b
    melw = np.zeros((nb, n_mels), np.float32)
    melw[:n_bins] = mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T
    return {"bc": bc, "bs": bs, "melw": melw}


@lru_cache(maxsize=None)
def _power_radices(prime: int, count: int, wide: bool = False,
                   composite: bool = True) -> Tuple[int, ...]:
    """The register radices of prime^count (prime 2 or 3) of least total
    `RADIX_WEIGHT`, fewest stages among equals, largest first: 8, 4 and 2
    (and 16 where the plan runs in the wide instantiations, ``wide``: radix
    16 spills at the others' 64 registers a thread) for the 2s, 9 and 3 for
    the 3s; without ``composite`` 4, 2 and 3 alone (radix 4 for each pair
    of 2s and one radix 2 for an odd one out)."""
    options = {2: (16, 8, 4, 2) if wide else (8, 4, 2), 3: (9, 3)}[prime]
    if not composite:
        options = tuple(r for r in options if r not in COMPOSITE)
    best = [()]
    for k in range(1, count + 1):
        cands = [tuple(sorted(best[k - e] + (r,), reverse=True))
                 for r in options for e in [round(math.log(r, prime))] if e <= k]
        best.append(min(cands, key=lambda c: (sum(RADIX_WEIGHT[r] for r in c), len(c))))
    return best[count]


def _smooth_radices(n: int) -> Optional[Tuple[int, ...]]:
    """The DIF radices of a 7-smooth ``n`` (`_power_radices` of its 2s and
    of its 3s, then 5, 7), or None when a prime above 7 divides it."""
    counts = {}
    for p in (2, 3, 5, 7):
        counts[p] = 0
        while n % p == 0:
            n //= p
            counts[p] += 1
    if n != 1:
        return None
    return (_power_radices(2, counts[2]) + _power_radices(3, counts[3]) + (5,) * counts[5]
            + (7,) * counts[7])


def _next_smooth(n: int) -> int:
    """The smallest 7-smooth integer >= ``n`` >= 1: over every 3^a 5^b 7^c
    below the best so far, the least power-of-two multiple that reaches n."""
    best = 1 << (n - 1).bit_length()
    p7 = 1
    while p7 < best:
        p5 = p7
        while p5 < best:
            p3 = p5
            while p3 < best:
                best = min(best, p3 << (-(-n // p3) - 1).bit_length())
                p3 *= 3
            p5 *= 5
        p7 *= 7
    return best


def _prime_factors(n: int) -> Tuple[int, ...]:
    """The prime factors of ``n`` >= 1 with multiplicity, ascending."""
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1 if p == 2 else 2
    return tuple(out + [n] if n > 1 else out)


def matrix_tiles(radix: int) -> int:
    """The 8-wide tiles of a matrix stage's two products, each way: (R + 1)
    / 2 rows r and columns s (0 .. (R - 1) / 2), padded to the ``mma``
    depth of 8."""
    return -(-(radix + 1) // 16)


def _direct_radices(n: int, wide: bool = False,
                    composite: bool = True) -> Optional[Tuple[int, ...]]:
    """The DIF radices of a direct transform of ``n`` points: the 2s and 3s
    by `_power_radices` (radix 16 among them where the plan runs wide
    anyway: ``wide``, a Rader stage's inner transforms, or a prime from 11
    up in ``n``; no composite radix without ``composite``), the other
    register primes ascending, then each prime above them as a matrix
    stage, ascending; None when a prime above ``MATRIX_MAX`` divides
    ``n``."""
    primes = _prime_factors(n)
    if any(p > MATRIX_MAX for p in primes):
        return None
    wide = wide or any(p > 7 for p in primes)
    return (_power_radices(2, primes.count(2), wide, composite)
            + _power_radices(3, primes.count(3), wide, composite)
            + tuple(p for p in primes if p > 3))


def _primitive_root(p: int) -> int:
    """The smallest generator of the multiplicative group mod the prime ``p``."""
    qs = set(_prime_factors(p - 1))
    return next(g for g in range(2, p) if all(pow(g, (p - 1) // q, p) != 1 for q in qs))


def _rader_radices(points: int, nested: bool = False, composite: bool = True
                   ) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]]:
    """A plan with a Rader stage for L = ``points``: (the outer radices, the
    Rader prime p last; the inner radices of its p - 1 point transforms;
    with ``nested``, the radices of the q - 1 point transforms of the Rader
    stage that ends the inner plan), or None. p is L's largest prime, above
    13; L's other primes run as register or matrix stages, so none of them
    may exceed ``MATRIX_MAX``. Without ``nested`` the inner plan is direct
    (`_direct_radices` (p - 1)); with it, the inner plan ends in a Rader
    stage for q, the largest prime of p - 1, above 13, whose q - 1 has a
    direct plan (one level: q's inner transforms have no Rader stage), and
    (p - 1) / q has a direct plan too. ``composite`` as for
    `_direct_radices`."""
    primes = _prime_factors(points)
    if not primes or primes[-1] <= PRIME_REGISTER_MAX:
        return None
    p = primes[-1]
    rest = _direct_radices(points // p, True, composite)
    if rest is None:
        return None
    if not nested:
        inner = _direct_radices(p - 1, True, composite)
        return None if inner is None else (rest + (p,), inner, ())
    inner = _rader_radices(p - 1, False, composite)
    if inner is None:
        return None
    return rest + (p,), inner[0], inner[1]


def plan_counts(n: int, radices: Tuple[int, ...], bluestein: bool,
                rader: Tuple[int, ...] = (), nested: Tuple[int, ...] = ()
                ) -> Tuple[float, int]:
    """A plan's work a frame as `plan_cost` weighs it: register-stage points,
    each stage's times its radix's `RADIX_WEIGHT` (both transforms with
    Bluestein, and its filter product as one more stage), and matrix tile
    steps (ceil(N / R / 8) row tiles x `matrix_tiles` (R)^2 a stage, each
    six ``mma`` and the gather of their operands). A Rader stage (its prime
    the last of ``radices``, ``rader`` the radices of its p - 1 point
    transforms, N' = N (p - 1) / p points) counts both inner transforms'
    register points and tile steps, and its gather and pointwise product as
    two more stages of N' points; a Rader stage nested in them (the last of
    ``rader``, ``nested`` the radices of its q - 1 point transforms) counts
    the same within each inner transform (its gather or scatter and its
    product)."""
    if rader:
        radices = radices[:-1]
    reg = sum(n * RADIX_WEIGHT[r] for r in radices if r in REGISTER_RADICES)
    mat = sum(-(-(n // r) // 8) * matrix_tiles(r) ** 2 for r in radices
              if r not in REGISTER_RADICES)
    if bluestein:
        return 2 * reg + n, 2 * mat
    if rader:
        inner = n - n // (math.prod(rader) + 1)
        i_reg, i_mat = plan_counts(inner, rader, False, nested)
        reg, mat = reg + 2 * i_reg + 2 * inner, mat + 2 * i_mat
    return reg, mat


def plan_cost(n: int, radices: Tuple[int, ...], bluestein: bool,
              cluster: bool = False, rader: Tuple[int, ...] = (),
              nested: Tuple[int, ...] = (), crossing: int = 0) -> float:
    """The cost model `mixed_plan` picks by, in nanoseconds a frame on one
    SM: ``COST_REGISTER`` a register-stage point (weighted by radix; times
    ``COST_NARROW`` in the narrow instantiations, `_narrow`) and
    ``COST_MATRIX`` a matrix tile step (`plan_counts`); for a plan the
    cluster body runs (``cluster``) that plus ``COST_CROSS`` (a Bluestein
    plan: ``COST_CROSS_BLUESTEIN``) a point of a stage that crosses CTAs
    (``crossing``, `_crossing_points`: its reads and writes through
    distributed shared memory and its cluster barrier), all times
    ``COST_CLUSTER``. Its weights are `tools/logmel_phases.py`'s
    `fit_choice` of an H100's runs (PERF.md §6): over the 57 sizes timed
    (the tool's 35 and 22 whose plan an earlier fit moved), every plan in
    turns, they pick a plan within 2 % of the fastest at all but 2,206
    (its Rader plan, 2.7 % slower than Bluestein; the model weighs a plan
    by L alone, and at 1,103, the same L, the Rader plan is 3.8 % the
    faster), 12,893 (nested, 23 % slower than its Rader plan), 12,899
    (nested, 6.0 % slower than Bluestein), 15,964 (Rader, 4.8 %), 16,994
    (Rader, 12 %), 18,992 (Bluestein, 18 %), 23,098 (nested, 2.2 %),
    25,734 (Rader, 3.2 %), 122,406 (Bluestein, 8.5 %) and 190,002 (Rader,
    2.7 %)."""
    reg, mat = plan_counts(n, radices, bluestein, rader, nested)
    reg *= COST_NARROW if _narrow(radices, rader) else 1.0
    cost = COST_REGISTER * reg + COST_MATRIX * mat
    if not cluster:
        return cost
    return (cost + (COST_CROSS_BLUESTEIN if bluestein else COST_CROSS) * crossing) * COST_CLUSTER


def _narrow(radices: Tuple[int, ...], rader: Tuple[int, ...] = ()) -> bool:
    """Whether the bodies run a plan in their narrow instantiations
    (``register_radix`` (r, false) in ``csrc/logmel_stages.cuh``): no Rader
    or matrix stage, no radix 11, 13 or 16."""
    return not rader and all(r in REGISTER_RADICES and r not in (11, 13, 16) for r in radices)


class MixedPlan(NamedTuple):
    """How ``csrc/logmel_mixed.cu`` transforms a frame of ``n_fft`` samples:
    ``points`` complex points L (``n_fft / 2`` packed, or ``n_fft`` at an odd
    n_fft), a transform of length ``n`` (L direct, or Bluestein's M) by DIF
    stages of ``radices``, each a register stage (2-13, 16), a matrix stage
    (an odd prime above 13) or, the last only, a Rader stage (its prime p,
    with ``rader`` the radices of its two p - 1 point inner transforms, each
    register or matrix, or, the last of them only, a nested Rader stage of
    prime q whose q - 1 point transforms run by ``nested``), and the shared
    memory one frame takes (the work array, twice with a matrix or Rader
    stage, and the power row)."""

    n_fft: int
    points: int
    n: int
    radices: Tuple[int, ...]
    bluestein: bool
    smem_bytes: int
    rader: Tuple[int, ...] = ()
    nested: Tuple[int, ...] = ()

    @property
    def kinds(self) -> Tuple[str, ...]:
        """Each stage's kind, in stage order: register, matrix or rader."""
        return _kinds(self.radices, bool(self.rader))

    @property
    def matrix(self) -> Tuple[int, ...]:
        """The radices run as matrix stages, in stage order (not the Rader
        stage's inner ones: `rader_matrix`)."""
        return tuple(r for r, k in zip(self.radices, self.kinds) if k == "matrix")

    @property
    def rader_prime(self) -> int:
        """The Rader stage's prime, 0 without one."""
        return self.radices[-1] if self.rader else 0

    @property
    def nested_prime(self) -> int:
        """The nested Rader stage's prime q (the last of ``rader``), 0
        without one."""
        return self.rader[-1] if self.nested else 0

    @property
    def rader_matrix(self) -> Tuple[int, ...]:
        """The Rader stage's inner radices run as matrix stages (not the
        nested stage's: `nested_matrix`)."""
        return tuple(r for r, k in zip(self.rader, _kinds(self.rader, bool(self.nested)))
                     if k == "matrix")

    @property
    def nested_matrix(self) -> Tuple[int, ...]:
        """The nested Rader stage's inner radices run as matrix stages."""
        return tuple(r for r in self.nested if r not in REGISTER_RADICES)

    @property
    def tensor_cores(self) -> bool:
        """Whether any stage runs on the tensor cores (the kernel is then
        within ``MATRIX_ATOL``-sized bands of `mixed_log_mel_plain`, not its
        bits)."""
        return bool(self.matrix or self.rader_matrix or self.nested_matrix)


def _kinds(radices: Tuple[int, ...], rader: bool) -> Tuple[str, ...]:
    """Each stage's kind: rader for the last where ``rader``, else register
    or matrix by its radix."""
    last = len(radices) - 1
    return tuple("rader" if rader and s == last else
                 "register" if r in REGISTER_RADICES else "matrix"
                 for s, r in enumerate(radices))


def _make_plan(n_fft: int, points: int, radices: Tuple[int, ...], bluestein: bool,
               rader: Tuple[int, ...] = (), nested: Tuple[int, ...] = ()) -> MixedPlan:
    """A plan and its shared memory a frame: the work array (two where a
    matrix or Rader stage writes out of place) and the power row. A nested
    Rader stage keeps its x_0 and X_0 inside the outer stage's N' points
    (its own tail of N' / q), so it takes no more."""
    n = int(np.prod(radices, dtype=np.int64))
    arrays = 2 if rader or any(r not in REGISTER_RADICES for r in radices) else 1
    return MixedPlan(n_fft, points, n, radices, bluestein,
                     8 * arrays * n + 4 * (n_fft // 2 + 1), tuple(rader), tuple(nested))


def _share_bytes(plan: MixedPlan, chunk: int, ctas: int) -> int:
    arrays = (plan.smem_bytes - 4 * (plan.n_fft // 2 + 1)) // (8 * plan.n)
    return 8 * arrays * chunk + 4 * -(-(plan.n_fft // 2 + 1) // ctas)


def _cluster_chunk(plan: MixedPlan, ctas: int) -> int:
    """The points of each work array a CTA holds when ``ctas`` CTAs share
    the plan's frame: ceil(N / C), or with a Rader stage whole inner
    transforms of p - 1 points a CTA (ceil(N / p / C) of them) where those
    cover the frame and fit, so that its inner stages stay inside the CTAs
    (at n_fft 25,734, C 2: 8,576 points, where 6,434 made every inner stage
    cross)."""
    chunk = -(-plan.n // ctas)
    if plan.rader:
        count = plan.rader_prime - 1
        aligned = count * -(-(plan.n // plan.rader_prime) // ctas)
        if aligned * ctas >= plan.n and _share_bytes(plan, aligned, ctas) <= MIXED_MAX_SMEM:
            return aligned
    return chunk


def _cluster_bytes(plan: MixedPlan, ctas: int) -> int:
    """A CTA's shared memory when ``ctas`` CTAs share the plan's frame."""
    return _share_bytes(plan, _cluster_chunk(plan, ctas), ctas)


def _crossing_points(plan: MixedPlan) -> int:
    """The points a frame of the plan passes through stages that cross CTAs
    on the cluster body at `plan_cluster_size`: N for each crossing stage
    (twice with Bluestein), N' for each crossing inner stage of a Rader
    stage (twice: forward and transposed); 0 beyond the body's limit."""
    try:
        sp = split_plan(plan, plan_cluster_size(plan))
    except ValueError:
        return 0
    points = sum(sp.cross) * plan.n * (2 if plan.bluestein else 1)
    if plan.rader:
        points += sum(sp.rader_cross) * 2 * (plan.n - plan.n // plan.rader_prime)
    return points


def _plan_cost_on_body(plan: MixedPlan) -> float:
    cluster = plan.smem_bytes > MIXED_MAX_SMEM
    return plan_cost(plan.n, plan.radices, plan.bluestein, cluster, plan.rader, plan.nested,
                     _crossing_points(plan) if cluster else 0)


def _wide_composite_cluster(plan: MixedPlan) -> bool:
    """A plan beyond one block in the wide instantiations with a composite
    radix, which `mixed_plan` rebuilds without them: the cluster body's wide
    instantiation with them spills (1,676 bytes a thread at 128 registers),
    and its Rader plans ran slower than on radices 4, 2 and 3 (PERF.md
    §6)."""
    return (plan.smem_bytes > MIXED_MAX_SMEM and not _narrow(plan.radices, plan.rader)
            and bool(set(plan.radices + plan.rader) & set(COMPOSITE)))


def _kind_plan(n_fft: int, points: int, kind: str, composite: bool) -> Optional[MixedPlan]:
    """L's direct, Rader or nested Rader plan (`mixed_plan`'s kinds but
    Bluestein), with or without composite radices; None where it has none,
    and for a nested plan beyond one block: the cluster body runs no nested
    stage (every nested plan the card timed there, before it was taken out,
    ran 1.6-3.4x slower than its size's fastest plan; PERF.md §6)."""
    if kind == "direct":
        direct = _direct_radices(points, composite=composite)
        return None if direct is None else _make_plan(n_fft, points, direct, False)
    with_rader = _rader_radices(points, kind == "nested", composite)
    if with_rader is None or len(with_rader[1]) > MIXED_MAX_STAGES:
        return None
    got = _make_plan(n_fft, points, with_rader[0], False, *with_rader[1:])
    return None if got.nested and got.smem_bytes > MIXED_MAX_SMEM else got


# The plan kinds a caller may force (`mixed_plan`'s ``plan``).
PLAN_KINDS = ("direct", "rader", "nested", "bluestein")


@lru_cache(maxsize=None)
def mixed_plan(n_fft: int, plan: Optional[str] = None) -> MixedPlan:
    """The plan of the mixed and cluster bodies at ``n_fft`` >= 1.

    L points (n_fft / 2 at an even n_fft, n_fft at an odd one) run by one
    of four plans: direct, N = L, by `_direct_radices` (register radices
    2-16, then matrix stages for the primes above 13 up to ``MATRIX_MAX``);
    direct with a Rader stage for L's largest prime p above 13
    (`_rader_radices`: the other primes as before, p last, its two p - 1
    point transforms on register and matrix stages), which takes the primes
    above ``MATRIX_MAX`` whose p - 1 has a direct plan; the same with a
    Rader stage nested in the inner transforms, for p - 1's largest prime q
    above 13 whose q - 1 has a direct plan (the primes p whose p - 1 has a
    prime above ``MATRIX_MAX``, and where it costs less than a matrix stage
    of q; in one block only); or Bluestein at M, the smallest 7-smooth
    length >= 2L - 1 (register radices only), which keeps the rest. ``plan``
    None picks the cheapest by `plan_cost`, on the body each would run on
    (one block where it fits, else a cluster), among the plans the cluster
    body's 16 CTAs hold (among all of them where none is held: beyond the
    body's limit). One of
    `PLAN_KINDS` forces that plan: ``"direct"`` (register and matrix
    stages only), ``"rader"`` (a direct inner plan, or the nested one where
    L has no other Rader plan), ``"nested"`` or ``"bluestein"``; ValueError
    where L has no such plan."""
    if n_fft < 1:
        raise ValueError(f"n_fft must be positive, got {n_fft}")
    if plan is not None and plan not in PLAN_KINDS:
        raise ValueError(f"unknown plan kind {plan!r}; expected one of {PLAN_KINDS}")
    points = n_fft if n_fft % 2 else n_fft // 2
    plans = {"bluestein": _make_plan(n_fft, points,
                                     _smooth_radices(_next_smooth(2 * points - 1)), True)}
    for kind in ("direct", "rader", "nested"):
        got = _kind_plan(n_fft, points, kind, True)
        if got is not None and _wide_composite_cluster(got):
            got = _kind_plan(n_fft, points, kind, False)
        if got is not None:
            plans[kind] = got
    if plan == "rader" and "rader" not in plans and "nested" in plans:
        return plans["nested"]
    if plan is not None:
        if plan not in plans:
            where = " in one block (the cluster body runs none)" if plan == "nested" else ""
            raise ValueError(f"n_fft {n_fft}: L = {points} has no {plan} plan{where}")
        return plans[plan]
    held = [p for p in plans.values() if _cluster_bytes(p, CLUSTER_MAX) <= MIXED_MAX_SMEM]
    return min(held or plans.values(), key=_plan_cost_on_body)


class ClusterSplit(NamedTuple):
    """How ``csrc/logmel_cluster.cu`` splits one frame of `mixed_plan` over a
    cluster of ``ctas`` CTAs: ``chunk`` work-array points (`_cluster_chunk`)
    and ``bin_chunk`` power-row bins a CTA (of each work array: two with a
    matrix or Rader stage), the shared memory a CTA takes, and which DIF stages (each with
    its transposed twin) reach other CTAs: stage s on sub-transforms of
    length ls crosses when ls does not divide the chunk. ``rader_cross``
    says the same of the Rader stage's inner stages (its gather and
    pointwise product always cross, and so does the Rader stage's bit).
    The cluster body runs no nested Rader stage."""

    ctas: int
    chunk: int
    bin_chunk: int
    smem_bytes: int
    cross: Tuple[bool, ...]
    rader_cross: Tuple[bool, ...] = ()


def _crossing(chunk: int, n: int, radices) -> Tuple[bool, ...]:
    cross, ls = [], n
    for r in radices:
        cross.append(chunk % ls != 0)
        ls //= r
    return tuple(cross)


def cluster_split(n_fft: int, ctas: int, plan: Optional[str] = None) -> ClusterSplit:
    """`mixed_plan` (n_fft, ``plan``) split over ``ctas``
    CTAs: the split `_launch_cluster` hands the kernel, whose launcher
    refuses one that does not cover the frame, does not fit or keeps a stage
    inside the CTAs whose sub-transforms do not divide the chunk."""
    return split_plan(mixed_plan(n_fft, plan), ctas)


def split_plan(mp: MixedPlan, ctas: int) -> ClusterSplit:
    """`cluster_split` of the plan ``mp``."""
    chunk, bins = _cluster_chunk(mp, ctas), -(-(mp.n_fft // 2 + 1) // ctas)
    cross = _crossing(chunk, mp.n, mp.radices)
    inner = ()
    if mp.rader:
        cross = cross[:-1] + (True,)
        inner = _crossing(chunk, mp.rader_prime - 1, mp.rader)
    return ClusterSplit(ctas, chunk, bins, _cluster_bytes(mp, ctas), cross, inner)


@lru_cache(maxsize=None)
def cluster_size(n_fft: int, plan: Optional[str] = None) -> int:
    """C, the CTAs a frame of the cluster body: the smallest C from 2 to
    ``CLUSTER_MAX`` whose share of the plan fits in ``MIXED_MAX_SMEM``
    (measured the fastest on an H100 at six of seven sizes, PERF.md §6).
    Raises ValueError beyond the body's limit, a plan that
    ``CLUSTER_MAX`` CTAs do not hold. The bits do not depend on C."""
    return plan_cluster_size(mixed_plan(n_fft, plan))


def plan_cluster_size(mp: MixedPlan) -> int:
    """`cluster_size` of the plan ``mp``."""
    for c in range(2, CLUSTER_MAX + 1):
        if _cluster_bytes(mp, c) <= MIXED_MAX_SMEM:
            return c
    raise ValueError(
        f"n_fft {mp.n_fft} is beyond the cluster body's limit: its plan takes "
        f"{mp.smem_bytes:,} bytes of shared memory a frame, "
        f"more than {CLUSTER_MAX} CTAs of {MIXED_MAX_SMEM:,} bytes hold")


def body(n_fft: int) -> str:
    """Which CUDA body computes a launch at ``n_fft`` >= 1: ``"fft"`` for a
    power of two from 256 to 16384; ``"mixed"`` for any other n_fft whose
    `mixed_plan` takes at most ``MIXED_MAX_SMEM`` bytes of shared memory a
    frame (8 N bytes of work array, twice with matrix or Rader stages, and 4
    (n_fft / 2 + 1) of power row): every n_fft up to 12,913 (12,865 = 5 x
    31 x 83 direct with matrix stages, 231,572 bytes; 12,867 = 3 x 4289
    with a Rader stage, 231,608; 12,895 = 5 x 2579, a Rader stage with a
    Rader stage of 1,289 nested in its inner transforms, 232,112; 12,911
    prime, nested, 232,400; 12,915 is direct with a matrix stage of 41 on
    the cluster body), every even one up to 23,172 (23,042: L 41 x 281, a
    Rader stage of 281, 230,424 bytes; 23,054: L 11,527 prime, a Rader
    stage, 230,544; 23,082: L 3 x 3847, a nested Rader stage of 641,
    230,824; 23,174 is Bluestein on the cluster body),
    and above those the sizes whose plan fits: direct with register radices
    up to L = 22,869 (an odd n_fft, 3^3 x 7 x 11^2; the largest even n_fft
    is 38,720, L = 19,360), with matrix, Rader or nested Rader stages up to
    L = 12,913 (two work arrays; the largest such n_fft is 23,244), and
    Bluestein up to M = 25,725; ``"cluster"`` for the rest, the same plan
    split over `cluster_size` CTAs (no nested Rader stage: a nested plan is
    one block's only). The cluster body's limit is a plan whose share in
    ``CLUSTER_MAX`` (16) CTAs fits in 227 KB each: every n_fft below
    206,215 (odd, L = 5 x 41,243: Bluestein at M = 413,343, 3,719,164
    bytes; 206,209 to 206,214 run direct or Rader plans), and above it the
    sizes whose plan fits (to 617,400, an even n_fft whose half is
    7-smooth); beyond it a launch raises ValueError (`cluster_size`). No
    n_fft that ran before Rader stages is refused: `mixed_plan` keeps a plan
    16 CTAs hold wherever one exists, and Bluestein's is still among its
    choices."""
    lo, hi = FFT_LOG_N
    if n_fft & (n_fft - 1) == 0 and 1 << lo <= n_fft <= 1 << hi:
        return "fft"
    if mixed_plan(n_fft).smem_bytes <= MIXED_MAX_SMEM:
        return "mixed"
    return "cluster"


def mel_csr(sr: int, n_fft: int, n_mels: int, fmin: float, fmax):
    """The mel filterbank as rows of contiguous bins: each band's first bin
    (int32, ``n_mels``), row pointers (int32, ``n_mels + 1``) and the weights
    from its first to its last nonzero bin, in bin order (float32). A band
    with no nonzero bin is empty."""
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    first = np.zeros(n_mels, np.int32)
    ptr = np.zeros(n_mels + 1, np.int32)
    rows = []
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        first[m], ptr[m + 1] = lo, ptr[m] + hi - lo
        rows.append(row[lo:hi])
    return first, ptr, np.concatenate(rows).astype(np.float32)


def mel_group(ptr: np.ndarray) -> int:
    """The lanes that sum one band in the mixed body (`group_band_sum` in
    ``csrc/logmel_stages.cuh``, the same order at any width): 4, doubled to
    at most 32 while the bands' mean width is at least MEL_BINS_PER_LANE
    bins a lane. Measured on an H100 against every width from 1 to 32 at
    n_fft 400 (16 kHz) to 23,042: the best within 2 % at each (PERF.md §6);
    below 4 lanes the in-lane tree's 32 / G - 1 adds cost more."""
    width = (int(ptr[-1]) - int(ptr[0])) / max(1, len(ptr) - 1)
    g = 4
    while g < MEL_LANES and width >= MEL_BINS_PER_LANE * g:
        g *= 2
    return g


def _unit_roots(count: int, n: int) -> np.ndarray:
    """``exp(-2 pi i m / n)`` for m < ``count``, computed in float64 and
    rounded once to float32 (re, im) pairs, ``(count, 2)``."""
    ang = 2.0 * np.pi * np.arange(count, dtype=np.float64) / n
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def fft_operands(sr: int, n_fft: int, n_mels: int, fmin: float, fmax) -> dict:
    """The FFT body's operands: the Hann window, the twiddles of the
    ``n_fft / 2``-point complex FFT (``tw[m] = exp(-2 pi i m / H)``, ``(H, 2)``)
    and of the real-to-complex untangle (``utw[k] = exp(-2 pi i k / n_fft)``,
    ``(H + 1, 2)``), each computed in float64 and rounded to float32, and
    the mel filterbank as CSR rows (`mel_csr`)."""
    h = n_fft // 2
    first, ptr, weights = mel_csr(sr, n_fft, n_mels, fmin, fmax)
    return {
        "window": hann_window(n_fft, np.float64).astype(np.float32),
        "tw": _unit_roots(h, h), "utw": _unit_roots(h + 1, n_fft),
        "mel_first": first, "mel_ptr": ptr, "mel_w": weights,
    }


def dif_positions(radices) -> np.ndarray:
    """Where the in-place DIF stages of ``radices`` leave X_k: stage s puts
    the sub-transform of frequencies k = s mod R in sub-block s, so the digits
    of k in the mixed radix, last radix slowest, give its position."""
    n = int(np.prod(radices, dtype=np.int64))
    k = np.arange(n, dtype=np.int64)
    pos = np.zeros(n, np.int64)
    span = n
    for r in radices:
        span //= r
        pos += (k % r) * span
        k //= r
    return pos


def _chirp64(points: int) -> np.ndarray:
    """Bluestein's chirp ``w_n = exp(-i pi (n^2 mod 2L) / L)`` in complex128;
    n^2 mod 2L in int64 (n^2 overflows int32 from L = 46,341, and a float
    angle of n^2 loses the phase)."""
    q = (np.arange(points, dtype=np.int64) ** 2) % (2 * points)
    return np.exp(-1j * np.pi * q.astype(np.float64) / points)


def bluestein_chirp(points: int) -> np.ndarray:
    """The chirp table of an L-point Bluestein transform, ``(L, 2)`` float32."""
    w = _chirp64(points)
    return np.stack([w.real, w.imag], axis=1).astype(np.float32)


def bluestein_filter(points: int, radices) -> np.ndarray:
    """``B = FFT_M(b) / M``, b_m = conj(w_m) for |m| < L wrapped mod M and
    zero elsewhere, in float64, stored at the DIF positions of ``radices``
    (whose product is M) and rounded once: ``(M, 2)`` float32."""
    m = int(np.prod(radices, dtype=np.int64))
    w = _chirp64(points)
    b = np.zeros(m, np.complex128)
    b[:points] = np.conj(w)
    b[m - points + 1 :] = np.conj(w[1:])[::-1]
    spec = np.fft.fft(b) / m
    out = np.empty((m, 2), np.float64)
    out[dif_positions(radices)] = np.stack([spec.real, spec.imag], axis=1)
    return out.astype(np.float32)


def _generator_powers(prime: int) -> Tuple[np.ndarray, np.ndarray]:
    """g^m and g^-m mod ``prime`` for m < prime - 1, g the smallest
    generator (`_primitive_root`), int64."""
    count = prime - 1
    g = _primitive_root(prime)
    gather = np.empty(count, np.int64)
    inverse = np.empty(count, np.int64)
    gi = pow(g, prime - 2, prime)
    a = b = 1
    for m in range(count):
        gather[m], inverse[m] = a, b
        a, b = a * g % prime, b * gi % prime
    return gather, inverse


def rader_tables(prime: int, inner, nested=()) -> dict:
    """A Rader stage's tables for the prime p = ``prime`` whose p - 1 point
    transforms run by the DIF stages ``inner`` (the last a nested Rader
    stage where ``nested`` gives its inner radices): ``rgather`` (int32, p -
    1), g^m mod p for the smallest generator g (`_primitive_root`), the order
    in which the stage gathers each butterfly's points v_{g^m}; ``rtw``, the
    inner transforms' twiddles e^{-2 pi i q / (p - 1)}; and ``rspec``, the
    filter spectrum B = DFT_{p-1}(b) / (p - 1) of b_m = e^{-2 pi i g^{-m} /
    p}, in float64, stored where the inner transforms leave each frequency
    (`plan_positions` of ``inner``, ``nested``) and rounded once. The
    stage's cyclic convolution is then one forward transform, the product
    with B, and the transposed stages (a forward DFT in natural order, which
    reads the convolution at -q): X_{g^m} = x_0 + D_m."""
    count = prime - 1
    gather, inverse = _generator_powers(prime)
    spec = np.fft.fft(np.exp(-2j * np.pi * inverse.astype(np.float64) / prime)) / count
    out = np.empty((count, 2), np.float64)
    out[plan_positions(tuple(inner), tuple(nested))] = np.stack([spec.real, spec.imag], axis=1)
    return {"rgather": gather.astype(np.int32), "rtw": _unit_roots(count, count),
            "rspec": out.astype(np.float32)}


def nested_tables(prime: int, inner) -> dict:
    """The nested Rader stage's tables for its prime q = ``prime``:
    `rader_tables` (q, ``inner``) as ``ngather``, ``ntw`` and ``nspec``."""
    t = rader_tables(prime, inner)
    return {"ngather": t["rgather"], "ntw": t["rtw"], "nspec": t["rspec"]}


def plan_positions(radices: Tuple[int, ...], rader: Tuple[int, ...] = ()) -> np.ndarray:
    """Where a direct transform by the DIF stages ``radices`` leaves X_k
    (k < N, the product of ``radices``): their DIF positions; where
    ``rader`` is set (the last stage is then a Rader stage of prime p, its
    butterflies the contiguous runs of p points, ``rader`` its inner
    radices) remapped to where that stage leaves its outputs, X_{g^m} of
    butterfly b at b (p - 1) + m and X_0 at N' + b (N' = N (p - 1) / p, the
    tail the inner transforms do not use). Nested inner stages do not move
    the outer stage's outputs: the transposed inner transform's first stage
    scatters them back to natural order."""
    pos = dif_positions(radices)
    if not rader:
        return pos
    p, n = radices[-1], int(np.prod(radices, dtype=np.int64))
    log = np.zeros(p, np.int64)
    log[_generator_powers(p)[0]] = np.arange(p - 1)
    b, s = pos // p, pos % p
    return np.where(s == 0, n - n // p + b, b * (p - 1) + log[s])


def output_positions(plan) -> np.ndarray:
    """Where the mixed and cluster bodies leave X_k of a direct plan, k < L
    (the ``pos`` table the bins' power reads): `plan_positions` of the
    plan's radices and Rader stage."""
    return plan_positions(plan.radices, plan.rader)


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero: what ``cvt.rna.tf32.f32`` does on the card."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def pair_matrices(radix: int) -> Tuple[np.ndarray, np.ndarray]:
    """The two real matrices of an odd R-point DFT in pair form, float64,
    rows r and columns s from 0 to H = (R - 1) / 2, zero-padded to 8
    `matrix_tiles` each way: cos[r, s] = cos(2 pi r s / R), and sin[r, s] =
    sin(2 pi r s / R) but 0 at r = 0 or s = 0. With a_0 = v_0, a_r = v_r +
    v_{R-r}, b_r = v_r - v_{R-r} and P = a cos, Q = b sin: X_0 = P_0, X_s =
    P_s - i Q_s and X_{R-s} = P_s + i Q_s. The angles reduce r s mod R
    exactly."""
    kp = 8 * matrix_tiles(radix)
    h = (radix - 1) // 2
    r = np.arange(h + 1)
    ang = 2.0 * np.pi * (np.outer(r, r) % radix) / radix
    cos, sin = np.zeros((kp, kp)), np.zeros((kp, kp))
    cos[: h + 1, : h + 1] = np.cos(ang)
    sin[1 : h + 1, 1 : h + 1] = np.sin(ang[1:, 1:])
    return cos, sin


def matrix_table(radix: int) -> np.ndarray:
    """`pair_matrices` (radix) as the ``mma.m16n8k8`` TF32 B fragments of
    ``matrix_stage``, each value split in two TF32 parts, hi its TF32
    rounding and lo that of the float64 rest: for each k tile kt and n tile
    nt, lane 4 g + t holds (hi[k, n], hi[k + 4, n], lo[k, n], lo[k + 4, n])
    of cos and then of sin, at k = 8 kt + t, n = 8 nt + g. ``(tiles^2 x 32 x
    8,)`` float32."""
    t = matrix_tiles(radix)
    lane = np.arange(32)
    k = 8 * np.arange(t)[:, None, None] + (lane % 4)[None, None, :]
    n = 8 * np.arange(t)[None, :, None] + (lane // 4)[None, None, :]
    parts = []
    for g in pair_matrices(radix):
        hi = _tf32(g.astype(np.float32))
        lo = _tf32((g - hi.astype(np.float64)).astype(np.float32))
        parts += [hi[k, n], hi[k + 4, n], lo[k, n], lo[k + 4, n]]
    return np.stack(parts, axis=-1).reshape(-1)


def mixed_operands(sr: int, n_fft: int, n_mels: int, fmin: float, fmax,
                   plan: Optional[str] = None) -> dict:
    """The mixed body's operands for `mixed_plan` (n_fft, ``plan``), each
    computed in float64 and rounded once to float32: the
    Hann window, the stage twiddles of the N-point transform (``tw[m] =
    exp(-2 pi i m / N)``, ``(N, 2)``, the register radices' constants among
    them), at an even n_fft the untangle twiddles (``utw[k] = exp(-2 pi i k
    / n_fft)``, ``(L + 1, 2)``); direct: the positions of X_k (``pos``,
    int32, `output_positions`), with a Rader stage its `rader_tables`, and
    with a nested Rader stage its `nested_tables`, and with matrix stages
    their `matrix_table` s in stage order, the Rader stage's inner ones
    next, the nested stage's inner ones last (``dft``); Bluestein: the chirp (``(L, 2)``) and
    the filter spectrum (``bspec``, ``(M, 2)``); the mel filterbank as CSR
    rows."""
    return plan_operands(sr, n_mels, fmin, fmax, mixed_plan(n_fft, plan))


def plan_operands(sr: int, n_mels: int, fmin: float, fmax, plan: MixedPlan) -> dict:
    """`mixed_operands` of the plan ``plan``."""
    n_fft = plan.n_fft
    first, ptr, weights = mel_csr(sr, n_fft, n_mels, fmin, fmax)
    ops = {"window": hann_window(n_fft, np.float64).astype(np.float32),
           "tw": _unit_roots(plan.n, plan.n), "mel_first": first, "mel_ptr": ptr, "mel_w": weights}
    if n_fft % 2 == 0:
        ops["utw"] = _unit_roots(plan.points + 1, n_fft)
    if plan.bluestein:
        ops["chirp"] = bluestein_chirp(plan.points)
        ops["bspec"] = bluestein_filter(plan.points, plan.radices)
    else:
        ops["pos"] = output_positions(plan).astype(np.int32)
    if plan.rader:
        ops.update(rader_tables(plan.rader_prime, plan.rader, plan.nested))
    if plan.nested:
        ops.update(nested_tables(plan.nested_prime, plan.nested))
    if plan.tensor_cores:
        ops["dft"] = np.concatenate([matrix_table(r) for r in
                                     plan.matrix + plan.rader_matrix + plan.nested_matrix])
    ops["mel_group"] = mel_group(ptr)
    return ops


_OPERANDS = {"dif": dif_operands, "exact": exact_operands, "fft": fft_operands,
             "mixed": mixed_operands}


def _mixed_kind(plan: Optional[str] = None):
    """The operand kind of `mixed_plan` (n, ``plan``)."""
    return "mixed" if plan is None else ("mixed", plan)


@lru_cache(maxsize=16)
def _device_operands(sr, n_fft, n_mels, fmin, fmax, kind, device: str) -> dict:
    """The operands of ``kind`` (``"dif"``, ``"exact"``, ``"fft"``,
    ``"mixed"``, or a forced mixed plan's `_mixed_kind`) on ``device``,
    built on the host and cached only here: the cached tensors are shared,
    read only."""
    ops = (_OPERANDS[kind] if isinstance(kind, str) else
           partial(mixed_operands, plan=kind[1]))(sr, n_fft, n_mels, fmin, fmax)
    return {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
            for k, v in ops.items()}


def _operands(cfg: FrontendConfig, n_fft: int, kind, device: torch.device) -> dict:
    with _lock:   # one build per key when threads meet an empty cache
        return _device_operands(cfg.sample_rate, n_fft, cfg.n_mels, cfg.fmin, cfg.fmax,
                                kind, str(device))


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown fused log-mel mode {mode!r}; expected one of {MODES}")


def route(n_samples: int, cfg: FrontendConfig, mode: str = "dif") -> str:
    """Which formulation and frame source `fused_log_mel` takes for a signal
    of ``n_samples`` (before centre padding): ``"chunked"``, ``"framed"`` or
    ``"exact"``."""
    _check_mode(mode)
    if mode == "exact" or cfg.n_fft % 4:
        return "exact"
    if cfg.hop_length * 2 == cfg.n_fft and n_samples >= cfg.n_fft:
        return "chunked"
    return "framed"


def frame_source(y: torch.Tensor, cfg: FrontendConfig) -> Tuple[torch.Tensor, int]:
    """The (centre-padded) contiguous waveform and its frame count: frame t
    is ``n_fft`` samples from ``t * hop``, as `stft.frame_signal` cuts it."""
    if y.ndim != 1:
        raise ValueError(f"expected a 1-D waveform, got shape {tuple(y.shape)}")
    if cfg.center:
        y = reflect_pad(y, cfg.n_fft // 2)
    if y.shape[0] < cfg.n_fft:
        raise ValueError(f"signal length {y.shape[0]} < n_fft {cfg.n_fft}")
    return y.contiguous(), 1 + (y.shape[0] - cfg.n_fft) // cfg.hop_length


def _finish(mel: torch.Tensor, log_floor) -> torch.Tensor:
    if log_floor is not None:
        mel = torch.clamp_min(mel, log_floor)
    return torch.log(mel)


def _plain(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
           cfg: FrontendConfig, direct: bool) -> torch.Tensor:
    """The JAX kernels' arithmetic in float32 PyTorch ops (the DIF real DFT
    or, ``direct``, the full DFT, as products against their bases), frames
    read from the flat ``src`` at ``t * stride``."""
    ops = _operands(cfg, n_fft, "exact" if direct else "dif", src.device)
    base = src.storage_offset()
    if direct:
        fr = src.as_strided((n_frames, n_fft), (stride, 1), base)
        re, im = fr @ ops["bc"], fr @ ops["bs"]
        return _finish((re * re + im * im) @ ops["melw"], cfg.log_floor)
    M = n_fft // 2
    ne = ops["n_even_tiles"] * BIN_TILE
    ya = ops["wa"] * src.as_strided((n_frames, M), (stride, 1), base)
    yb = ops["wb"] * src.as_strided((n_frames, M), (stride, 1), base + M)
    s, d = ya + yb, ya - yb
    e_re, e_im = s @ ops["bc"][:, :ne], s @ ops["bs"][:, :ne]
    d_re, d_im = d @ ops["bc"][:, ne:], d @ ops["bs"][:, ne:]
    power = torch.cat([e_re * e_re + e_im * e_im, d_re * d_re + d_im * d_im], dim=1)
    return _finish(power @ ops["melw"], cfg.log_floor)


def _untangle(a, b, utw):
    """``bin_power`` of the FFT bodies: |X_k|^2 from Z_k = ``a`` and Z_{L-k} =
    ``b`` (each a (re, im) pair), w = ``utw`` = exp(-2 pi i k / n_fft):
    E = (a + conj b) / 2, O = (a - conj b) / 2i, X_k = E + w O."""
    (a_r, a_i), (b_r, b_i) = a, b
    w_r, w_i = utw[:, 0], utw[:, 1]
    e_r, e_i = 0.5 * (a_r + b_r), 0.5 * (a_i - b_i)
    o_r, o_i = 0.5 * (a_i + b_i), 0.5 * (b_r - a_r)
    x_r = e_r + (w_r * o_r - w_i * o_i)
    x_i = e_i + (w_r * o_i + w_i * o_r)
    return x_r * x_r + x_i * x_i


def _csr_mel(power: torch.Tensor, ops: dict, n_mels: int) -> torch.Tensor:
    """The FFT body's mel sums: (frames, bins) power against the CSR rows,
    each band's bins added in bin order (bin i of every band at once). The
    mixed and cluster bodies add in `_lane_mel`'s order."""
    first, ptr, mel_w = ops["mel_first"].long(), ops["mel_ptr"].long(), ops["mel_w"]
    count = ptr[1:] - ptr[:-1]
    acc = torch.zeros((power.shape[0], n_mels), dtype=torch.float32, device=power.device)
    for i in range(int(count.max())):
        live = i < count
        w = torch.where(live, mel_w[torch.clamp(ptr[:-1] + i, max=mel_w.numel() - 1)], 0.0)
        acc = acc + w * power[:, torch.clamp(first + i, max=power.shape[1] - 1)]
    return acc


def _lane_mel(power: torch.Tensor, ops: dict, n_mels: int) -> torch.Tensor:
    """The mixed and cluster bodies' mel sums: (frames, bins) power against
    the CSR rows, bin i of a band (counted from its first bin) added into
    partial i mod 32 in bin order (lane i mod 32 of the band's warp in the
    cluster body, register i mod 32 of one thread in the mixed body), then
    the 32 partials combined by the fixed ``__shfl_xor_sync`` tree: at each
    step s = 16, 8, 4, 2, 1, p_l + p_{l + s} for l < s."""
    first, ptr, mel_w = ops["mel_first"].long(), ops["mel_ptr"].long(), ops["mel_w"]
    count = ptr[1:] - ptr[:-1]
    lanes = torch.arange(MEL_LANES, device=power.device)
    acc = torch.zeros((power.shape[0], n_mels, MEL_LANES), dtype=torch.float32,
                      device=power.device)
    for base in range(0, int(count.max()), MEL_LANES):
        i = base + lanes
        live = i[None, :] < count[:, None]
        w = torch.where(live, mel_w[torch.clamp(ptr[:-1, None] + i, max=mel_w.numel() - 1)], 0.0)
        p = power[:, torch.clamp(first[:, None] + i, max=power.shape[1] - 1)]
        acc = torch.where(live, acc + w * p, acc)
    s = MEL_LANES // 2
    while s:
        acc = acc[..., :s] + acc[..., s:2 * s]
        s //= 2
    return acc[..., 0]


def _butterfly(vr, vi):
    """The R-point forward DFT of ``csrc/logmel_fft.cu``'s ``butterfly<R>``
    (R = 2 or 4) on lists of real and imaginary parts, the same operations."""
    if len(vr) == 2:
        return [vr[0] + vr[1], vr[0] - vr[1]], [vi[0] + vi[1], vi[0] - vi[1]]
    t0r, t0i, t1r, t1i = vr[0] + vr[2], vi[0] + vi[2], vr[0] - vr[2], vi[0] - vi[2]
    t2r, t2i, t3r, t3i = vr[1] + vr[3], vi[1] + vi[3], vr[1] - vr[3], vi[1] - vi[3]
    return ([t0r + t2r, t1r + t3i, t0r - t2r, t1r - t3i],
            [t0i + t2i, t1i - t3r, t0i - t2i, t1i + t3r])


def _fft_plain(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
               cfg: FrontendConfig) -> torch.Tensor:
    """The FFT body's arithmetic stage by stage in float32 PyTorch ops, frames
    read from the flat ``src`` at ``t * stride``: the same radices, twiddle
    tables, untangle and CSR order, each product and sum rounded where the
    kernel rounds it (the kernel contracts nothing into an FMA), so that an
    indexing mistake shows on the CPU."""
    ops = _operands(cfg, n_fft, "fft", src.device)
    h = n_fft // 2
    x = src.as_strided((n_frames, n_fft), (stride, 1), src.storage_offset()) * ops["window"]
    re, im = x[:, 0::2], x[:, 1::2]                 # z[n] = x[2n] + i x[2n+1]
    tw_r, tw_i = ops["tw"][:, 0], ops["tw"][:, 1]
    log_h = h.bit_length() - 1
    ns = 1
    for radix in [2] * (log_h % 2) + [4] * (log_h // 2):    # Stockham, Ns = 1, R1, ...
        j = torch.arange(h // radix, device=src.device)
        k = j % ns
        vr = [re[:, j + r * (h // radix)] for r in range(radix)]
        vi = [im[:, j + r * (h // radix)] for r in range(radix)]
        if ns > 1:
            for r in range(1, radix):
                m = k * r * (h // (radix * ns))
                wr, wi = tw_r[m], tw_i[m]
                vr[r], vi[r] = vr[r] * wr - vi[r] * wi, vr[r] * wi + vi[r] * wr
        ur, ui = _butterfly(vr, vi)
        d = (j - k) * radix + k
        re, im = torch.empty_like(x[:, :h]), torch.empty_like(x[:, :h])
        for r in range(radix):
            re[:, d + r * ns], im[:, d + r * ns] = ur[r], ui[r]
        ns *= radix
    k = torch.arange(h + 1, device=src.device)
    return _finish(_csr_mel(_untangle((re[:, k % h], im[:, k % h]),
                                      (re[:, (h - k) % h], im[:, (h - k) % h]), ops["utw"]),
                            ops, cfg.n_mels), cfg.log_floor)


def fft_log_mel_plain(y: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """1-D waveform -> ``(n_frames, n_mels)`` log mel energies by the FFT
    body's arithmetic (`_fft_plain`), frames at stride hop on the (centre
    padded) waveform; a power-of-two ``n_fft`` from 256 to 16384."""
    if body(cfg.n_fft) != "fft":
        raise ValueError(f"the FFT body takes a power-of-two n_fft in [{1 << FFT_LOG_N[0]}, "
                         f"{1 << FFT_LOG_N[1]}], got {cfg.n_fft}")
    src, n_frames = frame_source(y.to(torch.float32), cfg)
    return _fft_plain(src, cfg.hop_length, n_frames, cfg.n_fft, cfg)


def _cmul(ar, ai, wr, wi):
    """``cmul`` of the kernels: (a.x w.x - a.y w.y, a.x w.y + a.y w.x)."""
    return ar * wr - ai * wi, ar * wi + ai * wr


# The float32 constants of the composite butterflies' twiddles (the
# kernels' literals): cos(pi / 4), cos(pi / 8), sin(pi / 8).
_C8, _C16, _S16 = (float(np.float32(v)) for v in (np.cos(np.pi / 4), np.cos(np.pi / 8),
                                                     np.sin(np.pi / 8)))


def _rotate(radix: int, e: int, vr, vi, tw_r, tw_i):
    """``rotate<R, E>`` of ``csrc/logmel_stages.cuh``: v times W_R^e inside a
    composite butterfly. Radix 8 and 16 (e in 16ths of a turn: 16 e / R):
    a quarter turn as a swap, an eighth and three eighths by cos(pi / 4) on
    the sum and difference, the others by `_cmul` with the float32
    constants; radix 9 by `_cmul` with the stage's constant tw[e N / 9]."""
    if radix == 9:
        step = tw_r.numel() // 9
        return _cmul(vr, vi, tw_r[e * step], tw_i[e * step])
    e16 = e * 16 // radix
    if e16 == 4:
        return vi, -vr
    if e16 == 2:
        return _C8 * (vr + vi), _C8 * (vi - vr)
    if e16 == 6:
        return _C8 * (vi - vr), -(_C8 * (vr + vi))
    w = {1: (_C16, -_S16), 3: (_S16, -_C16), 9: (-_C16, _S16)}[e16]
    return _cmul(vr, vi, w[0], w[1])


def _radix_butterfly(radix: int, vr, vi, tw_r, tw_i):
    """``butterfly<R>`` of ``csrc/logmel_stages.cuh``: radix 2 and 4 as in
    the FFT body; an odd radix by the pairs a_r = v_r + v_{R-r}, b_r = v_r -
    v_{R-r} against its constants e^{-2 pi i q / R} = ``tw[q N / R]``; a
    composite radix R = A B (`COMPOSITE`) as B A-point butterflies over n =
    n1 + B n2, the twiddles W_R^(n1 k2) (`_rotate`), then A B-point ones,
    X_{k2 + A k1}."""
    if radix in (2, 4):
        return _butterfly(vr, vi)
    if radix in COMPOSITE:
        b, a = COMPOSITE[radix]
        ur, ui = [], []
        for n1 in range(b):
            xr, xi = _radix_butterfly(a, vr[n1::b], vi[n1::b], tw_r, tw_i)
            for k2 in range(1, a):
                if n1:
                    xr[k2], xi[k2] = _rotate(radix, n1 * k2, xr[k2], xi[k2], tw_r, tw_i)
            ur.append(xr)
            ui.append(xi)
        out_r, out_i = [None] * radix, [None] * radix
        for k2 in range(a):
            xr, xi = _radix_butterfly(b, [u[k2] for u in ur], [u[k2] for u in ui], tw_r, tw_i)
            out_r[k2::a], out_i[k2::a] = xr, xi
        return out_r, out_i
    h = (radix - 1) // 2
    step = tw_r.numel() // radix
    c = [(tw_r[q * step], -tw_i[q * step]) for q in range(radix)]   # (cos, sin)
    ar = [None] + [vr[r] + vr[radix - r] for r in range(1, h + 1)]
    ai = [None] + [vi[r] + vi[radix - r] for r in range(1, h + 1)]
    br = [None] + [vr[r] - vr[radix - r] for r in range(1, h + 1)]
    bi = [None] + [vi[r] - vi[radix - r] for r in range(1, h + 1)]
    out_r, out_i = [vr[0]] * radix, [vi[0]] * radix
    for r in range(1, h + 1):
        out_r[0], out_i[0] = out_r[0] + ar[r], out_i[0] + ai[r]
    for s in range(1, h + 1):
        pr, pi = vr[0], vi[0]
        for r in range(1, h + 1):
            cs, sn = c[(r * s) % radix]
            pr, pi = pr + cs * ar[r], pi + cs * ai[r]
            tr, ti = sn * br[r], sn * bi[r]
            qr, qi = (tr, ti) if r == 1 else (qr + tr, qi + ti)
        out_r[s], out_i[s] = pr + qi, pi - qr
        out_r[radix - s], out_i[radix - s] = pr - qi, pi + qr
    return out_r, out_i


def _mixed_stage(re, im, radix: int, ls: int, tw_r, tw_i, transposed: bool):
    """One in-place stage of ``csrc/logmel_mixed.cu`` on sub-transforms of
    length ``ls`` (of a transform whose twiddle table ``tw`` has N entries;
    the array may hold a batch of them): butterfly b is sub-transform b // m
    at offset j = b % m (m = ls / R), its points g ls + j + r m; DIF:
    butterfly, then output s times e^{-2 pi i j s / ls}; transposed: input r
    times that, then butterfly; no twiddles when m = 1."""
    n = re.shape[1]
    m = ls // radix
    b = torch.arange(n // radix, device=re.device)
    j = b % m
    idx = [(b - j) * radix + j + r * m for r in range(radix)]
    vr, vi = [re[:, i] for i in idx], [im[:, i] for i in idx]
    tw_idx = [j * r * (tw_r.numel() // ls) for r in range(radix)]
    if transposed and m > 1:
        for r in range(1, radix):
            vr[r], vi[r] = _cmul(vr[r], vi[r], tw_r[tw_idx[r]], tw_i[tw_idx[r]])
    vr, vi = _radix_butterfly(radix, vr, vi, tw_r, tw_i)
    if not transposed and m > 1:
        for r in range(1, radix):
            vr[r], vi[r] = _cmul(vr[r], vi[r], tw_r[tw_idx[r]], tw_i[tw_idx[r]])
    re, im = torch.empty_like(re), torch.empty_like(im)
    for r in range(radix):
        re[:, idx[r]], im[:, idx[r]] = vr[r], vi[r]
    return re, im


def _matrix_stage(re, im, radix: int, ls: int, tw_r, tw_i, transposed: bool = False):
    """``matrix_stage`` of ``csrc/logmel_stages.cuh`` on sub-transforms of
    length ``ls``, with `_mixed_stage`'s butterflies and points: each
    butterfly's R-point DFT as one product with the exact DFT matrix in
    float64, rounded once to float32, and the twiddles in float32 as
    `_mixed_stage` applies them (after the product; before it, transposed).
    The kernel's three TF32 tensor-core products approximate that product
    (within a stated tolerance, not bitwise)."""
    n = re.shape[1]
    m = ls // radix
    b = torch.arange(n // radix, device=re.device)
    j = b % m
    r = torch.arange(radix, device=re.device)
    idx = ((b - j) * radix + j)[:, None] + m * r[None, :]
    vr, vi = re[:, idx], im[:, idx]
    t = j[:, None] * r[None, 1:] * (tw_r.numel() // ls)
    if transposed and m > 1:
        wr, wi = _cmul(vr[..., 1:], vi[..., 1:], tw_r[t], tw_i[t])
        vr, vi = torch.cat([vr[..., :1], wr], -1), torch.cat([vi[..., :1], wi], -1)
    x = torch.complex(vr.double(), vi.double())
    ang = 2.0 * np.pi * (np.outer(np.arange(radix), np.arange(radix)) % radix) / radix
    v = x @ torch.from_numpy(np.exp(-1j * ang)).to(re.device)
    vr, vi = v.real.float(), v.imag.float()
    if not transposed and m > 1:
        wr, wi = _cmul(vr[..., 1:], vi[..., 1:], tw_r[t], tw_i[t])
        vr, vi = torch.cat([vr[..., :1], wr], -1), torch.cat([vi[..., :1], wi], -1)
    re, im = torch.empty_like(re), torch.empty_like(im)
    re[:, idx], im[:, idx] = vr, vi
    return re, im


def _inner_stage(re, im, radix: int, ls: int, tw_r, tw_i, transposed: bool):
    """A register or matrix stage, by its radix."""
    if radix in REGISTER_RADICES:
        return _mixed_stage(re, im, radix, ls, tw_r, tw_i, transposed)
    return _matrix_stage(re, im, radix, ls, tw_r, tw_i, transposed)


def _rader_convolve(ar, ai, x0r, x0i, radices, nested, tables, nest_tables):
    """Steps 2-4 of a Rader stage of prime p on its gathered array (frames,
    N') of (p - 1)-point sequences a_m (or, for a transposed nested stage,
    the layout the forward stage left) and its x_0 (frames, N' / (p - 1)):
    the inner DIF stages ``radices`` (twiddles ``tables[1]``; the last a
    nested Rader stage where ``nested`` is set), X_0 = x_0 + A_0, the
    product with ``tables[2]`` (stored where the inner stages leave each
    frequency), x_0 added to its DC term, the transposed stages in reverse
    order. Returns the array (X_{g^m} - x_0 + x_0 at b (p - 1) + m) and
    X_0."""
    count = math.prod(radices)
    batches = ar.shape[1] // count
    ar, ai = _inner_transform(ar, ai, radices, nested, tables[1], nest_tables, False)
    # Each position's frequency slot in the table and each transform's DC
    # position: b (p - 1) + l without a nested stage; with one, the body of
    # transform b at b s + l (s = (p - 1)(q - 1) / q) and its tail at N's +
    # b (p - 1) / q + (l - s), the DC term first in its tail.
    split = count - count // _nested_prime(radices, nested) if nested else count
    t = torch.arange(ar.shape[1], device=ar.device)
    body_end = batches * split
    b = torch.where(t < body_end, t // split, (t - body_end) // max(1, count - split))
    slot = torch.where(t < body_end, t - b * split,
                       split + (t - body_end) - b * (count - split))
    dc = (torch.arange(batches, device=ar.device) * split if not nested else
          body_end + torch.arange(batches, device=ar.device) * (count - split))
    spec = tables[2]
    X0r, X0i = x0r + ar[:, dc], x0i + ai[:, dc]
    ar, ai = _cmul(ar, ai, spec[slot, 0], spec[slot, 1])
    ar[:, dc], ai[:, dc] = ar[:, dc] + x0r, ai[:, dc] + x0i
    ar, ai = _inner_transform(ar, ai, radices, nested, tables[1], nest_tables, True)
    return ar, ai, X0r, X0i


def _nested_prime(radices, nested) -> int:
    """The prime of a nested Rader stage: the last of ``radices`` where
    ``nested`` is set."""
    return radices[-1] if nested else 0


def _inner_transform(ar, ai, radices, nested, tw, nest_tables, transposed: bool):
    """A Rader stage's inner (p - 1)-point transforms over the batch ``ar``:
    the DIF stages of ``radices`` (register or matrix, twiddles ``tw``), or
    transposed in reverse order; where ``nested`` is set the last of them is
    a Rader stage of prime q (m = 1, its butterflies the runs of q points):
    forward, its gather into N'' = N' (q - 1) / q points and a tail of N' /
    q, its own convolution (`_rader_convolve` with ``nest_tables``), the
    output left in that layout (body, then tail); transposed, the
    convolution on that layout as it stands, then its scatter back to the
    runs: X_{g^m} of butterfly b from b (q - 1) + m to b q + g^m, X_0 from
    the tail to b q."""
    tw_r, tw_i = tw[:, 0], tw[:, 1]
    plain = radices[:-1] if nested else radices
    q = _nested_prime(radices, nested)
    if nested and transposed:
        gather = nest_tables[0].long()
        body = ar.shape[1] - ar.shape[1] // q
        br, bi, X0r, X0i = _rader_convolve(ar[:, :body], ai[:, :body], ar[:, body:],
                                           ai[:, body:], nested, (), nest_tables, None)
        runs = ar.shape[1] // q
        dst = (torch.arange(runs, device=ar.device)[:, None] * q + gather[None, :]).reshape(-1)
        start = torch.arange(runs, device=ar.device) * q
        ar, ai = torch.empty_like(ar), torch.empty_like(ai)
        ar[:, dst], ai[:, dst] = br, bi
        ar[:, start], ai[:, start] = X0r, X0i
    if transposed:
        ls = q or 1
        for radix in reversed(plain):
            ls *= radix
            ar, ai = _inner_stage(ar, ai, radix, ls, tw_r, tw_i, True)
        return ar, ai
    ls = math.prod(radices)
    for radix in plain:
        ar, ai = _inner_stage(ar, ai, radix, ls, tw_r, tw_i, False)
        ls //= radix
    if nested:
        runs = ar.shape[1] // q
        start = torch.arange(runs, device=ar.device) * q
        idx = (start[:, None] + nest_tables[0].long()[None, :]).reshape(-1)
        br, bi, X0r, X0i = _rader_convolve(ar[:, idx], ai[:, idx], ar[:, start], ai[:, start],
                                           nested, (), nest_tables, None)
        ar, ai = torch.cat([br, X0r], dim=1), torch.cat([bi, X0i], dim=1)
    return ar, ai


def _rader_stage(re, im, plan: MixedPlan, ops: dict):
    """The Rader stage of ``csrc/logmel_stages.cuh`` (the plan's last, m =
    1: butterfly b is the points b p .. b p + p - 1), operation by operation:
    gather a_m = v_{g^m} (``rgather``) into an array of N' = N (p - 1) / p
    points, b (p - 1) + m; the inner DIF stages on it (twiddles ``rtw``; a
    nested Rader stage last, `_inner_transform`); X_0 = x_0 + A_0; the
    product with ``rspec``, x_0 added to its DC term; the transposed stages
    in reverse order. X_{g^m} is then at b (p - 1) + m, and X_0 goes to the
    tail N' + b (`output_positions`)."""
    p = plan.rader_prime
    start = torch.arange(re.shape[1] // p, device=re.device) * p
    idx = (start[:, None] + ops["rgather"].long()[None, :]).reshape(-1)
    nest = (ops["ngather"], ops["ntw"], ops["nspec"]) if plan.nested else None
    ar, ai, X0r, X0i = _rader_convolve(re[:, idx], im[:, idx], re[:, start], im[:, start],
                                       plan.rader, plan.nested,
                                       (ops["rgather"], ops["rtw"], ops["rspec"]), nest)
    return torch.cat([ar, X0r], dim=1), torch.cat([ai, X0i], dim=1)


def _mixed_plain(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
                 cfg: FrontendConfig, forced: Optional[str] = None) -> torch.Tensor:
    """The mixed body's arithmetic stage by stage in float32 PyTorch ops,
    frames read from the flat ``src`` at ``t * stride``: the same plan
    (`mixed_plan` (n_fft, ``forced``)), tables and order, each
    product and sum rounded where the kernel rounds it (the kernel contracts
    nothing into an FMA); a matrix stage by `_matrix_stage`, a Rader stage
    by `_rader_stage`."""
    plan = mixed_plan(n_fft, forced)
    ops = _operands(cfg, n_fft, _mixed_kind(forced), src.device)
    big, pts = plan.n, plan.points
    x = src.as_strided((n_frames, n_fft), (stride, 1), src.storage_offset()) * ops["window"]
    if n_fft % 2 == 0:
        re, im = x[:, 0::2], x[:, 1::2]             # z[n] = x[2n] + i x[2n+1]
    else:
        re, im = x, torch.zeros_like(x)
    tw_r, tw_i = ops["tw"][:, 0], ops["tw"][:, 1]
    if plan.bluestein:
        ch_r, ch_i = ops["chirp"][:, 0], ops["chirp"][:, 1]
        re, im = _cmul(re, im, ch_r, ch_i)
        zeros = torch.zeros((n_frames, big - pts), dtype=torch.float32, device=src.device)
        re, im = torch.cat([re, zeros], dim=1), torch.cat([im, zeros], dim=1)
    ls = big
    for radix, kind in zip(plan.radices, plan.kinds):
        if kind == "rader":
            re, im = _rader_stage(re, im, plan, ops)
        else:
            re, im = _inner_stage(re, im, radix, ls, tw_r, tw_i, False)
        ls //= radix
    if plan.bluestein:
        re, im = _cmul(re, im, ops["bspec"][:, 0], ops["bspec"][:, 1])
        im = -im
        for radix in reversed(plan.radices):
            ls *= radix
            re, im = _mixed_stage(re, im, radix, ls, tw_r, tw_i, True)

        def spectrum(k):                            # w_k conj(D_k)
            return _cmul(re[:, k], -im[:, k], ch_r[k], ch_i[k])
    else:
        pos = ops["pos"].long()

        def spectrum(k):
            return re[:, pos[k]], im[:, pos[k]]
    k = torch.arange(n_fft // 2 + 1, device=src.device)
    if n_fft % 2 == 0:
        power = _untangle(spectrum(k % pts), spectrum((pts - k) % pts), ops["utw"])
    else:
        z_r, z_i = spectrum(k)
        power = z_r * z_r + z_i * z_i
    return _finish(_lane_mel(power, ops, cfg.n_mels), cfg.log_floor)


def mixed_log_mel_plain(y: torch.Tensor, cfg: FrontendConfig,
                        plan: Optional[str] = None) -> torch.Tensor:
    """A 1-D waveform (frames at stride hop on the centre-padded waveform) or
    an ``(n_frames, n_fft)`` frame matrix -> ``(n_frames, n_mels)`` log mel
    energies by the mixed body's arithmetic (`_mixed_plain`), at an n_fft
    that `body` sends to ``"mixed"`` or ``"cluster"`` (the same plan and
    operations, split over a cluster); ``plan`` forces a plan kind as
    `mixed_plan` does."""
    n_fft = y.shape[1] if y.ndim == 2 else cfg.n_fft
    if body(n_fft) not in ("mixed", "cluster"):
        raise ValueError(f"the mixed and cluster bodies do not take n_fft {n_fft} "
                         f"(body {body(n_fft)!r})")
    if y.ndim == 2:
        src, n_frames, n_fft, _ = _frame_matrix(y.to(torch.float32), "dif")
        return _mixed_plain(src, n_fft, n_frames, n_fft, cfg, plan)
    src, n_frames = frame_source(y.to(torch.float32), cfg)
    return _mixed_plain(src, cfg.hop_length, n_frames, cfg.n_fft, cfg, plan)


def fused_log_mel_plain(y: torch.Tensor, cfg: FrontendConfig, mode: str = "dif") -> torch.Tensor:
    """1-D waveform -> ``(n_frames, n_mels)`` log mel energies by the route
    `fused_log_mel` takes, in plain float32 PyTorch ops."""
    r = route(y.shape[0], cfg, mode)
    src, n_frames = frame_source(y.to(torch.float32), cfg)
    return _plain(src, cfg.hop_length, n_frames, cfg.n_fft, cfg, r == "exact")


def _frame_matrix(frames: torch.Tensor, mode: str) -> Tuple[torch.Tensor, int, int, bool]:
    """A frame matrix as the flat source read at stride n_fft, its frame
    count and n_fft, and whether it takes the direct formulation."""
    _check_mode(mode)
    if frames.ndim != 2 or frames.shape[0] == 0:
        raise ValueError(f"expected (n_frames, n_fft) frames, got {tuple(frames.shape)}")
    n_frames, n_fft = frames.shape
    return frames.contiguous().view(-1), n_frames, n_fft, mode == "exact" or n_fft % 4 != 0


def fused_log_mel_frames_plain(frames: torch.Tensor, cfg: FrontendConfig,
                               mode: str = "dif") -> torch.Tensor:
    """``(n_frames, n_fft)`` frames -> ``(n_frames, n_mels)`` log mel energies,
    in plain float32 PyTorch ops (DIF, or direct for mode ``"exact"`` and
    ``n_fft % 4 != 0``)."""
    src, n_frames, n_fft, direct = _frame_matrix(frames.to(torch.float32), mode)
    return _plain(src, n_fft, n_frames, n_fft, cfg, direct)


@lru_cache(maxsize=None)
def _mixed_lib() -> ctypes.CDLL:
    lib = _build.load("logmel_mixed")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.logmel_mixed.argtypes = ([p, ctypes.c_longlong, i, i, i, i, ctypes.POINTER(i), i, i,
                                  ctypes.POINTER(i), i, ctypes.POINTER(i)] + [p] * 16
                                 + [i, i, i, ctypes.c_float, p, p])
    lib.logmel_mixed.restype = i
    for name in ("logmel_mixed_max_smem", "logmel_mixed_max_stages"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.logmel_mixed_error_string.argtypes = [i]
    lib.logmel_mixed_error_string.restype = ctypes.c_char_p
    lib.logmel_mixed_matrix_tiles.argtypes = []
    lib.logmel_mixed_matrix_tiles.restype = i
    if (lib.logmel_mixed_max_smem(), lib.logmel_mixed_max_stages(),
            lib.logmel_mixed_matrix_tiles()) != (MIXED_MAX_SMEM, MIXED_MAX_STAGES, MATRIX_TILES):
        raise RuntimeError("csrc/logmel_mixed.cu limits differ from MIXED_MAX_SMEM / "
                           "MIXED_MAX_STAGES / MATRIX_TILES")
    return lib


@lru_cache(maxsize=None)
def _fft_lib() -> ctypes.CDLL:
    lib = _build.load("logmel_fft")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.logmel_fft.argtypes = ([p, ctypes.c_longlong, i, i] + [p] * 6
                               + [i, i, ctypes.c_float, p, p])
    lib.logmel_fft.restype = i
    for name in ("logmel_fft_min_log_n", "logmel_fft_max_log_n"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.logmel_fft_error_string.argtypes = [i]
    lib.logmel_fft_error_string.restype = ctypes.c_char_p
    if (lib.logmel_fft_min_log_n(), lib.logmel_fft_max_log_n()) != FFT_LOG_N:
        raise RuntimeError("csrc/logmel_fft.cu size range differs from FFT_LOG_N")
    return lib


@lru_cache(maxsize=None)
def _cluster_lib() -> ctypes.CDLL:
    lib = _build.load("logmel_cluster")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.logmel_cluster.argtypes = ([p, ctypes.c_longlong, i, i, i, i, ctypes.POINTER(i), i, i,
                                    ctypes.POINTER(i), i, i, i, ctypes.c_uint, ctypes.c_uint]
                                   + [p] * 13 + [i, i, ctypes.c_float, p, p])
    lib.logmel_cluster.restype = i
    lib.logmel_cluster_resident.argtypes = [i, i, i]
    lib.logmel_cluster_resident.restype = i
    for name in ("logmel_cluster_max_smem", "logmel_cluster_max_ctas",
                 "logmel_cluster_max_stages", "logmel_cluster_matrix_tiles"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.logmel_cluster_error_string.argtypes = [i]
    lib.logmel_cluster_error_string.restype = ctypes.c_char_p
    if (lib.logmel_cluster_max_smem(), lib.logmel_cluster_max_ctas(),
            lib.logmel_cluster_max_stages(), lib.logmel_cluster_matrix_tiles()) != (
                MIXED_MAX_SMEM, CLUSTER_MAX, MIXED_MAX_STAGES, MATRIX_TILES):
        raise RuntimeError("csrc/logmel_cluster.cu limits differ from MIXED_MAX_SMEM / "
                           "CLUSTER_MAX / MIXED_MAX_STAGES / MATRIX_TILES")
    return lib


def cluster_resident(ctas: int, threads: int = 1024, smem: int = MIXED_MAX_SMEM) -> int:
    """How many clusters of ``ctas`` CTAs of ``threads`` threads and ``smem``
    bytes of shared memory each the current card holds at once (0: it
    refuses such a launch), by ``cudaOccupancyMaxActiveClusters``."""
    n = _cluster_lib().logmel_cluster_resident(ctas, threads, smem)
    if n < 0:
        raise RuntimeError(f"logmel_cluster_resident failed: "
                           f"{_cluster_lib().logmel_cluster_error_string(-n).decode()}")
    return n


def _check_cuda(x: torch.Tensor, cfg: FrontendConfig) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32 samples, got {x.dtype}")
    if cfg.n_mels < 1:
        raise ValueError(f"n_mels must be at least 1, got {cfg.n_mels}")


def _floor(cfg: FrontendConfig) -> Tuple[int, float]:
    use = cfg.log_floor is not None
    return int(use), float(cfg.log_floor) if use else 0.0


def _launch_fft(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
                cfg: FrontendConfig) -> torch.Tensor:
    ops = _operands(cfg, n_fft, "fft", src.device)
    out = torch.empty((n_frames, cfg.n_mels), dtype=torch.float32, device=src.device)
    lib = _fft_lib()
    with torch.cuda.device(src.device):
        status = lib.logmel_fft(
            src.data_ptr(), stride, n_frames, n_fft.bit_length() - 1,
            *(ops[k].data_ptr() for k in ("window", "tw", "utw", "mel_first", "mel_ptr",
                                          "mel_w")),
            cfg.n_mels, *_floor(cfg), out.data_ptr(),
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"logmel_fft launch failed: {lib.logmel_fft_error_string(status).decode()}")
    return out


_MIXED_TABLES = ("window", "tw", "pos", "chirp", "bspec", "utw", "dft", "rgather", "rtw", "rspec",
                 "ngather", "ntw", "nspec", "mel_first", "mel_ptr", "mel_w")
_NESTED_TABLES = ("ngather", "ntw", "nspec")      # the mixed body's alone


def _mixed_args(plan: MixedPlan, ops: dict, nested: bool = True) -> tuple:
    """The plan as `logmel_mixed` (``nested``) and `logmel_cluster` take it
    after the frame source (n_fft, N, stages, radices, Bluestein), then the
    Rader stage's inner stages and radices and, for the mixed body, the
    nested stage's, then the table pointers (None where the plan has no such
    table; the nested stage's for the mixed body only)."""
    radices = (ctypes.c_int * max(1, len(plan.radices)))(*plan.radices)
    inner = (len(plan.rader), (ctypes.c_int * max(1, len(plan.rader)))(*plan.rader))
    if nested:
        inner += (len(plan.nested), (ctypes.c_int * max(1, len(plan.nested)))(*plan.nested))
    keys = [k for k in _MIXED_TABLES if nested or k not in _NESTED_TABLES]
    return ((plan.n_fft, plan.n, len(plan.radices), radices, int(plan.bluestein)), inner,
            tuple(ops[k].data_ptr() if k in ops else None for k in keys))


def _launch_mixed(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
                  cfg: FrontendConfig, plan: Optional[str] = None,
                  group: Optional[int] = None) -> torch.Tensor:
    """The mixed body by `mixed_plan` (n_fft, ``plan``), a
    band's mel sum on ``group`` lanes (`mel_group` by default; 4, 8, 16 or
    32 give the same bits); raises with the launcher's error where the plan
    is refused."""
    return launch_mixed_plan(src, stride, n_frames, cfg, mixed_plan(n_fft, plan),
                             _operands(cfg, n_fft, _mixed_kind(plan), src.device), group)


def launch_mixed_plan(src: torch.Tensor, stride: int, n_frames: int, cfg: FrontendConfig,
                      mp: MixedPlan, ops: dict, group: Optional[int] = None) -> torch.Tensor:
    """`_launch_mixed` of the plan ``mp`` with its operands ``ops``
    (`plan_operands` on the card)."""
    args, inner, tables = _mixed_args(mp, ops)
    out = torch.empty((n_frames, cfg.n_mels), dtype=torch.float32, device=src.device)
    lib = _mixed_lib()
    with torch.cuda.device(src.device):
        status = lib.logmel_mixed(
            src.data_ptr(), stride, n_frames, *args, *inner, *tables, cfg.n_mels,
            ops["mel_group"] if group is None else group, *_floor(cfg),
            out.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"logmel_mixed launch failed: {lib.logmel_mixed_error_string(status).decode()}")
    with _lock:
        fused_log_mel.mixed_launches += 1
    return out


def _launch_cluster(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
                    cfg: FrontendConfig, ctas: Optional[int] = None,
                    plan: Optional[str] = None) -> torch.Tensor:
    """The cluster body by `mixed_plan` (n_fft, ``plan``),
    one frame a cluster of ``ctas`` CTAs (`cluster_size` by default; any 1
    .. ``CLUSTER_MAX`` whose share fits gives the same bits); raises
    ValueError beyond the body's limit, and the launcher's error where it
    or the card refuses the split."""
    return launch_cluster_plan(src, stride, n_frames, cfg, mixed_plan(n_fft, plan),
                               _operands(cfg, n_fft, _mixed_kind(plan), src.device), ctas)


def launch_cluster_plan(src: torch.Tensor, stride: int, n_frames: int, cfg: FrontendConfig,
                        mp: MixedPlan, ops: dict, ctas: Optional[int] = None) -> torch.Tensor:
    """`_launch_cluster` of the plan ``mp`` with its operands ``ops``;
    ValueError for a plan with a nested Rader stage, which the cluster body
    does not run."""
    if mp.nested:
        raise ValueError(f"n_fft {mp.n_fft}: the cluster body runs no nested Rader stage")
    sp = split_plan(mp, plan_cluster_size(mp) if ctas is None else ctas)
    cross, rcross = (sum(1 << s for s, c in enumerate(bits) if c)
                     for bits in (sp.cross, sp.rader_cross))
    args, inner, tables = _mixed_args(mp, ops, nested=False)
    out = torch.empty((n_frames, cfg.n_mels), dtype=torch.float32, device=src.device)
    lib = _cluster_lib()
    with torch.cuda.device(src.device):
        status = lib.logmel_cluster(
            src.data_ptr(), stride, n_frames, *args, *inner, sp.ctas, sp.chunk, sp.bin_chunk,
            cross, rcross, *tables, cfg.n_mels, *_floor(cfg), out.data_ptr(),
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"logmel_cluster launch failed: {lib.logmel_cluster_error_string(status).decode()}")
    with _lock:
        fused_log_mel.cluster_launches += 1
    return out


_LAUNCHERS = {"fft": _launch_fft, "mixed": _launch_mixed, "cluster": _launch_cluster}


def _launch(src: torch.Tensor, stride: int, n_frames: int, n_fft: int,
            cfg: FrontendConfig) -> torch.Tensor:
    """One launch over frames ``src[t*stride : t*stride + n_fft]``, by the
    body `body` names for ``n_fft``."""
    if src.ndim != 1 or not src.is_contiguous():
        raise ValueError("the frame source must be a contiguous 1-D tensor")
    if n_frames <= 0 or (n_frames - 1) * stride + n_fft > src.shape[0]:
        raise ValueError(f"{n_frames} frames of {n_fft} at stride {stride} overrun "
                         f"{src.shape[0]} samples")
    return _LAUNCHERS[body(n_fft)](src, stride, n_frames, n_fft, cfg)


def _count(r: str) -> None:
    with _lock:
        if r == "chunked":
            fused_log_mel.launches += 1
        elif r == "framed":
            fused_log_mel.framed_launches += 1
        else:
            fused_log_mel.exact_launches += 1


def fused_log_mel(y: torch.Tensor, cfg: FrontendConfig, mode: str = "dif") -> torch.Tensor:
    """1-D float32 waveform -> ``(n_frames, n_mels)`` log mel energies.
    CUDA tensor: the kernel, by the route `route` names; CPU tensor:
    `fused_log_mel_plain`."""
    if y.device.type == "cpu":
        return fused_log_mel_plain(y, cfg, mode)
    _check_cuda(y, cfg)
    r = route(y.shape[0], cfg, mode)
    src, n_frames = frame_source(y, cfg)
    out = _launch(src, cfg.hop_length, n_frames, cfg.n_fft, cfg)
    _count(r)
    return out


def fused_log_mel_frames(frames: torch.Tensor, cfg: FrontendConfig,
                         mode: str = "dif") -> torch.Tensor:
    """``(n_frames, n_fft)`` float32 frames -> ``(n_frames, n_mels)`` log mel
    energies (the JAX ``fused_log_mel_frames``). CUDA tensor: the kernel at
    stride ``n_fft``; CPU tensor: `fused_log_mel_frames_plain`."""
    if frames.device.type == "cpu":
        return fused_log_mel_frames_plain(frames, cfg, mode)
    _check_cuda(frames, cfg)
    src, n_frames, n_fft, direct = _frame_matrix(frames, mode)
    out = _launch(src, n_fft, n_frames, n_fft, cfg)
    _count("exact" if direct else "framed")
    return out


fused_log_mel.launches = 0
fused_log_mel.framed_launches = 0
fused_log_mel.exact_launches = 0
fused_log_mel.mixed_launches = 0
fused_log_mel.cluster_launches = 0
