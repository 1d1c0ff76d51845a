"""Kernel B's cluster tier (``csrc/gru_cluster.cu``, 128 < H <= CLUSTER_MAX_H)
on the CPU: the tier rule, the Python mirror of the launcher's plan (the
cluster size C, the rows a cluster R, a CTA's shared memory), the source's
build rules, and the order of its sums, emulated in float32.

Its JAX parity at H = 129 and 256 (the plain versions the CPU runs, against
the JAX package's interpreted Pallas kernel) is in
tests/test_torch_gru_wide.py; the kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py [kernel B wide]).
"""

import numpy as np
import pytest

from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.kernels.gru_scan import (
    CLUSTER_KQ,
    CLUSTER_UNITS_PER_GROUP,
    CLUSTER_MAX_CTAS,
    CLUSTER_MAX_H,
    CLUSTER_MAX_SMEM,
    CLUSTER_MAX_THREADS,
    CLUSTER_ROWS,
    CLUSTER_WEIGHT_BYTES,
    cluster_ctas,
    cluster_fits,
    cluster_geometry,
    cluster_rows,
    cluster_smem_bytes,
    cluster_threads,
    gru_body,
)


@pytest.mark.parametrize("H_,want", [
    (33, "wide"), (128, "wide"), (129, "cluster"), (256, "cluster"),
    (CLUSTER_MAX_H, "cluster"), (CLUSTER_MAX_H + 1, "grid")])
def test_tier_rule(H_, want):
    assert gru_body(H_) == want
    assert gru_body(H_, backward=True) == want


def test_cluster_max_h_is_the_widest_width_every_plan_fits():
    """512: at C = 16 a CTA holds 32 units' weights (198,144 bytes); from
    513 a CTA holds 33 units, rounded up to 36, over padded rows of 548
    floats, more than a CTA's 232,448 bytes."""
    assert CLUSTER_MAX_H == 512
    assert cluster_ctas(512) == CLUSTER_MAX_CTAS
    assert cluster_geometry(512, 16) == (32, 32, 512, 516)
    assert cluster_smem_bytes(512, 16, 1, backward=True) <= CLUSTER_MAX_SMEM
    assert not cluster_fits(513, cluster_ctas(513), 1, backward=False)


@pytest.mark.parametrize("H", [129, 160, 200, 255, 256, 257, 300, 384, 448, 500, 512])
def test_the_plan_fits_a_cta_and_its_cluster_size_is_a_function_of_h(H):
    C = cluster_ctas(H)
    U, UP, HP, WS = cluster_geometry(H, C)
    assert C in (2, 4, 8, 16) and C <= CLUSTER_MAX_CTAS
    assert U * C >= H and (U - 1) * C < H         # every unit on one CTA
    assert UP % (32 // CLUSTER_KQ * CLUSTER_UNITS_PER_GROUP) == 0      # whole warps
    assert cluster_threads(H, C) == UP // 2 * 16 <= CLUSTER_MAX_THREADS
    assert HP % (4 * CLUSTER_KQ) == 0 and HP >= H and WS == HP + 4
    if C < CLUSTER_MAX_CTAS:                       # the fewest CTAs under the budget
        assert 12 * UP * WS <= CLUSTER_WEIGHT_BYTES
        _, up, _, ws = cluster_geometry(H, C // 2)
        assert C == 2 or (12 * up * ws > CLUSTER_WEIGHT_BYTES
                          or cluster_threads(H, C // 2) > CLUSTER_MAX_THREADS)
    for backward in (False, True):
        assert cluster_smem_bytes(H, C, 1, backward) <= CLUSTER_MAX_SMEM


def test_h256_runs_on_eight_ctas_of_32_units():
    assert cluster_ctas(256) == 8
    assert cluster_geometry(256, 8) == (32, 32, 256, 260)
    assert cluster_threads(256, 8) == 256
    assert (cluster_ctas(129), cluster_geometry(129, 8)) == (8, (17, 20, 192, 196))
    assert cluster_smem_bytes(256, 8, 16, backward=False) == 173568
    assert cluster_smem_bytes(256, 8, 8, backward=True) == 177664


@pytest.mark.parametrize("H", [129, 256, 512])
@pytest.mark.parametrize("n_blocks", [2, 10])
def test_rows_a_cluster_fill_the_card_and_fit_shared_memory(H, n_blocks):
    """R, as the launcher picks it from B x 2 x S and the card's resident
    clusters (here a card that holds `cap` clusters at any R): the fewest
    rows whose clusters all fit at once, the most that fit shared memory
    otherwise; C never moves with B, S or the card."""
    C = cluster_ctas(H)
    for cap in (1, 7, 16, 33):
        for B in (1, 3, 8, 100, 128, 1000):
            for backward in (False, True):
                R = cluster_rows(H, B, n_blocks, lambda r: cap, backward)
                assert R in CLUSTER_ROWS
                assert cluster_smem_bytes(H, C, R, backward) <= CLUSTER_MAX_SMEM
                fits_once = -(-B // R) * n_blocks <= cap or R >= B
                bigger = [r for r in CLUSTER_ROWS if r > R and cluster_fits(H, C, r, backward)]
                assert fits_once or not bigger
                smaller = [r for r in CLUSTER_ROWS if r < R]
                assert all(-(-B // r) * n_blocks > cap and r < B for r in smaller)
                assert cluster_ctas(H) == C
    assert cluster_rows(H, 128, 2, lambda r: 0, False) == 0     # refused: no cluster fits


def _lane_partials(h, w):
    """csrc/gru_cluster.cu's per-lane sums for one unit's dot product of a
    state row h (H,) with a weight column w (H,), in float32: lane kq of
    the unit's group takes k = 4 (kq + 16 i) + c, c = 0..3, in that order,
    into one accumulator by fused multiply-adds (emulated in float64, then
    rounded) -> (16,)."""
    H = h.shape[0]
    HP = -(-H // (4 * CLUSTER_KQ)) * 4 * CLUSTER_KQ
    hp, wp = np.zeros(HP), np.zeros(HP)
    hp[:H], wp[:H] = h, w
    part = np.zeros(CLUSTER_KQ, np.float32)
    for kq in range(CLUSTER_KQ):
        acc = np.float32(0)
        for i in range(HP // (4 * CLUSTER_KQ)):
            for c in range(4):
                k = 4 * (kq + CLUSTER_KQ * i) + c
                acc = np.float32(np.float64(acc) + hp[k] * wp[k])
        part[kq] = acc
    return part


LEVELS = (8, 4, 2, 1)


def _all_reduce(part):
    """The tree over lanes kq ^ 8, ^ 4, ^ 2, ^ 1 of one row: every lane's value."""
    v = part.copy()
    for m in LEVELS:
        v = np.array([v[k] + v[k ^ m] for k in range(CLUSTER_KQ)], np.float32)
    return v


def _reduce_scatter(parts):
    """The same tree over a block of rows, (lanes, rows) -> (lanes,): while
    more than one row is left a lane keeps half of them (the upper half when
    kq & m) and adds its partner's half of the same rows, then adds its
    partner's value; lane kq ends with row kq / (16 / rows)."""
    v, active = parts.copy(), parts.shape[1]
    for m in LEVELS:
        new = v.copy()
        half = active // 2
        for kq in range(CLUSTER_KQ):
            if active == 1:
                new[kq, 0] = v[kq, 0] + v[kq ^ m, 0]
                continue
            up = bool(kq & m)
            for i in range(half):
                slot = i + half if up else i       # the partner sends the same slot
                new[kq, i] = v[kq, slot] + v[kq ^ m, slot]
        v, active = new, max(half, 1)
    return v[:, 0]


@pytest.mark.parametrize("H", [129, 256])
def test_the_order_of_sums_depends_on_h_only(H):
    """A row's sum is the same tree over its sixteen lane partials whether
    its block holds one row (every lane ends with the same bits) or 2, 4 or
    8 (the reduce-scatter leaves it on 8, 4 or 2 lanes): a sum of two terms
    is the same either way round. So the rows beside a row, R, C and the seed never
    change its bits; and the order is within float32 rounding of the
    float64 dot product."""
    rng = np.random.default_rng(H)
    rows = rng.standard_normal((8, H)).astype(np.float32)
    w = (rng.standard_normal(H) / np.sqrt(H)).astype(np.float32)
    parts = np.stack([_lane_partials(r, w) for r in rows], axis=1)     # (lanes, rows)
    alone = []
    for r in range(8):
        lanes = _all_reduce(parts[:, r])
        assert len(set(lanes.tolist())) == 1
        alone.append(lanes[0])
    for n in (8, 4, 2):                  # blocks of RB = 8, 4, 2 rows
        for first in range(0, 8, n):
            got = _reduce_scatter(parts[:, first:first + n])
            for kq in range(CLUSTER_KQ):
                assert got[kq] == alone[first + kq // (CLUSTER_KQ // n)]
    np.testing.assert_allclose(alone, rows.astype(np.float64) @ w.astype(np.float64),
                               rtol=0, atol=1e-5)


def test_cluster_source_is_built_and_calls_no_library():
    """csrc/gru_cluster.cu is one of the built sources, for sm_90a, calls
    no cuDNN, cuBLAS, CUTLASS or other finished kernel and uses no tensor
    cores; its constants are the Python mirror's."""
    assert "gru_cluster" in _build.KERNEL_SOURCES
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = (_build.CSRC_DIR / "gru_cluster.cu").read_text()
    includes = sorted(ln.split()[1] for ln in src.splitlines() if ln.startswith("#include"))
    assert includes == ["<cooperative_groups.h>", "<cuda_runtime.h>", "<math.h>", "<mutex>",
                        "<vector>"]
    for word in ("cudnn", "cublas", "cutlass", "matmul", "wgmma", "mma.sync"):
        assert word not in src.lower()
    for name, value in (("KQ", CLUSTER_KQ), ("UPL", CLUSTER_UNITS_PER_GROUP),
                        ("MAX_SMEM", CLUSTER_MAX_SMEM), ("MAX_CTAS", CLUSTER_MAX_CTAS),
                        ("WEIGHT_BYTES", CLUSTER_WEIGHT_BYTES)):
        assert f"constexpr int {name} = {value};" in src
    assert f"#define GRU_CLUSTER_MAX_THREADS {CLUSTER_MAX_THREADS}" in src
    assert "ROW_OPTIONS[] = {" + ", ".join(map(str, CLUSTER_ROWS)) + "};" in src
    assert "gru_cluster_max_h" in src and "cudaOccupancyMaxActiveClusters" in src
