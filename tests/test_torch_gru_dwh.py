"""Kernel B's dwh/dbh reduction above the warp body (``csrc/gru_dwh.cu``,
every H > 32) on the CPU: the Python mirror of its row split, the 3xTF32
emulation of its arithmetic (`gru_dwh_3xtf32`) against a float64 product and
against the JAX package's `_bwd_kernel` (its custom-VJP backward, Pallas
interpreted on the CPU), and the source's build rules.

Tolerance: 1e-4 of the largest entry of the reference, the band the card
holds dwh to (chip_smoke.py's GRAD_RTOL): the three TF32 products keep about
float32's 24 bits a product, and the sums run over B*T rows in another
order. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py [kernel B dwh]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.ops.pallas import gru_scan as jax_gru_scan

from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.kernels.gru_scan import (
    DWH_K,
    DWH_MIN_SPLIT_ROWS,
    DWH_SPLIT_BLOCKS,
    DWH_TILE,
    dwh_split_plan,
    gru_dwh_3xtf32,
    gru_dwh_plain,
    gru_scan_bwd_plain,
    gru_scan_fwd_res_plain,
    tf32_round,
)

RTOL = 1e-4
WIDEST_PAIR = 16897     # the grid body's first width of two unit blocks a CTA


def _operands(seed, B, T, H, reset_after, lead=()):
    """ys, res (r, z, n in (0, 1), hn), h0, dxp made with numpy."""
    rng = np.random.default_rng(seed)
    RW = 4 * H if reset_after else 3 * H
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (f32(np.tanh(rng.standard_normal(lead + (B, T, H)))),
            f32(rng.random(lead + (B, T, RW))),
            f32(0.5 * rng.standard_normal(lead + (B, H))),
            f32(rng.standard_normal(lead + (B, T, 3 * H))))


def _close(got, want, what):
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got.double() - want.double()).abs().max())
    assert err <= RTOL * scale, (what, err, scale)


@pytest.mark.parametrize("B,T", [(1, 1), (1, 4), (3, 200), (128, 256), (256, 256), (7, 33)])
@pytest.mark.parametrize("H", [33, 64, 128, 129, 257, 1024, 2048, WIDEST_PAIR])
def test_split_plan_is_a_function_of_b_t_h_with_bounded_partials(B, T, H):
    """Whole chunks of DWH_K rows covering B*T, no more splits than one per
    DWH_MIN_SPLIT_ROWS rows, about DWH_SPLIT_BLOCKS blocks at most; so
    a (direction, seed)'s partials hold at most DWH_SPLIT_BLOCKS x 128 x 128
    floats of dwh (17.3 MB), or one copy of dwh where a single split's tiles
    already fill the card twice (3.4 GB at H = 16,897)."""
    splits, chunk = dwh_split_plan(B, T, H)
    rows, tiles = B * T, 3 * (-(-H // DWH_TILE)) ** 2
    assert chunk % DWH_K == 0 and (splits - 1) * chunk < rows <= splits * chunk
    assert splits <= max(1, -(-rows // DWH_MIN_SPLIT_ROWS))
    assert splits == 1 or splits * tiles <= DWH_SPLIT_BLOCKS
    part_floats = splits * (3 * H * H + 3 * H)
    assert splits * 3 * H * H <= max(DWH_SPLIT_BLOCKS * DWH_TILE ** 2, 3 * H * H)
    if tiles * 2 >= DWH_SPLIT_BLOCKS:
        assert splits == 1 and part_floats == 3 * H * H + 3 * H
    if H == WIDEST_PAIR:
        assert 4 * part_floats == 3426306072   # 3.4 GB a direction, as dwh itself


def test_split_plan_at_the_timed_shapes():
    """B = 128, T = 256: 86 splits of 384 rows at H <= 128 (3 tiles), 22
    of 1,504 at H = 256, one split from H = 1024 (192 tiles a direction)."""
    assert dwh_split_plan(128, 256, 64) == dwh_split_plan(128, 256, 128) == (86, 384)
    assert dwh_split_plan(128, 256, 256) == (22, 1504)
    assert dwh_split_plan(128, 256, 1024) == dwh_split_plan(128, 256, 2048) == (1, 32768)


def test_tf32_round_is_cvt_rna():
    """Ten mantissa bits, to nearest, ties away from zero; x = hi + lo is
    exact in float32 and lo keeps the next 11 bits."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 2 ** -11),
                      3.14159265, 1e-30], dtype=torch.float32)
    hi = tf32_round(x)
    assert hi[0] == 1.0 and hi[1] == 1.0 + 2 ** -10 and hi[2] == 1.0 + 2 ** -9
    assert hi[3] == -(1.0 + 2 ** -10)
    bits = hi.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    lo = tf32_round(x - hi)
    assert float((x.double() - hi.double() - lo.double()).abs().max()) <= 2 ** -21 * 3.2


@pytest.mark.parametrize("H", [33, 64, 128, 257, 1024])
@pytest.mark.parametrize("reset_after", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_emulation_is_within_the_band_of_a_float64_product(H, reset_after, reverse):
    """The kernel's arithmetic (three TF32 products a chunk of 8 rows, the
    splits added in order) against `gru_dwh_plain` in float64: within 1e-4
    of the largest entry, dwh and dbh; several splits at the narrow widths."""
    B, T = (3, 200) if H <= 128 else (2, 40) if H == 257 else (2, 6)
    ys, res, h0, dxp = _operands(H + 7 * reverse, B, T, H, reset_after)
    got = gru_dwh_3xtf32(ys, res, h0, dxp, reset_after, reverse)
    want = gru_dwh_plain(ys.double(), res.double(), h0.double(), dxp.double(), reset_after,
                         reverse)
    _close(got[0], want[0], "dwh")
    _close(got[1], want[1], "dbh")
    if not reset_after:
        assert not bool(got[1].any())
    if H <= 128:
        assert dwh_split_plan(B, T, H)[0] == 3


@pytest.mark.parametrize("reset_after", [False, True])
def test_emulation_of_a_stack_is_seed_by_seed(reset_after):
    """A leading seed axis (stacked multi-seed training): seed 0 of a stack of
    three is bitwise the seed alone, and every seed within the band of its
    float64 product; the split plan does not read the seed count."""
    S, B, T, H = 3, 2, 150, 65
    ops = _operands(5, B, T, H, reset_after, lead=(S,))
    dwh, dbh = gru_dwh_3xtf32(*ops, reset_after, True)
    assert dwh.shape == (S, H, 3 * H) and dbh.shape == (S, 3 * H)
    alone = gru_dwh_3xtf32(*(t[0] for t in ops), reset_after, True)
    assert torch.equal(dwh[0], alone[0]) and torch.equal(dbh[0], alone[1])
    for s in range(S):
        want = gru_dwh_plain(*(t[s].double() for t in ops), reset_after, True)
        _close(dwh[s], want[0], f"dwh seed {s}")
        _close(dbh[s], want[1], f"dbh seed {s}")


@pytest.mark.parametrize("H", [33, 128])
@pytest.mark.parametrize("reset_after", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_emulation_matches_the_jax_backward_kernel(H, reset_after, reverse):
    """On the stored rows of the port's plain forward and the dxp of its
    plain backward, the emulated dwh/dbh within 1e-4 of the largest entry of
    the JAX `_bwd_kernel`'s (the VJP of its Pallas `gru_scan`, interpreted)."""
    assert jax_gru_scan.fits_vmem(12, 3, H, reset_after)
    B, T = 3, 12
    rng = np.random.default_rng(300 + H + 2 * reset_after + reverse)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    xp = f32(rng.standard_normal((B, T, 3 * H)))
    wh = f32(rng.standard_normal((H, 3 * H)) / np.sqrt(H))
    bh = f32(0.1 * rng.standard_normal(3 * H)) if reset_after else None
    h0 = f32(0.5 * rng.standard_normal((B, H)))
    dys = f32(rng.standard_normal((B, T, H)))
    dhl = f32(rng.standard_normal((B, H)))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731

    def run(xp_, wh_, bh_, h0_):
        return jax_gru_scan.gru_scan(xp_, wh_, bh_, h0_, reset_after=reset_after,
                                     gate_activation="sigmoid", reverse=reverse)

    _, vjp = jax.vjp(run, xp, wh, bh, h0)
    _, want_dwh, want_dbh, _ = vjp((jnp.asarray(dys), jnp.asarray(dhl)))
    ys, res, _ = gru_scan_fwd_res_plain(t(xp), t(wh), t(bh), t(h0), reset_after, "sigmoid",
                                        reverse)
    dxp = gru_scan_bwd_plain(ys, res, t(wh), t(h0), t(dys), t(dhl), reset_after, "sigmoid",
                             reverse)[0]
    dwh, dbh = gru_dwh_3xtf32(ys, res, t(h0), dxp, reset_after, reverse)
    _close(dwh, torch.from_numpy(np.array(want_dwh)), "dwh")
    if reset_after:
        _close(dbh, torch.from_numpy(np.array(want_dbh)), "dbh")
    else:
        assert not bool(dbh.any())


def test_dwh_source_is_built_uses_the_tensor_cores_and_calls_no_library():
    """csrc/gru_dwh.cu is one of the built sources, for sm_90a; it calls no
    cuDNN, cuBLAS, CUTLASS or other finished kernel; its products are
    mma.sync TF32 on operands split by `tf32_round`'s integer rounding (the
    bits of cvt.rna.tf32), staged by cp.async;
    its constants are the Python mirror's; the wide body's FMA reduction is
    gone."""
    assert "gru_dwh" in _build.KERNEL_SOURCES
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = (_build.CSRC_DIR / "gru_dwh.cu").read_text()
    includes = sorted(ln.split()[1] for ln in src.splitlines() if ln.startswith("#include"))
    assert includes == ["<cuda_runtime.h>", "<mutex>", "<stdint.h>", "<vector>"]
    for word in ("cudnn", "cublas", "cutlass", "matmul", "wgmma", "gru_wide_dwh", "atomicadd"):
        assert word not in src.lower()
    for word in ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                 "(__float_as_uint(x) + 0x1000u) & 0xffffe000u", "cp.async",
                 "gru_dwh_sum_partials", "gru_dwh_splits"):
        assert word in src
    for name, value in (("BM", DWH_TILE), ("BK", DWH_K), ("SPLIT_BLOCKS", DWH_SPLIT_BLOCKS),
                        ("MIN_SPLIT_ROWS", DWH_MIN_SPLIT_ROWS)):
        assert f"constexpr int {name} = {value};" in src
    assert src.count("mma_tf32(acc[mt][nt]") == 3    # lo.hi, hi.lo, hi.hi
    # two block tiles: 128 wide, 64 wide where H <= 64 (the split plan's
    # tiles are the wide ones at every H)
    assert "constexpr int BM_NARROW = 64;" in src and "launch<BM_NARROW, 2>" in src
    # The profiling cuts are the only build-time switch, off by default.
    assert "#define GRU_DWH_CUT 0\n" in src
    assert [ln.split()[1] for ln in src.splitlines() if ln.startswith("#define")] == [
        "GRU_DWH_CUT", "PICK(field)"]
    wide = (_build.CSRC_DIR / "gru_wide.cu").read_text()
    for name in ("gru_wide_dwh", "gru_wide_sum", "dwh_splits", "DwhDir", "constexpr int DT",
                 "constexpr int DK"):
        assert name not in wide
