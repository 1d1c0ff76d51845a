"""Kernel A's matrix stage on the CPU (``matrix_stage`` of
``csrc/logmel_stages.cuh``): its host table (`matrix_table`, the B
fragments it reads) against a float64 DFT of the radix, its three TF32
products in the kernel's order of sums, its warp jobs (how often each
point is gathered), the plan rule under the committed
`plan_cost` weights at
the phase tool's sizes, and `mixed_log_mel_plain` at a matrix plan against
the JAX package's `extract`.

Bands: the table's hi + lo parts within 2^-21 of each float64 entry (two
TF32 roundings); a radix's DFT through the table in float64 within 1e-12,
through the kernel's three TF32 products with float32 sums within 2e-6 of
the largest output (float32's precision, not its bits); 3.9e-6 in the log
domain against `extract`, -inf entries equal.
"""

import json
import math
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sed_crnn_tpu.core.config import FrontendConfig as JaxFrontendConfig
from sed_crnn_tpu.ops import frontend as jax_frontend

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.kernels import fused_logmel as fl

RADICES = (17, 23, 31, 373, 647)


def _table_parts(radix):
    """`matrix_table` back in matrix form: {cos, sin} x {hi, lo}, each (8 T,
    8 T) float64, from the fragment order the stage reads (k tile kt,
    column tile nt, lane 4 g + t: k = 8 kt + t and k + 4, n = 8 nt + g)."""
    t = fl.matrix_tiles(radix)
    tab = fl.matrix_table(radix).reshape(t, t, 32, 8)
    lane = np.arange(32)
    parts = {name: np.zeros((8 * t, 8 * t)) for name in
             ("cos_hi", "cos_lo", "sin_hi", "sin_lo")}
    for kt in range(t):
        for nt in range(t):
            k, n = 8 * kt + lane % 4, 8 * nt + lane // 4
            for off, name in enumerate(("cos", "sin")):
                f = tab[kt, nt, :, 4 * off: 4 * off + 4].astype(np.float64)
                parts[name + "_hi"][k, n], parts[name + "_hi"][k + 4, n] = f[:, 0], f[:, 1]
                parts[name + "_lo"][k, n], parts[name + "_lo"][k + 4, n] = f[:, 2], f[:, 3]
    return parts


def _pairs(x, radix):
    """a_r (a_0 = x_0) and b_r (b_0 = 0) of each row of ``x`` (rows, R),
    zero-padded to 8 `matrix_tiles` columns."""
    h, kp = (radix - 1) // 2, 8 * fl.matrix_tiles(radix)
    a = np.zeros(x.shape[:-1] + (kp,), x.dtype)
    b = np.zeros_like(a)
    a[..., 0] = x[..., 0]
    r = np.arange(1, h + 1)
    a[..., 1: h + 1] = x[..., r] + x[..., radix - r]
    b[..., 1: h + 1] = x[..., r] - x[..., radix - r]
    return a, b


def _assemble(p, q, radix):
    """X_0 = P_0, X_s = P_s - i Q_s, X_{R-s} = P_s + i Q_s."""
    h = (radix - 1) // 2
    out = np.zeros(p.shape[:-1] + (radix,), np.complex128)
    out[..., 0] = p[..., 0]
    s = np.arange(1, h + 1)
    out[..., s] = p[..., s] - 1j * q[..., s]
    out[..., radix - s] = p[..., s] + 1j * q[..., s]
    return out


@pytest.mark.parametrize("radix", RADICES)
def test_matrix_table_is_the_dft_of_the_radix(radix):
    """The fragments the stage reads hold TF32 hi and lo parts of the pair
    matrices (zero in the padding, sin zero at r = 0 or s = 0), hi + lo
    within 2^-21 of the float64 entry, and a random R-point transform
    through them in float64 is `np.fft.fft`'s."""
    t = fl.matrix_tiles(radix)
    assert fl.matrix_table(radix).shape == (t * t * 32 * 8,)
    parts = _table_parts(radix)
    cos, sin = fl.pair_matrices(radix)
    for name, exact in (("cos", cos), ("sin", sin)):
        hi, lo = parts[name + "_hi"], parts[name + "_lo"]
        for v in (hi, lo):
            bits = v.astype(np.float32).view(np.uint32)
            assert not (bits & np.uint32(0x1FFF)).any()          # TF32: 10 mantissa bits
        np.testing.assert_array_equal(hi == 0, exact == 0)
        assert np.abs(hi + lo - exact).max() <= 2.0 ** -21
    rng = np.random.default_rng(radix)
    x = rng.standard_normal((6, radix)) + 1j * rng.standard_normal((6, radix))
    a, b = _pairs(x, radix)
    got = _assemble(a @ (parts["cos_hi"] + parts["cos_lo"]),
                    b @ (parts["sin_hi"] + parts["sin_lo"]), radix)
    want = np.fft.fft(x, axis=-1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    got64 = _assemble(a @ cos, b @ sin, radix)
    assert np.abs(got64 - want).max() <= 1e-12 * np.abs(want).max()


def _mma3(acc, a, parts, name, kt):
    """One k tile of one product as the stage runs it: three TF32 products,
    a_lo b_hi, a_hi b_lo, a_hi b_hi, each summed over its 8 k in float64
    and added to the float32 accumulator (one rounding an mma)."""
    ks = slice(8 * kt, 8 * kt + 8)
    hi = fl._tf32(a.astype(np.float32))
    lo = fl._tf32((a.astype(np.float32) - hi).astype(np.float32))
    for av, bv in ((lo, parts[name + "_hi"]), (hi, parts[name + "_lo"]),
                   (hi, parts[name + "_hi"])):
        acc = (acc + av[..., ks].astype(np.float64) @ bv[ks]).astype(np.float32)
    return acc


@pytest.mark.parametrize("radix", RADICES)
def test_three_tf32_products_in_the_kernels_order(radix):
    """The stage's arithmetic emulated: A split into TF32 hi and lo, the k
    tiles in order, three products a tile on one float32 accumulator, then
    P_s +- i Q_s in float32: within 2e-6 of the largest output of a float64
    DFT (float32's precision at every radix up to 647), and the order a
    function of R alone (no batch or position enters it)."""
    parts = _table_parts(radix)
    rng = np.random.default_rng(100 + radix)
    x = (rng.standard_normal((8, radix)) + 1j * rng.standard_normal((8, radix))).astype(
        np.complex64)
    a, b = _pairs(x.astype(np.complex128), radix)
    a, b = a.astype(np.complex64), b.astype(np.complex64)
    t = fl.matrix_tiles(radix)
    rows = {}
    for part, src, name in (("p", a, "cos"), ("q", b, "sin")):
        for comp in ("real", "imag"):
            v = getattr(src, comp).astype(np.float32)
            acc = np.zeros((8, 8 * t), np.float32)
            for kt in range(t):
                acc = _mma3(acc, v, parts, name, kt)
            rows[part + comp] = acc
    h = (radix - 1) // 2
    s = np.arange(1, h + 1)
    got = np.zeros((8, radix), np.complex64)
    got[:, 0] = rows["preal"][:, 0] + 1j * rows["pimag"][:, 0]
    got[:, s] = ((rows["preal"][:, s] + rows["qimag"][:, s])
                 + 1j * (rows["pimag"][:, s] - rows["qreal"][:, s]))
    got[:, radix - s] = ((rows["preal"][:, s] - rows["qimag"][:, s])
                         + 1j * (rows["pimag"][:, s] + rows["qreal"][:, s]))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    again = np.zeros((8, 8 * t), np.float32)
    for kt in range(t):
        again = _mma3(again, a.real[::-1].astype(np.float32), parts, "cos", kt)
    np.testing.assert_array_equal(again[::-1], rows["preal"])


def _source(name):
    return (_build.CSRC_DIR / name).read_text()


def _job(radix, cols):
    """A warp job of the stage at ``cols`` column tiles (the bodies'
    ``COLS``), as ``run_matrix_stage`` and ``matrix_stage_pair`` of
    ``csrc/logmel_stages.cuh`` set it, read from that source: (row tiles,
    column tiles of each)."""
    text = _source("logmel_stages.cuh")
    above, tiles = map(int, re.search(
        r"if \(COLS > (\d+) && matrix_tiles\(R\) == (\d+)\)\s*\n\s*matrix_stage_pair<", text
    ).groups())
    pair_cols, rows = map(int, re.search(
        r"constexpr int COLS = (\d+), ROWS = (\d+), W = COLS / ROWS;", text).groups())
    if cols > above and fl.matrix_tiles(radix) == tiles:
        return rows, pair_cols // rows
    return 1, cols


def _body_cols():
    """The column tiles a job each body instantiates: the mixed body's at
    128 and at 64 registers a thread, the cluster body's."""
    wide, narrow = map(int, re.search(r"constexpr int COLS = BLOCKS == 1 \? (\d+) : (\d+);",
                                      _source("logmel_mixed.cu")).groups())
    cluster = set(map(int, re.findall(r"run_matrix_stage<TRANSPOSED, (\d+)>",
                                      _source("logmel_cluster.cu"))))
    return wide, narrow, cluster


def test_job_rule_is_the_sources():
    """Both bodies run the stage at 4 column tiles a job where a thread has
    128 registers (the cluster body always), 2 at 64; at 4, a radix of 2
    column tiles (R 17-31) takes two row tiles a job of 2 columns each."""
    wide, narrow, cluster = _body_cols()
    assert (wide, narrow, cluster) == (4, 2, {4})
    assert [_job(r, 4) for r in (17, 31, 47)] == [(2, 2), (2, 2), (1, 4)]
    assert [_job(r, 2) for r in (17, 31, 47)] == [(1, 2), (1, 2), (1, 2)]


# radix: (column tiles T, gathers of each point at 4 column tiles a job,
# at 2). The parent's jobs took 2 columns up to 4 tiles at either width: 2
# gathers a point at R = 47 and 63.
JOBS = {17: (2, 1, 1), 31: (2, 1, 1), 47: (3, 1, 2), 63: (4, 1, 2), 83: (6, 2, 3),
        127: (8, 2, 4), 149: (10, 3, 5), 373: (24, 6, 12), 1021: (64, 16, 32)}


@pytest.mark.parametrize("radix", list(JOBS))
def test_each_point_is_gathered_once_a_job(radix):
    """Each job gathers, adds and splits its row tiles' points once for all
    its columns, so a point is gathered once a job of its row tile:
    ceil(T / columns) times, with the job read from the sources (`_job`):
    once up to R = 63 at 4 columns, 6 times at R = 373."""
    t, wide, narrow = JOBS[radix]
    assert fl.matrix_tiles(radix) == t
    for cols, gathers in ((4, wide), (2, narrow)):
        rows, columns = _job(radix, cols)
        assert -(-t // columns) == gathers
        assert rows * columns == cols


def test_form_rule_reads_only_the_radix():
    """The stage's form is a function of R alone: ``wgmma_radix`` in the
    source reads its one argument and the two constants the module mirrors
    (`WGMMA_MIN_RADIX`, `WGMMA_MAX_RADIX`), `wgmma_radix` takes the radix
    alone, and ``run_matrix_stage`` picks the form by ``wgmma_radix(R)``
    before anything else (not by the body, C, the butterflies or the
    ring, whose depth the launchers choose by free shared memory)."""
    import inspect

    text = _source("logmel_stages.cuh")
    lo, hi = (int(re.search(rf"constexpr int WGMMA_{k}_RADIX = (\d+);", text).group(1))
              for k in ("MIN", "MAX"))
    assert (lo, hi) == (fl.WGMMA_MIN_RADIX, fl.WGMMA_MAX_RADIX)
    body = re.search(r"constexpr bool wgmma_radix\(int r\) \{(.*?)\}", text, re.S).group(1)
    assert set(re.findall(r"[A-Za-z_]\w*", body)) == {"return", "r", "WGMMA_MIN_RADIX",
                                                        "WGMMA_MAX_RADIX"}
    dispatch = re.search(r"void run_matrix_stage\(.*?\{\s*(if \(.*?\)) \{", text, re.S).group(1)
    assert dispatch == "if (wgmma_radix(R))"
    assert list(inspect.signature(fl.wgmma_radix).parameters) == ["radix"]
    primes = [r for r in range(15, 1022, 2) if all(r % q for q in range(3, int(r ** 0.5) + 1, 2))]
    assert [r for r in primes if fl.wgmma_radix(r)] == [r for r in primes if lo <= r <= hi]
    assert fl.matrix_tiles(hi) <= 24 and fl.wgmma_slab_bytes(hi) == 24576
    assert fl.matrix_tiles(lo) > 4    # a wgmma stage is never 8 columns of padding


@pytest.mark.parametrize("radix", list(JOBS))
def test_wgmma_form_gathers_each_point_once_a_column_group(radix):
    """In the wgmma form a warpgroup's job is 32 butterflies and a column
    group of `WGMMA_COLS` (8) tiles, each point gathered, paired and split
    once a k step for the whole group: ceil(T / 8) times a stage (3 at R =
    373, where the mma.sync form gathers it 6 times; no more often than
    that form's at any R of more than 4 tiles); the source's column tiles a
    wgmma are the module's."""
    t = fl.matrix_tiles(radix)
    cols = fl.WGMMA_COLS
    text = _source("logmel_stages.cuh")
    assert int(re.search(r"constexpr int WGMMA_COLS = (\d+);", text).group(1)) == cols == 8
    assert -(-t // cols) == (1 if t <= 8 else -(-t // 8))
    assert -(-t // cols) <= JOBS[radix][1] or t <= 4


@pytest.mark.parametrize("n_fft,frames,by", [(141001, 92, "operations"), (12895, 1025, "bytes"),
                                             (12865, 1027, "operations")])
def test_matrix_bound_is_the_least_time(n_fft, frames, by):
    """`tools/logmel_phases.py`'s bound of a matrix phase on a 132-SM card:
    the three TF32 products at 495 TFLOP/s or the bytes through shared
    memory (the points read and written once a pass, each B table once an
    SM) at 128 bytes a clock an SM at 1,980 MHz, the larger; a phase timed
    below it stops the tool."""
    from sed_crnn_torch.tools import logmel_phases as tool

    plan = fl.mixed_plan(n_fft)
    flops, nbytes, table = tool.matrix_work(plan)
    sms, rate = 132, 128 * 132 * 1.98e9
    ctas = frames * (fl.plan_cluster_size(plan) if fl.body(n_fft) == "cluster" else 1)
    want = max(flops * frames / 495e12, (nbytes * frames + table * min(sms, ctas)) / rate) * 1e3
    got = tool.matrix_report({"no_power": 50 * want, "no_matrix": 0.0}, plan, frames, sms)
    assert got["bound_ms"] == pytest.approx(want, rel=1e-12) and got["bound_by"] == by
    assert got["share_of_bound"] == pytest.approx(0.02, rel=1e-12)
    with pytest.raises(ValueError, match="below its bound"):
        tool.matrix_report({"no_power": 0.5 * want, "no_matrix": 0.0}, plan, frames, sms)


def test_moved_counts_another_checkouts_plans():
    """`tools/logmel_phases.py --moved`: a size's plan key (body, kind,
    radices, cluster size) and the count of sizes another checkout plans
    otherwise; against this tree itself none moved."""
    from pathlib import Path

    from sed_crnn_torch.tools import logmel_phases as tool

    assert tool.plan_key(fl, 141001) == ("cluster", "rader", (7, 20143), (2, 3, 3, 3, 373), (),
                                         16)
    assert tool.plan_key(fl, 2048) == ("fft",) and tool.plan_key(fl, 206_215) == ("refused",)
    root = str(Path(fl.__file__).resolve().parents[3])
    assert tool.moved(root, 206_212, 206_216, workers=1) == {
        "sizes": 4, "kind": 0, "plan": 0, "ctas": 0, "refused": 1, "refused_other": 1,
        "kind_sizes": []}


def test_ctas_sweep_needs_a_card(monkeypatch, capsys):
    """`tools/logmel_phases.py --ctas` (each cluster-body size at every
    cluster size that holds it, in turns) refuses to run without a CUDA
    card and times nothing."""
    from sed_crnn_torch.tools import logmel_phases as tool

    monkeypatch.setattr(tool.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tool, "time_ctas", lambda *a: pytest.fail("timed without a card"))
    assert tool.main(["--ctas", "--sizes", "141001"]) == 2
    assert "a CUDA card is required" in capsys.readouterr().err


def test_sass_compare_reads_each_kernel(monkeypatch, tmp_path):
    """`tools/logmel_phases.py`'s SASS comparison of two builds: each
    ``Function :`` section of ``cuobjdump -sass`` is one kernel's code,
    named without its anonymous namespace's per-build tag, compared whole
    between the two."""
    from sed_crnn_torch.tools import logmel_phases as tool

    dumps = {"a.so": "\n\tcode for sm_90a\n\t\tFunction : _GLOBAL__N__17984ac5_k1\n\tMOV R1;\n"
                     "\t\tFunction : k2\n\tFADD R2;\n",
             "b.so": "\n\tcode for sm_90a\n\t\tFunction : _GLOBAL__N__b4a3dcbb_k1\n\tMOV R1;\n"
                     "\t\tFunction : k2\n\tFMUL R2;\n\t\tFunction : k3\n\tEXIT;\n"}
    monkeypatch.setattr(tool._build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(tool.subprocess, "run", lambda cmd, **kw: types.SimpleNamespace(
        stdout=dumps[Path(cmd[-1]).name]))
    assert tool._sass(Path("a.so")) == {"_GLOBAL__N__k1": "\tMOV R1;", "k2": "\tFADD R2;"}
    assert tool._sass_compare(Path("a.so"), Path("b.so")) == {"same": ["_GLOBAL__N__k1"],
                                                              "different": ["k2", "k3"]}


TURNS = Path(__file__).parent / "data" / "logmel_plan_turns.jsonl"


def _turn_rows():
    return [json.loads(ln) for ln in TURNS.read_text().splitlines()
            if ln.startswith("{") and "turns" in ln]


def test_committed_weights_are_fit_choices():
    """`plan_cost`'s weights are what `tools/logmel_phases.py`'s `fit_choice`
    gives on 57 sizes, every plan timed in turns on an H100 (`TURNS`: the
    phase tool's 35 sizes and 22 whose plan an earlier fit moved; PERF.md
    §6): the same `--fit-from` on the CPU reproduces them."""
    from sed_crnn_torch.tools import logmel_phases as tool

    lines = [json.loads(ln) for ln in TURNS.read_text().splitlines() if ln.startswith("{")]
    rows = [ln for ln in lines if "turns" in ln]
    assert len(rows) == 57
    anchor = {k: getattr(fl, k) for k in tool.WEIGHTS}
    for ln in lines:
        anchor.update(ln.get("fit", {}))
        anchor.update(ln.get("fit_cluster", {}))
    assert tool.fit_choice(rows, anchor) == {k: getattr(fl, k) for k in tool.WEIGHTS}


@pytest.mark.parametrize("n_fft", [r["turns"] for r in _turn_rows()])
def test_plan_is_the_cheapest_of_the_timed_ones(n_fft):
    """At each of the 57 sizes, `mixed_plan` is the plan of least
    `plan_cost` under the committed weights among those the card timed
    (their `_features` as the tool recorded them), on the body each runs."""
    row = next(r for r in _turn_rows() if r["turns"] == n_fft)
    plan = fl.mixed_plan(n_fft)
    costs = {}
    for kind, (n_reg, n_mat, narrow, cluster, crossing, blue) in row["features"].items():
        c = fl.COST_REGISTER * n_reg * (fl.COST_NARROW if narrow else 1.0) + fl.COST_MATRIX * n_mat
        if cluster:
            c = (c + (fl.COST_CROSS_BLUESTEIN if blue else fl.COST_CROSS) * crossing) * \
                fl.COST_CLUSTER
        costs[kind] = c
    best = row["plans"][min(costs, key=costs.get)]
    assert [tuple(best[0]), tuple(best[1]), tuple(best[2]), best[3]] == [
        plan.radices, plan.rader, plan.nested, plan.bluestein]
    assert fl._plan_cost_on_body(plan) == pytest.approx(min(costs.values()), rel=1e-9)


def test_141001_keeps_a_plan_and_206215_is_the_first_refused():
    """The largest loss to the library, 141,001 (L 7 x 20,143), keeps its
    Rader stage over 2 x 3 x 3 x 3 x 373 (373 on wgmma) on 16 CTAs, which
    hold its double B ring (11 are the fewest that hold one slab, 13 two),
    every inner stage crossing CTAs; 206,215 is still the first n_fft
    beyond the cluster body's limit."""
    plan = fl.mixed_plan(141001)
    assert (plan.radices, plan.rader, fl.body(141001)) == ((7, 20143), (2, 3, 3, 3, 373),
                                                           "cluster")
    assert fl.wgmma_radix(373) and fl.ring_bytes(plan, 2) == 256 + 2 * 24576
    sp = fl.cluster_split(141001, fl.cluster_size(141001))
    assert sp.ctas == 16 and sp.ring == 2 * 24576 and all(sp.rader_cross)
    assert [fl.cluster_split(141001, c).ring for c in (12, 13)] == [24576, 2 * 24576]
    assert fl._cluster_bytes(plan, 10) > fl.MIXED_MAX_SMEM >= fl._cluster_bytes(plan, 11)
    assert fl.cluster_split(141001, 11).ring == 24576
    assert all(fl.cluster_size(n) <= fl.CLUSTER_MAX for n in range(206_200, 206_215))
    with pytest.raises(ValueError, match="beyond the cluster body's limit"):
        fl.cluster_size(206_215)


@pytest.mark.parametrize("n_fft,kind,ctas,slabs", [
    (141001, None, 16, 2), (168709, None, 16, 1), (181651, None, 16, 1), (194090, None, 16, 2),
    (28367, None, 3, 2), (182146, None, 8, 2), (746, "direct", 0, 2),
    (4478, "rader", 0, 2), (12865, None, 0, 0), (206213, None, 16, 0)])
def test_shared_memory_counts_the_b_ring(n_fft, kind, ctas, slabs):
    """A block's shared memory holds its wgmma stages' B ring in the power
    row's place (256 bytes of alignment, then two slabs of the largest
    stage's k step where they fit beside the work arrays, else one:
    `ring_plan`); `cluster_size` gives a plan with a wgmma stage the fewest
    CTAs that hold it up to 8 (28,367: 3, 182,146: 8), else 16 (141,001;
    194,090, which 9 would hold; 168,709 and 181,651 with one slab: 373
    inside a Rader stage), any other plan the fewest CTAs that hold it; a
    plan with no
    wgmma stage takes no ring
    (12865: 31 and 83 on mma.sync; 206213: 89 and 331); every n_fft up to
    206,214 still has a plan, 206,215 none."""
    plan = fl.mixed_plan(n_fft, kind)
    slab = max((fl.wgmma_slab_bytes(r) for r in plan.matrix + plan.rader_matrix
                if fl.wgmma_radix(r)), default=0)
    arrays = 16 * (plan.n if not ctas else fl.cluster_split(n_fft, ctas, kind).chunk)
    assert fl.ring_plan(plan, arrays) == slabs * slab
    assert fl.ring_bytes(plan, slabs) == (256 + slabs * slab if slab else 0)
    if not ctas:
        assert plan.smem_bytes == arrays + max(4 * (n_fft // 2 + 1), fl.ring_bytes(plan, 1))
        assert plan.smem_bytes <= fl.MIXED_MAX_SMEM
        return
    assert fl.cluster_size(n_fft) == ctas
    sp = fl.cluster_split(n_fft, ctas)
    assert sp.ring == slabs * slab and sp.smem_bytes <= fl.MIXED_MAX_SMEM
    assert sp.smem_bytes == arrays + max(4 * sp.bin_chunk, 256 + slabs * slab)
    assert all(fl._cluster_bytes(plan, c) > fl.MIXED_MAX_SMEM for c in range(2, min(ctas, 9)))
    if slab:
        assert fl.WGMMA_CLUSTERS == (2, 3, 4, 5, 6, 7, 8, 16) and ctas in fl.WGMMA_CLUSTERS
    else:
        assert all(fl._cluster_bytes(plan, c) > fl.MIXED_MAX_SMEM for c in range(2, ctas))
    assert all(fl.cluster_size(n) <= fl.CLUSTER_MAX for n in range(206_200, 206_215))
    with pytest.raises(ValueError, match="beyond the cluster body's limit"):
        fl.cluster_size(206_215)


@pytest.mark.parametrize("log_floor", [None, 1e-10])
@pytest.mark.parametrize("center", [True, False])
def test_matrix_plan_plain_against_jax_extract(center, log_floor):
    """n_fft 12,865 (L 5 x 31 x 83: two matrix stages in one block) through
    `mixed_log_mel_plain` against the JAX package's `extract` (fft backend):
    within 3.9e-6 in the log domain, -inf entries equal."""
    kw = dict(n_fft=12865, hop_length=6432, center=center, log_floor=log_floor)
    cfg = FrontendConfig(**kw)
    assert fl.mixed_plan(12865).matrix == (31, 83)
    n = 4 * cfg.n_fft + (0 if center else cfg.n_fft)
    rng = np.random.default_rng(17)
    t = np.arange(n) / cfg.sample_rate
    y = (0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    y[n // 4: 3 * n // 4] = 0.0
    got = fl.mixed_log_mel_plain(torch.from_numpy(y), cfg).numpy().astype(np.float64)
    want = np.asarray(jax_frontend.extract(y, JaxFrontendConfig(**kw), bucket_seconds=0),
                      np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    assert np.abs(got[fin] - want[fin]).max() <= 3.9e-6
    assert np.isneginf(got).any() == (log_floor is None)
    assert math.isfinite(float(np.abs(got[fin]).max()))
