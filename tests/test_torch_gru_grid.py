"""Kernel B's grid tier (``csrc/gru_grid.cu``, H > CLUSTER_MAX_H) on the CPU:
the tier rule, the Python mirror of the launcher's plan (`grid_plan`: K
CTAs a direction, the units a CTA, the body and rows a pass, a CTA's shared
memory, resident or streamed weights), the source's build rules, the order
of its sums emulated in float32, and the port's BiGRU, pair functions and a
narrowed sednet-dcase at grid widths (the plain versions the CPU runs)
against the JAX package's `BiGRU.apply` on its interpreted Pallas
`gru_scan`.

Small shapes (T=12, B=3), weights scaled by 1/sqrt(fan-in). Tolerance 1e-5
absolute for the GRU, as in tests/test_torch_gru_wide.py: float32 on both
sides, the same per-step arithmetic up to reassociation in the products and
the batch sums. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py [kernel B wide]).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.nn.gru import BiGRU as JaxBiGRU
from sed_crnn_tpu.nn.layers import Ctx
from sed_crnn_tpu.ops import losses as jax_losses
from sed_crnn_tpu.ops.pallas import gru_scan as jax_gru_scan

from sed_crnn_torch.models.convert import to_jax
from sed_crnn_torch.nn.gru import BiGRU
from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.kernels.gru_scan import (
    CLUSTER_MAX_H,
    GRID_COUNTER_FLOATS,
    GRID_KC,
    GRID_LANES_MAX_B,
    GRID_MAX_SMEM,
    GRID_MAX_STAGES,
    GRID_PLAN_KEYS,
    GRID_RESIDENT_MAX_H,
    GRID_SLABS,
    GRID_SMS,
    GRID_THREADS,
    GRID_TILE_UNITS,
    GRID_UNITS_MAX,
    GRID_UNITS_MIN,
    grid_geometry,
    grid_plan,
    grid_scratch_floats,
    gru_body,
    gru_scan_pair,
    gru_scan_pair_bwd,
    gru_scan_pair_fwd_res,
)
from sed_crnn_torch.ops.losses import make_loss
from tests.test_torch_model import narrowed, port_model, seeded_tree

ATOL = 1e-5
B, T, IN = 3, 12, 10
DIRS = ("fwd", "bwd")
WIDTHS = [520, 1024]
PLAN_WIDTHS = [513, 520, 768, 1000, 1024, 1025, 1536, 2048, 4096, 8448, 8449, 16896, 16897,
               33793, 40000]
CASES = [(False, "hard_sigmoid", True), (True, "sigmoid", False)]


@pytest.mark.parametrize("H_", [CLUSTER_MAX_H + 1, 520, 1024, 2048, 4096])
def test_tier_rule(H_):
    assert gru_body(H_) == "grid"
    assert gru_body(H_, backward=True) == "grid"


@pytest.mark.parametrize("H", PLAN_WIDTHS)
@pytest.mark.parametrize("n_dir", [1, 2])
@pytest.mark.parametrize("backward", [False, True])
def test_the_plan_fits_a_cta_and_the_card(H, n_dir, backward):
    """Every plan fits a CTA's 232,448 bytes, its K CTAs a direction fit
    the card's SMs, every unit lies on one CTA, a CTA's units fit one block
    of UP or, where 256 units a CTA do not cover H, several blocks of 256 on
    every SM of the direction, streamed; the rows a pass are the body's row
    groups times the rows a thread."""
    for B_ in (1, 3, 8, 16, 17, 100, 128, 1000):
        p = grid_plan(n_dir, 1, B_, H, backward)
        assert set(p) == set(GRID_PLAN_KEYS)
        assert p["smem"] <= GRID_MAX_SMEM and p["threads"] == GRID_THREADS
        assert n_dir * p["ctas"] <= GRID_SMS
        K, U, UP = p["ctas"], p["units"], p["units_padded"]
        assert U == -(-H // K) and (K - 1) * U < H
        assert U <= UP or (UP == GRID_UNITS_MAX and K == GRID_SMS // n_dir
                           and not p["resident"])
        assert GRID_UNITS_MIN <= UP <= GRID_UNITS_MAX and UP & (UP - 1) == 0
        assert UP == GRID_UNITS_MIN or -(-H // (UP // 2)) > GRID_SMS // n_dir   # the fewest
        if p["split"] == GRID_SLABS:      # lanes body: resident, one unit a group
            assert B_ <= GRID_LANES_MAX_B and p["resident"] and UP <= 32
            assert p["rows"] == p["row_block"] * (32 // UP) and p["stages"] == 0
        else:
            assert p["split"] == 1 and p["stages"] in (2, 3)
            assert p["rows"] == p["row_block"] * GRID_THREADS // (UP // GRID_TILE_UNITS)
            assert p["row_block"] == 1 or B_ > p["rows"] // 2


def test_the_resident_streamed_boundary():
    """A pair keeps its weights resident to H = 1056 on 132 SMs: 66 CTAs of
    16 units, 48 vectors of 1,060 floats (203,520 bytes) beside the
    backward's smallest ring (two stages of 3 x 32 rows x 20 floats, 15,360
    bytes); from 1057 a CTA holds 32 units, streamed. At 1024 the forward's
    4 rows a thread (a pass of 128 rows, three stages) fit beside the
    weights, the backward's 2 rows (64 rows, two stages)."""
    assert GRID_RESIDENT_MAX_H == 1056
    for backward in (False, True):
        for B_ in (1, 8, 128):
            assert grid_plan(2, 1, B_, 1024, backward)["resident"]
            assert grid_plan(2, 1, B_, 1056, backward)["resident"]
        assert not grid_plan(2, 1, 128, 2048, backward)["resident"]
        assert not grid_plan(2, 1, 1, 1536, backward)["resident"]
        assert not grid_plan(2, 1, 17, 1057, backward)["resident"]
    assert grid_plan(2, 1, 128, 1056, True)["smem"] == 203520 + 3 * 7680
    assert grid_plan(2, 1, 128, 1024, False)["smem"] == 197376 + 30720
    assert grid_plan(2, 1, 128, 1024, True)["smem"] == 197376 + 30720
    assert grid_geometry(1025) == (1056, 132, 140) and grid_geometry(1024) == (1024, 128, 132)
    assert grid_plan(2, 1, 128, 1024, False)["ctas"] == 64
    assert grid_plan(2, 1, 128, 520, False)["ctas"] == 65
    assert grid_plan(1, 1, 128, 2112, False)["ctas"] == 132   # one direction: 16 units a CTA


@pytest.mark.parametrize("n_dir,widest", [(2, 16896), (1, 33792)])
def test_the_widest_width_and_the_first_refused(n_dir, widest):
    """A CTA lays out at most GRID_UNITS_MAX = 256 units: on 132 SMs a pair
    (66 CTAs a direction) holds H to 66 x 256 = 16,896 in one block a CTA
    and one direction (132 CTAs) to 33,792, streamed. One unit wider is no
    longer refused: the same CTAs walk 257 units each in two blocks of 256,
    on the same plan otherwise, so no width is refused by the plan and what
    bounds it is the card's memory (a pair at H = 40,000 holds 38.4 GB of
    wh, as much of dwh's partials and as much of dwh: beyond an 80 GB card).
    From 8,449 a pair's CTAs hold 256."""
    for backward in (False, True):
        for B_ in (1, 128):
            p = grid_plan(n_dir, 1, B_, widest, backward)
            assert (p["ctas"], p["units_padded"], p["split"]) == (132 // n_dir, 256, 1)
            assert not p["resident"] and p["smem"] <= GRID_MAX_SMEM
            q = grid_plan(n_dir, 1, B_, widest + 1, backward)
            assert (q["ctas"], q["units"], q["units_padded"]) == (132 // n_dir, 257, 256)
            assert {k: v for k, v in q.items() if k != "units"} == {
                k: v for k, v in p.items() if k != "units"}
            far = grid_plan(n_dir, 1, B_, 40000, backward)
            assert far["units"] == -(-40000 // (132 // n_dir)) and far["smem"] == p["smem"]
    assert 3 * (2 * 3 * 40000 ** 2 * 4) > 80e9
    assert grid_plan(2, 1, 1, 8448, False)["units_padded"] == 128
    assert grid_plan(2, 1, 1, 8449, False)["units_padded"] == 256


def test_the_bodies_by_batch_at_1024():
    """B <= 16 on the lanes body (eight lanes a unit, one slab each), the
    tile body above; K = 64 of 16 units whatever B; forced K moves UP."""
    lanes = grid_plan(2, 1, 1, 1024, False)
    assert (lanes["split"], lanes["rows"], lanes["smem"]) == (8, 2, 212000)
    tile = grid_plan(2, 1, 128, 1024, False)
    assert (tile["split"], tile["row_block"], tile["rows"], tile["stages"]) == (1, 4, 128, 3)
    chain = grid_plan(2, 1, 128, 1024, True)
    assert (chain["split"], chain["row_block"], chain["rows"], chain["stages"]) == (1, 2, 64, 2)
    assert grid_plan(2, 1, 17, 1024, False)["split"] == 1
    forced = grid_plan(2, 1, 1, 1024, False, ctas=40)
    assert (forced["ctas"], forced["units"], forced["units_padded"]) == (40, 26, 32)
    assert not forced["resident"] and forced["split"] == 1


def test_scratch_holds_the_exchanged_rows():
    assert grid_scratch_floats(2, 128, 1024, False) == GRID_COUNTER_FLOATS + 2 * (
        3 * 128 * 1024 + 2 * 128 * 1024)
    assert grid_scratch_floats(1, 3, 520, True) == GRID_COUNTER_FLOATS + (
        -(-(6 * 3 * 544 + 4 * 3 * 520) // 32) * 32)


def _fma(acc, a, b):
    """float32 fused multiply-add, emulated: the product of two float32 is
    exact in float64 and the sum is rounded once more to float32."""
    return np.float32(np.float64(acc) + np.float64(a) * np.float64(b))


def _slab_partials(h, w, H):
    HP, HS, _ = grid_geometry(H)
    hp, wp = np.zeros(HP, np.float32), np.zeros(HP, np.float32)
    hp[:H], wp[:H] = h, w
    parts = []
    for s in range(GRID_SLABS):
        acc = np.float32(0)
        for k in range(s * HS, (s + 1) * HS):
            acc = _fma(acc, hp[k], wp[k])
        parts.append(acc)
    return parts, hp, wp


def _lanes_sum(h, w, H):
    """The lanes body: lane s sums slab s alone, then each lane adds the
    eight partials in slab order by shuffles."""
    parts, _, _ = _slab_partials(h, w, H)
    total = parts[0]
    for p in parts[1:]:
        total = np.float32(total + p)
    return total


def _tile_sum(h, w, H):
    """The tile body: one thread walks k in chunks of KC through the ring,
    flushing its partial into the total at each slab end."""
    HP, HS, _ = grid_geometry(H)
    _, hp, wp = _slab_partials(h, w, H)
    total, part, slab, slab_end = np.float32(0), np.float32(0), 0, HS
    for ch in range(HP // GRID_KC):
        for q in range(GRID_KC // 4):
            k = ch * GRID_KC + 4 * q
            if k == slab_end:
                total = part if slab == 0 else np.float32(total + part)
                part, slab, slab_end = np.float32(0), slab + 1, slab_end + HS
            for c in range(4):
                part = _fma(part, hp[k + c], wp[k + c])
    return np.float32(total + part)


@pytest.mark.parametrize("H", [520, 1000])
def test_the_order_of_sums_depends_on_h_only(H):
    """Both bodies add the same eight slab chains in the same order, so a
    row's sums are the same bits on either body, whatever the plan puts
    beside them: K (which CTA holds a unit), the rows a pass, B, S, resident
    or streamed weights (the same values in another buffer); and within
    float32 rounding of the float64 dot product."""
    rng = np.random.default_rng(H)
    rows = rng.standard_normal((3, H)).astype(np.float32)
    w = (rng.standard_normal(H) / np.sqrt(H)).astype(np.float32)
    for row in rows:
        tile, lanes = _tile_sum(row, w, H), _lanes_sum(row, w, H)
        assert tile == lanes
        assert abs(float(tile) - float(row.astype(np.float64) @ w.astype(np.float64))) <= 1e-5
    plans = {(p["split"], p["ctas"], p["rows"], p["resident"])
             for p in (grid_plan(n, 1, b, H, bwd, ctas=k) for n in (1, 2) for b in (1, 8, 128)
                       for bwd in (False, True) for k in (0, 33, 66))}
    assert {s for s, *_ in plans} == {1, GRID_SLABS} and len(plans) > 4


def test_grid_source_is_built_and_calls_no_library():
    """csrc/gru_grid.cu is one of the built sources, for sm_90a, calls no
    cuDNN, cuBLAS, CUTLASS or other finished kernel and uses no tensor
    cores; it launches cooperatively; its constants are the Python mirror's."""
    assert "gru_grid" in _build.KERNEL_SOURCES
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = (_build.CSRC_DIR / "gru_grid.cu").read_text()
    includes = sorted(ln.split()[1] for ln in src.splitlines() if ln.startswith("#include"))
    assert includes == ["<cuda_runtime.h>", "<initializer_list>", "<math.h>", "<mutex>",
                        "<vector>"]
    for word in ("cudnn", "cublas", "cutlass", "matmul", "wgmma", "mma.sync"):
        assert word not in src.lower()
    for name, value in (("THREADS", GRID_THREADS), ("SLABS", GRID_SLABS), ("KC", GRID_KC),
                        ("LANES_MAX_B", GRID_LANES_MAX_B), ("MAX_SMEM", GRID_MAX_SMEM),
                        ("UP_MIN", GRID_UNITS_MIN), ("UP_MAX", GRID_UNITS_MAX),
                        ("COUNTER_FLOATS", GRID_COUNTER_FLOATS),
                        ("TILE_UNITS", GRID_TILE_UNITS), ("MAX_STAGES", GRID_MAX_STAGES)):
        assert f"constexpr int {name} = {value};" in src
    # The profiling cuts are the only build-time switch, off by default.
    assert "#define GRU_GRID_CUT 0\n" in src
    assert [ln.split()[1] for ln in src.splitlines() if ln.startswith("#define")] == [
        "GRU_GRID_CUT", "PICK(field)"]
    assert "cudaLaunchCooperativeKernel(" in src and "gru_grid_plan" in src


def test_the_wide_body_keeps_no_l2_tier():
    """The wide body's L2 tier is gone: its launchers refuse H > 128."""
    src = (_build.CSRC_DIR / "gru_wide.cu").read_text()
    for name in ("gru_wide_fwd_l2", "gru_wide_bwd_l2", "dot_l2", "l2_threads",
                 "gru_wide_scratch_floats", "L2_THREADS"):
        assert name not in src
    assert src.count("H > REG_MAX_H") == 2


def _weights(rng, H, reset_after):
    p = {"wi": rng.standard_normal((IN, 3 * H)) / np.sqrt(IN),
         "wh": rng.standard_normal((H, 3 * H)) / np.sqrt(H),
         "bi": 0.1 * rng.standard_normal(3 * H)}
    if reset_after:
        p["bh"] = 0.1 * rng.standard_normal(3 * H)
    return {k: v.astype(np.float32) for k, v in p.items()}


def test_jax_reference_runs_its_pallas_kernel_at_these_shapes():
    for H in WIDTHS:
        for reset_after in (False, True):
            assert jax_gru_scan.fits_vmem(T, B, H, reset_after)


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("reset_after,gate,carry", CASES)
def test_grid_bigru_matches_jax_outputs_states_and_gradients(H, reset_after, gate, carry):
    rng = np.random.default_rng(3000 + H)
    p = {d: _weights(rng, H, reset_after) for d in DIRS}
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    h0 = {d: (0.5 * rng.standard_normal((B, H))).astype(np.float32) for d in DIRS}
    g_out = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    g_h = {d: rng.standard_normal((B, H)).astype(np.float32) for d in DIRS}
    jax_bigru = JaxBiGRU(IN, H, reset_after, gate, backend="pallas")

    def loss(params, x, h0):
        out, hl = jax_bigru.apply(params, x, h0)
        return jnp.sum(out * g_out) + sum(jnp.sum(hl[d] * g_h[d]) for d in DIRS)

    args = (jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
            {d: jnp.asarray(v) for d, v in h0.items()} if carry else None)
    want_out, want_h = jax_bigru.apply(*args)
    want_g = jax.grad(loss, argnums=(0, 1, 2) if carry else (0, 1))(*args)

    m = BiGRU(IN, H, reset_after, gate)
    m.load_state_dict({f"{d}.{k}": torch.from_numpy(v) for d in p for k, v in p[d].items()})
    xt = torch.from_numpy(x).requires_grad_()
    h0t = {d: torch.from_numpy(v).requires_grad_() for d, v in h0.items()} if carry else None
    out, hl = m(xt, h0t)
    assert "GruScanPairFn" in type(out.grad_fn.next_functions[0][0]).__name__
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=ATOL)
    for d in DIRS:
        np.testing.assert_allclose(hl[d].detach().numpy(), np.asarray(want_h[d]), atol=ATOL)
    total = (out * torch.from_numpy(g_out)).sum() + sum(
        (hl[d] * torch.from_numpy(g_h[d])).sum() for d in DIRS)
    names = [f"{d}.{k}" for d in DIRS for k in p[d]]
    leaves = [dict(m.named_parameters())[n] for n in names] + [xt]
    leaves += [h0t[d] for d in DIRS] if carry else []
    got = dict(zip(names + ["x"] + [f"h0.{d}" for d in DIRS], torch.autograd.grad(total, leaves)))
    for n in names:
        d, k = n.split(".")
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want_g[0][d][k]), atol=ATOL,
                                   err_msg=n)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want_g[1]), atol=ATOL)
    if carry:
        for d in DIRS:
            np.testing.assert_allclose(got[f"h0.{d}"].numpy(), np.asarray(want_g[2][d]),
                                       atol=ATOL)


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("reset_after", [False, True])
def test_grid_pair_functions_match_jax_kernel_per_direction(H, reset_after):
    """The pair entry points on pre-projected inputs against the JAX Pallas
    `gru_scan` (forward) and its VJP (backward) of each direction."""
    rng = np.random.default_rng(4000 + H)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    xp = [f32(rng.standard_normal((B, T, 3 * H))) for _ in DIRS]
    wh = [f32(rng.standard_normal((H, 3 * H)) / np.sqrt(H)) for _ in DIRS]
    bh = [f32(0.1 * rng.standard_normal(3 * H)) if reset_after else None for _ in DIRS]
    h0 = [f32(0.5 * rng.standard_normal((B, H))) for _ in DIRS]
    dys = [f32(rng.standard_normal((B, T, H))) for _ in DIRS]
    dhl = [f32(rng.standard_normal((B, H))) for _ in DIRS]
    t = lambda arrs: tuple(None if a is None else torch.from_numpy(a) for a in arrs)  # noqa: E731

    fwd = gru_scan_pair(t(xp), t(wh), t(bh), t(h0), reset_after, "sigmoid")
    res = gru_scan_pair_fwd_res(t(xp), t(wh), t(bh), t(h0), reset_after, "sigmoid")
    grads = gru_scan_pair_bwd(tuple(r[0] for r in res), tuple(r[1] for r in res), t(wh), t(h0),
                              t(dys), t(dhl), reset_after, "sigmoid")
    for k, rev in enumerate((False, True)):
        def run(xp_, wh_, bh_, h0_):
            return jax_gru_scan.gru_scan(xp_, wh_, bh_, h0_, reset_after=reset_after,
                                         gate_activation="sigmoid", reverse=rev)

        (ys, hl), vjp = jax.vjp(run, xp[k], wh[k], bh[k] if reset_after else None, h0[k])
        for got in (fwd[k], (res[k][0], res[k][2])):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(ys), atol=ATOL)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(hl), atol=ATOL)
        dxp, dwh, dbh, dh0 = vjp((jnp.asarray(dys[k]), jnp.asarray(dhl[k])))
        for name, g, w in (("dxp", grads[k][0], dxp), ("dwh", grads[k][1], dwh),
                           ("dh0", grads[k][3], dh0)) + ((("dbh", grads[k][2], dbh),)
                                                         if reset_after else ()):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("H", WIDTHS)
def test_narrowed_sednet_at_grid_widths_matches_jax(H):
    """sednet-dcase narrowed (convolutions of 8 channels, 12 frames) at
    gru_hidden=(H, H), the JAX side on its interpreted Pallas GRU: eval
    logits within 1e-5 of their largest magnitude, and in train mode
    (dropout 0) the loss within 1e-5 relative and every gradient leaf within
    1e-4 of its largest (the bands of tests/test_torch_gru_wide.py's stacked
    model)."""
    jc, tc = narrowed("sednet-dcase", dropout=0.0, seq_len_in=T)
    jc = jc.replace(model=dataclasses.replace(jc.model, gru_backend="pallas", gru_hidden=(H, H)))
    tc = tc.replace(model=dataclasses.replace(tc.model, gru_hidden=(H, H)))
    jm = jax_get_model(jc.model)
    params, state = seeded_tree(jm, 50 + H)
    for i, gru in enumerate(params["gru"]):     # 1 / sqrt(fan-in), as the other GRU tests
        for d in DIRS:
            for k in ("wi", "wh"):
                gru[d][k] = gru[d][k] / 0.3 / np.sqrt(gru[d][k].shape[0])
    model = port_model(tc, params, state)
    rng = np.random.default_rng(51)
    x = rng.standard_normal((2, T, jc.model.n_mels)).astype(np.float32)
    y = (rng.random((2, jm.seq_len_out, jc.model.n_classes)) > 0.7).astype(np.float32)
    want = np.asarray(jm.apply(params, state, x, Ctx(train=False))[0])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))

    jloss = jax_losses.make_loss(jc.train.loss)

    def objective(p):
        logits, _, _ = jm.apply(p, state, jnp.asarray(x), Ctx(train=True))
        return jloss(logits, jnp.asarray(y))

    want_loss, want_grads = jax.value_and_grad(objective)(params)
    model.train()
    loss = make_loss(tc.train.loss)(model(torch.from_numpy(x))[0], torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got_g, _ = to_jax({k: p.grad for k, p in model.named_parameters()}, tc.model)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_grads),
                            jax.tree_util.tree_leaves(got_g)):
        if "conv" in str(path) and path[-1].key == "b":
            continue   # a bias ahead of train-mode BatchNorm: its gradient is 0 (noise)
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(np.asarray(g) - np.asarray(w)).max()) <= 1e-4 * scale, path
