"""GRU recurrence: the CUDA kernels (``csrc/gru_warp.cu``,
``csrc/gru_wide.cu``, ``csrc/gru_cluster.cu`` and ``csrc/gru_grid.cu``),
their plain PyTorch versions, and the `torch.autograd.Function`s that join
them.

The counterpart of the JAX package's `ops/pallas/gru_scan.py`, with its
batch-major contract: ``xp (B, T, 3H)`` pre-projected inputs
(``x @ wi + bi``), ``wh (H, 3H)`` in gate order (reset, update, candidate),
``bh (3H,)`` read only when ``reset_after``, ``h0 (B, H)`` -> ``ys (B, T, H)``,
``h_last (B, H)``. Both ``reset_after`` conventions, ``sigmoid`` and
keras-2.2 ``hard_sigmoid`` gates, and reverse time.

Four CUDA bodies, chosen by `gru_body` from the hidden width H, forward and
backward alike; every H >= 1 has one of them and runs on it, as far as the
card's memory holds the operands:

* ``"warp"`` (``csrc/gru_warp.cu``), H <= 32 (every preset): one warp per
  batch row (or 32 / HP rows, HP = H rounded up to a power of two), the
  recurrent weights in registers;
* ``"wide"`` (``csrc/gru_wide.cu``), 32 < H <= 128: four lanes per hidden
  unit, each holding a quarter of the unit's weights in registers, R batch
  rows a block;
* ``"cluster"`` (``csrc/gru_cluster.cu``), 128 < H <= `CLUSTER_MAX_H` (512):
  the recurrent weights resident in the shared memory of a thread-block
  cluster of `cluster_ctas` (H) CTAs, each CTA holding its units' part, R
  batch rows a cluster, the new state exchanged through distributed shared
  memory each step;
* ``"grid"`` (``csrc/gru_grid.cu``), H > `CLUSTER_MAX_H`: one persistent
  cooperative grid, K CTAs a direction (`grid_plan`), each holding its
  units' part of wh in shared memory (resident to `GRID_RESIDENT_MAX_H`,
  1056, for a pair, streamed each step above), the new state exchanged
  through device memory (L2) behind a barrier of the direction's CTAs each
  step. A CTA lays out at most `GRID_UNITS_MAX` (256) units at once; a
  wider share (a pair above H = 16,896 on 132 SMs, one direction above
  33,792) is walked in blocks of 256 units, streamed.

All run one or two directions (and S seeds) per launch, and reduce the
backward's ``dwh``/``dbh`` after the gradient chain by a separate kernel over
the stored rows, summed in a fixed order (`gru_dwh_plain` is its reference):
the warp body its own, every other body ``csrc/gru_dwh.cu``, a split-K
product on the tensor cores in 3xTF32 (`dwh_split_plan`; `gru_dwh_3xtf32`
repeats its arithmetic for the tests).

Entry points, each of which launches a kernel for a CUDA tensor, runs its
plain version only for a CPU tensor, and counts its launches:

* `gru_scan` / `gru_scan_pair`: the forward of one direction / of both
  directions of a BiGRU (``_fwd_kernel``, ``with_res=False``); with grad
  enabled and an input that requires grad they go through `GruScanFn` /
  `GruScanPairFn` instead. Counted in ``gru_scan.launches``.
* `gru_scan_fwd_res` / `gru_scan_pair_fwd_res`: the forward that also stores
  the gates of every step, ``res (B, T, 3H)`` = r | z | n, or ``(B, T, 4H)``
  with the projected candidate hn appended when ``reset_after``
  (``_fwd_kernel``, ``with_res=True``). Counted in
  ``gru_scan_fwd_res.launches``.
* `gru_scan_bwd` / `gru_scan_pair_bwd`: the reverse-time gradient recurrence
  (``_bwd_kernel``) over the stored residuals -> ``dxp, dwh, dbh, dh0``.
  The chain is counted in ``gru_scan_bwd.launches``, the ``dwh``/``dbh``
  reduction in ``gru_scan_bwd.dwh_launches`` (those of ``csrc/gru_dwh.cu``
  among them also in ``gru_scan_bwd.mma_dwh_launches``) and the fixed-order
  sum of its partials in ``gru_scan_bwd.sum_launches``. ``dbh`` is zero when
  ``reset_after`` is False, as the JAX wrapper sets it.

A pair is one launch of each kernel; ``direction 0`` runs forward in time
and ``direction 1`` reversed, as `nn/gru.py`'s BiGRU needs.

`gru_scan_stack`, `gru_scan_stack_fwd_res`, `gru_scan_stack_bwd` and
`GruScanStackFn` are the pair's entry points for S independent BiGRUs of one
shape (stacked multi-seed training, `models/stacked.py`): every operand of a
direction carries a leading seed axis, ``xp (S, B, T, 3H)``, ``wh (S, H,
3H)``, ``bh (S, 3H)``, ``h0 (S, B, H)``, and so does every result. Each
kernel launches once per call for all S seeds x 2 directions, counted in the
counters above. A CPU tensor runs the plain versions seed by seed.
``gru_scan.wide_launches``, ``gru_scan.cluster_launches`` and
``gru_scan.grid_launches`` count the launches of the wide, cluster and grid
bodies' recurrences (forward, residual forward, backward chain) among all of
the above. The kernels stream every per-step array, so any T and B are
taken.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from sed_crnn_torch.ops.kernels import _build

GATES = ("sigmoid", "hard_sigmoid")
WARP_MAX_HIDDEN = 32  # the warp body: lane j owns hidden unit j
REGISTER_MAX_HIDDEN = 128  # the wide body's register tier
BODIES = ("warp", "wide", "cluster", "grid")

# The cluster body's plan, as csrc/gru_cluster.cu computes it (the card's
# library reports the same numbers: `gru_cluster_ctas`, `_smem_bytes`,
# `_max_h`). A group of CLUSTER_KQ lanes owns CLUSTER_UNITS_PER_GROUP
# hidden units of a CTA; a CTA's shared memory holds its units' weights (3,
# UP, HP + 4), the state rows and a staging ring of CLUSTER_STAGES steps.
CLUSTER_KQ = 16
CLUSTER_UNITS_PER_GROUP = 2
CLUSTER_STAGES = 4
CLUSTER_MAX_THREADS = 256
CLUSTER_MAX_SMEM = 232448          # 227 KB, a CTA's opt-in limit on Hopper
CLUSTER_MAX_CTAS = 16              # the non-portable cluster limit
CLUSTER_WEIGHT_BYTES = 104000      # the rule's weight slice a CTA
CLUSTER_ROWS = (1, 2, 4, 8, 16, 32)

Pair = Tuple[torch.Tensor, torch.Tensor]


def hard_sigmoid(v: torch.Tensor) -> torch.Tensor:
    """keras-2.2 ``clip(0.2 v + 0.5, 0, 1)`` (not torch's relu6(v + 3) / 6)."""
    return torch.clamp(0.2 * v + 0.5, 0.0, 1.0)


def gate_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "sigmoid":
        return torch.sigmoid
    if name == "hard_sigmoid":
        return hard_sigmoid
    raise ValueError(f"unknown gate_activation {name!r}")


def gate_grad_from_output(name: str, g: torch.Tensor) -> torch.Tensor:
    """d gate / d pre-activation, from the gate's output value."""
    if name == "sigmoid":
        return g * (1.0 - g)
    if name == "hard_sigmoid":
        return 0.2 * ((g > 0.0) & (g < 1.0)).to(g.dtype)
    raise ValueError(f"unknown gate_activation {name!r}")


def res_width(reset_after: bool, H: int) -> int:
    """Width of a residual row: r | z | n, plus hn when ``reset_after``."""
    return 4 * H if reset_after else 3 * H


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def cluster_geometry(H: int, ctas: int) -> Tuple[int, int, int, int]:
    """A CTA's share of width H on ``ctas`` CTAs: ``(U, UP, HP, WS)``, its
    units, units rounded up to whole warps, the padded state row and the
    padded weight row (floats)."""
    U = -(-H // ctas)
    HP = _round_up(H, 4 * CLUSTER_KQ)
    return U, _round_up(U, 32 // CLUSTER_KQ * CLUSTER_UNITS_PER_GROUP), HP, HP + 4


def cluster_threads(H: int, ctas: int) -> int:
    """Threads a CTA: CLUSTER_KQ lanes for each group of units."""
    return cluster_geometry(H, ctas)[1] // CLUSTER_UNITS_PER_GROUP * CLUSTER_KQ


def cluster_smem_bytes(H: int, ctas: int, rows: int, backward: bool) -> int:
    """Shared memory of a CTA of the cluster body: forward weights, state
    rows (double-buffered), r h rows, the staged xp; backward weights, gate
    gradients (double-buffered), the staged h_prev, r, z, n, hn, dys and the
    lanes' carries."""
    _, UP, HP, WS = cluster_geometry(H, ctas)
    w = 3 * UP * WS
    if not backward:
        floats = w + 3 * rows * HP + CLUSTER_STAGES * rows * 3 * UP
    else:
        floats = w + 6 * rows * HP + CLUSTER_STAGES * rows * 6 * UP + 4 * rows * UP
    return 4 * floats


def cluster_ctas(H: int) -> int:
    """The cluster size at width H, a function of H alone: the fewest CTAs,
    a power of two, whose weight slice fits CLUSTER_WEIGHT_BYTES with at
    most CLUSTER_MAX_THREADS threads; else CLUSTER_MAX_CTAS."""
    C = 2
    while C <= CLUSTER_MAX_CTAS:
        _, UP, _, WS = cluster_geometry(H, C)
        if (cluster_threads(H, C) <= CLUSTER_MAX_THREADS
                and 12 * UP * WS <= CLUSTER_WEIGHT_BYTES):
            return C
        C *= 2
    return CLUSTER_MAX_CTAS


def cluster_fits(H: int, ctas: int, rows: int, backward: bool) -> bool:
    return (cluster_threads(H, ctas) <= CLUSTER_MAX_THREADS
            and cluster_smem_bytes(H, ctas, rows, backward) <= CLUSTER_MAX_SMEM)


def _cluster_max_h() -> int:
    H = 1
    while all(cluster_fits(H + 1, cluster_ctas(H + 1), 1, bwd) for bwd in (False, True)):
        H += 1
    return H


CLUSTER_MAX_H = _cluster_max_h()   # 512: C = 16, U = 32


def cluster_rows(H: int, B: int, n_blocks: int, resident, backward: bool) -> int:
    """The rows a cluster serves: the fewest of CLUSTER_ROWS whose
    ceil(B / R) x ``n_blocks`` clusters the card holds at once
    (``resident(R)``: the card's count at R's shared memory) or that cover
    B, else the most that fit; 0 when none fits. Only the launch geometry
    depends on it, never the order of a sum."""
    C, best = cluster_ctas(H), 0
    for R in CLUSTER_ROWS:
        if not cluster_fits(H, C, R, backward):
            break
        n = resident(R)
        if n < 1:
            break
        best = R
        if -(-B // R) * n_blocks <= n or R >= B:
            break
    return best


# The grid body's plan, as csrc/gru_grid.cu computes it (the card's library
# reports the same numbers: `grid_plan_card`, `gru_grid_scratch_floats`). A
# dot product over k is GRID_SLABS slabs of HP / 8 (HP = H rounded up to 32),
# added in order; a CTA of GRID_THREADS threads holds UP units (a power of
# two, GRID_UNITS_MIN .. GRID_UNITS_MAX).
GRID_THREADS = 256
GRID_SLABS = 8
GRID_KC = 16                       # k a chunk of the tile body's ring
GRID_TILE_UNITS = 2                # units a thread of the tile body (up to 4 rows)
GRID_MAX_STAGES = 3                # the tile body's deepest ring
GRID_LANES_MAX_B = 16              # widest batch the lanes body takes
GRID_MAX_SMEM = 232448             # 227 KB, a CTA's opt-in limit on Hopper
GRID_UNITS_MIN = 8
GRID_UNITS_MAX = 256
GRID_COUNTER_FLOATS = 64           # the scratch's head: the barrier counters
GRID_SMS = 132                     # the mirror's card: an H100 SXM's SMs


def grid_geometry(H: int) -> Tuple[int, int, int]:
    """``(HP, HS, SS)`` of width H: the padded state row, a slab of it, and
    the slab stride of the lanes body's layout (SS / 4 odd)."""
    HP = _round_up(H, 4 * GRID_SLABS)
    HS = HP // GRID_SLABS
    return HP, HS, HS + (4 if HS % 8 == 0 else 8)


def grid_plan(n_dir: int, n_seed: int, B: int, H: int, backward: bool,
              with_res: bool = False, ctas: int = 0, sms: int = GRID_SMS) -> dict:
    """The grid body's launch of ``n_dir`` directions of ``n_seed`` seeds at
    (B, H) on a card of ``sms`` SMs (``ctas`` > 0 forces K): ``{"ctas": K,
    "units": U, "units_padded": UP, "split": 8 (the lanes body) or 1 (the
    tile body), "row_block": rows a thread, "rows": rows a pass, "stages":
    the ring's (tile body), "resident": bool, "threads", "smem": a CTA's
    bytes}``. UP: the fewest units a CTA (a power of two) whose ceil(H / UP)
    CTAs a direction fit the card; where GRID_UNITS_MAX do not, UP =
    GRID_UNITS_MAX, K the direction's SMs, and a CTA walks its U > UP units
    in ceil(U / UP) blocks. The lanes body where B <= GRID_LANES_MAX_B and
    its resident weights and whole rows fit; else the tile body, its
    weights resident when one block holds the units and they fit beside the
    smallest ring. The seeds take turns in the same CTAs, and nothing here
    changes the order of a sum (``csrc/gru_grid.cu``'s header). Raises only
    on a shape no launch takes (no direction, B or H below 1)."""
    del n_seed, with_res
    if not (1 <= n_dir <= 2 and B >= 1 and H >= 1 and sms >= n_dir):
        raise ValueError(f"no grid plan for {n_dir} directions at B={B} H={H}")
    HP, _, SS = grid_geometry(H)
    if ctas > 0:
        K, UP = ctas, GRID_UNITS_MIN
        while UP < -(-H // ctas) and UP < GRID_UNITS_MAX:
            UP *= 2
    else:
        UP = GRID_UNITS_MIN
        while UP < GRID_UNITS_MAX and -(-H // UP) > sms // n_dir:
            UP *= 2
        K = min(-(-H // UP), sms // n_dir)
    U = -(-H // K)
    plan = {"ctas": K, "units": U, "units_padded": UP, "threads": GRID_THREADS}
    G = 3 if backward else 1
    if B <= GRID_LANES_MAX_B and UP <= 32:
        nrg, ws = 32 // UP, GRID_SLABS * SS + 4
        for RB in (4, 2, 1):
            if RB > 1 and RB // 2 * nrg >= B:
                continue
            smem = 4 * (3 * UP + G * RB * nrg) * ws
            if smem <= GRID_MAX_SMEM:
                return {**plan, "split": GRID_SLABS, "row_block": RB, "rows": RB * nrg,
                        "stages": 0, "resident": True, "smem": smem}
    nrg, kcp = GRID_THREADS // (UP // GRID_TILE_UNITS), GRID_KC + 4
    weights = 3 * UP * (HP + 4)
    resident = U <= UP and 4 * (weights + 2 * G * nrg * kcp) <= GRID_MAX_SMEM
    for RB in (4, 2, 1):
        if RB > 1 and RB // 2 * nrg >= B:
            continue
        for stages in range(GRID_MAX_STAGES, 1, -1):
            ring = stages * G * RB * nrg * kcp
            smem = 4 * (weights + ring if resident else ring + stages * 3 * UP * kcp)
            if smem <= GRID_MAX_SMEM:
                return {**plan, "split": 1, "row_block": RB, "rows": RB * nrg,
                        "stages": stages, "resident": resident, "smem": smem}
    raise ValueError(f"no grid plan fits a CTA at B={B} H={H}")


def grid_scratch_floats(n_dir: int, B: int, H: int, backward: bool) -> int:
    """Device scratch of a grid launch: the barrier counters, then each
    direction's exchanged rows and step values (32-float aligned)."""
    HP = grid_geometry(H)[0]
    n = 6 * B * HP + 4 * B * H if backward else 3 * B * HP + 2 * B * H
    return GRID_COUNTER_FLOATS + n_dir * _round_up(n, 32)


def _grid_resident_max_h(sms: int = GRID_SMS) -> int:
    H = CLUSTER_MAX_H
    while all(grid_plan(2, 1, B, H + 1, bwd, sms=sms)["resident"]
              for B in (1, GRID_LANES_MAX_B + 1) for bwd in (False, True)):
        H += 1
    return H


# 1056: a pair's 66 CTAs of 16 units (48 vectors of 1,060 floats, 203,520
# bytes, beside the backward's smallest ring of 15,360); from 1057 a CTA
# holds 32 units, streamed.
GRID_RESIDENT_MAX_H = _grid_resident_max_h()


def gru_body(H: int, backward: bool = False) -> str:
    """The CUDA body that a hidden width H runs on, forward and backward
    alike: ``"warp"`` (``csrc/gru_warp.cu``) for H <= 32, ``"wide"``
    (``csrc/gru_wide.cu``) for 32 < H <= 128, ``"cluster"``
    (``csrc/gru_cluster.cu``) to CLUSTER_MAX_H and ``"grid"``
    (``csrc/gru_grid.cu``) above."""
    if H <= 0:
        raise ValueError(f"hidden width must be positive, got {H}")
    if H <= WARP_MAX_HIDDEN:
        return "warp"
    if H <= REGISTER_MAX_HIDDEN:
        return "wide"
    return "cluster" if H <= CLUSTER_MAX_H else "grid"


def _steps(T: int, reverse: bool):
    return range(T - 1, -1, -1) if reverse else range(T)


def gru_scan_plain(
    xp: torch.Tensor,
    wh: torch.Tensor,
    bh: Optional[torch.Tensor],
    h0: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence as a Python step loop of float32 PyTorch ops."""
    ys, _, h = gru_scan_fwd_res_plain(xp, wh, bh, h0, reset_after, gate_activation,
                                      reverse, keep_res=False)
    return ys, h


def gru_scan_fwd_res_plain(
    xp: torch.Tensor,
    wh: torch.Tensor,
    bh: Optional[torch.Tensor],
    h0: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
    keep_res: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """The step loop, also returning the residuals ``res`` (None unless
    ``keep_res``) -> ``(ys, res, h_last)``."""
    B, T, H3 = xp.shape
    H = H3 // 3
    gate = gate_fn(gate_activation)
    h = h0
    ys = [h0] * T
    res = [None] * T
    for t in _steps(T, reverse):
        xt = xp[:, t]
        xr, xz, xn = xt[:, :H], xt[:, H : 2 * H], xt[:, 2 * H :]
        if reset_after:
            hp = h @ wh + bh
            r = gate(xr + hp[:, :H])
            z = gate(xz + hp[:, H : 2 * H])
            hn = hp[:, 2 * H :]
            n = torch.tanh(xn + r * hn)
            gates = (r, z, n, hn)
        else:
            r = gate(xr + h @ wh[:, :H])
            z = gate(xz + h @ wh[:, H : 2 * H])
            n = torch.tanh(xn + (r * h) @ wh[:, 2 * H :])
            gates = (r, z, n)
        h = (1.0 - z) * n + z * h
        ys[t] = h
        if keep_res:
            res[t] = torch.cat(gates, dim=-1)
    ys_t = torch.stack(ys, dim=1) if T else xp.new_zeros((B, 0, H))
    if not keep_res:
        return ys_t, None, h
    res_t = torch.stack(res, dim=1) if T else xp.new_zeros((B, 0, res_width(reset_after, H)))
    return ys_t, res_t, h


def _h_prev(ys: torch.Tensor, h0: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The state before each step, (B*T, H) in row order n = b T + t: ``ys``
    shifted by one step in the direction's order, ``h0`` at the chain's
    start."""
    before = h0[:, None]
    h = torch.cat([ys[:, 1:], before], 1) if reverse else torch.cat([before, ys[:, :-1]], 1)
    return h.reshape(-1, ys.shape[-1])


def dwh_factors(ys, res, h0, dxp, reset_after: bool, reverse: bool):
    """The operands of dwh's three products over the B*T stored rows,
    ``dwh[:, pH:(p+1)H] = L_p^T D_p``: ``([L_0, L_1, L_2], [D_0, D_1,
    D_2])``, each (B*T, H); L_2 is r h_prev when not ``reset_after``, D_2
    is r da_n when ``reset_after``."""
    H = ys.shape[-1]
    h_prev = _h_prev(ys, h0, reverse)
    r = res[..., :H].reshape(-1, H)
    d = dxp.reshape(-1, 3 * H)
    return ([h_prev, h_prev, h_prev if reset_after else r * h_prev],
            [d[:, :H], d[:, H : 2 * H], d[:, 2 * H :] * r if reset_after else d[:, 2 * H :]])


def gru_dwh_plain(
    ys: torch.Tensor,
    res: torch.Tensor,
    h0: torch.Tensor,
    dxp: torch.Tensor,
    reset_after: bool,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dwh (H, 3H)`` and ``dbh (3H,)`` from the stored rows, after the
    gradient chain: with ``h_prev`` the state before each step (``ys``
    shifted by one step in the direction's order, ``h0`` at the chain's
    start) and ``dxp = [da_r, da_z, da_n]``,
    ``dwh[:, :2H] = h_prev^T dxp[:, :2H]``; ``dwh[:, 2H:] = (r h_prev)^T da_n``
    when not ``reset_after``, else ``h_prev^T (da_n r)`` and
    ``dbh = sum [da_r, da_z, da_n r]`` (zeros when not ``reset_after``)."""
    B, T, H = ys.shape
    if B == 0 or T == 0:
        return ys.new_zeros((H, 3 * H)), ys.new_zeros((3 * H,))
    h_prev = _h_prev(ys, h0, reverse)
    r = res[..., :H].reshape(-1, H)
    d = dxp.reshape(-1, 3 * H)
    if reset_after:
        dhp = torch.cat([d[:, : 2 * H], d[:, 2 * H :] * r], dim=-1)
        return h_prev.T @ dhp, dhp.sum(0)
    dwh = torch.cat([h_prev.T @ d[:, : 2 * H], (r * h_prev).T @ d[:, 2 * H :]], dim=-1)
    return dwh, ys.new_zeros((3 * H,))


# The dwh/dbh reduction above the warp body, as csrc/gru_dwh.cu computes it
# (the card's library reports the same split count: `gru_dwh_splits`): a
# block owns DWH_TILE x DWH_TILE entries of one part of dwh and walks its
# row split in chunks of DWH_K rows; the splits give about DWH_SPLIT_BLOCKS
# blocks, at most one split per DWH_MIN_SPLIT_ROWS rows, whole chunks.
DWH_TILE = 128
DWH_K = 32
DWH_SPLIT_BLOCKS = 264             # two waves of an H100's 132 SMs
DWH_MIN_SPLIT_ROWS = 256


def dwh_split_plan(B: int, T: int, H: int) -> Tuple[int, int]:
    """``(splits, rows a split)`` of the dwh reduction over B*T rows at
    width H: a function of (B, T, H) alone, so a seed of a stack, and every
    run, sums in one order. One split where the 3 (H / DWH_TILE)^2 tiles
    already make DWH_SPLIT_BLOCKS blocks."""
    rows, t = B * T, -(-H // DWH_TILE)
    n = min(max(1, DWH_SPLIT_BLOCKS // (3 * t * t)), max(1, -(-rows // DWH_MIN_SPLIT_ROWS)))
    chunk = _round_up(-(-rows // n), DWH_K)
    return -(-rows // chunk), chunk


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def gru_dwh_3xtf32(
    ys: torch.Tensor,
    res: torch.Tensor,
    h0: torch.Tensor,
    dxp: torch.Tensor,
    reset_after: bool,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`gru_dwh_plain`'s function in the arithmetic of ``csrc/gru_dwh.cu``,
    for the tests: each split of `dwh_split_plan` walks its rows in chunks
    of DWH_K, each chunk summing, 8 rows at a time in row order, the TF32
    products lo.hi, hi.lo and hi.hi of the operands' splits x = hi + lo
    into a fresh float32 accumulator that is then added to the split's
    total; dbh adds the rows one by one; the partials are added in split
    order. A leading seed axis is taken seed by seed. The tensor cores'
    own order and rounding inside a product are not repeated, so this is
    the kernel's arithmetic up to float32 rounding."""
    if ys.dim() == 4:
        outs = [gru_dwh_3xtf32(*(t[s] for t in (ys, res, h0, dxp)), reset_after, reverse)
                for s in range(ys.shape[0])]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    B, T, H = ys.shape
    if B == 0 or T == 0:
        return ys.new_zeros((H, 3 * H)), ys.new_zeros((3 * H,))
    lefts, rights = dwh_factors(ys, res, h0, dxp, reset_after, reverse)
    n_split, chunk = dwh_split_plan(B, T, H)
    rows = n_split * chunk

    def blocks(x):     # (splits, steps, 8, H), zero rows past B*T
        x = torch.cat([x, x.new_zeros((rows - x.shape[0], H))])
        return x.view(n_split, chunk // 8, 8, H)

    acc = ys.new_zeros((n_split, H, 3 * H))
    steps = DWH_K // 8
    for p, (a, b) in enumerate(zip(lefts, rights)):
        (ah, al), (bh, bl) = _split_tf32(blocks(a)), _split_tf32(blocks(b))
        out = acc[:, :, p * H : (p + 1) * H]
        for c in range(chunk // DWH_K):
            part = ys.new_zeros((n_split, H, H))
            for j in range(c * steps, (c + 1) * steps):
                for x, y in ((al, bh), (ah, bl), (ah, bh)):
                    part += x[:, j].transpose(1, 2) @ y[:, j]
            out += part
    dbh = ys.new_zeros((n_split, 3 * H))
    if reset_after:
        dd = torch.cat([torch.cat(rights, 1), ys.new_zeros((rows - B * T, 3 * H))])
        dd = dd.view(n_split, chunk, 3 * H)
        for i in range(chunk):
            dbh += dd[:, i]
    dwh, bias = acc[0].clone(), dbh[0].clone()
    for s in range(1, n_split):
        dwh += acc[s]
        bias += dbh[s]
    return dwh, bias


def gru_scan_bwd_plain(
    ys: torch.Tensor,
    res: torch.Tensor,
    wh: torch.Tensor,
    h0: torch.Tensor,
    dys: torch.Tensor,
    dhl: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse-time gradient recurrence as an explicit step loop over the
    stored residuals (the JAX `_bwd_kernel`'s math, not autograd), then
    `gru_dwh_plain` -> ``(dxp (B, T, 3H), dwh (H, 3H), dbh (3H,), dh0 (B, H))``."""
    B, T, H = ys.shape
    dxp = [None] * T
    dh = dhl
    for t in _steps(T, not reverse):
        if reverse:      # the forward walked t = T-1 .. 0; predecessor is ys[t+1]
            h_prev = ys[:, t + 1] if t < T - 1 else h0
        else:
            h_prev = ys[:, t - 1] if t > 0 else h0
        rt = res[:, t]
        r, z, n = rt[:, :H], rt[:, H : 2 * H], rt[:, 2 * H : 3 * H]
        dht = dys[:, t] + dh
        da_z = dht * (h_prev - n) * gate_grad_from_output(gate_activation, z)
        da_n = dht * (1.0 - z) * (1.0 - n * n)
        if reset_after:
            hn = rt[:, 3 * H :]
            da_r = da_n * hn * gate_grad_from_output(gate_activation, r)
            dh = dht * z + torch.cat([da_r, da_z, da_n * r], dim=-1) @ wh.T
        else:
            drh = da_n @ wh[:, 2 * H :].T
            da_r = drh * h_prev * gate_grad_from_output(gate_activation, r)
            dh = dht * z + torch.cat([da_r, da_z], dim=-1) @ wh[:, : 2 * H].T + drh * r
        dxp[t] = torch.cat([da_r, da_z, da_n], dim=-1)
    dxp_t = torch.stack(dxp, dim=1) if T else ys.new_zeros((B, 0, 3 * H))
    dwh, dbh = gru_dwh_plain(ys, res, h0, dxp_t, reset_after, reverse)
    return dxp_t, dwh, dbh, dh


# --- the CUDA libraries --------------------------------------------------------

_p, _i = ctypes.c_void_p, ctypes.c_int


class _FwdDir(ctypes.Structure):
    _fields_ = [(n, _p) for n in ("xp", "wh", "bh", "h0", "ys", "res", "h_last")] + [
        ("reverse", _i)]


class _BwdDir(ctypes.Structure):
    _fields_ = [(n, _p) for n in ("ys", "res", "wh", "h0", "dys", "dhl", "dxp", "dh0")] + [
        ("reverse", _i)]


class _DwhDir(ctypes.Structure):
    _fields_ = [(n, _p) for n in ("ys", "res", "h0", "dxp", "part")] + [("reverse", _i)]


@lru_cache(maxsize=None)
def _warp_lib() -> ctypes.CDLL:
    """The warp body, ``csrc/gru_warp.cu``."""
    lib = _build.load("gru_warp")
    lib.gru_warp_fwd_launch.argtypes = [ctypes.POINTER(_FwdDir)] + [_i] * 8 + [_p]
    lib.gru_warp_fwd_launch.restype = _i
    lib.gru_warp_bwd_launch.argtypes = [ctypes.POINTER(_BwdDir)] + [_i] * 7 + [_p]
    lib.gru_warp_bwd_launch.restype = _i
    lib.gru_warp_dwh_blocks.argtypes = [_i, _i]
    lib.gru_warp_dwh_blocks.restype = _i
    lib.gru_warp_dwh_launch.argtypes = [ctypes.POINTER(_DwhDir)] + [_i] * 6 + [_p]
    lib.gru_warp_dwh_launch.restype = _i
    lib.gru_warp_sum_partials.argtypes = [_p, _p, _i, _i, _i, _p]
    lib.gru_warp_sum_partials.restype = _i
    lib.gru_warp_error_string.argtypes = [_i]
    lib.gru_warp_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=None)
def _wide_lib() -> ctypes.CDLL:
    """The wide body, ``csrc/gru_wide.cu``."""
    lib = _build.load("gru_wide")
    lib.gru_wide_fwd_launch.argtypes = [ctypes.POINTER(_FwdDir)] + [_i] * 8 + [_p]
    lib.gru_wide_fwd_launch.restype = _i
    lib.gru_wide_bwd_launch.argtypes = [ctypes.POINTER(_BwdDir)] + [_i] * 7 + [_p]
    lib.gru_wide_bwd_launch.restype = _i
    lib.gru_wide_error_string.argtypes = [_i]
    lib.gru_wide_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=None)
def _dwh_lib() -> ctypes.CDLL:
    """The dwh/dbh reduction above the warp body, ``csrc/gru_dwh.cu``."""
    return bind_dwh(_build.load("gru_dwh"))


def bind_dwh(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C interface of a library built from ``csrc/gru_dwh.cu``."""
    lib.gru_dwh_splits.argtypes = [_i, _i, _i]
    lib.gru_dwh_splits.restype = _i
    lib.gru_dwh_launch.argtypes = [ctypes.POINTER(_DwhDir)] + [_i] * 6 + [_p]
    lib.gru_dwh_launch.restype = _i
    lib.gru_dwh_sum_partials.argtypes = [_p, _p, _i, _i, ctypes.c_longlong, _p]
    lib.gru_dwh_sum_partials.restype = _i
    lib.gru_dwh_error_string.argtypes = [_i]
    lib.gru_dwh_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=None)
def _cluster_lib() -> ctypes.CDLL:
    """The cluster body, ``csrc/gru_cluster.cu``."""
    return bind_cluster(_build.load("gru_cluster"))


def bind_cluster(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C interface of a library built from ``csrc/gru_cluster.cu``."""
    lib.gru_cluster_max_h.argtypes = []
    lib.gru_cluster_max_h.restype = _i
    lib.gru_cluster_ctas.argtypes = [_i]
    lib.gru_cluster_ctas.restype = _i
    lib.gru_cluster_smem_bytes.argtypes = [_i] * 4
    lib.gru_cluster_smem_bytes.restype = ctypes.c_longlong
    lib.gru_cluster_plan.argtypes = [_i] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.gru_cluster_plan.restype = _i
    lib.gru_cluster_fwd_launch.argtypes = [ctypes.POINTER(_FwdDir)] + [_i] * 9 + [_p]
    lib.gru_cluster_fwd_launch.restype = _i
    lib.gru_cluster_bwd_launch.argtypes = [ctypes.POINTER(_BwdDir)] + [_i] * 8 + [_p]
    lib.gru_cluster_bwd_launch.restype = _i
    lib.gru_cluster_error_string.argtypes = [_i]
    lib.gru_cluster_error_string.restype = ctypes.c_char_p
    return lib


def cluster_plan(n_dir: int, n_seed: int, B: int, H: int, backward: bool,
                 with_res: bool = False, ctas: int = 0) -> dict:
    """The cluster body's launch on the current card: ``{"ctas": C, "rows":
    R, "threads": a CTA's, "smem": a CTA's bytes}`` (``ctas`` > 0 forces C)."""
    lib = _cluster_lib()
    out = (ctypes.c_longlong * 4)()
    _raise_on(lib.gru_cluster_plan(n_dir, n_seed, B, H, int(backward), int(with_res), ctas, out),
              "gru_cluster_plan", lib.gru_cluster_error_string)
    return dict(zip(("ctas", "rows", "threads", "smem"), (int(v) for v in out)))


@lru_cache(maxsize=None)
def _grid_lib() -> ctypes.CDLL:
    """The grid body, ``csrc/gru_grid.cu``."""
    return bind_grid(_build.load("gru_grid"))


def bind_grid(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C interface of a library built from ``csrc/gru_grid.cu``."""
    lib.gru_grid_scratch_floats.argtypes = [_i] * 4
    lib.gru_grid_scratch_floats.restype = ctypes.c_longlong
    lib.gru_grid_resident_ctas.argtypes = [_i] * 6
    lib.gru_grid_resident_ctas.restype = _i
    lib.gru_grid_plan.argtypes = [_i] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.gru_grid_plan.restype = _i
    lib.gru_grid_fwd_launch.argtypes = [ctypes.POINTER(_FwdDir)] + [_i] * 9 + [_p, _p]
    lib.gru_grid_fwd_launch.restype = _i
    lib.gru_grid_bwd_launch.argtypes = [ctypes.POINTER(_BwdDir)] + [_i] * 8 + [_p, _p]
    lib.gru_grid_bwd_launch.restype = _i
    lib.gru_grid_error_string.argtypes = [_i]
    lib.gru_grid_error_string.restype = ctypes.c_char_p
    return lib


GRID_PLAN_KEYS = ("ctas", "units", "units_padded", "split", "row_block", "rows", "stages",
                  "resident", "threads", "smem")


def grid_plan_card(n_dir: int, n_seed: int, B: int, H: int, backward: bool,
                   with_res: bool = False, ctas: int = 0, lib=None) -> dict:
    """`grid_plan` as the library computes it on the current card."""
    lib = lib or _grid_lib()
    out = (ctypes.c_longlong * len(GRID_PLAN_KEYS))()
    _raise_on(lib.gru_grid_plan(n_dir, n_seed, B, H, int(backward), int(with_res), ctas, out),
              "gru_grid_plan", lib.gru_grid_error_string)
    plan = dict(zip(GRID_PLAN_KEYS, (int(v) for v in out)))
    plan["resident"] = bool(plan["resident"])
    return plan


def _grid_scratch(lib, n_dir: int, B: int, H: int, backward: bool, device) -> torch.Tensor:
    """The grid body's device scratch for one launch."""
    n = lib.gru_grid_scratch_floats(n_dir, B, H, int(backward))
    return torch.empty(n, dtype=torch.float32, device=device)


def _checked(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    return t.contiguous()


def _raise_on(status: int, what: str, error_string) -> None:
    """Raise with the library's message for a non-zero CUDA status."""
    if status != 0:
        raise RuntimeError(f"{what} launch failed: {error_string(status).decode()}")


def _device_of(xp: torch.Tensor) -> torch.device:
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xp.device}")
    return xp.device


def _validate(H3: int, gate_activation: str) -> Tuple[int, str]:
    """-> (H, the body that runs it)."""
    if gate_activation not in GATES:
        raise ValueError(f"unknown gate_activation {gate_activation!r}")
    H = H3 // 3
    if H3 != 3 * H:
        raise ValueError(f"the gate axis must be 3H, got {H3}")
    return H, gru_body(H)


def _bias(bh: Optional[torch.Tensor], reset_after: bool, xp: torch.Tensor) -> Optional[torch.Tensor]:
    """``bh`` as (3H,); zeros when ``reset_after`` and none is given."""
    H3 = xp.shape[-1]
    if bh is not None:
        return bh.reshape(H3)
    return xp.new_zeros((H3,)) if reset_after else None


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _lead(stack: Optional[int]) -> tuple:
    """The leading shape of stacked operands: (S,), or () unstacked."""
    return () if stack is None else (stack,)


def _fwd(xps: Sequence[torch.Tensor], whs, bhs, h0s, reverses: Sequence[bool],
         reset_after: bool, gate_activation: str, with_res: bool,
         body: Optional[str] = None, stack: Optional[int] = None,
         ctas: int = 0) -> Tuple[List[tuple], int]:
    """Launch the forward of ``len(xps)`` (1 or 2) directions of one shape on
    the card, on ``body`` (default: `gru_body`'s choice; the private launch
    takes any body at any width it can hold) -> per direction ``(ys, res or
    None, h_last)``, and the number of launches. ``stack``: the seed count S
    of stacked operands (both directions), None for unstacked ones.
    ``ctas`` > 0 forces the cluster body's cluster size or the grid body's
    CTAs a direction."""
    dev = xps[0].device
    lead = _lead(stack)
    B, T, H3 = xps[0].shape[-3:]
    H, chosen = _validate(H3, gate_activation)
    body = body or chosen
    if body not in BODIES:
        raise ValueError(f"unknown GRU body {body!r}")
    dirs = []
    for x, wh, bh, h0 in zip(xps, whs, bhs, h0s):
        dirs.append((_checked("xp", x, lead + (B, T, H3), dev),
                     _checked("wh", wh, lead + (H, H3), dev),
                     _checked("bh", bh, lead + (H3,), dev) if reset_after else None,
                     _checked("h0", h0, lead + (B, H), dev)))
    outs = [(torch.empty(lead + (B, T, H), dtype=torch.float32, device=dev),
             torch.empty(lead + (B, T, res_width(reset_after, H)), dtype=torch.float32,
                         device=dev) if with_res else None,
             torch.empty(lead + (B, H), dtype=torch.float32, device=dev)) for _ in dirs]
    if B == 0 or T == 0 or stack == 0:
        for (_, _, _, h0), (_, _, hl) in zip(dirs, outs):
            hl.copy_(h0)
        return outs, 0
    n_dir, n_seed = len(dirs), stack or 1
    shape = (n_dir, n_seed, B, T, H, int(reset_after), int(gate_activation == "hard_sigmoid"),
             int(with_res))
    arr = (_FwdDir * n_dir)(*(
        _FwdDir(x.data_ptr(), wh.data_ptr(), _ptr(bh), h0.data_ptr(), ys.data_ptr(),
                _ptr(res), hl.data_ptr(), int(rev))
        for (x, wh, bh, h0), (ys, res, hl), rev in zip(dirs, outs, reverses)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if body == "warp":
            lib = _warp_lib()
            status = lib.gru_warp_fwd_launch(arr, *shape, stream)
            _raise_on(status, "gru_warp_fwd", lib.gru_warp_error_string)
        elif body == "cluster":
            lib = _cluster_lib()
            status = lib.gru_cluster_fwd_launch(arr, *shape, ctas, stream)
            _raise_on(status, "gru_cluster_fwd", lib.gru_cluster_error_string)
            gru_scan.cluster_launches += 1
        elif body == "grid":
            lib = _grid_lib()
            scratch = _grid_scratch(lib, n_dir, B, H, False, dev)
            status = lib.gru_grid_fwd_launch(arr, *shape, ctas, scratch.data_ptr(), stream)
            _raise_on(status, "gru_grid_fwd", lib.gru_grid_error_string)
            gru_scan.grid_launches += 1
        else:
            lib = _wide_lib()
            status = lib.gru_wide_fwd_launch(arr, *shape, stream)
            _raise_on(status, "gru_wide_fwd", lib.gru_wide_error_string)
            gru_scan.wide_launches += 1
    return outs, 1


def _bwd(ys_s, res_s, whs, h0s, dys_s, dhl_s, reverses: Sequence[bool], reset_after: bool,
         gate_activation: str, body: Optional[str] = None,
         stack: Optional[int] = None, ctas: int = 0) -> List[tuple]:
    """Launch the backward of ``len(ys_s)`` directions of one shape on the
    card: the gradient chain, the ``dwh``/``dbh`` reduction and the
    fixed-order sum of its partials -> per direction ``(dxp, dwh, dbh,
    dh0)``; counts its launches. ``body``, ``stack`` and ``ctas`` as for
    `_fwd` (every body but the warp one reduces with ``csrc/gru_dwh.cu``)."""
    dev = ys_s[0].device
    lead = _lead(stack)
    B, T, H = ys_s[0].shape[-3:]
    _, chosen = _validate(3 * H, gate_activation)
    body = body or chosen
    if body not in BODIES:
        raise ValueError(f"unknown GRU body {body!r}")
    RW = res_width(reset_after, H)
    dirs = [(_checked("ys", ys, lead + (B, T, H), dev),
             _checked("res", res, lead + (B, T, RW), dev),
             _checked("wh", wh, lead + (H, 3 * H), dev), _checked("h0", h0, lead + (B, H), dev),
             _checked("dys", dys, lead + (B, T, H), dev), _checked("dhl", dhl, lead + (B, H), dev))
            for ys, res, wh, h0, dys, dhl in zip(ys_s, res_s, whs, h0s, dys_s, dhl_s)]
    n_dir = len(dirs)
    dxps = [torch.empty(lead + (B, T, 3 * H), dtype=torch.float32, device=dev) for _ in dirs]
    if B == 0 or T == 0 or stack == 0:
        return [(dxp, d[2].new_zeros(lead + (H, 3 * H)), d[2].new_zeros(lead + (3 * H,)),
                 d[5].clone()) for dxp, d in zip(dxps, dirs)]
    dh0s = [torch.empty(lead + (B, H), dtype=torch.float32, device=dev) for _ in dirs]
    n = 3 * H * H + 3 * H
    n_seed = stack or 1
    flags = (int(reset_after), int(gate_activation == "hard_sigmoid"))
    chain = (_BwdDir * n_dir)(*(
        _BwdDir(*(t.data_ptr() for t in d), dxp.data_ptr(), dh0.data_ptr(), int(rev))
        for d, dxp, dh0, rev in zip(dirs, dxps, dh0s, reverses)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if body == "warp":
            wl = _warp_lib()
            _raise_on(wl.gru_warp_bwd_launch(chain, n_dir, n_seed, B, T, H, *flags, stream),
                      "gru_warp_bwd", wl.gru_warp_error_string)
            n_part = wl.gru_warp_dwh_blocks(B, T)
            reduce = (wl.gru_warp_dwh_launch, wl.gru_warp_sum_partials, "gru_warp",
                      wl.gru_warp_error_string)
        else:
            if body == "cluster":
                clib = _cluster_lib()
                status = clib.gru_cluster_bwd_launch(chain, n_dir, n_seed, B, T, H, *flags, ctas,
                                                     stream)
                _raise_on(status, "gru_cluster_bwd", clib.gru_cluster_error_string)
                gru_scan.cluster_launches += 1
            elif body == "grid":
                glib = _grid_lib()
                scratch = _grid_scratch(glib, n_dir, B, H, True, dev)
                status = glib.gru_grid_bwd_launch(chain, n_dir, n_seed, B, T, H, *flags, ctas,
                                                  scratch.data_ptr(), stream)
                _raise_on(status, "gru_grid_bwd", glib.gru_grid_error_string)
                gru_scan.grid_launches += 1
            else:
                wl = _wide_lib()
                _raise_on(wl.gru_wide_bwd_launch(chain, n_dir, n_seed, B, T, H, *flags, stream),
                          "gru_wide_bwd", wl.gru_wide_error_string)
                gru_scan.wide_launches += 1
            dl = _dwh_lib()
            n_part = dl.gru_dwh_splits(B, T, H)
            reduce = (dl.gru_dwh_launch, dl.gru_dwh_sum_partials, "gru_dwh",
                      dl.gru_dwh_error_string)
        gru_scan_bwd.launches += 1
        dwh_launch, sum_launch, name, error_string = reduce
        # Partials per (direction, seed), each seed's in a fixed order.
        part = torch.empty((n_dir, n_seed, n_part, n), dtype=torch.float32, device=dev)
        arr = (_DwhDir * n_dir)(*(
            _DwhDir(ys.data_ptr(), res.data_ptr(), h0.data_ptr(), dxp.data_ptr(),
                    part[k].data_ptr(), int(rev))
            for k, ((ys, res, _, h0, _, _), dxp, rev) in enumerate(zip(dirs, dxps, reverses))))
        status = dwh_launch(arr, n_dir, n_seed, B, T, H, int(reset_after), stream)
        _raise_on(status, f"{name}_dwh", error_string)
        gru_scan_bwd.dwh_launches += 1
        if body != "warp":
            gru_scan_bwd.mma_dwh_launches += 1
        sums = torch.empty((n_dir, n_seed, n), dtype=torch.float32, device=dev)
        status = sum_launch(part.data_ptr(), sums.data_ptr(), n_dir * n_seed, n_part, n, stream)
        _raise_on(status, f"{name}_sum_partials", error_string)
        gru_scan_bwd.sum_launches += 1
    if stack is not None:
        return [(dxp, sums[k, :, : 3 * H * H].view(stack, H, 3 * H), sums[k, :, 3 * H * H :], dh0)
                for k, (dxp, dh0) in enumerate(zip(dxps, dh0s))]
    return [(dxp, sums[k, 0, : 3 * H * H].view(H, 3 * H), sums[k, 0, 3 * H * H :], dh0)
            for k, (dxp, dh0) in enumerate(zip(dxps, dh0s))]


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def gru_scan(
    xp: torch.Tensor,
    wh: torch.Tensor,
    bh: Optional[torch.Tensor],
    h0: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction of the GRU recurrence over all T steps.

    With grad enabled and an input that requires grad: `GruScanFn` (the
    residual forward and the backward kernels). Otherwise, for a CUDA tensor
    the forward kernel of `gru_body`'s body, for a CPU tensor `gru_scan_plain`."""
    bh = _bias(bh, reset_after, xp)
    if _needs_grad(xp, wh, bh, h0):
        return GruScanFn.apply(xp, wh, bh, h0, reset_after, gate_activation, reverse)
    if _device_of(xp).type == "cpu":
        return gru_scan_plain(xp, wh, bh, h0, reset_after, gate_activation, reverse)
    (out,), n = _fwd([xp], [wh], [bh], [h0], [reverse], reset_after, gate_activation, False)
    gru_scan.launches += n
    return out[0], out[2]


gru_scan.launches = 0
gru_scan.wide_launches = 0
gru_scan.cluster_launches = 0
gru_scan.grid_launches = 0


def gru_scan_fwd_res(
    xp: torch.Tensor,
    wh: torch.Tensor,
    bh: Optional[torch.Tensor],
    h0: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward that keeps its residuals -> ``(ys, res, h_last)``. CUDA
    tensor: the kernel; CPU tensor: `gru_scan_fwd_res_plain`."""
    bh = _bias(bh, reset_after, xp)
    if _device_of(xp).type == "cpu":
        return gru_scan_fwd_res_plain(xp, wh, bh, h0, reset_after, gate_activation, reverse)
    (out,), n = _fwd([xp], [wh], [bh], [h0], [reverse], reset_after, gate_activation, True)
    gru_scan_fwd_res.launches += n
    return out


gru_scan_fwd_res.launches = 0


def gru_scan_bwd(
    ys: torch.Tensor,
    res: torch.Tensor,
    wh: torch.Tensor,
    h0: torch.Tensor,
    dys: torch.Tensor,
    dhl: torch.Tensor,
    reset_after: bool,
    gate_activation: str,
    reverse: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient recurrence -> ``(dxp, dwh, dbh, dh0)``. CUDA tensor: the
    backward kernels (the chain, the ``dwh`` reduction, the fixed-order
    partial sum); CPU tensor:
    `gru_scan_bwd_plain`."""
    if _device_of(ys).type == "cpu":
        return gru_scan_bwd_plain(ys, res, wh, h0, dys, dhl, reset_after,
                                  gate_activation, reverse)
    (out,) = _bwd([ys], [res], [wh], [h0], [dys], [dhl], [reverse], reset_after,
                  gate_activation)
    return out


gru_scan_bwd.launches = 0
gru_scan_bwd.dwh_launches = 0
gru_scan_bwd.sum_launches = 0
gru_scan_bwd.mma_dwh_launches = 0


def _pair_bias(bh: Sequence[Optional[torch.Tensor]], reset_after: bool, xp: Pair):
    return tuple(_bias(b, reset_after, x) for b, x in zip(bh, xp))


def _check_pair(xp: Pair) -> torch.device:
    dev = _device_of(xp[0])
    if len(xp) != 2 or xp[1].device != dev or xp[1].shape != xp[0].shape:
        raise ValueError("a pair needs two directions of one shape on one device")
    return dev


def gru_scan_pair(
    xp: Pair,
    wh: Pair,
    bh: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    h0: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[Pair, Pair]:
    """Both directions of a BiGRU, each argument a (forward-in-time,
    reversed) pair -> ``((ys_f, h_last_f), (ys_b, h_last_b))``.

    With grad enabled and an input that requires grad: `GruScanPairFn`.
    Otherwise, for CUDA tensors one forward launch, for CPU tensors two
    `gru_scan_plain` runs."""
    bh = _pair_bias(bh, reset_after, xp)
    if _needs_grad(*xp, *wh, *bh, *h0):
        ys_f, ys_b, hl_f, hl_b = GruScanPairFn.apply(*xp, *wh, *bh, *h0, reset_after,
                                                     gate_activation)
        return (ys_f, hl_f), (ys_b, hl_b)
    if _check_pair(xp).type == "cpu":
        return tuple(gru_scan_plain(x, w, b, h, reset_after, gate_activation, rev)
                     for x, w, b, h, rev in zip(xp, wh, bh, h0, (False, True)))
    outs, n = _fwd(xp, wh, bh, h0, (False, True), reset_after, gate_activation, False)
    gru_scan.launches += n
    return tuple((ys, hl) for ys, _, hl in outs)


def gru_scan_pair_fwd_res(
    xp: Pair,
    wh: Pair,
    bh: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    h0: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[tuple, tuple]:
    """`gru_scan_fwd_res` of both directions -> ``((ys, res, h_last) forward,
    (ys, res, h_last) reversed)``; counted in ``gru_scan_fwd_res.launches``."""
    bh = _pair_bias(bh, reset_after, xp)
    if _check_pair(xp).type == "cpu":
        return tuple(gru_scan_fwd_res_plain(x, w, b, h, reset_after, gate_activation, rev)
                     for x, w, b, h, rev in zip(xp, wh, bh, h0, (False, True)))
    outs, n = _fwd(xp, wh, bh, h0, (False, True), reset_after, gate_activation, True)
    gru_scan_fwd_res.launches += n
    return tuple(outs)


def gru_scan_pair_bwd(
    ys: Pair,
    res: Pair,
    wh: Pair,
    h0: Pair,
    dys: Pair,
    dhl: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[tuple, tuple]:
    """`gru_scan_bwd` of both directions -> ``((dxp, dwh, dbh, dh0) forward,
    (...) reversed)``: on the card one launch each of the chain, the ``dwh``
    reduction and the partial sum."""
    if _check_pair(ys).type == "cpu":
        return tuple(gru_scan_bwd_plain(*a, reset_after, gate_activation, rev)
                     for *a, rev in zip(ys, res, wh, h0, dys, dhl, (False, True)))
    return tuple(_bwd(ys, res, wh, h0, dys, dhl, (False, True), reset_after, gate_activation))


class GruScanFn(torch.autograd.Function):
    """The custom VJP of the recurrence: forward `gru_scan_fwd_res`, saving
    ``(ys, res, wh, h0)``; backward `gru_scan_bwd`. A cotangent that autograd
    passes as None (``ys`` or ``h_last`` unused downstream) becomes zeros;
    ``bh``'s gradient is None when no ``bh`` was given, and zeros when it was
    given with ``reset_after=False`` (the kernel never reads it then)."""

    @staticmethod
    def forward(ctx, xp, wh, bh, h0, reset_after, gate_activation, reverse):
        ys, res, h_last = gru_scan_fwd_res(xp, wh, bh, h0, reset_after,
                                           gate_activation, reverse)
        ctx.save_for_backward(ys, res, wh, h0)
        ctx.conf = (reset_after, gate_activation, reverse)
        ctx.has_bh = bh is not None
        ctx.set_materialize_grads(False)
        return ys, h_last

    @staticmethod
    def backward(ctx, dys, dhl):
        ys, res, wh, h0 = ctx.saved_tensors
        dys = torch.zeros_like(ys) if dys is None else dys.contiguous()
        dhl = torch.zeros_like(h0) if dhl is None else dhl.contiguous()
        dxp, dwh, dbh, dh0 = gru_scan_bwd(ys, res, wh, h0, dys, dhl, *ctx.conf)
        return dxp, dwh, dbh if ctx.has_bh else None, dh0, None, None, None


def _bigru_function(name: str, fwd_res: Callable, bwd: Callable, doc: str):
    """A `torch.autograd.Function` over both directions of a BiGRU: forward
    ``fwd_res``, saving what ``bwd`` takes. Arguments ``(xp_f, xp_b, wh_f,
    wh_b, bh_f, bh_b, h0_f, h0_b, reset_after, gate_activation)``, outputs
    ``(ys_f, ys_b, h_last_f, h_last_b)``; the same rules for absent
    cotangents and biases as `GruScanFn`."""

    def forward(ctx, xp_f, xp_b, wh_f, wh_b, bh_f, bh_b, h0_f, h0_b, reset_after,
                gate_activation):
        (ys_f, res_f, hl_f), (ys_b, res_b, hl_b) = fwd_res(
            (xp_f, xp_b), (wh_f, wh_b), (bh_f, bh_b), (h0_f, h0_b), reset_after,
            gate_activation)
        ctx.save_for_backward(ys_f, ys_b, res_f, res_b, wh_f, wh_b, h0_f, h0_b)
        ctx.conf = (reset_after, gate_activation)
        ctx.has_bh = (bh_f is not None, bh_b is not None)
        ctx.set_materialize_grads(False)
        return ys_f, ys_b, hl_f, hl_b

    def backward(ctx, dys_f, dys_b, dhl_f, dhl_b):
        ys_f, ys_b, res_f, res_b, wh_f, wh_b, h0_f, h0_b = ctx.saved_tensors

        def cot(g, like):
            return torch.zeros_like(like) if g is None else g.contiguous()

        grads = bwd(
            (ys_f, ys_b), (res_f, res_b), (wh_f, wh_b), (h0_f, h0_b),
            (cot(dys_f, ys_f), cot(dys_b, ys_b)), (cot(dhl_f, h0_f), cot(dhl_b, h0_b)),
            *ctx.conf)
        (dxp_f, dwh_f, dbh_f, dh0_f), (dxp_b, dwh_b, dbh_b, dh0_b) = grads
        return (dxp_f, dxp_b, dwh_f, dwh_b, dbh_f if ctx.has_bh[0] else None,
                dbh_b if ctx.has_bh[1] else None, dh0_f, dh0_b, None, None)

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward), "__doc__": doc})


GruScanPairFn = _bigru_function(
    "GruScanPairFn", gru_scan_pair_fwd_res, gru_scan_pair_bwd,
    """`GruScanFn` for both directions of a BiGRU at once: forward
    `gru_scan_pair_fwd_res`, backward `gru_scan_pair_bwd`.""")


# --- S BiGRUs of one shape at once (stacked multi-seed training) ---------------

def _check_stack(xp: Pair) -> Tuple[torch.device, int]:
    dev = _check_pair(xp)
    if xp[0].dim() != 4:
        raise ValueError(f"stacked operands need a leading seed axis, got xp {tuple(xp[0].shape)}")
    return dev, xp[0].shape[0]


def _stack_bias(bh, reset_after: bool, xp: Pair):
    """Each direction's ``bh`` as (S, 3H); zeros when ``reset_after`` and none
    is given."""
    S, _, _, H3 = xp[0].shape
    return tuple((b.reshape(S, H3) if b is not None
                  else x.new_zeros((S, H3)) if reset_after else None) for b, x in zip(bh, xp))


def _seedwise(fn: Callable, *stacked) -> tuple:
    """``fn`` on every seed's slice of the stacked arguments (None passes
    through), its results stacked along a new seed axis."""
    S = stacked[0].shape[0]
    outs = [fn(*(None if a is None else a[s] for a in stacked)) for s in range(S)]
    return tuple(torch.stack(r) for r in zip(*outs))


def gru_scan_stack(
    xp: Pair,
    wh: Pair,
    bh: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    h0: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[Pair, Pair]:
    """Both directions of S BiGRUs, each argument a (forward-in-time,
    reversed) pair of stacked tensors ``xp (S, B, T, 3H)``, ``wh (S, H, 3H)``,
    ``bh (S, 3H)`` or None, ``h0 (S, B, H)`` -> ``((ys_f, h_last_f), (ys_b,
    h_last_b))`` of shapes (S, B, T, H) and (S, B, H).

    With grad enabled and an input that requires grad: `GruScanStackFn`.
    Otherwise, for CUDA tensors one launch for every seed and direction, for CPU tensors `gru_scan_plain` seed by seed."""
    dev, S = _check_stack(xp)
    bh = _stack_bias(bh, reset_after, xp)
    if _needs_grad(*xp, *wh, *bh, *h0):
        ys_f, ys_b, hl_f, hl_b = GruScanStackFn.apply(*xp, *wh, *bh, *h0, reset_after,
                                                      gate_activation)
        return (ys_f, hl_f), (ys_b, hl_b)
    if dev.type == "cpu":
        return tuple(_seedwise(lambda x_, w_, b_, h_: gru_scan_plain(
            x_, w_, b_, h_, reset_after, gate_activation, rev), x, w, b, h)
            for x, w, b, h, rev in zip(xp, wh, bh, h0, (False, True)))
    outs, n = _fwd(xp, wh, bh, h0, (False, True), reset_after, gate_activation, False,
                   stack=S)
    gru_scan.launches += n
    return tuple((ys, hl) for ys, _, hl in outs)


def gru_scan_stack_fwd_res(
    xp: Pair,
    wh: Pair,
    bh: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    h0: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[tuple, tuple]:
    """`gru_scan_pair_fwd_res` of S stacked BiGRUs -> per direction ``(ys,
    res, h_last)`` with a leading seed axis; one launch on the card, counted
    in ``gru_scan_fwd_res.launches``."""
    dev, S = _check_stack(xp)
    bh = _stack_bias(bh, reset_after, xp)
    if dev.type == "cpu":
        return tuple(_seedwise(lambda x_, w_, b_, h_: gru_scan_fwd_res_plain(
            x_, w_, b_, h_, reset_after, gate_activation, rev), x, w, b, h)
            for x, w, b, h, rev in zip(xp, wh, bh, h0, (False, True)))
    outs, n = _fwd(xp, wh, bh, h0, (False, True), reset_after, gate_activation, True, stack=S)
    gru_scan_fwd_res.launches += n
    return tuple(outs)


def gru_scan_stack_bwd(
    ys: Pair,
    res: Pair,
    wh: Pair,
    h0: Pair,
    dys: Pair,
    dhl: Pair,
    reset_after: bool,
    gate_activation: str,
) -> Tuple[tuple, tuple]:
    """`gru_scan_pair_bwd` of S stacked BiGRUs -> per direction ``(dxp, dwh,
    dbh, dh0)`` with a leading seed axis: on the card one launch each of the
    chain, the ``dwh`` reduction and the partial sum for all seeds; each
    seed's ``dwh`` summed in the same fixed order as alone."""
    dev, S = _check_stack(ys)
    if dev.type == "cpu":
        return tuple(_seedwise(lambda *a: gru_scan_bwd_plain(*a, reset_after, gate_activation,
                                                             rev), *args)
                     for *args, rev in zip(ys, res, wh, h0, dys, dhl, (False, True)))
    return tuple(_bwd(ys, res, wh, h0, dys, dhl, (False, True), reset_after, gate_activation,
                      stack=S))


GruScanStackFn = _bigru_function(
    "GruScanStackFn", gru_scan_stack_fwd_res, gru_scan_stack_bwd,
    """`GruScanPairFn` over stacked operands: forward `gru_scan_stack_fwd_res`,
    backward `gru_scan_stack_bwd`, every tensor with a leading seed axis.""")
