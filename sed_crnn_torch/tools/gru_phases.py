"""Where the time of kernel B's cluster and grid tiers goes, phase by phase,
on one CUDA card.

    python3 -m sed_crnn_torch.tools.gru_phases [--H 256] [--T 256]
    python3 -m sed_crnn_torch.tools.gru_phases --body grid [--H 1024] [--T 256]
    python3 -m sed_crnn_torch.tools.gru_phases --body grid --l2-source OLD/gru_wide.cu
    python3 -m sed_crnn_torch.tools.gru_phases --body grid --against OTHER/gru_grid.cu
    python3 -m sed_crnn_torch.tools.gru_phases --body dwh [--H 1024] [--T 256]
    python3 -m sed_crnn_torch.tools.gru_phases --body dwh --against OTHER/gru_dwh.cu

from the root of a checkout.

``--body cluster`` (the default) builds ``sed_crnn_torch/csrc/gru_cluster.cu`` as
it is and with each of its profiling cuts (``-DGRU_CLUSTER_CUT=k``: the
source leaves out part of each step, and the results are no longer right)
and with a larger thread budget, all ``nvcc`` runs started
together, then times with CUDA events both directions of a BiGRU at width H
(a pair launch, as `nn/gru.py` runs it): the residual forward and the
backward chain alone (dxp and dh0; the dwh reduction after it is the wide
body's and is not built here), at B = 1 and B = 128, both conventions, in
turns (every variant, then every variant in reverse order). One JSON line
per (convention, B, C).

The variants: ``full`` (cut 0); ``no_exchange`` (cut 1: each CTA writes the
new state values or gate gradients into its own shared memory only, and
block barriers take the place of the cluster barriers); ``no_products``
(cut 2: nor the gate products); ``no_staging`` (cut 3: nor the cp.async
copies of the step's inputs; what is left is the gate arithmetic, the
writes of the outputs, the block barriers and the weights' load). The
step's phases are the differences, in us a step: exchange = full -
no_exchange (the distributed shared memory stores and the cluster
barrier's wait beyond a block barrier's), products = no_exchange -
no_products, staging = no_products - no_staging, rest = no_staging.

``threads512`` (``-DGRU_CLUSTER_MAX_THREADS=512``: up to 64 units a CTA,
at most 128 registers a thread) times the full body; it is the only build
that takes C = 4 at H = 256. C = 4, 8 and 16 are forced
through the launcher's ``ctas`` argument (the sums' order does not depend
on C); the library's rule picks `cluster_ctas` (H).

``--body grid`` builds ``sed_crnn_torch/csrc/gru_grid.cu`` as it is and with
its cuts (``-DGRU_GRID_CUT=k``): ``no_barrier`` (1: the direction's barriers
wait for no other CTA), ``no_products`` (2: nor the gate products) and
``no_loads`` (3: nor the loads of the state rows and streamed weight
chunks), and times a pair's residual forward and backward chain at width H
(default 1024) at B = 1 and 128, both conventions, in turns. The phases, in
us a step: exchange + barrier = full - no_barrier (the wait for the
direction's other CTAs, their skew included), products = no_barrier -
no_products, tile loads = no_products - no_loads (the state rows from L2,
and the weight chunks when streamed), rest = no_loads (gates, the writes of
the exchanged rows and outputs, block barriers). One JSON line per
(convention, B) with the plan of each build.

``--against PATH`` (with ``--body grid``) instead builds the grid body as
it is and from PATH, another version of ``gru_grid.cu`` with the same C
interface (a changed plan rule, say), and times a pair's forward, residual
forward and backward chain at width H (default 1024) at B = 1, 8 and 16
(the lanes body's batches), both conventions, in turns (this, other, other, this),
with each build's plan and whether the two give the same bits.

``--body dwh`` builds ``sed_crnn_torch/csrc/gru_dwh.cu`` (the backward's
dwh/dbh reduction above the warp body) as it is and with its cuts
(``-DGRU_DWH_CUT=k``): ``one_product`` (1: hi.hi only, one TF32 product a
k step in place of three), ``no_products`` (2: nor that, nor the A
fragments' loads and splits), ``no_copies`` (3: nor the copies of the
chunks; on the wgmma body the split pass of B is what is left),
``no_split`` (4: no products and no split pass: the wgmma body's copies
alone; the tile body has no split pass, so it is its no_products),
``products_alone`` (5: no copies and no split pass, the products with
their A loads) and ``bare_products`` (6: nor the A loads), and times the
reduction of a pair's stored rows at B = 128, T = ``--T``, at H (default
128, 1024 and 2048), both conventions, in turns, on the body the library's
``gru_dwh_body`` picks. The phases, in ms: the two extra products of
3xTF32 = full - one_product, one product = one_product - no_products (A
fragments, splits, MMAs); on the wgmma body copies alone = no_split, split
pass alone = no_copies, copies and split pass together = no_products,
products alone with and without their A loads = products_alone,
bare_products; on the tile body copies = no_products - no_copies, rest =
no_copies (the ring's waits and barriers, the partials' writes, dbh). One
JSON line per (convention, H) with the body, the split count, the rate of
the float32 product, the share of the bound (three TF32 products at 495
TFLOP/s) and the host's issue time of one launch (the wgmma body encodes
its tensor maps there). With ``--against PATH`` it builds ``gru_dwh.cu``
as it is and from PATH (another version with the same C interface, an
older one from `git archive` of a commit before the wgmma body among them)
and times the two in turns instead, each on its own dispatch, with the
largest distance between their dwh relative to its largest entry.

``--l2-source PATH`` (with ``--body grid``) also builds the wide body from
PATH, a ``gru_wide.cu`` that still has the L2 tier the grid body replaced
(above H = 512; the parent of the commit that retired it), and times its
pair forward at B = 1, T = ``--T``, and its pair residual forward and
backward chain at B = 128 over ``--l2-T`` steps (16: the tier reads all of
wh for each row at each step), in turns with the grid body at the same
shapes; times also in ms a step.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.kernels import gru_scan as gs

GRID_VARIANTS = {"full": (), "no_barrier": ("-DGRU_GRID_CUT=1",),
                 "no_products": ("-DGRU_GRID_CUT=2",), "no_loads": ("-DGRU_GRID_CUT=3",)}
VARIANTS = {"full": (), "no_exchange": ("-DGRU_CLUSTER_CUT=1",),
            "no_products": ("-DGRU_CLUSTER_CUT=2",), "no_staging": ("-DGRU_CLUSTER_CUT=3",),
            "threads512": ("-DGRU_CLUSTER_MAX_THREADS=512",)}
CUTS = ("full", "no_exchange", "no_products", "no_staging")
DWH_VARIANTS = {"full": (), "one_product": ("-DGRU_DWH_CUT=1",),
                "no_products": ("-DGRU_DWH_CUT=2",), "no_copies": ("-DGRU_DWH_CUT=3",),
                "no_split": ("-DGRU_DWH_CUT=4",), "products_alone": ("-DGRU_DWH_CUT=5",),
                "bare_products": ("-DGRU_DWH_CUT=6",)}
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 on the tensor cores
DWH_WIDTHS = (128, 1024, 2048)
BATCHES = (1, 128)
AGAINST_BATCHES = (1, 8, 16)
CTAS = (4, 8, 16)
REPS = 10


def build_variants(source: str = "gru_cluster", variants: dict = VARIANTS, bind=None,
                   extra: dict = None) -> dict:
    """One library per variant of ``csrc/<source>.cu`` under
    ``build/gru_phases/`` (and one per ``extra`` {name: source path}), every
    ``nvcc`` started before any is waited for: {variant: CDLL, bound by
    ``bind``}; their ptxas lines in ``build_variants.ptxas``."""
    out_dir = _build.BUILD_DIR.parent / "gru_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: (flags, _build.CSRC_DIR / f"{source}.cu") for name, flags in variants.items()}
    jobs.update({name: ((), path) for name, path in (extra or {}).items()})
    procs = {}
    for name, (flags, src) in jobs.items():
        lib = out_dir / f"lib{source}_{name}.so"
        procs[name] = lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{out}")
        cdll = ctypes.CDLL(str(lib))
        libs[name] = (bind or gs.bind_cluster)(cdll) if name in variants else cdll
        ptxas[name] = [ln.split(":", 1)[-1].strip() for ln in out.splitlines()
                       if "registers" in ln or "spill" in ln]
    build_variants.ptxas = ptxas
    return libs


def cuda_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _operands(rng, B: int, T: int, H: int, dev) -> list:
    """Both directions' (xp, wh, bh, h0, dys, dhl), wh scaled by 1 / sqrt(H)."""
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    return [(t(rng.standard_normal((B, T, 3 * H))), t(rng.standard_normal((H, 3 * H)) / H ** 0.5),
             t(0.1 * rng.standard_normal(3 * H)), t(0.5 * rng.standard_normal((B, H))),
             t(rng.standard_normal((B, T, H))), t(rng.standard_normal((B, H)))) for _ in range(2)]


def _pair_args(ops, reset_after: bool):
    """The launchers' direction arrays over ``ops`` with outputs allocated
    once: ``(B, T, H, fwd, bwd, buffers)`` (keep ``buffers`` alive)."""
    B, T, H3 = ops[0][0].shape
    H = H3 // 3
    RW = gs.res_width(reset_after, H)
    dev = ops[0][0].device
    ys = [torch.zeros((B, T, H), device=dev) for _ in ops]
    res = [torch.zeros((B, T, RW), device=dev) for _ in ops]
    hl = [torch.empty((B, H), device=dev) for _ in ops]
    dxp = [torch.empty((B, T, 3 * H), device=dev) for _ in ops]
    dh0 = [torch.empty((B, H), device=dev) for _ in ops]
    fwd = (gs._FwdDir * 2)(*(gs._FwdDir(o[0].data_ptr(), o[1].data_ptr(), o[2].data_ptr(),
                                        o[3].data_ptr(), y.data_ptr(), r.data_ptr(), h.data_ptr(), k)
                             for k, (o, y, r, h) in enumerate(zip(ops, ys, res, hl))))
    bwd = (gs._BwdDir * 2)(*(gs._BwdDir(y.data_ptr(), r.data_ptr(), o[1].data_ptr(),
                                        o[3].data_ptr(), o[4].data_ptr(), o[5].data_ptr(),
                                        d.data_ptr(), d0.data_ptr(), k)
                             for k, (o, y, r, d, d0) in enumerate(zip(ops, ys, res, dxp, dh0))))
    return B, T, H, fwd, bwd, (ys, res, hl, dxp, dh0)


def launchers(ops, reset_after: bool, ctas: int):
    """(forward, chain) closures over ``ops`` that launch a given library's
    residual forward and backward chain of both directions, C = ``ctas``."""
    B, T, H, fwd, bwd, buffers = _pair_args(ops, reset_after)
    stream = torch.cuda.current_stream().cuda_stream

    def forward(lib):
        gs._raise_on(lib.gru_cluster_fwd_launch(fwd, 2, 1, B, T, H, int(reset_after), 0, 1, ctas,
                                                stream), "gru_cluster_fwd",
                     lib.gru_cluster_error_string)

    def chain(lib):
        gs._raise_on(lib.gru_cluster_bwd_launch(bwd, 2, 1, B, T, H, int(reset_after), 0, ctas,
                                                stream), "gru_cluster_bwd",
                     lib.gru_cluster_error_string)

    forward.buffers = chain.buffers = buffers
    return forward, chain


def _in_turns(libs: dict, fn) -> dict:
    """ms per call of ``fn(lib)`` for each library, every one then every one
    in reverse order."""
    ms = {}
    order = list(libs)
    for name in order + order[::-1]:
        ms.setdefault(name, []).append(cuda_ms(lambda: fn(libs[name])))
    return ms



def grid_launchers(ops, reset_after: bool):
    """(forward, chain) closures over ``ops`` that launch a given grid
    library's residual forward and backward chain of both directions, each
    with its own device scratch."""
    B, T, H, fwd, bwd, buffers = _pair_args(ops, reset_after)
    scratch = {bw: torch.empty(gs.grid_scratch_floats(2, B, H, bw), device=ops[0][0].device)
               for bw in (False, True)}
    stream = torch.cuda.current_stream().cuda_stream

    def forward(lib, with_res: int = 1):
        gs._raise_on(lib.gru_grid_fwd_launch(fwd, 2, 1, B, T, H, int(reset_after), 0, with_res, 0,
                                             scratch[False].data_ptr(), stream),
                     "gru_grid_fwd", lib.gru_grid_error_string)

    def chain(lib):
        gs._raise_on(lib.gru_grid_bwd_launch(bwd, 2, 1, B, T, H, int(reset_after), 0, 0,
                                             scratch[True].data_ptr(), stream),
                     "gru_grid_bwd", lib.gru_grid_error_string)

    forward.buffers = chain.buffers = (buffers, scratch)
    return forward, chain


def l2_launchers(lib, ops, reset_after: bool):
    """(forward, residual forward, chain) closures that launch the retired
    L2 tier of a wide-body library built from an older ``gru_wide.cu`` (its
    launchers still take a scratch of ``gru_wide_scratch_floats``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gru_wide_scratch_floats.argtypes = [i] * 5
    lib.gru_wide_scratch_floats.restype = ctypes.c_longlong
    lib.gru_wide_fwd_launch.argtypes = [ctypes.POINTER(gs._FwdDir)] + [i] * 8 + [p, p]
    lib.gru_wide_fwd_launch.restype = i
    lib.gru_wide_bwd_launch.argtypes = [ctypes.POINTER(gs._BwdDir)] + [i] * 7 + [p, p]
    lib.gru_wide_bwd_launch.restype = i
    lib.gru_wide_error_string.argtypes = [i]
    lib.gru_wide_error_string.restype = ctypes.c_char_p
    B, T, H, fwd, bwd, buffers = _pair_args(ops, reset_after)
    scratch = {bw: torch.empty(lib.gru_wide_scratch_floats(2, 1, B, H, bw),
                               device=ops[0][0].device)
               for bw in (0, 1)}
    stream = torch.cuda.current_stream().cuda_stream

    def launch_fwd(with_res):
        gs._raise_on(lib.gru_wide_fwd_launch(fwd, 2, 1, B, T, H, int(reset_after), 0, with_res,
                                             scratch[0].data_ptr(), stream),
                     "gru_wide_fwd (L2 tier)", lib.gru_wide_error_string)

    def launch_chain():
        gs._raise_on(lib.gru_wide_bwd_launch(bwd, 2, 1, B, T, H, int(reset_after), 0,
                                             scratch[1].data_ptr(), stream),
                     "gru_wide_bwd (L2 tier)", lib.gru_wide_error_string)

    launch_fwd.buffers = launch_chain.buffers = (buffers, scratch)
    return (lambda: launch_fwd(0)), (lambda: launch_fwd(1)), launch_chain


def grid_against(H: int, T: int, source: str) -> int:
    """``--body grid --against PATH``: this grid body and the one built from
    PATH, a pair's forward, residual forward and chain in turns."""
    libs = build_variants("gru_grid", {"this": ()}, gs.bind_grid, {"other": source})
    libs["other"] = gs.bind_grid(libs["other"])
    device = torch.cuda.get_device_name(0)
    print(json.dumps({"ptxas": build_variants.ptxas, "device": device}), flush=True)
    rng = np.random.default_rng(35)
    for reset_after in (True, False):
        for B in AGAINST_BATCHES:
            ops = _operands(rng, B, T, H, torch.device("cuda"))
            forward, chain = grid_launchers(ops, reset_after)
            outs = {}
            for name, lib in libs.items():
                forward(lib)
                chain(lib)
                torch.cuda.synchronize()
                outs[name] = [t.clone() for group in forward.buffers[0] for t in group]
            line = {"body": "grid against", "H": H, "T": T, "B": B, "reset_after": reset_after,
                    "device": device, "source": source,
                    "same_bits": all(torch.equal(a, b) for a, b in zip(*outs.values())),
                    "plans": {n: [gs.grid_plan_card(2, 1, B, H, bw, True, lib=lib)
                                  for bw in (False, True)] for n, lib in libs.items()}}
            for kind, fn in (("forward", lambda lib: forward(lib, 0)),
                             ("residual_forward", forward), ("chain", chain)):
                ms = _in_turns(libs, fn)
                line[f"{kind}_ms"] = ms
                line[f"{kind}_us_a_step"] = {k: float(np.mean(v)) * 1e3 / T for k, v in ms.items()}
            print(json.dumps(line), flush=True)
    return 0


def grid_main(H: int, T: int, l2_source: str, l2_T: int) -> int:
    """``--body grid``: the grid body's phases, and the retired L2 tier in
    turns with it when ``l2_source`` names an older ``gru_wide.cu``."""
    extra = {"l2": l2_source} if l2_source else None
    libs = build_variants("gru_grid", GRID_VARIANTS, gs.bind_grid, extra)
    l2 = libs.pop("l2", None)
    device = torch.cuda.get_device_name(0)
    print(json.dumps({"ptxas": build_variants.ptxas, "device": device}), flush=True)
    rng = np.random.default_rng(32)
    cuts = tuple(GRID_VARIANTS)
    for reset_after in (True, False):
        for B in BATCHES:
            ops = _operands(rng, B, T, H, torch.device("cuda"))
            forward, chain = grid_launchers(ops, reset_after)
            line = {"body": "grid", "H": H, "T": T, "B": B, "reset_after": reset_after,
                    "device": device,
                    "plans": {k: gs.grid_plan_card(2, 1, B, H, k == "chain", True,
                                                   lib=libs["full"]) for k in ("forward", "chain")}}
            for kind, fn in (("forward", forward), ("chain", chain)):
                ms = _in_turns(libs, fn)
                mean = {k: float(np.mean(v)) for k, v in ms.items()}
                us = {k: v * 1e3 / T for k, v in mean.items()}
                line[f"{kind}_ms"] = ms
                line[f"{kind}_us_a_step"] = {
                    "full": us[cuts[0]], "exchange_barrier": us["full"] - us["no_barrier"],
                    "products": us["no_barrier"] - us["no_products"],
                    "tile_loads": us["no_products"] - us["no_loads"], "rest": us["no_loads"]}
            print(json.dumps(line), flush=True)
    if l2 is None:
        return 0
    for B, steps in ((1, T), (128, l2_T)):
        ops = _operands(rng, B, steps, H, torch.device("cuda"))
        forward, chain = grid_launchers(ops, True)
        l2_fwd, l2_fres, l2_chain = l2_launchers(l2, ops, True)
        fns = {"grid": {"forward": lambda: forward(libs["full"]),
                        "chain": lambda: chain(libs["full"])},
               "l2": {"forward": l2_fres if B > 1 else l2_fwd, "chain": l2_chain}}
        line = {"body": "l2 tier vs grid", "H": H, "T": steps, "B": B, "reset_after": True,
                "device": device}
        kinds = ("forward", "chain") if B > 1 else ("forward",)
        for kind in kinds:
            ms = {}
            for name in ("grid", "l2", "l2", "grid"):
                ms.setdefault(name, []).append(cuda_ms(fns[name][kind], reps=2, warmup=1))
            line[f"{kind}_ms"] = ms
            line[f"{kind}_ms_a_step"] = {k: float(np.mean(v)) / steps for k, v in ms.items()}
        print(json.dumps(line), flush=True)
    return 0


def host_issue_ms(fn, reps: int = REPS) -> float:
    """Host ms per call of ``fn`` that launches work on the card without
    waiting for it: the issue alone (the card idle before, the calls far
    fewer than the launch queue holds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def _dwh_phases(body: str, mean: dict) -> dict:
    """The reduction's phases in ms from its cuts' mean times."""
    out = {"full": mean["full"], "two_more_products": mean["full"] - mean["one_product"],
           "one_product": mean["one_product"] - mean["no_products"]}
    if body == "wgmma":
        out.update({"copies_alone": mean["no_split"], "split_pass_alone": mean["no_copies"],
                    "copies_and_split": mean["no_products"],
                    "products_alone": mean["products_alone"],
                    "bare_products": mean["bare_products"]})
    else:
        out.update({"copies": mean["no_products"] - mean["no_copies"], "rest": mean["no_copies"]})
    return out


def dwh_main(H: int, T: int, against: str = "") -> int:
    """``--body dwh``: csrc/gru_dwh.cu's phases, by its profiling cuts, or
    this version in turns with the one at ``against``."""
    if against:
        libs = build_variants("gru_dwh", {"this": ()}, gs.bind_dwh, {"other": against})
        libs["other"] = gs.bind_dwh(libs["other"])
    else:
        libs = build_variants("gru_dwh", DWH_VARIANTS, gs.bind_dwh)
    first = next(iter(libs.values()))
    device = torch.cuda.get_device_name(0)
    print(json.dumps({"ptxas": build_variants.ptxas, "device": device}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(36)
    B = BATCHES[-1]
    stream = torch.cuda.current_stream().cuda_stream
    for H in (H,) if H else DWH_WIDTHS:
        for reset_after in (True, False):
            dev = torch.device("cuda")
            randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
            ops = [(torch.tanh(randn(B, T, H)),
                    torch.rand((B, T, gs.res_width(reset_after, H)), generator=gen, device=dev),
                    0.5 * randn(B, H), randn(B, T, 3 * H)) for _ in range(2)]
            n_part = first.gru_dwh_splits(B, T, H)
            part = torch.empty((2, 1, n_part, 3 * H * H + 3 * H), device=dev)
            arr = (gs._DwhDir * 2)(*(gs._DwhDir(y.data_ptr(), r.data_ptr(), h.data_ptr(),
                                                x.data_ptr(), part[k].data_ptr(), k)
                                     for k, (y, r, h, x) in enumerate(ops)))
            on = gs.DWH_BODIES[first.gru_dwh_body(arr, 2, H)]

            def launch(lib):
                gs._raise_on(lib.gru_dwh_launch(arr, 2, 1, B, T, H, int(reset_after), stream),
                             "gru_dwh", lib.gru_dwh_error_string)

            ms = _in_turns(libs, launch)
            mean = {k: float(np.mean(v)) for k, v in ms.items()}
            host = {k: host_issue_ms(lambda lib=lib: launch(lib)) for k, lib in libs.items()}
            if against:
                outs = {}
                for name, lib in libs.items():
                    launch(lib)
                    torch.cuda.synchronize()
                    outs[name] = part.sum(dim=2)
                scale = float(outs["this"].abs().max())
                print(json.dumps({
                    "body": "dwh against", "H": H, "T": T, "B": B,
                    "reset_after": reset_after, "device": device, "source": against,
                    "ms": ms, "mean_ms": mean, "host_issue_ms": host,
                    "rel_diff": float((outs["this"] - outs["other"]).abs().max()) / scale}),
                    flush=True)
                del ops, part, outs
                torch.cuda.empty_cache()
                continue
            flops = 2 * 2 * B * T * H * 3 * H
            print(json.dumps({
                "body": "dwh", "dwh_body": on, "H": H, "T": T, "B": B,
                "reset_after": reset_after, "device": device, "splits": n_part, "ms": ms,
                "host_issue_ms": host["full"], "tflops": flops / mean["full"] / 1e9,
                "bound_share": 3 * flops / PEAK_TF32_FLOPS * 1e3 / mean["full"],
                "phases_ms": _dwh_phases(on, mean)}), flush=True)
            del ops, part
            torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--body", choices=("cluster", "grid", "dwh"), default="cluster")
    ap.add_argument("--H", type=int, default=None)
    ap.add_argument("--T", type=int, default=256)
    ap.add_argument("--l2-source", default=None)
    ap.add_argument("--l2-T", type=int, default=16)
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gru_phases: a CUDA card is required", file=sys.stderr)
        return 2
    if args.body == "dwh":
        return dwh_main(args.H, args.T, args.against or "")
    if args.body == "grid" and args.against:
        return grid_against(args.H or 1024, args.T, args.against)
    if args.body == "grid":
        return grid_main(args.H or 1024, args.T, args.l2_source, args.l2_T)
    H, T = args.H or 256, args.T
    libs = build_variants()
    device = torch.cuda.get_device_name(0)
    print(json.dumps({"ptxas": build_variants.ptxas, "device": device}), flush=True)
    rng = np.random.default_rng(31)
    for reset_after in (True, False):
        for B in BATCHES:
            ops = _operands(rng, B, T, H, torch.device("cuda"))
            for C in CTAS:
                usable = {n: lib for n, lib in libs.items()
                          if all(lib.gru_cluster_plan(2, 1, B, H, bwd, 1, C,
                                                      (ctypes.c_longlong * 4)()) == 0
                                 for bwd in (0, 1))}
                forward, chain = launchers(ops, reset_after, C)
                line = {"H": H, "T": T, "B": B, "reset_after": reset_after, "ctas": C,
                        "rule_ctas": gs.cluster_ctas(H), "plans": {}, "device": device}
                for name, lib in usable.items():
                    line["plans"][name] = [_plan(lib, B, H, bwd, C) for bwd in (False, True)]
                for kind, fn in (("forward", forward), ("chain", chain)):
                    ms = _in_turns(usable, fn)
                    mean = {k: float(np.mean(v)) for k, v in ms.items()}
                    line[f"{kind}_ms"] = ms
                    if all(c in mean for c in CUTS):
                        us = {k: v * 1e3 / T for k, v in mean.items()}
                        line[f"{kind}_us_a_step"] = {
                            "full": us["full"],
                            "exchange": us["full"] - us["no_exchange"],
                            "products": us["no_exchange"] - us["no_products"],
                            "staging": us["no_products"] - us["no_staging"],
                            "rest": us["no_staging"]}
                print(json.dumps(line), flush=True)
    return 0


def _plan(lib, B: int, H: int, backward: bool, ctas: int) -> dict:
    out = (ctypes.c_longlong * 4)()
    gs._raise_on(lib.gru_cluster_plan(2, 1, B, H, int(backward), 1, ctas, out),
                 "gru_cluster_plan", lib.gru_cluster_error_string)
    return dict(zip(("ctas", "rows", "threads", "smem"), (int(v) for v in out)))


if __name__ == "__main__":
    sys.exit(main())
