"""Where the time of kernel B's cluster tier goes, phase by phase, and its
cluster size, on one CUDA card.

    python3 -m sed_crnn_torch.tools.gru_phases [--H 256] [--T 256]

from the root of a checkout. Builds ``sed_crnn_torch/csrc/gru_cluster.cu`` as
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
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.kernels import gru_scan as gs

VARIANTS = {"full": (), "no_exchange": ("-DGRU_CLUSTER_CUT=1",),
            "no_products": ("-DGRU_CLUSTER_CUT=2",), "no_staging": ("-DGRU_CLUSTER_CUT=3",),
            "threads512": ("-DGRU_CLUSTER_MAX_THREADS=512",)}
CUTS = ("full", "no_exchange", "no_products", "no_staging")
BATCHES = (1, 128)
CTAS = (4, 8, 16)
REPS = 10


def build_variants() -> dict:
    """One library per variant under ``build/gru_phases/``, every ``nvcc``
    started before any is waited for: {variant: bound CDLL}; their ptxas
    lines in ``build_variants.ptxas``."""
    out_dir = _build.BUILD_DIR.parent / "gru_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out_dir / f"libgru_cluster_{name}.so"
        procs[name] = lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(_build.CSRC_DIR / "gru_cluster.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{out}")
        libs[name] = gs.bind_cluster(ctypes.CDLL(str(lib)))
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


def launchers(ops, reset_after: bool, ctas: int):
    """(forward, chain) closures over ``ops`` that launch a given library's
    residual forward and backward chain of both directions, C = ``ctas``."""
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
    stream = torch.cuda.current_stream().cuda_stream

    def forward(lib):
        gs._raise_on(lib.gru_cluster_fwd_launch(fwd, 2, 1, B, T, H, int(reset_after), 0, 1, ctas,
                                                stream), "gru_cluster_fwd",
                     lib.gru_cluster_error_string)

    def chain(lib):
        gs._raise_on(lib.gru_cluster_bwd_launch(bwd, 2, 1, B, T, H, int(reset_after), 0, ctas,
                                                stream), "gru_cluster_bwd",
                     lib.gru_cluster_error_string)

    return forward, chain


def _in_turns(libs: dict, fn) -> dict:
    """ms per call of ``fn(lib)`` for each library, every one then every one
    in reverse order."""
    ms = {}
    order = list(libs)
    for name in order + order[::-1]:
        ms.setdefault(name, []).append(cuda_ms(lambda: fn(libs[name])))
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--H", type=int, default=256)
    ap.add_argument("--T", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gru_phases: a CUDA card is required", file=sys.stderr)
        return 2
    H, T = args.H, args.T
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
