"""Where the time of kernel A's mixed and cluster bodies goes, phase by
phase, on one CUDA card, and the weights of `mixed_plan`'s cost model.

    python3 -m sed_crnn_torch.tools.logmel_phases [--body mixed|cluster|both]
                                                  [--against OTHER_CHECKOUT]
                                                  [--sizes N_FFT ...]

from the root of a checkout. Builds ``sed_crnn_torch/csrc/logmel_mixed.cu``
and ``logmel_cluster.cu`` as they are and with each of their profiling cuts
(``-DLOGMEL_MIXED_CUT=k`` / ``-DLOGMEL_CLUSTER_CUT=k``: the source leaves out
the later phases of a frame, and the results are no longer right), all
``nvcc`` runs started together, times each with CUDA events on 150 s of
noise (seed 9) uncentred, and prints one JSON line per size and plan: ms per
launch of each variant, in turns (every variant, then every variant in
reverse order).

The mixed body's variants: ``full``; ``no_mel`` (cut 1: without the mel
sums); ``no_power`` (2: nor the bins' power); ``no_matrix`` (3: nor the
matrix stages, a Rader stage's inner ones too); ``no_rader`` (4: nor the
Rader stage: its gather, inner register stages and product);
``no_bluestein`` (5: nor Bluestein's filter product and second transform);
``no_stages`` (6: nor the register stages: what is left is the load). Its
phases are the differences: mel = full - no_mel, power = no_mel -
no_power, matrix = no_power - no_matrix, rader = no_matrix - no_rader,
bluestein = no_rader - no_bluestein, register = no_bluestein - no_stages.
Each of `MIXED_SIZES` runs its plan and each other plan (`mixed_plan` with
its ``plan`` forced to each of `PLAN_KINDS`) that fits one block.

The cluster body's variants: ``full``, ``no_mel`` (1), ``no_power`` (2),
``no_matrix`` (3), ``no_rader`` (4), ``no_stages`` (5: nor the register
stages; left: the load, the Bluestein filter product and the barriers):
mel, power, matrix, rader and register as above.

Then each mixed size's time with its mel sums on 4, 8, 16 and 32 lanes a
band (the body picks `mel_group`) and with the wide instantiations forced
to 1 and 2 blocks an SM (``-DLOGMEL_WIDE_BLOCKS``; the body picks by
shared memory). Last, a least-squares fit of `plan_cost`'s weights
(``COST_REGISTER``, ``COST_MATRIX``: ns a frame on one SM, i.e. ms x 1e6 x
the card's SMs / frames) to the mixed body's transform time (no_power -
no_stages) of every plan timed, against each plan's `plan_counts`,
non-negative, with each plan's error; and of ``COST_CLUSTER``, the cluster
body's stage time (no_power - no_stages) over what the fitted weights give
its plans' counts.

With ``--against`` (the root of another checkout, e.g. an unpacked ``git
archive`` of the parent commit under the git-ignored ``build/``): that
checkout's ``ops/kernels/fused_logmel.py`` and its three log-mel sources
built beside this tree's, and both trees' `fused_log_mel` timed in turns
(this, other, other, this) at every size above and at the FFT body's 1024,
2048 and 4096, with whether their bits agree; one JSON line a size.

With ``--sizes``, only those n_fft are timed, in every part: a size of the
lists above (`FFT_SIZES`, `MIXED_SIZES`, `SIZES`) at its hop, any other at
hop n_fft / 2, each in the part of the body `body` gives it; the fit then
rests on their plans alone.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.kernels import fused_logmel as fl

MIXED_VARIANTS = {"full": 0, "no_mel": 1, "no_power": 2, "no_matrix": 3, "no_rader": 4,
                  "no_bluestein": 5, "no_stages": 6}
VARIANTS = {"full": 0, "no_mel": 1, "no_power": 2, "no_matrix": 3, "no_rader": 4,
            "no_stages": 5}   # the cluster body's
MIXED_SIZES = ((1001, 500), (1034, 517), (1102, 551), (1103, 551), (1764, 882), (2206, 1103),
               (3072, 1024), (12865, 6432), (12867, 6433), (23042, 11521), (23044, 11522),
               (23054, 11527))
SIZES = ((25734, 12867), (31290, 15645), (44100, 22050), (48000, 24000), (88200, 44100))
# The plans forced beside each size's own (`mixed_plan`'s ``plan``).
FORCED = tuple({"plan": k} for k in fl.PLAN_KINDS)
# The wide instantiations' blocks an SM, forced (the body picks 2 where two
# blocks' shared memory fits an SM, else 1), and the mel group widths.
WIDE_BLOCKS = {"wide_blocks_1": 1, "wide_blocks_2": 2}
MEL_GROUPS = (4, 8, 16, 32)
SECONDS = 150.0
REPS = 10
BODIES = {"mixed": ("logmel_mixed", "LOGMEL_MIXED_CUT", MIXED_VARIANTS),
          "cluster": ("logmel_cluster", "LOGMEL_CLUSTER_CUT", VARIANTS)}


def build_variants(bodies=("mixed", "cluster")) -> dict:
    """One library per body and variant under ``build/logmel_phases/``, every
    ``nvcc`` started before any is waited for: {body: {variant: CDLL}}; the
    mixed body's also at each of `WIDE_BLOCKS`."""
    out_dir = _build.BUILD_DIR.parent / "logmel_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = {(b, name): f"-D{BODIES[b][1]}={cut}" for b in bodies
             for name, cut in BODIES[b][2].items()}
    if "mixed" in bodies:
        flags.update({("mixed", name): f"-DLOGMEL_WIDE_BLOCKS={n}"
                      for name, n in WIDE_BLOCKS.items()})
    procs = {}
    for (b, name), flag in flags.items():
        lib = out_dir / f"lib{b}_{name}.so"
        procs[b, name] = lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, flag, "-o", str(lib),
             str(_build.CSRC_DIR / f"{BODIES[b][0]}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {b: {} for b in bodies}
    ptxas = {}
    for (b, name), (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {b} {name} variant:\n{out}")
        libs[b][name] = ctypes.CDLL(str(lib))
        ptxas[b, name] = [ln.split(":", 1)[-1].strip() for ln in out.splitlines()
                          if "registers" in ln or "spill" in ln]
    build_variants.ptxas = ptxas
    return libs


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
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


def _time_variants(libs: dict, source: str, launch) -> dict:
    """ms per call of ``launch`` with each variant's library of ``source``,
    in turns."""
    ms = {}
    order = list(libs)
    load = _build.load
    try:
        for name in order + order[::-1]:
            fl._mixed_lib.cache_clear()
            fl._cluster_lib.cache_clear()
            _build.load = lambda n, lib=libs[name]: lib if n == source else load(n)
            ms.setdefault(name, []).append(cuda_ms(launch))
    finally:
        _build.load = load
        fl._mixed_lib.cache_clear()
        fl._cluster_lib.cache_clear()
    return ms


def _mean(ms: dict) -> dict:
    return {k: float(np.mean(v)) for k, v in ms.items()}


AGAINST_SOURCES = ("logmel_fft", "logmel_mixed", "logmel_cluster")
FFT_SIZES = ((1024, 512), (2048, 1024), (4096, 2048))


def against(root: str, y: torch.Tensor, device: str, sizes=FFT_SIZES + MIXED_SIZES + SIZES
            ) -> None:
    """This tree's kernel A against another checkout's, in turns, at every
    size the tool times: the other's ``fused_logmel.py`` loaded as a module
    of its own, its sources built (all ``nvcc`` runs started together)
    under ``build/logmel_phases/against/``; one JSON line a size with both
    plans, ms a launch of each (this, other, other, this) and whether the
    two outputs are bitwise equal."""
    other = Path(root).resolve()
    out_dir = _build.BUILD_DIR.parent / "logmel_phases" / "against"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{n}.so"),
         str(other / "sed_crnn_torch" / "csrc" / f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for n in AGAINST_SOURCES}
    libs = {}
    for n, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the other checkout's {n}.cu:\n{text}")
        libs[n] = ctypes.CDLL(str(out_dir / f"lib{n}.so"))
    spec = importlib.util.spec_from_file_location(
        "fused_logmel_against", other / "sed_crnn_torch" / "ops" / "kernels" / "fused_logmel.py")
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    theirs._build = types.SimpleNamespace(load=lambda n: libs[n])
    for n_fft, hop in sizes:
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
        fns = {"this": lambda: fl.fused_log_mel(y, cfg),
               "other": lambda: theirs.fused_log_mel(y, cfg)}
        same = torch.equal(fns["this"](), fns["other"]())
        ms = {k: [] for k in fns}
        for k in ("this", "other", "other", "this"):
            ms[k].append(cuda_ms(fns[k]))
        plans = {name: (mod.mixed_plan(n_fft).radices if mod.body(n_fft) != "fft" else "fft")
                 for name, mod in (("this", fl), ("other", theirs))}
        print(json.dumps({"against": str(other), "n_fft": n_fft, "hop": hop, "plans": plans,
                          "bitwise_equal": same, "ms": ms, "device": device}), flush=True)


def _timeable(n_fft: int) -> bool:
    """A body of kernel A takes n_fft, at hop n_fft / 2 >= 1."""
    try:
        return n_fft >= 2 and (fl.body(n_fft) != "cluster" or fl.cluster_size(n_fft) > 0)
    except ValueError:      # beyond the cluster body's limit
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--body", choices=("mixed", "cluster", "both"), default="both")
    ap.add_argument("--against", default="",
                    help="the root of another checkout to time in turns with this one")
    ap.add_argument("--sizes", type=int, nargs="+", default=None,
                    help="time only these n_fft (hop n_fft / 2 where the lists name none)")
    args = ap.parse_args(argv)
    known = FFT_SIZES + MIXED_SIZES + SIZES
    if args.sizes is not None:
        hops = dict(known)
        known = tuple((n, hops.get(n, n // 2)) for n in dict.fromkeys(args.sizes))
        refused = [n for n, _ in known if not _timeable(n)]
        if refused:
            ap.error(f"--sizes {refused}: no body of kernel A takes them")
    mixed_sizes, sizes = [[s for s in known if fl.body(s[0]) == b] for b in ("mixed", "cluster")]
    if not torch.cuda.is_available():
        print("logmel_phases: a CUDA card is required", file=sys.stderr)
        return 2
    bodies = ("mixed", "cluster") if args.body == "both" else (args.body,)
    libs = build_variants(bodies)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(9)
    y = torch.from_numpy((0.1 * rng.standard_normal(int(SECONDS * FrontendConfig().sample_rate)))
                         .astype(np.float32)).to(dev)
    device = torch.cuda.get_device_name(0)
    fit_rows, fit_ns = [], []
    fit = {"COST_REGISTER": fl.COST_REGISTER}
    cluster_ns = cluster_points = 0.0
    if "mixed" in bodies:
        wide = {k: libs["mixed"].pop(k) for k in WIDE_BLOCKS}
        print(json.dumps({"ptxas": {f"{b} {k}": v for (b, k), v in build_variants.ptxas.items()
                                    if k in ("full",) + tuple(WIDE_BLOCKS)}}), flush=True)
        for n_fft, hop in mixed_sizes:
            cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
            src, n_frames = fl.frame_source(y, cfg)
            seen = []
            for forced in ({},) + FORCED:
                try:
                    plan = fl.mixed_plan(n_fft, **forced)
                except ValueError:      # no such plan
                    continue
                if plan in seen or plan.smem_bytes > fl.MIXED_MAX_SMEM:
                    continue
                seen.append(plan)
                ms = _time_variants(libs["mixed"], "logmel_mixed", lambda: fl._launch_mixed(
                    src, hop, n_frames, n_fft, cfg, **forced))
                m = _mean(ms)
                phases = {"mel": m["full"] - m["no_mel"], "power": m["no_mel"] - m["no_power"],
                          "matrix": m["no_power"] - m["no_matrix"],
                          "rader": m["no_matrix"] - m["no_rader"],
                          "bluestein": m["no_rader"] - m["no_bluestein"],
                          "register": m["no_bluestein"] - m["no_stages"],
                          "rest": m["no_stages"]}
                counts = fl.plan_counts(plan.n, plan.radices, plan.bluestein, plan.rader)
                fit_rows.append(counts)
                fit_ns.append((m["no_power"] - m["no_stages"]) * 1e6 * sms / n_frames)
                print(json.dumps({"body": "mixed", "n_fft": n_fft, "hop": hop,
                                  "frames": n_frames, "radices": plan.radices,
                                  "kinds": plan.kinds, "rader": plan.rader,
                                  "bluestein": plan.bluestein, "chosen": not forced,
                                  "forced": forced, "ms": ms, "phases_ms": phases,
                                  "counts": list(counts), "model": fl.plan_cost(
                                      plan.n, plan.radices, plan.bluestein, rader=plan.rader),
                                  "device": device}), flush=True)
        # The band's lanes and the wide instantiations' blocks an SM, each
        # against the body's own choice, on the full library.
        for n_fft, hop in mixed_sizes:
            cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
            src, n_frames = fl.frame_source(y, cfg)
            groups = {}
            for g in MEL_GROUPS + MEL_GROUPS[::-1]:
                groups.setdefault(g, []).append(cuda_ms(lambda: fl._launch_mixed(
                    src, hop, n_frames, n_fft, cfg, group=g)))
            blocks = _time_variants({"chosen": libs["mixed"]["full"], **wide}, "logmel_mixed",
                                    lambda: fl._launch_mixed(src, hop, n_frames, n_fft, cfg))
            print(json.dumps({"body": "mixed", "n_fft": n_fft, "hop": hop, "frames": n_frames,
                              "mel_group": fl._operands(cfg, n_fft, "mixed", dev)["mel_group"],
                              "mel_group_ms": groups, "blocks_ms": blocks,
                              "wide": bool(set(fl.mixed_plan(n_fft).radices) - {2, 3, 4, 5, 7}),
                              "device": device}), flush=True)
        if fit_rows:      # --sizes may leave the mixed body nothing to fit
            from scipy.optimize import nnls

            w, _ = nnls(np.array(fit_rows, float), np.array(fit_ns))
            fit["COST_REGISTER"], fit["COST_MATRIX"] = w[0], w[1]
            errors = [float(np.dot(w, r)) / t - 1.0 for r, t in zip(fit_rows, fit_ns)]
            print(json.dumps({"fit": {"COST_REGISTER": w[0], "COST_MATRIX": w[1]},
                              "in_use": {"COST_REGISTER": fl.COST_REGISTER,
                                         "COST_MATRIX": fl.COST_MATRIX},
                              "measured_vs_fit_ns": [
                                  [r, round(t, 1), round(float(np.dot(w, r)), 1)]
                                  for r, t in zip(fit_rows, fit_ns)],
                              "largest_error": max(errors, key=abs), "rows": len(fit_rows),
                              "sms": sms, "device": device}), flush=True)
    if "cluster" in bodies:
        fit.setdefault("COST_MATRIX", fl.COST_MATRIX)
        for n_fft, hop in sizes:
            cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
            src, n_frames = fl.frame_source(y, cfg)
            ms = _time_variants(libs["cluster"], "logmel_cluster", lambda: fl._launch_cluster(
                src, hop, n_frames, n_fft, cfg))
            m = _mean(ms)
            plan = fl.mixed_plan(n_fft)
            reg, mat = fl.plan_counts(plan.n, plan.radices, plan.bluestein, plan.rader)
            cluster_ns += (m["no_power"] - m["no_stages"]) * 1e6 * sms / n_frames
            cluster_points += fit["COST_REGISTER"] * reg + fit["COST_MATRIX"] * mat
            sp = fl.cluster_split(n_fft, fl.cluster_size(n_fft))
            print(json.dumps({"body": "cluster", "n_fft": n_fft, "hop": hop, "frames": n_frames,
                              "ctas": sp.ctas, "radices": plan.radices, "kinds": plan.kinds,
                              "rader": plan.rader, "bluestein": plan.bluestein, "ms": ms,
                              "phases_ms": {"mel": m["full"] - m["no_mel"],
                                            "power": m["no_mel"] - m["no_power"],
                                            "matrix": m["no_power"] - m["no_matrix"],
                                            "rader": m["no_matrix"] - m["no_rader"],
                                            "register": m["no_rader"] - m["no_stages"],
                                            "rest": m["no_stages"]},
                              "mel_share": (m["full"] - m["no_mel"]) / m["full"],
                              "device": device}), flush=True)
        print(json.dumps({"fit_cluster": {"COST_CLUSTER": cluster_ns / cluster_points},
                          "in_use": {"COST_CLUSTER": fl.COST_CLUSTER},
                          "sizes": len(sizes), "device": device}), flush=True)
    if args.against:
        against(args.against, y, device, known)
    return 0


if __name__ == "__main__":
    sys.exit(main())
