"""Where the time of kernel A's mixed and cluster bodies goes, phase by
phase, on one CUDA card, and the weights of `mixed_plan`'s cost model.

    python3 -m sed_crnn_torch.tools.logmel_phases [--body mixed|cluster|both]
                                                  [--against OTHER_CHECKOUT]
                                                  [--sizes N_FFT ...] [--radix]
                                                  [--turns] [--fit-from JSONL]

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
matrix stages, a Rader stage's inner ones too); ``no_nested`` (4: nor a
nested Rader stage: its gather, inner register stages, products and
scatter); ``no_rader`` (5: nor the Rader stage: its gather, inner register
stages and product); ``no_bluestein`` (6: nor Bluestein's filter product
and second transform); ``no_stages`` (7: nor the register stages: what is
left is the load). Its phases are the differences: mel = full - no_mel,
power = no_mel - no_power, matrix = no_power - no_matrix, nested =
no_matrix - no_nested, rader = no_nested - no_rader, bluestein = no_rader
- no_bluestein, register = no_bluestein - no_stages. Each of `MIXED_SIZES`
runs its plan and each other plan (`mixed_plan` with its ``plan`` forced
to each of `PLAN_KINDS`) that fits one block.

The cluster body's variants: ``full``, ``no_mel`` (1), ``no_power`` (2),
``no_matrix`` (3), ``no_rader`` (4), ``no_stages`` (5: nor the register
stages; left: the load, the Bluestein filter product and the barriers):
mel, power, matrix, rader and register as above (it runs no nested
stage). Each of `SIZES` runs its plan and each other plan on the cluster
body.

Each body also at `MATRIX_PARTS` (``-DLOGMEL_MATRIX_PART=k``: a matrix
stage keeps only the gather and split of its A operands, only its B
operands, or only its products), timed beside the others for every plan
with matrix stages: each part alone is its ms over ``no_matrix``. A plan's
``matrix`` entry gives the matrix phase beside its bound (`matrix_report`:
the three TF32 products' FLOPs at `TF32_FLOPS`, or the shared-memory and
B-table bytes at the SMs' shared-memory rate, the larger; a share above 1
stops the tool), its share of it, its TFLOP/s, and the parts.

With ``--radix``, the per-radix pass cuts (``skip_R``: built with
``-DLOGMEL_SKIP_RADIX=R``, every register stage of radix R left out): at
`RADIX_SIZES` (n_fft 12,895: its Bluestein plan's 25,920-point transforms,
and its nested plan, whose nested Rader stage runs 1,288-point
transforms), each plan as `_power_radices` factors it with radices 4, 8 or
16 alone among the powers of two (`RADIX_SETS`), timed in turns with each
of its radices cut: ms a pass and ps a point-pass by radix, and each
composite radix's pass against the radix-4 pass (the `RADIX_WEIGHT` the
card gives).

Then each mixed size's time with its mel sums on 4, 8, 16 and 32 lanes a
band (the body picks `mel_group`) and with the wide instantiations forced
to 1 and 2 blocks an SM (``-DLOGMEL_WIDE_BLOCKS``; the body picks by
shared memory). Then the least-squares fits (`_fit`: non-negative, each
row weighted by one over its time, so that every plan counts alike) of
`plan_cost`'s weights to the transform times (no_power - no_stages, in ns
a frame on one SM: ms x 1e6 x the card's SMs / frames): ``COST_REGISTER``,
``COST_NARROW``, ``COST_MATRIX`` from the mixed body's plans against their
`plan_counts` (the register points split by instantiation, `_narrow`);
``COST_CLUSTER``, ``COST_CROSS`` and ``COST_CROSS_BLUESTEIN`` from the
cluster body's against what those weights give them and their
`_crossing_points`. Then (`plan_turns`) every size's plans in turns, each
on the body it fits (full builds only), with `torch.stft` + mel beside
them, the pairs the model in use (`plan_cost`) orders otherwise than the
card, and the sizes where it does not pick the plan the card timed fastest
(more than 2 % off). Last (`fit_choice`), the weights `plan_cost` is set
to: those of `CHOICE_GRID` that pick, over every size just timed, the
plans of least total time (the sum of log(picked / fastest)), among equals
the nearest the least-squares fits; each weight to three digits, with the
sizes where they miss the fastest plan.

With ``--turns``, only `plan_turns` (and ``--against``), on the default
build: the check of the weights in use. With ``--fit-from`` a JSON-lines
file this tool printed (its ``fit``, ``fit_cluster`` and ``turns``
lines), `fit_choice` again from those lines alone, on the CPU.

With ``--against`` (the root of another checkout, e.g. an unpacked ``git
archive`` of the parent commit under the git-ignored ``build/``): that
checkout's ``ops/kernels/fused_logmel.py`` and its three log-mel sources
built beside this tree's, and both trees' `fused_log_mel` timed in turns
(this, other, other, this) at every size above and at the FFT body's 1024,
2048 and 4096, with whether their bits agree; one JSON line a size, with
both trees' matrix phase (``matrix_ms``: `MATRIX_CUTS` of both, in turns)
where both run the same plan with matrix stages; first, for each of the
three sources, which kernels both trees compile to the same SASS.

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
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.kernels import fused_logmel as fl

MIXED_VARIANTS = {"full": 0, "no_mel": 1, "no_power": 2, "no_matrix": 3, "no_nested": 4,
                  "no_rader": 5, "no_bluestein": 6, "no_stages": 7}
VARIANTS = {"full": 0, "no_mel": 1, "no_power": 2, "no_matrix": 3, "no_rader": 4,
            "no_stages": 5}   # the cluster body's
# The register radices the per-radix pass cuts leave out, one build each.
SKIP_RADICES = (2, 3, 4, 5, 7, 8, 9, 16)
# The matrix stages' part builds (``-DLOGMEL_MATRIX_PART=k``, on top of the
# full build): only the gather and TF32 split of the A operands, only the
# B operands, only the products.
MATRIX_PARTS = {"matrix_gather": 1, "matrix_b": 2, "matrix_mma": 3}
TF32_FLOPS = 495e12        # an H100's dense TF32 rate (NVIDIA's data sheet)
# The most bytes an SM's shared memory and L1 (one array) move a clock: 32
# banks of 4 bytes; every byte a stage reads from L2 passes them too. At the
# H100 SXM's highest SM clock (data sheet), 1,980 MHz.
SMEM_BYTES_CLOCK = 128
SM_CLOCK_HZ = 1.98e9
# n_fft 2579, 4126, 18992, 12895 and 12899: sizes with a nested Rader plan
# in one block (L 2579 over 2 x 1289 over 8 x 7 x 23; 2063 over 2 x 1031;
# 1187 over 2 x 593; 5 x 2579; 12899 over 2 x 6449 over 16 x 13 x 31);
# 1018 (L 509: Bluestein against Rader over 4 x 127).
MIXED_SIZES = ((1001, 500), (1034, 517), (1102, 551), (1103, 551), (1764, 882), (2206, 1103),
               (3072, 1024), (12865, 6432), (12867, 6433), (23042, 11521), (23044, 11522),
               (23054, 11527), (2579, 1289), (4126, 2063), (18992, 9496), (12895, 6447),
               (12899, 6449), (1018, 509))
# n_fft 12941 (L prime, 12940 = 4 x 5 x 647: Rader with a matrix stage of
# 647 against Bluestein), 23792 (L 8 x 1487, 1486 = 2 x 743), 21599, 24763,
# 29517, which keep Bluestein, and 141001 (L 7 x 20143: a Rader stage over 2
# x 3 x 3 x 3 x 373, whose inner stages cross CTAs, against Bluestein).
SIZES = ((25734, 12867), (31290, 15645), (44100, 22050), (48000, 24000), (88200, 44100),
         (12941, 6470), (23792, 11896), (21599, 10799), (24763, 12381), (29517, 14758),
         (141001, 70500))
# Sizes only `plan_turns` times (every plan in turns; no phases): nested
# plans in one block just above one block's Bluestein limit (23082, 23158),
# and sizes whose Rader plan competes with Bluestein on the composite
# radices, from 45002 to 190002 (C 2 to 9).
TURN_SIZES = ((23082, 11541), (23158, 11579), (45002, 22501), (90002, 45001),
              (150002, 75001), (190002, 95001))
# The per-radix pass cuts: n_fft 12895's Bluestein plan (M 25,920) and its
# nested plan (1,288-point transforms), and 12899's nested plan (6,448-point
# transforms), each factored with one of 4, 8 and 16 among the powers of two
# (9 with 8 and 16; 16 only in the wide instantiations).
RADIX_SIZES = ((12895, 6447, "bluestein"), (12895, 6447, "nested"), (12899, 6449, "nested"))
RADIX_SETS = {"4": {8: float("inf"), 9: float("inf"), 16: float("inf")},
              "8": {8: 1.0, 9: 1.0, 16: float("inf")},
              "16": {8: float("inf"), 9: 1.0, 16: 1.0}}
# `fit_choice`'s candidates for each weight (COST_MATRIX, COST_CROSS and
# COST_CROSS_BLUESTEIN as multiples of the fitted COST_REGISTER).
CHOICE_GRID = {"COST_NARROW": tuple(round(0.2 + 0.05 * k, 2) for k in range(17)),
               "COST_MATRIX": (25, 30, 35, 40, 45, 50, 55, 65, 75, 100, 125),
               "COST_CLUSTER": (1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 3.0),
               "COST_CROSS": (0.0, 0.125, 0.25, 0.5, 1.0, 2.0, 4.0),
               "COST_CROSS_BLUESTEIN": (0.0, 0.5, 1.0, 2.0, 3.0, 4.0, 6.0)}
PER_REGISTER = ("COST_MATRIX", "COST_CROSS", "COST_CROSS_BLUESTEIN")
WEIGHTS = ("COST_REGISTER", "COST_NARROW", "COST_MATRIX", "COST_CLUSTER", "COST_CROSS",
           "COST_CROSS_BLUESTEIN")
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


def build_variants(bodies=("mixed", "cluster"), radix: bool = False) -> dict:
    """One library per body and variant under ``build/logmel_phases/``, every
    ``nvcc`` started before any is waited for: {body: {variant: CDLL}}; the
    mixed body's also at each of `WIDE_BLOCKS`, each body's at each of
    `MATRIX_PARTS` and, with ``radix``, without each of `SKIP_RADICES`."""
    out_dir = _build.BUILD_DIR.parent / "logmel_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = {(b, name): f"-D{BODIES[b][1]}={cut}" for b in bodies
             for name, cut in BODIES[b][2].items()}
    flags.update({(b, name): f"-DLOGMEL_MATRIX_PART={k}" for b in bodies
                  for name, k in MATRIX_PARTS.items()})
    if radix:
        flags.update({(b, f"skip_{r}"): f"-DLOGMEL_SKIP_RADIX={r}" for b in bodies
                      for r in SKIP_RADICES})
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
                          if "registers" in ln or "spill" in ln or "properties for" in ln]
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


# The cuts `against` builds of both trees for the matrix phase (no_power -
# no_matrix), in turns.
MATRIX_CUTS = {"no_power": 2, "no_matrix": 3}


def _with_lib(mod, source: str, lib, fn):
    """``fn`` () with ``mod``'s kernel A library ``source`` replaced by
    ``lib`` (its library caches cleared before and after)."""
    build = mod._build
    load = build.load
    mod._mixed_lib.cache_clear()
    mod._cluster_lib.cache_clear()
    build.load = lambda n: lib if n == source else load(n)
    try:
        return fn()
    finally:
        build.load = load
        mod._mixed_lib.cache_clear()
        mod._cluster_lib.cache_clear()


def _plan_key(plan) -> list:
    """A plan as the JSON lines print it: radices, Rader and nested inner
    radices, Bluestein."""
    return [plan.radices, plan.rader, plan.nested, plan.bluestein]


def _sass(lib: Path) -> dict:
    """Each kernel's SASS in a library (``cuobjdump -sass``): {name: text},
    the name without its anonymous namespace's tag, which differs from
    build to build."""
    text = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        if ln.strip().startswith("Function : "):
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", ln.strip()[len("Function : "):])
            out[name] = []
        elif name is not None:
            out[name].append(ln)
    return {k: "\n".join(v) for k, v in out.items()}


def _sass_compare(mine: Path, theirs: Path) -> dict:
    """Which kernels two builds of one source compile to the same SASS."""
    a, b = _sass(mine), _sass(theirs)
    return {"same": sorted(k for k in a if b.get(k) == a[k]),
            "different": sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))}


def against(root: str, y: torch.Tensor, device: str, sizes=FFT_SIZES + MIXED_SIZES + SIZES
            ) -> None:
    """This tree's kernel A against another checkout's, in turns, at every
    size the tool times: the other's ``fused_logmel.py`` loaded as a module
    of its own, its sources built (all ``nvcc`` runs started together)
    under ``build/logmel_phases/against/``; one JSON line a size with both
    plans, ms a launch of each (this, other, other, this) and whether the
    two outputs are bitwise equal; where both trees run the same plan with
    matrix stages, both trees' matrix phase too (`MATRIX_CUTS` of each
    tree's body, every variant of both in turns, ``matrix_ms`` = no_power -
    no_matrix); then, for each plan kind both trees force to the same plan
    where that is not both trees' own, the same for that forced plan
    (``forced``), so that an unchanged plan is compared with itself."""
    other = Path(root).resolve()
    out_dir = _build.BUILD_DIR.parent / "logmel_phases" / "against"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {(tree, n, ""): base for n in AGAINST_SOURCES
            for tree, base in (("other", other / "sed_crnn_torch" / "csrc"),)}
    for b in ("mixed", "cluster"):
        for cut, level in MATRIX_CUTS.items():
            for tree, base in (("this", _build.CSRC_DIR), ("other", other / "sed_crnn_torch" / "csrc")):
                jobs[tree, BODIES[b][0], f"-D{BODIES[b][1]}={level}"] = base
    procs = {}
    for (tree, n, flag), base in jobs.items():
        lib = out_dir / f"lib{tree}_{n}{flag.replace('=', '_').replace('-D', '_')}.so"
        procs[tree, n, flag] = lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *([flag] if flag else []), "-o", str(lib),
             str(base / f"{n}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for key, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        built[key] = ctypes.CDLL(str(lib))
    libs = {n: built["other", n, ""] for n in AGAINST_SOURCES}
    for n in AGAINST_SOURCES:
        _build.load(n)
        print(json.dumps({"sass_against": str(other), "source": n} | _sass_compare(
            _build._library_path(n)[1], procs["other", n, ""][0])), flush=True)
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
        plans = {name: (_plan_key(mod.mixed_plan(n_fft)) if mod.body(n_fft) != "fft" else "fft")
                 for name, mod in (("this", fl), ("other", theirs))}
        line = {"against": str(other), "n_fft": n_fft, "hop": hop, "plans": plans,
                "bitwise_equal": same, "ms": ms, "device": device}
        mine = fl.mixed_plan(n_fft) if fl.body(n_fft) != "fft" else None
        if mine is not None and mine.tensor_cores and mine == theirs.mixed_plan(n_fft):
            source = BODIES[fl.body(n_fft)][0]
            flag = BODIES[fl.body(n_fft)][1]
            variants = {(tree, cut): (mod, built[tree, source, f"-D{flag}={level}"])
                        for tree, mod in (("this", fl), ("other", theirs))
                        for cut, level in MATRIX_CUTS.items()}
            cut_ms = {k: [] for k in variants}
            for k in list(variants) + list(variants)[::-1]:
                mod, lib = variants[k]
                cut_ms[k].append(_with_lib(mod, source, lib, lambda mod=mod: cuda_ms(
                    lambda: mod.fused_log_mel(y, cfg))))
            m = {k: float(np.mean(v)) for k, v in cut_ms.items()}
            line["matrix_ms"] = {tree: m[tree, "no_power"] - m[tree, "no_matrix"]
                                 for tree in ("this", "other")}
            line["cut_ms"] = {f"{t}/{c}": v for (t, c), v in cut_ms.items()}
        print(json.dumps(line), flush=True)
        if fl.body(n_fft) == "fft":
            continue
        src, n_frames = fl.frame_source(y, cfg)
        for kind in fl.PLAN_KINDS:
            try:
                mine, theirs_plan = fl.mixed_plan(n_fft, kind), theirs.mixed_plan(n_fft, kind)
            except ValueError:      # a kind one of them has not
                continue
            key = (mine.radices, mine.rader, mine.bluestein)
            if (key != (theirs_plan.radices, theirs_plan.rader, theirs_plan.bluestein)
                    or mine.nested or mine == fl.mixed_plan(n_fft)
                    and theirs_plan == theirs.mixed_plan(n_fft)):
                continue
            fns = {name: (lambda mod=mod: (
                mod._launch_mixed(src, hop, n_frames, n_fft, cfg, plan=kind)
                if mod.mixed_plan(n_fft, kind).smem_bytes <= mod.MIXED_MAX_SMEM
                else mod._launch_cluster(src, hop, n_frames, n_fft, cfg, plan=kind)))
                for name, mod in (("this", fl), ("other", theirs))}
            same = torch.equal(fns["this"](), fns["other"]())
            ms = {k: [] for k in fns}
            for k in ("this", "other", "other", "this"):
                ms[k].append(cuda_ms(fns[k]))
            print(json.dumps({"against": str(other), "n_fft": n_fft, "hop": hop,
                              "forced": kind, "plan": [mine.radices, mine.rader],
                              "bitwise_equal": same, "ms": ms, "device": device}), flush=True)


def _library(y: torch.Tensor, cfg: FrontendConfig):
    """`torch.stft` + mel + floor + log, uncentred: one library pipeline
    computing kernel A's function (timed beside it, never used by the
    port)."""
    from sed_crnn_torch.ops.mel import mel_filterbank

    fb = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels)).to(y.device)
    window = torch.hann_window(cfg.n_fft, periodic=True, device=y.device)
    return lambda: torch.log(torch.clamp_min(fb @ torch.stft(
        y, cfg.n_fft, cfg.hop_length, window=window, center=False,
        return_complex=True).abs().square(), cfg.log_floor))


def _features(plan) -> list:
    """What `plan_cost` weighs of a plan on the body it fits: its
    `plan_counts`, whether it runs narrow, on the cluster body, its
    `_crossing_points` there, and whether it is Bluestein's."""
    reg, mat = fl.plan_counts(plan.n, plan.radices, plan.bluestein, plan.rader, plan.nested)
    cluster = plan.smem_bytes > fl.MIXED_MAX_SMEM
    return [reg, mat, fl._narrow(plan.radices, plan.rader), cluster,
            fl._crossing_points(plan) if cluster else 0, plan.bluestein]


def matrix_work(plan) -> tuple:
    """A frame's matrix stages as the least work they must do: FLOPs of the
    three TF32 products a butterfly (P and Q, real and imaginary rows, (H +
    1)^2 each way, H = (R - 1) / 2: 24 (H + 1)^2) and shared-memory bytes
    (each stage's N points read once and written once, 16 N), over every
    pass: an outer stage once, a Rader stage's inner stage twice (forward
    and transposed), a nested stage's inner stage four times; and the bytes
    of the B tables (`matrix_table`: T^2 x 64 float4 a radix), which every
    SM that runs a stage must read at least once a launch."""
    flops = nbytes = table = 0.0
    n1 = plan.n - plan.n // plan.rader_prime if plan.rader else 0
    n2 = n1 - n1 // plan.nested_prime if plan.nested else 0
    for radices, points in ((plan.matrix, plan.n), (plan.rader_matrix, 2 * n1),
                            (plan.nested_matrix, 4 * n2)):
        for r in radices:
            flops += points / r * 24 * ((r + 1) // 2) ** 2
            nbytes += 16 * points
    for r in set(plan.matrix + plan.rader_matrix + plan.nested_matrix):
        table += fl.matrix_tiles(r) ** 2 * 64 * 16
    return flops, nbytes, table


def matrix_report(m: dict, plan, n_frames: int, sms: int) -> dict:
    """The matrix phase of a timed plan (``m``: mean ms by variant, on a card
    of ``sms`` SMs) beside its bound, its share of the bound, its rate in
    TFLOP/s, and, where the part builds ran, each part alone (gather and
    split, B operands, products): its ms over the build without matrix
    stages. The bound is the larger of `matrix_work`'s FLOPs at
    `TF32_FLOPS` and its bytes (the points' through shared memory, the B
    tables' once an SM of the launch) at `SMEM_BYTES_CLOCK` an SM at
    `SM_CLOCK_HZ`. Raises ValueError for a share above 1: a stage faster
    than its least time means the bound is wrong."""
    if not plan.tensor_cores:
        return {}
    flops, nbytes, table = matrix_work(plan)
    ctas = n_frames * (fl.plan_cluster_size(plan) if plan.smem_bytes > fl.MIXED_MAX_SMEM else 1)
    t_ops = flops * n_frames / TF32_FLOPS
    t_bytes = (nbytes * n_frames + table * min(sms, ctas)) / (SMEM_BYTES_CLOCK * sms * SM_CLOCK_HZ)
    ms = m["no_power"] - m["no_matrix"]
    bound = max(t_ops, t_bytes) * 1e3
    share = bound / ms if ms > 0 else None
    if share is not None and share > 1:
        raise ValueError(f"n_fft {plan.n_fft}: the matrix phase {ms:.4f} ms is below its "
                         f"bound {bound:.4f} ms")
    out = {"ms": ms, "bound_ms": bound, "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "share_of_bound": share,
           "tflops": flops * n_frames / (ms * 1e-3) / 1e12 if ms > 0 else None}
    for k in MATRIX_PARTS:
        if k in m:
            out[k.replace("matrix_", "") + "_ms"] = m[k] - m["no_matrix"]
    return out


def plan_turns(sizes, y: torch.Tensor, device: str) -> list:
    """Each size's own plan and every other plan it has (`PLAN_KINDS`), each
    on the body it fits, and the library (`_library`), timed in turns (every
    one, then in reverse); one JSON line a size with each plan's ms,
    `plan_cost` and `_features`, then one line with the pairs whose order by
    `plan_cost` is not the card's and the sizes whose cheapest plan by
    `plan_cost` is more than 2 % slower than their fastest. Returns the
    sizes' lines."""
    wrong, missed, pairs, rows = [], [], 0, []
    for n_fft, hop in sizes:
        if fl.body(n_fft) == "fft":
            continue
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
        src, n_frames = fl.frame_source(y, cfg)
        plans = {}
        for kind in (None,) + fl.PLAN_KINDS:
            try:
                plan = fl.mixed_plan(n_fft, kind)
                if plan.smem_bytes > fl.MIXED_MAX_SMEM:
                    fl.cluster_size(n_fft, kind)
            except ValueError:
                continue
            if plan not in [p for p, _ in plans.values()]:
                launch = (fl._launch_mixed if plan.smem_bytes <= fl.MIXED_MAX_SMEM
                          else fl._launch_cluster)
                plans[kind or "chosen"] = (plan, lambda launch=launch, kind=kind: launch(
                    src, hop, n_frames, n_fft, cfg, plan=kind))
        fns = {k: fn for k, (_, fn) in plans.items()} | {"library": _library(y, cfg)}
        ms = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(cuda_ms(fns[k]))
        cost = {k: fl._plan_cost_on_body(p) for k, (p, _) in plans.items()}
        mean = {k: v for k, v in _mean(ms).items() if k in plans}
        for a in plans:
            for b in plans:
                if a < b:
                    pairs += 1
                    if (mean[a] < mean[b]) != (cost[a] < cost[b]):
                        wrong.append([n_fft, a, b])
        fastest, picked = min(mean, key=mean.get), min(cost, key=cost.get)
        if mean[picked] > 1.02 * mean[fastest]:
            missed.append([n_fft, picked, fastest, mean[picked] / mean[fastest]])
        rows.append({"turns": n_fft, "hop": hop, "frames": n_frames, "ms": ms, "model": cost,
                     "plans": {k: [p.radices, p.rader, p.nested, p.bluestein]
                               for k, (p, _) in plans.items()},
                     "features": {k: _features(p) for k, (p, _) in plans.items()},
                     "device": device})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"ordering": {"pairs": pairs, "wrong": wrong, "not_fastest": missed},
                      "in_use": {k: getattr(fl, k) for k in WEIGHTS},
                      "radix_weight": fl.RADIX_WEIGHT, "device": device}), flush=True)
    return rows


def _fit(rows, times) -> np.ndarray:
    """Non-negative least squares of ``times`` on ``rows``, each row weighted
    by one over its time (relative errors)."""
    from scipy.optimize import nnls

    a, t = np.array(rows, float), np.array(times, float)
    return nnls(a / t[:, None], np.ones_like(t))[0]


def _round3(x: float) -> float:
    return float(f"{x:.3g}")


def fit_choice(rows, anchor: dict) -> dict:
    """`plan_cost`'s weights that pick the fastest plans at the sizes of
    ``rows`` (`plan_turns`' lines): over every combination of `CHOICE_GRID`
    (``anchor``'s COST_REGISTER, the others' multiples of it), the least
    total log(picked / fastest) plan time over the sizes; among equals, the
    nearest ``anchor`` (the least-squares fits) by sum of squared log(1 +
    w) differences. Each weight to three digits; prints them, the total,
    the sizes where they pick a plan more than 2 % slower than the fastest,
    and ``anchor``; returns them."""
    reg = _round3(anchor["COST_REGISTER"])
    names = tuple(CHOICE_GRID)
    grid = np.array(np.meshgrid(*(CHOICE_GRID[k] for k in names), indexing="ij"),
                    float).reshape(len(names), -1)
    for i, k in enumerate(names):
        if k in PER_REGISTER:
            grid[i] = np.vectorize(_round3)(grid[i] * reg)
    w = dict(zip(names, grid))

    def excess(weights) -> tuple:
        """The total log(picked / fastest) and each size's picked / fastest
        under every column of ``weights``."""
        total, ratios = 0.0, []
        ones = np.ones_like(weights["COST_NARROW"])
        for r in rows:
            kinds = [k for k in r["features"] if k in r["ms"]]
            ms = np.array([float(np.mean(r["ms"][k])) for k in kinds])
            cost = []
            for k in kinds:
                n_reg, n_mat, narrow, cluster, crossing, blue = r["features"][k]
                c = (reg * n_reg * (weights["COST_NARROW"] if narrow else ones)
                     + weights["COST_MATRIX"] * n_mat)
                if cluster:
                    c = (c + (weights["COST_CROSS_BLUESTEIN"] if blue else weights["COST_CROSS"])
                         * crossing) * weights["COST_CLUSTER"]
                cost.append(c * ones)
            ratio = ms[np.argmin(np.array(cost), axis=0)] / ms.min()
            total = total + np.log(ratio)
            ratios.append(ratio)
        return total, ratios

    total, ratios = excess(w)
    best = np.flatnonzero(total <= total.min() + 1e-12)
    dist = sum((np.log1p(grid[i, best]) - np.log1p(anchor[k])) ** 2
               for i, k in enumerate(names))
    pick = best[int(np.argmin(dist))]
    out = {"COST_REGISTER": reg} | {k: _round3(float(grid[i, pick]))
                                    for i, k in enumerate(names)}
    _, ratios = excess({k: np.array([v]) for k, v in out.items()})
    missed = [[r["turns"], float(x[0])] for r, x in zip(rows, ratios) if x[0] > 1.02]
    print(json.dumps({"fit_choice": out, "log_excess": float(total[pick]), "sizes": len(rows),
                      "not_fastest": missed, "anchor": anchor,
                      "in_use": {k: getattr(fl, k) for k in WEIGHTS}}), flush=True)
    return out


def _passes(plan) -> dict:
    """Points a frame each register radix of ``plan`` passes over: a stage of
    N points (twice with Bluestein), of the Rader stage's N' points twice
    (forward and transposed inner transforms), of the nested stage's N''
    points four times (twice in each inner transform)."""
    out = {}
    levels = [(plan.radices[:-1] if plan.rader else plan.radices,
               plan.n * (2 if plan.bluestein else 1))]
    if plan.rader:
        n1 = plan.n - plan.n // plan.rader_prime
        levels.append((plan.rader[:-1] if plan.nested else plan.rader, 2 * n1))
        if plan.nested:
            levels.append((plan.nested, 4 * (n1 - n1 // plan.nested_prime)))
    for radices, points in levels:
        for r in radices:
            if r in fl.REGISTER_RADICES:
                out[r] = out.get(r, 0) + points
    return out


def _with_weights(weights: dict):
    """`fl.RADIX_WEIGHT` updated by ``weights`` and the plan caches cleared;
    returns the weights it replaced."""
    old = dict(fl.RADIX_WEIGHT)
    fl.RADIX_WEIGHT.update(weights)
    for f in (fl._power_radices, fl.mixed_plan, fl.cluster_size, fl._device_operands):
        f.cache_clear()
    return old


def radix_passes(libs: dict, skips: dict, y: torch.Tensor, device: str) -> None:
    """The per-radix pass cuts at `RADIX_SIZES` under each of `RADIX_SETS`:
    each plan (built and its operands put on the card before any timing),
    then in turns its full build and each radix's ``skip_R`` build; one JSON
    line a plan with ms a pass and ps a point-pass by radix, then one line
    with each composite radix's ps a point-pass over radix 4's."""
    dev = y.device
    per_point = {}
    for n_fft, hop, kind in RADIX_SIZES:
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
        src, n_frames = fl.frame_source(y, cfg)
        for label, weights in RADIX_SETS.items():
            old = _with_weights(weights)
            try:
                plan = fl.mixed_plan(n_fft, kind)
            finally:
                _with_weights(old)
            ops = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
                   for k, v in fl.plan_operands(cfg.sample_rate, cfg.n_mels, cfg.fmin, cfg.fmax,
                                                plan).items()}
            body, launch = (("mixed", fl.launch_mixed_plan) if plan.smem_bytes <= fl.MIXED_MAX_SMEM
                            else ("cluster", fl.launch_cluster_plan))
            source = BODIES[body][0]
            passes = {r: v for r, v in _passes(plan).items() if r in SKIP_RADICES}
            variants = {"full": libs[body]["full"]} | {f"skip_{r}": skips[body][r]
                                                        for r in passes}
            ms = _mean(_time_variants(variants, source, lambda: launch(
                src, hop, n_frames, cfg, plan, ops)))
            radix = {}
            for r, points in passes.items():
                d = ms["full"] - ms[f"skip_{r}"]
                radix[r] = {"ms": d, "point_passes": points * n_frames,
                            "ps_per_point_pass": d * 1e9 / (points * n_frames)}
                per_point.setdefault((n_fft, kind, label), {})[r] = radix[r]["ps_per_point_pass"]
            print(json.dumps({"radix_set": label, "n_fft": n_fft, "plan": kind, "body": body,
                              "radices": plan.radices, "rader": plan.rader,
                              "nested": plan.nested, "bluestein": plan.bluestein,
                              "frames": n_frames, "ms": ms, "by_radix": radix,
                              "device": device}), flush=True)
    weight = {}
    for (n_fft, kind, label), rows in per_point.items():
        four = per_point.get((n_fft, kind, "4"), {}).get(4)
        if four:
            for r, v in rows.items():
                if r in fl.COMPOSITE:
                    weight.setdefault(r, []).append(v / four)
    print(json.dumps({"radix_weight": {r: float(np.mean(v)) for r, v in weight.items()},
                      "per_set": {f"{n}/{k}/{lab}": v for (n, k, lab), v in per_point.items()},
                      "in_use": fl.RADIX_WEIGHT, "device": device}), flush=True)


def _timeable(n_fft: int) -> bool:
    """A body of kernel A takes n_fft, at hop n_fft / 2 >= 1."""
    try:
        return n_fft >= 2 and (fl.body(n_fft) != "cluster" or fl.cluster_size(n_fft) > 0)
    except ValueError:      # beyond the cluster body's limit
        return False


def _fit_from(path: str) -> int:
    """`fit_choice` again from a JSON-lines file this tool printed."""
    lines = [json.loads(ln) for ln in Path(path).read_text().splitlines()
             if ln.startswith("{")]
    rows = [ln for ln in lines if "turns" in ln and "features" in ln]
    if not rows:
        print(f"logmel_phases: {path} holds no turns lines with features", file=sys.stderr)
        return 2
    anchor = {k: getattr(fl, k) for k in WEIGHTS}
    for ln in lines:
        anchor.update(ln.get("fit", {}))
        anchor.update(ln.get("fit_cluster", {}))
    fit_choice(rows, anchor)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--body", choices=("mixed", "cluster", "both"), default="both")
    ap.add_argument("--against", default="",
                    help="the root of another checkout to time in turns with this one")
    ap.add_argument("--sizes", type=int, nargs="+", default=None,
                    help="time only these n_fft (hop n_fft / 2 where the lists name none)")
    ap.add_argument("--radix", action="store_true",
                    help="also the per-radix pass cuts at RADIX_SIZES (both bodies built)")
    ap.add_argument("--turns", action="store_true",
                    help="only every size's plans in turns (and --against), no phases")
    ap.add_argument("--fit-from", default="",
                    help="fit the weights again from this tool's printed lines (no card)")
    args = ap.parse_args(argv)
    if args.fit_from:
        return _fit_from(args.fit_from)
    if args.radix and (args.body != "both" or args.turns):
        ap.error("--radix needs --body both and no --turns")
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
    bodies = () if args.turns else ("mixed", "cluster") if args.body == "both" else (args.body,)
    libs = build_variants(bodies, args.radix) if bodies else {}
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(9)
    y = torch.from_numpy((0.1 * rng.standard_normal(int(SECONDS * FrontendConfig().sample_rate)))
                         .astype(np.float32)).to(dev)
    device = torch.cuda.get_device_name(0)
    fit_rows, fit_ns = [], []
    fit = {}
    cluster_rows, cluster_ns = [], []
    skips = {b: {r: libs[b].pop(f"skip_{r}") for r in SKIP_RADICES} for b in bodies
             if args.radix}
    parts = {b: {k: libs[b].pop(k) for k in MATRIX_PARTS} for b in bodies}
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
                variants = libs["mixed"] | (parts["mixed"] if plan.tensor_cores else {})
                ms = _time_variants(variants, "logmel_mixed", lambda: fl._launch_mixed(
                    src, hop, n_frames, n_fft, cfg, **forced))
                m = _mean(ms)
                phases = {"mel": m["full"] - m["no_mel"], "power": m["no_mel"] - m["no_power"],
                          "matrix": m["no_power"] - m["no_matrix"],
                          "nested": m["no_matrix"] - m["no_nested"],
                          "rader": m["no_nested"] - m["no_rader"],
                          "bluestein": m["no_rader"] - m["no_bluestein"],
                          "register": m["no_bluestein"] - m["no_stages"],
                          "rest": m["no_stages"]}
                reg, mat = fl.plan_counts(plan.n, plan.radices, plan.bluestein, plan.rader,
                                          plan.nested)
                narrow = fl._narrow(plan.radices, plan.rader)
                counts = (0.0 if narrow else reg, reg if narrow else 0.0, mat)
                fit_rows.append(counts)
                fit_ns.append((m["no_power"] - m["no_stages"]) * 1e6 * sms / n_frames)
                print(json.dumps({"body": "mixed", "n_fft": n_fft, "hop": hop,
                                  "frames": n_frames, "radices": plan.radices,
                                  "kinds": plan.kinds, "rader": plan.rader,
                                  "nested": plan.nested, "bluestein": plan.bluestein,
                                  "chosen": not forced, "forced": forced, "ms": ms,
                                  "phases_ms": phases, "counts": list(counts),
                                  "matrix": matrix_report(m, plan, n_frames, sms),
                                  "model": fl._plan_cost_on_body(plan),
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
                              "wide": bool(set(fl.mixed_plan(n_fft).radices)
                                           - {2, 3, 4, 5, 7, 8, 9, 16}),
                              "device": device}), flush=True)
        if fit_rows:      # --sizes may leave the mixed body nothing to fit
            w = _fit(fit_rows, fit_ns)
            fit["COST_REGISTER"], fit["COST_MATRIX"] = float(w[0]), float(w[2])
            fit["COST_NARROW"] = float(w[1] / w[0]) if w[0] else 1.0
            errors = [float(np.dot(w, r)) / t - 1.0 for r, t in zip(fit_rows, fit_ns)]
            print(json.dumps({"fit": fit,
                              "in_use": {k: getattr(fl, k) for k in fit},
                              "measured_vs_fit_ns": [
                                  [r, round(t, 1), round(float(np.dot(w, r)), 1)]
                                  for r, t in zip(fit_rows, fit_ns)],
                              "largest_error": max(errors, key=abs), "rows": len(fit_rows),
                              "sms": sms, "device": device}), flush=True)
    if "cluster" in bodies:
        for k in ("COST_REGISTER", "COST_NARROW", "COST_MATRIX"):
            fit.setdefault(k, getattr(fl, k))
        for n_fft, hop in sizes:
            cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
            src, n_frames = fl.frame_source(y, cfg)
            seen = []
            for forced in ({},) + FORCED:
                try:
                    plan = fl.mixed_plan(n_fft, **forced)
                    ctas = fl.cluster_size(n_fft, **forced)
                except ValueError:      # no such plan, or none 16 CTAs hold
                    continue
                if plan in seen:
                    continue
                seen.append(plan)
                variants = libs["cluster"] | (parts["cluster"] if plan.tensor_cores else {})
                ms = _time_variants(variants, "logmel_cluster", lambda: fl._launch_cluster(
                    src, hop, n_frames, n_fft, cfg, **forced))
                m = _mean(ms)
                reg, mat = fl.plan_counts(plan.n, plan.radices, plan.bluestein, plan.rader,
                                          plan.nested)
                narrow = fl._narrow(plan.radices, plan.rader)
                crossing = fl._crossing_points(plan)
                base = (fit["COST_REGISTER"] * reg * (fit["COST_NARROW"] if narrow else 1.0)
                        + fit["COST_MATRIX"] * mat)
                cluster_rows.append((base, 0.0 if plan.bluestein else crossing,
                                     crossing if plan.bluestein else 0.0))
                cluster_ns.append((m["no_power"] - m["no_stages"]) * 1e6 * sms / n_frames)
                sp = fl.cluster_split(n_fft, ctas, **forced)
                print(json.dumps({"body": "cluster", "n_fft": n_fft, "hop": hop,
                                  "frames": n_frames, "ctas": sp.ctas, "radices": plan.radices,
                                  "kinds": plan.kinds, "rader": plan.rader,
                                  "bluestein": plan.bluestein,
                                  "chosen": not forced, "forced": forced, "ms": ms,
                                  "phases_ms": {"mel": m["full"] - m["no_mel"],
                                                "power": m["no_mel"] - m["no_power"],
                                                "matrix": m["no_power"] - m["no_matrix"],
                                                "rader": m["no_matrix"] - m["no_rader"],
                                                "register": m["no_rader"] - m["no_stages"],
                                                "rest": m["no_stages"]},
                                  "counts": [reg, mat], "crossing": crossing,
                                  "matrix": matrix_report(m, plan, n_frames, sms),
                                  "model": fl._plan_cost_on_body(plan),
                                  "mel_share": (m["full"] - m["no_mel"]) / m["full"],
                                  "device": device}), flush=True)
        if cluster_rows:
            v = _fit(cluster_rows, cluster_ns)
            fit["COST_CLUSTER"] = float(v[0])
            fit["COST_CROSS"], fit["COST_CROSS_BLUESTEIN"] = (
                (float(v[1] / v[0]), float(v[2] / v[0])) if v[0] else (0.0, 0.0))
            print(json.dumps({"fit_cluster": {k: fit[k] for k in (
                                  "COST_CLUSTER", "COST_CROSS", "COST_CROSS_BLUESTEIN")},
                              "in_use": {k: getattr(fl, k) for k in (
                                  "COST_CLUSTER", "COST_CROSS", "COST_CROSS_BLUESTEIN")},
                              "largest_error": max((float(np.dot(v, r)) / t - 1.0 for r, t in
                                                    zip(cluster_rows, cluster_ns)), key=abs),
                              "rows": len(cluster_rows), "device": device}), flush=True)
    rows = plan_turns(known + (TURN_SIZES if args.sizes is None else ()), y, device)
    if bodies:
        fit_choice(rows, {k: getattr(fl, k) for k in WEIGHTS} | fit)
    if args.radix:
        radix_passes(libs, skips, y, device)
    if args.against:
        against(args.against, y, device, known)
    return 0


if __name__ == "__main__":
    sys.exit(main())
