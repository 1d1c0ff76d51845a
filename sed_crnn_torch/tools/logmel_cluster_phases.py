"""Where the time of kernel A's cluster body goes, phase by phase, on one
CUDA card.

    python3 -m sed_crnn_torch.tools.logmel_cluster_phases   # from the root of a checkout

Builds ``sed_crnn_torch/csrc/logmel_cluster.cu`` as it is and with each of
its profiling cuts (``-DLOGMEL_CLUSTER_CUT=k``: the source leaves out the
later phases of a frame, and the results are no longer right), all
``nvcc`` runs started together, times each with CUDA events on 150 s of
noise (seed 9) at the sizes `chip_smoke.py` times, uncentred, and prints
one JSON line per size: ms per launch of

* ``full``: the body as it is;
* ``no_mel`` (cut 1): without the mel sums (each band's serial sum over its
  bins);
* ``no_power`` (cut 2): without the mel sums and the power of the bins;
* ``no_stages`` (cut 3): without those and the FFT stages (what is left:
  the load, the Bluestein filter product and the barriers).

The differences are the phases' costs: mel = full - no_mel, power =
no_mel - no_power, stages = no_power - no_stages. Variants are timed in
turns (each size: every variant, then every variant in reverse order).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels import _build
from sed_crnn_torch.ops.kernels import fused_logmel as fl

VARIANTS = {"full": 0, "no_mel": 1, "no_power": 2, "no_stages": 3}
SIZES = ((12865, 6432), (23042, 11521), (44100, 22050), (48000, 24000), (88200, 44100))
SECONDS = 150.0
REPS = 10


def build_variants() -> dict:
    """One library per variant under ``build/logmel_cluster_phases/``."""
    out_dir = _build.BUILD_DIR.parent / "logmel_cluster_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC_DIR / "logmel_cluster.cu"
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-DLOGMEL_CLUSTER_CUT={cut}",
         "-o", str(out_dir / f"lib{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, cut in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{out}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("logmel_cluster_phases: a CUDA card is required", file=sys.stderr)
        return 2
    libs = build_variants()
    load = _build.load

    def use(name):
        fl._cluster_lib.cache_clear()
        _build.load = lambda n: libs[name] if n == "logmel_cluster" else load(n)

    dev = torch.device("cuda")
    cfg0 = FrontendConfig()
    rng = np.random.default_rng(9)
    y = torch.from_numpy((0.1 * rng.standard_normal(int(SECONDS * cfg0.sample_rate)))
                         .astype(np.float32)).to(dev)
    order = list(libs)
    try:
        for n_fft, hop in SIZES:
            cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
            src, n_frames = fl.frame_source(y, cfg)
            ms = {}
            for name in order + order[::-1]:
                use(name)
                ms.setdefault(name, []).append(cuda_ms(
                    lambda: fl._launch_cluster(src, hop, n_frames, n_fft, cfg)))
            sp = fl.cluster_split(n_fft, fl.cluster_size(n_fft))
            print(json.dumps({"n_fft": n_fft, "hop": hop, "frames": n_frames, "ctas": sp.ctas,
                              "ms": ms, "device": torch.cuda.get_device_name(0)}), flush=True)
    finally:
        _build.load = load
        fl._cluster_lib.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
