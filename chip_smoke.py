#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, feature-extraction,
evaluation, live-serving and stacked multi-seed training paths on one GPU
and check its kernels.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card

Phases, each printing its own lines; any failed check raises, so the script
exits non-zero and prints no result line:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel from ``sed_crnn_torch/csrc/*.cu`` (one nvcc
   per source, in parallel) into ``build/sed_crnn_torch/``;
3. kernel A (fused log-mel; at a power-of-two n_fft the FFT body of
   ``csrc/logmel_fft.cu``) against its DIF plain PyTorch version on the card:
   a 30 s bucket, a 240 s signal, a ragged length and an all-silence input,
   with and without a log floor; log-domain atol 5e-4 at finite entries and
   an identical -inf pattern; max|diff| against the FFT body's own plain
   version, two runs bitwise equal; times (warm and cold L2) at the main
   path's shape beside the plain versions, ``torch.stft`` + mel, the bound
   and the retained dft body's time (its output held against the DIF plain
   version first), each also as torch.profiler device-busy time beside the
   host's issue time, and the 240 s frontend rate;
4. kernel B's forward (the GRU recurrence; the warp body ``csrc/gru_warp.cu``
   for H <= 32, the retained ``csrc/gru_scan.cu`` above) against its plain
   version: T=256, H in {32, 16, 8} (warp) at B in {1, 8, 128} and H=64
   (retained) at B in {1, 8}, both conventions, both gates, both directions,
   non-zero h0, single directions and pair launches; atol 1e-5; at the
   serving shape (B=1, H=32) the warp body's time beside the retained
   body's, one pair launch beside two single ones, the plain version, and
   ``torch.nn.GRU`` at reset_after=True (the one variant it computes),
   with torch.profiler device time and the host's issue time per call;
5. the main path at full width: ``sednet-dcase`` weights from a numpy seed
   in the JAX layout, written as a JAX-format checkpoint, and a 120 s 44.1 kHz
   wav with tone bursts, served by ``apps.infer.infer_file`` and by the same
   composition with the ``"kernel"`` frontend, on the card and on the CPU
   (plain versions); logits within 1e-3, probabilities within 1e-3, events
   equal, and both kernels' launch counts read around this phase alone
   (kernel A once per kernel-frontend ``extract``, on the chunked route and
   never on the dft body; kernel B one pair launch per BiGRU layer per
   chunk, all on the warp body) and no GRU plain version run on a CUDA
   tensor;
6. throughput in ``bench.py``'s units (audio-seconds per second) and a
   torch.profiler breakdown of streaming;
7. kernel B train (the residual forward, the backward chain, the dwh
   reduction and the fixed-order partial sum) against their plain versions
   at the widths and batches of phase 4, single directions and pair
   launches, non-zero h0, dys and dhl; ys/res atol 1e-5, gradients within
   1e-4 of each one's largest magnitude, the reduction also against
   ``gru_dwh_plain`` on the kernel's own dxp; the retained body driven once
   through a BiGRU at H=64; dwh bitwise equal across two runs; times at
   B=128 beside the retained body, two single launches, the plain versions,
   a torch.profiler split of the backward by kernel, and ``torch.nn.GRU``
   at reset_after=True, forward and backward at B=1 and B=128;
8. one full-width ``sednet-dcase`` train step (batch 16, dropout 0, the
   serving phase's seeded weights) on the card against the CPU: loss, Adam's
   moments, BatchNorm statistics and updated parameters within their bands,
   and exactly one pair residual forward and one pair backward (chain,
   dwh reduction, partial sum) launched per BiGRU layer;
9. ``run_fold`` at the preset's full size on synthetic folds (2 epochs of
   2 steps at batch 128, full-split validation sweeps): finite losses,
   JAX-format best/last checkpoints that load back and serve the same
   validation scores on the card and the same logits as on the CPU, and
   exact launch counts (per BiGRU layer one pair of each GRU kernel per
   train step, one pair forward per sweep step), none on the retained body;
10. training throughput: train-step time at batch 128, the training rate in
    audio-seconds per second, and a torch.profiler breakdown of one step.
11. kernel A's framed route (the TPU `_kernel_dif`: n_fft 1024 and 4096
    at hop 1024, and a frame-matrix input) and its exact route (the TPU
    `_kernel_exact`: mode "exact" at n_fft 2048 on the FFT body, the n_fft
    1034 / hop 517 fallback on the dft body; the dft body's DIF
    formulation at n_fft 3072) against their DIF / direct plain versions on
    the signals of phase 3 and a 1,500-sample one, with and without a floor
    (-inf pattern equal, 5e-4 at finite entries), the FFT body also against
    its own plain version and twice, bitwise; their times at the binmul
    path's shapes (warm and cold L2) beside the dft body's at the same
    shapes (its output held against the same plain version first), the
    plain versions, ``torch.stft`` + mel and the bounds, and as
    torch.profiler device-busy time beside the host's issue time; the
    exact route driven once by ``fused_log_mel(mode="exact")`` at n_fft
    2048 and the dft body once through ``frontend.extract`` at n_fft 1034;
12. the feature path: a synthetic DCASE 2017 street layout (12 binaural
    120 s wavs at 44.1 kHz and one 20 s wav at 48 kHz, folds 1 and 2) through
    ``apps.feature.main --binmul --backend kernel --device cuda``: exactly 2
    chunked and 4 framed launches per file, a cached rerun that launches
    nothing and no launch lands on the dft body, per-file features within
    5e-4 of ``--backend fft`` on the card,
    the packs' shapes and standardized means; the feature rate (host clock),
    a profile and the host's parts of one file;
13. ``apps.train.main --preset sednet-dcase-binmul`` on those packs at full
    width (in_channels 6, batch 128), 2 epochs: finite losses, exact GRU
    kernel launch counts (and no log-mel launch, as in phases 8 and 9), a
    best checkpoint that loads back and gives the same logits on the card
    and the CPU;
14. the evaluation path ([evaluate]): ``evaluate_split`` on a 1,800 s
    synthetic 6-class split (77,520 frames, 302 windows, 2 batches of 256)
    with phase 9's best checkpoint alone and best + last as an ensemble:
    exactly one pair forward per BiGRU layer per batch per member, nothing
    else and no plain version on the card; the forward against the CPU on
    16 windows (1e-3), the card's and the CPU's scoring of the card's roll
    (counts, thresholds and None/NaN places equal, ratios within 1e-6,
    dumped event lists byte-identical); ``apps.evaluate`` on phase 13's
    binmul checkpoint and phase 12's pack with ``--dump-events``, rescored
    by ``score_event_lists`` within 1e-9; the evaluation rate and its parts
    (forward, sweeps, event decode and matching, the rest), the event
    counts, and kernel B's pair forward at B=256 beside its bound and a
    bidirectional ``torch.nn.GRU``;
15. sequential multi-seed training ([multiseed]): ``apps.train --runs 2
    --runs-mode sequential`` at full width, 1 epoch, exact launch counts,
    per-seed checkpoints and ``experiment_multiseed.jsonl``; then
    ``apps.evaluate`` on both seeds' best checkpoints (2 members and the
    ensemble, exact launch counts);
16. the export and live-serving path ([serve]): kernel B's pair forward at
    the lookahead pair's T=512 and at B=8 against its plain version; phase
    9's best checkpoint exported by ``apps.export.main`` (kernel frontend,
    ``--stats-from`` a fold pack of the served file's statistics, per-class
    ``--threshold`` at gaps of the checkpoint's probabilities) and loaded on
    the card and the CPU; ``infer_file_artifact`` on the 120 s wav with and
    without lookahead, card vs CPU (1e-3, events equal) and against
    ``infer_file`` (1e-5, events equal) on the chunks that the zero-padded
    last chunk does not reach (the artifact normalizes the padding,
    ``infer_file`` pads after normalizing); ``serve_stream`` on random f32le
    packets (its events equal); the ``--listen`` daemon with
    ``--max-streams 8`` and 8 concurrent clients (each client's events equal,
    ticks between 21 and 8 x 21, kernel B launched 2 x ticks, kernel A once
    per non-empty framer block, every socket and join bounded); the serving
    rate, per-step p50/p99, the device idle share (torch.profiler) and
    ``stream_step_batch`` at B=8 against 8 x ``stream_step``;
17. stacked multi-seed training ([multiseed stacked]): kernel B with a seed
    axis (S in {1, 3, 5} at H in {8, 16}, B=128, T=8; S=2 at H=32, T=256)
    against its plain versions seed by seed, one launch per kernel for all
    S seeds x 2 directions, dwh bitwise equal run to run, and timed by
    events and device time beside S pair launches; timepooled-v2's bf16
    trunk on the card against the CPU's float32 forward within
    ``BF16_BAND`` x the JAX distance; ``apps.train --preset timepooled-v2
    --runs 5`` at full width in ``--runs-mode stacked`` (the main path) and
    ``sequential``: exact launch counts, per-seed histories within
    ``STACK_LOSS_RTOL`` / ``STACK_METRIC_ATOL``, equal best epochs, the
    aggregate training rates, one step of each mode timed and profiled;
    and the conv-128 split behind ``choose_runs_mode`` (timepooled-v1 x 2
    and x 4, sednet-dcase x 2, stacked against sequential steps).

The last lines are the card's name and power limit (nvidia-smi), one JSON
object with every kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12       # H100 SXM float32, outside the tensor cores
SR = 44100
FRAMES_PER_SEC = SR / 1024.0  # bench.py's unit
LOGMEL_ATOL = 5e-4
GRU_ATOL = 1e-5
PROB_ATOL = 1e-3
# Card vs CPU logits of the main path: float32 reassociation between cuDNN's
# and the CPU's convolutions and products, times the head's 8x last layer.
LOGIT_ATOL = 1e-3
# Kernel B's gradients against the plain loop, relative to each gradient's
# largest magnitude: dxp/dh0 come out of a 256-step chain, dwh/dbh are sums
# over B*T = 32,768 terms taken in another order.
GRAD_RTOL = 1e-4
# One train step, card vs CPU: the loss (a mean of float32 terms); Adam's
# first moment (the gradient times 0.1) per leaf, relative to the leaf's
# largest magnitude (cuDNN's and the CPU's convolution gradients sum in other
# orders; the first two blocks' weight gradients pass through train-mode
# BatchNorm's backward, which subtracts batch means, and reach ~1e-3 even
# between the CPU's own two convolution backends, which the phase prints);
# BatchNorm running statistics; parameters after Adam's step.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
STEP_BN_ATOL = 1e-5
STEP_PARAM_ATOL = 1e-5
TRAIN_BATCH = 128
GRU_T = 256
GRU_WIDTHS = (32, 16, 8)    # sednet's and timepooled-v1's H; timepooled-v2's two layers
# `torch.nn.GRU` computes the reset_after=True sigmoid recurrence (cuDNN's
# convention): its outputs against the plain version, float32 with sums in
# another order and cuDNN's own exp/tanh.
LIBRARY_ATOL = 1e-4
LIBRARY_VARIANT = "reset_after=True, sigmoid"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_flops = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def tones(seconds: float, seed: int, silent=()) -> np.ndarray:
    """Noise plus tone bursts (1 s on in turn for three tones), float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    y = 0.02 * rng.standard_normal(t.size)
    for k, f in enumerate((440.0, 1800.0, 5200.0)):
        y = y + ((np.floor(t) % 4) == k) * 0.3 * np.sin(2 * np.pi * f * t)
    for a, b in silent:
        y[int(a * SR) : int(b * SR)] = 0.0
    return y.astype(np.float32)


def bucket_signal(pcm: np.ndarray, cfg, bucket_seconds: float = 30.0) -> np.ndarray:
    """What `frontend.extract` hands the kernel: reflect-padded on the host,
    zero-extended to whole buckets, run uncentered."""
    y = np.pad(pcm, cfg.n_fft // 2, mode="reflect")
    bucket = int(bucket_seconds * cfg.sample_rate)
    return np.pad(y, (0, -(-len(y) // bucket) * bucket - len(y)))


def model_tree(model_cfg, seed: int):
    """A full-width JAX-layout (params, state) tree from a numpy seed, with
    fan-in scaled weights so the activations stay in range."""
    rng = np.random.default_rng(seed)

    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def b(n, scale=0.1):
        return (scale * rng.standard_normal(n)).astype(np.float32)

    params = {"conv": [], "bn": [], "gru": [], "head": []}
    state = {"bn": []}
    kh, kw = model_cfg.kernel_size
    c_in = model_cfg.in_channels
    for c in model_cfg.conv_channels:
        params["conv"].append({"w": w((kh, kw, c_in, c), kh * kw * c_in), "b": b(c)})
        params["bn"].append({"scale": (1.0 + b(c)).astype(np.float32), "bias": b(c)})
        state["bn"].append({"mean": b(c, 0.5),
                            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)})
        c_in = c
    non_time = model_cfg.n_mels        # the features left per frame after the trunk
    if model_cfg.pool_axis != "time":
        for p in model_cfg.pool:
            non_time //= p
    d_in = model_cfg.conv_channels[-1] * non_time
    reset_after = model_cfg.name != "sednet"     # the GRUs then carry bh too
    for h in model_cfg.gru_hidden:
        params["gru"].append({
            d: {"wi": w((d_in, 3 * h), d_in), "wh": w((h, 3 * h), h), "bi": b(3 * h),
                **({"bh": b(3 * h)} if reset_after else {})}
            for d in ("fwd", "bwd")
        })
        d_in = 2 * h
    for d in model_cfg.head_dims:
        params["head"].append({"w": w((d_in, d), d_in), "b": b(d)})
        d_in = d
    # Decisive logits: few probabilities near the 0.5 threshold, so that
    # float reassociation between card and CPU cannot flip an event edge.
    params["head"][-1]["w"] *= 8.0
    return params, state


# timepooled-v2's bf16 trunk: the distance of its logits from the float32
# forward may be at most BF16_BAND times the JAX package's own (jitted, on
# the CPU; tests/test_torch_bf16.py checks these values against JAX), per
# (weight seed, train mode) on `model_tree`'s weights and `bf16_input`.
BF16_BAND = 1.25
BF16_JAX_DIST = {
    (0, False): 0.017360568046569824, (0, True): 0.04473447799682617,
    (1, False): 0.0182037353515625, (1, True): 0.0627450942993164,
    (2, False): 0.018290996551513672, (2, True): 0.07585287094116211,
}


def bf16_input(seed: int) -> np.ndarray:
    """The band's input for weight seed ``seed``: 32 windows of 64 x 40."""
    return np.random.default_rng(100 + seed).standard_normal((32, 64, 40)).astype(np.float32)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from sed_crnn_torch.ops.kernels import _build

    seconds = _build.build_all()
    for name in _build.KERNEL_SOURCES:
        report = _build.ptxas_reports.get(name, "")
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {' | '.join(regs)}")
    print(f"[build] {len(_build.KERNEL_SOURCES)} kernels in {seconds:.2f} s "
          f"into {_build.BUILD_DIR}")


def _check_fft_body(tag: str, got, again, fft_plain) -> float:
    """Two runs of the FFT body bitwise equal, and their max|diff| against
    `fft_log_mel_plain` (the same float32 operations; only the log differs)
    at finite entries, with the same -inf pattern."""
    import torch

    check(torch.equal(got, again), f"{tag}: two runs of the kernel differ")
    fin = torch.isfinite(fft_plain)
    check(torch.equal(torch.isfinite(got), fin), f"{tag}: -inf pattern vs the fft plain version")
    err = float((got[fin] - fft_plain[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(err <= LOGMEL_ATOL, f"{tag}: {err} from the fft plain version")
    return err


def phase_logmel(main_signal: np.ndarray):
    import torch

    from sed_crnn_torch.core.config import FrontendConfig
    from sed_crnn_torch.ops.kernels.fused_logmel import (
        _launch_dft,
        fft_log_mel_plain,
        fused_log_mel,
        fused_log_mel_plain,
    )
    from sed_crnn_torch.ops.mel import mel_filterbank

    dev = torch.device("cuda")
    base = FrontendConfig()
    cases = [
        ("main path", main_signal, False),
        ("30s bucket", bucket_signal(tones(30.0, 1)[: 30 * SR - 2048], base), False),
        ("240s", tones(240.0, 2, silent=[(100.0, 101.5)]), True),
        ("ragged", tones(123457 / SR, 3), True),
        ("silence", np.zeros(5 * SR, np.float32), True),
    ]
    worst, worst_fft = 0.0, 0.0
    for name, y, center in cases:
        for floor in (None, 1e-10):
            cfg = dataclasses.replace(base, center=center, log_floor=floor)
            yt = torch.from_numpy(y).to(dev)
            got = fused_log_mel(yt, cfg)
            again = fused_log_mel(yt, cfg)
            want = fused_log_mel_plain(yt, cfg)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            check(torch.equal(torch.isfinite(got), fin), f"log-mel {name}: -inf pattern")
            check(torch.equal(got[~fin], want[~fin]), f"log-mel {name}: non-finite values")
            err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
            if name == "silence" and floor is None:
                check(not bool(fin.any()), "silence without a floor must be all -inf")
            check(err <= LOGMEL_ATOL, f"log-mel {name} floor={floor}: {err} > {LOGMEL_ATOL}")
            err_fft = _check_fft_body(f"log-mel {name} floor={floor}", got, again,
                                      fft_log_mel_plain(yt, cfg))
            worst, worst_fft = max(worst, err), max(worst_fft, err_fft)
            print(f"[kernel A] {name:10s} floor={floor}: shape {tuple(got.shape)} "
                  f"max|diff| at finite {err:.3g} (fft plain {err_fft:.3g}), "
                  f"two runs bitwise equal")

    # Times at the main path's shape: the 120 s file's bucket-padded signal.
    cfg = dataclasses.replace(base, center=False, log_floor=1e-10)
    yt = torch.from_numpy(main_signal).to(dev)
    n_frames = 1 + (len(main_signal) - cfg.n_fft) // cfg.hop_length
    fb = torch.from_numpy(mel_filterbank(SR, cfg.n_fft, cfg.n_mels)).to(dev)
    window = torch.hann_window(cfg.n_fft, periodic=True, device=dev)

    def library():
        spec = torch.stft(yt, cfg.n_fft, cfg.hop_length, window=window, center=False,
                          return_complex=True)
        return torch.log(torch.clamp_min(fb @ spec.abs().square(), 1e-10))

    kernel = lambda: fused_log_mel(yt, cfg)  # noqa: E731
    dft = lambda: _launch_dft(yt, cfg.hop_length, n_frames, cfg.n_fft, cfg, False)  # noqa: E731
    dft_err = _check_logmel("log-mel dft body (DIF) at the main-path shape", dft(),
                            fused_log_mel_plain(yt, cfg))
    ms = cuda_ms(kernel)
    cold = cuda_ms_cold(kernel)
    fft_plain = cuda_ms(lambda: fft_log_mel_plain(yt, cfg), reps=5)
    plain = cuda_ms(lambda: fused_log_mel_plain(yt, cfg), reps=5)
    lib_ms = cuda_ms(library)
    dft_ms = cuda_ms(dft)
    bnd, by, flops, nbytes = logmel_bound(len(main_signal), n_frames, cfg)
    audio_s = len(main_signal) / SR
    print(f"[kernel A] main-path shape (chunked, n_fft 2048 hop 1024): {n_frames} frames "
          f"({audio_s:.1f} s padded): kernel {ms:.4f} ms warm L2, {cold:.4f} ms cold L2, "
          f"plain (DIF) {plain:.4f} ms, torch.stft+mel {lib_ms:.4f} ms; bound {bnd:.4f} ms "
          f"({by}, rFFT+power+sparse mel {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
          f"kernel at {bnd / ms:.3f} of its bound; the dft body at this shape {dft_ms:.4f} ms "
          f"(vs the DIF plain version {dft_err:.3g}); the fft body's plain emulation "
          f"{fft_plain:.4f} ms")
    print(f"[kernel A] main-path shape, {split_line(bnd, kernel=kernel, library=library, dft=dft)}")
    y240 = torch.from_numpy(tones(240.0, 4)).to(dev)
    cfg240 = dataclasses.replace(base, log_floor=1e-10)
    ms240 = cuda_ms(lambda: fused_log_mel(y240, cfg240))
    cold240 = cuda_ms_cold(lambda: fused_log_mel(y240, cfg240))
    print(f"[kernel A] 240 s centered: kernel {ms240:.4f} ms warm L2 ({cold240:.4f} ms cold) -> "
          f"{240.0 / (ms240 / 1e3):,.0f} audio-sec/sec")
    return {"name": "fused_logmel", "route": "cuda",
            "source": "sed_crnn_torch/csrc/logmel_fft.cu",
            "replaces": "sed_crnn_tpu/ops/pallas/fused_logmel.py:173",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib_ms}, dft_err


def _gru_inputs(rng, dev, B: int, H: int, train: bool = False):
    """xp, wh, bh, h0 (and dys, dhl for ``train``) on the card, T=256."""
    import torch

    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    out = (t(rng.standard_normal((B, GRU_T, 3 * H))), t(0.3 * rng.standard_normal((H, 3 * H))),
           t(0.1 * rng.standard_normal(3 * H)), t(0.5 * rng.standard_normal((B, H))))
    if train:
        out += (t(rng.standard_normal((B, GRU_T, H))), t(rng.standard_normal((B, H))))
    return out


def _pair_of(sets, i, reset_after=True):
    """Argument i of both directions' operand sets, as a pair (None for bh
    when not ``reset_after``)."""
    return tuple(None if (i == 2 and not reset_after) else s[i] for s in sets)


def _library_gru(wh, bh):
    """`torch.nn.GRU` computing the ``reset_after=True`` sigmoid recurrence
    of pre-projected inputs: weight_ih = I, bias_ih = 0, weight_hh = wh^T,
    bias_hh = bh (gate order r, z, n in both)."""
    import torch

    H = wh.shape[0]
    g = torch.nn.GRU(3 * H, H, batch_first=True).to(wh.device)
    with torch.no_grad():
        g.weight_ih_l0.copy_(torch.eye(3 * H, device=wh.device))
        g.bias_ih_l0.zero_()
        g.weight_hh_l0.copy_(wh.T)
        g.bias_hh_l0.copy_(bh)
    return g


def phase_gru():
    """Kernel B's forward: the warp body (H <= 32) at H in {32, 16, 8} and
    the retained body at H=64 against the plain version, single directions
    and pair launches; times at the serving shape beside the retained body,
    two single launches, the plain version and `torch.nn.GRU`."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import (
        GATES,
        _fwd,
        gru_body,
        gru_scan,
        gru_scan_pair,
        gru_scan_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    worst = {"warp": 0.0, "retained": 0.0}
    _reset_gru_counts()
    n_warp = n_retained = 0
    for H in GRU_WIDTHS + (64,):
        body = gru_body(H)
        for B in (1, 8, 128) if body == "warp" else (1, 8):
            sets = [_gru_inputs(rng, dev, B, H) for _ in range(2)]   # direction 0 / 1
            errs = []
            for reset_after in (False, True):
                for gate in GATES:
                    want = []
                    for k, reverse in enumerate((False, True)):
                        xp, wh, bh, h0 = sets[k]
                        args = (xp, wh, bh if reset_after else None, h0, reset_after, gate, reverse)
                        got = gru_scan(*args)
                        want.append(gru_scan_plain(*args))
                        errs.append(max(_maxdiff(g, w) for g, w in zip(got, want[k])))
                    pair = gru_scan_pair(_pair_of(sets, 0), _pair_of(sets, 1),
                                         _pair_of(sets, 2, reset_after), _pair_of(sets, 3),
                                         reset_after, gate)
                    torch.cuda.synchronize()
                    for k in (0, 1):
                        errs.append(max(_maxdiff(g, w) for g, w in zip(pair[k], want[k])))
            err = max(errs)
            check(err <= GRU_ATOL, f"GRU {body} body H={H} B={B}: {err}")
            worst[body] = max(worst[body], err)
            launches = 8 + 4 * (1 if body == "warp" else 2)
            n_warp += launches * (body == "warp")
            n_retained += launches * (body == "retained")
            print(f"[kernel B] {body} body H={H:2d} B={B:3d}: 8 variants and 4 pair launches "
                  f"against the plain version, max|diff| {err:.3g}")
    counts = _gru_counts()
    check(counts["gru_scan_fwd"] == n_warp + n_retained and counts["gru_scan_retained"] == n_retained,
          f"phase 4 launches {counts}: {n_warp} warp, {n_retained} retained expected")

    # Times at the main path's shape: sednet streaming, B=1, reset_after=False.
    H, conf = 32, (False, "sigmoid")
    (xp, wh, bh, h0), (xp2, wh2, bh2, h02) = (_gru_inputs(rng, dev, 1, H) for _ in range(2))
    single = lambda: gru_scan(xp, wh, None, h0, *conf, False)  # noqa: E731
    retained = lambda: _fwd([xp], [wh], [None], [h0], [False], *conf, False, "retained")  # noqa: E731
    pair = lambda: gru_scan_pair((xp, xp2), (wh, wh2), (None, None), (h0, h02), *conf)  # noqa: E731
    two = lambda: (single(), gru_scan(xp2, wh2, None, h02, *conf, True))  # noqa: E731
    want = gru_scan_plain(xp, wh, None, h0, *conf, False)
    (ret_out,), _ = retained()
    ret_err = max(_maxdiff(ret_out[0], want[0]), _maxdiff(ret_out[2], want[1]))
    check(ret_err <= GRU_ATOL, f"retained body at the serving shape: {ret_err}")
    worst["retained"] = max(worst["retained"], ret_err)
    ms = cuda_ms(single, reps=50)
    ret_ms = cuda_ms(retained, reps=50)
    pair_ms = cuda_ms(pair, reps=50)
    two_ms = cuda_ms(two, reps=50)
    plain = cuda_ms(lambda: gru_scan_plain(xp, wh, None, h0, *conf, False), reps=5)
    T = GRU_T
    flops = T * (2 * H * 3 * H + 12 * H)
    nbytes = 4 * (T * 3 * H + H * 3 * H + H + T * H + H)
    bnd, by = bound_ms(nbytes, flops)
    # The library's function: reset_after=True, sigmoid, as the timepooled presets.
    lib = _library_gru(wh, bh)
    with torch.no_grad():
        lib_out, lib_h = lib(xp, h0[None])
        lib_ms = cuda_ms(lambda: lib(xp, h0[None]), reps=50)
    want = gru_scan_plain(xp, wh, bh, h0, True, "sigmoid", False)
    lib_err = max(_maxdiff(lib_out, want[0]), _maxdiff(lib_h[0], want[1]))
    check(lib_err <= LIBRARY_ATOL, f"torch.nn.GRU vs the plain reset_after=True version: {lib_err}")
    ra_ms = cuda_ms(lambda: gru_scan(xp, wh, bh, h0, True, "sigmoid", False), reps=50)
    print(f"[kernel B] serving shape B=1 T={T} H={H} reset_after=False: warp body {ms:.4f} ms "
          f"({ms / T * 1e3:.3f} us/step), retained body {ret_ms:.4f} ms (vs plain {ret_err:.3g}), "
          f"plain {plain:.4f} ms, bound {bnd:.6f} ms ({by}); both directions: one pair launch "
          f"{pair_ms:.4f} ms, two single launches {two_ms:.4f} ms")
    split = {}
    print(f"[kernel B] serving shape, "
          f"{split_line(bnd, split, kernel=single, retained=retained, pair=pair)}")
    print(f"[kernel B] reset_after=True sigmoid at B=1: warp body {ra_ms:.4f} ms, torch.nn.GRU "
          f"(weight_ih = I, weight_hh = wh^T; vs plain {lib_err:.3g}) {lib_ms:.4f} ms")
    entry = {"name": "gru_scan_fwd", "route": "cuda", "source": "sed_crnn_torch/csrc/gru_warp.cu",
             "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:94",
             "max_abs_err": worst["warp"], "ms": ms, "plain_ms": plain, "bound_ms": bnd,
             "bound_by": by, "library_ms": lib_ms, "library_variant": LIBRARY_VARIANT,
             "variant_ms": ra_ms, "device_ms": split["kernel"][0], "host_ms": split["kernel"][1]}
    return entry, {"fwd_err": worst["retained"], "fwd_ms": ret_ms, "fwd_plain_ms": plain,
                   "bound_ms": bnd, "bound_by": by}


def phase_main(workdir: str, pcm: np.ndarray):
    import torch

    from sed_crnn_torch.apps.infer import infer_file, load_model
    from sed_crnn_torch.core.checkpoint import load_checkpoint, save_checkpoint
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.data.rasterize import events_from_labels
    from sed_crnn_torch.data.wavio import write_wav
    from sed_crnn_torch.models.streaming import stream_logits, stream_probabilities
    from sed_crnn_torch.ops import frontend
    from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel

    preset = "sednet-dcase"
    cfg = get_preset(preset)
    params, state = model_tree(cfg.model, seed=11)
    ckpt = save_checkpoint(os.path.join(workdir, "sednet.npz"),
                           {"params": params, "model_state": state}, {"epoch": 0})
    wav = os.path.join(workdir, "tones_120s.wav")
    write_wav(wav, pcm, SR)
    fe_kernel = dataclasses.replace(cfg.frontend, backend="kernel", log_floor=1e-10)
    stats = frontend.fit_norm_stats(frontend.extract(pcm, fe_kernel, device="cpu"))
    stats = (stats.mean.numpy(), stats.scale.numpy())
    tree, _ = load_checkpoint(ckpt)
    pool = cfg.model.seq_len_in // cfg.model.seq_len_out
    out_hop = cfg.frontend.hop_length * pool

    def composition(device):
        model = load_model(tree, cfg.model, device)
        mel = frontend.normalize(frontend.extract(pcm, fe_kernel, device=device), stats)
        probs = stream_probabilities(model, mel)
        return probs, events_from_labels(probs, SR, out_hop, 0.5), model, mel

    _reset_logmel_counts()
    _reset_gru_counts()
    t0 = time.perf_counter()
    with _no_plain_gru_on_card() as plain_on_card:
        probs_i, events_i, _ = infer_file(wav, ckpt, preset, stats, device="cuda")
        probs_c, events_c, model_c, mel_c = composition("cuda")
        torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    logmel = _logmel_counts()
    gru = _gru_counts()
    launches = {"fused_logmel": fused_log_mel.launches, "gru_scan_fwd": gru["gru_scan_fwd"]}

    n_frames = mel_c.shape[0]
    n_chunks = -(-n_frames // cfg.model.seq_len_in)
    streams = 2
    kernel_extracts = 1   # the composition's extract; infer_file's preset frontend is fft
    check(logmel == {"chunked": kernel_extracts, "framed": 0, "exact": 0, "dft": 0},
          f"kernel A launches {logmel} != {kernel_extracts} chunked extract call, no dft body")
    # Kernel B: one pair launch per BiGRU layer (2) per chunk, on the warp body.
    want = _gru_path_counts(streams * 2 * n_chunks, 0)
    check(gru == want, f"kernel B launches {gru} != {want} (2 pairs x {n_chunks} chunks x "
          f"{streams} streams)")
    check(not plain_on_card, f"a GRU plain version ran on the card: {plain_on_card}")

    t0 = time.perf_counter()
    probs_i_cpu, events_i_cpu, _ = infer_file(wav, ckpt, preset, stats, device="cpu")
    probs_c_cpu, events_c_cpu, model_c_cpu, mel_c_cpu = composition("cpu")
    cpu_s = time.perf_counter() - t0

    # Logits before the sigmoid, which would hide a small error in the trunk
    # or the GRU where probabilities saturate.
    logits = stream_logits(model_c, mel_c).cpu()
    logits_cpu = stream_logits(model_c_cpu, mel_c_cpu)
    logit_err = float((logits - logits_cpu).abs().max())
    check(bool(torch.isfinite(logits).all()), "non-finite logits on the card")
    check(logit_err <= LOGIT_ATOL,
          f"card vs CPU logits {logit_err} > {LOGIT_ATOL}")
    print(f"[main] kernel composition logits {tuple(logits.shape)}: card vs CPU max|diff| "
          f"{logit_err:.3g} (|logit| up to {float(logits.abs().max()):.3g})")
    for name, g, c, eg, ec in (("infer_file", probs_i, probs_i_cpu, events_i, events_i_cpu),
                               ("kernel composition", probs_c, probs_c_cpu, events_c,
                                events_c_cpu)):
        check(g.shape == c.shape == (n_frames, cfg.model.n_classes), f"{name} shape {g.shape}")
        check(bool(np.isfinite(g).all()), f"{name}: non-finite probabilities")
        err = float(np.abs(g - c).max())
        check(err <= PROB_ATOL, f"{name}: card vs CPU probabilities {err} > {PROB_ATOL}")
        check(eg == ec, f"{name}: card and CPU events differ")
        print(f"[main] {name}: probs {g.shape}, card vs CPU max|diff| {err:.3g}, "
              f"{len(eg)} events equal, mean prob {float(g.mean()):.3f}")
    check(len(events_c) > 0, "the 120 s file decodes into events")
    print(f"[main] launches in the main path: {launches} ({n_chunks} chunks per stream, "
          f"{streams} streams); card {gpu_s:.2f} s, CPU {cpu_s:.2f} s")
    return launches, fe_kernel, load_model(tree, cfg.model, "cuda")


def phase_throughput(fe_kernel, model, pcm: np.ndarray):
    import torch

    from sed_crnn_torch.models.streaming import stream_logits
    from sed_crnn_torch.ops import frontend

    dev = torch.device("cuda")
    y240 = torch.from_numpy(tones(240.0, 5)).to(dev)
    for backend in ("fft", "matmul", "kernel"):
        cfg = dataclasses.replace(fe_kernel, backend=backend)
        ms = cuda_ms(lambda c=cfg: frontend.log_mel_energies(y240, c), reps=10)
        print(f"[throughput] frontend[{backend}] 240 s: {ms:.3f} ms -> "
              f"{240.0 / (ms / 1e3):,.0f} audio-sec/sec")
    times = []
    for _ in range(4):   # host padding + copy to the card + kernel + trim
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frontend.extract(pcm, fe_kernel, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    audio = len(pcm) / SR
    print(f"[throughput] extract[kernel] {audio:.0f} s file, host clock: "
          f"{min(times[1:]) * 1e3:.2f} ms -> {audio / min(times[1:]):,.0f} audio-sec/sec")
    frames = 103_000  # bench.py's streaming input
    mel = torch.from_numpy(
        np.random.default_rng(6).standard_normal((frames, 40)).astype(np.float32)).to(dev)
    stream_logits(model, mel[:2048])
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream_logits(model, mel)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    audio = frames / FRAMES_PER_SEC
    print(f"[throughput] sednet streaming {frames} frames ({audio:.0f} s audio): "
          f"{dt * 1e3:.1f} ms -> {audio / dt:,.0f} audio-sec/sec")
    profile_streaming(model, mel[: 40 * 256])


def profile_streaming(model, mel):
    """Device time by kernel over one streamed stretch (torch.profiler), and
    the device's idle share against the same call's unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sed_crnn_torch.models.streaming import stream_logits

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream_logits(model, mel)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stream_logits(model, mel)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    n_chunks = mel.shape[0] // model.cfg.seq_len_in
    if busy_us == 0:
        print("[profile] streaming: the profiler recorded no device time (not measured)")
        return
    print(f"[profile] streaming {n_chunks} chunks: wall {wall_us / 1e3:.2f} ms unprofiled, "
          f"device busy {busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / busy_us:6.1%} "
              f"{e.self_device_time_total / 1e3:8.2f} ms x{e.count:5d}  {e.key[:90]}")


def _maxdiff(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def _by_kernel(fn, reps: int = 20) -> dict:
    """torch.profiler's device ms per call of ``fn``, by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3 for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def _part(split: dict, *names) -> float:
    return sum(v for k, v in split.items() if any(n in k for n in names))


def phase_gru_train(retained: dict):
    """Kernel B's residual forward, backward and dwh reduction: the warp body
    at H in {32, 16, 8} and the retained body at H=64 against their plain
    versions, single directions and pair launches; the retained body driven
    once through a BiGRU at H=64; times at the training shape (B=128, T=256,
    H=32) beside the retained body, two single launches, the plain versions
    and `torch.nn.GRU`."""
    import torch

    from sed_crnn_torch.nn.gru import BiGRU
    from sed_crnn_torch.ops.kernels.gru_scan import (
        GATES,
        _bwd,
        _fwd,
        gru_body,
        gru_dwh_plain,
        gru_scan_bwd,
        gru_scan_bwd_plain,
        gru_scan_fwd_res,
        gru_scan_fwd_res_plain,
        gru_scan_pair_bwd,
        gru_scan_pair_fwd_res,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    worst = {b: {"fwd": 0.0, "bwd": 0.0, "dwh": 0.0} for b in ("warp", "retained")}
    grads = ("dxp", "dwh", "dbh", "dh0")

    def rel(got, want, tag, names=grads):
        worst_rel = 0.0
        for name, g, w in zip(names, got, want):
            e, scale = _maxdiff(g, w), float(w.abs().max())
            check(e <= GRAD_RTOL * scale, f"{tag} {name}: {e} > {GRAD_RTOL} x {scale}")
            worst_rel = max(worst_rel, e / scale if scale else 0.0)
        return worst_rel

    for H in GRU_WIDTHS + (64,):
        body = gru_body(H, backward=True)
        for B in (1, 8, 128) if body == "warp" else (1, 8):
            sets = [_gru_inputs(rng, dev, B, H, train=True) for _ in range(2)]
            fwd_errs, rels, dwh_rels = [], [], []
            for reset_after in (False, True):
                for gate in GATES:
                    want_f, want_b, got_b = [], [], []
                    for k, reverse in enumerate((False, True)):
                        xp, wh, bh, h0, dys, dhl = sets[k]
                        conf = (reset_after, gate, reverse)
                        b = bh if reset_after else None
                        ys, res, hl = gru_scan_fwd_res(xp, wh, b, h0, *conf)
                        want_f.append(gru_scan_fwd_res_plain(xp, wh, b, h0, *conf))
                        torch.cuda.synchronize()
                        fwd_errs.append(max(_maxdiff(g, w) for g, w in zip((ys, res, hl), want_f[k])))
                        got_b.append(gru_scan_bwd(ys, res, wh, h0, dys, dhl, *conf))
                        want_b.append(gru_scan_bwd_plain(ys, res, wh, h0, dys, dhl, *conf))
                        torch.cuda.synchronize()
                        rels.append(rel(got_b[k], want_b[k], f"GRU bwd H={H} B={B} {conf}"))
                        # The reduction against its reference on the kernel's own dxp.
                        dwh, dbh = gru_dwh_plain(ys, res, h0, got_b[k][0], reset_after, reverse)
                        dwh_rels.append(rel((dwh, dbh), got_b[k][1:3], f"GRU dwh H={H} B={B} {conf}",
                                            ("dwh", "dbh")))
                    args = [_pair_of(sets, i, reset_after) for i in range(4)]
                    pair = gru_scan_pair_fwd_res(*args, reset_after, gate)
                    pair_b = gru_scan_pair_bwd(
                        tuple(p[0] for p in pair), tuple(p[1] for p in pair), args[1], args[3],
                        _pair_of(sets, 4), _pair_of(sets, 5), reset_after, gate)
                    torch.cuda.synchronize()
                    for k in (0, 1):
                        fwd_errs.append(max(_maxdiff(g, w) for g, w in zip(pair[k], want_f[k])))
                        rels.append(rel(pair_b[k], want_b[k], f"GRU pair bwd H={H} B={B}"))
            err = max(fwd_errs)
            check(err <= GRU_ATOL, f"GRU fwd_res {body} body H={H} B={B}: {err}")
            w = worst[body]
            w["fwd"], w["bwd"] = max(w["fwd"], err), max(w["bwd"], max(rels))
            w["dwh"] = max(w["dwh"], max(dwh_rels))
            print(f"[kernel B train] {body} body H={H:2d} B={B:3d}: 8 variants and 4 pair launches, "
                  f"fwd_res max|diff| {err:.3g}, backward max|diff| / max|grad| {max(rels):.3g}, "
                  f"dwh/dbh vs gru_dwh_plain on the kernel's dxp {max(dwh_rels):.3g}")

    # The retained body's own main path: a BiGRU at H=64 trained one step
    # (autograd through GruScanPairFn: one pair residual forward, one pair
    # backward, two launches each on this body).
    gen = torch.Generator().manual_seed(4)
    layer = BiGRU(96, 64, False, "sigmoid")
    layer.init_parameters(gen)
    layer.to(dev)
    x = torch.randn(16, GRU_T, 96, generator=gen).to(dev)
    _reset_gru_counts()
    y, _ = layer(x)
    y.square().mean().backward()
    torch.cuda.synchronize()
    ret_launches = _gru_counts()
    check(ret_launches["gru_scan_retained"] == 4 and ret_launches["gru_dwh"] == 0
          and ret_launches["gru_scan_fwd_res"] == 2 and ret_launches["gru_scan_bwd"] == 2,
          f"BiGRU H=64 launches {ret_launches}")
    check(all(bool(torch.isfinite(p.grad).all()) for p in layer.parameters()), "BiGRU H=64 grads")
    print(f"[kernel B retained] BiGRU(96, 64) one train step at B=16 T={GRU_T}: launches "
          f"{ret_launches}")

    # Times at the training shape: sednet, reset_after=False, sigmoid.
    B, H, T, conf = TRAIN_BATCH, 32, GRU_T, (False, "sigmoid", False)
    xp, wh, bh, h0, dys, dhl = _gru_inputs(rng, dev, B, H, train=True)
    xp2, wh2, bh2, h02, dys2, dhl2 = _gru_inputs(rng, dev, B, H, train=True)
    ys, res, _ = gru_scan_fwd_res(xp, wh, None, h0, *conf)
    ys2, res2, _ = gru_scan_fwd_res(xp2, wh2, None, h02, False, "sigmoid", True)
    first = gru_scan_bwd(ys, res, wh, h0, dys, dhl, *conf)
    second = gru_scan_bwd(ys, res, wh, h0, dys, dhl, *conf)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "the backward is not deterministic from run to run")
    fwd = lambda: gru_scan_fwd_res(xp, wh, None, h0, *conf)  # noqa: E731
    bwd = lambda: gru_scan_bwd(ys, res, wh, h0, dys, dhl, *conf)  # noqa: E731
    ret_fwd = lambda: _fwd([xp], [wh], [None], [h0], [False], False, "sigmoid", True, "retained")  # noqa: E731
    ret_bwd = lambda: _bwd([ys], [res], [wh], [h0], [dys], [dhl], [False], False, "sigmoid",  # noqa: E731
                           "retained")
    (rf,), _ = ret_fwd()
    (rb,) = ret_bwd()
    want_f = gru_scan_fwd_res_plain(xp, wh, None, h0, *conf)
    ret_err = max(_maxdiff(g, w) for g, w in zip(rf, want_f))
    check(ret_err <= GRU_ATOL, f"retained fwd_res at the training shape: {ret_err}")
    ret_rel = rel(rb, gru_scan_bwd_plain(ys, res, wh, h0, dys, dhl, *conf),
                  "retained bwd at the training shape")
    pair_fwd = lambda: gru_scan_pair_fwd_res((xp, xp2), (wh, wh2), (None, None), (h0, h02),  # noqa: E731
                                             False, "sigmoid")
    two_fwd = lambda: (fwd(), gru_scan_fwd_res(xp2, wh2, None, h02, False, "sigmoid", True))  # noqa: E731
    pair_bwd = lambda: gru_scan_pair_bwd((ys, ys2), (res, res2), (wh, wh2), (h0, h02),  # noqa: E731
                                         (dys, dys2), (dhl, dhl2), False, "sigmoid")
    two_bwd = lambda: (bwd(), gru_scan_bwd(ys2, res2, wh2, h02, dys2, dhl2,  # noqa: E731
                                           False, "sigmoid", True))
    dxp = first[0]
    dwh_plain_fn = lambda: gru_dwh_plain(ys, res, h0, dxp, False, False)  # noqa: E731
    fwd_ms, bwd_ms = cuda_ms(fwd, reps=50), cuda_ms(bwd, reps=50)
    ret_fwd_ms, ret_bwd_ms = cuda_ms(ret_fwd, reps=20), cuda_ms(ret_bwd, reps=20)
    pair_fwd_ms, two_fwd_ms = cuda_ms(pair_fwd, reps=50), cuda_ms(two_fwd, reps=50)
    pair_bwd_ms, two_bwd_ms = cuda_ms(pair_bwd, reps=50), cuda_ms(two_bwd, reps=50)
    fwd_plain = cuda_ms(lambda: gru_scan_fwd_res_plain(xp, wh, None, h0, *conf), reps=3, warmup=1)
    bwd_plain = cuda_ms(lambda: gru_scan_bwd_plain(ys, res, wh, h0, dys, dhl, *conf),
                        reps=3, warmup=1)
    dwh_plain_ms = cuda_ms(dwh_plain_fn, reps=20)
    split = _by_kernel(bwd)
    ret_split = _by_kernel(ret_bwd)
    chain_ms = _part(split, "gru_warp_bwd")
    dwh_ms = _part(split, "gru_warp_dwh", "gru_warp_sum")
    f = 4
    fwd_bytes = f * (B * T * 3 * H + H * 3 * H + 2 * B * H + B * T * H + B * T * 3 * H)
    fwd_flops = T * B * (2 * H * 3 * H + 12 * H)
    bwd_bytes = f * (B * T * H + B * T * 3 * H + H * 3 * H + 2 * B * H + B * T * H
                     + B * T * 3 * H + H * 3 * H + 3 * H + B * H)
    bwd_flops = T * B * (2 * 2 * H * 3 * H + 20 * H)
    dwh_bytes = f * (B * T * H + B * T * H + B * T * 3 * H + B * H + H * 3 * H + 3 * H)
    dwh_flops = B * T * (2 * H * 3 * H + H)
    fb, fby = bound_ms(fwd_bytes, fwd_flops)
    bb, bby = bound_ms(bwd_bytes, bwd_flops)
    db, dby = bound_ms(dwh_bytes, dwh_flops)
    print(f"[kernel B train] B={B} T={T} H={H} reset_after=False: fwd_res warp body {fwd_ms:.4f} ms "
          f"({fwd_ms / T * 1e3:.3f} us/step), retained body {ret_fwd_ms:.4f} ms (vs plain "
          f"{ret_err:.3g}), plain {fwd_plain:.2f} ms, bound {fb:.5f} ms ({fby}, "
          f"{fwd_bytes / 1e6:.1f} MB); both directions: one pair launch {pair_fwd_ms:.4f} ms, "
          f"two single launches {two_fwd_ms:.4f} ms")
    print(f"[kernel B train] backward (chain + dwh reduction + partial sum) warp body "
          f"{bwd_ms:.4f} ms ({bwd_ms / T * 1e3:.3f} us/step), retained body {ret_bwd_ms:.4f} ms "
          f"(vs plain {ret_rel:.3g} of max|grad|), plain {bwd_plain:.2f} ms, bound {bb:.5f} ms "
          f"({bby}, {bwd_bytes / 1e6:.1f} MB); both directions: one pair {pair_bwd_ms:.4f} ms, "
          f"two singles {two_bwd_ms:.4f} ms; dwh bitwise equal across runs")
    print("[kernel B train] backward device ms per call by kernel (torch.profiler): warp body "
          + ", ".join(f"{k[:40]} {v:.4f}" for k, v in split.items()) + "; retained body "
          + ", ".join(f"{k[:40]} {v:.4f}" for k, v in ret_split.items()))
    print(f"[kernel B train] dwh reduction + partial sum {dwh_ms:.4f} ms device, "
          f"gru_dwh_plain {dwh_plain_ms:.4f} ms, bound {db:.5f} ms ({dby}, "
          f"{dwh_bytes / 1e6:.1f} MB)")
    bwd_split, fwd_split = {}, {}
    print(f"[kernel B train] "
          f"{split_line(bb, bwd_split, kernel=bwd, retained=ret_bwd, pair=pair_bwd)}")
    print(f"[kernel B train] fwd_res "
          f"{split_line(fb, fwd_split, kernel=fwd, retained=ret_fwd, pair=pair_fwd)}")

    # The library's function: reset_after=True, sigmoid.
    lib_times, own = {}, {}
    for b_ in (1, TRAIN_BATCH):
        xq, whq, bhq, h0q, dyq, dhq = _gru_inputs(rng, dev, b_, H, train=True)
        lib = _library_gru(whq, bhq)
        x_in = xq.clone().requires_grad_()
        out, hl = lib(x_in, h0q[None])
        want = gru_scan_fwd_res_plain(xq, whq, bhq, h0q, True, "sigmoid", False)
        lib_err = max(_maxdiff(out, want[0]), _maxdiff(hl[0], want[2]))
        check(lib_err <= LIBRARY_ATOL, f"torch.nn.GRU B={b_} vs plain: {lib_err}")
        lib_fwd = cuda_ms(lambda: lib(x_in, h0q[None]), reps=50)

        def lib_fwd_bwd():
            o, _ = lib(x_in, h0q[None])
            torch.autograd.backward(o, dyq)

        lib_times[b_] = (lib_fwd, cuda_ms(lib_fwd_bwd, reps=50) - lib_fwd, lib_err)
        ysq, resq, _ = gru_scan_fwd_res(xq, whq, bhq, h0q, True, "sigmoid", False)
        own[b_] = (cuda_ms(lambda: gru_scan_fwd_res(xq, whq, bhq, h0q, True, "sigmoid", False),
                           reps=50),
                   cuda_ms(lambda: gru_scan_bwd(ysq, resq, whq, h0q, dyq, dhq, True, "sigmoid",
                                                False), reps=50))
        print(f"[kernel B train] reset_after=True sigmoid B={b_}: warp body fwd_res {own[b_][0]:.4f} "
              f"ms, backward {own[b_][1]:.4f} ms; torch.nn.GRU (vs plain {lib_err:.3g}) forward "
              f"{lib_fwd:.4f} ms, backward {lib_times[b_][1]:.4f} ms")
    common = {"route": "cuda", "source": "sed_crnn_torch/csrc/gru_warp.cu",
              "library_variant": LIBRARY_VARIANT}
    w = worst["warp"]
    return (
        {"name": "gru_scan_fwd_res", **common,
         "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:94",
         "max_abs_err": w["fwd"], "ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": fb,
         "bound_by": fby, "library_ms": lib_times[TRAIN_BATCH][0],
         "variant_ms": own[TRAIN_BATCH][0], "device_ms": fwd_split["kernel"][0],
         "host_ms": fwd_split["kernel"][1]},
        {"name": "gru_scan_bwd", **common,
         "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:154",
         "max_abs_err": w["bwd"], "ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": bb,
         "bound_by": bby, "library_ms": lib_times[TRAIN_BATCH][1],
         "variant_ms": own[TRAIN_BATCH][1], "device_ms": bwd_split["kernel"][0],
         "host_ms": bwd_split["kernel"][1], "chain_ms": chain_ms},
        {"name": "gru_dwh", "route": "cuda", "source": "sed_crnn_torch/csrc/gru_warp.cu",
         "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:154",
         "max_abs_err": w["dwh"], "ms": dwh_ms, "plain_ms": dwh_plain_ms, "bound_ms": db,
         "bound_by": dby, "library_ms": None},
        {"name": "gru_scan_retained", "route": "cuda",
         "source": "sed_crnn_torch/csrc/gru_scan.cu",
         "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:94",
         "max_abs_err": max(retained["fwd_err"], worst["retained"]["fwd"]),
         "ms": retained["fwd_ms"], "plain_ms": retained["fwd_plain_ms"],
         "bound_ms": retained["bound_ms"], "bound_by": retained["bound_by"], "library_ms": None,
         "launches": ret_launches["gru_scan_retained"], "train_fwd_ms": ret_fwd_ms,
         "train_bwd_ms": ret_bwd_ms, "bwd_max_rel_err": max(ret_rel, worst["retained"]["bwd"])},
    )


def _leaves(tree, path=""):
    """(path, array) for every leaf of a checkpoint tree, in tree order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def _gru_counts():
    from sed_crnn_torch.ops.kernels.gru_scan import gru_scan, gru_scan_bwd, gru_scan_fwd_res

    return {"gru_scan_fwd": gru_scan.launches, "gru_scan_fwd_res": gru_scan_fwd_res.launches,
            "gru_scan_bwd": gru_scan_bwd.launches, "gru_dwh": gru_scan_bwd.dwh_launches,
            "gru_scan_sum_partials": gru_scan_bwd.sum_launches,
            "gru_scan_retained": gru_scan.retained_launches}


def _reset_gru_counts():
    from sed_crnn_torch.ops.kernels.gru_scan import gru_scan, gru_scan_bwd, gru_scan_fwd_res

    gru_scan.launches = gru_scan_fwd_res.launches = gru_scan.retained_launches = 0
    gru_scan_bwd.launches = gru_scan_bwd.dwh_launches = gru_scan_bwd.sum_launches = 0


def _gru_path_counts(fwd: int, steps: int) -> dict:
    """Exact GRU launch counts of a path with ``fwd`` no-grad BiGRU layer
    calls and ``steps`` train-step BiGRU layer calls: one pair launch of
    each kernel per layer call, all on the warp body."""
    return {"gru_scan_fwd": fwd, "gru_scan_fwd_res": steps, "gru_scan_bwd": steps,
            "gru_dwh": steps, "gru_scan_sum_partials": steps, "gru_scan_retained": 0}


@contextlib.contextmanager
def _no_plain_gru_on_card():
    """Count calls of the GRU plain versions on CUDA tensors while the block
    runs (the wrappers reach them through the module's globals); yields the
    list of such calls, which a driven path leaves empty."""
    from sed_crnn_torch.ops.kernels import gru_scan as mod

    names = ("gru_scan_plain", "gru_scan_fwd_res_plain", "gru_scan_bwd_plain", "gru_dwh_plain")
    saved = {n: getattr(mod, n) for n in names}
    hits = []

    def counting(name, fn):
        def wrapped(first, *args, **kwargs):
            if first.is_cuda:
                hits.append(name)
            return fn(first, *args, **kwargs)
        return wrapped

    for n in names:
        setattr(mod, n, counting(n, saved[n]))
    try:
        yield hits
    finally:
        for n in names:
            setattr(mod, n, saved[n])


def phase_train_step():
    """One full-width sednet-dcase train step on the card and on the CPU from
    the same weights and batch, dropout 0."""
    import torch

    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.models import get_model
    from sed_crnn_torch.models.convert import from_jax
    from sed_crnn_torch.train.loop import Trainer, TrainState, checkpoint_tree

    cfg = get_preset("sednet-dcase")
    mcfg = dataclasses.replace(cfg.model, dropout=0.0)
    params, state = model_tree(cfg.model, seed=11)
    batch = 16   # the CPU's side of the comparison takes a few seconds at this size
    rng = np.random.default_rng(12)
    x = rng.standard_normal((batch, mcfg.seq_len_in, mcfg.n_mels)).astype(np.float32)
    y = (rng.random((batch, mcfg.seq_len_out, mcfg.n_classes)) > 0.8).astype(np.float32)

    def step(device):
        model = get_model(mcfg)
        model.load_state_dict(from_jax(params, state, mcfg))
        trainer = Trainer(model.to(device), cfg.train, None, None)
        st = TrainState(trainer.adam.init({k: p.detach() for k, p in trainer.params().items()}),
                        1.0)
        st, loss, _ = trainer.train_step(st, torch.from_numpy(x).to(device),
                                         torch.from_numpy(y).to(device))
        return float(loss), checkpoint_tree(trainer, st)

    _reset_gru_counts()
    _reset_logmel_counts()
    with _no_plain_gru_on_card() as plain_on_card:
        loss_g, tree_g = step("cuda")
        torch.cuda.synchronize()
    launches = _gru_counts()
    check(not any(_logmel_counts().values()), f"train step log-mel launches {_logmel_counts()}")
    want = _gru_path_counts(0, 2)   # one pair per BiGRU layer, forward and backward
    check(launches == want, f"train step launches {launches} != {want}")
    check(not plain_on_card, f"a GRU plain version ran on the card: {plain_on_card}")
    t0 = time.perf_counter()
    loss_c, tree_c = step("cpu")
    cpu_s = time.perf_counter() - t0
    # The CPU against itself with its other convolution backend: how far
    # float32 alone moves these gradients (the conditioning of the band).
    with torch.backends.mkldnn.flags(enabled=False):
        _, tree_c2 = step("cpu")
    check(np.isfinite(loss_g), "non-finite loss on the card")
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    check(loss_rel <= STEP_LOSS_RTOL, f"train step loss {loss_g} vs {loss_c}")

    mu_g = dict(_leaves(tree_g["opt_state"]["mu"]))
    mu_c = dict(_leaves(tree_c["opt_state"]["mu"]))
    mu_c2 = dict(_leaves(tree_c2["opt_state"]["mu"]))
    cpu_spread, cpu_leaf = max(
        (float(np.abs(mu_c2[k] - c).max() / np.abs(c).max()), k)
        for k, c in mu_c.items() if not (k.startswith("/conv/") and k.endswith("/b")))
    tree_scale = max(float(np.abs(a).max()) for a in mu_c.values())
    worst_grad, worst_leaf, unclear = 0.0, "", 0
    for (path, p_g), (_, p_c) in zip(_leaves(tree_g["params"]), _leaves(tree_c["params"])):
        g, c = mu_g[path], mu_c[path]
        scale = float(np.abs(c).max())
        lr = cfg.train.learning_rate
        # Adam's first step moves an element by about lr * sign(g) whatever
        # |g| is, so elements whose gradient lies inside the band may move
        # apart by up to 2 lr; the rest agree to STEP_PARAM_ATOL.
        check(float(np.abs(p_g - p_c).max()) <= 2 * lr + STEP_PARAM_ATOL, f"{path} after Adam")
        if path.startswith("/conv/") and path.endswith("/b"):
            # A conv bias ahead of a train-mode BatchNorm has an exact
            # gradient of 0 (the batch mean removes any per-channel shift):
            # both sides hold rounding noise, held to the tree's scale, and
            # every element of the leaf lies inside the band.
            check(max(float(np.abs(g).max()), scale) <= 1e-4 * tree_scale,
                  f"{path}: gradient of a bias ahead of BatchNorm is not ~0")
            unclear += g.size
            continue
        err = float(np.abs(g - c).max()) / scale
        check(err <= STEP_GRAD_RTOL, f"train step gradient {path}: {err} of its max")
        if err > worst_grad:
            worst_grad, worst_leaf = err, path
        clear = np.abs(c) > STEP_GRAD_RTOL * scale
        unclear += int((~clear).sum())
        if clear.any():
            err = float(np.abs(p_g[clear] - p_c[clear]).max())
            check(err <= STEP_PARAM_ATOL, f"{path} after Adam: {err}")
    bn_err = max(float(np.abs(a - b).max()) for (_, a), (_, b) in
                 zip(_leaves(tree_g["model_state"]), _leaves(tree_c["model_state"])))
    check(bn_err <= STEP_BN_ATOL, f"BatchNorm running statistics: {bn_err}")
    print(f"[train step] sednet-dcase full width, batch {batch}, dropout 0: loss card "
          f"{loss_g:.6f} vs CPU {loss_c:.6f} (rel {loss_rel:.2g}); gradients (Adam's mu) "
          f"max|diff| / leaf max {worst_grad:.3g} ({worst_leaf}; the CPU's two convolution "
          f"backends differ by {cpu_spread:.3g} at {cpu_leaf}); BatchNorm stats {bn_err:.3g}; "
          f"{unclear} parameter elements with |g| inside the band; launches {launches}; "
          f"CPU step {cpu_s:.2f} s")


def phase_train(workdir: str):
    """`run_fold` at the preset's full size on synthetic folds, on the card."""
    import torch

    from sed_crnn_torch.apps.infer import load_model
    from sed_crnn_torch.apps.train import synthetic_folds
    from sed_crnn_torch.core.checkpoint import load_checkpoint
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.train.loop import Trainer, make_samplers, run_fold

    cfg = get_preset("sednet-dcase")
    epochs = 2
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_epochs=epochs, plot_every=0))
    frames = int(cfg.train.batch_size * cfg.model.seq_len_in * 1.3)   # as apps.train does
    fold = synthetic_folds(1, frames=frames, n_classes=cfg.model.n_classes)[1]
    dev = torch.device("cuda")
    tr, val = make_samplers(cfg, fold, dev)
    n_train, n_sweep = tr.steps_per_epoch(cfg.train.batch_size), val.sweep_steps(cfg.train.batch_size)
    art = os.path.join(workdir, "fold1")

    _reset_gru_counts()
    _reset_logmel_counts()
    t0 = time.perf_counter()
    with _no_plain_gru_on_card() as plain_on_card:
        res = run_fold(cfg, fold, 1, art, device="cuda", verbose=False)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _gru_counts()
    check(not any(_logmel_counts().values()), f"run_fold log-mel launches {_logmel_counts()}")
    want = _gru_path_counts(2 * n_sweep * epochs, 2 * n_train * epochs)
    check(launches == want, f"run_fold launches {launches} != {want}")
    check(not plain_on_card, f"a GRU plain version ran on the card: {plain_on_card}")
    check(res.epochs_run == epochs, f"run_fold ran {res.epochs_run} epochs")
    for k in ("loss_tr", "loss_val"):
        v = res.history[k]
        check(len(v) == epochs and bool(np.isfinite(v).all()), f"history {k}: {v}")
    best, last = os.path.join(art, "best_fold1.npz"), os.path.join(art, "last_fold1.npz")
    check(os.path.exists(best) and os.path.exists(last), "best/last checkpoints written")

    tree, meta = load_checkpoint(last)
    check(set(tree) >= {"params", "model_state", "opt_state", "lr_scale"}
          and int(tree["opt_state"]["step"]) == n_train * epochs,
          f"last checkpoint layout {sorted(tree)}")
    model = load_model(tree, cfg.model, dev)
    scores = Trainer(model, cfg.train, tr, val).eval_sweep(None)
    loss_val = float(scores["loss"])
    check(abs(loss_val - res.history["loss_val"][-1]) <= 1e-6 * abs(loss_val),
          f"checkpoint's validation loss {loss_val} vs the run's {res.history['loss_val'][-1]}")
    check(float(scores["er_overall_1sec"]) == res.history["er_1s_val"][-1],
          "checkpoint's validation ER differs from the run's")
    n = min(4, val.n_windows)
    x = val.data["mel"][: n * cfg.model.seq_len_in].reshape(n, cfg.model.seq_len_in, -1)
    with torch.no_grad():
        logits = model.eval()(x)[0].cpu()
        logits_cpu = load_model(tree, cfg.model, "cpu").eval()(x.cpu())[0]
    logit_err = float((logits - logits_cpu).abs().max())
    check(logit_err <= LOGIT_ATOL, f"checkpoint logits card vs CPU {logit_err}")
    epoch_sec = [json.loads(ln)["epoch_sec"] for ln in open(os.path.join(art, "train_fold1.jsonl"))]
    print(f"[train] run_fold sednet-dcase full width, {frames} frames per train split: "
          f"{epochs} epochs x {n_train} steps at batch {cfg.train.batch_size}, "
          f"{n_sweep} sweep step(s) per epoch, in {wall:.2f} s (epoch_sec {epoch_sec}); "
          f"loss_tr {res.history['loss_tr']}, loss_val {res.history['loss_val']}, "
          f"ER_1s_val {res.history['er_1s_val']}; last checkpoint serves the same val scores "
          f"(loss {loss_val:.6f}) and card vs CPU logits within {logit_err:.3g}; "
          f"launches {launches}")
    return launches, cfg, fold


def phase_train_throughput(cfg, fold):
    """Train-step time at batch 128 and the training rate; a profile of one step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sed_crnn_torch.models import get_model
    from sed_crnn_torch.models.convert import from_jax
    from sed_crnn_torch.train.loop import Rngs, Trainer, TrainState, make_samplers

    dev = torch.device("cuda")
    params, state = model_tree(cfg.model, seed=11)
    model = get_model(cfg.model)
    model.load_state_dict(from_jax(params, state, cfg.model))
    tr, val = make_samplers(cfg, fold, dev)
    trainer = Trainer(model.to(dev), cfg.train, tr, val)
    st = TrainState(trainer.adam.init({k: p.detach() for k, p in trainer.params().items()}), 1.0)
    rngs = Rngs(dev, 0, model.n_dropout_sites)
    batch = cfg.train.batch_size

    def one_step():
        nonlocal st
        x, y = tr.sample_batch(rngs.batch, batch)
        st, _, _ = trainer.train_step(st, x, y, rngs.dropout)

    for _ in range(3):
        one_step()
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = float(np.median(times)) * 1e3
    event_ms = cuda_ms(one_step, reps=10, warmup=1)
    audio = batch * cfg.model.seq_len_in / FRAMES_PER_SEC
    print(f"[throughput] train step sednet-dcase batch {batch} x {cfg.model.seq_len_in} frames "
          f"(dropout {cfg.model.dropout}): host clock median {step_ms:.2f} ms "
          f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), CUDA events "
          f"{event_ms:.2f} ms -> {audio / (step_ms / 1e3):,.0f} audio-sec/sec "
          f"({audio:.1f} audio-s per step)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_step()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us == 0:
        print("[profile] train step: the profiler recorded no device time (not measured)")
        return step_ms
    print(f"[profile] train step: wall {wall_us / 1e3:.2f} ms unprofiled, device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {max(0.0, 1 - busy_us / wall_us):.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"[profile]   {e.self_device_time_total / busy_us:6.1%} "
              f"{e.self_device_time_total / 1e3:8.3f} ms x{e.count:5d}  {e.key[:90]}")
    return step_ms


def cuda_ms_cold(fn, reps: int = 10) -> float:
    """Mean device milliseconds per call with a cold L2: a 256 MB write
    evicts the 50 MB L2 before each call, and CUDA events bracket the call
    alone."""
    import torch

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_host_ms(fn, reps: int = 20):
    """(device-busy ms, host ms) per call: the self device time of all that
    ``fn`` launches, summed by torch.profiler over ``reps`` calls (None where
    it records none), and the host's time to issue one call, by the host
    clock around ``reps`` calls that are not waited for. CUDA events around
    back-to-back calls (`cuda_ms`) read the larger of the two."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return (busy_us / reps / 1e3 if busy_us > 0 else None), host


def split_line(bnd: float, measured: dict | None = None, **fns) -> str:
    """`device_host_ms` of each named function, the kernel's device time
    against its bound; each (device, host) pair also lands in ``measured``."""
    parts = []
    for name, fn in fns.items():
        dev, host = device_host_ms(fn)
        if measured is not None:
            measured[name] = (dev, host)
        if dev is None:
            parts.append(f"{name} device not measured, host {host:.4f} ms")
            continue
        share = f" ({bnd / dev:.3f} of its bound)" if name == "kernel" else ""
        parts.append(f"{name} device {dev:.4f} ms{share}, host {host:.4f} ms")
    return "torch.profiler device-busy time and host issue time per call: " + "; ".join(parts)


def logmel_bound(n_samples: int, n_frames: int, cfg):
    """The least work of log-mel: per frame a real FFT of n_fft points
    (2.5 N log2 N), the power and the mel product over the filterbank's
    nonzero weights only (2 nnz), the log; the waveform read once and the
    log-mels written once. Returns (ms, what bounds it, flops, bytes)."""
    from sed_crnn_torch.ops.kernels.fused_logmel import mel_csr

    nnz = len(mel_csr(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)[2])
    n_bins = cfg.n_fft // 2 + 1
    flops = n_frames * (2.5 * cfg.n_fft * np.log2(cfg.n_fft) + 3 * n_bins + 2 * nnz + cfg.n_mels)
    nbytes = 4 * (n_samples + n_frames * cfg.n_mels)
    return bound_ms(nbytes, flops) + (flops, nbytes)


def _logmel_counts():
    """Launches per route, and of the dft body among them."""
    from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel

    return {"chunked": fused_log_mel.launches, "framed": fused_log_mel.framed_launches,
            "exact": fused_log_mel.exact_launches, "dft": fused_log_mel.dft_launches}


def _reset_logmel_counts():
    from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel

    fused_log_mel.launches = fused_log_mel.framed_launches = fused_log_mel.exact_launches = 0
    fused_log_mel.dft_launches = 0


def _check_logmel(tag: str, got, want) -> float:
    import torch

    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin), f"{tag}: -inf pattern")
    check(torch.equal(got[~fin], want[~fin]), f"{tag}: non-finite values")
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(err <= LOGMEL_ATOL, f"{tag}: {err} > {LOGMEL_ATOL}")
    return err


def phase_logmel_routes(pcm: np.ndarray, dft_err: float):
    """Kernel A's framed route (the TPU `_kernel_dif`) and exact route
    (`_kernel_exact`), each by the body its n_fft takes, against the DIF /
    direct plain version on the card (and the FFT body against its own plain
    version, two runs bitwise equal; the dft body's DIF formulation at n_fft
    3072); their times at the binmul path's shapes beside the retained dft
    body's (its output held against the same plain version first), the
    plain versions, `torch.stft` + mel and the bounds; the exact route
    driven once at n_fft 2048 and the dft body once through
    `frontend.extract` at n_fft 1034. ``dft_err`` is the dft body's error
    from `phase_logmel`."""
    import torch

    from sed_crnn_torch.core.config import FrontendConfig
    from sed_crnn_torch.ops import frontend
    from sed_crnn_torch.ops.kernels.fused_logmel import (
        _launch_dft,
        body,
        fft_log_mel_plain,
        fused_log_mel,
        fused_log_mel_frames,
        fused_log_mel_frames_plain,
        fused_log_mel_plain,
        route,
    )
    from sed_crnn_torch.ops.mel import mel_filterbank
    from sed_crnn_torch.ops.stft import frame_signal

    dev = torch.device("cuda")
    base = FrontendConfig()
    signals = [
        ("30s bucket", bucket_signal(tones(30.0, 1)[: 30 * SR - 4096], base), False),
        ("240s", tones(240.0, 2, silent=[(100.0, 101.5)]), True),
        ("ragged", tones(123457 / SR, 3), True),
        ("silence", np.zeros(5 * SR, np.float32), True),
        ("short", tones(1500 / SR, 4), True),
    ]
    confs = {"framed": [((1024, 1024), "dif"), ((4096, 1024), "dif"), ((3072, 1024), "dif")],
             "exact": [((2048, 1024), "exact"), ((1034, 517), "dif")]}
    worst = {"framed": 0.0, "exact": 0.0, "dft": dft_err}
    for kind, cases in confs.items():
        for (n_fft, hop), mode in cases:
            errs, fft_errs = [], []
            kb = body(n_fft)
            for name, y, center in signals:
                yt = torch.from_numpy(y).to(dev)
                for floor in (None, 1e-10):
                    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=center,
                                         log_floor=floor)
                    check(route(len(y), cfg, mode) == kind, f"{name} {n_fft}/{hop} route")
                    got = fused_log_mel(yt, cfg, mode)
                    want = fused_log_mel_plain(yt, cfg, mode)
                    tag = f"log-mel {kind} {n_fft}/{hop} {mode} {name} floor={floor}"
                    errs.append(_check_logmel(tag, got, want))
                    if kb == "fft":
                        fft_errs.append(_check_fft_body(tag, got, fused_log_mel(yt, cfg, mode),
                                                        fft_log_mel_plain(yt, cfg)))
                    if name == "silence" and floor is None:
                        check(not bool(torch.isfinite(want).any()), f"{tag}: not all -inf")
            # The frame-matrix entry (stride n_fft) on the 240 s signal's frames.
            y240 = torch.from_numpy(signals[1][1]).to(dev)
            cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, log_floor=1e-10)
            frames = frame_signal(y240, n_fft, hop).contiguous()
            got = fused_log_mel_frames(frames, cfg, mode)
            want = fused_log_mel_frames_plain(frames, cfg, mode)
            errs.append(_check_logmel(f"log-mel frames {n_fft}/{hop} {mode}", got, want))
            check(torch.equal(got, fused_log_mel_frames(frames, cfg, mode)),
                  f"log-mel frames {n_fft}/{hop} {mode}: two runs differ")
            slot = kind if kb == "fft" else "dft"
            worst[slot] = max(worst[slot], max(errs))
            fft_note = (f" (fft plain {max(fft_errs):.3g}), two runs bitwise equal"
                        if fft_errs else "")
            print(f"[kernel A {kind}] n_fft {n_fft} hop {hop} mode {mode}, {kb} body: "
                  f"{len(signals)} signals x 2 floors + a {tuple(frames.shape)} frame matrix, "
                  f"max|diff| at finite {max(errs):.3g}{fft_note}, -inf patterns equal")

    def library(yt, cfg):
        fb = torch.from_numpy(mel_filterbank(SR, cfg.n_fft, cfg.n_mels)).to(dev)
        window = torch.hann_window(cfg.n_fft, periodic=True, device=dev)
        return lambda: torch.log(torch.clamp_min(fb @ torch.stft(
            yt, cfg.n_fft, cfg.hop_length, window=window, center=False,
            return_complex=True).abs().square(), 1e-10))

    timed = {}
    for kind, n_fft, hop, mode in (("framed", 1024, 1024, "dif"), ("framed", 4096, 1024, "dif"),
                                   ("exact", 2048, 1024, "exact"), ("dft", 1034, 517, "dif")):
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
        y = bucket_signal(pcm, cfg)
        yt = torch.from_numpy(y).to(dev)
        n_frames = 1 + (len(y) - n_fft) // hop
        kb = body(n_fft)
        check(route(len(y), cfg, mode) == ("exact" if kind == "dft" else kind)
              and (kb == "dft") == (kind == "dft"), f"timed {kind} route and body")
        tag = f"log-mel {kind} {n_fft}/{hop} {mode} binmul-path shape"
        want = fused_log_mel_plain(yt, cfg, mode)
        got = fused_log_mel(yt, cfg, mode)
        err = _check_logmel(tag, got, want)
        worst[kind] = max(worst[kind], err)
        kernel = lambda: fused_log_mel(yt, cfg, mode)  # noqa: E731
        lib = library(yt, cfg)
        ms = cuda_ms(kernel)
        cold = cuda_ms_cold(kernel)
        plain = cuda_ms(lambda: fused_log_mel_plain(yt, cfg, mode), reps=5)
        lib_ms = cuda_ms(lib)
        bnd, by, flops, nbytes = logmel_bound(len(y), n_frames, cfg)
        direct = route(len(y), cfg, mode) == "exact"
        line = (f"[kernel A {kind}] binmul-path shape n_fft {n_fft} hop {hop} mode {mode}, "
                f"{kb} body: {n_frames} frames ({len(y) / SR:.1f} s padded), vs plain max|diff| "
                f"at finite {err:.3g}, -inf patterns equal: kernel {ms:.4f} ms warm L2, "
                f"{cold:.4f} ms cold L2; plain ({'direct' if direct else 'DIF'}) {plain:.4f} ms")
        splits = {"kernel": kernel, "library": lib}
        if kb == "fft":
            err_fft = _check_fft_body(tag, got, fused_log_mel(yt, cfg, mode),
                                      fft_log_mel_plain(yt, cfg))
            fft_plain = cuda_ms(lambda: fft_log_mel_plain(yt, cfg), reps=5)
            dft = lambda: _launch_dft(yt, hop, n_frames, n_fft, cfg, direct)  # noqa: E731
            err_dft = _check_logmel(f"{tag}, dft body", dft(), want)
            worst["dft"] = max(worst["dft"], err_dft)
            dft_ms = cuda_ms(dft)
            dft_cold = cuda_ms_cold(dft)
            splits["dft"] = dft
            line += (f"; vs the fft plain version {err_fft:.3g}, two runs bitwise equal; the "
                     f"dft body at this shape {dft_ms:.4f} ms warm, {dft_cold:.4f} ms cold (vs "
                     f"the same plain version {err_dft:.3g}); the fft body's plain emulation "
                     f"{fft_plain:.4f} ms")
        print(f"{line}; torch.stft+mel {lib_ms:.4f} ms; bound {bnd:.4f} ms ({by}, rFFT+power+"
              f"sparse mel {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), kernel at "
              f"{bnd / ms:.3f} of its bound")
        print(f"[kernel A {kind}] n_fft {n_fft} hop {hop}, {split_line(bnd, **splits)}")
        timed[(kind, n_fft)] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                                "library_ms": lib_ms}

    # The exact route on the FFT body: mode "exact" at n_fft 2048 on the
    # 120 s file, against the direct plain version.
    cfg = FrontendConfig(log_floor=1e-10)
    y120 = torch.from_numpy(pcm).to(dev)
    _reset_logmel_counts()
    got = fused_log_mel(y120, cfg, "exact")
    torch.cuda.synchronize()
    exact_launches = _logmel_counts()
    check(exact_launches == {"chunked": 0, "framed": 0, "exact": 1, "dft": 0},
          f"mode exact at n_fft 2048 launches {exact_launches}")
    err = _check_logmel("exact route n_fft 2048 on the 120 s file", got,
                        fused_log_mel_plain(y120, cfg, "exact"))
    print(f"[kernel A exact] fused_log_mel(mode='exact') of the {len(pcm) / SR:.0f} s file at "
          f"n_fft 2048: {tuple(got.shape)}, launches {exact_launches}, vs the direct plain "
          f"version max|diff| {err:.3g}")

    # The dft body's main path: `frontend.extract` of the 120 s file at
    # n_fft 1034 (neither a power of two nor a multiple of 4), against the
    # fft backend.
    cfg = FrontendConfig(n_fft=1034, hop_length=517, backend="kernel")
    _reset_logmel_counts()
    got = frontend.extract(pcm, cfg, device=dev)
    torch.cuda.synchronize()
    dft_launches = _logmel_counts()
    check(dft_launches == {"chunked": 0, "framed": 0, "exact": 1, "dft": 1},
          f"extract at n_fft 1034 launches {dft_launches}")
    want = frontend.extract(pcm, dataclasses.replace(cfg, backend="fft"), device=dev)
    err = _check_logmel("extract n_fft 1034 kernel vs fft", got, want)
    print(f"[kernel A dft] main path: frontend.extract of the {len(pcm) / SR:.0f} s file at "
          f"n_fft 1034 hop 517: {tuple(got.shape)}, launches {dft_launches}, "
          f"vs the fft backend max|diff| {err:.3g}")
    fft = {"route": "cuda", "source": "sed_crnn_torch/csrc/logmel_fft.cu"}
    return (
        {"name": "fused_logmel_framed", **fft,
         "replaces": "sed_crnn_tpu/ops/pallas/fused_logmel.py:162",
         "max_abs_err": worst["framed"], **timed[("framed", 4096)]},
        {"name": "fused_logmel_exact", **fft,
         "replaces": "sed_crnn_tpu/ops/pallas/fused_logmel.py:264",
         "max_abs_err": worst["exact"], "launches": exact_launches["exact"],
         **timed[("exact", 2048)]},
        {"name": "fused_logmel_dft", "route": "cuda",
         "source": "sed_crnn_torch/csrc/fused_logmel.cu",
         "replaces": "sed_crnn_tpu/ops/pallas/fused_logmel.py:264",
         "max_abs_err": worst["dft"], "launches": dft_launches["dft"],
         **timed[("dft", 1034)]},
    )


DCASE_CLASS_FREQS = (300.0, 700.0, 1300.0, 2500.0, 4100.0, 6300.0)


def write_dcase_layout(root: str, seed: int = 21):
    """A synthetic DCASE 2017 street layout: 12 binaural 16-bit wavs of 120 s
    at 44.1 kHz and one of 20 s at 48 kHz, noise plus a class tone (per
    channel gains) during each event; folds 1 and 2 (8 train and 4 evaluate
    files each, the 48 kHz file in fold 1's evaluate list); the 6 classes."""
    from sed_crnn_torch.data.catalog import DCASE_CLASSES
    from sed_crnn_torch.data.wavio import write_wav

    rng = np.random.default_rng(seed)
    audio = os.path.join(root, "audio", "street")
    setup = os.path.join(root, "evaluation_setup")
    os.makedirs(audio)
    os.makedirs(setup)
    lines = {}
    names = [f"street_{i:02d}.wav" for i in range(12)] + ["street_48k.wav"]
    for name in names:
        sr, seconds = (48000, 20.0) if name.endswith("48k.wav") else (SR, 120.0)
        n = int(seconds * sr)
        x = (0.02 * rng.standard_normal((n, 2))).astype(np.float32)
        events = []
        for _ in range(max(1, int(seconds // 15))):
            start = float(rng.uniform(0.0, seconds - 6.0))
            end = start + float(rng.uniform(1.0, 5.0))
            c = int(rng.integers(len(DCASE_CLASSES)))
            a, b = int(start * sr), int(end * sr)
            tone = 0.2 * np.sin(2 * np.pi * DCASE_CLASS_FREQS[c] / sr * np.arange(b - a))
            x[a:b] += (tone[:, None] * rng.uniform(0.3, 1.0, 2)).astype(np.float32)
            events.append(f"audio/street/{name}\tstreet\t{start:.3f}\t{end:.3f}\t"
                          f"{DCASE_CLASSES[c]}")
        write_wav(os.path.join(audio, name), x, sr)
        lines[name] = events or [f"audio/street/{name}\tstreet"]
    splits = {1: (names[:8], names[8:]), 2: (names[4:12], names[:4])}
    for fold, (train, evaluate) in splits.items():
        for split, files in (("train", train), ("evaluate", evaluate)):
            with open(os.path.join(setup, f"street_fold{fold}_{split}.txt"), "w") as f:
                f.write("\n".join(ln for n in files for ln in lines[n]) + "\n")
    return names


def _quiet(fn, *args):
    """Run ``fn(*args)`` with its standard output captured; returns its
    result and the captured lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def phase_feature(workdir: str):
    """`apps/feature.py --binmul --backend kernel` on a synthetic DCASE layout
    on the card (exact launch counts, a cached rerun, the fft backend's
    features, the packs), the feature rate and a profile, then
    `apps/train.py --preset sednet-dcase-binmul` on those packs at full
    width."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sed_crnn_torch.apps import feature
    from sed_crnn_torch.core.config import FrontendConfig
    from sed_crnn_torch.data import store
    from sed_crnn_torch.data.wavio import read_wav_multichannel

    root = os.path.join(workdir, "dcase")
    t0 = time.perf_counter()
    names = write_dcase_layout(root)
    print(f"[feature] wrote {len(names)} binaural wavs in {time.perf_counter() - t0:.1f} s")
    audio_s = 12 * 120.0 + 20.0
    cache = os.path.join(workdir, "cache")
    args = ["--dcase-root", root, "--binmul", "--folds", "1", "2", "--device", "cuda"]

    _reset_logmel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = _quiet(feature.main, args + ["--cache-dir", cache, "--backend", "kernel"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _logmel_counts()
    want = {"chunked": 2 * len(names), "framed": 4 * len(names), "exact": 0, "dft": 0}
    check(launches == want, f"feature launches {launches} != {want}")
    print(f"[feature] extract_dcase --binmul --backend kernel: {len(names)} files "
          f"({audio_s:.0f} s of binaural audio, 2 folds) in {wall:.2f} s host clock -> "
          f"{audio_s / wall:,.0f} audio-sec/sec; launches {launches} (per file 2 chunked "
          f"at n_fft 2048, 4 framed at n_fft 1024 and 4096, all on the fft body); {out[-1]}")

    per_file = sorted(f for f in os.listdir(cache) if f.endswith("_binmul.npz")
                      and not f.startswith("mbe_"))
    check(len(per_file) == len(names), f"{len(per_file)} per-file caches")
    log = os.path.join(cache, "feature_log.jsonl")
    records = [json.loads(ln) for ln in open(log)]
    n_log = len(records)
    secs = {os.path.basename(r["video"]): r["duration_sec"] for r in records}
    at_44k = [secs[n] for n in names[:-1]]
    print(f"[feature] per-file seconds (feature_log.jsonl, decode to npz write): 44.1 kHz "
          f"files first {at_44k[0]}, then min {min(at_44k[1:])} median "
          f"{float(np.median(at_44k[1:]))} max {max(at_44k[1:])}; the 20 s 48 kHz file "
          f"(resampled on the host) {secs[names[-1]]}")
    mtimes = {f: os.path.getmtime(os.path.join(cache, f)) for f in per_file}
    _reset_logmel_counts()
    _quiet(feature.main, args + ["--cache-dir", cache, "--backend", "kernel"])
    check(not any(_logmel_counts().values()),
          f"a cached rerun launched {_logmel_counts()}")
    check({f: os.path.getmtime(os.path.join(cache, f)) for f in per_file} == mtimes
          and len(open(log).read().splitlines()) == n_log == len(names),
          "a cached rerun rewrote a file or a log line")

    fft_cache = os.path.join(workdir, "cache_fft")
    _quiet(feature.main, args + ["--cache-dir", fft_cache, "--backend", "fft"])
    worst = 0.0
    for f in per_file:
        x, y = store.load_video_features(os.path.join(cache, f))
        fx, fy = store.load_video_features(os.path.join(fft_cache, f))
        check(x.shape == fx.shape and x.shape[1] == 240 and np.array_equal(y, fy),
              f"{f}: shapes {x.shape} / {fx.shape} or labels")
        fin = np.isfinite(fx)
        check(np.array_equal(np.isfinite(x), fin), f"{f}: -inf pattern vs fft")
        err = float(np.abs(x[fin] - fx[fin]).max())
        check(err <= LOGMEL_ATOL, f"{f}: kernel vs fft backend {err}")
        worst = max(worst, err)
    for k in (1, 2):
        fold = store.load_fold(cache, k, "binmul")
        means = np.abs(fold["train_x"].mean(axis=0)).max()
        check(fold["train_x"].shape[1] == fold["val_x"].shape[1] == 240
              and fold["train_y"].shape[1] == 6 and means < 1e-3
              and fold["norm_mean"].shape == fold["norm_scale"].shape == (240,)
              and bool(np.isfinite(fold["val_x"]).all()),
              f"fold {k} pack")
        print(f"[feature] fold {k} pack: train {fold['train_x'].shape}, val "
              f"{fold['val_x'].shape}, labels {fold['train_y'].shape[1]} classes "
              f"({int(fold['train_y'].sum())} positive cells), train means within {means:.2g}")
    print(f"[feature] per-file features, kernel vs fft backend on the card: max|diff| "
          f"{worst:.3g} over {len(per_file)} files, -inf patterns and labels equal")

    # Where the time goes: the device's share (torch.profiler over a fresh
    # run of fold 2's 12 files) and the host's parts for one file.
    prof_cache = os.path.join(workdir, "cache_prof")
    fold2 = ["--dcase-root", root, "--binmul", "--folds", "2", "--device", "cuda",
             "--backend", "kernel", "--cache-dir", prof_cache]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _quiet(feature.main, fold2)
        torch.cuda.synchronize()
    prof_wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    kern_us = sum(e.self_device_time_total for e in rows if "logmel" in e.key)
    if busy_us == 0:
        print("[profile] feature: the profiler recorded no device time (not measured)")
    else:
        print(f"[profile] feature, 12 files (fold 2) profiled: wall {prof_wall_us / 1e6:.2f} s, "
              f"device busy {busy_us / 1e3:.1f} ms ({busy_us / prof_wall_us:.3f} of wall), "
              f"log-mel kernels {kern_us / 1e3:.1f} ms ({kern_us / prof_wall_us:.3f} of wall)")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"[profile]   {e.self_device_time_total / busy_us:6.1%} "
                  f"{e.self_device_time_total / 1e3:8.2f} ms x{e.count:5d}  {e.key[:80]}")
    path = os.path.join(root, "audio", "street", names[0])
    t0 = time.perf_counter()
    pcm, _ = read_wav_multichannel(path)
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    for nf in (1024, 2048, 4096):
        for c in range(2):
            bucket_signal(np.ascontiguousarray(pcm[:, c]), FrontendConfig(n_fft=nf))
    t_pad = time.perf_counter() - t0
    x, y = store.load_video_features(os.path.join(cache, per_file[0]))
    t0 = time.perf_counter()
    store.save_video_features(os.path.join(workdir, "probe.npz"), x, y)
    t_save = time.perf_counter() - t0
    print(f"[feature] host parts of one 120 s file: wav read {t_read * 1e3:.1f} ms, "
          f"reflect + bucket padding x6 {t_pad * 1e3:.1f} ms, npz write {t_save * 1e3:.1f} ms; "
          f"all of one file {wall / len(names) * 1e3:.0f} ms on average")
    return launches, cache, audio_s / wall


def phase_feature_train(workdir: str, cache: str):
    """`apps/train.py --preset sednet-dcase-binmul` on the packs the feature
    phase wrote, at full width on the card, 2 epochs."""
    import torch

    from sed_crnn_torch.apps import train as train_app
    from sed_crnn_torch.apps.infer import load_model
    from sed_crnn_torch.core.checkpoint import load_checkpoint
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.data import store
    from sed_crnn_torch.train.loop import make_samplers

    epochs = 2
    cfg = get_preset("sednet-dcase-binmul")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_epochs=epochs, plot_every=0))
    m = cfg.model
    check(m.in_channels == 6 and tuple(m.conv_channels) == (128, 128, 128)
          and tuple(m.gru_hidden) == (32, 32) and cfg.train.batch_size == TRAIN_BATCH,
          "sednet-dcase-binmul preset widths")
    fold = store.load_fold(cache, 1, "binmul")
    tr, val = make_samplers(cfg, fold, torch.device("cuda"))
    n_train, n_sweep = tr.steps_per_epoch(cfg.train.batch_size), val.sweep_steps(cfg.train.batch_size)
    art = os.path.join(workdir, "art")
    _reset_gru_counts()
    _reset_logmel_counts()
    t0 = time.perf_counter()
    with _no_plain_gru_on_card() as plain_on_card:
        out, lines = _quiet(train_app.main, [
            "--preset", "sednet-dcase-binmul", "--cache-dir", cache, "--channel-tag", "binmul",
            "--folds", "1", "--max-epochs", str(epochs), "--plot-every", "0", "--device", "cuda",
            "--art-dir", art])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _gru_counts()
    want = _gru_path_counts(2 * n_sweep * epochs, 2 * n_train * epochs)
    check(launches == want, f"binmul training launches {launches} != {want}")
    check(not plain_on_card, f"a GRU plain version ran on the card: {plain_on_card}")
    check(not any(_logmel_counts().values()),
          f"binmul training log-mel launches {_logmel_counts()}")
    res = out["folds"][0]
    check(res.epochs_run == epochs, f"ran {res.epochs_run} epochs")
    for k in ("loss_tr", "loss_val"):
        v = res.history[k]
        check(len(v) == epochs and bool(np.isfinite(v).all()), f"history {k}: {v}")
    check(res.best_checkpoint is not None and os.path.exists(res.best_checkpoint),
          "best checkpoint written")
    tree, meta = load_checkpoint(res.best_checkpoint)
    model = load_model(tree, m, "cuda").eval()
    n = min(4, len(fold["val_x"]) // m.seq_len_in)
    x = torch.from_numpy(fold["val_x"][: n * m.seq_len_in].reshape(n, m.seq_len_in, -1))
    with torch.no_grad():
        logits = model(x.cuda())[0].cpu()
        logits_cpu = load_model(tree, m, "cpu").eval()(x)[0]
    err = float((logits - logits_cpu).abs().max())
    check(bool(torch.isfinite(logits).all()) and err <= LOGIT_ATOL,
          f"best checkpoint logits card vs CPU {err}")
    print(f"[feature train] apps.train --preset sednet-dcase-binmul (in_channels 6, conv "
          f"{m.conv_channels}, biGRU {m.gru_hidden}, batch {cfg.train.batch_size}) on the "
          f"packs: fold 1 {fold['train_x'].shape[0]} train frames, {epochs} epochs x {n_train} "
          f"steps, {n_sweep} sweep step(s), in {wall:.2f} s; loss_tr {res.history['loss_tr']}, "
          f"loss_val {res.history['loss_val']}; best checkpoint (epoch {meta.get('epoch')}) "
          f"loads back, logits {tuple(logits.shape)} card vs CPU {err:.3g}; launches {launches}")
    return res.best_checkpoint


EVAL_FRAMES = 77_520     # 1,800 s at 43.07 frames/s: about one DCASE 2017 street evaluate list
EVAL_BATCH = 256         # evaluate_split's default batch
SCORE_ATOL = 1e-6        # card vs CPU scoring ratios on one probability roll
MATCH_PAIRS_MAX = 5e7    # (ref x sys) event pairs past which host matching takes minutes


def _reports_agree(got, want, path="report"):
    """Two evaluation reports of one probability roll: the same keys, ints
    and strings equal, floats within SCORE_ATOL with NaN / inf and None in
    the same places."""
    if isinstance(want, dict):
        check(list(got) == list(want), f"{path}: keys {list(got)} vs {list(want)}")
        for k in want:
            _reports_agree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        check(len(got) == len(want), f"{path}: lengths")
        for i, (g, w) in enumerate(zip(got, want)):
            _reports_agree(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        same = (str(got) == str(want)) if not np.isfinite(want) else (
            isinstance(got, float) and abs(got - want) <= SCORE_ATOL)
        check(same, f"{path}: {got} vs {want}")
    else:
        check(type(got) is type(want) and got == want, f"{path}: {got!r} vs {want!r}")


def phase_evaluate(train_dir: str, cache: str, binmul_best: str):
    """`evaluate_split` and `apps.evaluate` on the card: phase 9's
    sednet-dcase checkpoints on a 1,800 s synthetic split, alone and as a
    2-member ensemble, with exact launch counts; card vs CPU forward and
    scoring; the binmul chain feature -> train -> evaluate -> score_events;
    the evaluation rate and its parts; kernel B's pair forward at B=256."""
    import torch

    from sed_crnn_torch.apps import evaluate as eval_app
    from sed_crnn_torch.apps.infer import load_model
    from sed_crnn_torch.apps.score_events import score_event_lists
    from sed_crnn_torch.apps.train import synthetic_folds
    from sed_crnn_torch.core.checkpoint import load_checkpoint
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.ops import metrics as metrics_ops
    from sed_crnn_torch.ops.event_metrics import (
        class_wise_event_scores,
        event_scores,
        events_from_roll,
    )
    from sed_crnn_torch.ops.kernels.gru_scan import gru_scan_pair, gru_scan_plain
    from sed_crnn_torch.train.evaluate import (
        DEFAULT_THRESHOLDS,
        evaluate_split,
        forward_probabilities,
        score_rolls,
        window_split,
    )

    dev = torch.device("cuda")
    cfg = get_preset("sednet-dcase")
    m, tc = cfg.model, cfg.train
    val = synthetic_folds(1, frames=2 * EVAL_FRAMES, seed=14, n_classes=m.n_classes)[1]
    x, y = val["val_x"], val["val_y"]
    check(x.shape == (EVAL_FRAMES, m.n_mels), f"evaluation split {x.shape}")
    xw, yw = window_split(x, y, m.seq_len_in, m.seq_len_out)
    n_win = xw.shape[0]
    n_batches = -(-n_win // EVAL_BATCH)
    audio_s = EVAL_FRAMES / FRAMES_PER_SEC
    ckpts = {k: load_checkpoint(os.path.join(train_dir, "fold1", f"{k}_fold1.npz"))
             for k in ("best", "last")}
    trees = {k: tree for k, (tree, _) in ckpts.items()}
    best, last = (load_model(trees[k], m, dev) for k in ("best", "last"))

    # The forward once before any clock (cuDNN's algorithm choice, the
    # kernel's first launch), and the event counts before any matching.
    probs = forward_probabilities([best.eval()], xw, EVAL_BATCH)
    flat_p = probs.reshape(-1, m.n_classes)
    flat_y = torch.from_numpy(np.ascontiguousarray(yw.reshape(-1, m.n_classes))).to(dev)
    n_ref = len(events_from_roll(flat_y.cpu().numpy(), 1, 0.5))
    n_sys = len(events_from_roll(flat_p.cpu().numpy(), 1, tc.threshold))
    print(f"[evaluate] {n_ref} reference and {n_sys} system events at threshold {tc.threshold}")
    check(n_ref * n_sys <= MATCH_PAIRS_MAX,
          f"{n_ref} x {n_sys} events: host matching would take minutes")
    reports, walls = {}, {}
    for name, members in (("best", best), ("best+last", [best, last])):
        n_members = 1 if name == "best" else 2
        _reset_gru_counts()
        _reset_logmel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _no_plain_gru_on_card() as plain_on_card:
            reports[name] = evaluate_split(members, x, y, cfg, device="cuda")
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts = _gru_counts()
        want = _gru_path_counts(2 * n_batches * n_members, 0)
        check(counts == want, f"evaluate {name} launches {counts} != {want}")
        check(not plain_on_card, f"a GRU plain version ran on the card: {plain_on_card}")
        check(not any(_logmel_counts().values()), f"evaluate log-mel launches {_logmel_counts()}")
        r = reports[name]
        check(r["n_windows"] == n_win and len(r["sweep"]["er_1s"]) == len(DEFAULT_THRESHOLDS)
              and len(r["per_class_sweep"]["thresholds"]) == m.n_classes
              and np.isfinite(r["best_er_1s"]) and sum(r["confusion"].values()) == n_win
              * m.seq_len_out * m.n_classes, f"evaluate {name} report")
    eval_launches = sum(2 * n_batches * k for k in (1, 2))

    # Card vs CPU: the forward on the first 16 windows, then the scoring code
    # on the card's own roll (median 5 and dumped events on both).
    head = probs[:16].cpu()
    cpu_probs = forward_probabilities([load_model(trees["best"], m, "cpu").eval()], xw[:16],
                                      EVAL_BATCH)
    prob_err = float((head - cpu_probs).abs().max())
    check(bool(torch.isfinite(probs).all()) and prob_err <= PROB_ATOL,
          f"evaluation probabilities card vs CPU {prob_err}")
    dumps = {d: os.path.join(train_dir, f"events_{d}") for d in ("cuda", "cpu")}
    t0 = time.perf_counter()
    on_card = score_rolls(flat_p, flat_y, cfg, n_win, median_filter=5,
                          dump_events_dir=dumps["cuda"])
    score_s = time.perf_counter() - t0
    on_cpu = score_rolls(flat_p.cpu(), flat_y.cpu(), cfg, n_win, median_filter=5,
                         dump_events_dir=dumps["cpu"])
    _reports_agree(on_card, on_cpu)
    check(on_card["confusion"] == on_cpu["confusion"]
          and on_card["best_threshold"] == on_cpu["best_threshold"]
          and on_card["per_class_sweep"]["thresholds"] == on_cpu["per_class_sweep"]["thresholds"],
          "card vs CPU counts or thresholds")
    for f in ("ref_events.txt", "est_events.txt"):
        with open(os.path.join(dumps["cuda"], f), "rb") as a, \
                open(os.path.join(dumps["cpu"], f), "rb") as b:
            check(a.read() == b.read(), f"card vs CPU event list {f}")

    # Where the time goes: the forward (CUDA events), the sweeps on the card
    # and the host's event decoding and matching, each alone.
    fwd_ms = cuda_ms(lambda: forward_probabilities([best], xw, EVAL_BATCH), reps=3, warmup=1)

    def sweeps():
        binary = (flat_p > torch.tensor(tc.threshold, device=dev)).float()
        out = (metrics_ops.all_scores(binary, flat_y, tc.frames_in_1_sec),
               metrics_ops.best_threshold(flat_p, flat_y, DEFAULT_THRESHOLDS, tc.frames_in_1_sec),
               metrics_ops.class_wise_report(binary, flat_y, tc.frames_in_1_sec),
               metrics_ops.best_per_class_thresholds(flat_p, flat_y, DEFAULT_THRESHOLDS,
                                                     tc.frames_in_1_sec))
        torch.cuda.synchronize()
        return out

    sweeps()
    t0 = time.perf_counter()
    sweeps()
    sweep_s = time.perf_counter() - t0
    hop_s = cfg.frontend.hop_length / cfg.frontend.sample_rate
    t0 = time.perf_counter()
    sys_ev = events_from_roll(flat_p.cpu().numpy(), hop_s, tc.threshold)
    ref_ev = events_from_roll(flat_y.cpu().numpy(), hop_s, 0.5)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    event_scores(ref_ev, sys_ev)
    class_wise_event_scores(ref_ev, sys_ev, n_classes=m.n_classes)
    match_s = time.perf_counter() - t0
    wall = walls["best"]
    rest = wall - fwd_ms / 1e3 - sweep_s - decode_s - match_s
    print(f"[evaluate] evaluate_split sednet-dcase (phase 9's best checkpoint, epoch "
          f"{ckpts['best'][1].get('epoch')}) on a {EVAL_FRAMES}-frame split ({audio_s:.1f} s, "
          f"{n_win} windows, {n_batches} batches of {EVAL_BATCH}): {wall:.3f} s host clock -> "
          f"{audio_s / wall:,.1f} audio-sec/sec; 2-member ensemble {walls['best+last']:.3f} s -> "
          f"{audio_s / walls['best+last']:,.1f} audio-sec/sec")
    print(f"[evaluate] parts of the single-model run, each alone: forward {fwd_ms:.2f} ms (CUDA "
          f"events), sweeps and base scores on the card {sweep_s * 1e3:.2f} ms (host clock to a "
          f"sync), event decode {decode_s * 1e3:.2f} ms and matching {match_s * 1e3:.2f} ms "
          f"(host), the rest {rest * 1e3:.2f} ms; {len(ref_ev)} reference and {len(sys_ev)} "
          f"system events")
    r = reports["best"]
    print(f"[evaluate] best: ER_1s {r['er_1s']:.4f} F1_1s {r['f1_1s']:.4f}, best threshold "
          f"{r['best_threshold']:.2f} (ER {r['best_er_1s']:.4f}), per-class ER "
          f"{r['per_class_sweep']['er_1s']:.4f}, event ER {r['er_event']:.4f} F1 "
          f"{r['f1_event']:.4f}; ensemble ER_1s {reports['best+last']['er_1s']:.4f}; launches "
          f"{_gru_path_counts(2 * n_batches, 0)['gru_scan_fwd']} and "
          f"{_gru_path_counts(4 * n_batches, 0)['gru_scan_fwd']} pair forwards, nothing else")
    n_dumped = {f: len(open(os.path.join(dumps["cuda"], f)).read().splitlines())
                for f in ("ref_events.txt", "est_events.txt")}
    print(f"[evaluate] card vs CPU: forward on 16 windows max|diff| {prob_err:.3g}; scoring of "
          f"the card's roll (median 5) on the card {score_s:.3f} s and on the CPU agree (counts, "
          f"thresholds, None/NaN places equal, ratios within {SCORE_ATOL}), event lists "
          f"byte-identical ({n_dumped['ref_events.txt']} reference, "
          f"{n_dumped['est_events.txt']} system events after the median)")

    # The device's share of one single-model run (torch.profiler), and the
    # host matching at a heavier load: the roll decoded at the per-class
    # sweep's thresholds.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate_split(best, x, y, cfg, device="cuda")
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    busy = ("not measured" if busy_ms == 0 else
            f"{busy_ms:.2f} ms busy of {prof_wall * 1e3:.2f} ms profiled, idle share "
            f"{max(0.0, 1 - busy_ms / (prof_wall * 1e3)):.3f}")
    th_vec = np.asarray(r["per_class_sweep"]["thresholds"], np.float32)
    sys_pc = events_from_roll(flat_p.cpu().numpy(), hop_s, th_vec)
    t0 = time.perf_counter()
    event_scores(ref_ev, sys_pc)
    class_wise_event_scores(ref_ev, sys_pc, n_classes=m.n_classes)
    match_pc = time.perf_counter() - t0
    print(f"[evaluate] device during one single-model run (torch.profiler): {busy}; host "
          f"matching of {len(ref_ev)} reference and {len(sys_pc)} system events decoded at the "
          f"per-class thresholds {th_vec.tolist()}: {match_pc * 1e3:.2f} ms")

    # The binmul chain: phase 12's fold-1 pack and phase 13's best checkpoint.
    dump = os.path.join(train_dir, "events_binmul")
    out = os.path.join(train_dir, "binmul_report.json")
    n_val = len(np.load(os.path.join(cache, "mbe_binmul_fold1.npz"))["arr_2"])
    binmul_batches = -(-(n_val // m.seq_len_in) // EVAL_BATCH)
    _reset_gru_counts()
    with _no_plain_gru_on_card() as plain_on_card:
        report, _ = _quiet(eval_app.main, [
            "--checkpoint", binmul_best, "--preset", "sednet-dcase-binmul", "--cache-dir", cache,
            "--channel-tag", "binmul", "--fold", "1", "--dump-events", dump, "--out", out,
            "--device", "cuda"])
        torch.cuda.synchronize()
    counts = _gru_counts()
    check(counts == _gru_path_counts(2 * binmul_batches, 0) and not plain_on_card,
          f"binmul evaluate launches {counts}")
    eval_launches += counts["gru_scan_fwd"]
    overall, _ = score_event_lists(os.path.join(dump, "ref_events.txt"),
                                   os.path.join(dump, "est_events.txt"))
    for k in ("er_event", "f1_event"):
        check(abs(overall[k] - report[k]) <= 1e-9 or (np.isnan(overall[k]) and np.isnan(report[k])),
              f"score_events {k} {overall[k]} vs the report's {report[k]}")
    print(f"[evaluate] binmul chain: apps.evaluate on phase 13's best checkpoint and phase 12's "
          f"fold-1 pack ({n_val} frames, {n_val // m.seq_len_in} windows): ER_1s "
          f"{report['er_1s']:.4f}, event ER {report['er_event']:.4f} F1 {report['f1_event']:.4f} "
          f"reproduced by score_events (n_ref {overall['n_ref']}, n_sys {overall['n_sys']}); "
          f"launches {counts['gru_scan_fwd']}")

    # Kernel B's pair forward at the evaluation batch.
    B, H, T = EVAL_BATCH, 32, GRU_T
    rng = np.random.default_rng(15)
    sets = [_gru_inputs(rng, dev, B, H) for _ in range(2)]
    conf = (False, "sigmoid")
    pair = lambda: gru_scan_pair(_pair_of(sets, 0), _pair_of(sets, 1),  # noqa: E731
                                 (None, None), _pair_of(sets, 3), *conf)
    got = pair()
    err = 0.0
    for k, rev in enumerate((False, True)):
        xp, wh, _, h0 = sets[k]
        want = gru_scan_plain(xp, wh, None, h0, *conf, rev)
        err = max(err, max(_maxdiff(g, w) for g, w in zip(got[k], want)))
    check(err <= GRU_ATOL, f"pair forward at B={B}: {err}")
    ms = cuda_ms(pair, reps=20)
    dev_ms, host_ms = device_host_ms(pair)
    nbytes = 2 * 4 * (B * T * 3 * H + H * 3 * H + 2 * B * H + B * T * H)
    flops = 2 * T * B * (2 * H * 3 * H + 12 * H)
    bnd, by = bound_ms(nbytes, flops)
    xp, wh, bh, h0 = sets[0]
    lib = torch.nn.GRU(3 * H, H, batch_first=True, bidirectional=True).to(dev)
    with torch.no_grad():
        for sfx in ("", "_reverse"):
            getattr(lib, f"weight_ih_l0{sfx}").copy_(torch.eye(3 * H, device=dev))
            getattr(lib, f"bias_ih_l0{sfx}").zero_()
            getattr(lib, f"weight_hh_l0{sfx}").copy_(wh.T)
            getattr(lib, f"bias_hh_l0{sfx}").copy_(bh)
        h0s = torch.stack([h0, h0])
        lib_ms = cuda_ms(lambda: lib(xp, h0s), reps=20)
        lib_out, _ = lib(xp, h0s)
    want = gru_scan_plain(xp, wh, bh, h0, True, "sigmoid", False)
    lib_err = _maxdiff(lib_out[..., :H], want[0])
    check(lib_err <= LIBRARY_ATOL, f"bidirectional torch.nn.GRU at B={B} vs plain: {lib_err}")
    ra_sets = [(s[0], s[1], s[2], s[3]) for s in sets]
    ra_ms = cuda_ms(lambda: gru_scan_pair(_pair_of(ra_sets, 0), _pair_of(ra_sets, 1),
                                          _pair_of(ra_sets, 2), _pair_of(ra_sets, 3), True,
                                          "sigmoid"), reps=20)
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"[evaluate] kernel B pair forward at B={B} T={T} H={H} reset_after=False ({2 * B} "
          f"warps): {ms:.4f} ms by events ({ms / T * 1e3:.3f} us/step), device {dev_txt} "
          f"(torch.profiler), host issue {host_ms:.4f} ms, vs plain {err:.3g}; bound {bnd:.5f} ms "
          f"({by}, {nbytes / 1e6:.1f} MB); reset_after=True pair {ra_ms:.4f} ms vs "
          f"bidirectional torch.nn.GRU (weight_ih = I; vs plain {lib_err:.3g}) {lib_ms:.4f} ms")
    return eval_launches, {"eval_b256_ms": ms, "eval_b256_device_ms": dev_ms,
                           "eval_b256_host_ms": host_ms, "eval_b256_bound_ms": bnd,
                           "eval_b256_bound_by": by, "eval_b256_library_ms": lib_ms,
                           "eval_b256_variant_ms": ra_ms, "eval_rate_audio_s_per_s": audio_s / wall}


def phase_multiseed(workdir: str):
    """`apps.train --runs 2 --runs-mode sequential` at full width on the card
    (1 epoch, 1 fold), then `apps.evaluate` on the two seeds' best
    checkpoints: 2 members and their ensemble."""
    import glob

    import torch

    from sed_crnn_torch.apps import evaluate as eval_app
    from sed_crnn_torch.apps import train as train_app
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.train.loop import make_samplers
    from sed_crnn_torch.train.multiseed import run_seeds

    cfg = get_preset("sednet-dcase")
    batch, seq = cfg.train.batch_size, cfg.model.seq_len_in
    frames = max(8000, int(batch * seq * 1.3))          # as apps.train --synthetic makes them
    fold = train_app.synthetic_folds(1, frames=frames, n_classes=cfg.model.n_classes,
                                     n_mels=cfg.model.n_mels)[1]
    tr, val = make_samplers(cfg, fold, torch.device("cuda"))
    n_train, n_sweep = tr.steps_per_epoch(batch), val.sweep_steps(batch)
    art = os.path.join(workdir, "art")
    seeds = run_seeds(cfg.train.seed, 2)
    _reset_gru_counts()
    t0 = time.perf_counter()
    with _no_plain_gru_on_card() as plain_on_card:
        out, _ = _quiet(train_app.main, [
            "--preset", "sednet-dcase", "--synthetic", "--folds", "1", "--runs", "2",
            "--runs-mode", "sequential", "--max-epochs", "1", "--plot-every", "0",
            "--device", "cuda", "--art-dir", art])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _gru_counts()
    want = _gru_path_counts(2 * n_sweep * len(seeds), 2 * n_train * len(seeds))
    check(counts == want and not plain_on_card, f"multiseed launches {counts} != {want}")
    (run,) = os.listdir(art)
    bests = sorted(glob.glob(os.path.join(art, run, "fold1", "seed*", "best_fold1.npz")))
    check(out["seeds"] == seeds and bests == sorted(
        os.path.join(art, run, "fold1", f"seed{s}", "best_fold1.npz") for s in seeds),
        f"multiseed seeds {out['seeds']} / checkpoints {bests}")
    with open(os.path.join(art, run, "experiment_multiseed.jsonl")) as f:
        (record,) = [json.loads(ln) for ln in f]
    check(record["seeds"] == seeds and record["mean_er"] == out["mean_er"]
          and record["std_er"] == out["std_er"] and np.isfinite(record["mean_er"]),
          f"experiment_multiseed.jsonl {record}")
    print(f"[multiseed] apps.train --runs 2 --runs-mode sequential sednet-dcase full width, 1 "
          f"epoch x {n_train} steps at batch {batch} + {n_sweep} sweep step per seed, seeds "
          f"{seeds}, in {wall:.2f} s: ER {out['mean_er']:.4f} ± {out['std_er']:.4f}, F1 "
          f"{out['mean_f1']:.4f} ± {out['std_f1']:.4f}; launches {counts}")

    cache = os.path.join(workdir, "cache")
    os.makedirs(cache)
    np.savez(os.path.join(cache, "mbe_mon_fold1.npz"), fold["train_x"], fold["train_y"],
             fold["val_x"], fold["val_y"])
    n_batches = -(-(len(fold["val_x"]) // seq) // EVAL_BATCH)
    _reset_gru_counts()
    with _no_plain_gru_on_card() as plain_on_card:
        report, _ = _quiet(eval_app.main, ["--checkpoint", *bests, "--preset", "sednet-dcase",
                                           "--cache-dir", cache, "--device", "cuda"])
        torch.cuda.synchronize()
    counts = _gru_counts()
    want = _gru_path_counts(2 * n_batches * (2 + 2), 0)
    check(counts == want and not plain_on_card, f"multiseed evaluate launches {counts} != {want}")
    check(report["n_members"] == 2 and len(report["members"]) == 2
          and np.isfinite(report["ensemble"]["er_1s"]), "multiseed evaluate report")
    print(f"[multiseed] apps.evaluate on the 2 seeds' best checkpoints: member ER_1s "
          f"{[round(mm['er_1s'], 4) for mm in report['members']]} (mean "
          f"{report['mean_er_1s']:.4f} ± {report['std_er_1s']:.4f}), ensemble ER_1s "
          f"{report['ensemble']['er_1s']:.4f}; launches {counts['gru_scan_fwd']} pair forwards")


# [multiseed stacked]: kernel B with a seed axis at the stacked main path's
# shapes (timepooled-v2: S seeds x BiGRU(16) and BiGRU(8), B=128, T=8; and
# S=2 at sednet's H=32, T=256), both multi-seed modes on timepooled-v2, the
# conv-128 split behind `choose_runs_mode`, and the bf16 trunk on the card.
STACK_SHAPES = [(S, 128, 8, H) for S in (1, 3, 5) for H in (8, 16)] + [(2, 128, 256, 32)]
STACK_RUNS = 5                 # the reference protocol's "mean of 5 runs"
STACK_EPOCHS = 2
# Stacked vs sequential on the card: the same function up to float32
# rounding (a grouped convolution, batched products), which the bf16 trunk
# and the focal loss carry forward through training: loss histories within
# 10 % of each other, ER/F1 within 0.15, the same best epochs.
STACK_LOSS_RTOL = 0.10
STACK_METRIC_ATOL = 0.15
# The split: conv-128 trunks at batch 128, stacked against sequential.
SPLIT_CELLS = [("timepooled-v1", 2), ("timepooled-v1", 4), ("sednet-dcase", 2)]


def _stack_operands(rng, dev, S: int, B: int, T: int, H: int):
    """Both directions' (xp, wh, bh, h0, dys, dhl), each with a leading seed
    axis, on the card."""
    import torch

    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    return [(t(rng.standard_normal((S, B, T, 3 * H))), t(0.3 * rng.standard_normal((S, H, 3 * H))),
             t(0.1 * rng.standard_normal((S, 3 * H))), t(0.5 * rng.standard_normal((S, B, H))),
             t(rng.standard_normal((S, B, T, H))), t(rng.standard_normal((S, B, H))))
            for _ in range(2)]


def _gru_bounds(S: int, B: int, T: int, H: int, reset_after: bool):
    """The least work of S seeds x 2 directions of the forward, the residual
    forward and the backward (chain + dwh), as `phase_gru_train` counts it
    per direction: (fwd, fwd_res, bwd) each (ms, what bounds it)."""
    f, n, RW = 4, 2 * S, (4 if reset_after else 3) * H
    fwd_b = f * (B * T * 3 * H + H * 3 * H + 3 * H + 2 * B * H + B * T * H)
    fwd_f = T * B * (2 * H * 3 * H + 12 * H)
    bwd_b = f * (B * T * H + B * T * RW + H * 3 * H + 2 * B * H + B * T * H
                 + B * T * 3 * H + H * 3 * H + 3 * H + B * H)
    bwd_f = T * B * (2 * 2 * H * 3 * H + 20 * H)
    return (bound_ms(n * fwd_b, n * fwd_f), bound_ms(n * (fwd_b + f * B * T * RW), n * fwd_f),
            bound_ms(n * bwd_b, n * bwd_f))


def _stack_kernel_checks():
    """Kernel B's stacked entry points against their plain versions seed by
    seed at STACK_SHAPES, both conventions: one launch per kernel per call,
    the forward bands, gradients and dwh within GRAD_RTOL, dwh bitwise equal
    from run to run. Returns the worst errors."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import (
        gru_dwh_plain,
        gru_scan_bwd_plain,
        gru_scan_fwd_res_plain,
        gru_scan_stack,
        gru_scan_stack_bwd,
        gru_scan_stack_fwd_res,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    worst = {"fwd": 0.0, "bwd": 0.0, "dwh": 0.0}
    one = {"gru_scan_fwd": 1, "gru_scan_fwd_res": 1, "gru_scan_bwd": 1, "gru_dwh": 1,
           "gru_scan_sum_partials": 1, "gru_scan_retained": 0}
    for S, B, T, H in STACK_SHAPES:
        d0, d1 = _stack_operands(rng, dev, S, B, T, H)
        for reset_after in (False, True):
            def arg(i, reset_after=reset_after):   # operand i of both directions
                return (d0[i], d1[i]) if (i != 2 or reset_after) else (None, None)
            _reset_gru_counts()
            fwd = gru_scan_stack(arg(0), arg(1), arg(2), arg(3), reset_after, "sigmoid")
            res = gru_scan_stack_fwd_res(arg(0), arg(1), arg(2), arg(3), reset_after, "sigmoid")
            ys, rs = tuple(r[0] for r in res), tuple(r[1] for r in res)
            bwd = gru_scan_stack_bwd(ys, rs, arg(1), arg(3), arg(4), arg(5), reset_after,
                                     "sigmoid")
            torch.cuda.synchronize()
            counts = _gru_counts()
            check(counts == one, f"stacked S={S} H={H} launches {counts} != {one}")
            again = gru_scan_stack_bwd(ys, rs, arg(1), arg(3), arg(4), arg(5), reset_after,
                                       "sigmoid")
            for k, rev in enumerate((False, True)):
                check(all(torch.equal(a, b) for a, b in zip(bwd[k], again[k])),
                      f"stacked backward S={S} H={H} not bitwise equal run to run")
                for s in range(S):
                    a = (arg(0)[k][s], arg(1)[k][s], None if arg(2)[k] is None else arg(2)[k][s],
                         arg(3)[k][s])
                    want = gru_scan_fwd_res_plain(*a, reset_after, "sigmoid", rev)
                    err = max(max(_maxdiff(g[s], w) for g, w in zip(res[k], want)),
                              _maxdiff(fwd[k][0][s], want[0]), _maxdiff(fwd[k][1][s], want[2]))
                    check(err <= GRU_ATOL, f"stacked forward S={S} H={H} seed {s}: {err}")
                    worst["fwd"] = max(worst["fwd"], err)
                    want = gru_scan_bwd_plain(ys[k][s], rs[k][s], arg(1)[k][s], arg(3)[k][s],
                                              arg(4)[k][s], arg(5)[k][s], reset_after, "sigmoid",
                                              rev)
                    dwh = gru_dwh_plain(ys[k][s], rs[k][s], arg(3)[k][s], bwd[k][0][s],
                                        reset_after, rev)
                    for name, g, w in zip(("dxp", "dwh", "dbh", "dh0", "dwh/own dxp",
                                           "dbh/own dxp"),
                                          [b[s] for b in bwd[k]] + [bwd[k][1][s], bwd[k][2][s]],
                                          list(want) + list(dwh)):
                        scale = float(w.abs().max())
                        e = _maxdiff(g, w)
                        check(e <= GRAD_RTOL * max(scale, 1e-6),
                              f"stacked {name} S={S} H={H} seed {s}: {e} of {scale}")
                        key = "dwh" if "own" in name else "bwd"
                        worst[key] = max(worst[key], e / scale if scale else 0.0)
        print(f"[multiseed stacked] kernel B stacked S={S} B={B} T={T} H={H:2d}: forward, residual "
              f"forward, backward and dwh, both conventions, one launch each for {2 * S} "
              f"(seed, direction) pairs; against the plain versions seed by seed")
    print(f"[multiseed stacked] kernel B stacked worst: forward max|diff| {worst['fwd']:.3g}, "
          f"backward {worst['bwd']:.3g} and dwh on its own dxp {worst['dwh']:.3g} of max|grad|; "
          f"dwh bitwise equal run to run")
    return worst


def _stack_kernel_times(S: int, B: int, T: int, H: int) -> dict:
    """Stacked launches against S pair launches at one shape, reset_after=True
    sigmoid (timepooled-v2's GRUs): CUDA events, device and host times."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import (
        gru_scan_pair,
        gru_scan_pair_bwd,
        gru_scan_pair_fwd_res,
        gru_scan_stack,
        gru_scan_stack_bwd,
        gru_scan_stack_fwd_res,
    )

    d0, d1 = _stack_operands(np.random.default_rng(14), torch.device("cuda"), S, B, T, H)
    arg = lambda i: (d0[i], d1[i])  # noqa: E731
    per = [tuple((d0[i][s].contiguous(), d1[i][s].contiguous()) for i in range(6))
           for s in range(S)]
    res = gru_scan_stack_fwd_res(arg(0), arg(1), arg(2), arg(3), True, "sigmoid")
    ys, rs = tuple(r[0] for r in res), tuple(r[1] for r in res)
    pres = [gru_scan_pair_fwd_res(p[0], p[1], p[2], p[3], True, "sigmoid") for p in per]
    fns = {
        "fwd": lambda: gru_scan_stack(arg(0), arg(1), arg(2), arg(3), True, "sigmoid"),
        "fwd_res": lambda: gru_scan_stack_fwd_res(arg(0), arg(1), arg(2), arg(3), True, "sigmoid"),
        "bwd": lambda: gru_scan_stack_bwd(ys, rs, arg(1), arg(3), arg(4), arg(5), True, "sigmoid"),
    }
    sep = {
        "fwd": lambda: [gru_scan_pair(p[0], p[1], p[2], p[3], True, "sigmoid") for p in per],
        "fwd_res": lambda: [gru_scan_pair_fwd_res(p[0], p[1], p[2], p[3], True, "sigmoid")
                            for p in per],
        "bwd": lambda: [gru_scan_pair_bwd(tuple(r[0] for r in pr), tuple(r[1] for r in pr), p[1],
                                          p[3], p[4], p[5], True, "sigmoid")
                        for p, pr in zip(per, pres)],
    }
    bounds = dict(zip(("fwd", "fwd_res", "bwd"), _gru_bounds(S, B, T, H, True)))
    out = {}
    for name in ("fwd", "fwd_res", "bwd"):
        ms, sep_ms = cuda_ms(fns[name], reps=50), cuda_ms(sep[name], reps=20)
        dev_ms, host_ms = device_host_ms(fns[name])
        sep_dev, sep_host = device_host_ms(sep[name])
        out[name] = {"ms": ms, "device_ms": dev_ms, "host_ms": host_ms, "separate_ms": sep_ms,
                     "separate_device_ms": sep_dev, "separate_host_ms": sep_host,
                     "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
        if name == "bwd":   # the chain and the dwh reduction + sum apart, by device time
            by = _by_kernel(fns[name])
            out[name]["chain_device_ms"] = _part(by, "gru_warp_bwd")
            out[name]["dwh_device_ms"] = _part(by, "gru_warp_dwh", "gru_warp_sum")
        print(f"[multiseed stacked] kernel B {name} S={S} B={B} T={T} H={H}: one stacked launch "
              f"{ms:.4f} ms by events (device {_fmt(dev_ms)} ms, host issue {host_ms:.4f} ms) vs "
              f"{S} pair launches {sep_ms:.4f} ms (device {_fmt(sep_dev)} ms, host issue "
              f"{sep_host:.4f} ms); bound {bounds[name][0]:.6f} ms ({bounds[name][1]})")
    return out


def _fmt(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def _profile_once(fn) -> tuple:
    """(unprofiled wall ms, device-busy ms or None, the top rows) of one
    synchronized call of ``fn``, by the host clock and torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    return wall, (busy if busy > 0 else None), rows


def _step_fns(cfg, n_seeds: int, dev):
    """(stacked step, sequential steps) of ``n_seeds`` freshly initialized
    seeds of ``cfg`` on synthetic data: one `MultiSeedTrainer` step over all
    seeds, and one `Trainer` step per seed."""
    import torch

    from sed_crnn_torch.apps.train import synthetic_folds
    from sed_crnn_torch.models import get_model
    from sed_crnn_torch.models.stacked import StackedCRNN
    from sed_crnn_torch.train.loop import Rngs, Trainer, TrainState, make_samplers
    from sed_crnn_torch.train.multiseed import MultiSeedTrainer

    m, batch = cfg.model, cfg.train.batch_size
    frames = max(8000, int(batch * m.seq_len_in * 1.3))
    fold = synthetic_folds(1, frames=frames, n_classes=m.n_classes, n_mels=m.n_mels,
                           in_channels=m.in_channels)[1]
    tr, val = make_samplers(cfg, fold, dev)
    models = [get_model(m).init_parameters(torch.Generator().manual_seed(s))
              for s in range(n_seeds)]
    stacked = MultiSeedTrainer(StackedCRNN.from_models(models).to(dev), cfg.train, tr, val)
    rngs = [Rngs(dev, s, stacked.model.n_dropout_sites) for s in range(n_seeds)]
    st = TrainState(stacked.adam.init({k: p.detach() for k, p in stacked.params().items()}),
                    torch.ones(n_seeds, device=dev))
    singles = [Trainer(mm.to(dev), cfg.train, tr, val) for mm in models]
    sts = [TrainState(t.adam.init({k: p.detach() for k, p in t.params().items()}), 1.0)
           for t in singles]

    def stacked_step():
        nonlocal st
        x, y = stacked.draw_batch(tr, [r.batch for r in rngs])
        st, _, _ = stacked.train_step(st, x, y, [r.dropout for r in rngs])

    def sequential_steps():
        for i, (t, r) in enumerate(zip(singles, rngs)):
            x, y = tr.sample_batch(r.batch, batch)
            sts[i], _, _ = t.train_step(sts[i], x, y, r.dropout)

    return stacked_step, sequential_steps


def _median_ms(fn, reps: int = 10) -> float:
    """Median host-clock ms of ``reps`` synchronized calls, after 3 warm-ups."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _bf16_on_card() -> float:
    """timepooled-v2's bf16 trunk on the card against the CPU's float32
    forward, within BF16_BAND of the JAX distance for each weight seed and
    mode; returns the worst share of the band's limit."""
    import torch

    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.models import get_model
    from sed_crnn_torch.models.convert import from_jax

    mcfg = dataclasses.replace(get_preset("timepooled-v2").model, dropout=0.0)
    worst = 0.0
    for seed in (0, 1, 2):
        params, state = model_tree(mcfg, seed)
        x = bf16_input(seed)
        for train in (False, True):
            out = {}
            for dtype, dev in (("float32", "cpu"), ("bfloat16", "cuda")):
                m = get_model(dataclasses.replace(mcfg, compute_dtype=dtype))
                m.load_state_dict(from_jax(params, state, m.cfg))
                with torch.no_grad():
                    out[dev] = m.to(dev).train(train)(torch.from_numpy(x).to(dev))[0].cpu()
            dist = float((out["cuda"] - out["cpu"]).abs().max())
            limit = BF16_BAND * BF16_JAX_DIST[seed, train]
            check(dist <= limit, f"bf16 trunk on the card seed {seed} train {train}: {dist} > "
                                 f"{limit}")
            worst = max(worst, dist / limit)
            print(f"[multiseed stacked] bf16 trunk timepooled-v2 seed {seed} "
                  f"{'train' if train else 'eval'}: card bf16 vs CPU float32 max|diff| {dist:.4g}, "
                  f"JAX's own {BF16_JAX_DIST[seed, train]:.4g}, limit {limit:.4g}")
    return worst


def phase_multiseed_stacked(workdir: str):
    """[multiseed stacked]: kernel B's stacked checks and times, the bf16
    trunk on the card, `apps.train --runs 5` on timepooled-v2 in both modes
    (histories, best epochs, exact launch counts, rates, profiles), and the
    conv-128 split behind `choose_runs_mode`. Returns the stacked run's GRU
    launch counts and the kernel numbers."""
    import torch

    from sed_crnn_torch.apps import train as train_app
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.train.loop import make_samplers
    from sed_crnn_torch.train.multiseed import STACKED_SPLIT_BATCH, choose_runs_mode

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    worst = _stack_kernel_checks()
    times = {H: _stack_kernel_times(STACK_RUNS, 128, 8, H) for H in (16, 8)}
    times[32] = _stack_kernel_times(2, 128, GRU_T, 32)
    bf16_share = _bf16_on_card()

    # Both modes on timepooled-v2 through the CLI, full width.
    cfg = get_preset("timepooled-v2")
    batch, seq = cfg.train.batch_size, cfg.model.seq_len_in
    audio_per_step = batch * seq / FRAMES_PER_SEC
    frames = max(8000, int(batch * seq * 1.3))          # as apps.train --synthetic makes them
    fold = train_app.synthetic_folds(1, frames=frames, n_classes=cfg.model.n_classes,
                                     n_mels=cfg.model.n_mels)[1]
    tr, val = make_samplers(cfg, fold, dev)
    n_train = tr.steps_per_epoch(batch)
    n_val = max(1, val.steps_per_epoch(batch, drop_last=False))
    layers = len(cfg.model.gru_hidden)
    runs, wall, counts = {}, {}, {}
    for mode in ("stacked", "sequential"):
        art = os.path.join(workdir, mode)
        _reset_gru_counts()
        t0 = time.perf_counter()
        with _no_plain_gru_on_card() as plain_on_card:
            runs[mode], _ = _quiet(train_app.main, [
                "--preset", "timepooled-v2", "--synthetic", "--folds", "1",
                "--runs", str(STACK_RUNS), "--runs-mode", mode, "--max-epochs", str(STACK_EPOCHS),
                "--plot-every", "0", "--device", "cuda", "--art-dir", art])
            torch.cuda.synchronize()
        wall[mode] = time.perf_counter() - t0
        counts[mode] = _gru_counts()
        per = 1 if mode == "stacked" else STACK_RUNS
        want = _gru_path_counts(per * layers * n_val * STACK_EPOCHS,
                                per * layers * n_train * STACK_EPOCHS)
        check(counts[mode] == want and not plain_on_card,
              f"timepooled-v2 --runs-mode {mode} launches {counts[mode]} != {want}")
        (run,) = os.listdir(art)
        epoch_sec = {}
        for s in runs[mode]["seeds"]:
            with open(os.path.join(art, run, "fold1", f"seed{s}", "train_fold1.jsonl")) as f:
                epoch_sec[s] = [json.loads(ln)["epoch_sec"] for ln in f]
        # seconds of training and validation, checkpoint writing excluded
        sec = (sum(epoch_sec[runs[mode]["seeds"][0]]) if mode == "stacked"
               else sum(sum(v) for v in epoch_sec.values()))
        rate = STACK_RUNS * n_train * STACK_EPOCHS * audio_per_step / sec
        runs[mode]["rate"], runs[mode]["epoch_sec"] = rate, epoch_sec
        print(f"[multiseed stacked] apps.train timepooled-v2 --runs {STACK_RUNS} --runs-mode {mode}"
              f" (full width, batch {batch}, bf16 trunk, {STACK_EPOCHS} epochs x {n_train} train +"
              f" {n_val} validation steps): wall {wall[mode]:.2f} s, epochs {sec:.2f} s -> "
              f"{rate:,.0f} audio-sec/sec aggregate ({audio_per_step:.1f} audio-s per seed-step); "
              f"ER {runs[mode]['mean_er']:.4f} ± {runs[mode]['std_er']:.4f}; launches "
              f"{counts[mode]}")
    worst_loss, worst_metric = 0.0, 0.0
    for j, s in enumerate(runs["stacked"]["seeds"]):
        a, b = runs["stacked"]["folds"][1][j], runs["sequential"]["folds"][1][j]
        check((a.best_epoch, a.epochs_run) == (b.best_epoch, b.epochs_run),
              f"seed {s}: stacked best epoch {a.best_epoch} / {a.epochs_run} run vs sequential "
              f"{b.best_epoch} / {b.epochs_run}")
        for k, v in b.history.items():
            g, w = np.asarray(a.history[k]), np.asarray(v)
            if k.startswith("loss"):
                e = float(np.max(np.abs(g - w) / np.abs(w)))
                check(e <= STACK_LOSS_RTOL, f"seed {s} {k}: stacked {g} vs sequential {w}")
                worst_loss = max(worst_loss, e)
            else:
                e = float(np.max(np.abs(g - w)))
                check(e <= STACK_METRIC_ATOL, f"seed {s} {k}: stacked {g} vs sequential {w}")
                worst_metric = max(worst_metric, e)
    print(f"[multiseed stacked] stacked vs sequential per seed: loss histories within "
          f"{worst_loss:.3g} relative (band {STACK_LOSS_RTOL}), ER/F1 within {worst_metric:.3g} "
          f"(band {STACK_METRIC_ATOL}), the same best epochs "
          f"{[r.best_epoch for r in runs['stacked']['folds'][1]]}; aggregate rate stacked / "
          f"sequential {runs['stacked']['rate'] / runs['sequential']['rate']:.2f}")

    # One step of each mode at steady state: rate, profile and idle share.
    stacked_step, sequential_steps = _step_fns(cfg, STACK_RUNS, dev)
    step = {"stacked": _median_ms(stacked_step), "sequential": _median_ms(sequential_steps)}
    for mode, fn in (("stacked", stacked_step), ("sequential", sequential_steps)):
        wall_ms, busy, rows = _profile_once(fn)
        rate = STACK_RUNS * audio_per_step / (step[mode] / 1e3)
        idle = "not measured" if busy is None else f"{max(0.0, 1 - busy / wall_ms):.3f}"
        print(f"[multiseed stacked] {mode} step, {STACK_RUNS} seeds of timepooled-v2 at batch "
              f"{batch}: host clock median {step[mode]:.2f} ms -> {rate:,.0f} audio-sec/sec; "
              f"profiled: wall {wall_ms:.2f} ms, device busy {_fmt(busy)} ms, idle share {idle}")
        for e in rows[:8]:
            print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:5d}  "
                  f"{e.key[:90]}")

    # The conv-128 split: stacked vs sequential step rate at batch 128.
    split = {}
    for name, n_seeds in SPLIT_CELLS:
        c = get_preset(name)
        st_fn, seq_fn = _step_fns(c, n_seeds, dev)
        st_ms, seq_ms = _median_ms(st_fn, reps=5), _median_ms(seq_fn, reps=5)
        split[name, n_seeds] = seq_ms / st_ms
        eff = c.train.batch_size * n_seeds
        print(f"[multiseed stacked] split {name} x{n_seeds} (effective batch {eff}): stacked step "
              f"{st_ms:.2f} ms vs {n_seeds} sequential steps {seq_ms:.2f} ms -> stacked / "
              f"sequential rate {seq_ms / st_ms:.3f}; choose_runs_mode says "
              f"{choose_runs_mode(c, n_seeds)} (split {STACKED_SPLIT_BATCH})")
    print(f"[multiseed stacked] phase wall {time.perf_counter() - t_phase:.1f} s")
    numbers = {"worst": worst, "times": times, "bf16_share": bf16_share,
               "rates": {m: runs[m]["rate"] for m in runs}, "steps_ms": step,
               "split": {f"{k[0]} x{k[1]}": v for k, v in split.items()}}
    return counts["stacked"], numbers


SERVE_STREAMS = 8        # concurrent TCP clients of the [serve] daemon (--max-streams)
SERVE_TIMEOUT_S = 120    # every client socket and the daemon's join


def _gap_thresholds(probs: np.ndarray) -> list:
    """Per class, the midpoint of the widest gap between the sorted
    probabilities from the median to the 99.5th percentile: an operating
    point at which the class fires and no frame sits near the edge."""
    out = []
    for p in np.sort(np.asarray(probs, np.float64), axis=0).T:
        hi = p[len(p) // 2 : int(len(p) * 0.995)]
        i = int(np.argmax(np.diff(hi)))
        out.append(float((hi[i] + hi[i + 1]) / 2))
    return out


class _BlockCount:
    """Counts the non-empty frame blocks of every framer that `apps/serve.py`
    makes while it is installed (the handler threads share it)."""

    def __init__(self, serve_app):
        self.app, self.real = serve_app, serve_app.make_framer
        self.blocks = 0
        self._lock = threading.Lock()

    def __enter__(self):
        counter = self

        class Counting:
            def __init__(self, *args):
                self.inner = counter.real(*args)

            def _count(self, frames):
                if frames.shape[0]:
                    with counter._lock:
                        counter.blocks += 1
                return frames

            def feed(self, pcm):
                return self._count(self.inner.feed(pcm))

            def flush(self):
                return self._count(self.inner.flush())

        self.app.make_framer = Counting
        return self

    def __exit__(self, *exc):
        self.app.make_framer = self.real


def _serve_daemon(serve_app, art_path: str, pcm: np.ndarray, profiled: bool = False) -> dict:
    """`apps.serve.main --listen` with ``SERVE_STREAMS`` clients sending the
    whole wav at once as f32le; every socket and join bounded by
    ``SERVE_TIMEOUT_S``. -> the clients' lines, the daemon's counts, the wall
    time from the first connect to the last reply, and (``profiled``) the
    device-busy time of the run."""
    import queue
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    result: "queue.SimpleQueue" = queue.SimpleQueue()

    def daemon():
        try:
            result.put(serve_app.main([
                "--artifact", art_path, "--pcm", "f32le", "--listen", str(port),
                "--connections", str(SERVE_STREAMS), "--max-streams", str(SERVE_STREAMS),
                "--device", "cuda"]))
        except BaseException as e:  # handed to the phase, which raises it
            result.put(e)

    payload = pcm.astype("<f4").tobytes()
    lines = [None] * SERVE_STREAMS

    def client(i):
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while True:
            try:
                s = socket.create_connection(("127.0.0.1", port), timeout=1)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.02)
        with s:
            s.settimeout(SERVE_TIMEOUT_S)
            s.sendall(payload)
            s.shutdown(socket.SHUT_WR)
            data = b""
            while chunk := s.recv(1 << 16):
                data += chunk
        lines[i] = [json.loads(ln) for ln in data.decode().splitlines()]

    server = threading.Thread(target=daemon, daemon=True)
    clients = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(SERVE_STREAMS)]
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
            else contextlib.nullcontext())
    with prof:
        server.start()
        t0 = time.perf_counter()
        for t in clients:
            t.start()
        for t in clients + [server]:
            t.join(timeout=SERVE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    check(not any(t.is_alive() for t in clients + [server]),
          f"the daemon or a client did not finish within {SERVE_TIMEOUT_S} s")
    counts = result.get(timeout=1)
    if isinstance(counts, BaseException):
        raise counts
    check(all(ln is not None for ln in lines), "a client got no reply")
    busy = None
    if profiled:
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6 or None
    return {"lines": lines, "counts": counts, "wall": wall, "busy": busy}


def phase_serve(train_dir: str, workdir: str, pcm: np.ndarray):
    """The export and live-serving path at full width on the card
    ([serve]): phase 9's best sednet-dcase checkpoint exported through
    `apps.export`, `infer_file_artifact` card vs CPU and against
    `infer_file`, `serve_stream` on random packets, and the `--listen`
    daemon with 8 concurrent clients, with exact launch counts."""
    from unittest import mock

    import torch

    from sed_crnn_torch.apps import export as export_app
    from sed_crnn_torch.apps import serve as serve_app
    from sed_crnn_torch.apps.infer import infer_file, infer_file_artifact
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.data.eventio import default_class_names
    from sed_crnn_torch.data.rasterize import events_from_labels
    from sed_crnn_torch.data.wavio import write_wav
    from sed_crnn_torch.models.export import ServingArtifact
    from sed_crnn_torch.ops import frontend
    from sed_crnn_torch.ops.kernels.gru_scan import gru_scan_pair, gru_scan_plain
    from sed_crnn_torch.ops.stft import num_frames

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    preset = "sednet-dcase"
    cfg = get_preset(preset)
    m = cfg.model
    os.makedirs(workdir)
    best = os.path.join(train_dir, "fold1", "best_fold1.npz")
    wav = os.path.join(workdir, "tones_120s.wav")
    write_wav(wav, pcm, SR)

    # Kernel B at the shapes this path gives it first: the lookahead pair
    # (T=512) and the daemon's batch (B=8), from carried states.
    rng = np.random.default_rng(17)
    H = m.gru_hidden[0]
    pair_err = 0.0
    for B, T in ((1, 2 * m.seq_len_in), (SERVE_STREAMS, m.seq_len_in)):
        sets = [tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            rng.standard_normal((B, T, 3 * H)), rng.standard_normal((H, 3 * H)) / np.sqrt(H),
            0.5 * rng.standard_normal((B, H)))) for _ in range(2)]
        got = gru_scan_pair(*(tuple(s[k] for s in sets) for k in range(2)), (None, None),
                            tuple(s[2] for s in sets), False, "sigmoid")
        for k, rev in enumerate((False, True)):
            want = gru_scan_plain(sets[k][0], sets[k][1], None, sets[k][2], False, "sigmoid", rev)
            pair_err = max(pair_err, *(_maxdiff(g, w) for g, w in zip(got[k], want)))
    check(pair_err <= GRU_ATOL, f"kernel B pair forward at T=512 / B=8: {pair_err}")

    # The fold's statistics, fit on the served file's log-mels and recorded in a
    # fold pack as the feature app records them (arr_4, arr_5).
    fe = dataclasses.replace(cfg.frontend, log_floor=1e-10)
    st = frontend.fit_norm_stats(frontend.extract(pcm, fe, device=dev))
    stats = (st.mean.cpu().numpy(), st.scale.cpu().numpy())
    cache = os.path.join(workdir, "cache")
    os.makedirs(cache)
    x0, y0 = np.zeros((4, m.n_mels), np.float32), np.zeros((4, m.n_classes), np.float32)
    np.savez(os.path.join(cache, "mbe_mon_fold1.npz"), x0, y0, x0, y0, *stats)

    # Per-class operating points from the checkpoint's own probabilities.
    probs0, _, _ = infer_file(wav, best, preset, stats, device=dev)
    thr = _gap_thresholds(probs0)
    margin = min(float(np.abs(probs0[:, c] - t).min()) for c, t in enumerate(thr))

    # 1. Export, with the kernel frontend in the cfg handed to export_serving.
    art_path = os.path.join(workdir, "sednet.sedart")
    kernel_cfg = cfg.replace(frontend=dataclasses.replace(cfg.frontend, backend="kernel"))
    with mock.patch.object(export_app, "get_preset", return_value=kernel_cfg):
        out, _ = _quiet(export_app.main, [
            "--checkpoint", best, "--preset", preset, "--stats-from", cache, "--fold", "1",
            "--threshold", *(repr(t) for t in thr), "--out", art_path, "--device", "cuda"])
    check(out["norm_folded"] and out["default_threshold"] == thr, f"export {out}")
    art = ServingArtifact.load(art_path, "cuda")
    art_cpu = ServingArtifact.load(art_path, "cpu")
    check(art.meta == art_cpu.meta and art.meta["frontend"]["backend"] == "kernel",
          "the artifact's metadata")

    # 2. infer_file_artifact, card vs CPU and against infer_file, with and
    # without lookahead; launches counted on the card runs alone.
    n_frames = num_frames(len(pcm), fe.n_fft, fe.hop_length, fe.center)
    n_chunks = -(-n_frames // m.seq_len_in)
    _reset_logmel_counts()
    _reset_gru_counts()
    with _no_plain_gru_on_card() as plain_on_card:
        card = {la: infer_file_artifact(wav, art_path, lookahead=la, device="cuda")
                for la in (False, True)}
        torch.cuda.synchronize()
    logmel, gru = _logmel_counts(), _gru_counts()
    check(logmel == {"chunked": 2, "framed": 0, "exact": 0, "dft": 0},
          f"infer_file_artifact kernel A launches {logmel}")
    check(gru == _gru_path_counts(2 * 2 * n_chunks, 0) and not plain_on_card,
          f"infer_file_artifact kernel B launches {gru} ({n_chunks} chunks)")
    launches = {"chunked": logmel["chunked"], "gru_scan_fwd": gru["gru_scan_fwd"]}
    errs = {}
    out_hop = cfg.frontend.hop_length * (m.seq_len_in // m.seq_len_out)
    for la in (False, True):
        probs, events, _ = card[la]
        cpu_probs, cpu_events, _ = infer_file_artifact(wav, art_path, lookahead=la, device="cpu")
        ref_probs, _, _ = infer_file(wav, best, preset, stats, thr, lookahead=la, device=dev)
        check(probs.shape == (n_frames, m.n_classes) and bool(np.isfinite(probs).all()),
              f"artifact probabilities {probs.shape}")
        # The artifact pads the last chunk's raw log-mels with zeros and
        # normalizes in the program (the JAX artifact's semantics); infer_file
        # pads after normalizing. So the two agree up to the chunk that the
        # padded one reaches: the last, and under lookahead the one before.
        k = (n_chunks - 1 - la) * m.seq_len_out
        ref_ev, got_ev = (events_from_labels(p[:k], SR, out_hop, np.float32(thr))
                          for p in (ref_probs, probs))
        errs[la] = (float(np.abs(probs - cpu_probs).max()),
                    float(np.abs(probs[:k] - ref_probs[:k]).max()),
                    float(np.abs(probs[k:] - ref_probs[k:]).max()))
        check(errs[la][0] <= PROB_ATOL and events == cpu_events,
              f"lookahead={la}: artifact card vs CPU {errs[la][0]}, events equal "
              f"{events == cpu_events}")
        check(errs[la][1] <= 1e-5 and got_ev == ref_ev,
              f"lookahead={la}: artifact vs infer_file on the first {k} frames {errs[la][1]}, "
              f"events equal {got_ev == ref_ev}")
    events0 = card[False][1]
    check(len(events0) > 0, "the artifact's operating points decode events")
    print(f"[serve] apps.export of phase 9's best checkpoint (kernel frontend, --stats-from, "
          f"{m.n_classes} thresholds {[round(t, 4) for t in thr]}, nearest frame "
          f"{margin:.3g} away): {out['bytes']} bytes; infer_file_artifact on the {len(pcm) / SR:.0f}"
          f" s wav: {len(events0)} events; card vs CPU max|diff| {errs[False][0]:.3g} "
          f"(lookahead {errs[True][0]:.3g}), events equal; vs infer_file {errs[False][1]:.3g} "
          f"(lookahead {errs[True][1]:.3g}) before the chunks the padded tail reaches, events "
          f"there equal, and {errs[False][2]:.3g} (lookahead {errs[True][2]:.3g}) in them; "
          f"launches {launches}")

    # 3. serve_stream through the direct stepper on random packet sizes.
    def packets(seed):
        r = np.random.default_rng(seed)
        i = 0
        while i < len(pcm):
            step = int(r.integers(256, 8193))
            yield pcm[i : i + step]
            i += step

    stepper = serve_app._DirectStepper(art)
    lines = []
    _reset_logmel_counts()
    _reset_gru_counts()
    with _BlockCount(serve_app) as blocks, _no_plain_gru_on_card() as plain_on_card:
        t0 = time.perf_counter()
        n_out, n_events = serve_app.serve_stream(art, packets(19), lines.append, stepper=stepper)
        live_s = time.perf_counter() - t0
    logmel, gru = _logmel_counts(), _gru_counts()
    n_steps = len(stepper.latencies)
    check(n_steps == n_chunks and n_out == n_frames, f"serve_stream {n_steps} steps, {n_out} frames")
    check(logmel == {"chunked": 0, "framed": blocks.blocks, "exact": 0, "dft": 0},
          f"serve_stream kernel A launches {logmel} vs {blocks.blocks} framer blocks")
    check(gru == _gru_path_counts(2 * n_steps, 0) and not plain_on_card,
          f"serve_stream kernel B launches {gru}")
    launches["framed"] = logmel["framed"]
    launches["gru_scan_fwd"] += gru["gru_scan_fwd"]
    live_events = [ln for ln in lines if ln["type"] == "event"]
    check(sorted((ln["start_s"], ln["end_s"], ln["class"]) for ln in live_events)
          == sorted((round(s, 3), round(e, 3), c) for s, e, c in events0),
          "serve_stream's events differ from infer_file_artifact's")
    lat = np.asarray(stepper.latencies) * 1e3
    print(f"[serve] serve_stream, f32le packets of 256-8192 samples: {n_out} frames, "
          f"{n_events} event lines equal to infer_file_artifact's, {blocks.blocks} framer "
          f"blocks, {n_steps} steps in {live_s:.2f} s; step p50 {np.percentile(lat, 50):.3f} ms "
          f"p99 {np.percentile(lat, 99):.3f} ms (host clock to the host copy)")

    # 4. The daemon: 8 concurrent clients, one batched step per tick.
    names = default_class_names(m.n_classes)
    _reset_logmel_counts()
    _reset_gru_counts()
    with _BlockCount(serve_app) as blocks, _no_plain_gru_on_card() as plain_on_card:
        run = _serve_daemon(serve_app, art_path, pcm)
    logmel, gru = _logmel_counts(), _gru_counts()
    ticks, stepped = run["counts"]["ticks"], run["counts"]["stepped"]
    check(run["counts"]["served"] == SERVE_STREAMS and stepped == SERVE_STREAMS * n_steps,
          f"daemon counts {run['counts']}")
    check(n_steps <= ticks <= SERVE_STREAMS * n_steps, f"{ticks} ticks for {n_steps} chunks")
    check(gru == _gru_path_counts(2 * ticks, 0) and not plain_on_card,
          f"daemon kernel B launches {gru} vs 2 x {ticks} ticks")
    check(logmel == {"chunked": 0, "framed": blocks.blocks, "exact": 0, "dft": 0},
          f"daemon kernel A launches {logmel} vs {blocks.blocks} framer blocks")
    launches["framed"] += logmel["framed"]
    launches["gru_scan_fwd"] += gru["gru_scan_fwd"]
    for got in run["lines"]:
        ev = [ln for ln in got if ln["type"] == "event"]
        check([{k: v for k, v in ln.items() if k != "label"} for ln in ev] == live_events
              and all(ln["label"] == names[ln["class"]] for ln in ev),
              "a daemon client's event lines differ from serve_stream's")
        check(got[-1]["type"] == "summary" and got[-1]["n_output_frames"] == n_out,
              f"a daemon client's summary {got[-1]}")
    p50 = float(np.median([got[-1]["step_ms_p50"] for got in run["lines"]]))
    p99 = float(max(got[-1]["step_ms_p99"] for got in run["lines"]))
    rate = SERVE_STREAMS * len(pcm) / SR / run["wall"]
    prof = _serve_daemon(serve_app, art_path, pcm, profiled=True)
    idle = "not measured" if prof["busy"] is None else f"{1 - prof['busy'] / run['wall']:.3f}"
    busy = "not measured" if prof["busy"] is None else f"{prof['busy'] * 1e3:.1f} ms"
    print(f"[serve] daemon --max-streams {SERVE_STREAMS}, {SERVE_STREAMS} clients sending the "
          f"{len(pcm) / SR:.0f} s wav at once: {ticks} ticks, {stepped} chunk steps, "
          f"{stepped / ticks:.2f} streams per tick; per-step p50 {p50:.2f} ms (median over "
          f"clients) p99 {p99:.2f} ms (max); wall {run['wall']:.2f} s -> {rate:,.0f} "
          f"audio-sec/sec; device busy {busy} in a profiled repeat, idle share {idle}; every "
          f"client's event lines equal serve_stream's; launches {gru['gru_scan_fwd']} pair "
          f"forwards (2 x ticks), {logmel['framed']} framed (= framer blocks)")

    # stream_step_batch at B=8 against 8 stream_steps at B=1, on real chunks.
    mel = frontend.extract(pcm, dataclasses.replace(fe, backend="kernel"), device=dev)
    chunks = mel[: SERVE_STREAMS * m.seq_len_in].reshape(SERVE_STREAMS, m.seq_len_in, -1)
    carry8, carry1 = art.stream_init_batch(SERVE_STREAMS), art.stream_init()

    def batch8():
        return art.stream_step_batch(carry8, chunks)

    def singles8():
        return [art.stream_step(carry1, chunks[i]) for i in range(SERVE_STREAMS)]

    b8_ms, b1x8_ms = cuda_ms(batch8, reps=20), cuda_ms(singles8, reps=10)
    b8_dev, b8_host = device_host_ms(batch8)
    b1x8_dev, b1x8_host = device_host_ms(singles8, reps=10)
    T, B = m.seq_len_in, SERVE_STREAMS
    nbytes = 2 * 4 * (B * T * 3 * H + H * 3 * H + 2 * B * H + B * T * H)
    bnd, by = bound_ms(nbytes, 2 * T * B * (2 * H * 3 * H + 12 * H))
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731

    # The live rows (the framed route on the framer's frames) against the
    # offline rows (`extract`'s chunked route): the same FFT body per frame.
    framer = serve_app.make_framer(fe.n_fft, fe.hop_length, fe.center)
    frames = np.concatenate([framer.feed(pcm), framer.flush()])
    live_rows = frontend.log_mel_from_frames(torch.from_numpy(frames).to(dev),
                                             dataclasses.replace(fe, backend="kernel"))
    rows_equal = bool(torch.equal(live_rows, mel))
    rows_err = 0.0 if rows_equal else _maxdiff(live_rows, mel)
    wall = time.perf_counter() - t_phase
    print(f"[serve] stream_step_batch B={B}: {b8_ms:.4f} ms by events (device {fmt(b8_dev)}, "
          f"host issue {b8_host:.4f} ms) vs {B} x stream_step B=1: {b1x8_ms:.4f} ms (device "
          f"{fmt(b1x8_dev)}, host issue {b1x8_host:.4f} ms); kernel B pair at B={B} bound "
          f"{bnd:.6f} ms ({by}); pair at T=512 / B=8 vs plain {pair_err:.3g}; live vs offline "
          f"log-mel rows ({frames.shape[0]} frames) bitwise equal: {rows_equal} (max|diff| "
          f"{rows_err:.3g}); phase wall {wall:.1f} s")
    return launches, {
        "serve_max_abs_err": pair_err, "serve_b8_ms": b8_ms, "serve_b8_device_ms": b8_dev,
        "serve_b8_host_ms": b8_host, "serve_b1x8_ms": b1x8_ms, "serve_b1x8_device_ms": b1x8_dev,
        "serve_b1x8_host_ms": b1x8_host, "serve_b8_bound_ms": bnd, "serve_b8_bound_by": by,
        "serve_rate_audio_s_per_s": rate, "serve_step_p50_ms": p50, "serve_step_p99_ms": p99,
        "serve_ticks": ticks, "serve_idle_share": None if prof["busy"] is None
        else 1 - prof["busy"] / run["wall"], "serve_live_rows_bitwise": rows_equal}


def main() -> int:
    smi = phase_device()
    import torch

    from sed_crnn_torch.core.device import set_full_fp32

    set_full_fp32()
    phase_build()
    from sed_crnn_torch.core.config import FrontendConfig

    pcm = tones(120.0, 9, silent=[(50.0, 52.0)])
    kernel_a, dft_err = phase_logmel(bucket_signal(pcm, FrontendConfig()))
    kernel_b, retained = phase_gru()
    with tempfile.TemporaryDirectory() as workdir:
        launches, fe_kernel, model = phase_main(workdir, pcm)
    phase_throughput(fe_kernel, model, pcm)
    kernel_fwd_res, kernel_bwd, kernel_dwh, kernel_retained = phase_gru_train(retained)
    phase_train_step()
    with tempfile.TemporaryDirectory() as workdir:
        train_dir, feature_dir = (os.path.join(workdir, d) for d in ("train", "feature"))
        train_launches, cfg, fold = phase_train(train_dir)
        phase_train_throughput(cfg, fold)
        kernel_framed, kernel_exact, kernel_dft = phase_logmel_routes(pcm, dft_err)
        os.makedirs(feature_dir)
        feature_launches, cache, _ = phase_feature(feature_dir)
        binmul_best = phase_feature_train(feature_dir, cache)
        eval_launches, eval_numbers = phase_evaluate(train_dir, cache, binmul_best)
        phase_multiseed(os.path.join(workdir, "multiseed"))
        stack_launches, stack = phase_multiseed_stacked(os.path.join(workdir, "stacked"))
        serve_launches, serve_numbers = phase_serve(train_dir, os.path.join(workdir, "serve"),
                                                    pcm)
    kernel_b.update(eval_numbers)
    kernel_b.update(serve_numbers)
    kernel_b["max_abs_err"] = max(kernel_b["max_abs_err"], serve_numbers["serve_max_abs_err"])
    launches["gru_scan_fwd"] += eval_launches + serve_launches["gru_scan_fwd"]
    launches["fused_logmel"] += serve_launches["chunked"]
    launches.update({k: train_launches[k] for k in ("gru_scan_fwd_res", "gru_scan_bwd",
                                                    "gru_dwh")})
    launches["fused_logmel_framed"] = feature_launches["framed"] + serve_launches["framed"]
    launches["fused_logmel_exact"] = kernel_exact.pop("launches")
    launches["fused_logmel_dft"] = kernel_dft.pop("launches")
    launches["gru_scan_retained"] = kernel_retained.pop("launches")
    # kernel B's stacked launches (one per kernel for all seeds) on the
    # stacked main path, and its stacked numbers at timepooled-v2's H=16
    for k in ("gru_scan_fwd", "gru_scan_fwd_res", "gru_scan_bwd", "gru_dwh"):
        launches[k] += stack_launches[k]
    shape = f"S={STACK_RUNS} B=128 T=8 H=16 reset_after=True"
    for entry, name in ((kernel_b, "fwd"), (kernel_fwd_res, "fwd_res"), (kernel_bwd, "bwd")):
        t = stack["times"][16][name]
        entry.update({"stack_shape": shape, "stack_ms": t["ms"], "stack_device_ms": t["device_ms"],
                      "stack_host_ms": t["host_ms"], "stack_separate_ms": t["separate_ms"],
                      "stack_bound_ms": t["bound_ms"], "stack_bound_by": t["bound_by"]})
    kernel_dwh.update({"stack_shape": shape,
                       "stack_device_ms": stack["times"][16]["bwd"]["dwh_device_ms"]})
    kernel_b["max_abs_err"] = max(kernel_b["max_abs_err"], stack["worst"]["fwd"])
    kernel_fwd_res["max_abs_err"] = max(kernel_fwd_res["max_abs_err"], stack["worst"]["fwd"])
    kernel_bwd["max_abs_err"] = max(kernel_bwd["max_abs_err"], stack["worst"]["bwd"])
    kernel_dwh["max_abs_err"] = max(kernel_dwh["max_abs_err"], stack["worst"]["dwh"])
    kernels = []
    head = ("name", "route", "source", "replaces")
    for k in (kernel_a, kernel_framed, kernel_exact, kernel_dft, kernel_b, kernel_fwd_res,
              kernel_bwd, kernel_dwh, kernel_retained):
        kernels.append({**{key: k[key] for key in head}, "launches": launches[k["name"]],
                        **{key: v for key, v in k.items() if key not in head}})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
