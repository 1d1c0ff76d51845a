#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and feature-extraction paths
on one GPU and check its kernels.

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
    and the CPU.

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


def sednet_tree(model_cfg, seed: int):
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
    mel_out = model_cfg.n_mels
    for p in model_cfg.pool:
        mel_out //= p
    d_in = model_cfg.conv_channels[-1] * mel_out
    for h in model_cfg.gru_hidden:
        params["gru"].append({
            d: {"wi": w((d_in, 3 * h), d_in), "wh": w((h, 3 * h), h), "bi": b(3 * h)}
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
    params, state = sednet_tree(cfg.model, seed=11)
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
    params, state = sednet_tree(cfg.model, seed=11)
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
    params, state = sednet_tree(cfg.model, seed=11)
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
        train_launches, cfg, fold = phase_train(workdir)
    phase_train_throughput(cfg, fold)
    kernel_framed, kernel_exact, kernel_dft = phase_logmel_routes(pcm, dft_err)
    with tempfile.TemporaryDirectory() as workdir:
        feature_launches, cache, _ = phase_feature(workdir)
        phase_feature_train(workdir, cache)
    launches.update({k: train_launches[k] for k in ("gru_scan_fwd_res", "gru_scan_bwd",
                                                    "gru_dwh")})
    launches["fused_logmel_framed"] = feature_launches["framed"]
    launches["fused_logmel_exact"] = kernel_exact.pop("launches")
    launches["fused_logmel_dft"] = kernel_dft.pop("launches")
    launches["gru_scan_retained"] = kernel_retained.pop("launches")
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
