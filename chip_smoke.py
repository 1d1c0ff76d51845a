#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one GPU and check its kernels.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card

Phases, each printing its own lines; any failed check raises, so the script
exits non-zero and prints no result line:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel from ``sed_crnn_torch/csrc/*.cu`` (one nvcc
   per source, in parallel) into ``build/sed_crnn_torch/``;
3. kernel A (fused log-mel) against its plain PyTorch version on the card:
   a 30 s bucket, a 240 s signal, a ragged length and an all-silence input,
   with and without a log floor; log-domain atol 5e-4 at finite entries and
   an identical -inf pattern;
4. kernel B (GRU recurrence) against its plain version: T=256, H=32,
   B in {1, 8, 128}, both conventions, both gates, both directions, non-zero
   h0; atol 1e-5;
5. the main path at full width: ``sednet-dcase`` weights from a numpy seed
   in the JAX layout, written as a JAX-format checkpoint, and a 120 s 44.1 kHz
   wav with tone bursts, served by ``apps.infer.infer_file`` and by the same
   composition with the ``"kernel"`` frontend, on the card and on the CPU
   (plain versions); logits within 1e-3, probabilities within 1e-3, events
   equal, and both kernels' launch counts read around this phase alone
   (kernel A once per kernel-frontend ``extract``, kernel B 4x per chunk);
6. throughput in ``bench.py``'s units (audio-seconds per second).

The line before the last is one JSON object with every kernel's numbers;
the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def phase_logmel(main_signal: np.ndarray):
    import torch

    from sed_crnn_torch.core.config import FrontendConfig
    from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel, fused_log_mel_plain
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
    worst = 0.0
    for name, y, center in cases:
        for floor in (None, 1e-10):
            cfg = dataclasses.replace(base, center=center, log_floor=floor)
            yt = torch.from_numpy(y).to(dev)
            got = fused_log_mel(yt, cfg)
            want = fused_log_mel_plain(yt, cfg)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            check(torch.equal(torch.isfinite(got), fin), f"log-mel {name}: -inf pattern")
            check(torch.equal(got[~fin], want[~fin]), f"log-mel {name}: non-finite values")
            err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
            if name == "silence" and floor is None:
                check(not bool(fin.any()), "silence without a floor must be all -inf")
            check(err <= LOGMEL_ATOL, f"log-mel {name} floor={floor}: {err} > {LOGMEL_ATOL}")
            worst = max(worst, err)
            print(f"[kernel A] {name:10s} floor={floor}: shape {tuple(got.shape)} "
                  f"max|diff| at finite {err:.3g}")

    # Times at the main path's shape: the 120 s file's bucket-padded signal.
    cfg = dataclasses.replace(base, center=False, log_floor=1e-10)
    yt = torch.from_numpy(main_signal).to(dev)
    n_frames = 1 + (len(main_signal) - cfg.n_fft) // cfg.hop_length
    M = cfg.hop_length
    fb = torch.from_numpy(mel_filterbank(SR, cfg.n_fft, cfg.n_mels)).to(dev)
    window = torch.hann_window(cfg.n_fft, periodic=True, device=dev)

    def library():
        spec = torch.stft(yt, cfg.n_fft, cfg.hop_length, window=window, center=False,
                          return_complex=True)
        return torch.log(torch.clamp_min(fb @ spec.abs().square(), 1e-10))

    ms = cuda_ms(lambda: fused_log_mel(yt, cfg))
    plain = cuda_ms(lambda: fused_log_mel_plain(yt, cfg))
    lib_ms = cuda_ms(library)
    # The bound is the function's least work: a real FFT of n_fft points
    # (2.5 N log2 N), the power and the mel product per frame; the waveform
    # read once and the log-mels written once.
    n_bins = cfg.n_fft // 2 + 1
    flops = n_frames * (2.5 * cfg.n_fft * np.log2(cfg.n_fft) + 3 * n_bins
                        + 2 * n_bins * cfg.n_mels + cfg.n_mels)
    nbytes = 4 * (len(main_signal) + n_frames * cfg.n_mels)
    bnd, by = bound_ms(nbytes, flops)
    # The DIF formulation's own work (two real DFTs of M points as GEMMs, the
    # power and two mel GEMMs per frame; bases read once), for reference only.
    dif_flops = n_frames * (2 * M * 2 * (M + 1) + 3 * (M + 1) + 2 * (M + 1) * cfg.n_mels)
    dif_bytes = 4 * ((n_frames + 1) * M + 2 * M + 2 * M * (M + 1)
                     + (M + 1) * cfg.n_mels + n_frames * cfg.n_mels)
    dif_bnd, dif_by = bound_ms(dif_bytes, dif_flops)
    audio_s = len(main_signal) / SR
    print(f"[kernel A] main-path shape: {n_frames} frames ({audio_s:.1f} s padded): "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.stft+mel {lib_ms:.4f} ms; "
          f"bound {bnd:.4f} ms ({by}, rFFT+power+mel {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB); DIF-formulation bound {dif_bnd:.4f} ms ({dif_by}, "
          f"{dif_flops / 1e9:.2f} GFLOP, kernel at {dif_flops / ms / 1e9:.1f} TFLOP/s)")
    y240 = torch.from_numpy(tones(240.0, 4)).to(dev)
    cfg240 = dataclasses.replace(base, log_floor=1e-10)
    ms240 = cuda_ms(lambda: fused_log_mel(y240, cfg240))
    print(f"[kernel A] 240 s centered: kernel {ms240:.4f} ms -> "
          f"{240.0 / (ms240 / 1e3):,.0f} audio-sec/sec")
    return {"name": "fused_logmel", "route": "cuda",
            "source": "sed_crnn_torch/csrc/fused_logmel.cu",
            "replaces": "sed_crnn_tpu/ops/pallas/fused_logmel.py:173",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib_ms}


def phase_gru():
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import gru_scan, gru_scan_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    T, H = 256, 32
    worst = 0.0

    def inputs(B):
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
        return (t(rng.standard_normal((B, T, 3 * H))), t(0.3 * rng.standard_normal((H, 3 * H))),
                t(0.1 * rng.standard_normal(3 * H)), t(0.5 * rng.standard_normal((B, H))))

    for B in (1, 8, 128):
        xp, wh, bh, h0 = inputs(B)
        errs = []
        for reset_after in (False, True):
            for gate in ("sigmoid", "hard_sigmoid"):
                for reverse in (False, True):
                    args = (xp, wh, bh if reset_after else None, h0, reset_after, gate, reverse)
                    ys, hl = gru_scan(*args)
                    ys_p, hl_p = gru_scan_plain(*args)
                    torch.cuda.synchronize()
                    err = max(float((ys - ys_p).abs().max()), float((hl - hl_p).abs().max()))
                    check(err <= GRU_ATOL,
                          f"GRU B={B} reset_after={reset_after} {gate} reverse={reverse}: {err}")
                    errs.append(err)
        worst = max(worst, max(errs))
        print(f"[kernel B] B={B:3d}: 8 variants, max|diff| {max(errs):.3g}")

    # Times at the main path's shape: sednet streaming, B=1, reset_after=False.
    xp, wh, _, h0 = inputs(1)
    ms = cuda_ms(lambda: gru_scan(xp, wh, None, h0, False, "sigmoid", False), reps=50)
    plain = cuda_ms(lambda: gru_scan_plain(xp, wh, None, h0, False, "sigmoid", False), reps=5)
    cudnn = torch.nn.GRU(3 * H, H, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn_ms = cuda_ms(lambda: cudnn(xp, h0[None]), reps=50)
    flops = T * (2 * H * 3 * H + 12 * H)
    nbytes = 4 * (T * 3 * H + H * 3 * H + H + T * H + H)
    bnd, by = bound_ms(nbytes, flops)
    print(f"[kernel B] main-path shape B=1 T={T} H={H}: kernel {ms:.4f} ms "
          f"({ms / T * 1e3:.2f} us/step), plain {plain:.4f} ms, bound {bnd:.6f} ms ({by}); "
          f"cuDNN nn.GRU (reset_after=True, not the same function) {cudnn_ms:.4f} ms")
    return {"name": "gru_scan_fwd", "route": "cuda",
            "source": "sed_crnn_torch/csrc/gru_scan.cu",
            "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:94",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": None}


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
    from sed_crnn_torch.ops.kernels.gru_scan import gru_scan

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

    fused_log_mel.launches = 0
    gru_scan.launches = 0
    t0 = time.perf_counter()
    probs_i, events_i, _ = infer_file(wav, ckpt, preset, stats, device="cuda")
    probs_c, events_c, model_c, mel_c = composition("cuda")
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = {"fused_logmel": fused_log_mel.launches, "gru_scan_fwd": gru_scan.launches}

    n_frames = mel_c.shape[0]
    n_chunks = -(-n_frames // cfg.model.seq_len_in)
    streams = 2
    kernel_extracts = 1   # the composition's extract; infer_file's preset frontend is fft
    check(launches["fused_logmel"] == kernel_extracts,
          f"kernel A launches {launches['fused_logmel']} != {kernel_extracts} extract call")
    check(launches["gru_scan_fwd"] == streams * 4 * n_chunks,
          f"kernel B launches {launches['gru_scan_fwd']} != 4 x {n_chunks} chunks x {streams}")

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


def main() -> int:
    smi = phase_device()
    import torch

    from sed_crnn_torch.core.device import set_full_fp32

    set_full_fp32()
    phase_build()
    from sed_crnn_torch.core.config import FrontendConfig

    pcm = tones(120.0, 9, silent=[(50.0, 52.0)])
    kernel_a = phase_logmel(bucket_signal(pcm, FrontendConfig()))
    kernel_b = phase_gru()
    with tempfile.TemporaryDirectory() as workdir:
        launches, fe_kernel, model = phase_main(workdir, pcm)
    phase_throughput(fe_kernel, model, pcm)
    kernels = []
    for k in (kernel_a, kernel_b):
        kernels.append({"name": k["name"], "route": k["route"], "source": k["source"],
                        "replaces": k["replaces"], "launches": launches[k["name"]],
                        **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms")}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
