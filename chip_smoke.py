#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, feature-extraction,
evaluation, live-serving, stacked multi-seed training, checkpoint
migration, data- and seed-parallel and DCASE reproduction paths and its
tracing, debug and host-library tools on one GPU and check its kernels.

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
   path's shape beside the plain versions, ``torch.stft`` + mel and the
   bound, each also as torch.profiler device-busy time beside the host's
   issue time, and the 240 s frontend rate;
4. kernel B's forward (the GRU recurrence; the warp body ``csrc/gru_warp.cu``
   for H <= 32, the wide body ``csrc/gru_wide.cu`` above) against its plain
   version: T=256, H in {32, 16, 8} (warp) at B in {1, 8, 128} and H=64
   (wide) at B in {1, 8}, both conventions, both gates, both directions,
   non-zero h0, single directions and pair launches; atol 1e-5; at the
   serving shape (B=1, H=32) the warp body's time beside the wide body's
   (through the private launcher), one pair launch beside two single ones,
   the plain version, and
   ``torch.nn.GRU`` at reset_after=True (the one variant it computes),
   with torch.profiler device time and the host's issue time per call;
5. the main path at full width: ``sednet-dcase`` weights from a numpy seed
   in the JAX layout, written as a JAX-format checkpoint, and a 120 s 44.1 kHz
   wav with tone bursts, served by ``apps.infer.infer_file`` and by the same
   composition with the ``"kernel"`` frontend, on the card and on the CPU
   (plain versions); logits within 1e-3, probabilities within 1e-3, events
   equal, and both kernels' launch counts read around this phase alone
   (kernel A once per kernel-frontend ``extract``, on the chunked route and
   never on the cluster body; kernel B one pair launch per BiGRU layer per
   chunk, all on the warp body) and no GRU plain version run on a CUDA
   tensor;
6. throughput in ``bench.py``'s units (audio-seconds per second) and a
   torch.profiler breakdown of streaming;
7. kernel B train (the residual forward, the backward chain, the dwh
   reduction and the fixed-order partial sum) against their plain versions
   at the widths and batches of phase 4, single directions and pair
   launches, non-zero h0, dys and dhl; ys/res atol 1e-5, gradients within
   1e-4 of each one's largest magnitude, the reduction also against
   ``gru_dwh_plain`` on the kernel's own dxp; dwh bitwise equal across two
   runs; times at B=128 beside the wide body, two single launches, the
   plain versions,
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
   train step, one pair forward per sweep step), none on the wide body;
10. training throughput: train-step time at batch 128, the training rate in
    audio-seconds per second, and a torch.profiler breakdown of one step;
    then the port's tools ([tools], sednet-dcase full width):
    ``utils/tracing.py::profile_trace`` around a kernel-frontend ``extract``
    of a 240 s signal, one train step at batch 128 and one B=1 serving chunk,
    each in its ``annotate`` region; the written Chrome trace holds the three
    annotations and, per kind, as many kernel A and kernel B device events
    (by symbol) as the wrappers counted launches, with non-zero device time,
    printed beside CUDA events on the same shapes; ``StepClock`` over 10
    train steps beside the training rate; ``run_fold(debug=True)`` for one
    epoch on phase 9's fold with the GRU launches of ``debug=False``, and
    with one NaN planted in a window of the first training batch raising
    ``NonFiniteError`` at fold 1 epoch 1; the C++ host library built with
    g++: ``log_mel_native`` within 5e-4 of kernel A's chunked route on the
    240 s signal (-inf pattern equal), ``StreamingFramer`` bitwise
    ``PythonFramer`` on random packets of the 120 s signal,
    ``wav_read_mono_native`` within 1e-6 of ``data/wavio``; the TF
    SavedModel export is held on the CPU only (no tensorflow here).
11. kernel A's framed route (the TPU `_kernel_dif`: n_fft 1024 and 4096
    at hop 1024, and a frame-matrix input) and its exact route (the TPU
    `_kernel_exact`: mode "exact" at n_fft 2048 on the FFT body) against
    their DIF / direct plain versions on the signals of phase 3 and a
    1,500-sample one, with and without a floor (-inf pattern equal, 5e-4 at
    finite entries), the FFT body also against its own plain version and
    twice, bitwise; their times at the binmul path's shapes (warm and cold
    L2) beside the plain versions, ``torch.stft`` + mel and the bounds, and
    as torch.profiler device-busy time beside the host's issue time (the
    FFT body's at n_fft 1024 printed on its own); the exact route driven
    once by ``fused_log_mel(mode="exact")`` at n_fft 2048;
    then ([kernel A mixed]) the mixed-radix body ``csrc/logmel_mixed.cu``
    at n_fft 1034 / hop 517 (exact route, 11 and a matrix stage of 47),
    1764 / 882 (chunked, direct), 3072 / 1024 (framed, direct), 1001 / 500
    (exact, 7, 11, 13), 1102 / 551 (matrix stages 19, 29), 12865 / 6432
    (matrix stages), 23042 / 11521 (a matrix stage of 41, a Rader stage of
    281), the Rader plans 12867 / 6433 (3, Rader 4289) and 23054 / 11527
    (Rader 11527), 2066 / 1033 (Rader 1033 alone, its gather folded into
    the load), 1103 / 551 (Rader 1103 over 2 x 19 x 29) and 12895 /
    6447 (5, Rader 2579 with Rader 1289 nested in its inner transforms) on
    those signals, with and without a floor: against `mixed_log_mel_plain`
    (bitwise, or within MATRIX_ATOL with matrix stages), two runs bitwise equal, within 5e-4 of
    the DIF / direct plain version (torch's FFT + mel above 4096) with the
    -inf pattern equal, and on a frame matrix; its times on 150 s of padded
    audio (warm and cold L2, device and host) beside ``torch.stft`` + mel,
    its Bluestein plan in turns, both plain versions and the bound; for
    each plan with matrix stages, which form each ran (one launch, counted
    by form: ``wgmma`` where `wgmma_radix` names the radix, else
    ``mma.sync``), the kernel in turns with ``torch.stft`` + mel, and the
    matrix phase (two cut builds of the body, started after the kernels'
    build) beside its bound; every plan in turns at the sizes that were
    Bluestein; ``frontend.extract`` at n_fft 1034 with exactly one mixed
    launch and no cluster launch;
    then ([kernel A cluster]) the cluster body ``csrc/logmel_cluster.cu``
    (every n_fft beyond one block's shared memory): the clusters the card
    holds at 227 KB a CTA for every size to 16; n_fft 25734 / 12867
    (3, Rader 4289, exact route), 25738 / 12869 (17, Rader 757), 31290 / 15645
    (a matrix stage of 149), 44100 / 22050 and 48000 / 24000 (direct, chunked), 88200 / 44100 (3 CTAs)
    21599 / 10799 (Bluestein, exact route) and 141001 / 70500 (7, Rader
    20143 over 2 x 3 x 3 x 3 x 373, exact route) on those signals, with and
    without a floor: against
    `mixed_log_mel_plain` (bitwise, or within MATRIX_ATOL), two runs
    bitwise equal, within 5e-4 of torch's FFT + mel with the -inf pattern
    equal; the same bits at other cluster sizes (25734 at 2-16 CTAs, 25738
    at 2-4, 44100 at 2, 3, 4, 7, 88200 at 3-12, 141001 at 11, 12 and 13:
    one B slab a CTA, two; its default is 16) and the mixed body's shapes
    (register, matrix and Rader plans) forced onto it at 2, 3, 4 and 8 CTAs, bitwise
    the mixed body's; times on 150 s of padded audio (warm and cold L2,
    device and host) beside ``torch.stft`` + mel, the plain version, the
    bound and every other plan in turns, the matrix plans' forms, turns
    with the library and matrix phases as for the mixed body (141001's 373
    on ``wgmma``), and 88200 at 3 and 4 CTAs and 141000 at 7 and 8 in
    turns; ``frontend.extract`` of the 120 s file at
    25734 (exact) and 44100 (chunked), exactly one cluster launch each;
12. the feature path: a synthetic DCASE 2017 street layout (12 binaural
    120 s wavs at 44.1 kHz and one 20 s wav at 48 kHz, folds 1 and 2) through
    ``apps.feature.main --binmul --backend kernel --device cuda``: exactly 2
    chunked and 4 framed launches per file, a cached rerun that launches
    nothing and no launch lands on the cluster body, per-file features within
    5e-4 of ``--backend fft`` on the card,
    the packs' shapes and standardized means; the feature rate (host clock),
    a profile and the host's parts of one file; then ``--multires 1764
    3072 --backend kernel`` into its own cache: exactly 4 framed launches
    per file, all on the mixed body, none on the cluster body, features within
    5e-4 of ``--backend fft``;
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
    per non-empty framer block, every socket and join bounded); every
    framer of the live chain the C++ ``StreamingFramer``, closed with its
    handle freed, and its rows bitwise the offline rows; the serving
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
    and x 4, sednet-dcase x 2, stacked against sequential steps);
18. kernel B above the warp body ([kernel B wide]): the wide body
    (``csrc/gru_wide.cu``, registers to H=128), the cluster body
    (``csrc/gru_cluster.cu``, 128 < H <= 512) and the grid body
    (``csrc/gru_grid.cu``, H > 512): pair launches against the plain
    versions at H in WIDE_WIDTHS (33 .. 128 in registers, 129, 256 and 512
    on the cluster body, 520, 768 and 1024 on the grid body with resident
    weights, 1536 and 2048 streamed), B in {1, 8, 128}, T=64, both
    conventions, both gates, both directions, one launch of each kernel on
    the body `gru_body` names, each shape's cluster or grid plan (held
    against the Python mirror; the CTAs the card holds at once), the
    backward bitwise run to run, and stacked (S=5) with seed 0 bitwise the
    unstacked pair on every body (520 and 1024 on the grid body); the grid
    body's bits at forced K (40 and 66 CTAs a direction) and a pair of more
    CTAs than half the SMs refused; the grid body at 256 units a CTA (a
    pair at H=8449, B=2, T=4) and at two blocks of 256 units a CTA (a pair
    at H=16897, B=1, T=4) against the plain versions; then kernel B's dwh
    reduction ([kernel B dwh]: ``csrc/gru_dwh.cu``, 3xTF32 on the tensor
    cores, at H in DWH_TIMED, a pair at B=128, T=256, both conventions,
    against ``gru_dwh_plain``, bitwise run to run, in turns with one
    ``torch.matmul`` of the same product and, given ``--dwh-parent PATH``,
    an older ``gru_wide.cu``'s FMA reduction; at H=32 in turns with the warp
    body's); at H=128 with wh up to 0.3 N(0, 1),
    against float64, beside the float32 plain version and the same kernel
    built with exact gates; the wide body's times at H in {64, 128}
    (forward at B=1, residual forward and backward at B=128, T=256) beside
    the plain versions, the bounds and ``torch.nn.GRU``; the cluster body's
    at H=256 and the grid body's at H=1024 (and 2048 at B=128) in turns with
    a bidirectional ``torch.nn.GRU`` (a pair's forward at B=1, residual
    forward and backward with the chain / dwh / sum split at B=128); then
    the full-width paths: ``run_fold`` (2 epochs) and a card-vs-CPU train
    step of ``sednet-dcase`` with ``gru_hidden=(128, 128)``, that checkpoint
    through ``stream_logits`` (40 chunks, B=1) and ``forward_probabilities``
    (B=256) against the CPU, and ``timepooled-v2`` with ``gru_hidden=(64,
    64)``: one 5-seed ``MultiSeedTrainer`` step, the stacked kernels at its
    shape, ``run_experiment_multiseed`` stacked against sequential, and the
    two modes' per-step losses from one init (bf16 and float32 trunks, the
    preset's GRUs and these); on the cluster body (``gru_hidden=(256,
    256)``) and on the grid body (``(1024, 1024)``) a card-vs-CPU train step
    of ``sednet-dcase`` and that model, exported, serving the 120 s wav
    through ``infer_file_artifact``, ``stream_logits`` (B=1) and
    ``forward_probabilities`` (its 20 whole windows) against the CPU; exact
    launch counts by body on every path and no plain version on the card;
19. checkpoint migration ([import], after [serve]): the reference's v1 and
    v2 classes (`reference_model`: full width, weights from
    ``torch.Generator`` seeds, primed BatchNorm statistics) saved as a raw
    ``state_dict`` and as a Lightning ``.ckpt`` with pickled
    hyper-parameters, imported by ``apps.import_torch.main``; at B=128 the
    reference class (cuDNN ``nn.GRU``) against the port's `CRNN` from the
    imported npz on the card within 1e-4 (v2 at float32; the preset's bf16
    trunk for its launches), one pair launch per BiGRU layer; the imported
    v1 served as in phase 5 (card vs CPU, exact launch counts);
    ``run_fold(resume_from=...)`` on it for one epoch of a few steps at full
    width, exact launch counts; ``apps.export_weights.main`` back to ``.pt``
    (naming v1 and v2), reloaded with ``strict=True`` into fresh reference
    classes, bitwise the originals; the whole forwards' times and kernel B's
    pair at (B 128, T 8, H 32, reset_after=True) beside one bidirectional
    ``torch.nn.GRU`` layer, the plain version and the bound;
20. data parallelism, the seed mesh and the DCASE reproduction script
    ([parallel], after [import]), ``sednet-dcase`` at full width, dropout
    0: `run_fold` with ``data_parallel_factory(make_mesh(1))`` over NCCL
    and ``apps.train --data-parallel 1 --synthetic`` (batch 128, 2 epochs
    of 2 steps, full-split sweeps) bitwise plain `run_fold` under
    deterministic cuDNN (histories, best and last checkpoints), exact
    launch counts, no GRU plain version on the card; the step at batch 128
    against the plain step in turns, its 7 all_reduces alone, a profile;
    two ranks spawned on ``cuda:0`` over gloo: one step of a fixed global
    batch of 128 (halves of 64) against one device's step on the same
    arithmetic (convolutions on the halves, BatchNorm's moments as the mean
    of the halves'; gradients within 1e-4 of each leaf's largest) and on
    the whole batch (4e-4: the halves' BatchNorm moments alone move that
    step by 1.6e-4; BatchNorm statistics and parameters 1e-5 in both), the
    same step with BatchNorm's reduction hidden from autograd over 100
    times that band, parameters bitwise equal on both ranks after 3 steps,
    the sweep equal to one device's, exact launch counts, per-rank step and
    collective times and bytes; ``apps.evaluate --data-parallel`` on
    [evaluate]'s split and phase 9's best checkpoint, report and event
    lists byte-identical to the unsharded CLI's, exact launch counts;
    ``reproduce_dcase.main`` as it ships (``--folds 1 2 --runs 2
    --max-epochs 2 --seed-parallel 1``) on a synthetic 13-file DCASE layout:
    stage 1 on the feature CLI's default fft frontend (no kernel A launch,
    as the JAX script), no plot and a notice where matplotlib is missing,
    kernel B's stacked launches exact, the protocol's ER/F1, std and
    per-seed values bitwise a direct stacked `run_experiment_multiseed` on
    the same cache under deterministic cuDNN, the stages' wall times.

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


def reference_model(version: str, seed: int, conv: int | None = None,
                    hidden: tuple | None = None):
    """A plain-torch reconstruction of one of the reference's CRNN classes,
    on the CPU in eval mode, over (B, 1, 40, 64) input: ``"v1"``, the
    TimePooledCRNN of `sed.py:82-112` (``convs``/``bns`` ModuleLists of 3
    conv + BN blocks, one 2-layer bidirectional ``gru``, ``fc``), or ``"v2"``,
    `crnn_lightning.py:41-73` (a ``conv_stack`` Sequential of [Conv2d, BN,
    ReLU, MaxPool] per block and a trailing Dropout, ``gru1``/``gru2``,
    ``d1``/``d2``), so that its ``state_dict`` has the reference's keys in
    their order. Widths default to the presets' (v1: conv 128, GRU 32; v2:
    conv 16, GRUs 16 and 8). Every parameter is drawn from a
    ``torch.Generator`` seeded with ``seed``, fan-in scaled, the last layer
    x4 so that few probabilities sit near the 0.5 threshold; the BatchNorm
    statistics are primed by three train-mode batches from the same
    generator."""
    import torch
    from torch import nn

    n_mels, pool = 40, 2
    if version == "v1":
        c = conv or 128
        h = hidden or (32, 32)

        class ReferenceV1(nn.Module):
            def __init__(self):
                super().__init__()
                chans = [1, c, c, c]
                self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], 3, padding=1)
                                           for i in range(3))
                self.bns = nn.ModuleList(nn.BatchNorm2d(c) for _ in range(3))
                self.gru = nn.GRU(c * n_mels, h[0], num_layers=2, batch_first=True,
                                  bidirectional=True)
                self.fc = nn.Linear(2 * h[0], 1)

            def forward(self, x):
                for conv_, bn in zip(self.convs, self.bns):
                    x = nn.functional.max_pool2d(torch.relu(bn(conv_(x))), (1, pool))
                x = x.permute(0, 3, 1, 2)
                x, _ = self.gru(x.reshape(x.shape[0], x.shape[1], -1))
                return self.fc(x)

        model, last = ReferenceV1(), "fc.weight"
    elif version == "v2":
        c = conv or 16
        h = hidden or (16, 8)

        class ReferenceV2(nn.Module):
            def __init__(self):
                super().__init__()
                self.conv_stack = nn.Sequential()
                in_c = 1
                for _ in range(3):
                    self.conv_stack.append(nn.Conv2d(in_c, c, 3, padding=1))
                    self.conv_stack.append(nn.BatchNorm2d(c))
                    self.conv_stack.append(nn.ReLU())
                    self.conv_stack.append(nn.MaxPool2d((1, pool)))
                    in_c = c
                self.conv_stack.append(nn.Dropout(0.4))
                self.gru1 = nn.GRU(c * n_mels, h[0], batch_first=True, bidirectional=True)
                self.gru2 = nn.GRU(2 * h[0], h[1], batch_first=True, bidirectional=True)
                self.d1 = nn.Linear(2 * h[1], 8)
                self.d2 = nn.Linear(8, 1)

            def forward(self, x):
                x = self.conv_stack(x).permute(0, 3, 1, 2)
                x, _ = self.gru1(x.reshape(x.shape[0], x.shape[1], -1))
                x, _ = self.gru2(x)
                return self.d2(torch.relu(self.d1(x)))

        model, last = ReferenceV2(), "d2.weight"
    else:
        raise ValueError(f"unknown reference version {version!r}")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.randn(p.shape, generator=g)
            if p.ndim > 1:                       # weights: 1 / sqrt(fan-in)
                p.copy_(draw / p[0].numel() ** 0.5 * (4.0 if name == last else 1.0))
            elif name.endswith("weight"):        # BatchNorm scales
                p.copy_(1.0 + 0.1 * draw)
            else:
                p.copy_(0.1 * draw)
        model.train()
        for _ in range(3):
            model(torch.randn((8, 1, n_mels, 64), generator=g))
    return model.eval()


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
        fft_log_mel_plain,
        fused_log_mel,
        fused_log_mel_plain,
    )

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
    library = _library_logmel(yt, cfg)
    kernel = lambda: fused_log_mel(yt, cfg)  # noqa: E731
    ms = cuda_ms(kernel)
    cold = cuda_ms_cold(kernel)
    fft_plain = cuda_ms(lambda: fft_log_mel_plain(yt, cfg), reps=5)
    plain = cuda_ms(lambda: fused_log_mel_plain(yt, cfg), reps=5)
    lib_ms = cuda_ms(library)
    bnd, by, flops, nbytes = logmel_bound(len(main_signal), n_frames, cfg)
    audio_s = len(main_signal) / SR
    print(f"[kernel A] main-path shape (chunked, n_fft 2048 hop 1024): {n_frames} frames "
          f"({audio_s:.1f} s padded): kernel {ms:.4f} ms warm L2, {cold:.4f} ms cold L2, "
          f"plain (DIF) {plain:.4f} ms, torch.stft+mel {lib_ms:.4f} ms; bound {bnd:.4f} ms "
          f"({by}, rFFT+power+sparse mel {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
          f"kernel at {bnd / ms:.3f} of its bound; the fft body's plain emulation "
          f"{fft_plain:.4f} ms")
    print(f"[kernel A] main-path shape, {split_line(bnd, kernel=kernel, library=library)}")
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
            "bound_by": by, "library_ms": lib_ms}


def _gru_inputs(rng, dev, B: int, H: int, train: bool = False, T: int = GRU_T,
                wh_std: float = 0.3):
    """xp, wh (``wh_std`` N(0, 1)), bh, h0 (and dys, dhl for ``train``) on
    the card."""
    import torch

    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    out = (t(rng.standard_normal((B, T, 3 * H))), t(wh_std * rng.standard_normal((H, 3 * H))),
           t(0.1 * rng.standard_normal(3 * H)), t(0.5 * rng.standard_normal((B, H))))
    if train:
        out += (t(rng.standard_normal((B, T, H))), t(rng.standard_normal((B, H))))
    return out


def _pair_of(sets, i, reset_after=True):
    """Argument i of both directions' operand sets, as a pair (None for bh
    when not ``reset_after``)."""
    return tuple(None if (i == 2 and not reset_after) else s[i] for s in sets)


def _library_gru(wh, bh, bidirectional: bool = False):
    """`torch.nn.GRU` computing the ``reset_after=True`` sigmoid recurrence
    of pre-projected inputs: weight_ih = I, bias_ih = 0, weight_hh = wh^T,
    bias_hh = bh (gate order r, z, n in both). ``bidirectional``: wh and bh
    are pairs, the second for the reverse direction, over one input."""
    import torch

    whs, bhs = (wh, bh) if bidirectional else ((wh,), (bh,))
    H, dev = whs[0].shape[0], whs[0].device
    g = torch.nn.GRU(3 * H, H, batch_first=True, bidirectional=bidirectional).to(dev)
    with torch.no_grad():
        for sfx, w, b in zip(("", "_reverse"), whs, bhs):
            getattr(g, f"weight_ih_l0{sfx}").copy_(torch.eye(3 * H, device=dev))
            getattr(g, f"bias_ih_l0{sfx}").zero_()
            getattr(g, f"weight_hh_l0{sfx}").copy_(w.T)
            getattr(g, f"bias_hh_l0{sfx}").copy_(b)
    return g


def phase_gru():
    """Kernel B's forward: the warp body (H <= 32) at H in {32, 16, 8} and
    the wide body at H=64 against the plain version, single directions and
    pair launches; times at the serving shape beside the wide body (through
    the private launcher), two single launches, the plain version and
    `torch.nn.GRU`."""
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
    worst = {"warp": 0.0, "wide": 0.0}
    _reset_gru_counts()
    n_warp = n_wide = 0
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
            launches = 8 + 4
            n_warp += launches * (body == "warp")
            n_wide += launches * (body == "wide")
            print(f"[kernel B] {body} body H={H:2d} B={B:3d}: 8 variants and 4 pair launches "
                  f"against the plain version, max|diff| {err:.3g}")
    counts = _gru_counts()
    check(counts["gru_scan_fwd"] == n_warp + n_wide and counts["gru_wide"] == n_wide,
          f"phase 4 launches {counts}: {n_warp} warp, {n_wide} wide expected")

    # Times at the main path's shape: sednet streaming, B=1, reset_after=False.
    H, conf = 32, (False, "sigmoid")
    (xp, wh, bh, h0), (xp2, wh2, bh2, h02) = (_gru_inputs(rng, dev, 1, H) for _ in range(2))
    single = lambda: gru_scan(xp, wh, None, h0, *conf, False)  # noqa: E731
    wide = lambda: _fwd([xp], [wh], [None], [h0], [False], *conf, False, "wide")  # noqa: E731
    pair = lambda: gru_scan_pair((xp, xp2), (wh, wh2), (None, None), (h0, h02), *conf)  # noqa: E731
    two = lambda: (single(), gru_scan(xp2, wh2, None, h02, *conf, True))  # noqa: E731
    want = gru_scan_plain(xp, wh, None, h0, *conf, False)
    (wide_out,), _ = wide()
    wide_err = max(_maxdiff(wide_out[0], want[0]), _maxdiff(wide_out[2], want[1]))
    check(wide_err <= GRU_ATOL, f"wide body at the serving shape: {wide_err}")
    worst["wide"] = max(worst["wide"], wide_err)
    ms = cuda_ms(single, reps=50)
    wide_ms = cuda_ms(wide, reps=50)
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
          f"({ms / T * 1e3:.3f} us/step), wide body {wide_ms:.4f} ms (vs plain {wide_err:.3g}), "
          f"plain {plain:.4f} ms, bound {bnd:.6f} ms ({by}); both directions: one pair launch "
          f"{pair_ms:.4f} ms, two single launches {two_ms:.4f} ms")
    split = {}
    print(f"[kernel B] serving shape, "
          f"{split_line(bnd, split, kernel=single, wide=wide, pair=pair)}")
    print(f"[kernel B] reset_after=True sigmoid at B=1: warp body {ra_ms:.4f} ms, torch.nn.GRU "
          f"(weight_ih = I, weight_hh = wh^T; vs plain {lib_err:.3g}) {lib_ms:.4f} ms")
    entry = {"name": "gru_scan_fwd", "route": "cuda", "source": "sed_crnn_torch/csrc/gru_warp.cu",
             "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:94",
             "max_abs_err": worst["warp"], "ms": ms, "plain_ms": plain, "bound_ms": bnd,
             "bound_by": by, "library_ms": lib_ms, "library_variant": LIBRARY_VARIANT,
             "variant_ms": ra_ms, "device_ms": split["kernel"][0], "host_ms": split["kernel"][1],
             "wide_body_ms": wide_ms}
    return entry, worst["wide"]


def _serve_card_and_cpu(tag: str, wav: str, ckpt: str, preset: str, pcm: np.ndarray):
    """Serve ``wav`` (``pcm`` at 44.1 kHz) with checkpoint ``ckpt`` through
    `apps.infer.infer_file` (the preset's fft frontend) and through the same
    composition with the ``"kernel"`` frontend, on the card and on the CPU:
    logits within LOGIT_ATOL, probabilities within PROB_ATOL, events equal;
    the card's launches read around its two runs alone: kernel A once (the
    composition's extract, chunked route, not on the cluster body), kernel B
    one pair launch per BiGRU layer per chunk per stream, on the warp body,
    and no GRU plain version on a CUDA tensor.
    -> (launches, the kernel frontend config, the card's model)."""
    import torch

    from sed_crnn_torch.apps.infer import infer_file, load_model
    from sed_crnn_torch.core.checkpoint import load_checkpoint
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.data.rasterize import events_from_labels
    from sed_crnn_torch.models.streaming import stream_logits, stream_probabilities
    from sed_crnn_torch.ops import frontend
    from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel

    cfg = get_preset(preset)
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
    check(logmel == {"chunked": kernel_extracts, "framed": 0, "exact": 0, "mixed": 0,
                     "cluster": 0},
          f"{tag} kernel A launches {logmel} != {kernel_extracts} chunked extract call, no "
          f"cluster body")
    # Kernel B: one pair launch per BiGRU layer per chunk, on the warp body.
    n_layers = len(cfg.model.gru_hidden)
    want = _gru_path_counts(streams * n_layers * n_chunks, 0)
    check(gru == want, f"{tag} kernel B launches {gru} != {want} ({n_layers} pairs x "
          f"{n_chunks} chunks x {streams} streams)")
    check(not plain_on_card, f"{tag} a GRU plain version ran on the card: {plain_on_card}")

    t0 = time.perf_counter()
    probs_i_cpu, events_i_cpu, _ = infer_file(wav, ckpt, preset, stats, device="cpu")
    probs_c_cpu, events_c_cpu, model_c_cpu, mel_c_cpu = composition("cpu")
    cpu_s = time.perf_counter() - t0

    # Logits before the sigmoid, which would hide a small error in the trunk
    # or the GRU where probabilities saturate.
    logits = stream_logits(model_c, mel_c).cpu()
    logits_cpu = stream_logits(model_c_cpu, mel_c_cpu)
    logit_err = float((logits - logits_cpu).abs().max())
    check(bool(torch.isfinite(logits).all()), f"{tag} non-finite logits on the card")
    check(logit_err <= LOGIT_ATOL,
          f"{tag} card vs CPU logits {logit_err} > {LOGIT_ATOL}")
    print(f"{tag} {preset} kernel composition logits {tuple(logits.shape)}: card vs CPU "
          f"max|diff| {logit_err:.3g} (|logit| up to {float(logits.abs().max()):.3g}, "
          f"nearest the threshold {float(logits[: n_frames // pool].abs().min()):.3g})")
    for name, g, c, eg, ec in (("infer_file", probs_i, probs_i_cpu, events_i, events_i_cpu),
                               ("kernel composition", probs_c, probs_c_cpu, events_c,
                                events_c_cpu)):
        check(g.shape == c.shape == (n_frames // pool, cfg.model.n_classes),
              f"{tag} {name} shape {g.shape}")
        check(bool(np.isfinite(g).all()), f"{tag} {name}: non-finite probabilities")
        err = float(np.abs(g - c).max())
        check(err <= PROB_ATOL, f"{tag} {name}: card vs CPU probabilities {err} > {PROB_ATOL}")
        check(eg == ec, f"{tag} {name}: card and CPU events differ")
        print(f"{tag} {name}: probs {g.shape}, card vs CPU max|diff| {err:.3g}, "
              f"{len(eg)} events equal, mean prob {float(g.mean()):.3f}")
    check(len(events_c) > 0, f"{tag} the 120 s file decodes into events")
    print(f"{tag} launches in the serving path: {launches} ({n_chunks} chunks per stream, "
          f"{streams} streams); card {gpu_s:.2f} s, CPU {cpu_s:.2f} s")
    return launches, fe_kernel, model_c


def phase_main(workdir: str, pcm: np.ndarray):
    from sed_crnn_torch.core.checkpoint import save_checkpoint
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.data.wavio import write_wav

    preset = "sednet-dcase"
    params, state = model_tree(get_preset(preset).model, seed=11)
    ckpt = save_checkpoint(os.path.join(workdir, "sednet.npz"),
                           {"params": params, "model_state": state}, {"epoch": 0})
    wav = os.path.join(workdir, "tones_120s.wav")
    write_wav(wav, pcm, SR)
    return _serve_card_and_cpu("[main]", wav, ckpt, preset, pcm)


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


def _rel_err(got, want, tag: str, names=("dxp", "dwh", "dbh", "dh0"),
             floor: float = 0.0) -> float:
    """max|got - want| / max|want| of each pair, each held to GRAD_RTOL of
    max(max|want|, ``floor``); returns the largest."""
    worst = 0.0
    for name, g, w in zip(names, got, want):
        e, scale = _maxdiff(g, w), float(w.abs().max())
        check(e <= GRAD_RTOL * max(scale, floor), f"{tag} {name}: {e} > {GRAD_RTOL} x {scale}")
        worst = max(worst, e / scale if scale else 0.0)
    return worst


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


def phase_gru_train():
    """Kernel B's residual forward, backward and dwh reduction: the warp body
    at H in {32, 16, 8} and the wide body at H=64 against their plain
    versions, single directions and pair launches; times at the training
    shape (B=128, T=256, H=32) beside the wide body (through the private
    launchers), two single launches, the plain versions and
    `torch.nn.GRU`."""
    import torch

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
    worst = {b: {"fwd": 0.0, "bwd": 0.0, "dwh": 0.0} for b in ("warp", "wide")}

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
                        rels.append(_rel_err(got_b[k], want_b[k], f"GRU bwd H={H} B={B} {conf}"))
                        # The reduction against its reference on the kernel's own dxp.
                        dwh, dbh = gru_dwh_plain(ys, res, h0, got_b[k][0], reset_after, reverse)
                        dwh_rels.append(_rel_err((dwh, dbh), got_b[k][1:3],
                                                 f"GRU dwh H={H} B={B} {conf}", ("dwh", "dbh")))
                    args = [_pair_of(sets, i, reset_after) for i in range(4)]
                    pair = gru_scan_pair_fwd_res(*args, reset_after, gate)
                    pair_b = gru_scan_pair_bwd(
                        tuple(p[0] for p in pair), tuple(p[1] for p in pair), args[1], args[3],
                        _pair_of(sets, 4), _pair_of(sets, 5), reset_after, gate)
                    torch.cuda.synchronize()
                    for k in (0, 1):
                        fwd_errs.append(max(_maxdiff(g, w) for g, w in zip(pair[k], want_f[k])))
                        rels.append(_rel_err(pair_b[k], want_b[k], f"GRU pair bwd H={H} B={B}"))
            err = max(fwd_errs)
            check(err <= GRU_ATOL, f"GRU fwd_res {body} body H={H} B={B}: {err}")
            w = worst[body]
            w["fwd"], w["bwd"] = max(w["fwd"], err), max(w["bwd"], max(rels))
            w["dwh"] = max(w["dwh"], max(dwh_rels))
            print(f"[kernel B train] {body} body H={H:2d} B={B:3d}: 8 variants and 4 pair launches, "
                  f"fwd_res max|diff| {err:.3g}, backward max|diff| / max|grad| {max(rels):.3g}, "
                  f"dwh/dbh vs gru_dwh_plain on the kernel's dxp {max(dwh_rels):.3g}")

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
    wide_fwd = lambda: _fwd([xp], [wh], [None], [h0], [False], False, "sigmoid", True, "wide")  # noqa: E731
    wide_bwd = lambda: _bwd([ys], [res], [wh], [h0], [dys], [dhl], [False], False, "sigmoid",  # noqa: E731
                            "wide")
    (wf,), _ = wide_fwd()
    (wb,) = wide_bwd()
    want_f = gru_scan_fwd_res_plain(xp, wh, None, h0, *conf)
    wide_err = max(_maxdiff(g, w) for g, w in zip(wf, want_f))
    check(wide_err <= GRU_ATOL, f"wide fwd_res at the training shape: {wide_err}")
    wide_rel = _rel_err(wb, gru_scan_bwd_plain(ys, res, wh, h0, dys, dhl, *conf),
                        "wide bwd at the training shape")
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
    wide_fwd_ms, wide_bwd_ms = cuda_ms(wide_fwd, reps=20), cuda_ms(wide_bwd, reps=20)
    pair_fwd_ms, two_fwd_ms = cuda_ms(pair_fwd, reps=50), cuda_ms(two_fwd, reps=50)
    pair_bwd_ms, two_bwd_ms = cuda_ms(pair_bwd, reps=50), cuda_ms(two_bwd, reps=50)
    fwd_plain = cuda_ms(lambda: gru_scan_fwd_res_plain(xp, wh, None, h0, *conf), reps=3, warmup=1)
    bwd_plain = cuda_ms(lambda: gru_scan_bwd_plain(ys, res, wh, h0, dys, dhl, *conf),
                        reps=3, warmup=1)
    dwh_plain_ms = cuda_ms(dwh_plain_fn, reps=20)
    split = _by_kernel(bwd)
    wide_split = _by_kernel(wide_bwd)
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
          f"({fwd_ms / T * 1e3:.3f} us/step), wide body {wide_fwd_ms:.4f} ms (vs plain "
          f"{wide_err:.3g}), plain {fwd_plain:.2f} ms, bound {fb:.5f} ms ({fby}, "
          f"{fwd_bytes / 1e6:.1f} MB); both directions: one pair launch {pair_fwd_ms:.4f} ms, "
          f"two single launches {two_fwd_ms:.4f} ms")
    print(f"[kernel B train] backward (chain + dwh reduction + partial sum) warp body "
          f"{bwd_ms:.4f} ms ({bwd_ms / T * 1e3:.3f} us/step), wide body {wide_bwd_ms:.4f} ms "
          f"(vs plain {wide_rel:.3g} of max|grad|), plain {bwd_plain:.2f} ms, bound {bb:.5f} ms "
          f"({bby}, {bwd_bytes / 1e6:.1f} MB); both directions: one pair {pair_bwd_ms:.4f} ms, "
          f"two singles {two_bwd_ms:.4f} ms; dwh bitwise equal across runs")
    print("[kernel B train] backward device ms per call by kernel (torch.profiler): warp body "
          + ", ".join(f"{k[:40]} {v:.4f}" for k, v in split.items()) + "; wide body "
          + ", ".join(f"{k[:40]} {v:.4f}" for k, v in wide_split.items()))
    print(f"[kernel B train] dwh reduction + partial sum {dwh_ms:.4f} ms device, "
          f"gru_dwh_plain {dwh_plain_ms:.4f} ms, bound {db:.5f} ms ({dby}, "
          f"{dwh_bytes / 1e6:.1f} MB)")
    bwd_split, fwd_split = {}, {}
    print(f"[kernel B train] "
          f"{split_line(bb, bwd_split, kernel=bwd, wide=wide_bwd, pair=pair_bwd)}")
    print(f"[kernel B train] fwd_res "
          f"{split_line(fb, fwd_split, kernel=fwd, wide=wide_fwd, pair=pair_fwd)}")

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
    ), {"fwd": max(worst["wide"]["fwd"], wide_err), "bwd": max(worst["wide"]["bwd"], wide_rel),
        "dwh": worst["wide"]["dwh"], "train_fwd_ms_at_32": wide_fwd_ms,
        "train_bwd_ms_at_32": wide_bwd_ms}


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
            "gru_dwh_mma": gru_scan_bwd.mma_dwh_launches,
            "gru_dwh_wgmma": gru_scan_bwd.wgmma_dwh_launches,
            "gru_wide": gru_scan.wide_launches, "gru_cluster": gru_scan.cluster_launches,
            "gru_grid": gru_scan.grid_launches}


def _reset_gru_counts():
    from sed_crnn_torch.ops.kernels.gru_scan import gru_scan, gru_scan_bwd, gru_scan_fwd_res

    gru_scan.launches = gru_scan_fwd_res.launches = gru_scan.wide_launches = 0
    gru_scan.cluster_launches = gru_scan.grid_launches = 0
    gru_scan_bwd.launches = gru_scan_bwd.dwh_launches = gru_scan_bwd.sum_launches = 0
    gru_scan_bwd.mma_dwh_launches = gru_scan_bwd.wgmma_dwh_launches = 0


def _gru_path_counts(fwd: int, steps: int, body: str = "warp", hidden=()) -> dict:
    """Exact GRU launch counts of a path with ``fwd`` no-grad BiGRU layer
    calls and ``steps`` train-step BiGRU layer calls: one pair launch of
    each kernel per layer call, all on one body: the warp, wide, cluster or
    grid body (the last three's recurrences, the forward, residual forward
    and backward chain, counted in ``gru_wide`` / ``gru_cluster`` /
    ``gru_grid``, and their dwh reductions, csrc/gru_dwh.cu's, in
    ``gru_dwh_mma``; those of its wgmma body, the layers of ``hidden`` whose
    width `dwh_body` sends there, also in ``gru_dwh_wgmma``)."""
    from sed_crnn_torch.ops.kernels.gru_scan import dwh_body

    check(body in ("warp", "wide", "cluster", "grid"), f"unknown GRU body {body!r}")
    wgmma = sum(dwh_body(h) == "wgmma" for h in hidden) if body != "warp" else 0
    return {"gru_scan_fwd": fwd, "gru_scan_fwd_res": steps, "gru_scan_bwd": steps,
            "gru_dwh": steps, "gru_scan_sum_partials": steps,
            "gru_dwh_mma": steps if body != "warp" else 0,
            "gru_dwh_wgmma": steps // max(1, len(hidden)) * wgmma,
            **{f"gru_{b}": fwd + 2 * steps if body == b else 0
               for b in ("wide", "cluster", "grid")}}


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


def _gru_model_body(model_cfg) -> str:
    """The body kernel B runs the model's GRUs on (`gru_body`; one body for
    every layer)."""
    from sed_crnn_torch.ops.kernels.gru_scan import gru_body

    bodies = {gru_body(h) for h in model_cfg.gru_hidden}
    check(len(bodies) == 1, f"gru_hidden {model_cfg.gru_hidden} mixes GRU bodies {bodies}")
    return bodies.pop()


def phase_train_step(model_overrides: dict | None = None, tag: str = "[train step]"):
    """One full-width sednet-dcase train step (the model config replaced by
    ``model_overrides``) on the card and on the CPU from the same weights and
    batch, dropout 0."""
    import torch

    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.models import get_model
    from sed_crnn_torch.models.convert import from_jax
    from sed_crnn_torch.train.loop import Trainer, TrainState, checkpoint_tree

    cfg = get_preset("sednet-dcase")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **(model_overrides or {})))
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
    want = _gru_path_counts(0, 2, _gru_model_body(mcfg), mcfg.gru_hidden)   # a pair a layer
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
    print(f"{tag} sednet-dcase full width, gru_hidden {tuple(mcfg.gru_hidden)}, batch {batch}, "
          f"dropout 0: loss card "
          f"{loss_g:.6f} vs CPU {loss_c:.6f} (rel {loss_rel:.2g}); gradients (Adam's mu) "
          f"max|diff| / leaf max {worst_grad:.3g} ({worst_leaf}; the CPU's two convolution "
          f"backends differ by {cpu_spread:.3g} at {cpu_leaf}); BatchNorm stats {bn_err:.3g}; "
          f"{unclear} parameter elements with |g| inside the band; launches {launches}; "
          f"CPU step {cpu_s:.2f} s")
    return {"loss_rel": loss_rel, "grad_rel": worst_grad, "bn": bn_err,
            "launches": launches["gru_wide"] + launches["gru_cluster"] + launches["gru_grid"],
            "counts": launches}


def phase_train(workdir: str, model_overrides: dict | None = None, tag: str = "[train]"):
    """`run_fold` at the preset's full size (the model config replaced by
    ``model_overrides``) on synthetic folds, on the card."""
    import torch

    from sed_crnn_torch.apps.infer import load_model
    from sed_crnn_torch.apps.train import synthetic_folds
    from sed_crnn_torch.core.checkpoint import load_checkpoint
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.train.loop import Trainer, make_samplers, run_fold

    cfg = get_preset("sednet-dcase")
    epochs = 2
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **(model_overrides or {})),
                      train=dataclasses.replace(cfg.train, max_epochs=epochs, plot_every=0))
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
    want = _gru_path_counts(2 * n_sweep * epochs, 2 * n_train * epochs, _gru_model_body(cfg.model),
                            cfg.model.gru_hidden)
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
    print(f"{tag} run_fold sednet-dcase full width, gru_hidden {tuple(cfg.model.gru_hidden)}, "
          f"{frames} frames per train split: "
          f"{epochs} epochs x {n_train} steps at batch {cfg.train.batch_size}, "
          f"{n_sweep} sweep step(s) per epoch, in {wall:.2f} s (epoch_sec {epoch_sec}); "
          f"loss_tr {res.history['loss_tr']}, loss_val {res.history['loss_val']}, "
          f"ER_1s_val {res.history['er_1s_val']}; last checkpoint serves the same val scores "
          f"(loss {loss_val:.6f}) and card vs CPU logits within {logit_err:.3g}; "
          f"launches {launches}")
    return launches, cfg, fold


def _train_stepper(cfg, fold):
    """One full-width train step at the preset's batch on the card, from the
    serving phase's seeded weights (numpy seed 11), as a closure."""
    import torch

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

    def one_step():
        nonlocal st
        x, y = tr.sample_batch(rngs.batch, cfg.train.batch_size)
        st, _, _ = trainer.train_step(st, x, y, rngs.dropout)

    return one_step


def phase_train_throughput(cfg, fold):
    """Train-step time at batch 128 and the training rate; a profile of one step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    one_step = _train_stepper(cfg, fold)
    batch = cfg.train.batch_size
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


# [tools]: the port's tracing, debug and host-library tools at full width.
TOOLS_STEPS = 10          # StepClock's train steps at batch 128
TOOLS_ANNOTATIONS = ("frontend", "train step", "serve")
# The kernels' symbols in a trace, by wrapper count: kernel A's bodies, and
# kernel B's recurrences (the forward with or without residuals told apart
# by the WITH_RES template argument, demangled or not), chain, dwh and sum.
TRACE_SYMBOLS = {
    "fused_logmel": ("logmel_fft_kernel", "logmel_mixed_kernel", "logmel_cluster_kernel"),
    "gru_scan_fwd": ("gru_warp_fwd", "gru_wide_fwd", "gru_cluster_fwd", "gru_grid_fwd"),
    "gru_scan_bwd": ("gru_warp_bwd", "gru_wide_bwd", "gru_cluster_bwd", "gru_grid_bwd"),
    "gru_dwh": ("gru_warp_dwh", "gru_dwh_kernel", "gru_dwh_wgmma"),
    "gru_scan_sum_partials": ("gru_warp_sum", "gru_dwh_sum"),
}


def _trace_kind(name: str):
    """The wrapper count a kernel event of the trace belongs to, or None."""
    for kind, symbols in TRACE_SYMBOLS.items():
        if any(sym in name for sym in symbols):
            if kind == "gru_scan_fwd" and ("true>" in name or "Lb1E" in name):
                return "gru_scan_fwd_res"
            return kind
    return None


def _read_trace(path: str):
    """-> (device ms and event count per kind, the annotation names)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    per_kind: dict = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        kind = _trace_kind(e.get("name", ""))
        if kind is not None:
            n, ms = per_kind.get(kind, (0, 0.0))
            per_kind[kind] = (n + 1, ms + float(e.get("dur", 0.0)) / 1e3)
    names = {e.get("name") for e in events
             if e.get("cat") in ("user_annotation", "gpu_user_annotation")}
    return per_kind, names


def _launch_deltas() -> dict:
    """Kernel A's launches (every route) and kernel B's by count, as the
    trace kinds group them."""
    lm, gru = _logmel_counts(), _gru_counts()
    return {"fused_logmel": lm["chunked"] + lm["framed"] + lm["exact"],
            **{k: gru[k] for k in ("gru_scan_fwd", "gru_scan_fwd_res", "gru_scan_bwd",
                                   "gru_dwh", "gru_scan_sum_partials")}}


def _tools_trace(workdir: str, cfg, fold, y240: np.ndarray) -> dict:
    """`profile_trace` around a kernel-frontend `extract` of 240 s, one train
    step at batch 128 and one B=1 serving chunk, each annotated; the trace's
    kernel A and B events against the wrappers' launch counts, and their
    device time against CUDA events on the same shapes."""
    import torch

    from sed_crnn_torch.models.export import export_serving
    from sed_crnn_torch.ops import frontend
    from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel
    from sed_crnn_torch.ops.kernels.gru_scan import (
        gru_scan_pair,
        gru_scan_pair_bwd,
        gru_scan_pair_fwd_res,
    )
    from sed_crnn_torch.utils.tracing import TRACE_FILE, annotate, profile_trace

    dev = torch.device("cuda")
    fe = dataclasses.replace(cfg.frontend, backend="kernel")
    one_step = _train_stepper(cfg, fold)
    params, state = model_tree(cfg.model, seed=11)
    art = export_serving(cfg, params, state, device=dev)
    mel = frontend.extract(y240, fe, device=dev)      # warm: the build and the first launches
    chunk = mel[: cfg.model.seq_len_in]
    one_step()
    art.stream_step(art.stream_init(), chunk)
    torch.cuda.synchronize()

    trace_dir = os.path.join(workdir, "trace")
    _reset_logmel_counts()
    _reset_gru_counts()
    with profile_trace(trace_dir):
        with annotate("frontend"):
            frontend.extract(y240, fe, device=dev)
        with annotate("train step"):
            one_step()
        with annotate("serve"):
            art.stream_step(art.stream_init(), chunk)
    launches = _launch_deltas()
    per_kind, names = _read_trace(os.path.join(trace_dir, TRACE_FILE))
    counted = {k: per_kind.get(k, (0, 0.0))[0] for k in launches}
    check(counted == launches, f"trace kernel events {counted} != wrapper launches {launches}")
    check(all(v > 0 for v in launches.values()), f"a kernel kind missing from the run {launches}")
    missing = [a for a in TOOLS_ANNOTATIONS if a not in names]
    check(not missing, f"annotations missing from the trace: {missing}")
    zero = [k for k in launches if not per_kind[k][1] > 0]
    check(not zero, f"no device time in the trace for {zero}")

    # CUDA events on the traced shapes: kernel A on the padded 240 s signal
    # `extract` hands it, kernel B's pairs at B=128 (training) and B=1.
    y = torch.from_numpy(bucket_signal(y240, fe)).to(dev)
    raw = dataclasses.replace(fe, center=False)
    rng = np.random.default_rng(23)
    H, T = cfg.model.gru_hidden[0], cfg.model.seq_len_out
    reset_after = cfg.model.name != "sednet"

    def pair(B):
        t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
        xp = (t(B, T, 3 * H), t(B, T, 3 * H))
        wh = (0.3 * t(H, 3 * H), 0.3 * t(H, 3 * H))
        h0 = (t(B, H), t(B, H))
        return xp, wh, (None, None), h0, (t(B, T, H), t(B, T, H)), (t(B, H), t(B, H))

    xp, wh, bh, h0, dys, dhl = pair(cfg.train.batch_size)
    (fys, fres, _), (bys, bres, _) = gru_scan_pair_fwd_res(xp, wh, bh, h0, reset_after,
                                                           cfg.model.gru_gate_activation)
    xp1, wh1, bh1, h01, _, _ = pair(1)
    gate = cfg.model.gru_gate_activation
    event_ms = {
        "fused_logmel": cuda_ms(lambda: fused_log_mel(y, raw)),
        "gru_scan_fwd_res": cuda_ms(lambda: gru_scan_pair_fwd_res(xp, wh, bh, h0, reset_after,
                                                                  gate)),
        "gru_scan_bwd+dwh+sum": cuda_ms(lambda: gru_scan_pair_bwd(
            (fys, bys), (fres, bres), wh, h0, dys, dhl, reset_after, gate)),
        "gru_scan_fwd": cuda_ms(lambda: gru_scan_pair(xp1, wh1, bh1, h01, reset_after, gate)),
    }
    trace_ms = {k: per_kind[k][1] / per_kind[k][0] for k in launches}
    trace_ms["gru_scan_bwd+dwh+sum"] = sum(
        trace_ms[k] for k in ("gru_scan_bwd", "gru_dwh", "gru_scan_sum_partials"))
    print(f"[tools] profile_trace of a kernel-frontend extract ({len(y240) / SR:.0f} s), one "
          f"train step at batch {cfg.train.batch_size} and one B=1 serving chunk "
          f"(sednet-dcase full width): kernel events by kind {counted} = the wrappers' "
          f"launches; annotations {list(TOOLS_ANNOTATIONS)} present")
    for k in ("fused_logmel", "gru_scan_fwd_res", "gru_scan_bwd", "gru_dwh",
              "gru_scan_sum_partials", "gru_scan_bwd+dwh+sum", "gru_scan_fwd"):
        beside = f", CUDA events {event_ms[k]:.4f} ms" if k in event_ms else ""
        print(f"[tools]   {k}: trace device {trace_ms[k]:.4f} ms per launch{beside}")
    return {"launches": launches, "trace_ms": trace_ms, "event_ms": event_ms}


def _tools_debug(workdir: str, cfg, fold) -> dict:
    """`run_fold(debug=True)` for one epoch on [train]'s synthetic fold: the
    same GRU launches as without it; with one NaN in a window of the first
    training batch it raises `NonFiniteError` at fold 1 epoch 1."""
    import torch

    from sed_crnn_torch.train.loop import Rngs, make_samplers, run_fold
    from sed_crnn_torch.utils.debug import NonFiniteError

    dev = torch.device("cuda")
    cfg1 = cfg.replace(train=dataclasses.replace(cfg.train, max_epochs=1))
    counts, walls = {}, {}
    for debug in (False, True):
        _reset_gru_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_fold(cfg1, fold, 1, os.path.join(workdir, f"debug_{debug}"), device="cuda",
                       verbose=False, debug=debug)
        torch.cuda.synchronize()
        walls[debug], counts[debug] = time.perf_counter() - t0, _gru_counts()
        check(res.epochs_run == 1 and np.isfinite(res.history["loss_tr"]).all(),
              f"run_fold debug={debug}: {res.history['loss_tr']}")
    check(counts[True] == counts[False], f"debug launches {counts[True]} != {counts[False]}")

    # The first batch's first window, replayed from run_fold's generators.
    tr, _ = make_samplers(cfg1, fold, dev)
    rngs = Rngs(dev, cfg1.train.seed + 1, len(cfg1.model.conv_channels) + 1)
    x, _ = tr.sample_batch(rngs.batch, cfg1.train.batch_size)
    T = cfg1.model.seq_len_in
    n_win = len(fold["train_x"]) // T
    windows = fold["train_x"][: n_win * T].reshape(n_win, T, -1)
    (w,) = np.flatnonzero((windows == x[0].cpu().numpy()).all(axis=(1, 2)))
    planted = dict(fold, train_x=fold["train_x"].copy())
    planted["train_x"][w * T + T // 2, 7] = np.nan
    message = None
    try:
        run_fold(cfg1, planted, 1, os.path.join(workdir, "debug_nan"), device="cuda",
                 verbose=False, debug=True)
    except NonFiniteError as e:
        message = str(e)
    check(message is not None and message.startswith("fold 1 epoch 1: non-finite loss"),
          f"run_fold(debug=True) with a planted NaN: {message!r}")
    print(f"[tools] run_fold 1 epoch on [train]'s fold: debug=False {walls[False]:.3f} s, "
          f"debug=True {walls[True]:.3f} s, GRU launches equal {counts[True]}; one NaN in "
          f"window {w} of the first batch: NonFiniteError {message!r}")
    return {"launches": counts[True], "wall_s": walls[False], "debug_wall_s": walls[True]}


def _tools_native(workdir: str, y240: np.ndarray, pcm: np.ndarray) -> dict:
    """The C++ host library, built here: `log_mel_native` against kernel A's
    chunked route on the 240 s signal (5e-4 in the log domain, -inf pattern
    equal), `StreamingFramer` bitwise `PythonFramer` on random packets of the
    120 s signal, `wav_read_mono_native` within 1e-6 of `data/wavio`."""
    import torch

    from sed_crnn_torch.core.config import FrontendConfig
    from sed_crnn_torch.data.wavio import read_wav, write_wav
    from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel
    from sed_crnn_torch.utils import native

    t0 = time.perf_counter()
    lib = native.build_library(force=True)   # compiled by this run, whatever is cached
    build_s = time.perf_counter() - t0
    fe = FrontendConfig()
    t0 = time.perf_counter()
    host = native.log_mel_native(y240, fe.sample_rate, fe.n_fft, fe.hop_length, fe.n_mels,
                                 fe.center)
    host_s = time.perf_counter() - t0
    kernel = fused_log_mel(torch.from_numpy(y240).cuda(), fe).cpu().numpy()
    fin = np.isfinite(kernel)
    check(host.shape == kernel.shape and np.array_equal(np.isfinite(host), fin),
          f"log_mel_native {host.shape} vs kernel A {kernel.shape}: -inf pattern")
    check(not fin.all(), "the 240 s signal's silence gives -inf rows")
    err = float(np.abs(host[fin] - kernel[fin]).max())
    check(err <= LOGMEL_ATOL, f"log_mel_native vs kernel A: {err}")

    rng = np.random.default_rng(29)
    framers = (native.StreamingFramer(fe.n_fft, fe.hop_length), native.PythonFramer(
        fe.n_fft, fe.hop_length))
    parts: tuple = ([], [])
    i = 0
    while i < len(pcm):
        step = int(rng.integers(1, 8193))
        for f, out in zip(framers, parts):
            out.append(f.feed(pcm[i : i + step]))
        i += step
    for f, out in zip(framers, parts):
        out.append(f.flush())
        f.close()
    frames = [np.concatenate(p) for p in parts]
    check(np.array_equal(frames[0], frames[1]), "StreamingFramer vs PythonFramer")

    wav = os.path.join(workdir, "tones_120s.wav")
    write_wav(wav, pcm, SR)
    got, sr = native.wav_read_mono_native(wav)
    want, sr_ref = read_wav(wav)
    wav_err = float(np.abs(got - want).max())
    check(sr == sr_ref == SR and got.shape == want.shape and wav_err <= 1e-6,
          f"wav_read_mono_native vs wavio: {wav_err}")
    print(f"[tools] host library {lib} built in {build_s:.2f} s (g++ -O3); log_mel_native on "
          f"240 s ({host.shape[0]} frames, {host_s:.2f} s on the host) vs kernel A's chunked "
          f"route: max|diff| at finite {err:.3g}, -inf pattern equal ({int((~fin).sum())} "
          f"entries); StreamingFramer bitwise PythonFramer on {len(parts[0])} packets "
          f"({frames[0].shape[0]} frames); wav_read_mono_native vs wavio {wav_err:.3g}")
    print("[tools] TF SavedModel export (models/tf_export.py, apps.export --format tf): "
          "held on the CPU only (tests/test_torch_tf_export.py): no tensorflow beside the card")
    return {"logmel_native_max_abs_err": err}


def phase_tools(workdir: str, cfg, fold, train_step_ms: float, pcm: np.ndarray) -> dict:
    """[tools]: tracing (`utils/tracing.py`) around kernels A and B, the
    StepClock against the training rate, `run_fold(debug=True)` and the C++
    host library, at sednet-dcase full width."""
    import torch

    from sed_crnn_torch.utils.tracing import FRAMES_PER_SEC as CLOCK_FPS
    from sed_crnn_torch.utils.tracing import StepClock

    t_phase = time.perf_counter()
    os.makedirs(workdir)
    y240 = tones(240.0, 2, silent=[(100.0, 101.5)])
    traced = _tools_trace(workdir, cfg, fold, y240)

    one_step = _train_stepper(cfg, fold)
    one_step()
    clock = StepClock(cfg.model.seq_len_in)
    torch.cuda.synchronize()
    with clock:
        for _ in range(TOOLS_STEPS):
            one_step()
            clock.add_windows(cfg.train.batch_size)
        torch.cuda.synchronize()
    rate_h = cfg.train.batch_size * cfg.model.seq_len_in / CLOCK_FPS / (train_step_ms / 1e3) / 3600
    print(f"[tools] StepClock over {TOOLS_STEPS} train steps at batch {cfg.train.batch_size}: "
          f"{clock.record()} -> {clock.audio_hours_per_sec:.4f} audio-hours/sec; [throughput]'s "
          f"median step ({train_step_ms:.2f} ms) gives {rate_h:.4f} audio-hours/sec")

    debugged = _tools_debug(workdir, cfg, fold)
    hosted = _tools_native(workdir, y240, pcm)
    print(f"[tools] phase wall {time.perf_counter() - t_phase:.1f} s")
    launches = dict(traced["launches"])
    for k, n in debugged["launches"].items():
        if k in launches:
            launches[k] += n
    return {"launches": launches, "trace_ms": traced["trace_ms"], "event_ms": traced["event_ms"],
            "clock_audio_hours_per_sec": clock.audio_hours_per_sec, **hosted,
            "debug_wall_s": debugged["debug_wall_s"], "plain_wall_s": debugged["wall_s"]}


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
    """Launches per route, and of the mixed and cluster bodies among them."""
    from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel

    return {"chunked": fused_log_mel.launches, "framed": fused_log_mel.framed_launches,
            "exact": fused_log_mel.exact_launches, "mixed": fused_log_mel.mixed_launches,
            "cluster": fused_log_mel.cluster_launches}


def _reset_logmel_counts():
    from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel

    fused_log_mel.launches = fused_log_mel.framed_launches = fused_log_mel.exact_launches = 0
    fused_log_mel.mixed_launches = fused_log_mel.cluster_launches = 0
    fused_log_mel.wgmma_launches = fused_log_mel.mma_launches = 0


def _form_counts():
    """Mixed and cluster launches by the form of their matrix stages: on
    ``wgmma`` and on ``mma.sync`` (`fused_logmel.wgmma_radix`, R alone)."""
    from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel

    return {"wgmma": fused_log_mel.wgmma_launches, "mma": fused_log_mel.mma_launches}


def _forms_text(plan) -> str:
    """A plan's matrix stages by form."""
    from sed_crnn_torch.ops.kernels.fused_logmel import wgmma_radix

    radices = plan.matrix + plan.rader_matrix + plan.nested_matrix
    on = {f: [r for r in radices if wgmma_radix(r) == (f == "wgmma")] for f in ("wgmma", "mma")}
    return ", ".join(f"{on[f]} on {'wgmma' if f == 'wgmma' else 'mma.sync'}" for f in on
                     if on[f])


# The matrix phase of a timed plan (`tools/logmel_phases.py`'s MATRIX_CUTS:
# each body built without the power and mel sums, and also without the
# matrix stages; the phase is the difference). The four builds start after
# the kernels' (`_start_matrix_cuts`) and are waited for by the first
# phase that times a matrix phase.
_MATRIX_CUT_LIBS: dict = {}


def _start_matrix_cuts():
    from sed_crnn_torch.ops.kernels import _build
    from sed_crnn_torch.tools import logmel_phases as lp

    out = _build.BUILD_DIR.parent / "chip_smoke_cuts"
    out.mkdir(parents=True, exist_ok=True)
    for body in ("mixed", "cluster"):
        source, macro, _ = lp.BODIES[body]
        for cut, level in lp.MATRIX_CUTS.items():
            lib = out / f"lib{source}_{cut}.so"
            _MATRIX_CUT_LIBS[source, cut] = lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, f"-D{macro}={level}", "-o", str(lib),
                 str(_build.CSRC_DIR / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _matrix_cut_lib(source: str, cut: str):
    import ctypes

    lib, proc = _MATRIX_CUT_LIBS[source, cut]
    if isinstance(proc, subprocess.Popen):
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc of {source} {cut}: {out[-2000:]}")
        _MATRIX_CUT_LIBS[source, cut] = lib, ctypes.CDLL(str(lib))
    return _MATRIX_CUT_LIBS[source, cut][1]


def _matrix_phase(yt, cfg, n_frames: int) -> dict:
    """The matrix phase of ``cfg``'s plan on its body, ms (the two cut
    builds in turns), beside its bound and share of it (`tools/
    logmel_phases.py`'s `matrix_report`: the three TF32 products at 495
    TFLOP/s or the points' and tables' bytes through shared memory)."""
    import torch

    from sed_crnn_torch.ops.kernels import fused_logmel as fl
    from sed_crnn_torch.tools import logmel_phases as lp

    plan = fl.mixed_plan(cfg.n_fft)
    source = lp.BODIES[fl.body(cfg.n_fft)][0]
    libs = {cut: _matrix_cut_lib(source, cut) for cut in lp.MATRIX_CUTS}
    ms = {cut: [] for cut in libs}
    for cut in list(libs) + list(libs)[::-1]:
        ms[cut].append(lp._with_lib(fl, source, libs[cut], lambda: cuda_ms(
            lambda: fl.fused_log_mel(yt, cfg), reps=10)))
    mean = {k: float(np.mean(v)) for k, v in ms.items()}
    out = lp.matrix_report(mean, plan, n_frames, torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    return {k: out[k] for k in ("ms", "bound_ms", "bound_by", "share_of_bound")}


def _kernel_library_turns(kernel, library) -> tuple:
    """The kernel and one library call in turns (kernel, library, library,
    kernel): their mean ms."""
    ms = {"kernel": [], "library": []}
    for k in ("kernel", "library", "library", "kernel"):
        ms[k].append(cuda_ms(kernel if k == "kernel" else library, reps=10))
    return float(np.mean(ms["kernel"])), float(np.mean(ms["library"]))


def _matrix_line(tag: str, plan, yt, cfg, n_frames: int, kernel, library) -> dict:
    """For a timed plan with matrix stages: which form each ran (one launch,
    counted by the forms the library reports, checked against the rule's
    mirror `wgmma_radix`), the kernel in turns with `torch.stft` + mel, and
    the matrix phase beside its bound; printed, and returned for the
    kernels line."""
    import torch

    from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel, wgmma_radix

    radices = plan.matrix + plan.rader_matrix + plan.nested_matrix
    _reset_logmel_counts()
    fused_log_mel(yt, cfg)
    torch.cuda.synchronize()
    forms = _form_counts()
    want = {"wgmma": int(any(wgmma_radix(r) for r in radices)),
            "mma": int(any(not wgmma_radix(r) for r in radices))}
    check(forms == want, f"{tag}: launches by form {forms}, expected {want}")
    ms, lib_ms = _kernel_library_turns(kernel, library)
    phase = _matrix_phase(yt, cfg, n_frames)
    print(f"{tag}: matrix stages {_forms_text(plan)}, one launch by form {forms}; in turns "
          f"kernel {ms:.4f} ms, torch.stft+mel {lib_ms:.4f} ms (x{lib_ms / ms:.2f}); matrix "
          f"phase {phase['ms']:.4f} ms against its bound {phase['bound_ms']:.4f} ms "
          f"({phase['bound_by']}): {phase['share_of_bound']:.3f} of it")
    return {"forms": forms, "turns_ms": ms, "turns_library_ms": lib_ms, "matrix_phase": phase}


def _check_logmel(tag: str, got, want) -> float:
    import torch

    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin), f"{tag}: -inf pattern")
    check(torch.equal(got[~fin], want[~fin]), f"{tag}: non-finite values")
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(err <= LOGMEL_ATOL, f"{tag}: {err} > {LOGMEL_ATOL}")
    return err


def _logmel_signals(base):
    """Phase 3's signals (a 30 s bucket run uncentred, 240 s with a silent
    stretch, a ragged length, silence) and a 1,500-sample one, with whether
    each is centred."""
    return [
        ("30s bucket", bucket_signal(tones(30.0, 1)[: 30 * SR - 4096], base), False),
        ("240s", tones(240.0, 2, silent=[(100.0, 101.5)]), True),
        ("ragged", tones(123457 / SR, 3), True),
        ("silence", np.zeros(5 * SR, np.float32), True),
        ("short", tones(1500 / SR, 4), True),
    ]


def _library_logmel(yt, cfg):
    """`torch.stft` + mel + floor + log at ``cfg``, uncentred: one library
    pipeline computing kernel A's function (timed, never used by the port)."""
    import torch

    from sed_crnn_torch.ops.mel import mel_filterbank

    fb = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels)).to(yt.device)
    window = torch.hann_window(cfg.n_fft, periodic=True, device=yt.device)
    return lambda: torch.log(torch.clamp_min(fb @ torch.stft(
        yt, cfg.n_fft, cfg.hop_length, window=window, center=False,
        return_complex=True).abs().square(), 1e-10))


def phase_logmel_routes(pcm: np.ndarray):
    """Kernel A's framed route (the TPU `_kernel_dif`) and exact route
    (`_kernel_exact`) on the FFT body, against the DIF / direct plain
    version on the card (and against the FFT body's own plain version, two
    runs bitwise equal); their times at the binmul path's shapes beside the
    plain versions, `torch.stft` + mel and the bounds, and the host's issue
    time per call; the exact route driven once at n_fft 2048. Returns the
    framed and exact entries."""
    import torch

    from sed_crnn_torch.core.config import FrontendConfig
    from sed_crnn_torch.ops.kernels.fused_logmel import (
        body,
        fft_log_mel_plain,
        fused_log_mel,
        fused_log_mel_frames,
        fused_log_mel_frames_plain,
        fused_log_mel_plain,
        route,
    )
    from sed_crnn_torch.ops.stft import frame_signal

    dev = torch.device("cuda")
    signals = _logmel_signals(FrontendConfig())
    confs = {"framed": [((1024, 1024), "dif"), ((4096, 1024), "dif")],
             "exact": [((2048, 1024), "exact")]}
    worst = {"framed": 0.0, "exact": 0.0}
    for kind, cases in confs.items():
        for (n_fft, hop), mode in cases:
            errs, fft_errs = [], []
            check(body(n_fft) == "fft", f"{n_fft}: the fft body")
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
            worst[kind] = max(worst[kind], max(errs))
            print(f"[kernel A {kind}] n_fft {n_fft} hop {hop} mode {mode}, fft body: "
                  f"{len(signals)} signals x 2 floors + a {tuple(frames.shape)} frame matrix, "
                  f"max|diff| at finite {max(errs):.3g} (fft plain {max(fft_errs):.3g}), two "
                  f"runs bitwise equal, -inf patterns equal")

    timed = {}
    for kind, n_fft, hop, mode in (("framed", 1024, 1024, "dif"), ("framed", 4096, 1024, "dif"),
                                   ("exact", 2048, 1024, "exact")):
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
        y = bucket_signal(pcm, cfg)
        yt = torch.from_numpy(y).to(dev)
        n_frames = 1 + (len(y) - n_fft) // hop
        check(route(len(y), cfg, mode) == kind, f"timed {kind} route")
        tag = f"log-mel {kind} {n_fft}/{hop} {mode} binmul-path shape"
        want = fused_log_mel_plain(yt, cfg, mode)
        got = fused_log_mel(yt, cfg, mode)
        err = _check_logmel(tag, got, want)
        worst[kind] = max(worst[kind], err)
        kernel = lambda: fused_log_mel(yt, cfg, mode)  # noqa: E731
        lib = _library_logmel(yt, cfg)
        ms = cuda_ms(kernel)
        cold = cuda_ms_cold(kernel)
        plain = cuda_ms(lambda: fused_log_mel_plain(yt, cfg, mode), reps=5)
        lib_ms = cuda_ms(lib)
        bnd, by, flops, nbytes = logmel_bound(len(y), n_frames, cfg)
        err_fft = _check_fft_body(tag, got, fused_log_mel(yt, cfg, mode),
                                  fft_log_mel_plain(yt, cfg))
        fft_plain = cuda_ms(lambda: fft_log_mel_plain(yt, cfg), reps=5)
        direct = route(len(y), cfg, mode) == "exact"
        print(f"[kernel A {kind}] binmul-path shape n_fft {n_fft} hop {hop} mode {mode}, fft "
              f"body: {n_frames} frames ({len(y) / SR:.1f} s padded), vs plain max|diff| at "
              f"finite {err:.3g}, -inf patterns equal: kernel {ms:.4f} ms warm L2, {cold:.4f} ms "
              f"cold L2; plain ({'direct' if direct else 'DIF'}) {plain:.4f} ms; vs the fft "
              f"plain version {err_fft:.3g}, two runs bitwise equal; the fft body's plain "
              f"emulation {fft_plain:.4f} ms; "
              f"torch.stft+mel {lib_ms:.4f} ms; bound {bnd:.4f} ms ({by}, rFFT+power+sparse "
              f"mel {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), kernel at {bnd / ms:.3f} "
              f"of its bound")
        measured = {}
        print(f"[kernel A {kind}] n_fft {n_fft} hop {hop}, "
              f"{split_line(bnd, measured, kernel=kernel, library=lib)}")
        timed[(kind, n_fft)] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                                "library_ms": lib_ms, "host_ms": measured["kernel"][1]}

    # The exact route on the FFT body: mode "exact" at n_fft 2048 on the
    # 120 s file, against the direct plain version.
    cfg = FrontendConfig(log_floor=1e-10)
    y120 = torch.from_numpy(pcm).to(dev)
    _reset_logmel_counts()
    got = fused_log_mel(y120, cfg, "exact")
    torch.cuda.synchronize()
    exact_launches = _logmel_counts()
    check(exact_launches == {"chunked": 0, "framed": 0, "exact": 1, "mixed": 0, "cluster": 0},
          f"mode exact at n_fft 2048 launches {exact_launches}")
    err = _check_logmel("exact route n_fft 2048 on the 120 s file", got,
                        fused_log_mel_plain(y120, cfg, "exact"))
    print(f"[kernel A exact] fused_log_mel(mode='exact') of the {len(pcm) / SR:.0f} s file at "
          f"n_fft 2048: {tuple(got.shape)}, launches {exact_launches}, vs the direct plain "
          f"version max|diff| {err:.3g}")

    print(f"[kernel A framed] host issue per call at n_fft 1024 hop 1024 (the FFT body sets its "
          f"shared-memory attribute once per instantiation and device): "
          f"{timed[('framed', 1024)]['host_ms']:.4f} ms")
    fft = {"route": "cuda", "source": "sed_crnn_torch/csrc/logmel_fft.cu"}
    return (
        {"name": "fused_logmel_framed", **fft,
         "replaces": "sed_crnn_tpu/ops/pallas/fused_logmel.py:162",
         "max_abs_err": worst["framed"], **timed[("framed", 4096)]},
        {"name": "fused_logmel_exact", **fft,
         "replaces": "sed_crnn_tpu/ops/pallas/fused_logmel.py:264",
         "max_abs_err": worst["exact"], "launches": exact_launches["exact"],
         **timed[("exact", 2048)]},
    )


# The mixed body's shapes (n_fft, hop, route): L 517 = 11 x 47 (a matrix
# stage of 47), direct at L 882 and 1536, L 1001 = 7 x 11 x 13 (register
# radices), L 551 = 19 x 29 (two matrix stages), L 12865 = 5 x 31 x 83 and
# 11521 = 41 x 281 (matrix stages, and a Rader stage of 281), and the Rader
# plans: L 12867 = 3 x 4289 and 11527 (prime), the cluster body's Bluestein
# sizes before Rader stages fitted them in one block; L 1033 (prime, 1032 =
# 8 x 3 x 43: a Rader stage, the plan's only stage, its gather folded into
# the load, a matrix stage of 43 inside); 1103 (prime, a 25 ms window at
# 44.1 kHz: a Rader stage over 2 x 19 x 29, which `plan_cost` picks for L
# 1,103 as at 2206 under its refitted weights; the card timed it faster than
# Bluestein at 1103, slower at 2206, PERF.md §6); and 12895 (L 5 x
# 2579, 2578 = 2 x 1289, 1288 = 8 x 7 x 23: a Rader stage nested in the
# Rader stage's inner transforms), Bluestein at M 25,920 on the cluster
# body before the nested stage fitted it in one block.
MIXED_SHAPES = ((1034, 517, "exact"), (1764, 882, "chunked"), (3072, 1024, "framed"),
                (1001, 500, "exact"), (1102, 551, "exact"), (12865, 6432, "exact"),
                (23042, 11521, "exact"), (12867, 6433, "exact"), (23054, 11527, "exact"),
                (2066, 1033, "exact"), (1103, 551, "exact"), (12895, 6447, "exact"))
# A plan with matrix stages (a Rader stage's inner ones too) against
# `mixed_log_mel_plain` (whose matrix product is float64, rounded once):
# three TF32 products with float32 sums come within about 2^-21 of a
# butterfly's inputs, not bitwise, so a band far below its frame's peak (12
# nats at 1034) moves by that over its share: 5.7e-5 at most on the card
# over every shape and signal here (PERF.md §6), held at 1e-4; LOGMEL_ATOL
# is the ceiling. It holds at these frames; at a frame of tens of points
# (n_fft 46, one matrix stage of 23) a band of one weak bin came 1.1e-4 off,
# so the card tests of the stage's small forms bound the energies and the
# bands of at least 1e-2 of the frame's largest (PERF.md §7).
MATRIX_ATOL = 1e-4
# The sizes whose plan was Bluestein before matrix stages, timed with each
# of their plans in turns (matrix, Rader and Bluestein, each on the body it
# fits); 23044 (L 2 x 7 x 823: a Rader stage of 823 against a matrix stage
# of 823 and Bluestein on the cluster body).
PLAN_TURNS = ((1034, 517), (1102, 551), (12865, 6432), (23042, 11521), (23044, 11522))
TPU_LOGMEL_SITES = ", ".join(f"sed_crnn_tpu/ops/pallas/fused_logmel.py:{line}"
                             for line in (173, 162, 264))


def _plan_text(plan) -> str:
    """A plan as the timed lines print it."""
    text = (f"{'Bluestein' if plan.bluestein else 'direct'} L {plan.points}, N {plan.n}, "
            f"radices {plan.radices}, stages {'/'.join(plan.kinds) or 'none'}")
    if plan.rader:
        text += f", Rader {plan.rader_prime} over {plan.rader}"
    if plan.nested:
        text += f", nested Rader {plan.nested_prime} over {plan.nested}"
    return text


def _plain_tolerance(plan):
    """The tolerance against `mixed_log_mel_plain` and its reason."""
    if plan.tensor_cores:
        return MATRIX_ATOL, "TF32 x3 matrix stages against a float64 product"
    return 0.0, "bitwise: the same float32 operations"


def _check_plain_bits(tag: str, got, plain, plan) -> float:
    """The kernel against `mixed_log_mel_plain`: bitwise for a plan with no
    matrix stage, else within MATRIX_ATOL with the same -inf entries;
    returns max|diff| at finite entries (0 when bitwise)."""
    import torch

    if not plan.tensor_cores:
        check(torch.equal(got, plain), f"{tag}: not bitwise equal to mixed_log_mel_plain")
        return 0.0
    fin = torch.isfinite(plain)
    check(torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], plain[~fin]),
          f"{tag}: -inf pattern vs mixed_log_mel_plain")
    err = float((got[fin] - plain[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(err <= MATRIX_ATOL, f"{tag}: {err} from mixed_log_mel_plain > {MATRIX_ATOL}")
    return err


# The plans forced beside a size's own in turns (`mixed_plan` keywords).
FORCED_PLANS = {"bluestein": {"plan": "bluestein"}, "direct": {"plan": "direct"},
                "rader": {"plan": "rader"}, "nested": {"plan": "nested"}}


def _plan_turns(src, hop: int, n_frames: int, n_fft: int, cfg, check_bits: bool = True) -> dict:
    """The size's own plan and every other plan it has (Bluestein, direct
    without and with a Rader stage), each on the body it fits (the mixed
    body where one block holds it, else the cluster body), each checked
    against `mixed_log_mel_plain` forced alike, then timed in turns (own,
    others, others reversed, own): {label: {"plan", "body", "ms"}}."""
    from sed_crnn_torch.ops.kernels.fused_logmel import (
        MIXED_MAX_SMEM,
        _launch_cluster,
        _launch_mixed,
        mixed_log_mel_plain,
        mixed_plan,
    )

    own = mixed_plan(n_fft)
    plans = {"chosen": ({}, own)}
    for label, kw in FORCED_PLANS.items():
        try:
            plan = mixed_plan(n_fft, **kw)
        except ValueError:
            continue
        if all(plan != p for _, p in plans.values()):
            plans[label] = (kw, plan)
    fns, out = {}, {}
    for label, (kw, plan) in plans.items():
        where = "mixed" if plan.smem_bytes <= MIXED_MAX_SMEM else "cluster"
        launch = _launch_mixed if where == "mixed" else _launch_cluster
        fns[label] = lambda launch=launch, kw=kw: launch(src, hop, n_frames, n_fft, cfg, **kw)
        if check_bits and label != "chosen":
            _check_plain_bits(f"plans {n_fft}/{hop} {label}", fns[label](),
                              mixed_log_mel_plain(src, cfg, **kw), plan)
        out[label] = {"plan": _plan_text(plan), "body": where, "ms": []}
    order = list(fns)
    for label in order + order[::-1]:
        out[label]["ms"].append(cuda_ms(fns[label], reps=10))
    return out


def _turns_text(turns: dict) -> str:
    return "; ".join(f"{k} ({v['plan']}, {v['body']} body) {[round(t, 4) for t in v['ms']]} ms"
                     for k, v in turns.items())


def phase_logmel_mixed(pcm: np.ndarray):
    """[kernel A mixed]: the mixed-radix / Rader / Bluestein body at
    `MIXED_SHAPES` on phase 3's signals and a 1,500-sample one, with and
    without a floor: against `mixed_log_mel_plain` (bitwise, or within
    MATRIX_ATOL with matrix stages), two runs bitwise equal, within 5e-4 of
    the DIF / direct plain version (torch's FFT + mel above n_fft 4096, where
    that version's bases grow to gigabytes) with the -inf pattern equal, and
    on a frame matrix; its times on 150 s of padded audio beside `torch.stft`
    + mel, its Bluestein plan in turns, both plain versions and the bound;
    each `PLAN_TURNS` size with every plan in turns; `frontend.extract` at
    n_fft 1034 with one mixed launch and no cluster launch. Returns the mixed
    entry and its launches on that `extract` run."""
    import torch

    from sed_crnn_torch.core.config import FrontendConfig
    from sed_crnn_torch.ops import frontend
    from sed_crnn_torch.ops.kernels.fused_logmel import (
        body,
        frame_source,
        fused_log_mel,
        fused_log_mel_frames,
        fused_log_mel_plain,
        mixed_log_mel_plain,
        mixed_plan,
        route,
    )
    from sed_crnn_torch.ops.stft import frame_signal

    dev = torch.device("cuda")
    signals = _logmel_signals(FrontendConfig())
    worst = worst_plain = 0.0
    for n_fft, hop, kind in MIXED_SHAPES:
        plan = mixed_plan(n_fft)
        check(body(n_fft) == "mixed", f"{n_fft}: the mixed body")
        reference = fused_log_mel_plain if n_fft <= 4096 else _library_fft_log_mel
        errs, plain_errs = [], []
        _reset_logmel_counts()
        calls = 0
        for name, y, center in signals:
            yt = torch.from_numpy(y).to(dev)
            for floor in (None, 1e-10):
                cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=center, log_floor=floor)
                r = route(len(y), cfg)
                check(r == kind or (r == "framed" and len(y) < n_fft),
                      f"{name} {n_fft}/{hop} route {r}")
                tag = f"log-mel mixed {n_fft}/{hop} {name} floor={floor}"
                got = fused_log_mel(yt, cfg)
                again = fused_log_mel(yt, cfg)
                calls += 2
                check(torch.equal(got, again), f"{tag}: two runs differ")
                plain_errs.append(_check_plain_bits(tag, got, mixed_log_mel_plain(yt, cfg), plan))
                errs.append(_check_logmel(tag, got, reference(yt, cfg)))
                if name == "silence" and floor is None:
                    check(not bool(torch.isfinite(got).any()), f"{tag}: not all -inf")
        y240 = torch.from_numpy(signals[1][1]).to(dev)
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, log_floor=1e-10)
        frames = frame_signal(y240, n_fft, hop).contiguous()
        got = fused_log_mel_frames(frames, cfg)
        calls += 1
        check(torch.equal(got, fused_log_mel(y240, cfg)),
              f"mixed {n_fft}/{hop} frame matrix: not bitwise the waveform's")
        plain_errs.append(_check_plain_bits(f"mixed {n_fft}/{hop} frame matrix", got,
                                            mixed_log_mel_plain(frames, cfg), plan))
        calls += 1
        counts = _logmel_counts()
        check(counts["mixed"] == calls and counts["cluster"] == 0,
              f"mixed {n_fft}/{hop}: launches {counts} for {calls} calls")
        worst, worst_plain = max(worst, max(errs)), max(worst_plain, max(plain_errs))
        atol, why = _plain_tolerance(plan)
        versus = ("bitwise equal to mixed_log_mel_plain" if not plan.tensor_cores else
                  f"vs mixed_log_mel_plain max|diff| {max(plain_errs):.3g} (tolerance "
                  f"{atol:g}: {why})")
        print(f"[kernel A mixed] n_fft {n_fft} hop {hop} ({kind} route; {_plan_text(plan)}): "
              f"{len(signals)} signals x 2 floors + a {tuple(frames.shape)} frame matrix, "
              f"{versus}, bitwise run to run, vs the "
              f"{'DIF / direct plain version' if n_fft <= 4096 else 'torch FFT + mel'} "
              f"max|diff| at finite {max(errs):.3g}, -inf patterns equal; launches {counts}")

    timed = {}
    for n_fft, hop, kind in MIXED_SHAPES:
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
        y = bucket_signal(pcm, cfg)
        yt = torch.from_numpy(y).to(dev)
        n_frames = 1 + (len(y) - n_fft) // hop
        plan = mixed_plan(n_fft)
        small = n_fft <= 4096
        got = fused_log_mel(yt, cfg)
        tag = f"log-mel mixed {n_fft}/{hop} timed shape"
        err = _check_logmel(tag, got, (fused_log_mel_plain if small else _library_fft_log_mel)(
            yt, cfg))
        plain_err = _check_plain_bits(tag, got, mixed_log_mel_plain(yt, cfg), plan)
        worst, worst_plain = max(worst, err), max(worst_plain, plain_err)
        kernel = lambda: fused_log_mel(yt, cfg)  # noqa: E731
        lib = _library_logmel(yt, cfg)
        ms, cold = cuda_ms(kernel), cuda_ms_cold(kernel)
        lib_ms = cuda_ms(lib)
        plain = cuda_ms(lambda: fused_log_mel_plain(yt, cfg), reps=5) if small else None
        mixed_plain = cuda_ms(lambda: mixed_log_mel_plain(yt, cfg), reps=5 if small else 2,
                              warmup=1)
        bnd, by, flops, nbytes = logmel_bound(len(y), n_frames, cfg)
        measured = {}
        split = split_line(bnd, measured, kernel=kernel, library=lib)
        src, _ = frame_source(yt, cfg)
        turns = _plan_turns(src, hop, n_frames, n_fft, cfg, check_bits=False)
        blue = turns.get("bluestein")
        point_stages = n_frames * plan.n * len(plan.radices) * (2 if plan.bluestein else 1)
        plain_text = (f"plain ({'direct' if route(len(y), cfg) == 'exact' else 'DIF'}) "
                      f"{plain:.4f} ms, " if small else "")
        atol, why = _plain_tolerance(plan)
        print(f"[kernel A mixed] n_fft {n_fft} hop {hop} ({kind}; {_plan_text(plan)}), "
              f"{n_frames} frames ({len(y) / SR:.1f} s padded): kernel {ms:.4f} ms warm L2, "
              f"{cold:.4f} ms cold L2; torch.stft+mel {lib_ms:.4f} ms, x{lib_ms / ms:.2f} "
              f"against it ({'faster' if ms <= lib_ms else 'slower'}); "
              + (f"its Bluestein plan in turns {blue['ms']} ms (this plan "
                 f"{turns['chosen']['ms']}, x"
                 f"{np.mean(blue['ms']) / np.mean(turns['chosen']['ms']):.2f}); " if blue else "")
              + f"{plain_text}mixed_log_mel_plain {mixed_plain:.4f} ms (tolerance {atol:g}, "
              f"{why}: max|diff| {plain_err:.3g}); bound {bnd:.4f} ms ({by}, "
              f"rFFT+power+sparse mel {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB), kernel at {bnd / ms:.3f} of its bound; {point_stages:,} "
              f"frame-point-stages (frames x N x stages, x2 for Bluestein), "
              f"{ms * 1e9 / point_stages:.2f} ps each")
        print(f"[kernel A mixed] n_fft {n_fft} hop {hop}, {split}")
        matrix = (_matrix_line(f"[kernel A mixed] n_fft {n_fft} hop {hop}", plan, yt, cfg,
                               n_frames, kernel, lib) if plan.tensor_cores else {})
        timed[n_fft] = {**matrix, "ms": ms, "cold_ms": cold, "device_ms": measured["kernel"][0],
                        "host_ms": measured["kernel"][1], "plain_ms": plain,
                        "mixed_plain_ms": mixed_plain, "bound_ms": bnd, "bound_by": by,
                        "library_ms": lib_ms, "radices": list(plan.radices),
                        "kinds": list(plan.kinds), "rader": list(plan.rader),
                        "matrix": list(plan.matrix + plan.rader_matrix), "plain_atol": atol,
                        "plain_atol_reason": why, "plain_max_abs_err": plain_err,
                        "bluestein_ms": blue["ms"] if blue else None,
                        "plan_ms": turns["chosen"]["ms"]}

    # Every plan of the sizes that were Bluestein before matrix stages, in
    # turns (matrix, Rader, Bluestein, each on the body it fits);
    # `mixed_plan` should keep the fastest.
    turns = {}
    for n_fft, hop in PLAN_TURNS:
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
        src, n_frames = frame_source(torch.from_numpy(bucket_signal(pcm, cfg)).to(dev), cfg)
        turns[f"{n_fft}/{hop}"] = _plan_turns(src, hop, n_frames, n_fft, cfg)
        print(f"[kernel A mixed] plans at n_fft {n_fft} hop {hop}, {n_frames} frames, in turns: "
              f"{_turns_text(turns[f'{n_fft}/{hop}'])}; mixed_plan picks the first")

    # The main path at a size the mixed body takes: `frontend.extract` of
    # the 120 s file at n_fft 1034 (neither a power of two nor a multiple of
    # 4: the exact route, a matrix stage), against the fft backend.
    cfg = FrontendConfig(n_fft=1034, hop_length=517, backend="kernel")
    _reset_logmel_counts()
    got = frontend.extract(pcm, cfg, device=dev)
    torch.cuda.synchronize()
    launches = _logmel_counts()
    check(launches == {"chunked": 0, "framed": 0, "exact": 1, "mixed": 1, "cluster": 0},
          f"extract at n_fft 1034 launches {launches}")
    want = frontend.extract(pcm, dataclasses.replace(cfg, backend="fft"), device=dev)
    err = _check_logmel("extract n_fft 1034 kernel vs fft", got, want)
    worst = max(worst, err)
    print(f"[kernel A mixed] main path: frontend.extract of the {len(pcm) / SR:.0f} s file at "
          f"n_fft 1034 hop 517: {tuple(got.shape)}, launches {launches}, vs the fft backend "
          f"max|diff| {err:.3g}")
    main = timed[1034]
    shapes = {f"{n}/{h}": timed[n] for n, h, _ in MIXED_SHAPES}
    mixed = {"name": "fused_logmel_mixed", "route": "cuda",
             "source": "sed_crnn_torch/csrc/logmel_mixed.cu", "replaces": TPU_LOGMEL_SITES,
             "max_abs_err": worst, "plain_max_abs_err": worst_plain,
             **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             "shape": "n_fft 1034 hop 517, 150 s padded", "shapes": shapes, "plan_turns": turns}
    return mixed, launches["mixed"]


# The cluster body's shapes (n_fft, hop): L 12867 = 3 x 4289 at an even
# n_fft (25734: a Rader stage of 4289 over 4 x 4 x 4 x 67 under the
# refitted `plan_cost`, 3.2 % slower than Bluestein at M 25,920 there;
# exact route), L 12869 = 17 x
# 757 (25738: a matrix stage of 17, then a Rader stage of 757 over 4 x 3 x
# 3 x 3 x 7, its chunk whole inner transforms; exact route), L 15645 = 3 x
# 5 x 7 x 149 (31290: a matrix stage of 149), 1 s at 44.1 kHz and at 48 kHz
# (direct, chunked, 2 CTAs a frame), 2 s at 44.1 kHz (direct, 3 CTAs) and
# 21599 (odd, L prime, 21598 = 2 x 10799, 10798 = 2 x 5399: no Rader plan,
# nested or not; Bluestein at M 43,200, exact route) and 141001 (odd, L = 7
# x 20143: a Rader stage of 20143 over 2 x 3 x 3 x 3 x 373, its inner
# matrix stage of 373 (on wgmma) crossing CTAs, C 16, as every plan with a
# wgmma stage, two of its B slabs a CTA; exact route).
CLUSTER_SHAPES = ((25734, 12867), (25738, 12869), (31290, 15645), (44100, 22050),
                  (48000, 24000), (88200, 44100), (21599, 10799), (141001, 70500))
# Other splits of five of them, whose bits must be the default split's (4
# CTAs do not divide 44100's N, so all its stages cross CTAs; at 25738 each
# CTA holds whole inner transforms of its Rader stage at 2, 3 and 4 CTAs; at
# 141001 every inner stage crosses at every size, and its CTAs hold one B
# slab at C 11 and 12, two from 13).
CLUSTER_SPLITS = {25734: (2, 3, 4, 8, 16), 25738: (2, 3, 4), 44100: (2, 3, 4, 7),
                  88200: (3, 4, 6, 12), 141001: (11, 12, 13)}
# Sizes timed at two cluster sizes in turns: the smallest that holds the
# plan (`cluster_size`) and one with fewer stages crossing CTAs.
CLUSTER_TURNS = ((88200, 44100, 3, 4), (141000, 70500, 7, 8))
# The mixed body's shapes (register, matrix and Rader plans) forced onto
# the cluster body at these sizes.
CLUSTER_FORCED = (2, 3, 4, 8)


def _library_fft_log_mel(yt, cfg):
    """torch's FFT + mel + floor + log in float32 on the frames the kernel
    reads (`frame_source`: the port's reflect padding, uncentred), each
    windowed frame one complex transform: the library reference of [kernel A
    cluster] (never used by the port). Not `torch.stft`: at an odd n_fft
    cuFFT's batched real-to-complex transform leaks a neighbouring frame's
    rounding into an all-zero frame (7e-05 of a 470 peak at 12865), whose
    exact power, and the kernel's, is 0."""
    import torch

    from sed_crnn_torch.ops.kernels.fused_logmel import frame_source
    from sed_crnn_torch.ops.mel import mel_filterbank

    src, _ = frame_source(yt, cfg)
    fb = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                                         cfg.fmax)).to(yt.device)
    window = torch.hann_window(cfg.n_fft, periodic=True, device=yt.device)
    frames = src.unfold(0, cfg.n_fft, cfg.hop_length) * window
    spec = torch.fft.fft(frames.to(torch.complex64))[:, : cfg.n_fft // 2 + 1]
    mel = spec.abs().square() @ fb.T
    return torch.log(mel if cfg.log_floor is None else torch.clamp_min(mel, cfg.log_floor))


def phase_logmel_cluster(pcm: np.ndarray):
    """[kernel A cluster]: the mixed body's plan split over a thread-block
    cluster (``csrc/logmel_cluster.cu``), at every n_fft beyond one block's
    shared memory. The clusters the card holds at full shared memory, by
    size; at `CLUSTER_SHAPES` on phase 3's signals and a 1,500-sample one,
    with and without a floor: against `mixed_log_mel_plain` (bitwise, or
    within MATRIX_ATOL with matrix stages), twice bitwise, and within 5e-4
    of torch's FFT + mel (`_library_fft_log_mel`) with the -inf pattern
    equal; at `CLUSTER_SPLITS` the same bits at every cluster size; the mixed
    body's shapes (register, matrix and Rader plans) forced onto the cluster
    body at `CLUSTER_FORCED` sizes, bitwise the mixed body's; times on 150 s
    of padded audio (warm and cold L2, device and host) beside the bound,
    `torch.stft` + mel, the plain version and every other plan in turns;
    `frontend.extract` of the 120 s file at 25734 (exact route) and 44100
    (chunked), one cluster launch each and nothing else. Returns the
    kernels-line entry and the launches of those two `extract` runs."""
    import torch

    from sed_crnn_torch.core.config import FrontendConfig
    from sed_crnn_torch.ops import frontend
    from sed_crnn_torch.ops.kernels.fused_logmel import (
        CLUSTER_MAX,
        _launch_cluster,
        _launch_mixed,
        body,
        cluster_resident,
        cluster_size,
        cluster_split,
        frame_source,
        fused_log_mel,
        mixed_log_mel_plain,
        mixed_plan,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    resident = {c: cluster_resident(c) for c in range(1, CLUSTER_MAX + 1)}
    print(f"[kernel A cluster] clusters the card holds at once at 1,024 threads and 227 KB a "
          f"CTA, by cluster size: {resident}")
    check(all(n > 0 for n in resident.values()),
          f"the card refuses a cluster size the body may pick: {resident}")
    signals = _logmel_signals(FrontendConfig())
    worst = worst_plain = 0.0
    for n_fft, hop in CLUSTER_SHAPES:
        check(body(n_fft) == "cluster", f"{n_fft}: the cluster body")
        plan = mixed_plan(n_fft)
        sp = cluster_split(n_fft, cluster_size(n_fft))
        _reset_logmel_counts()
        calls, errs, plain_errs = 0, [], []
        for name, y, center in signals:
            yt = torch.from_numpy(y).to(dev)
            for floor in (None, 1e-10):
                cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=center, log_floor=floor)
                tag = f"log-mel cluster {n_fft}/{hop} {name} floor={floor}"
                got = fused_log_mel(yt, cfg)
                again = fused_log_mel(yt, cfg)
                calls += 2
                check(torch.equal(got, again), f"{tag}: two runs differ")
                plain_errs.append(_check_plain_bits(tag, got, mixed_log_mel_plain(yt, cfg), plan))
                errs.append(_check_logmel(f"{tag} vs torch.fft+mel", got,
                                          _library_fft_log_mel(yt, cfg)))
                if name == "silence" and floor is None:
                    check(not bool(torch.isfinite(got).any()), f"{tag}: not all -inf")
        counts = _logmel_counts()
        check(counts["cluster"] == calls and counts["mixed"] == 0,
              f"cluster {n_fft}/{hop}: launches {counts} for {calls} calls")
        worst, worst_plain = max(worst, max(errs)), max(worst_plain, max(plain_errs))
        atol, why = _plain_tolerance(plan)
        versus = ("bitwise equal to mixed_log_mel_plain" if not plan.tensor_cores else
                  f"vs mixed_log_mel_plain max|diff| {max(plain_errs):.3g} (tolerance "
                  f"{atol:g}: {why})")
        print(f"[kernel A cluster] n_fft {n_fft} hop {hop} ({_plan_text(plan)}; {sp.ctas} CTAs "
              f"of {sp.smem_bytes:,} bytes, chunk {sp.chunk}, {sum(sp.cross)} of "
              f"{len(sp.cross)} stages cross CTAs, each twice with Bluestein, "
              f"{sum(sp.rader_cross)} of {len(sp.rader_cross)} Rader inner stages): "
              f"{len(signals)} signals x 2 floors, {versus}, bitwise run to run, vs "
              f"torch.fft+mel max|diff| at finite {max(errs):.3g}, -inf patterns equal; "
              f"launches {counts}")

    # The mixed body's shapes (register, matrix and Rader plans) forced onto
    # the cluster body, and other splits of the real sizes: the same bits. A
    # nested plan (one block's only) is refused there, before any launch.
    y30 = torch.from_numpy(signals[0][1]).to(dev)
    forced, refused = [], []
    for n_fft, hop, _ in MIXED_SHAPES:
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False)
        src, n_frames = frame_source(y30, cfg)
        if mixed_plan(n_fft).nested:
            before = _logmel_counts()
            try:
                _launch_cluster(src, hop, n_frames, n_fft, cfg, ctas=CLUSTER_FORCED[0])
            except ValueError:
                refused.append((n_fft, hop))
            check(refused[-1:] == [(n_fft, hop)] and _logmel_counts() == before,
                  f"cluster body forced to the nested plan of {n_fft}/{hop}: not refused")
            continue
        want = _launch_mixed(src, hop, n_frames, n_fft, cfg)
        for c in CLUSTER_FORCED:
            got = _launch_cluster(src, hop, n_frames, n_fft, cfg, ctas=c)
            check(torch.equal(got, want),
                  f"cluster body forced to {n_fft}/{hop} ({_plan_text(mixed_plan(n_fft))}) at "
                  f"C {c}: not the mixed body's bits")
        forced.append((n_fft, hop))
    print(f"[kernel A cluster] the mixed body's shapes {forced} (register, matrix and Rader "
          f"plans) on the 30 s bucket at C {CLUSTER_FORCED}: bitwise equal to the mixed body; "
          f"the nested plans of {refused} refused, nothing launched")
    for n_fft, splits in CLUSTER_SPLITS.items():
        hop = dict(CLUSTER_SHAPES)[n_fft]
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
        src, n_frames = frame_source(torch.from_numpy(bucket_signal(pcm, cfg)).to(dev), cfg)
        want = fused_log_mel(src, cfg)
        for c in splits:
            check(torch.equal(_launch_cluster(src, hop, n_frames, n_fft, cfg, ctas=c), want),
                  f"cluster {n_fft}/{hop} at C {c}: bits differ from C {cluster_size(n_fft)}")
        print(f"[kernel A cluster] n_fft {n_fft} hop {hop}, {n_frames} frames: bitwise equal at "
              f"C {splits} (default {cluster_size(n_fft)})")

    timed = {}
    for n_fft, hop in CLUSTER_SHAPES:
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
        y = bucket_signal(pcm, cfg)
        yt = torch.from_numpy(y).to(dev)
        n_frames = 1 + (len(y) - n_fft) // hop
        kernel = lambda: fused_log_mel(yt, cfg)  # noqa: E731
        lib = _library_logmel(yt, cfg)
        plan, sp = mixed_plan(n_fft), cluster_split(n_fft, cluster_size(n_fft))
        plain_err = _check_plain_bits(f"timed {n_fft}", kernel(), mixed_log_mel_plain(yt, cfg),
                                      plan)
        ms, cold = cuda_ms(kernel), cuda_ms_cold(kernel)
        lib_ms = cuda_ms(lib)
        plain = cuda_ms(lambda: mixed_log_mel_plain(yt, cfg), reps=2, warmup=1)
        bnd, by, flops, nbytes = logmel_bound(len(y), n_frames, cfg)
        measured = {}
        split = split_line(bnd, measured, kernel=kernel, library=lib)
        src, _ = frame_source(yt, cfg)
        turns = _plan_turns(src, hop, n_frames, n_fft, cfg, check_bits=False)
        blue = turns.get("bluestein")
        point_stages = n_frames * plan.n * len(plan.radices) * (2 if plan.bluestein else 1)
        atol, why = _plain_tolerance(plan)
        print(f"[kernel A cluster] n_fft {n_fft} hop {hop}, {n_frames} frames "
              f"({len(y) / SR:.1f} s padded; {_plan_text(plan)}), C {sp.ctas}: kernel "
              f"{ms:.4f} ms warm L2, {cold:.4f} ms cold L2; torch.stft+mel {lib_ms:.4f} ms "
              f"(x{lib_ms / ms:.2f}, {'faster' if ms <= lib_ms else 'slower'}); "
              + (f"its Bluestein plan in turns {blue['ms']} ms (this plan "
                 f"{turns['chosen']['ms']}, x"
                 f"{np.mean(blue['ms']) / np.mean(turns['chosen']['ms']):.2f}); " if blue else "") +
              f"other plans in turns: {_turns_text(turns)}; "
              f"mixed_log_mel_plain {plain:.4f} ms (tolerance {atol:g}, {why}: max|diff| "
              f"{plain_err:.3g}); bound {bnd:.4f} ms ({by}, rFFT+power+sparse "
              f"mel {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), kernel at {bnd / ms:.4f} of "
              f"its bound; {point_stages:,} frame-point-stages, {ms * 1e9 / point_stages:.2f} ps "
              f"each")
        print(f"[kernel A cluster] n_fft {n_fft} hop {hop}, {split}")
        matrix = (_matrix_line(f"[kernel A cluster] n_fft {n_fft} hop {hop}", plan, yt, cfg,
                               n_frames, kernel, lib) if plan.tensor_cores else {})
        timed[n_fft] = {**matrix, "ms": ms, "cold_ms": cold, "device_ms": measured["kernel"][0],
                        "host_ms": measured["kernel"][1], "plain_ms": plain, "bound_ms": bnd,
                        "bound_by": by, "library_ms": lib_ms, "ctas": sp.ctas,
                        "cross_stages": sum(sp.cross), "stages": len(sp.cross),
                        "radices": list(plan.radices), "kinds": list(plan.kinds),
                        "rader": list(plan.rader), "plain_atol": atol, "plain_atol_reason": why,
                        "plain_max_abs_err": plain_err,
                        "bluestein_ms": blue["ms"] if blue else None,
                        "plan_ms": turns["chosen"]["ms"]}
    by_c = {}
    for n_fft, hop, small, other in CLUSTER_TURNS:
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, center=False, log_floor=1e-10)
        src, n_frames = frame_source(torch.from_numpy(bucket_signal(pcm, cfg)).to(dev), cfg)
        check(cluster_size(n_fft) == small, f"{n_fft}: cluster size {cluster_size(n_fft)}")
        turns = [[c, sum(cluster_split(n_fft, c).cross),
                  cuda_ms(lambda c=c: _launch_cluster(src, hop, n_frames, n_fft, cfg, ctas=c),
                          reps=10)]
                 for c in (small, other, other, small)]
        by_c[f"{n_fft}/{hop}"] = turns
        print(f"[kernel A cluster] n_fft {n_fft} hop {hop}, {n_frames} frames, by cluster "
              f"size in turns [C, stages crossing, ms]: {turns}")

    # The main path: `frontend.extract` of the 120 s file at 25734 (n_fft %
    # 4 = 2: the exact route) and at 44100 (hop n_fft / 2: the chunked
    # route), against the fft backend.
    launches = 0
    for n_fft, hop, kind in ((25734, 12867, "exact"), (44100, 22050, "chunked")):
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, backend="kernel")
        _reset_logmel_counts()
        got = frontend.extract(pcm, cfg, device=dev)
        torch.cuda.synchronize()
        counts = _logmel_counts()
        want_counts = {"chunked": 0, "framed": 0, "exact": 0, "mixed": 0, "cluster": 1, kind: 1}
        check(counts == want_counts, f"extract at n_fft {n_fft} launches {counts}")
        launches += counts["cluster"]
        err = _check_logmel(f"extract n_fft {n_fft} kernel vs fft", got,
                            frontend.extract(pcm, dataclasses.replace(cfg, backend="fft"),
                                             device=dev))
        worst = max(worst, err)
        print(f"[kernel A cluster] main path: frontend.extract of the {len(pcm) / SR:.0f} s file "
              f"at n_fft {n_fft} hop {hop}: {tuple(got.shape)}, launches {counts}, vs the fft "
              f"backend max|diff| {err:.3g}")
    print(f"[kernel A cluster] phase in {time.perf_counter() - t0:.1f} s")
    main = timed[25734]
    entry = {"name": "fused_logmel_cluster", "route": "cuda",
             "source": "sed_crnn_torch/csrc/logmel_cluster.cu", "replaces": TPU_LOGMEL_SITES,
             "max_abs_err": worst, "plain_max_abs_err": worst_plain,
             **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             "shape": "n_fft 25734 hop 12867, 150 s padded",
             "shapes": {f"{n}/{h}": timed[n] for n, h in CLUSTER_SHAPES},
             "ms_by_ctas": by_c}
    return entry, launches


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
    want = {"chunked": 2 * len(names), "framed": 4 * len(names), "exact": 0, "mixed": 0,
            "cluster": 0}
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


def phase_feature_multires(workdir: str) -> int:
    """`apps/feature.py --multires 1764 3072 --backend kernel` on the
    feature phase's synthetic DCASE layout, into its own cache: window sizes
    that are not powers of two (40 ms at 44.1 kHz, and 3072), each a framed
    launch on the mixed body, exactly 4 per file and none on the cluster body;
    per-file features within 5e-4 of ``--backend fft``. Returns the mixed
    launches."""
    import torch

    from sed_crnn_torch.apps import feature
    from sed_crnn_torch.data import store

    root = os.path.join(workdir, "dcase")
    n_files = len([f for f in os.listdir(os.path.join(root, "audio", "street"))
                   if f.endswith(".wav")])
    args = ["--dcase-root", root, "--multires", "1764", "3072", "--folds", "1", "2",
            "--device", "cuda"]
    cache = os.path.join(workdir, "cache_multires")
    _reset_logmel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = _quiet(feature.main, args + ["--cache-dir", cache, "--backend", "kernel"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _logmel_counts()
    want = {"chunked": 0, "framed": 4 * n_files, "exact": 0, "mixed": 4 * n_files, "cluster": 0}
    check(launches == want, f"--multires 1764 3072 launches {launches} != {want}")
    fft_cache = os.path.join(workdir, "cache_multires_fft")
    _quiet(feature.main, args + ["--cache-dir", fft_cache, "--backend", "fft"])
    per_file = sorted(f for f in os.listdir(cache) if f.endswith("_binmul.npz")
                      and not f.startswith("mbe_"))
    check(len(per_file) == n_files, f"{len(per_file)} per-file caches for {n_files} files")
    worst = 0.0
    for f in per_file:
        x, y = store.load_video_features(os.path.join(cache, f))
        fx, fy = store.load_video_features(os.path.join(fft_cache, f))
        check(x.shape == fx.shape and x.shape[1] == 4 * 40 and np.array_equal(y, fy),
              f"multires {f}: shapes {x.shape} / {fx.shape} or labels")
        fin = np.isfinite(fx)
        check(np.array_equal(np.isfinite(x), fin), f"multires {f}: -inf pattern vs fft")
        err = float(np.abs(x[fin] - fx[fin]).max())
        check(err <= LOGMEL_ATOL, f"multires {f}: kernel vs fft backend {err}")
        worst = max(worst, err)
    print(f"[feature] --multires 1764 3072 --backend kernel: {n_files} files in {wall:.2f} s "
          f"host clock, launches {launches} (per file 2 channels x 2 sizes, framed, all on the "
          f"mixed body); features {x.shape[1]} a frame, vs --backend fft max|diff| {worst:.3g} "
          f"over {len(per_file)} files, -inf patterns and labels equal; {out[-1]}")
    return launches["mixed"]


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


def _stack_operands(rng, dev, S: int, B: int, T: int, H: int, w: float | None = None):
    """Both directions' (xp, wh, bh, h0, dys, dhl), each with a leading seed
    axis, on the card; wh ``w`` N(0, 1), by default 0.3 up to H=32 and
    0.3 sqrt(32 / H) above, so that the recurrent pre-activations keep
    H=32's spread. (At 0.3 and H=128 the recurrence carries a one-ulp
    change of its input to ~5e-5, so no float32 version, the plain one
    included, is within GRU_ATOL of another: `_wide_precision` holds the
    wide body to float64 there.)"""
    import torch

    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    w = 0.3 * min(1.0, (32.0 / H) ** 0.5) if w is None else w
    return [(t(rng.standard_normal((S, B, T, 3 * H))), t(w * rng.standard_normal((S, H, 3 * H))),
             t(0.1 * rng.standard_normal((S, 3 * H))), t(0.5 * rng.standard_normal((S, B, H))),
             t(rng.standard_normal((S, B, T, H))), t(rng.standard_normal((S, B, H))))
            for _ in range(2)]


def _gru_bounds(S: int, B: int, T: int, H: int, reset_after: bool, n_dirs: int = 2):
    """The least work of S seeds x ``n_dirs`` directions of the forward, the
    residual forward and the backward (chain + dwh), as `phase_gru_train`
    counts it per direction: (fwd, fwd_res, bwd) each (ms, what bounds it)."""
    f, n, RW = 4, n_dirs * S, (4 if reset_after else 3) * H
    fwd_b = f * (B * T * 3 * H + H * 3 * H + 3 * H + 2 * B * H + B * T * H)
    fwd_f = T * B * (2 * H * 3 * H + 12 * H)
    bwd_b = f * (B * T * H + B * T * RW + H * 3 * H + 2 * B * H + B * T * H
                 + B * T * 3 * H + H * 3 * H + 3 * H + B * H)
    bwd_f = T * B * (2 * 2 * H * 3 * H + 20 * H)
    return (bound_ms(n * fwd_b, n * fwd_f), bound_ms(n * (fwd_b + f * B * T * RW), n * fwd_f),
            bound_ms(n * bwd_b, n * bwd_f))


def _stack_kernel_checks(shapes=None, tag: str = "[multiseed stacked]", seed: int = 13):
    """Kernel B's stacked entry points against their plain versions seed by
    seed at ``shapes`` (default STACK_SHAPES), both conventions: one launch
    per kernel per call, the forward bands, gradients and dwh within
    GRAD_RTOL, dwh bitwise equal from run to run, seed 0 bitwise equal to
    the unstacked pair on its operands. Returns the worst errors."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import (
        gru_body,
        gru_dwh_plain,
        gru_scan_bwd_plain,
        gru_scan_fwd_res_plain,
        gru_scan_pair_bwd,
        gru_scan_pair_fwd_res,
        gru_scan_stack,
        gru_scan_stack_bwd,
        gru_scan_stack_fwd_res,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    worst = {"fwd": 0.0, "bwd": 0.0, "dwh": 0.0}
    for S, B, T, H in shapes or STACK_SHAPES:
        one = _gru_path_counts(1, 1, gru_body(H), (H,))
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
            first = lambda i: tuple(None if a is None else a[0].contiguous() for a in arg(i))  # noqa: E731
            pres = gru_scan_pair_fwd_res(first(0), first(1), first(2), first(3), reset_after,
                                         "sigmoid")
            pbwd = gru_scan_pair_bwd(tuple(r[0] for r in pres), tuple(r[1] for r in pres),
                                     first(1), first(3), first(4), first(5), reset_after, "sigmoid")
            for k in (0, 1):
                check(all(torch.equal(a, b[0]) for a, b in zip(pres[k] + pbwd[k],
                                                               res[k] + bwd[k])),
                      f"stacked S={S} H={H}: seed 0 is not bitwise the unstacked pair")
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
        print(f"{tag} kernel B stacked S={S} B={B} T={T} H={H:2d} ({gru_body(H)} body): forward, "
              f"residual forward, backward and dwh, both conventions, one launch each for "
              f"{2 * S} (seed, direction) pairs; against the plain versions seed by seed; seed 0 "
              f"bitwise the unstacked pair")
    print(f"{tag} kernel B stacked worst: forward max|diff| {worst['fwd']:.3g}, "
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
    seeds, and one `Trainer` step per seed, each returning the seeds' losses
    (S,). The two draw from generators of their own with the same seeds, so
    their n-th calls see the same batches and dropout masks."""
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
    rngs, seq_rngs = ([Rngs(dev, s, stacked.model.n_dropout_sites) for s in range(n_seeds)]
                      for _ in range(2))
    st = TrainState(stacked.adam.init({k: p.detach() for k, p in stacked.params().items()}),
                    torch.ones(n_seeds, device=dev))
    singles = [Trainer(mm.to(dev), cfg.train, tr, val) for mm in models]
    sts = [TrainState(t.adam.init({k: p.detach() for k, p in t.params().items()}), 1.0)
           for t in singles]

    def stacked_step():
        nonlocal st
        x, y = stacked.draw_batch(tr, [r.batch for r in rngs])
        st, losses, _ = stacked.train_step(st, x, y, [r.dropout for r in rngs])
        return losses

    def sequential_steps():
        losses = []
        for i, (t, r) in enumerate(zip(singles, seq_rngs)):
            x, y = tr.sample_batch(r.batch, batch)
            sts[i], loss, _ = t.train_step(sts[i], x, y, r.dropout)
            losses.append(loss)
        return torch.stack(losses)

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
    makes while it is installed (the handler threads share it), the kinds of
    framer made, and the framers closed with their C handle freed."""

    def __init__(self, serve_app):
        self.app, self.real = serve_app, serve_app.make_framer
        self.blocks = self.made = self.freed = 0
        self.kinds: set = set()
        self._lock = threading.Lock()

    def __enter__(self):
        counter = self

        class Counting:
            def __init__(self, *args):
                self.inner = counter.real(*args)
                with counter._lock:
                    counter.made += 1
                    counter.kinds.add(type(self.inner).__name__)

            def _count(self, frames):
                if frames.shape[0]:
                    with counter._lock:
                        counter.blocks += 1
                return frames

            def feed(self, pcm):
                return self._count(self.inner.feed(pcm))

            def flush(self):
                return self._count(self.inner.flush())

            def close(self):
                self.inner.close()
                with counter._lock:
                    counter.freed += getattr(self.inner, "_h", 0) is None

        self.app.make_framer = Counting
        return self

    def __exit__(self, *exc):
        self.app.make_framer = self.real

    def check_native(self, tag: str) -> None:
        """Every framer of the run was the C++ one, and every one was closed
        with its handle freed."""
        check(self.kinds == {"StreamingFramer"} and self.freed == self.made > 0,
              f"{tag}: framers {sorted(self.kinds)}, {self.made} made, {self.freed} freed")


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
    from sed_crnn_torch.utils import native

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
    check(logmel == {"chunked": 2, "framed": 0, "exact": 0, "mixed": 0, "cluster": 0},
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
    check(logmel == {"chunked": 0, "framed": blocks.blocks, "exact": 0, "mixed": 0,
                     "cluster": 0},
          f"serve_stream kernel A launches {logmel} vs {blocks.blocks} framer blocks")
    check(gru == _gru_path_counts(2 * n_steps, 0) and not plain_on_card,
          f"serve_stream kernel B launches {gru}")
    blocks.check_native("serve_stream")
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
    check(logmel == {"chunked": 0, "framed": blocks.blocks, "exact": 0, "mixed": 0,
                     "cluster": 0},
          f"daemon kernel A launches {logmel} vs {blocks.blocks} framer blocks")
    blocks.check_native("daemon")
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
    print(f"[serve] daemon --max-streams {SERVE_STREAMS} (C++ StreamingFramer, "
          f"{blocks.made} made and freed), {SERVE_STREAMS} clients sending the "
          f"{len(pcm) / SR:.0f} s wav at once: {ticks} ticks, {stepped} chunk steps, "
          f"{stepped / ticks:.2f} streams per tick; per-step p50 {p50:.2f} ms (median over "
          f"clients) p99 {p99:.2f} ms (max); wall {run['wall']:.2f} s -> {rate:,.0f} "
          f"audio-sec/sec; device busy {busy} in a profiled repeat, idle share {idle}; every "
          f"client's event lines equal serve_stream's; launches {gru['gru_scan_fwd']} pair "
          f"forwards (2 x ticks), {logmel['framed']} framed (= framer blocks); with the numpy "
          f"framer the daemon read 220-268 audio-sec/sec, p50 18.81-24.80 ms, idle share "
          f"0.975-0.980 (PERF.md section 5)")

    # The same daemon on the numpy framer, in turns with the C++ one (the
    # run above was the first C++ turn): aggregate rate, p50, p99.
    turns = {"StreamingFramer": [(rate, p50, p99)], "PythonFramer": []}
    for kind in ("PythonFramer", "StreamingFramer", "PythonFramer"):
        with mock.patch.object(serve_app, "make_framer", getattr(native, kind)):
            r = _serve_daemon(serve_app, art_path, pcm)
        turns[kind].append((SERVE_STREAMS * len(pcm) / SR / r["wall"],
                            float(np.median([g[-1]["step_ms_p50"] for g in r["lines"]])),
                            float(max(g[-1]["step_ms_p99"] for g in r["lines"]))))
    print("[serve] daemon in turns (C++, numpy, C++, numpy): " + "; ".join(
        f"{k} " + ", ".join(f"{a:,.0f} audio-sec/sec (p50 {b:.2f}, p99 {c:.2f} ms)"
                            for a, b, c in v) for k, v in turns.items()))

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
    framer.close()
    live_rows = frontend.log_mel_from_frames(torch.from_numpy(frames).to(dev),
                                             dataclasses.replace(fe, backend="kernel"))
    rows_equal = bool(torch.equal(live_rows, mel))
    rows_err = 0.0 if rows_equal else _maxdiff(live_rows, mel)
    check(rows_equal and type(framer).__name__ == "StreamingFramer",
          f"live rows ({type(framer).__name__}) vs offline rows: {rows_err}")
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
        else 1 - prof["busy"] / run["wall"], "serve_live_rows_bitwise": rows_equal,
        "serve_rate_turns": {k: [t[0] for t in v] for k, v in turns.items()}}


# Kernel B's wide body (csrc/gru_wide.cu, H > 32): the widths, batches and
# timed shapes of [kernel B wide], and the three full-width paths' configs.
IMPORT_BATCH = 128       # windows of 64 x 40 in the forward parity and its times
# The port's forward from an imported checkpoint against the reference class
# on the card: cuDNN's convolutions on both sides, cuDNN's GRU against kernel
# B (float32, sums in another order), before a head that scales logits x4.
IMPORT_ATOL = 1e-4
IMPORT_FRAMES = 3000     # the fine-tune's synthetic train split: a few steps of 128


def phase_import(workdir: str, pcm: np.ndarray):
    """[import]: checkpoint migration on the card. The reference's v1 and v2
    classes (`reference_model`, full width, seeded) saved as a raw
    ``state_dict`` and as a Lightning ``.ckpt`` (pickled hyper-parameters:
    the full-unpickle path), imported by ``apps.import_torch.main``; their
    forward at B=128 against the port's `CRNN` from the imported npz (v2 at
    float32; the preset's bf16 trunk for its launches), one pair launch per
    BiGRU layer; the imported v1 served by `_serve_card_and_cpu`; fine-tuned
    by ``run_fold(resume_from=...)`` for one epoch, exact launch counts; both
    exported by ``apps.export_weights.main`` (naming v1, v2) and reloaded
    with ``strict=True`` into fresh reference classes, bitwise; times of the
    forwards and of kernel B's pair at (B 128, T 8, H 32, reset_after=True)
    beside one bidirectional ``torch.nn.GRU`` layer and the bound."""
    import argparse
    import warnings

    import torch

    from sed_crnn_torch.apps import export_weights, import_torch
    from sed_crnn_torch.apps.train import synthetic_folds
    from sed_crnn_torch.core.checkpoint import load_checkpoint
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.data.wavio import write_wav
    from sed_crnn_torch.models.convert import load_model
    from sed_crnn_torch.ops.kernels.gru_scan import gru_scan_pair, gru_scan_plain
    from sed_crnn_torch.train.loop import make_samplers, run_fold

    t_phase = time.perf_counter()
    os.makedirs(workdir)
    dev = torch.device("cuda")
    presets = {"v1": "timepooled-v1", "v2": "timepooled-v2"}
    # v1's seed: its nearest logit to the threshold on the served file is 0.08,
    # 80x LOGIT_ATOL, so that card-vs-CPU rounding cannot move an event edge.
    refs = {"v1": reference_model("v1", 42), "v2": reference_model("v2", 32)}
    originals = {v: {k: t.clone() for k, t in m.state_dict().items()} for v, m in refs.items()}
    src = {"v1": os.path.join(workdir, "v1_state_dict.pt"),
           "v2": os.path.join(workdir, "v2_lightning.ckpt")}
    torch.save(originals["v1"], src["v1"])
    torch.save({"state_dict": {f"model.{k}": t for k, t in originals["v2"].items()},
                "hyper_parameters": argparse.Namespace(lr=1e-3, fold_id=1, batch_size=128),
                "epoch": 41}, src["v2"])
    npz = {v: os.path.join(workdir, f"imported_{v}.npz") for v in presets}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for v, preset in presets.items():
            import_torch.main(["--torch-ckpt", src[v], "--preset", preset, "--out", npz[v]])
    unpickle = [w for w in caught if "FULL unpickle" in str(w.message)]
    check(len(unpickle) == 1, f"the Lightning file takes the full-unpickle path once: {caught}")

    # Forward parity on the card: the reference class (cuDNN conv and GRU)
    # against the port's model from the imported npz.
    rng = np.random.default_rng(33)
    xt = torch.from_numpy(rng.standard_normal((IMPORT_BATCH, 64, 40)).astype(np.float32)).to(dev)
    x_ref = xt.transpose(1, 2)[:, None].contiguous()     # (B, 1, 40, 64), the reference's
    numbers, fwd_launches = {}, 0
    for v, preset in presets.items():
        mcfg = dataclasses.replace(get_preset(preset).model, compute_dtype="float32")
        tree, meta = load_checkpoint(npz[v])
        check(meta["preset"] == preset and meta["epoch"] == 0, f"{v} metadata {meta}")
        model, ref = load_model(tree, mcfg, dev), refs[v].to(dev)
        _reset_gru_counts()
        with torch.no_grad(), _no_plain_gru_on_card() as plain_on_card:
            got = model(xt)[0]
            torch.cuda.synchronize()
        counts = _gru_counts()
        want_counts = _gru_path_counts(len(mcfg.gru_hidden), 0)
        check(counts == want_counts, f"[import] {v} forward launches {counts} != {want_counts}")
        check(not plain_on_card, f"[import] a GRU plain version ran on the card: {plain_on_card}")
        fwd_launches += counts["gru_scan_fwd"]
        with torch.no_grad():
            want = ref(x_ref)
        check(got.shape == want.shape == (IMPORT_BATCH, 8, 1), f"{v} logits {tuple(got.shape)}")
        err = float((got - want).abs().max())
        check(err <= IMPORT_ATOL, f"[import] {v} port vs reference class on the card: {err}")
        with torch.no_grad():
            ref_ms = cuda_ms(lambda: ref(x_ref), reps=20)
            port_ms = cuda_ms(lambda: model(xt), reps=20)
            split = _by_kernel(lambda: model(xt))
        numbers[v] = {"ref_ms": ref_ms, "port_ms": port_ms}
        top = ", ".join(f"{k[:48]} {ms:.4f}" for k, ms in
                        sorted(split.items(), key=lambda kv: -kv[1])[:3])
        line = (f"[import] {v} ({preset}, full width, float32) B={IMPORT_BATCH}: port vs "
                f"reference class max|diff| {err:.3g} (|logit| up to "
                f"{float(want.abs().max()):.3g}); whole forward: reference class (cuDNN GRU) "
                f"{ref_ms:.4f} ms, port {port_ms:.4f} ms (device-busy "
                f"{sum(split.values()):.4f} ms, kernel B {_part(split, 'gru_warp'):.4f}; "
                f"largest: {top})")
        if v == "v2":
            # The preset's own bf16 trunk: launches, and its distance from float32.
            bf16 = load_model(tree, get_preset(preset).model, dev)
            _reset_gru_counts()
            with torch.no_grad(), _no_plain_gru_on_card() as plain_on_card:
                got16 = bf16(xt)[0]
                torch.cuda.synchronize()
            counts = _gru_counts()
            check(counts == want_counts and not plain_on_card,
                  f"[import] v2 bf16 forward launches {counts} != {want_counts}")
            fwd_launches += counts["gru_scan_fwd"]
            check(bool(torch.isfinite(got16).all()), "[import] v2 bf16 logits not finite")
            with torch.no_grad():
                bf16_ms = cuda_ms(lambda: bf16(xt), reps=20)
            line += (f"; the preset's bf16 trunk {bf16_ms:.4f} ms, "
                     f"{float((got16 - got).abs().max()):.3g} from float32")
        print(line)

    # Serve the imported v1: the 120 s wav through infer_file and the
    # kernel-frontend composition, card and CPU.
    wav = os.path.join(workdir, "tones_120s.wav")
    write_wav(wav, pcm, SR)
    serve_launches, _, _ = _serve_card_and_cpu("[import]", wav, npz["v1"], presets["v1"], pcm)

    # Fine-tune the imported v1 for one epoch on synthetic folds at full width.
    cfg = get_preset(presets["v1"])
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_epochs=1, plot_every=0))
    fold = synthetic_folds(1, frames=IMPORT_FRAMES, n_classes=cfg.model.n_classes)[1]
    tr, val = make_samplers(cfg, fold, dev)
    n_train = tr.steps_per_epoch(cfg.train.batch_size)
    n_val = max(1, val.steps_per_epoch(cfg.train.batch_size, drop_last=False))
    check(n_train >= 2, f"fine-tune split gives {n_train} steps")
    art = os.path.join(workdir, "finetune")
    _reset_gru_counts()
    _reset_logmel_counts()
    t0 = time.perf_counter()
    with _no_plain_gru_on_card() as plain_on_card:
        res = run_fold(cfg, fold, 1, art, resume_from=npz["v1"], device="cuda", verbose=False)
        torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    tune = _gru_counts()
    want_counts = _gru_path_counts(2 * n_val, 2 * n_train)
    check(tune == want_counts, f"[import] fine-tune launches {tune} != {want_counts}")
    check(not any(_logmel_counts().values()), f"fine-tune log-mel launches {_logmel_counts()}")
    check(not plain_on_card, f"[import] a GRU plain version ran on the card: {plain_on_card}")
    check(res.epochs_run == 1 and all(np.isfinite(res.history[k][0])
                                      for k in ("loss_tr", "loss_val")),
          f"fine-tune history {res.history}")
    tuned, _ = load_checkpoint(os.path.join(art, "last_fold1.npz"))
    imported, _ = load_checkpoint(npz["v1"])
    moved = max(float(np.abs(a - b).max()) for (_, a), (_, b) in
                zip(_leaves(tuned["params"]), _leaves(imported["params"])))
    check(int(tuned["opt_state"]["step"]) == n_train and moved > 0,
          f"fine-tuned checkpoint: step {tuned['opt_state']['step']}, moved {moved}")
    print(f"[import] run_fold(resume_from=imported v1), 1 epoch x {n_train} steps at batch "
          f"{cfg.train.batch_size}, {n_val} validation steps, in {tune_s:.2f} s: loss_tr "
          f"{res.history['loss_tr']}, loss_val {res.history['loss_val']}; parameters moved up "
          f"to {moved:.3g}; launches {tune}")

    # Export both imports back and reload them into fresh reference classes.
    for v, preset in presets.items():
        out = os.path.join(workdir, f"exported_{v}.pt")
        export_weights.main(["--checkpoint", npz[v], "--preset", preset, "--naming", v,
                             "--out", out])
        fresh = reference_model(v, 34)
        fresh.load_state_dict(torch.load(out, map_location="cpu", weights_only=True), strict=True)
        back = fresh.state_dict()
        check(list(back) == list(originals[v]), f"[import] {v} export key order")
        for k, t in originals[v].items():
            if k.endswith("num_batches_tracked"):
                check(back[k].dtype == torch.int64 and int(back[k]) == 0, f"{v} {k}")
            else:
                check(back[k].dtype == t.dtype and torch.equal(back[k], t),
                      f"[import] {v} exported {k} differs from the original")
        print(f"[import] {v} exported (naming {v}) and strict-loaded into a fresh reference "
              f"class: {len(back)} tensors, every parameter and running statistic bitwise the "
              f"original (num_batches_tracked 0)")

    # Kernel B's pair at the imported models' shape against one bidirectional
    # torch.nn.GRU layer on the same input.
    B, T, H = IMPORT_BATCH, 8, 32
    d0, d1 = (_gru_inputs(rng, dev, B, H, T=T, wh_std=H ** -0.5) for _ in range(2))
    x = d0[0]
    args = ((x, x), (d0[1], d1[1]), (d0[2], d1[2]), (d0[3], d1[3]))
    pair = lambda: gru_scan_pair(*args, True, "sigmoid")  # noqa: E731
    lib = _library_gru((d0[1], d1[1]), (d0[2], d1[2]), bidirectional=True)
    h_lib = torch.stack([d0[3], d1[3]])
    with torch.no_grad():
        got = pair()
        y_lib, hl_lib = lib(x, h_lib)
    err = lib_err = 0.0
    for k, rev in enumerate((False, True)):
        want = gru_scan_plain(x, args[1][k], args[2][k], args[3][k], True, "sigmoid", rev)
        err = max(err, _maxdiff(got[k][0], want[0]), _maxdiff(got[k][1], want[1]))
        lib_err = max(lib_err, _maxdiff(y_lib[..., k * H:(k + 1) * H], want[0]),
                      _maxdiff(hl_lib[k], want[1]))
    check(err <= GRU_ATOL, f"[import] pair at B={B} T={T}: {err}")
    check(lib_err <= LIBRARY_ATOL, f"[import] bidirectional torch.nn.GRU at B={B} T={T}: {lib_err}")
    with torch.no_grad():
        pair_ms = cuda_ms(pair, reps=50)
        lib_ms = cuda_ms(lambda: lib(x, h_lib), reps=50)
        pair_dev, pair_host = device_host_ms(pair)
        lib_dev, lib_host = device_host_ms(lambda: lib(x, h_lib))
    plain_ms = cuda_ms(lambda: [gru_scan_plain(x, args[1][k], args[2][k], args[3][k], True,
                                               "sigmoid", k == 1) for k in (0, 1)], reps=5)
    (bnd, by), _, _ = _gru_bounds(1, B, T, H, True)
    print(f"[import] kernel B pair forward at B={B} T={T} H={H} reset_after=True: "
          f"{pair_ms:.4f} ms (vs plain {err:.3g}), bidirectional torch.nn.GRU {lib_ms:.4f} ms "
          f"(vs plain {lib_err:.3g}), plain {plain_ms:.4f} ms, bound {bnd:.6f} ms ({by}); "
          f"device-busy / host issue per call: pair {_fmt(pair_dev)} / {pair_host:.4f} ms, "
          f"library {_fmt(lib_dev)} / {lib_host:.4f} ms; phase in "
          f"{time.perf_counter() - t_phase:.1f} s")
    launches = {"fused_logmel": serve_launches["fused_logmel"],
                "gru_scan_fwd": fwd_launches + serve_launches["gru_scan_fwd"] + tune["gru_scan_fwd"],
                **{k: tune[k] for k in ("gru_scan_fwd_res", "gru_scan_bwd", "gru_dwh")}}
    entry = {"import_shape": f"pair B={B} T={T} H={H} reset_after=True", "import_ms": pair_ms,
             "import_plain_ms": plain_ms, "import_library_ms": lib_ms, "import_bound_ms": bnd,
             "import_bound_by": by, "import_max_abs_err": err, "import_device_ms": pair_dev,
             "import_host_ms": pair_host,
             **{f"import_{v}_forward_ms": n["port_ms"] for v, n in numbers.items()},
             **{f"import_{v}_reference_ms": n["ref_ms"] for v, n in numbers.items()}}
    return launches, entry


# Kernel B above the warp body: the wide body's register tier to H = 128,
# the cluster body (csrc/gru_cluster.cu) to CLUSTER_MAX_H = 512, the grid
# body (csrc/gru_grid.cu) above: weights resident to GRID_RESIDENT_MAX_H =
# 1056 (520, 768, 1024), streamed at 1536 and 2048.
WIDE_WIDTHS = (33, 48, 64, 96, 128, 129, 256, 512, 520, 768, 1024, 1536, 2048)
WIDE_BATCHES = (1, 8, 128)
WIDE_CHECK_T = 64
WIDE_TIMED = (64, 128)     # the wide body's register tier; H = 256 in `_cluster_times`
CLUSTER_TIMED = 256        # the cluster body in turns with the library
GRID_TIMED = (1024, 2048)  # the grid body in turns with the library (2048 at B = 128 only)
WIDE_STACK_SHAPES = [(5, 8, 32, H) for H in (48, 64, 128, 129, 256, 520, 1024)]
GRID_FORCED_K = (40, 66)   # a pair's CTAs a direction forced: other units a CTA, same bits
GRID_WIDEST = 8449         # the first width whose pair's CTAs hold 256 units in one block
GRID_TWO_BLOCKS = 16897    # a pair one unit wider than 66 CTAs x 256 units: two blocks a CTA
WIDE_SEDNET = {"gru_hidden": (128, 128)}   # SELDnet's (DCASE 2019 Task 3) recurrent width
CLUSTER_SEDNET = {"gru_hidden": (256, 256)}   # the cluster body's full-width paths
GRID_SEDNET = {"gru_hidden": (1024, 1024)}    # the grid body's full-width paths
WIDE_V2 = {"gru_hidden": (64, 64)}
# Its operands scale wh by 1 / sqrt(H), so that the pre-activations keep one
# spread at every width.


def _body_of(H: int) -> str:
    """The body that serves width H above the warp body, by the tier rule."""
    from sed_crnn_torch.ops.kernels.gru_scan import CLUSTER_MAX_H, REGISTER_MAX_HIDDEN

    return "wide" if H <= REGISTER_MAX_HIDDEN else "cluster" if H <= CLUSTER_MAX_H else "grid"


def _wide_checks() -> dict:
    """The wide, cluster and grid bodies' pair launches against the plain
    versions at every width of WIDE_WIDTHS (each on the body `gru_body`
    gives it) and batch of WIDE_BATCHES, both conventions, both gates: one
    launch of each kernel, forwards within GRU_ATOL, gradients and dwh (also
    on the kernel's own dxp) within GRAD_RTOL, the backward bitwise equal
    run to run; each shape's plan held against the Python mirror. Returns
    the worst errors by body."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import (
        GATES,
        gru_body,
        gru_dwh_plain,
        gru_scan_bwd_plain,
        gru_scan_fwd_res_plain,
        gru_scan_pair,
        gru_scan_pair_bwd,
        gru_scan_pair_fwd_res,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    worst = {b: {"fwd": 0.0, "bwd": 0.0, "dwh": 0.0} for b in ("wide", "cluster", "grid")}
    for H in WIDE_WIDTHS:
        body = _body_of(H)
        check(gru_body(H) == gru_body(H, backward=True) == body, f"H={H} not on the {body} body")
        want_counts = _gru_path_counts(1, 1, body, (H,))
        for B in WIDE_BATCHES:
            fwd_e = bwd_e = dwh_e = 0.0
            for reset_after in (False, True):
                for gate in GATES:
                    sets = [_gru_inputs(rng, dev, B, H, True, WIDE_CHECK_T, H ** -0.5)
                            for _ in range(2)]
                    args = [_pair_of(sets, i, reset_after) for i in range(4)]
                    _reset_gru_counts()
                    pair = gru_scan_pair(*args, reset_after, gate)
                    pres = gru_scan_pair_fwd_res(*args, reset_after, gate)
                    ys, rs = tuple(r[0] for r in pres), tuple(r[1] for r in pres)
                    grads = gru_scan_pair_bwd(ys, rs, args[1], args[3], _pair_of(sets, 4),
                                              _pair_of(sets, 5), reset_after, gate)
                    torch.cuda.synchronize()
                    counts = _gru_counts()
                    check(counts == want_counts, f"{body} H={H} B={B} launches {counts}")
                    again = gru_scan_pair_bwd(ys, rs, args[1], args[3], _pair_of(sets, 4),
                                              _pair_of(sets, 5), reset_after, gate)
                    for k, rev in enumerate((False, True)):
                        tag = f"{body} H={H} B={B} reset_after={reset_after} {gate} dir {k}"
                        a = [x[k] for x in args]
                        want = gru_scan_fwd_res_plain(*a, reset_after, gate, rev)
                        fwd_e = max(fwd_e, max(_maxdiff(g, w) for g, w in zip(pres[k], want)))
                        check(torch.equal(pair[k][0], pres[k][0])
                              and torch.equal(pair[k][1], pres[k][2]), f"{tag}: fwd vs fwd_res")
                        want = gru_scan_bwd_plain(ys[k], rs[k], a[1], a[3], sets[k][4], sets[k][5],
                                                  reset_after, gate, rev)
                        bwd_e = max(bwd_e, _rel_err(grads[k], want, tag))
                        own = gru_dwh_plain(ys[k], rs[k], a[3], grads[k][0], reset_after, rev)
                        dwh_e = max(dwh_e, _rel_err(grads[k][1:3], own, f"{tag} dwh on own dxp",
                                                    ("dwh", "dbh")))
                        check(all(torch.equal(x, y) for x, y in zip(grads[k], again[k])),
                              f"{tag}: backward not bitwise equal run to run")
            check(fwd_e <= GRU_ATOL, f"{body} H={H} B={B} forward {fwd_e}")
            for key, e in (("fwd", fwd_e), ("bwd", bwd_e), ("dwh", dwh_e)):
                worst[body][key] = max(worst[body][key], e)
            print(f"[kernel B wide] {body} body H={H:4d} B={B:3d} T={WIDE_CHECK_T}"
                  f"{_gru_plan_text(H, B)}: pair forward, residual "
                  f"forward and backward, both conventions and gates, one launch each; fwd "
                  f"max|diff| {fwd_e:.3g}, backward {bwd_e:.3g} and dwh on its own dxp "
                  f"{dwh_e:.3g} of max|grad|; dwh bitwise run to run")
    return worst


def _gru_plan_text(H: int, B: int, n_seed: int = 1) -> str:
    """The cluster or grid body's launch of a pair at (B, H) on this card,
    forward and backward chain, held against the Python mirror: the cluster
    body's C, R and a CTA's threads and shared memory; the grid body's K
    CTAs a direction of U (UP) units, its lanes or tile body and rows a
    pass, ring stages, resident or streamed weights, a CTA's shared memory
    and the CTAs the card holds at once; "" on another body."""
    import torch

    from sed_crnn_torch.ops.kernels import gru_scan as gs

    body = gs.gru_body(H)
    if body == "cluster":
        parts = []
        for backward in (False, True):
            p = gs.cluster_plan(2, n_seed, B, H, backward, with_res=True)
            check(p["smem"] == gs.cluster_smem_bytes(H, p["ctas"], p["rows"], backward),
                  f"cluster plan {p} at H={H} B={B}: shared memory differs from the Python mirror")
            parts.append(f"{'backward' if backward else 'forward'} C {p['ctas']} R {p['rows']} "
                         f"{p['threads']} threads {p['smem']:,} B a CTA")
        return " (" + "; ".join(parts) + ")"
    if body != "grid":
        return ""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib, parts = gs._grid_lib(), []
    for backward in (False, True):
        p = gs.grid_plan_card(2, n_seed, B, H, backward, with_res=True)
        mirror = gs.grid_plan(2, n_seed, B, H, backward, with_res=True, sms=sms)
        check(p == mirror, f"grid plan at H={H} B={B}: card {p} vs Python mirror {mirror}")
        held = lib.gru_grid_resident_ctas(2, B, H, int(backward), 1, 0)
        check(held >= 2 * p["ctas"], f"grid H={H} B={B}: the card holds {held} CTAs at once")
        parts.append(f"{'backward' if backward else 'forward'} K {p['ctas']} x {p['units']} "
                     f"({p['units_padded']}) units, {'lanes' if p['split'] > 1 else 'tile'} "
                     f"{p['rows']} rows a pass, stages {p['stages']}, "
                     f"{'resident' if p['resident'] else 'streamed'}, {p['smem']:,} B a CTA, "
                     f"{held} CTAs held at once")
    return " (" + "; ".join(parts) + ")"


def _wide_times(H: int) -> dict:
    """The wide body at width H, CUDA events, warm L2: one direction's
    forward at B=1 and residual forward and backward (chain + dwh + sum) at
    B=128, T=256, reset_after=False sigmoid (sednet's convention), each held
    against its plain version first, beside the plain version's time, the
    bound, device and host times and the backward's split by kernel; then, at
    reset_after=True sigmoid (the library's convention), one direction's
    residual forward at B=128 beside a one-direction `torch.nn.GRU`, and a
    pair's forward at B=1 and residual forward and backward at B=128 beside a
    bidirectional one on the same input (the library's outputs held against
    the plain versions)."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import (
        gru_scan,
        gru_scan_bwd,
        gru_scan_bwd_plain,
        gru_scan_fwd_res,
        gru_scan_fwd_res_plain,
        gru_scan_pair,
        gru_scan_pair_bwd,
        gru_scan_pair_fwd_res,
        gru_scan_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(22 + H)
    T, BT = GRU_T, TRAIN_BATCH
    out = {"H": H}
    xp, wh, bh, h0, _, _ = _gru_inputs(rng, dev, 1, H, True, T, H ** -0.5)
    conf = (False, "sigmoid", False)
    fwd = lambda: gru_scan(xp, wh, None, h0, *conf)  # noqa: E731
    err = max(_maxdiff(g, w) for g, w in zip(fwd(), gru_scan_plain(xp, wh, None, h0, *conf)))
    check(err <= GRU_ATOL, f"wide H={H} forward B=1: {err}")
    out["fwd_b1_ms"] = cuda_ms(fwd, reps=20)
    out["fwd_b1_plain_ms"] = cuda_ms(lambda: gru_scan_plain(xp, wh, None, h0, *conf), reps=3,
                                     warmup=1)
    out["fwd_b1_device_ms"], out["fwd_b1_host_ms"] = device_host_ms(fwd)
    out["fwd_b1_bound_ms"], out["fwd_b1_bound_by"] = _gru_bounds(1, 1, T, H, False, 1)[0]

    xp, wh, bh, h0, dys, dhl = _gru_inputs(rng, dev, BT, H, True, T, H ** -0.5)
    fres = lambda: gru_scan_fwd_res(xp, wh, None, h0, *conf)  # noqa: E731
    ys, res, hl = fres()
    want = gru_scan_fwd_res_plain(xp, wh, None, h0, *conf)
    err = max(_maxdiff(g, w) for g, w in zip((ys, res, hl), want))
    check(err <= GRU_ATOL, f"wide H={H} residual forward B={BT}: {err}")
    bwd = lambda: gru_scan_bwd(ys, res, wh, h0, dys, dhl, *conf)  # noqa: E731
    first, second = bwd(), bwd()
    check(all(torch.equal(a, b) for a, b in zip(first, second)), f"wide H={H}: dwh run to run")
    out["bwd_rel_err"] = _rel_err(first, gru_scan_bwd_plain(ys, res, wh, h0, dys, dhl, *conf),
                                  f"wide H={H} backward B={BT}")
    out["fwd_res_ms"], out["bwd_ms"] = cuda_ms(fres, reps=20), cuda_ms(bwd, reps=20)
    out["fwd_res_plain_ms"] = cuda_ms(lambda: gru_scan_fwd_res_plain(xp, wh, None, h0, *conf),
                                      reps=3, warmup=1)
    out["bwd_plain_ms"] = cuda_ms(lambda: gru_scan_bwd_plain(ys, res, wh, h0, dys, dhl, *conf),
                                  reps=3, warmup=1)
    out["fwd_res_device_ms"], out["fwd_res_host_ms"] = device_host_ms(fres)
    out["bwd_device_ms"], out["bwd_host_ms"] = device_host_ms(bwd)
    split = _by_kernel(bwd)
    out["bwd_chain_ms"] = _part(split, "gru_wide_bwd")
    out["bwd_dwh_ms"] = _part(split, "gru_dwh_kernel", "gru_dwh_wgmma")
    out["bwd_sum_ms"] = _part(split, "gru_dwh_sum")
    _, (out["fwd_res_bound_ms"], out["fwd_res_bound_by"]), (out["bwd_bound_ms"],
                                                            out["bwd_bound_by"]) = \
        _gru_bounds(1, BT, T, H, False, 1)

    # The library's function: reset_after=True sigmoid, one direction (the
    # same work as the entries of the other GRU kernels), then both.
    one = _library_gru(wh, bh)
    want = gru_scan_plain(xp, wh, bh, h0, True, "sigmoid", False)
    y_one, hl_one = one(xp, h0[None])
    err = max(_maxdiff(y_one, want[0]), _maxdiff(hl_one[0], want[1]))
    check(err <= LIBRARY_ATOL, f"torch.nn.GRU H={H} B={BT}: {err}")
    out["variant_fwd_res_ms"] = cuda_ms(lambda: gru_scan_fwd_res(xp, wh, bh, h0, True, "sigmoid",
                                                                 False), reps=20)
    out["library_one_fwd_ms"] = cuda_ms(lambda: one(xp, h0[None]), reps=20)
    for B in (1, BT):
        d0, d1 = (_gru_inputs(rng, dev, B, H, True, T, H ** -0.5) for _ in range(2))
        x = d0[0]
        args = ((x, x), (d0[1], d1[1]), (d0[2], d1[2]), (d0[3], d1[3]))
        lib = _library_gru((d0[1], d1[1]), (d0[2], d1[2]), bidirectional=True)
        x_in = x.clone().requires_grad_()
        h_lib = torch.stack([d0[3], d1[3]])
        y_lib, hl_lib = lib(x_in, h_lib)
        lib_err = 0.0
        for k, rev in enumerate((False, True)):
            want = gru_scan_plain(x, args[1][k], args[2][k], args[3][k], True, "sigmoid", rev)
            lib_err = max(lib_err, _maxdiff(y_lib[..., k * H:(k + 1) * H], want[0]),
                          _maxdiff(hl_lib[k], want[1]))
        check(lib_err <= LIBRARY_ATOL, f"bidirectional torch.nn.GRU H={H} B={B}: {lib_err}")
        dy = torch.cat([d0[4], d1[4]], dim=-1)
        lib_fwd = cuda_ms(lambda: lib(x_in, h_lib), reps=20)

        def lib_fwd_bwd():
            o, _ = lib(x_in, h_lib)
            torch.autograd.backward(o, dy)

        lib_bwd = cuda_ms(lib_fwd_bwd, reps=20) - lib_fwd
        if B == 1:
            out["pair_fwd_b1_ms"] = cuda_ms(lambda: gru_scan_pair(*args, True, "sigmoid"), reps=20)
            out["library_fwd_b1_ms"] = lib_fwd
            continue
        pres = gru_scan_pair_fwd_res(*args, True, "sigmoid")
        pys, prs = tuple(r[0] for r in pres), tuple(r[1] for r in pres)
        dys2, dhl2 = (d0[4], d1[4]), (d0[5], d1[5])
        out["pair_fwd_res_ms"] = cuda_ms(lambda: gru_scan_pair_fwd_res(*args, True, "sigmoid"),
                                         reps=20)
        out["pair_bwd_ms"] = cuda_ms(lambda: gru_scan_pair_bwd(pys, prs, args[1], args[3], dys2,
                                                               dhl2, True, "sigmoid"), reps=20)
        out["library_fwd_ms"], out["library_bwd_ms"], out["library_err"] = lib_fwd, lib_bwd, lib_err
    print(f"[kernel B wide] times H={H} T={T} (reset_after=False sigmoid, one direction): forward "
          f"B=1 {out['fwd_b1_ms']:.4f} ms ({out['fwd_b1_ms'] / T * 1e3:.3f} us/step; device "
          f"{_fmt(out['fwd_b1_device_ms'])}, host {out['fwd_b1_host_ms']:.4f}; plain "
          f"{out['fwd_b1_plain_ms']:.2f}; bound {out['fwd_b1_bound_ms']:.6f} {out['fwd_b1_bound_by']}"
          f"); B={BT}: residual forward {out['fwd_res_ms']:.4f} ms (device "
          f"{_fmt(out['fwd_res_device_ms'])}; plain {out['fwd_res_plain_ms']:.2f}; bound "
          f"{out['fwd_res_bound_ms']:.5f} {out['fwd_res_bound_by']}), backward "
          f"{out['bwd_ms']:.4f} ms (device {_fmt(out['bwd_device_ms'])}: chain "
          f"{out['bwd_chain_ms']:.4f}, dwh {out['bwd_dwh_ms']:.4f}, sum {out['bwd_sum_ms']:.4f}; "
          f"plain {out['bwd_plain_ms']:.2f}; bound {out['bwd_bound_ms']:.5f} "
          f"{out['bwd_bound_by']}; vs plain {out['bwd_rel_err']:.3g} of max|grad|)")
    print(f"[kernel B wide] times H={H} T={T} reset_after=True sigmoid: one direction's residual "
          f"forward B={BT} {out['variant_fwd_res_ms']:.4f} ms vs torch.nn.GRU forward "
          f"{out['library_one_fwd_ms']:.4f}; both directions vs bidirectional torch.nn.GRU (vs "
          f"plain {out['library_err']:.3g}): forward B=1 pair "
          f"{out['pair_fwd_b1_ms']:.4f} ms vs {out['library_fwd_b1_ms']:.4f}; B={BT} residual "
          f"forward pair {out['pair_fwd_res_ms']:.4f} ms vs forward {out['library_fwd_ms']:.4f}; "
          f"backward pair {out['pair_bwd_ms']:.4f} ms vs {out['library_bwd_ms']:.4f}")
    return out


def _dwh_launchers(lib, name: str, ops, reset_after: bool):
    """A library's dwh/dbh reduction of a pair on ``ops`` ((ys, res, h0,
    dxp) of each direction, on the card) as closures, partials and sums
    allocated once: ``(dwh, total, sums)``: the reduction kernel alone, the
    reduction then its fixed-order sum (``total.sum`` the sum alone), and
    the (2, 1, 3H^2 + 3H) sums. ``name``: the library's prefix, ``gru_dwh``
    (csrc/gru_dwh.cu), ``gru_warp`` or ``gru_wide`` (an older
    csrc/gru_wide.cu, its reduction from before csrc/gru_dwh.cu)."""
    import torch

    from sed_crnn_torch.ops.kernels import gru_scan as gs

    B, T, H = ops[0][0].shape
    dev = ops[0][0].device
    if name == "gru_warp":
        n_part = lib.gru_warp_dwh_blocks(B, T)
        launch, add = lib.gru_warp_dwh_launch, lib.gru_warp_sum_partials
    elif name == "gru_wide":
        n_part = lib.gru_wide_dwh_splits(B, T, H)
        launch, add = lib.gru_wide_dwh_launch, lib.gru_wide_sum_partials
    else:
        n_part = lib.gru_dwh_splits(B, T, H)
        launch, add = lib.gru_dwh_launch, lib.gru_dwh_sum_partials
    error_string = getattr(lib, f"{name}_error_string")
    n = 3 * H * H + 3 * H
    part = torch.empty((2, 1, n_part, n), device=dev)
    sums = torch.empty((2, 1, n), device=dev)
    arr = (gs._DwhDir * 2)(*(gs._DwhDir(y.data_ptr(), r.data_ptr(), h.data_ptr(), x.data_ptr(),
                                        part[k].data_ptr(), k)
                             for k, (y, r, h, x) in enumerate(ops)))
    stream = torch.cuda.current_stream().cuda_stream

    def dwh():
        gs._raise_on(launch(arr, 2, 1, B, T, H, int(reset_after), stream), f"{name}_dwh",
                     error_string)

    def sum_():
        gs._raise_on(add(part.data_ptr(), sums.data_ptr(), 2, n_part, n, stream),
                     f"{name}_sum_partials", error_string)

    def total():
        dwh()
        sum_()

    total.sum, total.n_part, dwh.buffers = sum_, n_part, (arr, part, sums, ops)
    return dwh, total, sums


def _bind_old_wide(lib):
    """The dwh reduction's C interface of a library built from an older
    csrc/gru_wide.cu (before csrc/gru_dwh.cu took its place)."""
    import ctypes

    from sed_crnn_torch.ops.kernels import gru_scan as gs

    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gru_wide_dwh_splits.argtypes = [i] * 3
    lib.gru_wide_dwh_splits.restype = i
    lib.gru_wide_dwh_launch.argtypes = [ctypes.POINTER(gs._DwhDir)] + [i] * 6 + [p]
    lib.gru_wide_dwh_launch.restype = i
    lib.gru_wide_sum_partials.argtypes = [p, p, i, i, i, p]
    lib.gru_wide_sum_partials.restype = i
    lib.gru_wide_error_string.argtypes = [i]
    lib.gru_wide_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_parts(ys, rs, wh, h0, dys, dhl, conf, body: str) -> dict:
    """The three launches of a pair's backward apart, on the card's current
    stream, as closures (outputs and scratch allocated once): the gradient
    chain on the cluster or grid body, then the dwh reduction and the
    fixed-order sum that both share (``csrc/gru_dwh.cu``), on the chain's
    dxp."""
    import torch

    from sed_crnn_torch.ops.kernels import gru_scan as gs

    B, T, H = ys[0].shape
    dev = ys[0].device
    flags = (int(conf[0]), int(conf[1] == "hard_sigmoid"))
    dxp = [torch.empty((B, T, 3 * H), device=dev) for _ in ys]
    dh0 = [torch.empty((B, H), device=dev) for _ in ys]
    chain = (gs._BwdDir * 2)(*(
        gs._BwdDir(*(t.data_ptr() for t in d), x.data_ptr(), d0.data_ptr(), k)
        for k, (d, x, d0) in enumerate(zip(zip(ys, rs, wh, h0, dys, dhl), dxp, dh0))))
    dwh, total, _ = _dwh_launchers(gs._dwh_lib(), "gru_dwh", list(zip(ys, rs, h0, dxp)),
                                   conf[0])
    stream = torch.cuda.current_stream().cuda_stream
    if body == "cluster":
        cl = gs._cluster_lib()
        run_chain = lambda: gs._raise_on(  # noqa: E731
            cl.gru_cluster_bwd_launch(chain, 2, 1, B, T, H, *flags, 0, stream),
            "gru_cluster_bwd", cl.gru_cluster_error_string)
    else:
        gl = gs._grid_lib()
        scratch = gs._grid_scratch(gl, 2, B, H, True, dev)
        run_chain = lambda: gs._raise_on(  # noqa: E731
            gl.gru_grid_bwd_launch(chain, 2, 1, B, T, H, *flags, 0, scratch.data_ptr(), stream),
            "gru_grid_bwd", gl.gru_grid_error_string)
    return {"chain": run_chain, "dwh": dwh, "sum": total.sum}


def _in_turns(fns: dict, reps: dict, order) -> dict:
    """Mean ms per call of each of ``fns``, CUDA events, in ``order`` (a
    name that is not in ``fns`` is skipped)."""
    ms = {k: [] for k in fns}
    for k in order:
        if k in fns:
            ms[k].append(cuda_ms(fns[k], reps=reps[k], warmup=1))
    return {k: float(np.mean(v)) for k, v in ms.items()}


def _bigru_operands(rng, dev, B: int, H: int, T: int = GRU_T):
    """Both directions' operands of a pair on the card, the same xp for both
    (a bidirectional `torch.nn.GRU` reads one input): (xp, wh, bh, h0, dys,
    dhl) pairs, wh scaled by 1 / sqrt(H)."""
    d0, d1 = (_gru_inputs(rng, dev, B, H, True, T, H ** -0.5) for _ in range(2))
    x = d0[0]
    return (x, x), (d0[1], d1[1]), (d0[2], d1[2]), (d0[3], d1[3]), (d0[4], d1[4]), \
        (d0[5], d1[5])


def _bidirectional_library(xp, wh, bh, h0, dys, conf):
    """A bidirectional `torch.nn.GRU` with the pair's weights, its outputs
    held against the plain versions: (forward, forward + backward, err)."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import gru_scan_plain

    H = wh[0].shape[0]
    lib = _library_gru(wh, bh, bidirectional=True)
    x_in = xp[0].clone().requires_grad_()
    h_lib = torch.stack(h0)
    y, hl = lib(x_in, h_lib)
    err = 0.0
    for k, rev in enumerate((False, True)):
        want = gru_scan_plain(xp[k], wh[k], bh[k], h0[k], *conf, rev)
        err = max(err, _maxdiff(y[..., k * H:(k + 1) * H], want[0]), _maxdiff(hl[k], want[1]))
    check(err <= LIBRARY_ATOL, f"bidirectional torch.nn.GRU H={H}: {err}")
    dy = torch.cat(dys, dim=-1)

    def fwd_bwd():
        o, _ = lib(x_in, h_lib)
        torch.autograd.backward(o, dy)
    return (lambda: lib(x_in, h_lib)), fwd_bwd, err


def _cluster_times(H: int = CLUSTER_TIMED) -> dict:
    """The cluster body at width H against `torch.nn.GRU`, T=GRU_T,
    reset_after=True sigmoid (the library's convention), CUDA events, warm
    L2, in turns (cluster, library, library, cluster): a pair's forward at
    B=1, a pair's residual forward and backward (chain + dwh + sum, split by
    kernel) at B=TRAIN_BATCH against a bidirectional `torch.nn.GRU`'s
    forward and backward, and one direction's residual forward at
    B=TRAIN_BATCH against a one-direction one; every output held against its
    plain version first (the library's too), beside the plain versions'
    times, the bounds and each shape's cluster plan."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import (
        _bwd,
        _fwd,
        gru_body,
        gru_scan_bwd_plain,
        gru_scan_fwd_res_plain,
        gru_scan_plain,
    )

    check(gru_body(H) == "cluster", f"H={H} is not on the cluster body")
    dev = torch.device("cuda")
    rng = np.random.default_rng(27)
    T, BT = GRU_T, TRAIN_BATCH
    conf = (True, "sigmoid")
    order = ("cluster", "library", "library", "cluster")
    out = {"H": H, "T": T}

    # B = 1: a pair's forward.
    xp, wh, bh, h0, dys, dhl = _bigru_operands(rng, dev, 1, H)
    fwd = lambda: _fwd(xp, wh, bh, h0, (False, True), *conf, False, "cluster")  # noqa: E731
    plain = [gru_scan_plain(xp[k], wh[k], bh[k], h0[k], *conf, k == 1) for k in (0, 1)]
    outs, _ = fwd()
    err = max(max(_maxdiff(o[0], p[0]), _maxdiff(o[2], p[1])) for o, p in zip(outs, plain))
    check(err <= GRU_ATOL, f"cluster H={H} pair forward B=1: {err}")
    out["fwd_b1_cluster_err"] = err
    lib_fwd, _, lib_err = _bidirectional_library(xp, wh, bh, h0, dys, conf)
    with torch.no_grad():
        ms = _in_turns({"cluster": fwd, "library": lib_fwd}, {"cluster": 20, "library": 10}, order)
    out.update({f"fwd_b1_{k}_ms": v for k, v in ms.items()})
    out["fwd_b1_plain_ms"] = cuda_ms(lambda: [gru_scan_plain(xp[k], wh[k], bh[k], h0[k], *conf,
                                                             k == 1) for k in (0, 1)],
                                     reps=2, warmup=1)
    (out["fwd_b1_bound_ms"], out["fwd_b1_bound_by"]), _, _ = _gru_bounds(1, 1, T, H, True)
    out["fwd_b1_plan"] = _gru_plan_text(H, 1)

    # B = TRAIN_BATCH: a pair's residual forward and backward.
    xp, wh, bh, h0, dys, dhl = _bigru_operands(rng, dev, BT, H)
    fres = lambda: _fwd(xp, wh, bh, h0, (False, True), *conf, True, "cluster")  # noqa: E731
    res_c = fres()[0]
    want_f = [gru_scan_fwd_res_plain(xp[k], wh[k], bh[k], h0[k], *conf, k == 1) for k in (0, 1)]
    err = max(max(_maxdiff(g, w) for g, w in zip(o, p)) for o, p in zip(res_c, want_f))
    check(err <= GRU_ATOL, f"cluster H={H} pair residual forward B={BT}: {err}")
    out["fwd_res_cluster_err"] = err
    ys, rs = tuple(o[0] for o in res_c), tuple(o[1] for o in res_c)
    bwd = lambda: _bwd(ys, rs, wh, h0, dys, dhl, (False, True), *conf, "cluster")  # noqa: E731
    want_b = [gru_scan_bwd_plain(ys[k], rs[k], wh[k], h0[k], dys[k], dhl[k], *conf, k == 1)
              for k in (0, 1)]
    first, again = bwd(), bwd()
    check(all(torch.equal(x, y) for f, a in zip(first, again) for x, y in zip(f, a)),
          f"cluster H={H} backward B={BT} not bitwise equal run to run")
    out["bwd_cluster_rel_err"] = max(_rel_err(g, w, f"cluster H={H} backward B={BT}")
                                     for g, w in zip(first, want_b))
    lib_fwd, lib_fwd_bwd, b128_err = _bidirectional_library(xp, wh, bh, h0, dys, conf)
    out["library_err"] = max(lib_err, b128_err)
    reps = {"cluster": 10, "library": 10}
    with torch.no_grad():
        ms = _in_turns({"cluster": fres, "library": lib_fwd}, reps, order)
    out.update({f"fwd_res_{k}_ms": v for k, v in ms.items()})
    ms = _in_turns({"cluster": bwd, "library": lib_fwd_bwd}, reps, order)
    out.update({f"bwd_{k}_ms": v for k, v in ms.items()})
    out["bwd_library_ms"] -= out["fwd_res_library_ms"]     # the library's backward alone
    parts = _bwd_parts(ys, rs, wh, h0, dys, dhl, conf, "cluster")
    out["bwd_cluster_chain_ms"] = cuda_ms(parts["chain"], reps=10)
    out["bwd_dwh_ms"] = cuda_ms(parts["dwh"], reps=10)
    out["bwd_sum_ms"] = cuda_ms(parts["sum"], reps=10)
    out["fwd_res_plain_ms"] = cuda_ms(lambda: [gru_scan_fwd_res_plain(
        xp[k], wh[k], bh[k], h0[k], *conf, k == 1) for k in (0, 1)], reps=2, warmup=1)
    out["bwd_plain_ms"] = cuda_ms(lambda: [gru_scan_bwd_plain(
        ys[k], rs[k], wh[k], h0[k], dys[k], dhl[k], *conf, k == 1) for k in (0, 1)],
        reps=2, warmup=1)
    _, (out["fwd_res_bound_ms"], out["fwd_res_bound_by"]), (out["bwd_bound_ms"],
                                                            out["bwd_bound_by"]) = \
        _gru_bounds(1, BT, T, H, True)
    out["b128_plan"] = _gru_plan_text(H, BT)

    # One direction's residual forward beside a one-direction torch.nn.GRU.
    one = lambda: _fwd([xp[0]], [wh[0]], [bh[0]], [h0[0]], [False], *conf, True,  # noqa: E731
                       "cluster")
    lib_one = _library_gru(wh[0], bh[0])
    y_one, hl_one = lib_one(xp[0], h0[0][None])
    check(max(_maxdiff(y_one, want_f[0][0]), _maxdiff(hl_one[0], want_f[0][2])) <= LIBRARY_ATOL,
          f"torch.nn.GRU H={H} B={BT}")
    with torch.no_grad():
        ms = _in_turns({"cluster": one, "library": lambda: lib_one(xp[0], h0[0][None])}, reps,
                       order)
    out.update({f"one_fwd_res_{k}_ms": v for k, v in ms.items()})
    out["one_fwd_res_bound_ms"] = _gru_bounds(1, BT, T, H, True, 1)[1][0]

    f = lambda k: out[f"{k}_library_ms"] / out[f"{k}_cluster_ms"]  # noqa: E731
    print(f"[kernel B wide] cluster body H={H} T={T} reset_after=True sigmoid, in turns with "
          f"bidirectional torch.nn.GRU (vs plain {out['library_err']:.3g}), ms: pair "
          f"forward B=1{out['fwd_b1_plan']} cluster {out['fwd_b1_cluster_ms']:.4f}, library "
          f"{out['fwd_b1_library_ms']:.4f} ({f('fwd_b1'):.2f}x the cluster's time), plain "
          f"{out['fwd_b1_plain_ms']:.2f}, bound {out['fwd_b1_bound_ms']:.6f} "
          f"({out['fwd_b1_bound_by']})")
    print(f"[kernel B wide] cluster body H={H} B={BT}{out['b128_plan']}: pair residual forward "
          f"cluster {out['fwd_res_cluster_ms']:.4f}, library forward "
          f"{out['fwd_res_library_ms']:.4f} ({f('fwd_res'):.2f}x), plain "
          f"{out['fwd_res_plain_ms']:.2f}, bound {out['fwd_res_bound_ms']:.5f} "
          f"({out['fwd_res_bound_by']}); pair backward cluster {out['bwd_cluster_ms']:.4f} "
          f"(chain {out['bwd_cluster_chain_ms']:.4f}, dwh {out['bwd_dwh_ms']:.4f}, sum "
          f"{out['bwd_sum_ms']:.4f}; vs plain {out['bwd_cluster_rel_err']:.3g} of max|grad|), "
          f"library backward {out['bwd_library_ms']:.4f} ({f('bwd'):.2f}x), plain "
          f"{out['bwd_plain_ms']:.2f}, bound {out['bwd_bound_ms']:.5f} ({out['bwd_bound_by']}); "
          f"one direction's residual forward cluster {out['one_fwd_res_cluster_ms']:.4f}, "
          f"one-direction torch.nn.GRU {out['one_fwd_res_library_ms']:.4f}, bound "
          f"{out['one_fwd_res_bound_ms']:.5f}")
    return out


def _grid_times(H: int) -> dict:
    """The grid body at width H against `torch.nn.GRU`, T=GRU_T,
    reset_after=True sigmoid (the library's convention), CUDA events, warm
    L2, in turns (grid, library, library, grid): a pair's forward at B=1
    (not at 2048), a pair's residual forward and backward (chain, dwh and
    sum timed apart too) at B=TRAIN_BATCH against a bidirectional
    `torch.nn.GRU`'s forward and backward; every output held against its
    plain version first (the library's too), beside the plain versions'
    times, the bounds and each shape's grid plan."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import (
        _bwd,
        _fwd,
        gru_body,
        gru_scan_bwd_plain,
        gru_scan_fwd_res_plain,
        gru_scan_plain,
    )

    check(gru_body(H) == "grid", f"H={H} is not on the grid body")
    dev = torch.device("cuda")
    rng = np.random.default_rng(29 + H)
    T, BT = GRU_T, TRAIN_BATCH
    conf = (True, "sigmoid")
    order = ("grid", "library", "library", "grid")
    out = {"H": H, "T": T}
    lib_errs = []
    if H == GRID_TIMED[0]:
        xp, wh, bh, h0, dys, dhl = _bigru_operands(rng, dev, 1, H)
        fwd = lambda: _fwd(xp, wh, bh, h0, (False, True), *conf, False, "grid")  # noqa: E731
        plain = [gru_scan_plain(xp[k], wh[k], bh[k], h0[k], *conf, k == 1) for k in (0, 1)]
        outs, _ = fwd()
        err = max(max(_maxdiff(o[0], p[0]), _maxdiff(o[2], p[1])) for o, p in zip(outs, plain))
        check(err <= GRU_ATOL, f"grid H={H} pair forward B=1: {err}")
        out["fwd_b1_err"] = err
        lib_fwd, _, e = _bidirectional_library(xp, wh, bh, h0, dys, conf)
        lib_errs.append(e)
        with torch.no_grad():
            ms = _in_turns({"grid": fwd, "library": lib_fwd}, {"grid": 10, "library": 5}, order)
        out.update({f"fwd_b1_{k}_ms": v for k, v in ms.items()})
        out["fwd_b1_plain_ms"] = cuda_ms(lambda: [gru_scan_plain(
            xp[k], wh[k], bh[k], h0[k], *conf, k == 1) for k in (0, 1)], reps=1, warmup=1)
        (out["fwd_b1_bound_ms"], out["fwd_b1_bound_by"]), _, _ = _gru_bounds(1, 1, T, H, True)
        out["fwd_b1_plan"] = _gru_plan_text(H, 1)

    xp, wh, bh, h0, dys, dhl = _bigru_operands(rng, dev, BT, H)
    fres = lambda: _fwd(xp, wh, bh, h0, (False, True), *conf, True, "grid")  # noqa: E731
    res_g = fres()[0]
    want_f = [gru_scan_fwd_res_plain(xp[k], wh[k], bh[k], h0[k], *conf, k == 1) for k in (0, 1)]
    err = max(max(_maxdiff(g, w) for g, w in zip(o, p)) for o, p in zip(res_g, want_f))
    check(err <= GRU_ATOL, f"grid H={H} pair residual forward B={BT}: {err}")
    out["fwd_res_err"] = err
    ys, rs = tuple(o[0] for o in res_g), tuple(o[1] for o in res_g)
    bwd = lambda: _bwd(ys, rs, wh, h0, dys, dhl, (False, True), *conf, "grid")  # noqa: E731
    want_b = [gru_scan_bwd_plain(ys[k], rs[k], wh[k], h0[k], dys[k], dhl[k], *conf, k == 1)
              for k in (0, 1)]
    first, again = bwd(), bwd()
    check(all(torch.equal(x, y) for f, a in zip(first, again) for x, y in zip(f, a)),
          f"grid H={H} backward B={BT} not bitwise equal run to run")
    out["bwd_rel_err"] = max(_rel_err(g, w, f"grid H={H} backward B={BT}")
                             for g, w in zip(first, want_b))
    out["bwd_abs_err"] = max(_maxdiff(g[i], w[i]) for g, w in zip(first, want_b) for i in (0, 3))
    lib_fwd, lib_fwd_bwd, e = _bidirectional_library(xp, wh, bh, h0, dys, conf)
    out["library_err"] = max(lib_errs + [e])
    reps = {"grid": 3, "library": 3}
    with torch.no_grad():
        ms = _in_turns({"grid": fres, "library": lib_fwd}, reps, order)
    out.update({f"fwd_res_{k}_ms": v for k, v in ms.items()})
    ms = _in_turns({"grid": bwd, "library": lib_fwd_bwd}, reps, order)
    out.update({f"bwd_{k}_ms": v for k, v in ms.items()})
    out["bwd_library_ms"] -= out["fwd_res_library_ms"]     # the library's backward alone
    parts = _bwd_parts(ys, rs, wh, h0, dys, dhl, conf, "grid")
    for k in ("chain", "dwh", "sum"):
        out[f"bwd_{k}_ms"] = cuda_ms(parts[k], reps=3)
    out["fwd_res_plain_ms"] = cuda_ms(lambda: [gru_scan_fwd_res_plain(
        xp[k], wh[k], bh[k], h0[k], *conf, k == 1) for k in (0, 1)], reps=1, warmup=1)
    out["bwd_plain_ms"] = cuda_ms(lambda: [gru_scan_bwd_plain(
        ys[k], rs[k], wh[k], h0[k], dys[k], dhl[k], *conf, k == 1) for k in (0, 1)],
        reps=1, warmup=1)
    _, (out["fwd_res_bound_ms"], out["fwd_res_bound_by"]), (out["bwd_bound_ms"],
                                                            out["bwd_bound_by"]) = \
        _gru_bounds(1, BT, T, H, True)
    out["b128_plan"] = _gru_plan_text(H, BT)

    f = lambda k: out[f"{k}_library_ms"] / out[f"{k}_grid_ms"]  # noqa: E731
    if "fwd_b1_grid_ms" in out:
        print(f"[kernel B wide] grid body H={H} T={T} reset_after=True sigmoid, in turns with "
              f"bidirectional torch.nn.GRU (vs plain {out['library_err']:.3g}), ms: pair "
              f"forward B=1{out['fwd_b1_plan']} grid {out['fwd_b1_grid_ms']:.4f} "
              f"({out['fwd_b1_grid_ms'] / T * 1e3:.2f} us a step), library "
              f"{out['fwd_b1_library_ms']:.4f} ({f('fwd_b1'):.2f}x the grid's time), plain "
              f"{out['fwd_b1_plain_ms']:.2f}, bound {out['fwd_b1_bound_ms']:.6f} "
              f"({out['fwd_b1_bound_by']})")
    print(f"[kernel B wide] grid body H={H} B={BT} T={T}{out['b128_plan']}: pair residual "
          f"forward grid {out['fwd_res_grid_ms']:.4f} ({out['fwd_res_grid_ms'] / T * 1e3:.2f} us "
          f"a step), library forward {out['fwd_res_library_ms']:.4f} ({f('fwd_res'):.2f}x), "
          f"plain {out['fwd_res_plain_ms']:.2f}, bound {out['fwd_res_bound_ms']:.5f} "
          f"({out['fwd_res_bound_by']}); pair backward grid {out['bwd_grid_ms']:.4f} (chain "
          f"{out['bwd_chain_ms']:.4f}, dwh {out['bwd_dwh_ms']:.4f}, sum {out['bwd_sum_ms']:.4f}; "
          f"vs plain {out['bwd_rel_err']:.3g} of max|grad|), library backward "
          f"{out['bwd_library_ms']:.4f} ({f('bwd'):.2f}x), plain {out['bwd_plain_ms']:.2f}, "
          f"bound {out['bwd_bound_ms']:.5f} ({out['bwd_bound_by']}); library vs plain "
          f"{out['library_err']:.3g}")
    return out


def _grid_forced_k() -> dict:
    """The grid body's bits at forced K: stacked S=5 at B=8, T=32, H in {520,
    1024}, both conventions, the residual forward and the backward at each
    of GRID_FORCED_K CTAs a direction (other units a CTA; at 40, 26 or 13
    units padded to 32 or 16, the tile body, streamed at 1024) bitwise
    those at the rule's K; a pair of more CTAs than half the card's SMs is
    refused by the cooperative launch and raises."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import _bwd, _fwd, grid_plan

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(33)
    S, B, T = 5, 8, 32
    plans = {}
    for H in (520, 1024):
        d0, d1 = _stack_operands(rng, dev, S, B, T, H)
        for reset_after in (False, True):
            arg = lambda i: (d0[i], d1[i]) if (i != 2 or reset_after) else (None, None)  # noqa: E731
            conf = (reset_after, "sigmoid")
            outs = {}
            for k in (0,) + GRID_FORCED_K:
                fwd, _ = _fwd(arg(0), arg(1), arg(2), arg(3), (False, True), *conf, True, "grid",
                              S, k)
                bwd = _bwd(tuple(f[0] for f in fwd), tuple(f[1] for f in fwd), arg(1), arg(3),
                           arg(4), arg(5), (False, True), *conf, "grid", S, k)
                outs[k] = [t for f, b in zip(fwd, bwd) for t in f + b]
                plans[(H, k)] = grid_plan(2, S, B, H, False, ctas=k, sms=sms)
            for k in GRID_FORCED_K:
                check(all(torch.equal(a, b) for a, b in zip(outs[0], outs[k])),
                      f"grid H={H} S={S} reset_after={reset_after}: K={k} changes the bits")
        try:
            _fwd(arg(0), arg(1), arg(2), arg(3), (False, True), True, "sigmoid", True, "grid", S,
                 sms // 2 + 1)
        except RuntimeError as e:
            refused = str(e)
        else:
            refused = ""
        check("gru_grid_fwd" in refused, f"grid H={H}: a pair of {sms // 2 + 1} CTAs a "
                                          f"direction was not refused")
    text = "; ".join(f"H={H} K={p['ctas']}: {p['units']} ({p['units_padded']}) units, "
                     f"{'lanes' if p['split'] > 1 else 'tile'}, "
                     f"{'resident' if p['resident'] else 'streamed'}"
                     for (H, _), p in plans.items())
    print(f"[kernel B wide] grid body stacked S={S} B={B} T={T}, both conventions: residual "
          f"forward and backward bitwise the rule's at forced K {GRID_FORCED_K} ({text}); a pair "
          f"of {sms // 2 + 1} CTAs a direction refused: {refused!r}")
    return {"forced_k": list(GRID_FORCED_K), "refused": refused}


def _grid_widest() -> dict:
    """The grid body at the most units a CTA: a pair at H=GRID_WIDEST (34
    CTAs a direction of 249 (256) units, weights streamed), B=2, T=4, and a
    pair at H=GRID_TWO_BLOCKS (66 CTAs a direction of 257 units, walked in
    two blocks of 256; about 30 GB with the dwh partials), B=1, T=4, both
    conventions, sigmoid: the residual forward within GRU_ATOL of the plain
    version and the backward (chain, csrc/gru_dwh.cu's dwh) within
    GRAD_RTOL of max|grad|, each plan held against the Python mirror."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import (
        _bwd,
        _fwd,
        gru_scan_bwd_plain,
        gru_scan_fwd_res_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    out = {}
    for B, T, H in ((2, 4, GRID_WIDEST), (1, 4, GRID_TWO_BLOCKS)):
        d = [(randn(B, T, 3 * H), randn(H, 3 * H, scale=H ** -0.5), randn(3 * H, scale=0.1),
              randn(B, H, scale=0.5), randn(B, T, H), randn(B, H)) for _ in range(2)]
        arg = lambda i: tuple(x[i] for x in d)  # noqa: E731
        plan = _gru_plan_text(H, B)
        fwd_err = bwd_err = 0.0
        for reset_after in (False, True):
            conf = (reset_after, "sigmoid")
            bh = arg(2) if reset_after else (None, None)
            outs, _ = _fwd(arg(0), arg(1), bh, arg(3), (False, True), *conf, True, "grid")
            want = [gru_scan_fwd_res_plain(d[k][0], d[k][1], bh[k], d[k][3], *conf, k == 1)
                    for k in (0, 1)]
            err = max(_maxdiff(g, w) for o, p in zip(outs, want) for g, w in zip(o, p))
            check(err <= GRU_ATOL, f"grid H={H} reset_after={reset_after} residual forward: {err}")
            fwd_err = max(fwd_err, err)
            del want
            ys, rs = tuple(o[0] for o in outs), tuple(o[1] for o in outs)
            got = _bwd(ys, rs, arg(1), arg(3), arg(4), arg(5), (False, True), *conf, "grid")
            for k in (0, 1):
                want_b = gru_scan_bwd_plain(ys[k], rs[k], d[k][1], d[k][3], d[k][4], d[k][5],
                                            *conf, k == 1)
                bwd_err = max(bwd_err, _rel_err(got[k], want_b, f"grid H={H} reset_after="
                                                                f"{reset_after} backward"))
                del want_b
            del outs, got, ys, rs
        del d
        torch.cuda.empty_cache()
        out[H] = {"fwd": fwd_err, "bwd": bwd_err}
        print(f"[kernel B wide] grid body at its most units a CTA, pair H={H} B={B} T={T}{plan}, "
              f"both conventions: residual forward vs plain {fwd_err:.3g}, backward (dwh by "
              f"csrc/gru_dwh.cu) {bwd_err:.3g} of max|grad|")
    return {"H": GRID_WIDEST, "fwd": max(v["fwd"] for v in out.values()),
            "bwd": max(v["bwd"] for v in out.values()), "two_blocks": out[GRID_TWO_BLOCKS]}


def _body_serving(workdir: str, pcm: np.ndarray, overrides: dict, body: str,
                  seed: int) -> dict:
    """sednet-dcase with ``overrides``' GRUs (seeded weights, `model_tree`)
    exported as a serving artifact and served on the 120 s wav through
    `apps.infer.infer_file_artifact`, on the card and on the CPU:
    probabilities within PROB_ATOL, events equal; the chunks' logits through
    `stream_logits` (B=1, 256-frame chunks, the GRU state carried) within
    LOGIT_ATOL; the wav's whole 256-frame windows at once through
    `forward_probabilities` within PROB_ATOL; on the card one pair launch
    per BiGRU layer per chunk (and per layer for the windows), all on
    ``body``, no GRU plain version."""
    import torch

    from sed_crnn_torch.apps.infer import infer_file_artifact, load_model
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.data.wavio import write_wav
    from sed_crnn_torch.models.export import export_serving
    from sed_crnn_torch.models.streaming import stream_logits
    from sed_crnn_torch.ops import frontend
    from sed_crnn_torch.train.evaluate import forward_probabilities

    cfg = get_preset("sednet-dcase")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **overrides))
    m = cfg.model
    check(_gru_model_body(m) == body, f"gru_hidden {m.gru_hidden} not on the {body} body")
    params, state = model_tree(m, seed=seed)
    fe = dataclasses.replace(cfg.frontend, log_floor=1e-10)
    stats = frontend.fit_norm_stats(frontend.extract(pcm, fe, device="cpu"))
    stats = (stats.mean.numpy(), stats.scale.numpy())
    art = os.path.join(workdir, f"sednet_gru{m.gru_hidden[0]}.zip")
    export_serving(cfg, params, state, norm_stats=stats, preset=None, device="cpu").save(art)
    wav = os.path.join(workdir, "tones_120s.wav")
    write_wav(wav, pcm, SR)

    _reset_gru_counts()
    t0 = time.perf_counter()
    with _no_plain_gru_on_card() as plain_on_card:
        probs, events, _ = infer_file_artifact(wav, art, device="cuda")
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = _gru_counts()
    n_frames = frontend.extract(pcm, fe, device="cpu").shape[0]
    n_chunks = -(-n_frames // m.seq_len_in)
    layers = len(m.gru_hidden)
    want = _gru_path_counts(layers * n_chunks, 0, body)
    check(counts == want and not plain_on_card,
          f"{body} serving launches {counts} != {want}; plain on the card {plain_on_card}")
    t0 = time.perf_counter()
    probs_cpu, events_cpu, _ = infer_file_artifact(wav, art, device="cpu")
    cpu_s = time.perf_counter() - t0
    pool = m.seq_len_in // m.seq_len_out
    check(probs.shape == probs_cpu.shape == (n_frames // pool, m.n_classes),
          f"{body} serving shape {probs.shape}")
    prob_err = float(np.abs(probs - probs_cpu).max())
    check(bool(np.isfinite(probs).all()) and prob_err <= PROB_ATOL,
          f"{body} serving probabilities card vs CPU {prob_err}")
    check(events == events_cpu and len(events) > 0, f"{body} serving: card and CPU events differ")
    tree = {"params": params, "model_state": state}
    card, cpu = load_model(tree, m, "cuda"), load_model(tree, m, "cpu")
    mel = frontend.normalize(frontend.extract(pcm, fe, device="cpu"), stats)
    _reset_gru_counts()
    with _no_plain_gru_on_card() as plain_on_card:
        logits = stream_logits(card, mel.cuda()).cpu()
        torch.cuda.synchronize()
    counts = _gru_counts()
    check(counts == _gru_path_counts(layers * n_chunks, 0, body) and not plain_on_card,
          f"{body} stream_logits launches {counts}")
    logits_cpu = stream_logits(cpu, mel)
    logit_err = _maxdiff(logits, logits_cpu)
    check(logit_err <= LOGIT_ATOL, f"{body} serving logits card vs CPU {logit_err}")
    n_win = n_frames // m.seq_len_in
    windows = mel[: n_win * m.seq_len_in].reshape(n_win, m.seq_len_in, m.n_mels).numpy()
    _reset_gru_counts()
    with _no_plain_gru_on_card() as plain_on_card:
        wprobs = forward_probabilities([card], windows, 256)
        torch.cuda.synchronize()
    counts = _gru_counts()
    check(counts == _gru_path_counts(layers, 0, body) and not plain_on_card,
          f"{body} forward_probabilities launches {counts}")
    wprobs_cpu = forward_probabilities([cpu], windows, 256)
    window_err = _maxdiff(wprobs.cpu(), wprobs_cpu)
    check(window_err <= PROB_ATOL, f"{body} forward_probabilities card vs CPU {window_err}")
    print(f"[kernel B wide] serving gru_hidden {tuple(m.gru_hidden)} ({body} body): the 120 s "
          f"wav through infer_file_artifact, {n_chunks} chunks, card vs CPU probabilities "
          f"{prob_err:.3g}, {len(events)} events equal; stream_logits at B=1 card vs CPU "
          f"{logit_err:.3g}; forward_probabilities of its {n_win} whole windows at once card vs "
          f"CPU {window_err:.3g}; card {card_s:.2f} s, CPU {cpu_s:.2f} s (infer_file_artifact); "
          f"launches exact, no plain version on the card")
    return {"launches": layers * (2 * n_chunks + 1), "prob_err": prob_err,
            "logit_err": logit_err, "window_err": window_err}


# The wide body's precision on a badly conditioned recurrence: the stacked
# check's shape at H=128 with wh at the warp widths' scale (0.3 N(0, 1)) and
# at smaller ones, against float64.
PRECISION_SHAPE = (5, 8, 32, 128)
PRECISION_SCALES = (0.15, 0.2, 0.3)
# The gates of csrc/gru_wide.cu, and their exact forms for `_exact_gate_wide`.
EXACT_GATES = {"__fdividef(1.0f, 1.0f + __expf(-v))": "1.0f / (1.0f + expf(-v))",
               "1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * v))": "tanhf(v)"}


@contextlib.contextmanager
def _exact_gate_wide(workdir: str):
    """Kernel B's wide body built from csrc/gru_wide.cu with EXACT_GATES in
    place of its __expf / __fdividef gates, launched by the port's wrappers
    inside the block."""
    import ctypes

    from sed_crnn_torch.ops.kernels import _build
    from sed_crnn_torch.ops.kernels import gru_scan as gs

    src = (_build.CSRC_DIR / "gru_wide.cu").read_text()
    for fast, exact in EXACT_GATES.items():
        check(src.count(fast) == 1, f"gru_wide.cu has {src.count(fast)} of {fast!r}")
        src = src.replace(fast, exact)
    check("__expf" not in src and "__fdividef" not in src, "gru_wide.cu: fast math left")
    cu, so = os.path.join(workdir, "gru_wide_exact.cu"), os.path.join(workdir, "gru_wide_exact.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc of the exact-gate wide body:\n{proc.stdout}{proc.stderr}")
    fast_lib = _build.load("gru_wide")
    _build._loaded["gru_wide"] = ctypes.CDLL(so)
    gs._wide_lib.cache_clear()
    try:
        yield
    finally:
        _build._loaded["gru_wide"] = fast_lib
        gs._wide_lib.cache_clear()


def _wide_precision() -> dict:
    """The wide body against a float64 plain version at PRECISION_SHAPE
    (stacked, both directions, both conventions and gates) for wh at each of
    PRECISION_SCALES: per scale the largest distance of the forward's ys and
    h_last to float64 for the kernel, the same kernel with exact gates, the
    float32 plain version and the float32 plain version on xp moved by one
    ulp (how far float32 rounding alone is carried here), with the kernel's
    distance to the float32 plain version (what the GRU_ATOL checks read)
    and the spread of the r and z pre-activations. The kernel is held within
    GRU_ATOL of float64 or, where float32 rounding alone is carried further,
    no further than the float32 plain version on the moved xp."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import GATES, gru_scan_fwd_res_plain, gru_scan_stack

    S, B, T, H = PRECISION_SHAPE
    dev = torch.device("cuda")
    rng = np.random.default_rng(26)
    cases = {w: _stack_operands(rng, dev, S, B, T, H, w) for w in PRECISION_SCALES}
    confs = [(ra, g) for ra in (False, True) for g in GATES]

    def launch(d0, d1, ra, gate):
        arg = lambda i: (d0[i], d1[i]) if (i != 2 or ra) else (None, None)  # noqa: E731
        return gru_scan_stack(arg(0), arg(1), arg(2), arg(3), ra, gate)

    fast = {(w, c): launch(*d, *c) for w, d in cases.items() for c in confs}
    with tempfile.TemporaryDirectory() as workdir, _exact_gate_wide(workdir):
        exact = {(w, c): launch(*d, *c) for w, d in cases.items() for c in confs}
    out = {}
    for w, (d0, d1) in cases.items():
        r = {"kernel": 0.0, "exact_gates": 0.0, "plain": 0.0, "plain_ulp": 0.0,
             "kernel_vs_plain": 0.0, "pre_std": 0.0, "pre_max": 0.0}
        for ra, gate in confs:
            for k, (d, rev) in enumerate(((d0, False), (d1, True))):
                for s in range(S):
                    a = [d[0][s], d[1][s], d[2][s] if ra else None, d[3][s]]
                    f64 = gru_scan_fwd_res_plain(*(None if x is None else x.double() for x in a),
                                                 ra, gate, rev)
                    f32 = gru_scan_fwd_res_plain(*a, ra, gate, rev)
                    sign = torch.from_numpy(rng.choice([-1.0, 1.0], a[0].shape).astype(np.float32))
                    moved = a[0] * (1 + 2.0 ** -23 * sign.to(dev))
                    ulp = gru_scan_fwd_res_plain(moved, *a[1:], ra, gate, rev)

                    def dist(ys, hl, ref=f64):
                        return max(_maxdiff(ys.double(), ref[0]), _maxdiff(hl.double(), ref[2]))

                    kf, ke = fast[(w, (ra, gate))][k], exact[(w, (ra, gate))][k]
                    for key, v in (("kernel", dist(kf[0][s], kf[1][s])),
                                   ("exact_gates", dist(ke[0][s], ke[1][s])),
                                   ("plain", dist(f32[0], f32[2])),
                                   ("plain_ulp", dist(ulp[0], ulp[2])),
                                   ("kernel_vs_plain", dist(kf[0][s], kf[1][s], f32))):
                        r[key] = max(r[key], v)
                    ys = f64[0].flip(1) if rev else f64[0]
                    prev = torch.cat([a[3].double()[:, None], ys[:, :-1]], dim=1)
                    pre = ((a[0].double() if not rev else a[0].double().flip(1))[..., :2 * H]
                           + prev @ a[1].double()[:, :2 * H])
                    r["pre_std"] = max(r["pre_std"], float(pre.std()))
                    r["pre_max"] = max(r["pre_max"], float(pre.abs().max()))
        check(r["kernel"] <= max(GRU_ATOL, r["plain_ulp"]),
              f"wide precision wh {w}: kernel {r['kernel']} from float64, float32 plain on "
              f"1-ulp-moved xp {r['plain_ulp']}")
        out[w] = r
        print(f"[kernel B wide] precision S={S} B={B} T={T} H={H}, wh {w} N(0, 1) (r, z "
              f"pre-activations std {r['pre_std']:.3g}, max |v| {r['pre_max']:.3g}), both "
              f"conventions, gates and directions: max distance to float64 of the kernel "
              f"{r['kernel']:.3g}, with exact gates {r['exact_gates']:.3g}, of float32 plain "
              f"{r['plain']:.3g}, of float32 plain on 1-ulp-moved xp {r['plain_ulp']:.3g}; "
              f"kernel vs float32 plain {r['kernel_vs_plain']:.3g}")
    return out


# [kernel B dwh]: csrc/gru_dwh.cu, the dwh/dbh reduction of every body above
# the warp one, at the training shape (a pair, B=TRAIN_BATCH, T=GRU_T).
DWH_TIMED = (64, 128, 256, 1024, 2048)
DWH_WARP_H = 32            # the warp body's widest: its own reduction against this one
DWH_REPS = {64: 20, 128: 20, 256: 10, 1024: 4, 2048: 2, DWH_WARP_H: 20}
# Widths that take the mma.sync tile (not a multiple of 4), checked but not
# timed: (H, B, T); the widest pair's at its [kernel B wide] batch, the dwh
# partials alone 3.4 GB a direction.
DWH_CHECKED = ((33, 128, 256), (129, 128, 256), (257, 128, 256), (GRID_TWO_BLOCKS, 2, 40))
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 on the tensor cores


def _dwh_operands(gen, B: int, T: int, H: int, reset_after: bool) -> list:
    """A pair's stored rows on the card: (ys, res, h0, dxp) of each
    direction, ys in (-1, 1) and the gates in (0, 1) as a forward leaves
    them."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import res_width

    dev = torch.device("cuda")
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    return [(torch.tanh(randn(B, T, H)),
             torch.rand((B, T, res_width(reset_after, H)), generator=gen, device=dev),
             0.5 * randn(B, H), randn(B, T, 3 * H)) for _ in range(2)]


def _dwh_library(ops, reset_after: bool):
    """One `torch.matmul` of the same product on prepared operands: the two
    directions' three parts L_p^T D_p (`dwh_factors`) batched, (6, H, N) x
    (6, N, H) with the left operand a transposed view; returns the call
    (its operands kept on it) and its dwh per direction for the check."""
    import torch

    from sed_crnn_torch.ops.kernels.gru_scan import dwh_factors

    lefts, rights = [], []
    for k, op in enumerate(ops):
        left, right = dwh_factors(*op, reset_after, k == 1)
        lefts += left
        rights += right
    a, b = torch.stack(lefts).transpose(1, 2), torch.stack(rights)
    call = lambda: torch.matmul(a, b)  # noqa: E731
    call.operands = (a, b)
    out = call()
    return call, [torch.cat(list(out[3 * k:3 * k + 3]), dim=-1) for k in (0, 1)]


def _dwh_bound(B: int, T: int, H: int):
    """The least time of a pair's dwh/dbh: each direction reads ys, r, h0 and
    dxp once and writes dwh and dbh once; 2 N H 3H multiply-adds a
    direction, three TF32 products each on the tensor cores (3xTF32) ->
    ((ms, what bounds it), the same product's float32 bound in ms)."""
    N = B * T
    n_bytes = 2 * 4 * (N * H + N * H + B * H + N * 3 * H + 3 * H * H + 3 * H)
    n_flops = 2 * 2 * N * H * 3 * H
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 3 * n_flops / PEAK_TF32_FLOPS * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, n_flops / PEAK_FP32_FLOPS * 1e3


def _dwh_stacked_seed0(lib, gen, ops, reset_after: bool):
    """csrc/gru_dwh.cu on a stack of two seeds of both directions (one
    launch, grid.z = 2 S) whose seed 0 is ``ops`` -> seed 0's sums, (2, n)."""
    import torch

    from sed_crnn_torch.ops.kernels import gru_scan as gs

    B, T, H = ops[0][0].shape
    other = _dwh_operands(gen, B, T, H, reset_after)
    stacked = [tuple(torch.stack([a, b]) for a, b in zip(o, q)) for o, q in zip(ops, other)]
    del other
    n_part, n = lib.gru_dwh_splits(B, T, H), 3 * H * H + 3 * H
    part = torch.empty((2, 2, n_part, n), device=ops[0][0].device)
    sums = torch.empty((2, 2, n), device=ops[0][0].device)
    arr = (gs._DwhDir * 2)(*(gs._DwhDir(y.data_ptr(), r.data_ptr(), h.data_ptr(), x.data_ptr(),
                                        part[k].data_ptr(), k)
                             for k, (y, r, h, x) in enumerate(stacked)))
    stream = torch.cuda.current_stream().cuda_stream
    gs._raise_on(lib.gru_dwh_launch(arr, 2, 2, B, T, H, int(reset_after), stream), "gru_dwh_dwh",
                 lib.gru_dwh_error_string)
    gs._raise_on(lib.gru_dwh_sum_partials(part.data_ptr(), sums.data_ptr(), 4, n_part, n,
                                          stream), "gru_dwh_sum_partials", lib.gru_dwh_error_string)
    torch.cuda.synchronize()
    return sums[:, 0].clone()


def _dwh_parent(path: str):
    """The reduction of an older source, built beside this one: an older
    csrc/gru_dwh.cu (its C interface this one's) or csrc/gru_wide.cu (the FMA
    reduction from before csrc/gru_dwh.cu) -> (library, its prefix)."""
    from sed_crnn_torch.ops.kernels import gru_scan as gs
    from sed_crnn_torch.tools.gru_phases import build_variants

    source = os.path.basename(path)
    check(source in ("gru_dwh.cu", "gru_wide.cu"), f"--dwh-parent {path}: not a gru_dwh.cu "
                                                   "or gru_wide.cu")
    name = source[:-3]
    built = build_variants(name, {}, None, {"parent": path})
    return (gs.bind_dwh if name == "gru_dwh" else _bind_old_wide)(built["parent"]), name


def _dwh_check(lib, gen, H: int, B: int, T: int, reset_after: bool, tag: str) -> dict:
    """csrc/gru_dwh.cu on a pair at (B, T, H): against `gru_dwh_plain` within
    GRAD_RTOL of the largest entry, dwh and dbh of both directions, bitwise
    run to run, seed 0 of a stack of two bitwise the pair; the card's split
    count and body the Python mirrors' -> the errors, the operands, the
    plain version's results and the launchers."""
    import torch

    from sed_crnn_torch.ops.kernels import gru_scan as gs
    from sed_crnn_torch.ops.kernels.gru_scan import dwh_body, dwh_split_plan, gru_dwh_plain

    ops = _dwh_operands(gen, B, T, H, reset_after)
    want = [gru_dwh_plain(*ops[k], reset_after, k == 1) for k in (0, 1)]
    launchers = _dwh_launchers(lib, "gru_dwh", ops, reset_after)
    check(launchers[1].n_part == dwh_split_plan(B, T, H)[0],
          f"{tag}: the card's split count differs from the Python mirror")
    check(gs.DWH_BODIES[lib.gru_dwh_body(launchers[0].buffers[0], 2, H)] == dwh_body(H),
          f"{tag}: the card's body differs from the Python mirror")
    _, total, sums = launchers
    total()
    first = sums.clone()
    total()
    torch.cuda.synchronize()
    check(torch.equal(first, sums), f"{tag}: dwh not bitwise run to run")
    got = [(first[k, 0, :3 * H * H].view(H, 3 * H), first[k, 0, 3 * H * H:]) for k in (0, 1)]
    rel = max(_rel_err(g, w, f"{tag} dir {k}", ("dwh", "dbh"), 1e-6)
              for k, (g, w) in enumerate(zip(got, want)))
    abs_err = max(_maxdiff(x, y) for g, w in zip(got, want) for x, y in zip(g, w))
    del got
    seed0 = _dwh_stacked_seed0(lib, gen, ops, reset_after)
    check(torch.equal(seed0, first[:, 0]), f"{tag}: stacked seed 0 differs from the pair")
    del seed0, first
    torch.cuda.empty_cache()
    return {"rel": rel, "abs": abs_err, "ops": ops, "want": want, "launchers": launchers,
            "body": dwh_body(H)}


def phase_gru_dwh(parent: str = "") -> dict:
    """[kernel B dwh]: csrc/gru_dwh.cu on a pair's stored rows at B=TRAIN_BATCH,
    T=GRU_T, both conventions, at each width of DWH_TIMED and, checked only,
    at DWH_CHECKED's (the mma.sync tile's odd widths): dwh/dbh against
    `gru_dwh_plain` within GRAD_RTOL of the largest entry, bitwise from run
    to run, seed 0 of a stacked launch bitwise the pair, the card's split
    count and body (`dwh_body`) the Python mirrors'; then, at DWH_TIMED,
    CUDA events in turns (kernel, library, parent, parent, library,
    kernel), the reduction with its partial sum beside one `torch.matmul` of
    the same product on prepared operands (float32, TF32 off; checked
    against the plain version too) and, where ``parent`` names an older
    csrc/gru_dwh.cu (the mma.sync tile at every width) or csrc/gru_wide.cu
    (the FMA reduction), that file's reduction and sum (held to the plain
    version as well); beside the plain version's time, the bound and each
    one's share of it. At DWH_WARP_H the kernel in turns with the warp
    body's reduction, the one that width runs, and the library call.
    Returns the kernels line's entry for csrc/gru_dwh.cu (its launches are
    counted on the [kernel B wide] paths)."""
    import torch

    from sed_crnn_torch.ops.kernels import gru_scan as gs
    from sed_crnn_torch.ops.kernels.gru_scan import gru_dwh_plain

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for torch.matmul")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(41)
    lib, old, old_name = gs._dwh_lib(), None, ""
    if parent:
        old, old_name = _dwh_parent(parent)
    B, T = TRAIN_BATCH, GRU_T
    times, checked, worst_rel, worst_abs = {}, {}, 0.0, 0.0
    for H, b, t in DWH_CHECKED:
        for reset_after in (False, True):
            tag = f"[kernel B dwh] H={H} B={b} T={t} reset_after={reset_after}"
            c = _dwh_check(lib, gen, H, b, t, reset_after, tag)
            worst_rel, worst_abs = max(worst_rel, c["rel"]), max(worst_abs, c["abs"])
            checked[f"{H}/{reset_after}"] = {"B": b, "T": t, "body": c["body"], "rel_err": c["rel"]}
            print(f"{tag}: {c['body']} body, vs plain {c['rel']:.3g} of max|dwh|, bitwise run to "
                  f"run, stacked seed 0 bitwise the pair")
            del c
            torch.cuda.empty_cache()
    for H in (DWH_WARP_H,) + DWH_TIMED:
        for reset_after in (False, True):
            tag = f"[kernel B dwh] H={H} reset_after={reset_after}"
            c = _dwh_check(lib, gen, H, B, T, reset_after, tag)
            ops, want = c["ops"], c["want"]
            worst_rel, worst_abs = max(worst_rel, c["rel"]), max(worst_abs, c["abs"])
            paths = {"kernel": c["launchers"]}
            if H == DWH_WARP_H:
                paths["warp"] = _dwh_launchers(gs._warp_lib(), "gru_warp", ops, reset_after)
            elif old is not None:
                paths["parent"] = _dwh_launchers(old, old_name, ops, reset_after)
            line = {"H": H, "B": B, "T": T, "reset_after": reset_after, "body": c["body"],
                    "splits": paths["kernel"][1].n_part, "kernel_rel_err": c["rel"]}
            del c
            for name, (_, total, sums) in paths.items():
                if name == "kernel":
                    continue
                total()
                first = sums.clone()
                total()
                torch.cuda.synchronize()
                check(torch.equal(first, sums), f"{tag} {name}: dwh not bitwise run to run")
                got = [(first[k, 0, :3 * H * H].view(H, 3 * H), first[k, 0, 3 * H * H:])
                       for k in (0, 1)]
                line[f"{name}_rel_err"] = max(_rel_err(g, w, f"{tag} {name} dir {k}",
                                                       ("dwh", "dbh"), 1e-6)
                                              for k, (g, w) in enumerate(zip(got, want)))
                del first, got
            fns = {name: total for name, (_, total, _) in paths.items()}
            fns["library"], lib_dwh = _dwh_library(ops, reset_after)
            line["library_rel_err"] = max(
                _rel_err((g,), (w[0],), f"{tag} torch.matmul dir {k}", ("dwh",))
                for k, (g, w) in enumerate(zip(lib_dwh, want)))
            del lib_dwh
            order = ("kernel", "library", "parent", "warp")
            turns = {k: [] for k in fns}
            for name in order + order[::-1]:
                if name in fns:
                    turns[name].append(cuda_ms(fns[name], reps=DWH_REPS[H], warmup=1))
            for name, v in turns.items():
                line[f"{name}_ms"] = float(np.mean(v))
                line[f"{name}_turns_ms"] = v
            line["kernel_dwh_ms"] = cuda_ms(paths["kernel"][0], reps=DWH_REPS[H], warmup=1)
            line["kernel_sum_ms"] = cuda_ms(paths["kernel"][1].sum, reps=DWH_REPS[H], warmup=1)
            if "parent" in paths:
                line["parent_dwh_ms"] = cuda_ms(paths["parent"][0], reps=DWH_REPS[H], warmup=1)
            if H > DWH_WARP_H:
                line["plain_ms"] = cuda_ms(lambda: [gru_dwh_plain(*ops[k], reset_after, k == 1)
                                                    for k in (0, 1)], reps=2, warmup=1)
            (line["bound_ms"], line["bound_by"]), line["fp32_bound_ms"] = _dwh_bound(B, T, H)
            for name in fns:
                line[f"{name}_bound_share"] = line["bound_ms"] / line[f"{name}_ms"]
            line["kernel_tflops"] = 2 * 2 * B * T * H * 3 * H / line["kernel_ms"] / 1e9
            times[f"{H}/{reset_after}"] = line
            turns_of = lambda k: ", ".join(f"{x:.4f}" for x in line[f"{k}_turns_ms"])  # noqa: E731
            others = ", ".join(f"{k} {line[f'{k}_ms']:.4f} (turns {turns_of(k)}; "
                               f"{line[f'{k}_bound_share']:.3f} of the bound)"
                               for k in fns if k != "kernel")
            print(f"{tag} B={B} T={T} pair, {line['body']} body, {line['splits']} splits: kernel "
                  f"(dwh + sum) {line['kernel_ms']:.4f} ms (turns {turns_of('kernel')}; dwh "
                  f"{line['kernel_dwh_ms']:.4f}, sum {line['kernel_sum_ms']:.4f}; "
                  f"{line['kernel_tflops']:.1f} TFLOP/s of the float32 product; "
                  f"{line['kernel_bound_share']:.3f} of the bound), {others}; "
                  f"plain {line.get('plain_ms', float('nan')):.3f}; bound {line['bound_ms']:.4f} "
                  f"({line['bound_by']}, 3xTF32 at 495 TFLOP/s), float32 bound "
                  f"{line['fp32_bound_ms']:.4f}; vs plain: "
                  + ", ".join(f"{k[:-8]} {v:.3g}" for k, v in line.items()
                              if k.endswith("_rel_err")) + " of max|dwh|; bitwise run to run, "
                  "stacked seed 0 bitwise the pair")
            del ops, want, paths, fns
            torch.cuda.empty_cache()
    t = times[f"{GRID_TIMED[0]}/True"]
    print(f"[kernel B dwh] checks and times in {time.perf_counter() - t0:.1f} s")
    return {"name": "gru_dwh_mma", "route": "cuda", "source": "sed_crnn_torch/csrc/gru_dwh.cu",
            "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:154",
            "shape": f"pair, B={B} T={T} H={GRID_TIMED[0]} reset_after=True: the dwh/dbh "
                     "reduction (split-K, 3xTF32 on the tensor cores: wgmma fed by TMA above "
                     "H = 64 at multiples of 4, mma.sync elsewhere) and its fixed-order "
                     "partial sum",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "bound_share": t["kernel_bound_share"],
            "library_ms": t["library_ms"],
            "library_variant": "one torch.matmul of the prepared L_p^T D_p, both directions' "
                               "three parts batched, float32 with TF32 off",
            "fp32_bound_ms": t["fp32_bound_ms"], "parent_given": parent or None,
            "times": times, "checked": checked}


def phase_gru_wide() -> dict:
    """[kernel B wide]: the wide, cluster and grid bodies' checks at every
    width, batch, convention, gate and direction, pair and stacked; the grid
    body's bits at forced K; the wide body's precision against float64
    (`_wide_precision`) and times at WIDE_TIMED; the cluster body's times at
    CLUSTER_TIMED and the grid body's at GRID_TIMED in turns with the
    library."""
    t0 = time.perf_counter()
    worst = _wide_checks()
    for body in ("wide", "cluster", "grid"):
        shapes = [s for s in WIDE_STACK_SHAPES if _body_of(s[3]) == body]
        stack = _stack_kernel_checks(shapes, "[kernel B wide]", seed=23)
        for k in worst[body]:
            worst[body][k] = max(worst[body][k], stack[k])
    forced = _grid_forced_k()
    widest = _grid_widest()
    worst["grid"]["fwd"] = max(worst["grid"]["fwd"], widest["fwd"])
    worst["grid"]["bwd"] = max(worst["grid"]["bwd"], widest["bwd"])
    precision = _wide_precision()
    times = {H: _wide_times(H) for H in WIDE_TIMED}
    cluster = _cluster_times()
    grid = {H: _grid_times(H) for H in GRID_TIMED}
    print(f"[kernel B wide] kernel checks and times in {time.perf_counter() - t0:.1f} s")
    return {"worst": worst["wide"], "cluster_worst": worst["cluster"], "times": times,
            "precision": precision, "cluster_times": cluster, "grid_worst": worst["grid"],
            "grid_times": grid, "grid_forced": forced}


def _wide_entry(wide: dict, paths: dict, train: dict, serving_err: float) -> dict:
    """The wide body's entry of the kernels line: one direction's residual
    forward at H=128, B=128 (the wide training path's shape) as the headline,
    beside one direction of `torch.nn.GRU` and the kernel at the library's
    convention; its times at every WIDE_TIMED width, its launches by path and
    worst errors."""
    t = wide["times"][128]
    worst = wide["worst"]
    return {"name": "gru_wide", "route": "cuda", "source": "sed_crnn_torch/csrc/gru_wide.cu",
            "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:94",
            "replaces_backward": "sed_crnn_tpu/ops/pallas/gru_scan.py:154",
            "shape": f"one direction, B={TRAIN_BATCH} T={GRU_T} H=128 reset_after=False, "
                     "residual forward",
            "max_abs_err": max(worst["fwd"], train["fwd"], serving_err),
            "bwd_max_rel_err": max(worst["bwd"], train["bwd"]),
            "dwh_max_rel_err": max(worst["dwh"], train["dwh"]),
            "ms": t["fwd_res_ms"], "plain_ms": t["fwd_res_plain_ms"],
            "bound_ms": t["fwd_res_bound_ms"], "bound_by": t["fwd_res_bound_by"],
            "library_ms": t["library_one_fwd_ms"], "library_variant": "reset_after=True, sigmoid",
            "variant_ms": t["variant_fwd_res_ms"], "launches_by_path": paths["launches"],
            "times": {str(h): v for h, v in wide["times"].items()},
            "precision_h128": {str(w): v for w, v in wide["precision"].items()},
            "at_h32": {k: train[k] for k in train if k.endswith("_at_32")}}


def _cluster_entry(wide: dict, paths: dict) -> dict:
    """The cluster body's entry of the kernels line: a pair's residual
    forward at H=CLUSTER_TIMED, B=TRAIN_BATCH, reset_after=True (the
    CLUSTER_SEDNET training path's width) as the headline, beside a
    bidirectional `torch.nn.GRU`'s forward; its other times, its launches by
    path and worst errors."""
    t = wide["cluster_times"]
    worst = wide["cluster_worst"]
    return {"name": "gru_cluster", "route": "cuda", "source": "sed_crnn_torch/csrc/gru_cluster.cu",
            "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:94",
            "replaces_backward": "sed_crnn_tpu/ops/pallas/gru_scan.py:154",
            "shape": f"pair, B={TRAIN_BATCH} T={GRU_T} H={t['H']} reset_after=True, residual "
                     "forward",
            "max_abs_err": max(worst["fwd"], t["fwd_res_cluster_err"], t["fwd_b1_cluster_err"]),
            "bwd_max_rel_err": max(worst["bwd"], t["bwd_cluster_rel_err"]),
            "dwh_max_rel_err": worst["dwh"],
            "ms": t["fwd_res_cluster_ms"], "plain_ms": t["fwd_res_plain_ms"],
            "bound_ms": t["fwd_res_bound_ms"], "bound_by": t["fwd_res_bound_by"],
            "library_ms": t["fwd_res_library_ms"],
            "library_variant": "bidirectional torch.nn.GRU, reset_after=True, sigmoid",
            "launches_by_path": paths["cluster_launches"],
            "train_step": {k: paths["cluster_step"][k] for k in ("loss_rel", "grad_rel", "bn")},
            "serving_prob_err": paths["cluster_serving"]["prob_err"],
            "serving_logit_err": paths["cluster_serving"]["logit_err"],
            "times": t}


def _grid_entries(wide: dict, paths: dict) -> list:
    """The grid body's two entries of the kernels line, at H=GRID_TIMED[0],
    T=GRU_T, reset_after=True (the GRID_SEDNET paths' width), each beside a
    bidirectional `torch.nn.GRU`: the forward (a pair's residual forward at
    B=TRAIN_BATCH as the headline, the B=1 forward and H=2048 beside it) and
    the backward chain (the pair's whole backward at B=TRAIN_BATCH, the
    chain then csrc/gru_dwh.cu's dwh reduction and sum, so that its time, plain
    version, bound and library time are of one function: dxp, dwh, dbh and
    dh0; the chain's own time and bound beside it). Launches by kind on the
    grid paths."""
    t, t2 = wide["grid_times"][GRID_TIMED[0]], wide["grid_times"][GRID_TIMED[1]]
    worst = wide["grid_worst"]
    counts = paths["grid_counts"]
    common = {"route": "cuda", "source": "sed_crnn_torch/csrc/gru_grid.cu",
              "library_variant": "bidirectional torch.nn.GRU, reset_after=True, sigmoid",
              "forced_k": wide["grid_forced"]["forced_k"]}
    chain_bound = _chain_bound(TRAIN_BATCH, GRU_T, t["H"])
    fwd = {"name": "gru_grid_fwd", "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:94",
           "shape": f"pair, B={TRAIN_BATCH} T={GRU_T} H={t['H']} reset_after=True, residual "
                    "forward", "launches": counts["fwd"],
           "max_abs_err": max(worst["fwd"], t["fwd_res_err"], t["fwd_b1_err"],
                              t2["fwd_res_err"]),
           "ms": t["fwd_res_grid_ms"], "plain_ms": t["fwd_res_plain_ms"],
           "bound_ms": t["fwd_res_bound_ms"], "bound_by": t["fwd_res_bound_by"],
           "library_ms": t["fwd_res_library_ms"], **common,
           "b1_ms": t["fwd_b1_grid_ms"], "b1_library_ms": t["fwd_b1_library_ms"],
           "b1_plain_ms": t["fwd_b1_plain_ms"], "b1_bound_ms": t["fwd_b1_bound_ms"],
           "h2048_ms": t2["fwd_res_grid_ms"], "h2048_library_ms": t2["fwd_res_library_ms"],
           "h2048_bound_ms": t2["fwd_res_bound_ms"], "launches_by_path": counts["fwd_by_path"],
           "train_step": {k: paths["grid_step"][k] for k in ("loss_rel", "grad_rel", "bn")},
           "serving_prob_err": paths["grid_serving"]["prob_err"],
           "serving_logit_err": paths["grid_serving"]["logit_err"],
           "serving_window_err": paths["grid_serving"]["window_err"]}
    bwd = {"name": "gru_grid_bwd", "replaces": "sed_crnn_tpu/ops/pallas/gru_scan.py:154",
           "shape": f"pair, B={TRAIN_BATCH} T={GRU_T} H={t['H']} reset_after=True, the "
                    "backward: the chain (dxp, dh0), then dwh, dbh by gru_dwh_wgmma + "
                    "gru_dwh_sum (csrc/gru_dwh.cu)", "launches": counts["bwd"],
           "max_abs_err": max(t["bwd_abs_err"], t2["bwd_abs_err"]),
           "bwd_max_rel_err": max(worst["bwd"], t["bwd_rel_err"],
                                                               t2["bwd_rel_err"]),
           "dwh_max_rel_err": worst["dwh"],
           "ms": t["bwd_grid_ms"], "plain_ms": t["bwd_plain_ms"],
           "bound_ms": t["bwd_bound_ms"], "bound_by": t["bwd_bound_by"],
           "library_ms": t["bwd_library_ms"], **common,
           "chain_ms": t["bwd_chain_ms"], "chain_bound_ms": chain_bound[0],
           "chain_bound_by": chain_bound[1], "dwh_ms": t["bwd_dwh_ms"],
           "sum_ms": t["bwd_sum_ms"], "h2048_chain_ms": t2["bwd_chain_ms"], "h2048_ms": t2["bwd_grid_ms"],
           "h2048_library_ms": t2["bwd_library_ms"], "h2048_bound_ms": t2["bwd_bound_ms"],
           "launches_by_path": counts["bwd_by_path"]}
    return [fwd, bwd]


def _chain_bound(B: int, T: int, H: int):
    """The least work of a pair's backward chain alone (dxp and dh0; dwh is
    the next kernel's): its reads and writes, and 2 x 3H x H FMAs a row a
    step for the gate-gradient products -> (ms, what bounds it)."""
    f, RW = 4, 4 * H
    n_bytes = 2 * f * (B * T * H + B * T * RW + H * 3 * H + 2 * B * H + B * T * H + B * T * 3 * H
                       + B * H)
    n_flops = 2 * T * B * (2 * H * 3 * H + 20 * H)
    return bound_ms(n_bytes, n_flops)


def _wide_serving(cfg, best: str) -> dict:
    """The wide model's checkpoint served on the card and the CPU:
    `stream_logits` over 40 chunks at B=1 with the GRU state carried, and
    `forward_probabilities` at B=256 (the CPU on its first 16 windows); logits
    within LOGIT_ATOL, probabilities within PROB_ATOL, events equal, exact
    launch counts, no plain version on the card."""
    import torch

    from sed_crnn_torch.apps.infer import load_model
    from sed_crnn_torch.core.checkpoint import load_checkpoint
    from sed_crnn_torch.data.rasterize import events_from_labels
    from sed_crnn_torch.models.streaming import stream_logits
    from sed_crnn_torch.train.evaluate import forward_probabilities

    m = cfg.model
    tree, _ = load_checkpoint(best)
    card, cpu = load_model(tree, m, "cuda"), load_model(tree, m, "cpu")
    rng = np.random.default_rng(24)
    n_chunks = 40
    mel = torch.from_numpy(rng.standard_normal((n_chunks * m.seq_len_in - 100, m.n_mels))
                           .astype(np.float32))
    out_hop = cfg.frontend.hop_length * (m.seq_len_in // m.seq_len_out)
    layers = len(m.gru_hidden)

    def events(p):
        return events_from_labels(np.asarray(p), SR, out_hop, 0.5)

    _reset_gru_counts()
    t0 = time.perf_counter()
    with _no_plain_gru_on_card() as plain_on_card:
        logits = stream_logits(card, mel.cuda())
        torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    counts = _gru_counts()
    want = _gru_path_counts(layers * n_chunks, 0, "wide")
    check(counts == want and not plain_on_card, f"wide streaming launches {counts} != {want}")
    logits_cpu = stream_logits(cpu, mel)
    logit_err = _maxdiff(logits.cpu(), logits_cpu)
    check(bool(torch.isfinite(logits).all()) and logit_err <= LOGIT_ATOL,
          f"wide streaming logits card vs CPU {logit_err}")
    ev, ev_cpu = events(torch.sigmoid(logits).cpu()), events(torch.sigmoid(logits_cpu))
    check(ev == ev_cpu, "wide streaming: card and CPU events differ")
    xw = rng.standard_normal((300, m.seq_len_in, m.n_mels)).astype(np.float32)
    _reset_gru_counts()
    with _no_plain_gru_on_card() as plain_on_card:
        probs = forward_probabilities([card], xw, 256)
        torch.cuda.synchronize()
    counts = _gru_counts()
    want = _gru_path_counts(layers * 2, 0, "wide")
    check(counts == want and not plain_on_card, f"wide forward_probabilities launches {counts}")
    probs_cpu = forward_probabilities([cpu], xw[:16], 16)
    prob_err = _maxdiff(probs[:16].cpu(), probs_cpu)
    check(prob_err <= PROB_ATOL, f"wide forward_probabilities card vs CPU {prob_err}")
    flat = lambda p: p.reshape(-1, p.shape[-1]).cpu()  # noqa: E731
    check(events(flat(probs[:16])) == events(flat(probs_cpu)),
          "wide forward_probabilities: card and CPU events differ")
    audio = n_chunks * m.seq_len_in / FRAMES_PER_SEC
    print(f"[kernel B wide] serving gru_hidden {tuple(m.gru_hidden)}: stream_logits {n_chunks} "
          f"chunks at B=1, card vs CPU logits {logit_err:.3g}, {len(ev)} events equal, "
          f"{stream_s:.3f} s on the card ({audio / stream_s:,.0f} audio-sec/sec, first call); "
          f"forward_probabilities 300 windows at B=256, card vs CPU on 16 windows {prob_err:.3g}, "
          f"events equal; launches exact")
    return {"launches": layers * (n_chunks + 2), "logit_err": logit_err, "prob_err": prob_err}


def _cudnn_deterministic():
    """cuDNN held to deterministic algorithms (float32, no TF32) inside the
    block. Stacked and sequential training are two float32 orderings of one
    function whose gap training grows step by step (`_stack_divergence`);
    cuDNN's default convolution algorithms add run-to-run noise of the same
    size (timepooled-v2 with WIDE_V2's GRUs on an H100: the worst loss gap read 0.064 to
    0.098 over five runs, 0.0621 twice with these algorithms), so the wide
    path compares the modes with them."""
    import torch

    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def _stack_divergence(cfg, steps: int) -> list:
    """Per train step of STACK_RUNS seeds of ``cfg``, from one init on the
    same batches and dropout masks, the largest relative gap over seeds
    between the stacked step's loss and the sequential steps' (`_step_fns`)."""
    import torch

    stacked_step, sequential_steps = _step_fns(cfg, STACK_RUNS, torch.device("cuda"))
    gaps = []
    for _ in range(steps):
        a, b = stacked_step(), sequential_steps()
        gaps.append(float(((a - b).abs() / b.abs()).max()))
    return gaps


def _wide_stacked(workdir: str) -> dict:
    """timepooled-v2 with WIDE_V2's GRUs, 5 seeds at batch 128: one
    `MultiSeedTrainer` step with one launch of each kernel per BiGRU layer
    for all seeds; the kernels at that step's GRU shape (seed 0 bitwise the
    unstacked pair); `run_experiment_multiseed` stacked against sequential,
    histories within STACK_LOSS_RTOL / STACK_METRIC_ATOL, equal best epochs,
    exact launch counts."""
    import torch

    from sed_crnn_torch.apps.train import synthetic_folds
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.train.loop import make_samplers
    from sed_crnn_torch.train.multiseed import run_experiment_multiseed

    dev = torch.device("cuda")
    cfg = get_preset("timepooled-v2")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **WIDE_V2),
                      train=dataclasses.replace(cfg.train, max_epochs=STACK_EPOCHS, plot_every=0))
    m, batch = cfg.model, cfg.train.batch_size
    layers = len(m.gru_hidden)
    stacked_step, _ = _step_fns(cfg, STACK_RUNS, dev)
    stacked_step()
    torch.cuda.synchronize()
    _reset_gru_counts()
    with _no_plain_gru_on_card() as plain_on_card:
        stacked_step()
        torch.cuda.synchronize()
    counts = _gru_counts()
    want = _gru_path_counts(0, layers, "wide", m.gru_hidden)
    check(counts == want and not plain_on_card, f"wide stacked step launches {counts} != {want}")
    step_ms = _median_ms(stacked_step, reps=5)
    worst = _stack_kernel_checks([(STACK_RUNS, batch, m.seq_len_out, h) for h in
                                  sorted(set(m.gru_hidden))], "[kernel B wide]", seed=25)

    frames = max(8000, int(batch * m.seq_len_in * 1.3))
    folds = synthetic_folds(1, frames=frames, n_classes=m.n_classes, n_mels=m.n_mels)
    tr, val = make_samplers(cfg, folds[1], dev)
    n_train = tr.steps_per_epoch(batch)
    n_val = max(1, val.steps_per_epoch(batch, drop_last=False))
    runs, wide_launches = {}, 0
    for mode in ("stacked", "sequential"):
        _reset_gru_counts()
        t0 = time.perf_counter()
        with _no_plain_gru_on_card() as plain_on_card, _cudnn_deterministic():
            runs[mode] = run_experiment_multiseed(cfg, folds, os.path.join(workdir, mode),
                                                  n_runs=STACK_RUNS, verbose=False, mode=mode,
                                                  device="cuda")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _gru_counts()
        per = 1 if mode == "stacked" else STACK_RUNS
        want = _gru_path_counts(per * layers * n_val * STACK_EPOCHS,
                                per * layers * n_train * STACK_EPOCHS, "wide", m.gru_hidden)
        check(counts == want and not plain_on_card,
              f"wide --runs-mode {mode} launches {counts} != {want}")
        if mode == "stacked":
            wide_launches = counts["gru_wide"]
        print(f"[kernel B wide] run_experiment_multiseed timepooled-v2 gru_hidden "
              f"{tuple(m.gru_hidden)} x{STACK_RUNS} {mode}: {STACK_EPOCHS} epochs x {n_train} "
              f"train + {n_val} validation steps in {wall:.2f} s; launches {counts}")
    worst_loss = worst_metric = 0.0
    worst_at = None
    for j, s in enumerate(runs["stacked"]["seeds"]):
        a, b = runs["stacked"]["folds"][1][j], runs["sequential"]["folds"][1][j]
        check((a.best_epoch, a.epochs_run) == (b.best_epoch, b.epochs_run),
              f"wide seed {s}: best epoch {a.best_epoch} vs {b.best_epoch}")
        for k, v in b.history.items():
            g, w = np.asarray(a.history[k]), np.asarray(v)
            if k.startswith("loss"):
                e = float(np.max(np.abs(g - w) / np.abs(w)))
                check(e <= STACK_LOSS_RTOL, f"wide seed {s} {k}: stacked {g} vs sequential {w}")
                if e > worst_loss:
                    worst_loss, worst_at = e, (s, k, g.tolist(), w.tolist())
            else:
                e = float(np.max(np.abs(g - w)))
                check(e <= STACK_METRIC_ATOL, f"wide seed {s} {k}: stacked {g} vs sequential {w}")
                worst_metric = max(worst_metric, e)
    print(f"[kernel B wide] stacked step {STACK_RUNS} seeds at batch {batch}: {step_ms:.2f} ms "
          f"host clock, one launch of each kernel per layer; stacked vs sequential histories "
          f"within {worst_loss:.3g} relative (band {STACK_LOSS_RTOL}; seed {worst_at[0]} "
          f"{worst_at[1]} stacked {worst_at[2]} vs sequential {worst_at[3]}), ER/F1 within "
          f"{worst_metric:.3g} (band {STACK_METRIC_ATOL}), equal best epochs")
    # Where the gap between the modes comes from: their per-step losses from
    # one init, with the preset's GRUs and WIDE_V2's, bf16 and float32 trunks.
    gaps = {}
    for gru in (get_preset("timepooled-v2").model.gru_hidden, m.gru_hidden):
        for trunk in ("bfloat16", "float32"):
            c = cfg.replace(model=dataclasses.replace(m, gru_hidden=gru, compute_dtype=trunk))
            with _cudnn_deterministic():
                g = _stack_divergence(c, STACK_EPOCHS * n_train)
            gaps[f"{tuple(gru)} {trunk}"] = g
            print(f"[kernel B wide] stacked vs sequential step losses, timepooled-v2 gru_hidden "
                  f"{tuple(gru)}, {trunk} trunk, {STACK_RUNS} seeds from one init: largest "
                  f"relative gap over seeds at steps 1, 2, 5, 10, 20, {len(g)}: "
                  f"{', '.join(f'{g[i - 1]:.3g}' for i in (1, 2, 5, 10, 20, len(g)))}; "
                  f"max {max(g):.3g}")
    return {"launches": 2 * layers + wide_launches, "worst": worst, "step_ms": step_ms,
            "loss_rel": worst_loss, "metric": worst_metric, "step_gaps": gaps}


def phase_wide_paths(workdir: str, pcm: np.ndarray) -> dict:
    """[kernel B wide]'s full-width paths: on the wide body `run_fold` and a
    card-vs-CPU train step of sednet-dcase with WIDE_SEDNET's GRUs, that
    checkpoint served, and stacked multi-seed timepooled-v2 with WIDE_V2's;
    on the cluster body (CLUSTER_SEDNET) and on the grid body (GRID_SEDNET)
    a card-vs-CPU train step of sednet-dcase and that model served on the
    120 s wav. Returns each body's launches on each path and the errors."""
    t0 = time.perf_counter()
    train_launches, cfg, _ = phase_train(os.path.join(workdir, "train"), WIDE_SEDNET,
                                         "[kernel B wide] train")
    step = phase_train_step(WIDE_SEDNET, "[kernel B wide] train step")
    serving = _wide_serving(cfg, os.path.join(workdir, "train", "fold1", "best_fold1.npz"))
    stacked = _wide_stacked(os.path.join(workdir, "stacked"))
    launches = {"train": train_launches["gru_wide"] + step["launches"],
                "serving": serving["launches"], "stacked": stacked["launches"]}
    check(all(v > 0 for v in launches.values()), f"wide body launches by path {launches}")
    cluster_step = phase_train_step(CLUSTER_SEDNET, "[kernel B wide] cluster train step")
    os.makedirs(os.path.join(workdir, "cluster"))
    cluster_serving = _body_serving(os.path.join(workdir, "cluster"), pcm, CLUSTER_SEDNET,
                                    "cluster", 28)
    cluster_launches = {"train": cluster_step["launches"], "serving": cluster_serving["launches"]}
    check(all(v > 0 for v in cluster_launches.values()),
          f"cluster body launches by path {cluster_launches}")
    t1 = time.perf_counter()
    grid_step = phase_train_step(GRID_SEDNET, "[kernel B wide] grid train step")
    os.makedirs(os.path.join(workdir, "grid"))
    grid_serving = _body_serving(os.path.join(workdir, "grid"), pcm, GRID_SEDNET, "grid", 30)
    grid_launches = {"train": grid_step["launches"], "serving": grid_serving["launches"]}
    c = grid_step["counts"]
    grid_counts = {"fwd": c["gru_scan_fwd_res"] + grid_serving["launches"],
                   "bwd": c["gru_scan_bwd"],
                   "fwd_by_path": {"train": c["gru_scan_fwd_res"],
                                   "serving": grid_serving["launches"]},
                   "bwd_by_path": {"train": c["gru_scan_bwd"]}}
    check(all(v > 0 for v in grid_launches.values()) and grid_counts["fwd"] > 0
          and grid_counts["bwd"] > 0, f"grid body launches by path {grid_launches}")
    # csrc/gru_dwh.cu: the dwh reduction of every train step above the warp body
    dwh_launches = {"wide_train": train_launches["gru_dwh_mma"] + step["counts"]["gru_dwh_mma"],
                    "cluster_train": cluster_step["counts"]["gru_dwh_mma"],
                    "grid_train": grid_step["counts"]["gru_dwh_mma"]}
    check(all(v > 0 for v in dwh_launches.values()), f"gru_dwh launches by path {dwh_launches}")
    # its wgmma body: every one of these widths (128, 256, 1024) takes it
    wgmma_launches = {"wide_train": train_launches["gru_dwh_wgmma"]
                      + step["counts"]["gru_dwh_wgmma"],
                      "cluster_train": cluster_step["counts"]["gru_dwh_wgmma"],
                      "grid_train": grid_step["counts"]["gru_dwh_wgmma"]}
    check(wgmma_launches == dwh_launches,
          f"gru_dwh wgmma launches by path {wgmma_launches} != {dwh_launches}")
    print(f"[kernel B wide] the wide body's launches by path {launches}, the cluster body's "
          f"{cluster_launches}, the grid body's {grid_launches} (grid paths in "
          f"{time.perf_counter() - t1:.1f} s); paths in {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "step": step, "serving": serving, "stacked": stacked,
            "cluster_launches": cluster_launches, "cluster_step": cluster_step,
            "cluster_serving": cluster_serving, "grid_launches": grid_launches,
            "grid_step": grid_step, "grid_serving": grid_serving, "grid_counts": grid_counts,
            "dwh_launches": dwh_launches, "dwh_wgmma_launches": wgmma_launches}


PARALLEL_EPOCHS = 2
PARALLEL_HALF = 64          # each rank's share of the fixed global batch of 128
PARALLEL_GRAD_RTOL = 1e-4   # two ranks vs one device on the same arithmetic: gradients,
                            # of each leaf's largest
# Two ranks vs one device's step on the whole batch: gradients, of each
# leaf's largest. The two ranks reduce BatchNorm's moments as the mean of
# the halves' moments; that alone, on one device with no collective, moves
# this step's gradient by 1.6e-4 of /conv/1/w's largest, and cuDNN against
# torch's own convolutions moves it by 2.9e-4 of /conv/0/w's (an H100
# 80GB HBM3 at 700 W, ``[parallel]``'s own readings), so 1e-4 is below this
# step's float32 spread.
PARALLEL_WHOLE_GRAD_RTOL = 4e-4
PARALLEL_ATOL = 1e-5        # two ranks vs one: BatchNorm statistics, parameters
PARALLEL_TIMEOUT_S = 600    # the two spawned ranks, build and all


def _dp_cfg():
    """sednet-dcase at full width for the [parallel] phase: 2 epochs,
    dropout 0 (the two-rank comparison holds one step to bands)."""
    from sed_crnn_torch.core.config import get_preset

    cfg = get_preset("sednet-dcase")
    return cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0),
                       train=dataclasses.replace(cfg.train, max_epochs=PARALLEL_EPOCHS,
                                                 plot_every=0))


def _tree_gaps(a: dict, b: dict) -> list:
    """(max |a - b|, path) of every leaf two checkpoint trees hold."""
    fa, fb = dict(_leaves(a)), dict(_leaves(b))
    check(set(fa) == set(fb), f"checkpoint trees differ in leaves: {set(fa) ^ set(fb)}")
    return sorted(((float(np.abs(fa[k].astype(np.float64) - fb[k]).max()) if fa[k].size
                    else 0.0, k) for k in fa), reverse=True)


def _step_gaps(got: dict, want: dict, grad_rtol: float) -> dict:
    """How far one step's checkpoint tree is from another's: per leaf, Adam's
    first moment (the gradient, scaled) as a share of the leaf's largest
    (``grad``; a conv bias ahead of train-mode BatchNorm, whose exact
    gradient is 0, as a share of the tree's scale, ``zero_grad``), the
    parameters (``param`` all, ``param_clear`` where the gradient is clear of
    ``grad_rtol``: Adam's first step moves an element by about lr * sign(g)
    whatever |g| is), and the BatchNorm statistics (``bn``)."""
    mu_g, mu_w = dict(_leaves(got["opt_state"]["mu"])), dict(_leaves(want["opt_state"]["mu"]))
    tree_scale = max(float(np.abs(a).max()) for a in mu_w.values())
    out = {"grad": {}, "zero_grad": {}, "param": {}, "param_clear": {}}
    for (path, p_g), (_, p_w) in zip(_leaves(got["params"]), _leaves(want["params"])):
        g, w = mu_g[path], mu_w[path]
        out["param"][path] = float(np.abs(p_g - p_w).max())
        if path.startswith("/conv/") and path.endswith("/b"):
            out["zero_grad"][path] = max(float(np.abs(g).max()),
                                         float(np.abs(w).max())) / tree_scale
            continue
        scale = float(np.abs(w).max())
        out["grad"][path] = float(np.abs(g - w).max()) / scale
        clear = np.abs(w) > grad_rtol * scale
        out["param_clear"][path] = float(np.abs(p_g[clear] - p_w[clear]).max()) if clear.any() \
            else 0.0
    out["bn"] = max(float(np.abs(a - b).max()) for (_, a), (_, b) in
                    zip(_leaves(got["model_state"]), _leaves(want["model_state"])))
    return out


def _check_step_gaps(tag: str, gaps: dict, lr: float, grad_band: dict, atol: float) -> None:
    """Hold `_step_gaps` to bands: each leaf's gradient to ``grad_band``
    (by path), a conv bias ahead of BatchNorm to 1e-4 of the tree's scale,
    the parameters to ``atol`` where the gradient is clear of the band and
    2 lr elsewhere, the BatchNorm statistics to ``atol``."""
    for path, v in gaps["param"].items():
        check(v <= 2 * lr + atol, f"{tag} {path} after Adam: {v}")
    for path, v in gaps["zero_grad"].items():
        check(v <= 1e-4, f"{tag} {path}: gradient of a bias ahead of BatchNorm is not ~0")
    for path, v in gaps["grad"].items():
        check(v <= grad_band[path], f"{tag} gradient {path}: {v:.3g} of its max "
              f"(band {grad_band[path]:.3g})")
    for path, v in gaps["param_clear"].items():
        check(v <= atol, f"{tag} {path} after Adam: {v}")
    check(gaps["bn"] <= atol, f"{tag} BatchNorm running statistics {gaps['bn']}")


def _collective_sizes(model) -> list:
    """Floats per all_reduce of one data-parallel train step: the flat
    gradient, then each BatchNorm's packed (mean, mean_sq, n) forward and its
    backward."""
    from sed_crnn_torch.nn.layers import BatchNorm2d

    n_params = sum(p.numel() for p in model.parameters())
    bns = [2 * m.weight.numel() + 1 for m in model.modules() if isinstance(m, BatchNorm2d)]
    return [n_params] + bns + bns


def _collectives_ms(mesh, sizes: list, reps: int = 10) -> float:
    """Host-clock milliseconds of one step's all_reduces alone (``sizes``
    floats each, on the mesh's device), the device synchronized."""
    import torch

    from sed_crnn_torch.parallel.mesh import all_reduce_sum

    bufs = [torch.zeros(n, device=mesh.device) for n in sizes]
    times = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bufs:
            all_reduce_sum(b, mesh)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _dp_step_fn(trainer, x, y):
    """One train step of ``trainer`` on (x, y), its state carried."""
    from sed_crnn_torch.train.loop import TrainState

    box = [TrainState(trainer.adam.init({k: p.detach() for k, p in trainer.params().items()}),
                      1.0)]

    def step():
        box[0], _, _ = trainer.train_step(box[0], x, y)

    return step, box


def _median_step_ms(step, reps: int = 8) -> float:
    import torch

    for _ in range(2):
        step()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _parallel_rank(payload: dict) -> dict:
    """One of two ranks on ``cuda:0`` over gloo (spawned by `_two_ranks`):
    the fixed global batch's step on its half, 2 more steps, the sweep at
    the initial parameters, per-rank times and bytes, exact launch counts."""
    import torch
    import torch.distributed as dist

    from sed_crnn_torch.models import get_model
    from sed_crnn_torch.parallel import mesh as mesh_mod
    from sed_crnn_torch.parallel.data_parallel import DataParallelTrainer
    from sed_crnn_torch.train.loop import checkpoint_tree, make_samplers

    mesh = mesh_mod.make_mesh(2, device="cuda:0")
    check(dist.get_backend() == "gloo" and mesh.device == torch.device("cuda", 0),
          f"rank {mesh.rank}: {dist.get_backend()} on {mesh.device}")
    cfg, r, dev = payload["cfg"], mesh.rank, mesh.device
    model = get_model(cfg.model)
    model.load_state_dict(payload["state_dict"])
    tr, val = make_samplers(cfg, payload["fold"], dev)
    trainer = DataParallelTrainer(model.to(dev), cfg.train, tr, val, mesh)
    check(trainer.local_batch == PARALLEL_HALF, f"local batch {trainer.local_batch}")
    sweep = {k: float(v) for k, v in trainer.eval_sweep(None).items()}
    half = slice(PARALLEL_HALF * r, PARALLEL_HALF * (r + 1))
    x = torch.from_numpy(payload["x"][half]).to(dev)
    y = torch.from_numpy(payload["y"][half]).to(dev)
    step, box = _dp_step_fn(trainer, x, y)
    _reset_gru_counts()
    mesh_mod.reset_counts()
    with _no_plain_gru_on_card() as plain_on_card:
        step()
        torch.cuda.synchronize()
    launches = _gru_counts()
    per_step = dict(mesh_mod.counts)
    first = checkpoint_tree(trainer, box[0])
    rngs = trainer.replica_rngs(dev, 7)
    for _ in range(2):
        xb, yb = tr.sample_batch(rngs.batch, trainer.local_batch)
        box[0], _, _ = trainer.train_step(box[0], xb, yb)
    third = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    step_ms = _median_step_ms(step)
    sizes = _collective_sizes(model)
    coll_ms, grad_ms = _collectives_ms(mesh, sizes), _collectives_ms(mesh, sizes[:1])
    # the same first step with BatchNorm's reduction hidden from autograd
    model.load_state_dict(payload["state_dict"])
    step, box = _dp_step_fn(trainer, x, y)
    differentiable = mesh_mod.all_reduce_sum_grad
    mesh_mod.all_reduce_sum_grad = mesh_mod.all_reduce_sum
    try:
        step()
    finally:
        mesh_mod.all_reduce_sum_grad = differentiable
    return {"rank": r, "sweep": sweep, "first": first, "third": third, "launches": launches,
            "plain_on_card": plain_on_card, "per_step": per_step, "step_ms": step_ms,
            "collectives_ms": coll_ms, "grad_ms": grad_ms,
            "detached": checkpoint_tree(trainer, box[0])}


@contextlib.contextmanager
def _conv_by_halves():
    """Every `Conv2d` of the port run on the batch's two halves apart (a
    rank's convolutions at the local batch), inside the block."""
    import torch

    from sed_crnn_torch.nn.layers import Conv2d

    whole = Conv2d.forward
    Conv2d.forward = lambda self, x: torch.cat([whole(self, h) for h in x.chunk(2)])
    try:
        yield
    finally:
        Conv2d.forward = whole


@contextlib.contextmanager
def _bn_moments_by_halves():
    """Train-mode `BatchNorm2d` with its moments taken as the mean of the
    batch halves' moments (two ranks' cross-replica reduction, on one
    device), inside the block: a plain restatement of the layer's float32
    train forward."""
    import torch

    from sed_crnn_torch.nn.layers import BatchNorm2d

    whole = BatchNorm2d.forward

    def forward(self, x):
        if not self.training:
            return whole(self, x)
        halves = x.float().chunk(2)
        mean = sum(h.mean(dim=(0, 2, 3)) for h in halves) / 2.0
        mean_sq = sum((h * h).mean(dim=(0, 2, 3)) for h in halves) / 2.0
        n = float(x.numel() // x.shape[1])
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var * n / (n - 1.0))
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        shape = (1, -1, 1, 1)
        return (x - mean.view(shape)) * inv.view(shape) + self.bias.float().view(shape)

    BatchNorm2d.forward = forward
    try:
        yield
    finally:
        BatchNorm2d.forward = whole


@contextlib.contextmanager
def _halves_arithmetic():
    """Two ranks' arithmetic on one device: convolutions on the halves,
    BatchNorm's moments as the mean of the halves'."""
    with _conv_by_halves(), _bn_moments_by_halves():
        yield


def _two_ranks(cfg, fold, state_dict, x, y) -> dict:
    """Two ranks on one card over gloo against one device's step on the same
    arithmetic (`_halves_arithmetic`) and on the whole batch, a BatchNorm
    reduction hidden from autograd against the latter, the sweep against one
    device's, parameters across ranks."""
    import torch

    from sed_crnn_torch.models import get_model
    from sed_crnn_torch.parallel import mesh as mesh_mod
    from sed_crnn_torch.train.loop import Trainer, checkpoint_tree, make_samplers

    dev = torch.device("cuda")
    payload = {"cfg": cfg, "fold": fold, "state_dict": state_dict, "x": x, "y": y}
    t0 = time.perf_counter()
    ranks = mesh_mod.spawn_ranks(_parallel_rank, 2, (payload,), device="cuda:0",
                                 backend="gloo", timeout=PARALLEL_TIMEOUT_S)
    wall = time.perf_counter() - t0

    model = get_model(cfg.model)
    model.load_state_dict(state_dict)
    tr, val = make_samplers(cfg, fold, dev)
    trainer = Trainer(model.to(dev), cfg.train, tr, val)
    one_sweep = {k: float(v) for k, v in trainer.eval_sweep(None).items()}
    def one_rank_step(order, flags=None):
        model.load_state_dict(state_dict)
        step, box = _dp_step_fn(trainer, torch.from_numpy(x[order]).to(dev),
                                torch.from_numpy(y[order]).to(dev))
        with flags or contextlib.nullcontext():
            step()
        return checkpoint_tree(trainer, box[0])

    n = x.shape[0]
    whole = np.arange(n)
    want = one_rank_step(whole)
    # one device, no collective: the two ranks' arithmetic, each part of it
    # alone, and torch's own convolutions in place of cuDNN's
    same = one_rank_step(whole, _halves_arithmetic())
    parts = {}
    for name, order, flags in (
            ("convolutions on the halves", whole, _conv_by_halves()),
            ("BatchNorm moments by halves", whole, _bn_moments_by_halves()),
            ("the batch reversed", whole[::-1].copy(), None),
            ("cuDNN off", whole, torch.backends.cudnn.flags(enabled=False, allow_tf32=False))):
        g = _step_gaps(one_rank_step(order, flags), want, PARALLEL_GRAD_RTOL)["grad"]
        parts[name] = max(g.items(), key=lambda kv: kv[1])
    lr = cfg.train.learning_rate
    gaps = [_step_gaps(r["first"], want, PARALLEL_GRAD_RTOL) for r in ranks]
    to_same = [_step_gaps(r["first"], same, PARALLEL_GRAD_RTOL) for r in ranks]
    detached = [max(_step_gaps(r["detached"], want, PARALLEL_GRAD_RTOL)["grad"].values())
                for r in ranks]
    for r, g, e, d in zip(ranks, gaps, to_same, detached):
        worst = max((v, k) for k, v in g["grad"].items())
        worst_same = max((v, k) for k, v in e["grad"].items())
        print(f"[parallel] gloo rank {r['rank']}/2 on cuda:0, local batch {PARALLEL_HALF}: "
              f"step {r['step_ms']:.2f} ms (host clock, median of 8), collectives alone "
              f"{r['collectives_ms']:.2f} ms (the gradient's {r['grad_ms']:.2f}), "
              f"{r['per_step']['collectives']} all_reduces {r['per_step']['bytes']:,} bytes per "
              f"step; gradients vs one device on the same arithmetic {worst_same[0]:.3g} of the "
              f"leaf max ({worst_same[1]}; band {PARALLEL_GRAD_RTOL:g}), vs one device's step on "
              f"all 128 {worst[0]:.3g} ({worst[1]}; band {PARALLEL_WHOLE_GRAD_RTOL:g}), with "
              f"BatchNorm's reduction hidden from autograd {d:.3g}; BatchNorm stats "
              f"{g['bn']:.3g}, parameters where the gradient is clear "
              f"{max(g['param_clear'].values()):.3g}; launches {r['launches']}")
    print("[parallel] one device's step on all 128 moved by (largest share of a leaf's max): "
          + "; ".join(f"{k} {v:.3g} ({p})" for k, (p, v) in parts.items()))
    for r, g, e, d in zip(ranks, gaps, to_same, detached):
        tag = f"[parallel] rank {r['rank']} vs one device"
        _check_step_gaps(f"{tag} on the same arithmetic", e, lr,
                         {k: PARALLEL_GRAD_RTOL for k in e["grad"]}, PARALLEL_ATOL)
        _check_step_gaps(f"{tag} on all 128", g, lr,
                         {k: PARALLEL_WHOLE_GRAD_RTOL for k in g["grad"]}, PARALLEL_ATOL)
        check(d > 100 * PARALLEL_WHOLE_GRAD_RTOL, f"{tag}: a BatchNorm reduction autograd "
              f"misses moves the gradient by only {d:.3g}")
    for k in ranks[0]["third"]:
        check(np.array_equal(ranks[0]["third"][k], ranks[1]["third"][k]),
              f"[parallel] {k} differs across ranks after 3 steps")
    for r in ranks:
        check(r["launches"] == _gru_path_counts(0, 2), f"rank {r['rank']} launches "
              f"{r['launches']}")
        check(not r["plain_on_card"], f"a GRU plain version ran on the card: {r['plain_on_card']}")
        for k, v in one_sweep.items():
            ok = abs(r["sweep"][k] - v) <= 1e-6 * abs(v) if k == "loss" else r["sweep"][k] == v
            check(ok, f"rank {r['rank']} sweep {k}: {r['sweep'][k]} vs {v}")
    sizes = _collective_sizes(model)
    check(ranks[0]["per_step"] == {"collectives": len(sizes), "bytes": 4 * sum(sizes)},
          f"collectives per step {ranks[0]['per_step']} vs {len(sizes)} of {sizes} floats")
    print(f"[parallel] gloo: parameters bitwise equal on both ranks after 3 steps; the sweep "
          f"(loss {ranks[0]['sweep']['loss']:.6f}, ER {ranks[0]['sweep']['er_overall_1sec']:.4f})"
          f" equals one device's; two ranks spawned and joined in {wall:.1f} s")
    return {"gloo_step_ms": [r["step_ms"] for r in ranks],
            "gloo_collectives_ms": [r["collectives_ms"] for r in ranks],
            "gloo_grad_ms": [r["grad_ms"] for r in ranks],
            "grad_rel": max(max(g["grad"].values()) for g in gaps),
            "grad_rel_same": max(max(e["grad"].values()) for e in to_same)}


def _dp_world1(workdir: str) -> dict:
    """Data parallelism at world size 1 over NCCL: `run_fold` with the
    data-parallel factory and ``apps.train --data-parallel 1`` against plain
    `run_fold`, deterministic cuDNN; the step against the plain step; the
    collectives alone; a profile of one step."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from sed_crnn_torch.apps import train as train_app
    from sed_crnn_torch.apps.train import synthetic_folds
    from sed_crnn_torch.core.checkpoint import load_checkpoint
    from sed_crnn_torch.models import get_model
    from sed_crnn_torch.models.convert import from_jax
    from sed_crnn_torch.parallel import mesh as mesh_mod
    from sed_crnn_torch.parallel.data_parallel import DataParallelTrainer
    from sed_crnn_torch.train.loop import Trainer, data_parallel_factory, make_samplers, run_fold

    cfg = _dp_cfg()
    dev = torch.device("cuda")
    frames = int(cfg.train.batch_size * cfg.model.seq_len_in * 1.3)   # as apps.train does
    fold = synthetic_folds(1, frames=frames, n_classes=cfg.model.n_classes)[1]
    tr, val = make_samplers(cfg, fold, dev)
    n_train, n_sweep = tr.steps_per_epoch(cfg.train.batch_size), val.sweep_steps(
        cfg.train.batch_size)
    dirs = {k: os.path.join(workdir, k) for k in ("plain", "dp", "cli")}
    with _cudnn_deterministic():
        plain = run_fold(cfg, fold, 1, dirs["plain"], device="cuda", verbose=False)
        mesh = mesh_mod.make_mesh(1, device="cuda")
        check(dist.get_backend() == "nccl" and mesh.size == 1, f"{dist.get_backend()} mesh")
        _reset_gru_counts()
        _reset_logmel_counts()
        mesh_mod.reset_counts()
        t0 = time.perf_counter()
        with _no_plain_gru_on_card() as plain_on_card:
            dp = run_fold(cfg, fold, 1, dirs["dp"], device=mesh.device, verbose=False,
                          trainer_factory=data_parallel_factory(mesh))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _gru_counts()
        collectives = dict(mesh_mod.counts)
        mesh.close()
        check(not plain_on_card, f"a GRU plain version ran on the card: {plain_on_card}")
        check(not any(_logmel_counts().values()), f"log-mel launches {_logmel_counts()}")
        want = _gru_path_counts(2 * n_sweep * PARALLEL_EPOCHS, 2 * n_train * PARALLEL_EPOCHS)
        check(launches == want, f"data-parallel run_fold launches {launches} != {want}")
        _reset_gru_counts()
        saved = train_app.get_preset
        train_app.get_preset = lambda name: _dp_cfg()
        try:
            cli, _ = _quiet(train_app.main, ["--synthetic", "--folds", "1", "--data-parallel", "1",
                                             "--art-dir", dirs["cli"], "--device", "cuda"])
        finally:
            train_app.get_preset = saved
        cli_launches = _gru_counts()
    check(dp.epochs_run == PARALLEL_EPOCHS and bool(np.isfinite(dp.history["loss_tr"]).all()),
          f"data-parallel run_fold history {dp.history}")
    (cli_run,) = os.listdir(dirs["cli"])
    runs = {"run_fold": (dp, dirs["dp"]),
            "apps.train": (cli["folds"][0], os.path.join(dirs["cli"], cli_run, "fold1"))}
    verdicts = []
    for name, (res, d) in runs.items():
        gaps = [g for ck in ("best_fold1.npz", "last_fold1.npz") for g in _tree_gaps(
            load_checkpoint(os.path.join(d, ck))[0],
            load_checkpoint(os.path.join(dirs["plain"], ck))[0])]
        if res.history == plain.history and gaps[0][0] == 0.0:
            verdicts.append(f"{name} bitwise run_fold's (histories, best and last checkpoints)")
            continue
        # not bitwise: name the leaf and hold the run to [train step]'s bands
        for k, v in plain.history.items():
            rel = np.abs(np.asarray(res.history[k]) - v) / np.maximum(np.abs(v), 1e-12)
            check(k.startswith("loss") and float(rel.max()) <= STEP_LOSS_RTOL
                  or not k.startswith("loss"), f"{name} history {k}: {res.history[k]} vs {v}")
        gaps = _step_gaps(load_checkpoint(os.path.join(d, "last_fold1.npz"))[0],
                          load_checkpoint(os.path.join(dirs["plain"], "last_fold1.npz"))[0],
                          STEP_GRAD_RTOL)
        _check_step_gaps(f"[parallel] {name}", gaps, cfg.train.learning_rate,
                         {k: STEP_GRAD_RTOL for k in gaps["grad"]}, STEP_PARAM_ATOL)
        verdicts.append(f"{name} NOT bitwise: largest gap {gaps[0][0]:.3g} at {gaps[0][1]}, "
                        f"within [train step]'s bands")
    print(f"[parallel] NCCL world size 1, sednet-dcase full width, {PARALLEL_EPOCHS} epochs x "
          f"{n_train} steps at batch {cfg.train.batch_size} + {n_sweep} sweep step(s), in "
          f"{wall:.2f} s: " + "; ".join(verdicts) + f"; launches {launches} (apps.train's "
          f"{cli_launches}); {collectives['collectives']} all_reduces, "
          f"{collectives['bytes']:,} bytes")

    # the step at batch 128: data-parallel at world size 1 against plain
    mesh = mesh_mod.make_mesh(1, device="cuda")
    params, state = model_tree(cfg.model, seed=11)
    state_dict = from_jax(params, state, cfg.model)
    # a decisive last layer: few probabilities near the 0.5 threshold, so the
    # sweep's scores cannot flip on the float32 rounding between batch-64 and
    # batch-128 convolutions (the two-rank comparison)
    last = [k for k in state_dict if k.startswith("head.") and k.endswith(".weight")][-1]
    state_dict[last] = state_dict[last] * 8.0
    rng = np.random.default_rng(12)
    x = rng.standard_normal((128, cfg.model.seq_len_in, cfg.model.n_mels)).astype(np.float32)
    y = (rng.random((128, cfg.model.seq_len_out, cfg.model.n_classes)) > 0.8).astype(np.float32)
    xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    def trainer_of(cls, *extra):
        model = get_model(cfg.model)
        model.load_state_dict(state_dict)
        return cls(model.to(dev), cfg.train, tr, val, *extra)

    plain_step, _ = _dp_step_fn(trainer_of(Trainer), xd, yd)
    dp_trainer = trainer_of(DataParallelTrainer, mesh)
    dp_step, _ = _dp_step_fn(dp_trainer, xd, yd)
    times = {}
    for turn in ("plain", "dp", "dp", "plain"):
        times.setdefault(turn, []).append(_median_step_ms(plain_step if turn == "plain"
                                                          else dp_step))
    sizes = _collective_sizes(dp_trainer.model)
    coll_ms = _collectives_ms(mesh, sizes)
    grad_ms = _collectives_ms(mesh, sizes[:1])
    wall_us = _median_step_ms(dp_step, reps=3) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dp_step()
        torch.cuda.synchronize()
    mesh.close()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    nccl_us = sum(e.self_device_time_total for e in rows
                  if "nccl" in e.key.lower() or "memcpy dtod" in e.key.lower())
    idle = max(0.0, 1 - busy_us / wall_us) if busy_us else float("nan")
    plain_ms, dp_ms = (float(np.mean(times[k])) for k in ("plain", "dp"))
    print(f"[parallel] train step at batch 128 (host clock, median of 8, in turns plain, dp, dp, "
          f"plain): plain {times['plain']} ms, data-parallel world size 1 (NCCL) {times['dp']} "
          f"ms ({dp_ms / plain_ms:.3f}x); its {len(sizes)} all_reduces alone {coll_ms:.3f} ms "
          f"(the gradient's, {sizes[0]:,} floats = {4 * sizes[0]:,} bytes, {grad_ms:.3f} ms; "
          f"{len(sizes) - 1} BatchNorm ones of {sizes[1:]} floats); profile: device busy "
          f"{busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms, idle share {idle:.3f}, NCCL "
          f"kernels and device-to-device copies {nccl_us / 1e3:.3f} ms")
    return {"launches": launches, "cli_launches": cli_launches, "fold": fold, "cfg": cfg,
            "state_dict": state_dict, "x": x, "y": y, "plain_ms": plain_ms, "dp_ms": dp_ms,
            "nccl_collectives_ms": coll_ms, "nccl_grad_ms": grad_ms, "idle": idle,
            "n_params": sizes[0]}


def _sharded_evaluate(train_dir: str, workdir: str) -> dict:
    """``apps.evaluate --data-parallel`` (world size 1, NCCL) on [evaluate]'s
    split and best checkpoint against the unsharded CLI: the report and the
    dumped event lists equal, exact launch counts."""
    import torch

    from sed_crnn_torch.apps import evaluate as eval_app
    from sed_crnn_torch.apps.train import synthetic_folds
    from sed_crnn_torch.core.config import get_preset

    m = get_preset("sednet-dcase").model
    val = synthetic_folds(1, frames=2 * EVAL_FRAMES, seed=14, n_classes=m.n_classes)[1]
    x, y = val["val_x"], val["val_y"]
    cache = os.path.join(workdir, "cache")
    os.makedirs(cache)
    np.savez(os.path.join(cache, "mbe_mon_fold1.npz"), x, y, x, y)
    n_batches = -(-(x.shape[0] // m.seq_len_in) // EVAL_BATCH)
    base = ["--checkpoint", os.path.join(train_dir, "fold1", "best_fold1.npz"),
            "--preset", "sednet-dcase", "--cache-dir", cache, "--device", "cuda"]
    out, walls, launches = {}, {}, {}
    for name, extra in (("single", []), ("sharded", ["--data-parallel"])):
        d = os.path.join(workdir, name)
        _reset_gru_counts()
        _reset_logmel_counts()
        t0 = time.perf_counter()
        with _no_plain_gru_on_card() as plain_on_card:
            _quiet(eval_app.main, base + extra + ["--dump-events", d,
                                                  "--out", os.path.join(d, "report.json")])
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = _gru_counts()
        check(not plain_on_card, f"a GRU plain version ran on the card: {plain_on_card}")
        check(launches[name] == _gru_path_counts(2 * n_batches, 0),
              f"{name} evaluation launches {launches[name]}")
        out[name] = {f: open(os.path.join(d, f), "rb").read()
                     for f in ("report.json", "ref_events.txt", "est_events.txt")}
    for f in out["single"]:
        check(out["sharded"][f] == out["single"][f], f"sharded evaluation: {f} differs")
    report = json.loads(out["single"]["report.json"])
    print(f"[parallel] apps.evaluate --data-parallel (NCCL, world size 1) on [evaluate]'s "
          f"{x.shape[0]:,}-frame split, best checkpoint: report, ref_events.txt and "
          f"est_events.txt byte-identical to the unsharded CLI's (ER_1s {report['er_1s']:.4f},"
          f" F1_1s {report['f1_1s']:.4f}, {report['n_windows']} windows); walls "
          f"{walls['single']:.2f} / {walls['sharded']:.2f} s; launches {launches['sharded']}")
    return launches["sharded"]


def _reproduce_dcase_run(workdir: str) -> dict:
    """``python -m sed_crnn_torch.apps.reproduce_dcase`` as it ships, at full
    width on a synthetic DCASE layout, ``--seed-parallel 1``: stage 1 on the
    feature CLI's default ``fft`` frontend, as the JAX script (no kernel A
    launch); without matplotlib, its notice and no plot; exact stacked kernel
    B launch counts; the protocol's numbers (its ``experiment_multiseed.jsonl``
    and the report) against a direct stacked `run_experiment_multiseed` on
    the same cache, deterministic cuDNN; the stages' walls, split where the
    cache's last file was written."""
    import importlib.util
    import io

    import torch

    from sed_crnn_torch.apps import reproduce_dcase
    from sed_crnn_torch.core.config import get_preset
    from sed_crnn_torch.data import store
    from sed_crnn_torch.train import multiseed
    from sed_crnn_torch.train.loop import make_samplers

    root = os.path.join(workdir, "dcase")
    names = write_dcase_layout(root)
    art, cache = os.path.join(workdir, "art"), os.path.join(root, "sedtpu_cache")
    _reset_gru_counts()
    _reset_logmel_counts()
    err = io.StringIO()
    t0 = time.time()
    with _cudnn_deterministic(), _no_plain_gru_on_card() as plain_on_card, \
            contextlib.redirect_stderr(err):
        report, lines = _quiet(reproduce_dcase.main, [
            "--dcase-root", root, "--art-dir", art, "--folds", "1", "2", "--runs", "2",
            "--max-epochs", str(PARALLEL_EPOCHS), "--seed-parallel", "1", "--device", "cuda",
            "--out", os.path.join(workdir, "report.json")])
        torch.cuda.synchronize()
    t1 = time.time()
    stack_launches, fe = _gru_counts(), _logmel_counts()
    check(not plain_on_card, f"a GRU plain version ran on the card: {plain_on_card}")
    check(not any(fe.values()), f"stage 1 launched kernel A {fe}; the script's frontend is fft")
    check(json.loads(lines[-2]) == report and lines[-1].startswith("vs published baseline: "),
          f"the script's last lines {lines[-2:]}")
    pngs = [f for _, _, fs in os.walk(art) for f in fs if f.endswith(".png")]
    plots = importlib.util.find_spec("matplotlib") is not None
    check(plots == bool(pngs) and plots != ("matplotlib is not installed" in err.getvalue()),
          f"plots: matplotlib {'present' if plots else 'missing'}, {len(pngs)} png, stderr "
          f"{err.getvalue()!r}")
    features_end = max(os.path.getmtime(os.path.join(cache, f)) for f in os.listdir(cache))
    with open(os.path.join(art, "experiment_multiseed.jsonl")) as f:
        (logged,) = [json.loads(ln) for ln in f]

    cfg = get_preset("sednet-dcase")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_epochs=PARALLEL_EPOCHS,
                                                plot_every=0))
    folds = store.load_all_folds(cache, [1, 2], "mon")
    with _cudnn_deterministic():
        direct = multiseed.run_experiment_multiseed(cfg, folds, os.path.join(workdir, "direct"),
                                                    n_runs=2, mode="stacked", verbose=False,
                                                    device="cuda")
    for k in ("mean_er", "std_er", "mean_f1", "std_f1", "er_by_seed", "f1_by_seed", "seeds"):
        check(logged[k] == direct[k], f"reproduce_dcase {k} {logged[k]} vs direct {direct[k]}")
    for key, src in (("er_1s", "mean_er"), ("f1_1s", "mean_f1"), ("std_er", "std_er"),
                     ("std_f1", "std_f1")):
        check(report[key] == round(direct[src], 4), f"report {key} {report} vs direct {direct}")
    fwd = steps = 0
    for k, fd in folds.items():
        tr, val = make_samplers(cfg, fd, torch.device("cpu"))
        epochs = max(r.epochs_run for r in direct["folds"][k])
        fwd += 2 * val.sweep_steps(cfg.train.batch_size) * epochs
        steps += 2 * tr.steps_per_epoch(cfg.train.batch_size) * epochs
    want = _gru_path_counts(fwd, steps)
    check(stack_launches == want, f"stage 2 stacked launches {stack_launches} != {want}")
    print(f"[parallel] reproduce_dcase --folds 1 2 --runs 2 --max-epochs {PARALLEL_EPOCHS} "
          f"--seed-parallel 1, as it ships, on {len(names)} files (sednet-dcase full width, "
          f"batch {cfg.train.batch_size}, 2 seeds stacked): walls, split at the cache's last "
          f"write, features {features_end - t0:.2f} s, protocol and report "
          f"{t1 - features_end:.2f} s; stage 1 on the fft frontend (kernel A launches {fe}); "
          f"plots: {len(pngs)} png (matplotlib {'present' if plots else 'missing'}); report "
          f"{report}; the protocol's ER/F1, std and per-seed values bitwise a direct stacked "
          f"run_experiment_multiseed; kernel B stacked {stack_launches}")
    return stack_launches


def phase_parallel(train_dir: str, workdir: str) -> dict:
    """[parallel]: data parallelism at world size 1 over NCCL and over two
    gloo ranks on one card, sharded evaluation and the DCASE reproduction script,
    at full width."""
    os.makedirs(workdir)
    w1 = _dp_world1(os.path.join(workdir, "world1"))
    two = _two_ranks(w1["cfg"], w1["fold"], w1["state_dict"], w1["x"], w1["y"])
    eval_launches = _sharded_evaluate(train_dir, os.path.join(workdir, "evaluate"))
    stack_launches = _reproduce_dcase_run(os.path.join(workdir, "reproduce"))
    launches = {k: w1["launches"][k] + w1["cli_launches"][k] + eval_launches[k]
                + stack_launches[k] for k in w1["launches"]}
    return {"launches": launches, "numbers": {
        "dp_step_ms": w1["dp_ms"], "plain_step_ms": w1["plain_ms"],
        "nccl_collectives_ms": w1["nccl_collectives_ms"], "nccl_grad_ms": w1["nccl_grad_ms"],
        "gloo_step_ms": two["gloo_step_ms"], "gloo_collectives_ms": two["gloo_collectives_ms"],
        "gloo_grad_ms": two["gloo_grad_ms"],
        "dp_idle_share": w1["idle"], "n_params": w1["n_params"],
        "two_rank_grad_rel": two["grad_rel"], "two_rank_grad_rel_same": two["grad_rel_same"]}}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="The port's smoke run on one CUDA card.")
    ap.add_argument("--dwh-parent", default="",
                    help="an older csrc/gru_dwh.cu (or csrc/gru_wide.cu, its FMA reduction) "
                         "whose dwh reduction [kernel B dwh] times in turns with "
                         "csrc/gru_dwh.cu")
    args = ap.parse_args(argv)
    smi = phase_device()
    import torch

    from sed_crnn_torch.core.device import set_full_fp32

    set_full_fp32()
    phase_build()
    _start_matrix_cuts()
    from sed_crnn_torch.core.config import FrontendConfig

    pcm = tones(120.0, 9, silent=[(50.0, 52.0)])
    kernel_a = phase_logmel(bucket_signal(pcm, FrontendConfig()))
    kernel_b, wide_serving_err = phase_gru()
    with tempfile.TemporaryDirectory() as workdir:
        launches, fe_kernel, model = phase_main(workdir, pcm)
    phase_throughput(fe_kernel, model, pcm)
    (kernel_fwd_res, kernel_bwd, kernel_dwh), wide_train = phase_gru_train()
    phase_train_step()
    with tempfile.TemporaryDirectory() as workdir:
        train_dir, feature_dir = (os.path.join(workdir, d) for d in ("train", "feature"))
        train_launches, cfg, fold = phase_train(train_dir)
        step_ms = phase_train_throughput(cfg, fold)
        tools = phase_tools(os.path.join(workdir, "tools"), cfg, fold, step_ms, pcm)
        kernel_framed, kernel_exact = phase_logmel_routes(pcm)
        kernel_mixed, mixed_launches = phase_logmel_mixed(pcm)
        kernel_cluster, cluster_launches = phase_logmel_cluster(pcm)
        os.makedirs(feature_dir)
        feature_launches, cache, _ = phase_feature(feature_dir)
        mixed_launches += phase_feature_multires(feature_dir)
        binmul_best = phase_feature_train(feature_dir, cache)
        eval_launches, eval_numbers = phase_evaluate(train_dir, cache, binmul_best)
        phase_multiseed(os.path.join(workdir, "multiseed"))
        stack_launches, stack = phase_multiseed_stacked(os.path.join(workdir, "stacked"))
        serve_launches, serve_numbers = phase_serve(train_dir, os.path.join(workdir, "serve"),
                                                    pcm)
        import_launches, import_numbers = phase_import(os.path.join(workdir, "import"), pcm)
        parallel = phase_parallel(train_dir, os.path.join(workdir, "parallel"))
        wide = phase_gru_wide()
        kernel_dwh_mma = phase_gru_dwh(args.dwh_parent)
        wide_paths = phase_wide_paths(os.path.join(workdir, "wide"), pcm)
    kernel_b.update(eval_numbers)
    kernel_b.update(serve_numbers)
    kernel_b["max_abs_err"] = max(kernel_b["max_abs_err"], serve_numbers["serve_max_abs_err"])
    launches["gru_scan_fwd"] += eval_launches + serve_launches["gru_scan_fwd"]
    launches["fused_logmel"] += serve_launches["chunked"]
    launches.update({k: train_launches[k] for k in ("gru_scan_fwd_res", "gru_scan_bwd",
                                                    "gru_dwh")})
    for k, n in tools["launches"].items():
        if k in launches:
            launches[k] += n
    launches["fused_logmel_framed"] = feature_launches["framed"] + serve_launches["framed"]
    launches["fused_logmel_exact"] = kernel_exact.pop("launches")
    launches["fused_logmel_mixed"] = mixed_launches
    launches["fused_logmel_cluster"] = cluster_launches
    launches["gru_wide"] = sum(wide_paths["launches"].values())
    launches["gru_cluster"] = sum(wide_paths["cluster_launches"].values())
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
    kernel_b["max_abs_err"] = max(kernel_b["max_abs_err"], stack["worst"]["fwd"],
                                  import_numbers["import_max_abs_err"])
    kernel_b.update(import_numbers)
    for k, n in import_launches.items():
        launches[k] += n
    for k, n in parallel["launches"].items():
        if k in launches:
            launches[k] += n
    kernel_b.update({f"parallel_{k}": v for k, v in parallel["numbers"].items()})
    kernel_fwd_res["max_abs_err"] = max(kernel_fwd_res["max_abs_err"], stack["worst"]["fwd"])
    kernel_bwd["max_abs_err"] = max(kernel_bwd["max_abs_err"], stack["worst"]["bwd"])
    kernel_dwh["max_abs_err"] = max(kernel_dwh["max_abs_err"], stack["worst"]["dwh"])
    kernel_wide = _wide_entry(wide, wide_paths, wide_train, wide_serving_err)
    kernel_cluster_b = _cluster_entry(wide, wide_paths)
    kernel_grid_fwd, kernel_grid_bwd = _grid_entries(wide, wide_paths)
    launches["gru_grid_fwd"] = kernel_grid_fwd.pop("launches")
    launches["gru_grid_bwd"] = kernel_grid_bwd.pop("launches")
    launches["gru_dwh_mma"] = sum(wide_paths["dwh_launches"].values())
    kernel_dwh_mma["launches_by_path"] = wide_paths["dwh_launches"]
    kernel_dwh_mma["wgmma_launches_by_path"] = wide_paths["dwh_wgmma_launches"]
    # [tools]: each kernel's device time per launch in the profile_trace trace
    for entry, kind in ((kernel_a, "fused_logmel"), (kernel_b, "gru_scan_fwd"),
                        (kernel_fwd_res, "gru_scan_fwd_res"), (kernel_bwd, "gru_scan_bwd"),
                        (kernel_dwh, "gru_dwh")):
        entry["trace_ms"] = tools["trace_ms"][kind]
        entry["trace_event_ms"] = tools["event_ms"].get(kind)
    kernel_a["logmel_native_max_abs_err"] = tools["logmel_native_max_abs_err"]
    kernels = []
    head = ("name", "route", "source", "replaces")
    for k in (kernel_a, kernel_framed, kernel_exact, kernel_mixed, kernel_cluster, kernel_b,
              kernel_fwd_res, kernel_bwd, kernel_dwh, kernel_wide, kernel_cluster_b,
              kernel_grid_fwd, kernel_grid_bwd, kernel_dwh_mma):
        kernels.append({**{key: k[key] for key in head}, "launches": launches[k["name"]],
                        **{key: v for key, v in k.items() if key not in head}})
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    check(not idle, f"kernels never launched on their paths: {idle}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
