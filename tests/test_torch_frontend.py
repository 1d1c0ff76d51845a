"""The port's log-mel frontend (sed_crnn_torch/ops/frontend.py and the plain
version of the fused log-mel kernel) against the JAX package's on the same
seeded waveforms.

Tolerances, in the log domain: 2e-4 between the fft/matmul backends of the
two frameworks (two float32 FFT/GEMM implementations, the band of the JAX
package's own oracle test) and between the port's direct ("exact") route and
the JAX exact kernel (float32 products summed in another order); 5e-4
between the port's float32 DIF routes and the JAX DIF kernels, whose
products run as bf16x3 (the band of tests/test_frontend_parity.py). Signals
are tones plus noise, so no mel band sits at a window sidelobe floor; -inf
entries (exact silence with no floor) must coincide.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.core.config import FrontendConfig as JaxFrontendConfig
from sed_crnn_tpu.ops import frontend as jax_frontend
from sed_crnn_tpu.ops import stft as jax_stft
from sed_crnn_tpu.ops.pallas.fused_logmel import fused_log_mel as jax_fused_log_mel
from sed_crnn_tpu.ops.pallas.fused_logmel import fused_log_mel_frames as jax_fused_frames

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops import frontend, stft
from sed_crnn_torch.ops.kernels.fused_logmel import (
    fused_log_mel,
    fused_log_mel_frames,
    fused_log_mel_frames_plain,
    fused_log_mel_plain,
    route,
)

SMALL = dict(sample_rate=16000, n_fft=256, hop_length=128, n_mels=16)


def _tone_mix(rng, n, sr=44100):
    t = np.arange(n) / sr
    y = (0.4 * np.sin(2 * np.pi * 440.0 * t)
         + 0.2 * np.sin(2 * np.pi * 3517.0 * t + 0.3)
         + 0.05 * rng.standard_normal(n))
    return y.astype(np.float32)


def _assert_log_close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], atol=atol)


@pytest.mark.parametrize("backend", ["fft", "matmul"])
@pytest.mark.parametrize("n", [44100 + 12345, 5000])
def test_extract_matches_jax(backend, n):
    y = _tone_mix(np.random.default_rng(0), n)
    want = jax_frontend.extract(y, JaxFrontendConfig(backend=backend))
    got = frontend.extract(y, FrontendConfig(backend=backend), device="cpu")
    _assert_log_close(got.numpy(), want, 2e-4)


@pytest.mark.parametrize("log_floor", [None, 1e-10])
@pytest.mark.parametrize("center", [True, False])
def test_fused_plain_matches_jax_kernel(log_floor, center):
    """Plain fused log-mel vs the JAX fused Pallas kernel run interpreted,
    on a signal with an exactly silent stretch (-inf rows without a floor)."""
    rng = np.random.default_rng(1)
    y = _tone_mix(rng, 16000, sr=16000)
    y[4000:9000] = 0.0
    kw = dict(SMALL, center=center, log_floor=log_floor)
    want = np.asarray(jax.jit(lambda w: jax_fused_log_mel(w, JaxFrontendConfig(**kw)))(
        jnp.asarray(y)))
    got = fused_log_mel_plain(torch.from_numpy(y), FrontendConfig(**kw))
    if log_floor is None:
        assert np.isneginf(want).any()
    _assert_log_close(got.numpy(), want, 5e-4)


def test_kernel_backend_extract_matches_jax_pallas_backend():
    y = _tone_mix(np.random.default_rng(2), 40000, sr=16000)
    want = jax_frontend.extract(y, JaxFrontendConfig(backend="pallas", **SMALL),
                                bucket_seconds=1.0)
    cfg = FrontendConfig(backend="kernel", **SMALL)
    got = frontend.extract(y, cfg, bucket_seconds=1.0, device="cpu")
    _assert_log_close(got.numpy(), want, 5e-4)
    # on a CPU tensor the wrapper computes the plain version, launching nothing
    launches = fused_log_mel.launches
    yt = torch.from_numpy(y)
    assert torch.equal(fused_log_mel(yt, cfg), fused_log_mel_plain(yt, cfg))
    assert fused_log_mel.launches == launches


def test_fused_matches_fft_backend_at_full_config():
    """Full-size configuration: the plain fused path against the port's own
    fft backend (both float32)."""
    y = _tone_mix(np.random.default_rng(3), 44100)
    cfg = FrontendConfig(log_floor=1e-10)
    want = frontend.log_mel_energies(torch.from_numpy(y), cfg)
    got = fused_log_mel_plain(torch.from_numpy(y), cfg)
    _assert_log_close(got.numpy(), want.numpy(), 2e-4)


def test_bucketing_gives_the_exact_length_frames():
    y = _tone_mix(np.random.default_rng(4), 44100 * 2 + 777)
    cfg = FrontendConfig()
    bucketed = frontend.extract(y, cfg, bucket_seconds=1.0, device="cpu")
    exact = frontend.extract(y, cfg, bucket_seconds=0, device="cpu")
    assert bucketed.shape == exact.shape == (1 + len(y) // 1024, 40)
    np.testing.assert_allclose(bucketed.numpy(), exact.numpy(), atol=1e-5)


def test_log_mel_from_frames_matches_jax():
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((7, 2048)).astype(np.float32)
    want = jax_frontend.log_mel_from_frames(frames, JaxFrontendConfig())
    got = frontend.log_mel_from_frames(torch.from_numpy(frames), FrontendConfig())
    _assert_log_close(got.numpy(), want, 2e-4)


def test_norm_stats_and_normalize_match_jax():
    rng = np.random.default_rng(6)
    x = (3.0 + 2.0 * rng.standard_normal((500, 40))).astype(np.float32)
    x[:, 7] = 1.25  # constant feature: zero std -> scale 1
    want = jax_frontend.fit_norm_stats(jnp.asarray(x))
    got = frontend.fit_norm_stats(torch.from_numpy(x))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    assert got.scale[7] == 1.0
    np.testing.assert_allclose(
        frontend.normalize(torch.from_numpy(x), got).numpy(),
        np.asarray(jax_frontend.normalize(jnp.asarray(x), want)), atol=1e-5)


def test_unknown_backend_and_unported_shapes_raise():
    """An unknown backend or mode raises; hop 512 at n_fft 2048 (once
    refused) now takes the framed DIF route and matches the JAX pallas
    backend."""
    y = torch.zeros(4096)
    with pytest.raises(ValueError):
        frontend.log_mel_energies(y, FrontendConfig(backend="pallas"))
    with pytest.raises(ValueError):
        fused_log_mel(y, FrontendConfig(), mode="bf16x3")
    y = _tone_mix(np.random.default_rng(7), 20000)
    cfg = FrontendConfig(hop_length=512)
    assert route(len(y), cfg) == "framed"
    want = jax_frontend.extract(y, JaxFrontendConfig(backend="pallas", hop_length=512))
    got = frontend.extract(y, dataclasses.replace(cfg, backend="kernel"), device="cpu")
    _assert_log_close(got.numpy(), want, 5e-4)


@pytest.mark.parametrize("n,pad", [(1, 3), (2, 5), (3, 5), (5, 4), (700, 1024), (1500, 1024),
                                   (2048, 1024)])
def test_reflect_pad_is_numpy_reflect(n, pad):
    """Repeated reflection once the pad reaches the signal's length."""
    y = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = stft.reflect_pad(torch.from_numpy(y), pad)
    np.testing.assert_array_equal(got.numpy(), np.pad(y, pad, mode="reflect"))
    assert got.shape[0] == n + 2 * pad


@pytest.mark.parametrize("backend", ["fft", "matmul", "kernel"])
@pytest.mark.parametrize("n", [700, 1500])
def test_short_signals_match_jax(backend, n):
    """Centred signals shorter than n_fft / 2 and than n_fft, unbucketed:
    the repeated reflection gives the JAX package's frames."""
    y = _tone_mix(np.random.default_rng(n), n)
    jax_backend = "pallas" if backend == "kernel" else backend
    want = jax_frontend.extract(y, JaxFrontendConfig(backend=jax_backend), bucket_seconds=0)
    got = frontend.extract(y, FrontendConfig(backend=backend), bucket_seconds=0, device="cpu")
    assert got.shape[0] == stft.num_frames(n, 2048, 1024) == want.shape[0]
    _assert_log_close(got.numpy(), want, 5e-4 if backend == "kernel" else 2e-4)


FRAMED = {
    "small": (dict(sample_rate=16000, n_fft=256, hop_length=64, n_mels=16), 16000),
    "1024/1024": (dict(n_fft=1024, hop_length=1024), 2 * 44100),
    "4096/1024": (dict(n_fft=4096, hop_length=1024), 2 * 44100),
}


@pytest.mark.parametrize("case,center,log_floor", [
    ("small", True, None), ("small", True, 1e-10), ("small", False, None),
    ("small", False, 1e-10), ("1024/1024", True, None), ("1024/1024", False, 1e-10),
    ("4096/1024", True, None), ("4096/1024", False, 1e-10),
])
def test_framed_dif_plain_matches_jax_kernel(case, center, log_floor):
    """hop != n_fft / 2: the framed DIF route (stride hop on the padded
    waveform) against the JAX `_kernel_dif` run interpreted, on a signal
    with a silent stretch (-inf rows without a floor)."""
    kw, n = FRAMED[case]
    sr = kw.get("sample_rate", 44100)
    y = _tone_mix(np.random.default_rng(8), n, sr=sr)
    y[sr // 4 : sr // 4 + sr // 2] = 0.0
    kw = dict(kw, center=center, log_floor=log_floor)
    assert route(n, FrontendConfig(**kw)) == "framed"
    want = np.asarray(jax.jit(lambda w: jax_fused_log_mel(w, JaxFrontendConfig(**kw)))(
        jnp.asarray(y)))
    got = fused_log_mel_plain(torch.from_numpy(y), FrontendConfig(**kw))
    if log_floor is None:
        assert np.isneginf(want).any()
    _assert_log_close(got.numpy(), want, 5e-4)


@pytest.mark.parametrize("n_fft,hop,mode", [(1024, 1024, "dif"), (2048, 1024, "dif"),
                                            (2048, 1024, "exact"), (1034, 517, "dif")])
def test_frames_plain_matches_jax_frames(n_fft, hop, mode):
    """The frame-matrix entry (stride n_fft) against JAX
    `fused_log_mel_frames` on the same frames; 1034 falls back to exact."""
    y = _tone_mix(np.random.default_rng(9), 30000)
    frames = np.array(jax_stft.frame_signal(jnp.asarray(y), n_fft, hop))
    jax_mode = "bf16x3" if mode == "dif" else mode
    want = np.asarray(jax_fused_frames(jnp.asarray(frames), JaxFrontendConfig(n_fft=n_fft),
                                       jax_mode))
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop)
    got = fused_log_mel_frames(torch.from_numpy(frames), cfg, mode)
    assert torch.equal(got, fused_log_mel_frames_plain(torch.from_numpy(frames), cfg, mode))
    direct = mode == "exact" or n_fft % 4
    _assert_log_close(got.numpy(), want, 2e-4 if direct else 5e-4)


@pytest.mark.parametrize("n", [44100, 44100 * 2 + 777, 2048])
def test_chunked_route_equals_frame_matrix_route(n):
    """Stride M on the waveform and stride n_fft on the materialized frames
    read the same samples: bit for bit equal on the CPU."""
    cfg = FrontendConfig()
    y = torch.from_numpy(np.random.default_rng(11).standard_normal(n).astype(np.float32) * 0.3)
    assert route(n, cfg) == "chunked"
    frames = stft.frame_signal(y, cfg.n_fft, cfg.hop_length, center=cfg.center)
    assert torch.equal(fused_log_mel(y, cfg), fused_log_mel_frames(frames, cfg))


@pytest.mark.parametrize("kw,mode", [(dict(), "exact"), (dict(n_fft=1034, hop_length=517), "dif")])
def test_exact_plain_matches_jax_kernel(kw, mode):
    """mode "exact" at n_fft 2048, and the n_fft % 4 fallback at 1034/517
    (the JAX test's shape), against JAX `_kernel_exact` run interpreted."""
    y = _tone_mix(np.random.default_rng(12), 44100)
    cfg = FrontendConfig(log_floor=1e-10, **kw)
    assert route(len(y), cfg, mode) == "exact"
    jax_mode = "bf16x3" if mode == "dif" else mode
    want = np.asarray(jax.jit(lambda w: jax_fused_log_mel(
        w, JaxFrontendConfig(log_floor=1e-10, **kw), jax_mode))(jnp.asarray(y)))
    got = fused_log_mel_plain(torch.from_numpy(y), cfg, mode)
    _assert_log_close(got.numpy(), want, 2e-4)
