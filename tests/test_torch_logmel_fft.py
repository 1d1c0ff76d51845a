"""The FFT body of the fused log-mel (``csrc/logmel_fft.cu``) on the CPU: its
host operands, the body choice, and its plain version `fft_log_mel_plain`
(the kernel's arithmetic stage by stage) against three references on the
same seeded waveforms.

Bands, in the log domain at finite entries, -inf entries equal:

* 1e-4 against ``np.fft.rfft`` + mel in float64: float32 rounding of an
  FFT (error growing with log2 n_fft) and of the mel sums; measured up to
  2e-5 (128 mels);
* 2e-4 against `fused_log_mel_plain` (the DIF / direct plain version the
  wrapper runs on a CPU tensor): its float32 real DFT as products has an
  error growing with sqrt(n_fft), up to 7e-5 from float64 here;
* 5e-4 against the JAX package's `fused_log_mel` run interpreted (bf16x3
  products on the TPU's DIF route), the band of tests/test_frontend_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.core.config import FrontendConfig as JaxFrontendConfig
from sed_crnn_tpu.ops.pallas.fused_logmel import fused_log_mel as jax_fused_log_mel

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels.fused_logmel import (
    FFT_LOG_N,
    body,
    fft_log_mel_plain,
    fft_operands,
    fused_log_mel,
    fused_log_mel_plain,
    mel_csr,
)
from sed_crnn_torch.ops.mel import mel_filterbank
from sed_crnn_torch.ops.stft import hann_window

CONFIGS = {
    "256/16k": dict(sample_rate=16000, n_fft=256, hop_length=128, n_mels=16),
    "1024": dict(n_fft=1024, hop_length=512),
    "2048": dict(),
    "4096": dict(n_fft=4096, hop_length=2048),
    "2048/128 mels": dict(n_mels=128),
}


def _signal(n, sr, seed, silent=False):
    """Two tones and noise; with ``silent``, an exactly silent middle half
    (-inf rows without a floor)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    y = (0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 3517.0 * t + 0.3)
         + 0.05 * rng.standard_normal(n))
    if silent:
        y[n // 4 : 3 * n // 4] = 0.0
    return y.astype(np.float32)


def _rfft_log_mel(y, cfg):
    """Frame, window, ``np.fft.rfft``, power, mel, floor, log, in float64."""
    y = y.astype(np.float64)
    if cfg.center:
        y = np.pad(y, cfg.n_fft // 2, mode="reflect")
    n = 1 + (len(y) - cfg.n_fft) // cfg.hop_length
    idx = np.arange(n)[:, None] * cfg.hop_length + np.arange(cfg.n_fft)[None, :]
    power = np.abs(np.fft.rfft(y[idx] * hann_window(cfg.n_fft, np.float64), axis=1)) ** 2
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, np.float64)
    mel = power @ fb.T
    if cfg.log_floor is not None:
        mel = np.maximum(mel, cfg.log_floor)
    with np.errstate(divide="ignore"):
        return np.log(mel)


def _assert_log_close(got, want, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("sr,n_fft,n_mels", [(16000, 256, 16), (44100, 1024, 40),
                                             (44100, 2048, 40), (44100, 4096, 40),
                                             (44100, 2048, 128), (44100, 16384, 40)])
def test_mel_csr_scatters_back_to_dense(sr, n_fft, n_mels):
    """Each band is one contiguous bin range: scattered back, the CSR rows
    are the dense filterbank bit for bit, with no stored zero inside. (The
    dense rows hold a -0.0 at the DC bin of band 0, outside its support:
    ``+ 0.0`` makes it +0.0 before the bits are compared.)"""
    fb = mel_filterbank(sr, n_fft, n_mels)
    first, ptr, w = mel_csr(sr, n_fft, n_mels, 0.0, None)
    assert first.dtype == ptr.dtype == np.int32 and w.dtype == np.float32
    dense = np.zeros_like(fb)
    for m in range(n_mels):
        dense[m, first[m] : first[m] + ptr[m + 1] - ptr[m]] = w[ptr[m] : ptr[m + 1]]
    np.testing.assert_array_equal(dense.view(np.int32), (fb + np.float32(0.0)).view(np.int32))
    assert ptr[-1] == len(w) == np.count_nonzero(fb)
    if (sr, n_fft, n_mels) == (44100, 4096, 40):
        assert len(w) == 3890   # against 81,960 dense


@pytest.mark.parametrize("n_fft", [256, 2048, 16384])
def test_twiddles_and_window_round_float64(n_fft):
    """The twiddle tables lie within 1 ulp of their float64 values; the
    window is the float64 Hann window rounded to float32."""
    ops = fft_operands(44100, n_fft, 40, 0.0, None)
    h = n_fft // 2
    for key, k, n in (("tw", np.arange(h), h), ("utw", np.arange(h + 1), n_fft)):
        ang = 2.0 * np.pi * k / n
        exact = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
        table = ops[key]
        assert table.dtype == np.float32 and table.shape == exact.shape
        ulp = np.spacing(np.abs(table)).astype(np.float64)
        assert np.all(np.abs(table.astype(np.float64) - exact) <= ulp)
    np.testing.assert_array_equal(ops["window"], hann_window(n_fft, np.float64).astype(np.float32))


@pytest.mark.parametrize("n_fft", [1 << k for k in range(FFT_LOG_N[0], FFT_LOG_N[1] + 1)])
def test_power_of_two_sizes_take_the_fft_body(n_fft):
    assert body(n_fft) == "fft"


@pytest.mark.parametrize("n_fft,other", [
    (1034, "mixed"), (1000, "mixed"), (128, "mixed"), (32768, "mixed"), (2050, "mixed"),
    (3072, "mixed"), (12865, "mixed"), (23042, "mixed"), (12867, "mixed"), (25734, "cluster"),
])
def test_other_sizes_take_the_dft_body(n_fft, other):
    """Every other size leaves the FFT body: the mixed body up to its
    shared-memory limit (tests/test_torch_logmel_mixed.py), the cluster
    body beyond it (tests/test_torch_logmel_cluster.py)."""
    assert body(n_fft) == other
    with pytest.raises(ValueError):
        fft_log_mel_plain(torch.zeros(4 * n_fft), FrontendConfig(n_fft=n_fft, hop_length=512))


@pytest.mark.parametrize("log_floor", [None, 1e-10])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("case", list(CONFIGS))
def test_fft_plain_matches_references(case, center, log_floor):
    """A quarter second (at least 4 frames' length) with a silent middle
    half, every configuration: the FFT body's plain version against float64
    rFFT + mel and the DIF plain version; without a floor (the -inf rows)
    also against the JAX fused Pallas kernel (interpreted), whose compile
    per configuration is most of this file's time."""
    kw = dict(CONFIGS[case], center=center, log_floor=log_floor)
    cfg = FrontendConfig(**kw)
    n = max(cfg.sample_rate // 4, 4 * cfg.n_fft)
    y = _signal(n, cfg.sample_rate, seed=len(case), silent=True)
    got = fft_log_mel_plain(torch.from_numpy(y), cfg).numpy()
    _assert_log_close(got, _rfft_log_mel(y, cfg), 1e-4)
    _assert_log_close(got, fused_log_mel_plain(torch.from_numpy(y), cfg).numpy(), 2e-4)
    if log_floor is None:
        assert np.isneginf(got).any()
        want = jax.jit(lambda w: jax_fused_log_mel(w, JaxFrontendConfig(**kw)))(jnp.asarray(y))
        _assert_log_close(got, want, 5e-4)


@pytest.mark.parametrize("case", ["1024", "2048", "4096"])
def test_fft_plain_on_a_short_clip(case):
    """A 1,500-sample clip, centred: frames made of repeated reflections."""
    cfg = FrontendConfig(**CONFIGS[case])
    y = _signal(1500, cfg.sample_rate, seed=3)
    got = fft_log_mel_plain(torch.from_numpy(y), cfg).numpy()
    assert got.shape == (1 + 1500 // cfg.hop_length, cfg.n_mels)
    _assert_log_close(got, _rfft_log_mel(y, cfg), 1e-4)
    _assert_log_close(got, fused_log_mel_plain(torch.from_numpy(y), cfg).numpy(), 2e-4)
    want = jax.jit(lambda w: jax_fused_log_mel(w, JaxFrontendConfig(**CONFIGS[case])))(
        jnp.asarray(y))
    _assert_log_close(got, want, 5e-4)


def test_cpu_wrapper_runs_the_dft_plain_version():
    """On a CPU tensor the wrapper runs `fused_log_mel_plain` whatever the
    body, and counts no launch."""
    cfg = FrontendConfig(log_floor=1e-10)
    y = torch.from_numpy(_signal(20000, 44100, seed=4))
    counts = (fused_log_mel.launches, fused_log_mel.framed_launches,
              fused_log_mel.exact_launches, fused_log_mel.cluster_launches)
    assert torch.equal(fused_log_mel(y, cfg), fused_log_mel_plain(y, cfg))
    assert counts == (fused_log_mel.launches, fused_log_mel.framed_launches,
                      fused_log_mel.exact_launches, fused_log_mel.cluster_launches)
