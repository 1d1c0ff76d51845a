"""The port's C++ host library (`sed_crnn_torch/utils/native.py` over
`sed_crnn_torch/native/logmel.cpp`) against the JAX package's on the CPU.

The two libraries are built from the same source with the same flags, so
`log_mel_native` and the streaming framers must agree bit for bit, with
each other, with the numpy `PythonFramer` and with whole-signal framing
(`ops/stft.py::frame_signal`). Against the float64 scipy oracle
(`tests/oracle/librosa_ref.py`) the JAX tests' tolerances hold: 5e-5 at a
power of two, 1e-4 absolute + 1e-5 relative on the Bluestein path. The WAV
reader agrees with `data/wavio.py::read_wav` within 1e-6.

The library is built at first use into ``build/sed_crnn_torch/`` (g++ is on
the test machines); the build's own tests build into a temporary
directory.
"""

import os
import struct
import threading

import numpy as np
import pytest
import torch

from sed_crnn_tpu.utils import native as jax_native

from sed_crnn_torch.data import wavio
from sed_crnn_torch.ops.stft import frame_signal
from sed_crnn_torch.utils import native
from sed_crnn_torch.utils.native import PythonFramer, StreamingFramer
from tests.oracle.librosa_ref import oracle_log_mel


@pytest.fixture(scope="module")
def built():
    if not native.native_available():
        pytest.skip("g++ is not on PATH and no library is built")
    return native.build_library()


def _signal(seed, n=44100):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 3517 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,center,floor", [
    (2048, 1024, True, None), (1024, 512, True, 1e-10), (512, 160, False, None),
    (1000, 500, True, None), (1536, 768, True, None), (1034, 517, False, 1e-10),
])
def test_log_mel_native_is_jax_bitwise(built, n_fft, hop, center, floor):
    y = _signal(n_fft)
    got = native.log_mel_native(y, n_fft=n_fft, hop=hop, center=center, log_floor=floor)
    want = jax_native.log_mel_native(y, n_fft=n_fft, hop=hop, center=center, log_floor=floor)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_fft,atol,rtol", [(2048, 5e-5, 0.0), (1000, 1e-4, 1e-5),
                                             (1536, 1e-4, 1e-5)])
def test_log_mel_native_matches_the_oracle(built, n_fft, atol, rtol):
    y = _signal(7)
    got = native.log_mel_native(y, n_fft=n_fft, hop=n_fft // 2)
    ref = oracle_log_mel(y, n_fft=n_fft, hop=n_fft // 2)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


def test_log_mel_native_floor_silence_and_rejection(built):
    y = np.zeros(8192, np.float32)
    assert np.isfinite(native.log_mel_native(y, log_floor=1e-30)).all()
    assert np.isneginf(native.log_mel_native(y)).all()
    assert native.log_mel_native(np.zeros(10, np.float32), center=False).shape == (0, 40)
    for kw in ({"n_fft": -4}, {"n_mels": 0}):
        with pytest.raises(ValueError, match="positive") as got:
            native.log_mel_native(np.zeros(4096, np.float32), **kw)
        with pytest.raises(ValueError) as want:
            jax_native.log_mel_native(np.zeros(4096, np.float32), **kw)
        assert str(got.value) == str(want.value)
    # hop 0 is refused before the library's frame count divides by it (the
    # JAX binding passes it on, and the process dies of SIGFPE)
    with pytest.raises(ValueError, match="hop=0"):
        native.log_mel_native(np.zeros(4096, np.float32), hop=0)


def _write(path, x, sr, fmt):
    """A RIFF/WAVE file of (n, ch) samples: 16-bit PCM (`wavio.write_wav`),
    24-bit PCM, or 32-bit float with an odd-sized extra chunk before data."""
    if fmt == "pcm16":
        wavio.write_wav(path, x, sr)
        return
    n_ch = x.shape[1]
    if fmt == "pcm24":
        v = np.clip(np.round(x * 8388607.0), -8388608, 8388607).astype("<i4")
        data = v.astype("<u4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
        code, bits = 1, 24
    else:
        data, code, bits = x.astype("<f4").tobytes(), 3, 32
    width = bits // 8
    extra = b"LIST" + struct.pack("<I", 3) + b"abc\x00"
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 4 + 24 + len(extra) + 8 + len(data), b"WAVE"))
        f.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, code, n_ch, sr, sr * n_ch * width,
                            n_ch * width, bits))
        f.write(extra)
        f.write(struct.pack("<4sI", b"data", len(data)) + data)


@pytest.mark.parametrize("fmt", ["pcm16", "pcm24", "float32"])
def test_wav_reader_matches_wavio_and_jax(built, tmp_path, fmt):
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.5, 0.5, (5001, 2)).astype(np.float32)
    p = str(tmp_path / f"{fmt}.wav")
    _write(p, x, 48000, fmt)
    got, sr = native.wav_read_mono_native(p)
    ref, sr_ref = wavio.read_wav(p, mono=True)
    assert sr == sr_ref == 48000 and got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)
    want, _ = jax_native.wav_read_mono_native(p)
    np.testing.assert_array_equal(got, want)


def test_wav_reader_rejects_garbage(built, tmp_path):
    p = tmp_path / "bad.wav"
    p.write_bytes(b"definitely not RIFF")
    with pytest.raises(ValueError, match="native wav reader failed"):
        native.wav_read_mono_native(str(p))
    with pytest.raises(ValueError):
        native.wav_read_mono_native(str(tmp_path / "missing.wav"))


def _feed(framer, y, rng, hi):
    parts, i = [], 0
    while i < len(y):
        step = int(rng.integers(1, hi))
        parts.append(framer.feed(y[i : i + step]))
        i += step
    parts.append(framer.flush())
    return np.concatenate(parts, axis=0)


@pytest.mark.parametrize("n_fft,hop,center", [(256, 128, True), (256, 128, False),
                                              (2048, 1024, True), (400, 160, True)])
def test_streaming_framer_is_whole_signal_framing_and_jax(built, n_fft, hop, center):
    y = np.random.default_rng(n_fft).standard_normal(n_fft * 7 + 41).astype(np.float32)
    want = frame_signal(torch.from_numpy(y), n_fft, hop, center).numpy()
    outs = []
    for make in (StreamingFramer, PythonFramer, jax_native.StreamingFramer):
        framer = make(n_fft, hop, center)
        outs.append(_feed(framer, y, np.random.default_rng(11), 700))
        framer.close()
    for got in outs:
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_streaming_framer_guards(built):
    rng = np.random.default_rng(2)
    short = StreamingFramer(256, 128, True)
    short.feed(rng.standard_normal(10).astype(np.float32))
    with pytest.raises(ValueError, match="n_fft/2"):   # reflect undefined
        short.flush()
    done = StreamingFramer(256, 128, True)
    done.feed(rng.standard_normal(300).astype(np.float32))
    done.flush()
    for call in (done.flush, lambda: done.feed(np.zeros(4, np.float32))):
        with pytest.raises(RuntimeError, match="flushed"):
            call()
    with pytest.raises(ValueError, match="invalid framer params"):
        StreamingFramer(0, 128)
    closed = StreamingFramer(256, 128)
    closed.close()
    closed.close()   # the handle is freed once
    with pytest.raises(RuntimeError, match="closed"):
        closed.feed(np.zeros(300, np.float32))


def test_make_framer_choice(built, monkeypatch, tmp_path):
    assert isinstance(native.make_framer(512, 256), StreamingFramer)
    assert type(jax_native.make_framer(512, 256)).__name__ == "StreamingFramer"
    # neither g++ nor a built library: the numpy framer
    monkeypatch.setattr(native, "LIB", tmp_path / "absent" / "liblogmel.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.native_available()
    assert isinstance(native.make_framer(512, 256), PythonFramer)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """Unlike JAX's make_framer, a source that does not build is not hidden."""
    if native.shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH")
    bad = tmp_path / "logmel.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB", tmp_path / "build" / "liblogmel.so")
    native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.make_framer()
    finally:
        native._lib.cache_clear()
    assert os.listdir(tmp_path / "build") == []   # no temporary file left


def test_concurrent_builds_and_rebuild_when_newer(monkeypatch, tmp_path):
    """Workers building at once each write their own temporary file and
    rename it into place; a source newer than the library rebuilds it."""
    if native.shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH")
    lib = tmp_path / "build" / "liblogmel.so"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB", lib)
    results, errors = [], []

    def build():
        try:
            results.append(native.build_library(force=True))
        except Exception as e:  # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert results == [str(lib)] * 4 and os.listdir(lib.parent) == ["liblogmel.so"]
    assert native.build_library() == str(lib)
    # An hour older than the source, whatever the checkout's age.
    old = native.SRC.stat().st_mtime - 3600
    os.utime(lib, (old, old))
    native.build_library()
    assert lib.stat().st_mtime > old
