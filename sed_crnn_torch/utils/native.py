"""ctypes bindings for the port's C++ host library, and the numpy framer.

Counterpart of the JAX package's `utils/native.py`. The library is the
port's copy of the JAX package's source (``sed_crnn_torch/native/
logmel.cpp``, the same bits): a streaming framer for the live serving
chain, a double-precision host log-mel (an independent oracle for kernel
A) and a WAV reader. No pybind11 is assumed, hence the C ABI and ctypes.

`build_library` compiles it with ``g++ -O3 -shared -fPIC -std=c++17`` into
``build/sed_crnn_torch/liblogmel.so`` at the root of the checkout, at first
use (never at import), and again when the source is newer than the
library. The compiler writes a temporary file that is renamed into place,
so concurrent builds (test workers, serving processes) never load a
half-written library.

`make_framer` hands the live chain `StreamingFramer` wherever the library
can be built or is built, and `PythonFramer` (numpy, the same contract and
frame boundaries) only where there is neither ``g++`` nor a built library.
A failed build or load of the port's own source raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from sed_crnn_torch.ops.kernels._build import BUILD_DIR, PACKAGE_DIR

SRC = PACKAGE_DIR / "native" / "logmel.cpp"
LIB = BUILD_DIR / "liblogmel.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def native_available() -> bool:
    """The library is built, or can be: g++ is on PATH and the source is here."""
    return LIB.exists() or (shutil.which("g++") is not None and SRC.exists())


def build_library(force: bool = False) -> str:
    """The library's path, compiled first when it is missing, older than its
    source, or ``force``."""
    if LIB.exists() and not force:
        src_mtime = SRC.stat().st_mtime if SRC.exists() else 0.0
        if LIB.stat().st_mtime >= src_mtime:
            return str(LIB)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not available; cannot build the native log-mel library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB)
    return str(LIB)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library())
    lib.logmel_num_frames.restype = ctypes.c_int64
    lib.logmel_num_frames.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.logmel_extract.restype = ctypes.c_int64
    lib.logmel_extract.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(ctypes.c_float),
    ]
    lib.wav_read_mono.restype = ctypes.c_int64
    lib.wav_read_mono.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.logmel_free.restype = None
    lib.logmel_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.framer_create.restype = ctypes.c_void_p
    lib.framer_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.framer_destroy.restype = None
    lib.framer_destroy.argtypes = [ctypes.c_void_p]
    lib.framer_feed.restype = ctypes.c_int64
    lib.framer_feed.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.framer_flush.restype = ctypes.c_int64
    lib.framer_flush.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.framer_capacity.restype = ctypes.c_int64
    lib.framer_capacity.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def log_mel_native(
    pcm: np.ndarray,
    sr: int = 44100,
    n_fft: int = 2048,
    hop: int = 1024,
    n_mels: int = 40,
    center: bool = True,
    log_floor: Optional[float] = None,
) -> np.ndarray:
    """(n_samples,) float32 -> (n_frames, n_mels) float32 log-mel energies,
    computed in double precision on the host."""
    if min(n_fft, hop, n_mels) <= 0:
        # checked here: the library's frame count divides by hop
        raise ValueError(
            f"native logmel rejected arguments (n_fft={n_fft}, hop={hop}, "
            f"n_mels={n_mels} must all be positive)"
        )
    lib = _lib()
    pcm = np.ascontiguousarray(pcm, dtype=np.float32)
    n_frames = lib.logmel_num_frames(len(pcm), n_fft, hop, int(center))
    out = np.empty((max(n_frames, 0), n_mels), dtype=np.float32)
    if n_frames <= 0:
        return out
    written = lib.logmel_extract(
        _fptr(pcm), len(pcm), sr, n_fft, hop, n_mels, int(center),
        -1.0 if log_floor is None else float(log_floor), _fptr(out),
    )
    return out[:written]


def wav_read_mono_native(path: str) -> Tuple[np.ndarray, int]:
    """A RIFF/WAVE file (PCM16/24/32 or float32, channels averaged) ->
    (samples float32, sample rate)."""
    lib = _lib()
    buf = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_int(0)
    n = lib.wav_read_mono(os.fsencode(path), ctypes.byref(buf), ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"native wav reader failed on {path}")
    try:
        out = np.ctypeslib.as_array(buf, shape=(n,)).copy()
    finally:
        lib.logmel_free(buf)
    return out, sr.value


class StreamingFramer:
    """Incremental librosa-centre framing of a live PCM stream in C++ (the
    library's ``StreamFramer``). Feed arbitrary chunks; complete
    ``(k, n_fft)`` float32 frame blocks come back as soon as enough samples
    exist; `flush` applies the right reflect pad and emits the tail. The
    concatenated output equals `ops/stft.py::frame_signal` on the whole
    signal, bit for bit. Single use after `flush`. One framer per stream:
    an instance is not shared between threads. `close` (or garbage
    collection) frees the C handle, once."""

    _h = None

    def __init__(self, n_fft: int = 2048, hop: int = 1024, center: bool = True):
        self._lib = _lib()
        self._h = self._lib.framer_create(n_fft, hop, int(center))
        if not self._h:
            raise ValueError(f"invalid framer params n_fft={n_fft} hop={hop}")
        self.n_fft, self.hop, self.center = n_fft, hop, center
        self._flushed = False

    def _drain(self, call, pcm: Optional[np.ndarray]) -> np.ndarray:
        if not self._h:
            raise RuntimeError("framer already closed")
        n = 0 if pcm is None else len(pcm)
        cap = self._lib.framer_capacity(self._h, n)
        out = np.empty((cap, self.n_fft), dtype=np.float32)
        if pcm is None:
            k = call(self._h, _fptr(out), cap)
        else:
            k = call(self._h, _fptr(pcm), n, _fptr(out), cap)
        if k < 0:
            raise ValueError(
                "streaming framer error (center mode needs more than "
                "n_fft/2 samples before flush)"
            )
        return out[:k]

    def feed(self, pcm: np.ndarray) -> np.ndarray:
        if self._flushed:
            raise RuntimeError("framer already flushed")
        pcm = np.ascontiguousarray(pcm, dtype=np.float32).ravel()
        return self._drain(self._lib.framer_feed, pcm)

    def flush(self) -> np.ndarray:
        if self._flushed:
            raise RuntimeError("framer already flushed")
        self._flushed = True
        return self._drain(self._lib.framer_flush, None)

    def close(self):
        if self._h:
            self._lib.framer_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class PythonFramer:
    """Incremental librosa-centre framing of a live PCM stream in numpy, with
    `StreamingFramer`'s contract and frame boundaries: feed arbitrary chunks;
    complete ``(k, n_fft)`` float32 frame blocks come back as soon as enough
    samples exist; `flush` applies the right reflect pad and emits the tail.
    The concatenated output equals framing the whole signal
    (`ops/stft.py::frame_signal`). Single use after `flush`."""

    def __init__(self, n_fft: int = 2048, hop: int = 1024, center: bool = True):
        if n_fft <= 0 or hop <= 0:
            raise ValueError(f"invalid framer params n_fft={n_fft} hop={hop}")
        self.n_fft, self.hop, self.center = n_fft, hop, center
        self._pad = n_fft // 2 if center else 0
        self._buf = np.empty(0, np.float32)   # padded-signal suffix
        self._raw = np.empty(0, np.float32)   # raw head until the left pad exists
        self._tail = np.empty(0, np.float32)  # last pad+1 raw samples
        self._left_padded = not center
        self._flushed = False

    def _drain(self) -> np.ndarray:
        if self._buf.size < self.n_fft:
            return np.empty((0, self.n_fft), np.float32)
        n = (self._buf.size - self.n_fft) // self.hop + 1
        idx = np.arange(n)[:, None] * self.hop + np.arange(self.n_fft)[None, :]
        frames = self._buf[idx]
        self._buf = self._buf[n * self.hop:]
        return frames

    def feed(self, pcm: np.ndarray) -> np.ndarray:
        if self._flushed:
            raise RuntimeError("framer already flushed")
        pcm = np.ascontiguousarray(pcm, dtype=np.float32).ravel()
        if self._pad:
            t = np.concatenate([self._tail, pcm])
            self._tail = t[-(self._pad + 1):]
        if not self._left_padded:
            self._raw = np.concatenate([self._raw, pcm])
            if self._raw.size <= self._pad:
                return np.empty((0, self.n_fft), np.float32)
            head = self._raw[1 : self._pad + 1][::-1]
            self._buf = np.concatenate([head, self._raw])
            self._raw = np.empty(0, np.float32)
            self._left_padded = True
        else:
            self._buf = np.concatenate([self._buf, pcm])
        return self._drain()

    def flush(self) -> np.ndarray:
        if self._flushed:
            raise RuntimeError("framer already flushed")
        self._flushed = True
        if not self.center:
            return self._drain()
        if not self._left_padded:
            raise ValueError(
                "streaming framer error (center mode needs more than "
                "n_fft/2 samples before flush)"
            )
        right = self._tail[:-1][::-1][: self._pad]
        self._buf = np.concatenate([self._buf, right])
        return self._drain()

    def close(self):
        pass


def make_framer(n_fft: int = 2048, hop: int = 1024, center: bool = True):
    """The streaming framer of the live chain: `StreamingFramer` where the
    library is built or can be built (a failed build or load raises), else
    `PythonFramer`."""
    if native_available():
        return StreamingFramer(n_fft, hop, center)
    return PythonFramer(n_fft, hop, center)
