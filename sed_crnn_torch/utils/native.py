"""The streaming framer of the live serving chain, numpy only.

Counterpart of the JAX package's `utils/native.py`. There, a C++ library
(`native/logmel.cpp`) supplies a streaming framer, a host log-mel and a wav
reader, with `PythonFramer` as the numpy fallback of the framer. The port
keeps `PythonFramer`, which has the C++ framer's contract and frame
boundaries, and `make_framer` returns it; the C++ library is not ported.
"""

from __future__ import annotations

import numpy as np


class PythonFramer:
    """Incremental librosa-centre framing of a live PCM stream: feed
    arbitrary chunks; complete ``(k, n_fft)`` float32 frame blocks come back
    as soon as enough samples exist; `flush` applies the right reflect pad
    and emits the tail. The concatenated output equals framing the whole
    signal (`ops/stft.py::frame_signal`). Single use after `flush`."""

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


def make_framer(n_fft: int = 2048, hop: int = 1024, center: bool = True) -> PythonFramer:
    """The streaming framer of the live chain."""
    return PythonFramer(n_fft, hop, center)
