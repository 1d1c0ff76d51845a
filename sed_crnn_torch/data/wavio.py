"""WAV decode and encode in numpy, with no audio library.

A copy of the JAX package's `data/wavio.py` readers: a RIFF parser for PCM
8/16/24/32-bit and IEEE float32/64, channel averaging for forced mono.
`decode_audio` takes wav files at the model's sample rate; resampling and
other containers (ffmpeg) are not yet ported and raise.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np


def read_wav(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Returns (samples float32 in [-1, 1], sample_rate). Multichannel files
    return shape (n, ch) unless ``mono`` (mean over channels)."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", header)
            if chunk_id == b"fmt ":
                fmt = f.read(chunk_size)
                f.seek(chunk_size & 1, os.SEEK_CUR)  # RIFF chunks pad to even
            elif chunk_id == b"data":
                data = f.read(chunk_size)
                f.seek(chunk_size & 1, os.SEEK_CUR)
            else:
                f.seek(chunk_size + (chunk_size & 1), os.SEEK_CUR)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, n_ch, sr, _br, _ba, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1:  # integer PCM
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(data, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")

    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch)
        if mono:
            x = x.mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), int(sr)


def write_wav(path: str, samples: np.ndarray, sr: int) -> None:
    """Write float32 samples as 16-bit PCM (test fixtures / debugging)."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
    n_ch = pcm.shape[1]
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(data), b"WAVE"))
        f.write(
            struct.pack(
                "<4sIHHIIHH", b"fmt ", 16, 1, n_ch, sr, sr * n_ch * 2, n_ch * 2, 16
            )
        )
        f.write(struct.pack("<4sI", b"data", len(data)))
        f.write(data)


def decode_audio(path: str, sr: int = 44100, mono: bool = True) -> np.ndarray:
    """Decode a wav file to float32 PCM at ``sr``."""
    if not path.lower().endswith(".wav"):
        raise NotImplementedError(
            f"{path}: only wav input is ported; the ffmpeg path is not yet ported"
        )
    x, file_sr = read_wav(path, mono=mono)
    if file_sr != sr:
        raise NotImplementedError(
            f"{path}: sample rate {file_sr} != {sr}; resampling is not yet ported"
        )
    return x
