"""WAV decode and encode in numpy, with no audio library, and the ffmpeg
paths for other containers.

A copy of the JAX package's `data/wavio.py`: a RIFF parser for PCM
8/16/24/32-bit and IEEE float32/64, channel averaging for forced mono
(ffmpeg's ``-ac 1``), `data/resample.py` for a wav at another rate, and an
ffmpeg subprocess for any other container when the binary exists (ffprobe
for the media probes).
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
from typing import Optional, Tuple

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


def read_wav_multichannel(path: str) -> Tuple[np.ndarray, int]:
    """(n, ch) float32 and the sample rate: the binaural DCASE pipeline's
    reader."""
    x, sr = read_wav(path, mono=False)
    if x.ndim == 1:
        x = x[:, None]
    return x, sr


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


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def decode_audio(
    path: str, sr: int = 44100, mono: bool = True, channels: Optional[int] = None
) -> np.ndarray:
    """Decode a media file to float32 PCM at ``sr``. WAV files use the
    native reader, a rate mismatch converted by the polyphase resampler
    (`data/resample.py`, the family of ffmpeg's swresample, which the
    reference used through ``-ar``). Other containers pipe through ffmpeg
    (f32le, ``-ac 1`` for mono) when the binary exists, and raise otherwise.

    ``mono=False`` returns (n, ch); the ffmpeg path emits interleaved
    samples without channel metadata, so it needs ``channels`` to
    de-interleave (the WAV path reads the count from the header)."""
    if path.lower().endswith(".wav"):
        x, file_sr = read_wav(path, mono=mono)
        if file_sr == sr:
            return x
        from sed_crnn_torch.data.resample import resample

        return resample(x, file_sr, sr)
    if not ffmpeg_available():
        raise RuntimeError(f"cannot decode {path}: ffmpeg not available")
    if not mono and channels is None:
        raise ValueError(
            f"{path}: mono=False via the ffmpeg path needs explicit `channels` "
            "to de-interleave the f32le stream"
        )
    cmd = ["ffmpeg", "-v", "error", "-i", path, "-f", "f32le"]
    cmd += ["-ac", "1"] if mono else ["-ac", str(channels)]
    cmd += ["-ar", str(sr), "pipe:1"]
    raw = subprocess.check_output(cmd)
    x = np.frombuffer(raw, dtype=np.float32)
    if not mono:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
    return x


def probe_duration(path: str) -> Optional[float]:
    """Media duration in seconds via ffprobe; None if unavailable."""
    if shutil.which("ffprobe") is None:
        return None
    try:
        out = subprocess.check_output(
            [
                "ffprobe", "-v", "error", "-show_entries", "format=duration",
                "-of", "default=noprint_wrappers=1:nokey=1", path,
            ]
        )
        return float(out.strip())
    except (subprocess.CalledProcessError, ValueError):
        return None


def probe_media_meta(path: str) -> dict:
    """Media metadata from one ffprobe run: fps, frame count, width, height
    and duration (what the reference's OpenCV probe collected). Missing or
    unprobeable fields are None (audio-only files have no video stream)."""
    meta = {"fps": None, "n_frames": None, "width": None, "height": None,
            "duration_s": None}
    if shutil.which("ffprobe") is None:
        return meta
    try:
        out = subprocess.check_output(
            [
                "ffprobe", "-v", "error", "-select_streams", "v:0",
                "-show_entries",
                "format=duration:stream=avg_frame_rate,nb_frames,width,height",
                "-of", "default=noprint_wrappers=1", path,
            ]
        ).decode()
    except subprocess.CalledProcessError:
        return meta
    for line in out.splitlines():
        key, _, val = line.partition("=")
        val = val.strip()
        if not val or val in ("N/A", "0/0"):
            continue
        try:
            if key == "avg_frame_rate":
                num, _, den = val.partition("/")
                meta["fps"] = float(num) / float(den) if den else float(num)
            elif key == "nb_frames":
                meta["n_frames"] = int(val)
            elif key in ("width", "height"):
                meta[key] = int(val)
            elif key == "duration":
                meta["duration_s"] = float(val)
        except (ValueError, ZeroDivisionError):
            pass
    return meta
