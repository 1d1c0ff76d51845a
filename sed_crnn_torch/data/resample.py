"""Polyphase sample-rate conversion in numpy, with no ffmpeg or scipy.

A copy of the JAX package's `data/resample.py`; like it, this runs on the
host (file IO, as the reference's ffmpeg subprocess was), not on the card.
The reference delegated rate conversion to ffmpeg's resampler (``-ar
44100``); this is a windowed-sinc polyphase resampler of the same family as
ffmpeg's swresample and scipy's ``resample_poly``: a Kaiser-windowed sinc
low-pass at the tighter of the two Nyquist rates, applied at the upsampled
rate, one convolution per polyphase leg.

* Pure numpy, float64 filtering: determinism and parity matter more than
  FLOPs here.
* The filter design is ``scipy.signal.firwin(n, 1/max_rate, window=("kaiser",
  beta))`` (sinc * kaiser, DC-normalized).
* The output length is ``ceil(n * up / down)`` and the filter is centred
  (group delay compensated), scipy's semantics: y[m] estimates x(t) at
  t = m * down / up.
"""

from __future__ import annotations

from math import ceil, gcd

import numpy as np


def _kaiser_beta_for_attenuation(atten_db: float) -> float:
    """Kaiser's published beta formula (Oppenheim & Schafer eq. 7.62)."""
    if atten_db > 50.0:
        return 0.1102 * (atten_db - 8.7)
    if atten_db > 21.0:
        return 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    return 0.0


def design_resample_filter(
    up: int,
    down: int,
    half_len_mult: int = 10,
    atten_db: float = 60.0,
    beta: float | None = None,
) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for an up/down polyphase resampler.

    Cutoff at ``1/max(up, down)`` of the upsampled Nyquist (pass the narrower
    band), ``2 * half_len_mult * max(up, down) + 1`` taps, DC gain 1 before
    the ``up`` interpolation-gain factor. Matches scipy's
    ``resample_poly`` default construction when ``atten_db`` maps to the same
    beta (scipy hardcodes beta=5.0 ~= 50 dB; our default 60 dB is slightly
    sharper — tests pin both)."""
    g = gcd(up, down)
    up //= g
    down //= g
    max_rate = max(up, down)
    cutoff = 1.0 / max_rate  # in units of the upsampled Nyquist
    half_len = half_len_mult * max_rate
    n_taps = 2 * half_len + 1
    if beta is None:
        beta = _kaiser_beta_for_attenuation(atten_db)
    n = np.arange(n_taps, dtype=np.float64) - half_len
    taps = cutoff * np.sinc(cutoff * n) * np.kaiser(n_taps, beta)
    taps /= taps.sum()  # exact unity DC gain (firwin scale=True)
    return taps * up  # interpolation gain: up-1 of every up inputs are zeros


def resample_poly(
    x: np.ndarray, up: int, down: int, taps: np.ndarray | None = None
) -> np.ndarray:
    """Polyphase rational resampling of ``x`` along axis 0 by ``up/down``.

    Accepts 1-D ``(n,)`` or 2-D ``(n, ch)`` input; returns float
    ``ceil(n * up / down)`` samples at the new rate, filter-delay
    compensated. ``taps`` overrides the default Kaiser design (must be odd
    length, centered)."""
    if up < 1 or down < 1:
        raise ValueError(f"up/down must be positive, got {up}/{down}")
    g = gcd(up, down)
    up //= g
    down //= g
    x = np.asarray(x)
    if x.ndim not in (1, 2):
        raise ValueError(f"expected 1-D or 2-D input, got shape {x.shape}")
    if up == 1 and down == 1:
        return x.astype(np.float32, copy=True)
    squeeze = x.ndim == 1
    cols = x[:, None] if squeeze else x
    n_in = cols.shape[0]
    if n_in == 0:
        out = np.zeros((0,) + cols.shape[1:], dtype=np.float32)
        return out[:, 0] if squeeze else out

    if taps is None:
        taps = design_resample_filter(up, down)
    taps = np.asarray(taps, dtype=np.float64)
    if taps.ndim != 1 or taps.size % 2 != 1:
        raise ValueError("taps must be a 1-D odd-length (centered) filter")
    delay = taps.size // 2

    # y[m] = sum_j h[j*up + p] * x[n0 - j],  q = m*down + delay,
    # p = q % up, n0 = q // up  — one short convolution per polyphase leg,
    # outputs of leg p land at m = m_p, m_p + up, ... (down ⊥ up covers all
    # phases). conv_full(x, h_p)[n] is exactly sum_j h_p[j] x[n-j] with
    # zeros outside x, which is the zero-padded boundary scipy uses.
    n_out = int(ceil(n_in * up / down))
    y = np.zeros((n_out,) + cols.shape[1:], dtype=np.float64)
    m = np.arange(n_out, dtype=np.int64)
    q = m * down + delay
    phase = q % up
    n0 = q // up
    xf = cols.astype(np.float64)
    for p in range(up):
        hp = taps[p::up]
        if hp.size == 0:
            continue
        sel = np.nonzero(phase == p)[0]
        if sel.size == 0:
            continue
        idx = n0[sel]
        full = np.stack(
            [np.convolve(xf[:, c], hp, mode="full") for c in range(xf.shape[1])],
            axis=1,
        )
        valid = idx < full.shape[0]  # beyond that, x's zero-padding tail
        y[sel[valid]] = full[idx[valid]]
    out = y.astype(np.float32)
    return out[:, 0] if squeeze else out


class StreamingResampler:
    """Chunk-wise polyphase resampling with carried filter history, for live
    input where PCM arrives in packets of any size and the offline
    converter's whole-signal view is unavailable.

    Contract: ``concat(push(c) for chunks) + flush()`` equals
    ``resample_poly(concat(chunks), up, down)`` sample for sample (float32
    rounding) — the streaming boundary introduces no seams. An output sample
    is emitted as soon as its full filter support has arrived; ``flush()``
    supplies the zero-padded tail the offline converter assumes past the end
    of the signal."""

    def __init__(self, sr_in: int, sr_out: int, taps: np.ndarray | None = None):
        if sr_in <= 0 or sr_out <= 0:
            raise ValueError(f"sample rates must be positive, got {sr_in}->{sr_out}")
        g = gcd(sr_out, sr_in)
        self.up, self.down = sr_out // g, sr_in // g
        self.passthrough = self.up == 1 and self.down == 1
        if self.passthrough:
            return
        if taps is None:
            taps = design_resample_filter(self.up, self.down)
        taps = np.asarray(taps, dtype=np.float64)
        if taps.ndim != 1 or taps.size % 2 != 1:
            raise ValueError("taps must be a 1-D odd-length (centered) filter")
        self.delay = taps.size // 2
        # polyphase tap matrix: row p holds h[p::up], zero-padded to Lmax
        self.L = -(-taps.size // self.up)
        self.T = np.zeros((self.up, self.L), dtype=np.float64)
        for p in range(self.up):
            leg = taps[p :: self.up]
            self.T[p, : leg.size] = leg
        self._reset()

    def _reset(self):
        self.buf = np.zeros(0, dtype=np.float64)
        self.buf_start = 0  # absolute input index of buf[0]
        self.total_in = 0
        self.m_next = 0

    def _emit(self, m_lo: int, m_hi: int) -> np.ndarray:
        """y[m_lo:m_hi]; input indices beyond the buffer read as zero (the
        offline converter's zero-padded boundary)."""
        if m_hi <= m_lo:
            return np.zeros(0, dtype=np.float32)
        m = np.arange(m_lo, m_hi, dtype=np.int64)
        q = m * self.down + self.delay
        n0 = q // self.up
        idx = n0[:, None] - np.arange(self.L, dtype=np.int64)[None, :]
        rel = idx - self.buf_start
        valid = (idx >= 0) & (rel >= 0) & (rel < self.buf.size)
        if self.buf.size:
            xg = np.where(valid, self.buf[np.clip(rel, 0, self.buf.size - 1)], 0.0)
        else:
            xg = np.zeros(rel.shape, dtype=np.float64)
        y = np.einsum("ml,ml->m", self.T[q % self.up], xg)
        return y.astype(np.float32)

    def push(self, chunk: np.ndarray) -> np.ndarray:
        """Feed PCM samples; returns every output sample whose filter
        support is now complete."""
        chunk = np.asarray(chunk, dtype=np.float64).reshape(-1)
        if self.passthrough:
            return chunk.astype(np.float32)
        self.buf = np.concatenate([self.buf, chunk])
        self.total_in += chunk.size
        # last emittable m: n0(m) <= total_in - 1
        m_hi = (self.total_in * self.up - 1 - self.delay) // self.down + 1
        out = self._emit(self.m_next, max(m_hi, self.m_next))
        self.m_next = max(m_hi, self.m_next)
        # future outputs only read x[n0(m_next) - L + 1 :]
        keep_from = (self.m_next * self.down + self.delay) // self.up - self.L + 1
        drop = max(0, keep_from - self.buf_start)
        if drop:
            self.buf = self.buf[drop:]
            self.buf_start += drop
        return out

    def flush(self) -> np.ndarray:
        """End of stream: the remaining outputs up to the offline length
        ``ceil(total * up / down)``, then reset for a new stream."""
        if self.passthrough:
            return np.zeros(0, dtype=np.float32)
        n_out = int(ceil(self.total_in * self.up / self.down))
        out = self._emit(self.m_next, n_out)
        self._reset()
        return out


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Convert ``x`` (axis 0 = time, optional channel axis 1) from ``sr_in``
    to ``sr_out`` Hz. Identity (with dtype normalization to float32) when the
    rates match."""
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError(f"sample rates must be positive, got {sr_in}->{sr_out}")
    if sr_in == sr_out:
        return np.asarray(x, dtype=np.float32)
    g = gcd(sr_out, sr_in)
    return resample_poly(x, sr_out // g, sr_in // g)
