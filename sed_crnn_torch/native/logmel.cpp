// Native host-side log-mel frontend, WAV reader and streaming framer for
// sed_crnn_torch (`utils/native.py` binds it with ctypes).
//
// The port's own copy of the JAX package's host library: the same source,
// so the two libraries compute the same bits. Self-contained C++ with no
// external dependencies: reflect-padded framing, periodic Hann window,
// iterative radix-2 FFT with a Bluestein chirp-z fallback for arbitrary
// n_fft, Slaney-scale area-normalized mel filterbank, natural log.
// Double-precision math throughout, so it doubles as an independent parity
// oracle for the device kernels. Exposed as a C ABI for ctypes.
//
// Build (at first use, by utils/native.py::build_library):
//   g++ -O3 -shared -fPIC -std=c++17 logmel.cpp -o liblogmel.so

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------- FFT ----
// Iterative radix-2 Cooley-Tukey over interleaved (re, im) pairs.
void fft_pow2_inplace(double* re, double* im, int n) {
  // bit reversal
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (int len = 2; len <= n; len <<= 1) {
    double ang = -2.0 * kPi / len;
    double wre = std::cos(ang), wim = std::sin(ang);
    for (int i = 0; i < n; i += len) {
      double cre = 1.0, cim = 0.0;
      for (int k = 0; k < len / 2; ++k) {
        int a = i + k, b = i + k + len / 2;
        double tre = re[b] * cre - im[b] * cim;
        double tim = re[b] * cim + im[b] * cre;
        re[b] = re[a] - tre;
        im[b] = im[a] - tim;
        re[a] += tre;
        im[a] += tim;
        double ncre = cre * wre - cim * wim;
        cim = cre * wim + cim * wre;
        cre = ncre;
      }
    }
  }
}

// Bluestein's chirp-z transform: DFT of arbitrary length n as a circular
// convolution of size m = next power of two >= 2n-1, so the oracle accepts
// any n_fft (the device paths never had the radix-2 restriction). Angles use
// k^2 mod 2n to stay exact for large k (pi*k^2/n is periodic in 2n).
void fft_bluestein(double* re, double* im, int n) {
  int m = 1;
  while (m < 2 * n - 1) m <<= 1;
  std::vector<double> are(m, 0.0), aim(m, 0.0), bre(m, 0.0), bim(m, 0.0);
  std::vector<double> cre(n), cim(n);  // chirp c_k = exp(-i*pi*k^2/n)
  for (int k = 0; k < n; ++k) {
    const double ang = kPi * static_cast<double>(
        (static_cast<int64_t>(k) * k) % (2 * n)) / n;
    cre[k] = std::cos(ang);
    cim[k] = -std::sin(ang);
    // a_k = x_k * c_k
    are[k] = re[k] * cre[k] - im[k] * cim[k];
    aim[k] = re[k] * cim[k] + im[k] * cre[k];
    // b_k = conj(c_k), wrapped circularly for negative lags
    bre[k] = cre[k];
    bim[k] = -cim[k];
    if (k > 0) {
      bre[m - k] = bre[k];
      bim[m - k] = bim[k];
    }
  }
  fft_pow2_inplace(are.data(), aim.data(), m);
  fft_pow2_inplace(bre.data(), bim.data(), m);
  for (int k = 0; k < m; ++k) {  // pointwise product
    const double r = are[k] * bre[k] - aim[k] * bim[k];
    aim[k] = are[k] * bim[k] + aim[k] * bre[k];
    are[k] = r;
  }
  // inverse FFT via conjugation
  for (int k = 0; k < m; ++k) aim[k] = -aim[k];
  fft_pow2_inplace(are.data(), aim.data(), m);
  for (int k = 0; k < n; ++k) {
    const double vr = are[k] / m, vi = -aim[k] / m;
    // X_k = c_k * (a (*) b)_k
    re[k] = vr * cre[k] - vi * cim[k];
    im[k] = vr * cim[k] + vi * cre[k];
  }
}

void fft_inplace(double* re, double* im, int n) {
  if ((n & (n - 1)) == 0) {
    fft_pow2_inplace(re, im, n);
  } else {
    fft_bluestein(re, im, n);
  }
}

// ------------------------------------------------------------- mel fb ----
// Slaney scale: linear below 1 kHz (200/3 Hz per mel), log above
// (log(6.4)/27 per mel); area normalization 2/(f_hi - f_lo).
double hz_to_mel(double f) {
  const double f_sp = 200.0 / 3.0;
  const double brk = 1000.0, brk_mel = brk / f_sp;
  const double step = std::log(6.4) / 27.0;
  return f < brk ? f / f_sp : brk_mel + std::log(f / brk) / step;
}

double mel_to_hz(double m) {
  const double f_sp = 200.0 / 3.0;
  const double brk = 1000.0, brk_mel = brk / f_sp;
  const double step = std::log(6.4) / 27.0;
  return m < brk_mel ? m * f_sp : brk * std::exp(step * (m - brk_mel));
}

std::vector<double> mel_filterbank(int sr, int n_fft, int n_mels) {
  const int n_bins = n_fft / 2 + 1;
  std::vector<double> edges(n_mels + 2);
  const double mel_max = hz_to_mel(sr / 2.0);
  for (int i = 0; i < n_mels + 2; ++i)
    edges[i] = mel_to_hz(mel_max * i / (n_mels + 1));
  std::vector<double> fb(static_cast<size_t>(n_mels) * n_bins, 0.0);
  for (int m = 0; m < n_mels; ++m) {
    const double lo = edges[m], mid = edges[m + 1], hi = edges[m + 2];
    const double enorm = 2.0 / (hi - lo);
    for (int b = 0; b < n_bins; ++b) {
      const double f = 0.5 * sr * b / (n_bins - 1);
      const double up = (f - lo) / (mid - lo);
      const double down = (hi - f) / (hi - mid);
      const double w = std::fmin(up, down);
      if (w > 0.0) fb[static_cast<size_t>(m) * n_bins + b] = w * enorm;
    }
  }
  return fb;
}

}  // namespace

extern "C" {

// Number of STFT frames the extractor will produce.
int64_t logmel_num_frames(int64_t n_samples, int n_fft, int hop, int center) {
  int64_t padded = n_samples + (center ? n_fft : 0);
  if (padded < n_fft) return 0;
  return 1 + (padded - n_fft) / hop;
}

// pcm (n_samples float32) -> out (n_frames * n_mels float32, row-major).
// log_floor <= 0 means no floor (log(0) -> -inf, reference parity).
// Returns the number of frames written, or -1 on invalid arguments.
int64_t logmel_extract(const float* pcm, int64_t n_samples, int sr, int n_fft,
                       int hop, int n_mels, int center, double log_floor,
                       float* out) {
  if (n_fft <= 0 || hop <= 0 || n_mels <= 0) return -1;
  const int64_t n_frames = logmel_num_frames(n_samples, n_fft, hop, center);
  if (n_frames <= 0) return 0;
  const int n_bins = n_fft / 2 + 1;
  const int pad = center ? n_fft / 2 : 0;

  std::vector<double> window(n_fft);
  for (int i = 0; i < n_fft; ++i)
    window[i] = 0.5 - 0.5 * std::cos(2.0 * kPi * i / n_fft);
  const std::vector<double> fb = mel_filterbank(sr, n_fft, n_mels);

  // reflect-padded sample accessor (librosa center=True semantics)
  auto sample = [&](int64_t idx) -> double {
    int64_t i = idx - pad;
    if (i < 0) i = -i;
    if (i >= n_samples) i = 2 * (n_samples - 1) - i;
    if (i < 0 || i >= n_samples) return 0.0;  // degenerate tiny inputs
    return static_cast<double>(pcm[i]);
  };

  std::vector<double> re(n_fft), im(n_fft), power(n_bins);
  for (int64_t t = 0; t < n_frames; ++t) {
    const int64_t start = t * hop;
    for (int i = 0; i < n_fft; ++i) {
      re[i] = sample(start + i) * window[i];
      im[i] = 0.0;
    }
    fft_inplace(re.data(), im.data(), n_fft);
    for (int b = 0; b < n_bins; ++b)
      power[b] = re[b] * re[b] + im[b] * im[b];
    float* row = out + t * n_mels;
    for (int m = 0; m < n_mels; ++m) {
      const double* w = fb.data() + static_cast<size_t>(m) * n_bins;
      double acc = 0.0;
      for (int b = 0; b < n_bins; ++b) acc += w[b] * power[b];
      if (log_floor > 0.0 && acc < log_floor) acc = log_floor;
      row[m] = static_cast<float>(std::log(acc));
    }
  }
  return n_frames;
}

// Minimal RIFF/WAVE reader: PCM16/24/32 + float32, multichannel -> mono mean.
// Returns sample count written into *out_samples (caller frees with
// logmel_free), sample rate via *out_sr; -1 on parse error.
int64_t wav_read_mono(const char* path, float** out_samples, int* out_sr) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  auto rd_u32 = [&]() { uint8_t b[4]; if (std::fread(b, 1, 4, f) != 4) return -1L; return (long)(b[0] | b[1] << 8 | b[2] << 16 | (uint32_t)b[3] << 24); };
  char tag[5] = {0};
  if (std::fread(tag, 1, 4, f) != 4 || std::strcmp(tag, "RIFF")) { std::fclose(f); return -1; }
  rd_u32();
  if (std::fread(tag, 1, 4, f) != 4 || std::strcmp(tag, "WAVE")) { std::fclose(f); return -1; }

  int fmt_code = 0, n_ch = 0, bits = 0, sr = 0;
  std::vector<uint8_t> data;
  while (std::fread(tag, 1, 4, f) == 4) {
    long size = rd_u32();
    if (size < 0) break;
    if (!std::strcmp(tag, "fmt ")) {
      std::vector<uint8_t> fmt(size);
      if (std::fread(fmt.data(), 1, size, f) != (size_t)size) break;
      if (size & 1) std::fseek(f, 1, SEEK_CUR);  // RIFF chunks pad to even
      fmt_code = fmt[0] | fmt[1] << 8;
      n_ch = fmt[2] | fmt[3] << 8;
      sr = fmt[4] | fmt[5] << 8 | fmt[6] << 16 | fmt[7] << 24;
      bits = fmt[14] | fmt[15] << 8;
      if (fmt_code == 0xFFFE && size >= 26) fmt_code = fmt[24] | fmt[25] << 8;
    } else if (!std::strcmp(tag, "data")) {
      data.resize(size);
      if (std::fread(data.data(), 1, size, f) != (size_t)size) { std::fclose(f); return -1; }
      if (size & 1) std::fseek(f, 1, SEEK_CUR);
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
    }
    if (fmt_code && !data.empty()) break;
  }
  std::fclose(f);
  if (!fmt_code || data.empty() || n_ch <= 0) return -1;

  const int bytes = bits / 8;
  const int64_t n_total = (int64_t)data.size() / bytes;
  const int64_t n = n_total / n_ch;
  float* mono = new float[n];
  for (int64_t i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int c = 0; c < n_ch; ++c) {
      const uint8_t* p = data.data() + (i * n_ch + c) * bytes;
      double v = 0.0;
      if (fmt_code == 3 && bits == 32) {
        float fv;
        std::memcpy(&fv, p, 4);
        v = fv;
      } else if (bits == 16) {
        v = (int16_t)(p[0] | p[1] << 8) / 32768.0;
      } else if (bits == 24) {
        int32_t s = p[0] | p[1] << 8 | p[2] << 16;
        if (s & 0x800000) s -= 1 << 24;
        v = s / 8388608.0;
      } else if (bits == 32) {
        int32_t s;
        std::memcpy(&s, p, 4);
        v = s / 2147483648.0;
      } else {
        delete[] mono;
        return -1;
      }
      acc += v;
    }
    mono[i] = (float)(acc / n_ch);
  }
  *out_samples = mono;
  *out_sr = sr;
  return n;
}

void logmel_free(float* p) { delete[] p; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Streaming PCM framer: incremental librosa-center framing for live audio.
//
// Feeds of arbitrary-sized PCM chunks come in; complete n_fft frames
// (hop-advanced, reflect-padded at the stream head exactly like
// `ops/stft.py::frame_signal(center=True)`) come out as soon as enough
// samples exist. `framer_flush` applies the right reflect pad and emits the
// tail frames, matching the whole-signal framing bit for bit (parity test:
// tests/test_torch_native.py). This is the host IO piece of a real-time serving
// chain: ring-feed PCM -> frames -> fused log-mel -> artifact stream_step.
// ---------------------------------------------------------------------------

struct StreamFramer {
  int n_fft = 0, hop = 0, center = 0;
  int64_t pos = 0;             // next frame start, indexed into `sig`
  int64_t n_raw = 0;           // raw samples seen so far
  bool left_padded = false;    // reflect head emitted into `sig`?
  std::vector<float> sig;      // padded-signal suffix not yet fully consumed
  std::vector<float> tail;     // last pad+1 raw samples (for the right pad)
};

extern "C" {

void* framer_create(int n_fft, int hop, int center) {
  if (n_fft <= 0 || hop <= 0) return nullptr;
  auto* f = new StreamFramer();
  f->n_fft = n_fft;
  f->hop = hop;
  f->center = center;
  f->left_padded = (center == 0);  // non-center mode needs no head pad
  return f;
}

void framer_destroy(void* p) { delete static_cast<StreamFramer*>(p); }

// Emit every complete frame currently available into out (n_fft floats per
// frame, row-major, up to max_frames). Returns frames written.
static int64_t drain(StreamFramer* f, float* out, int64_t max_frames) {
  int64_t written = 0;
  while (written < max_frames &&
         f->pos + f->n_fft <= static_cast<int64_t>(f->sig.size())) {
    std::copy(f->sig.begin() + f->pos, f->sig.begin() + f->pos + f->n_fft,
              out + written * f->n_fft);
    f->pos += f->hop;
    ++written;
  }
  // Drop the consumed prefix occasionally to bound memory.
  if (f->pos > 4 * f->n_fft) {
    f->sig.erase(f->sig.begin(), f->sig.begin() + f->pos);
    f->pos = 0;
  }
  return written;
}

// Feed n PCM samples; writes complete frames to out (caller sizes it with
// framer_capacity). Returns frames written, or -1 on error.
int64_t framer_feed(void* p, const float* pcm, int64_t n, float* out,
                    int64_t max_frames) {
  auto* f = static_cast<StreamFramer*>(p);
  if (!f || (n > 0 && !pcm)) return -1;
  const int pad = f->n_fft / 2;
  // Track the last pad+1 raw samples for the eventual right reflect pad.
  f->tail.insert(f->tail.end(), pcm, pcm + n);
  if (static_cast<int64_t>(f->tail.size()) > pad + 1)
    f->tail.erase(f->tail.begin(), f->tail.end() - (pad + 1));
  if (!f->left_padded) {
    // Accumulate raw samples until the head reflect pad (y[pad..1]) exists.
    f->sig.insert(f->sig.end(), pcm, pcm + n);
    f->n_raw += n;
    if (f->n_raw <= pad) return 0;  // not enough to synthesize the head yet
    std::vector<float> head(pad);
    for (int i = 0; i < pad; ++i) head[i] = f->sig[pad - i];
    f->sig.insert(f->sig.begin(), head.begin(), head.end());
    f->left_padded = true;
  } else {
    f->sig.insert(f->sig.end(), pcm, pcm + n);
    f->n_raw += n;
  }
  return drain(f, out, max_frames);
}

// End of stream: apply the right reflect pad (center mode) and emit the
// remaining frames. Returns frames written, or -1 if the stream was too
// short to frame (center mode needs > n_fft/2 raw samples).
int64_t framer_flush(void* p, float* out, int64_t max_frames) {
  auto* f = static_cast<StreamFramer*>(p);
  if (!f) return -1;
  const int pad = f->n_fft / 2;
  if (f->center) {
    if (!f->left_padded) return -1;  // n_raw <= pad: reflect undefined
    // Right pad: y[n-2], y[n-3], ..., y[n-1-pad] — from the raw tail.
    const int64_t t = static_cast<int64_t>(f->tail.size());
    if (t < 2) return -1;
    for (int i = 0; i < pad; ++i) {
      int64_t idx = t - 2 - i;
      if (idx < 0) return -1;  // stream shorter than pad+1 raw samples
      f->sig.push_back(f->tail[idx]);
    }
  }
  return drain(f, out, max_frames);
}

// Upper bound on frames a feed/flush of n more samples can emit.
int64_t framer_capacity(void* p, int64_t n) {
  auto* f = static_cast<StreamFramer*>(p);
  if (!f) return 0;
  int64_t avail = static_cast<int64_t>(f->sig.size()) - f->pos + n + f->n_fft;
  return avail > 0 ? avail / f->hop + 2 : 2;
}

}  // extern "C"
