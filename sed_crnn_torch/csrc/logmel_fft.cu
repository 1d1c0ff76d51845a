// Log-mel by a real FFT in shared memory, for Hopper (sm_90a): windowed frame
// -> real FFT -> power -> sparse mel -> floor -> log, in one pass over the
// waveform, with no spectral intermediate in device memory.
//
// Replaces, at every power-of-two n_fft from 256 to 16384 (template LOGN 8 ..
// 14), the three TPU kernels of sed_crnn_tpu/ops/pallas/fused_logmel.py:
// `_kernel_dif_chunked` (hop == n_fft / 2), `_kernel_dif` (any hop, or a
// frame matrix) and `_kernel_exact` (mode "exact"). All three compute the
// same function; the frame stride picks the source: M = n_fft / 2 for the
// chunked route, the hop on the padded waveform, n_fft on a frame matrix.
// Other sizes take csrc/logmel_mixed.cu or csrc/logmel_cluster.cu.
//
// What bounds it on an H100: the function's least work per frame is an
// rFFT (2.5 N log2 N flops), the power and the sparse mel product (about 1.9
// weights per bin in all), against 4 * hop bytes of new waveform per frame.
// At hop 1024 that is device-memory bytes at n_fft 1024 and 2048 and float32
// operations at 4096. The design keeps every intermediate on chip and
// touches device memory once for the samples and once for the log-mels: a
// frame is read at src[t * stride + k] (size_t index), windowed on load and
// packed as n_fft / 2 complex points z[n] = x[2n] + i x[2n+1]; a radix-4
// Stockham FFT (one radix-2 stage first when log2(n_fft / 2) is odd) runs in
// shared memory, 4 * n_fft bytes a frame, with the butterflies in registers:
// n_fft / 16 threads a frame, 8 complex points each, several frames a block
// below n_fft 4096 (256 threads). The real-to-complex untangle writes |X_k|^2
// of the n_fft / 2 + 1 bins to shared memory, and one thread sums each
// (frame, mel) cell over its band's contiguous bin range in bin order, then
// applies the floor and logf and stores coalesced. A block owns its frames
// whole: no partial sums, no atomics, no second pass, so the result is
// bitwise the same from run to run. Samples load as 16-byte vectors when the
// frame base and stride allow it (a template flag chosen from the pointer
// and the stride), one float at a time otherwise; the arithmetic is the same
// in both, and every product and sum is an explicitly rounded float32
// operation (no FMA contraction), so a frame's bits do not depend on the
// stride or the source, and the plain PyTorch version repeats them. Twiddles
// come from tables computed in float64 and rounded to float32 on the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "logmel_stages.cuh"

namespace {

using logmel::bin_power;
using logmel::butterfly;
using logmel::cmul;

constexpr int MIN_LOG_N = 8;    // n_fft 256
constexpr int MAX_LOG_N = 14;   // n_fft 16384
constexpr int POINTS = 8;       // complex points a thread holds per stage
constexpr int MIN_THREADS = 256;

template <int LOGN>
struct Shape {
  static constexpr int N = 1 << LOGN;
  static constexpr int H = N / 2;               // complex FFT length
  static constexpr int LOGH = LOGN - 1;
  static constexpr int TPF = H / POINTS;        // threads per frame
  static constexpr int FPB = TPF >= MIN_THREADS ? 1 : MIN_THREADS / TPF;  // frames per block
  static constexpr int THREADS = TPF * FPB;
  static constexpr int R1 = LOGH % 2 ? 2 : 4;   // radix of the first stage
  static constexpr int STAGES4 = (LOGH - (R1 == 2 ? 1 : 2)) / 2;  // radix-4 stages after it
  static constexpr int PW = H + 1;              // power row: bins 0..H
  static constexpr size_t SMEM = FPB * (sizeof(float2) * H + sizeof(float) * PW);
};

template <int LOGN, bool VEC>
__global__ void __launch_bounds__(Shape<LOGN>::THREADS)
logmel_fft_kernel(const float* __restrict__ src,      // frame t at src[t * stride]
                  long long stride, int n_frames,
                  const float* __restrict__ window,   // (N) Hann
                  const float2* __restrict__ tw,      // (H) e^{-2 pi i m / H}
                  const float2* __restrict__ utw,     // (H + 1) e^{-2 pi i k / N}
                  const int* __restrict__ mel_first,  // (n_mels) first bin of each band
                  const int* __restrict__ mel_ptr,    // (n_mels + 1) CSR row pointers
                  const float* __restrict__ mel_w,    // (nnz) weights in bin order
                  int n_mels, int use_floor, float floor_v,
                  float* __restrict__ out) {          // (n_frames, n_mels)
  using S = Shape<LOGN>;
  constexpr int H = S::H, TPF = S::TPF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* const zall = reinterpret_cast<float2*>(smem_raw);
  float* const pall = reinterpret_cast<float*>(zall + S::FPB * H);

  const int lt = threadIdx.x % TPF;     // thread within its frame
  const int f = threadIdx.x / TPF;      // frame within the block
  const int t0 = blockIdx.x * S::FPB;
  const int t = t0 + f;
  float2* const z = zall + f * H;
  float2 v[POINTS];

  // Stage 1 (Ns = 1, no twiddles) straight from device memory: butterfly q
  // of this thread is j = lt * BPT + q, its input r the point j + r * H / R.
  {
    constexpr int R = S::R1, BPT = POINTS / R;
    if (t < n_frames) {
      const float* fr = src + (size_t)t * (size_t)stride;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n0 = lt * BPT + r * (H / R);   // even: 2 * n0 is 16-byte aligned
        if (VEC) {
#pragma unroll
          for (int c = 0; c < BPT / 2; ++c) {
            const float4 x = *reinterpret_cast<const float4*>(fr + 2 * n0 + 4 * c);
            const float4 w = *reinterpret_cast<const float4*>(window + 2 * n0 + 4 * c);
            v[(2 * c) * R + r] = make_float2(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y));
            v[(2 * c + 1) * R + r] = make_float2(__fmul_rn(x.z, w.z), __fmul_rn(x.w, w.w));
          }
        } else {
#pragma unroll
          for (int q = 0; q < BPT; ++q) {
            const int k = 2 * (n0 + q);
            v[q * R + r] = make_float2(__fmul_rn(fr[k], window[k]),
                                       __fmul_rn(fr[k + 1], window[k + 1]));
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < POINTS; ++i) v[i] = make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int q = 0; q < BPT; ++q) {
      butterfly<R>(v + q * R, nullptr);
      const int j = lt * BPT + q;
#pragma unroll
      for (int r = 0; r < R; ++r) z[j * R + r] = v[q * R + r];
    }
  }
  __syncthreads();

  // Radix-4 Stockham stages, Ns = R1, 4 R1, ..., H / 4: butterfly q of this
  // thread is j = lt + q * TPF; its inputs j + r * H / 4, twiddled by
  // e^{-2 pi i (j % Ns) r / (4 Ns)}, its outputs to (j - j % Ns) * 4 + j % Ns
  // + r * Ns. All reads land in registers before the barrier, then all
  // writes: one buffer.
#pragma unroll
  for (int s = 0; s < S::STAGES4; ++s) {
    const int ns = S::R1 << (2 * s);
    const int step = H / (4 * ns);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = lt + q * TPF;
#pragma unroll
      for (int r = 0; r < 4; ++r) v[q * 4 + r] = z[j + r * (H / 4)];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = lt + q * TPF;
      const int k = j & (ns - 1);
#pragma unroll
      for (int r = 1; r < 4; ++r) v[q * 4 + r] = cmul(v[q * 4 + r], tw[k * r * step]);
      butterfly<4>(v + q * 4, nullptr);
      const int d = (j - k) * 4 + k;
#pragma unroll
      for (int r = 0; r < 4; ++r) z[d + r * ns] = v[q * 4 + r];
    }
    __syncthreads();
  }

  // Untangle the packed FFT into the power of bins 0..H.
  float* const p = pall + f * S::PW;
#pragma unroll
  for (int i = 0; i < POINTS; ++i) {
    const int k = lt + i * TPF;
    p[k] = bin_power(z[k], z[(H - k) & (H - 1)], utw[k]);
  }
  if (lt == 0) p[H] = bin_power(z[0], z[0], utw[H]);
  __syncthreads();

  // Sparse mel: one thread per (frame, band), its bins in order; floor, log.
  for (int c = threadIdx.x; c < S::FPB * n_mels; c += S::THREADS) {
    const int ff = c / n_mels, m = c - ff * n_mels;
    if (t0 + ff >= n_frames) break;
    const float* pp = pall + ff * S::PW + mel_first[m];
    const int b = mel_ptr[m], e = mel_ptr[m + 1];
    float acc = 0.0f;
    for (int i = b; i < e; ++i) acc = __fadd_rn(acc, __fmul_rn(mel_w[i], pp[i - b]));
    out[(size_t)(t0 + ff) * n_mels + m] = logf(use_floor ? fmaxf(acc, floor_v) : acc);
  }
}

// Host side: the dynamic shared memory attribute of an instantiation is set
// once per device (bit d of `done`), not on every launch.
template <int LOGN, bool VEC>
cudaError_t opt_in_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(logmel_fft_kernel<LOGN, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Shape<LOGN>::SMEM);
    if (err != cudaSuccess) return err;
    done.fetch_or(bit);
  }
  return cudaSuccess;
}

// Pick the load width from the pointers and the stride, launch.
template <int LOGN>
int launch(const float* src, long long stride, int n_frames, const float* window,
           const float2* tw, const float2* utw, const int* mel_first, const int* mel_ptr,
           const float* mel_w, int n_mels, int use_floor, float floor_v, float* out,
           cudaStream_t s) {
  using S = Shape<LOGN>;
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(window) % 16 == 0 && stride % 4 == 0;
  const cudaError_t err = vec ? opt_in_smem<LOGN, true>() : opt_in_smem<LOGN, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_frames + S::FPB - 1) / S::FPB;
  if (vec) {
    logmel_fft_kernel<LOGN, true><<<blocks, S::THREADS, S::SMEM, s>>>(
        src, stride, n_frames, window, tw, utw, mel_first, mel_ptr, mel_w, n_mels, use_floor,
        floor_v, out);
  } else {
    logmel_fft_kernel<LOGN, false><<<blocks, S::THREADS, S::SMEM, s>>>(
        src, stride, n_frames, window, tw, utw, mel_first, mel_ptr, mel_w, n_mels, use_floor,
        floor_v, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* logmel_fft_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int logmel_fft_min_log_n() { return MIN_LOG_N; }
int logmel_fft_max_log_n() { return MAX_LOG_N; }

// Frame t (t < n_frames) is the n_fft = 2^log_n samples at src[t * stride];
// window (n_fft); tw (n_fft / 2) and utw (n_fft / 2 + 1) complex float32
// pairs; the mel filterbank as CSR rows of contiguous bins: band m covers
// bins mel_first[m] .. mel_first[m] + mel_ptr[m + 1] - mel_ptr[m] - 1 with
// weights mel_w[mel_ptr[m] ..]; out (n_frames, n_mels).
int logmel_fft(const float* src, long long stride, int n_frames, int log_n,
               const float* window, const void* tw, const void* utw,
               const int* mel_first, const int* mel_ptr, const float* mel_w,
               int n_mels, int use_floor, float floor_v, float* out, void* stream) {
  if (n_frames <= 0 || stride <= 0 || n_mels <= 0 || src == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* t2 = static_cast<const float2*>(tw);
  const float2* u2 = static_cast<const float2*>(utw);
#define LOGMEL_FFT_CASE(L)                                                              \
  case L:                                                                               \
    return launch<L>(src, stride, n_frames, window, t2, u2, mel_first, mel_ptr, mel_w, \
                     n_mels, use_floor, floor_v, out, s);
  switch (log_n) {
    LOGMEL_FFT_CASE(8)
    LOGMEL_FFT_CASE(9)
    LOGMEL_FFT_CASE(10)
    LOGMEL_FFT_CASE(11)
    LOGMEL_FFT_CASE(12)
    LOGMEL_FFT_CASE(13)
    LOGMEL_FFT_CASE(14)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LOGMEL_FFT_CASE
}

}  // extern "C"
