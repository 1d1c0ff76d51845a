// Log-mel by a mixed-radix FFT in shared memory, for Hopper (sm_90a), at
// every n_fft that csrc/logmel_fft.cu (powers of two 256 .. 16384) does not
// take, up to the shared-memory limit below (csrc/logmel_cluster.cu splits a
// frame over a thread-block cluster beyond it): windowed frame -> DFT ->
// power -> sparse mel -> floor -> log, in one pass over the waveform, with
// no spectral intermediate in device memory. The arithmetic lives in
// csrc/logmel_stages.cuh, shared with the cluster body.
//
// Replaces, at those sizes, the three TPU kernels of
// sed_crnn_tpu/ops/pallas/fused_logmel.py: `_kernel_dif_chunked` (hop ==
// n_fft / 2), `_kernel_dif` (any hop, or a frame matrix) and `_kernel_exact`
// (mode "exact", any n_fft % 4 != 0). All three compute the same function;
// the frame stride picks the source: n_fft / 2 for the chunked route, the
// hop on the padded waveform, n_fft on a frame matrix.
//
// The plan is runtime data, built on the host (ops/kernels/fused_logmel.py
// `mixed_plan`): an even n_fft is packed as L = n_fft / 2 complex points
// z[n] = x[2n] + i x[2n+1] and untangled into bins 0..L at the end; an odd
// n_fft is transformed as L = n_fft points with a zero imaginary part, bins
// 0..(n_fft-1)/2 kept. The L-point DFT is either
//
// * direct, when L is 7-smooth: N = L, in-place decimation-in-frequency
//   stages of radix 4, 2, 3, 5 and 7, which leave X_k at position pos[k]
//   (a table from the host); or
// * Bluestein, otherwise: the chirp w_n = e^{-i pi (n^2 mod 2L) / L}, a_n =
//   z_n w_n zero-padded to N = M, the smallest 7-smooth length >= 2L - 1;
//   the same DIF stages on a (output at permuted positions), a pointwise
//   product with the filter spectrum B stored at those positions (1/M folded
//   in on the host), the conjugate, and the transposed stages run in reverse
//   order (twiddle, then butterfly), which take permuted input to natural
//   output: the inverse FFT as conj(FFT(conj(.))); X_k = w_k conj(D_k).
//
// What bounds it on an H100: as for the power-of-two body, the least work
// per frame is an FFT of n_fft points, the power and the sparse mel product,
// against 4 * hop bytes of new waveform per frame: device-memory bytes at
// the sizes users run (n_fft 400-3072). Bluestein costs two M-point FFTs a
// frame (M ~ 2L), about 4x a direct transform. The design keeps every
// intermediate on chip: a frame is read once (scalar loads at src[t *
// stride + k], size_t index, the Hann window applied on load; a hop such as
// 517 rules out wider loads), the transform runs in place in shared memory
// (8 N bytes a frame) with each butterfly in registers, so a thread holds at
// most 7 points whatever N is and a block needs no second buffer; a stage's
// radix is uniform across the block, so its `switch` does not diverge. Then
// |X_k|^2 goes to a power row in shared memory and one thread sums each
// (frame, mel) cell over its band's contiguous bins in bin order, applies
// the floor and logf and stores coalesced. A block owns its frames whole: no
// partial sums, no atomics, no second pass. Every product and sum is an
// explicitly rounded float32 operation (no FMA contraction), and the radix
// constants, stage twiddles, chirp, B and untangle twiddles all come from
// tables computed in float64 and rounded once to float32 on the host, so the
// result is bitwise the same from run to run and `mixed_log_mel_plain`
// repeats it. Shared memory: frames a block x (8 N + 4 (n_fft / 2 + 1))
// bytes, at most 227 KB (232,448 bytes), opted in once per instantiation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "logmel_stages.cuh"

namespace {

using logmel::MAX_STAGES;
using logmel::Plan;

constexpr int MAX_THREADS = 1024;
constexpr int MIN_THREADS = 256;        // frames a block grow to this many threads
constexpr int POINTS = 8;               // transform points a thread owns per frame
constexpr int MAX_SMEM = 232448;        // 227 KB, the opt-in limit of a block

template <bool BLUE>
__global__ void __launch_bounds__(MAX_THREADS)
logmel_mixed_kernel(const float* __restrict__ src,      // frame t at src[t * stride]
                    long long stride, int n_frames, int n_fft, Plan plan, int tpf, int fpb,
                    const float* __restrict__ window,   // (n_fft) Hann
                    const float2* __restrict__ tw,      // (N) e^{-2 pi i m / N}
                    const int* __restrict__ pos,        // (L) direct: position of X_k
                    const float2* __restrict__ chirp,   // (L) Bluestein: w_n
                    const float2* __restrict__ bspec,   // (M) Bluestein: B / M at DIF positions
                    const float2* __restrict__ utw,     // (L + 1) even n_fft: e^{-2 pi i k / n_fft}
                    const int* __restrict__ mel_first,  // (n_mels) first bin of each band
                    const int* __restrict__ mel_ptr,    // (n_mels + 1) CSR row pointers
                    const float* __restrict__ mel_w,    // (nnz) weights in bin order
                    int n_mels, int use_floor, float floor_v,
                    float* __restrict__ out) {          // (n_frames, n_mels)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = plan.n, L = plan.points, NB = plan.n_bins;
  float2* const zall = reinterpret_cast<float2*>(smem_raw);
  float* const pall = reinterpret_cast<float*>(zall + (size_t)fpb * N);
  const bool even = (n_fft & 1) == 0;

  const int lt = threadIdx.x % tpf;     // thread within its frame
  const int f = threadIdx.x / tpf;      // frame within the block
  const int t0 = blockIdx.x * fpb;
  const bool live = t0 + f < n_frames;
  float2* const z = zall + (size_t)f * N;

  // Load: window, pack (even) or zero imaginary part (odd), chirp
  // (Bluestein), zeros past L. A frame past the end computes on zeros.
  const float* fr = src + (size_t)(live ? t0 + f : 0) * (size_t)stride;
  for (int n = lt; n < N; n += tpf)
    z[n] = live ? logmel::load_point<BLUE>(fr, n, L, even, window, chirp)
                : make_float2(0.0f, 0.0f);
  __syncthreads();

  int ls = N;
  for (int s = 0; s < plan.n_stages; ++s) {
    logmel::run_block_stage<false>(plan.radix[s], z, N, ls, lt, tpf, tw);
    ls /= plan.radix[s];
    __syncthreads();
  }

  if (BLUE) {
    // Pointwise product with the filter spectrum, conjugated, then the
    // transposed stages in reverse order: D = FFT(conj(A B)) in natural order.
    for (int p = lt; p < N; p += tpf) z[p] = logmel::cconj(logmel::cmul(z[p], __ldg(bspec + p)));
    __syncthreads();
    ls = 1;
    for (int s = plan.n_stages - 1; s >= 0; --s) {
      ls *= plan.radix[s];
      logmel::run_block_stage<true>(plan.radix[s], z, N, ls, lt, tpf, tw);
      __syncthreads();
    }
  }

  // Power of bins 0..NB-1: the real-to-complex untangle (even n_fft), or
  // |Z_k|^2 (odd).
  float* const p = pall + (size_t)f * NB;
  for (int k = lt; k < NB; k += tpf)
    p[k] = logmel::power<BLUE>(z, k, L, even, pos, chirp, utw);
  __syncthreads();

  // Sparse mel: one thread per (frame, band), its bins in order; floor, log.
  for (int c = threadIdx.x; c < fpb * n_mels; c += blockDim.x) {
    const int ff = c / n_mels, m = c - ff * n_mels;
    if (t0 + ff >= n_frames) break;
    const float* pp = pall + (size_t)ff * NB + mel_first[m];
    const int b = mel_ptr[m], e = mel_ptr[m + 1];
    float acc = 0.0f;
    for (int i = b; i < e; ++i) acc = __fadd_rn(acc, __fmul_rn(mel_w[i], pp[i - b]));
    out[(size_t)(t0 + ff) * n_mels + m] = logf(use_floor ? fmaxf(acc, floor_v) : acc);
  }
}

// Threads per frame: POINTS transform points a thread, whole warps, at most
// MAX_THREADS; frames a block: up to MIN_THREADS threads, within MAX_SMEM.
int threads_per_frame(int n) {
  int t = (n + POINTS - 1) / POINTS;
  t = (t + 31) / 32 * 32;
  return t > MAX_THREADS ? MAX_THREADS : t;
}

size_t frame_smem(const Plan& plan) {
  return sizeof(float2) * (size_t)plan.n + sizeof(float) * (size_t)plan.n_bins;
}

// Host side: the dynamic shared memory attribute is set once per
// instantiation and device (bit d of `done`), then the launch.
template <bool BLUE>
int launch(const float* src, long long stride, int n_frames, int n_fft, const Plan& plan,
           const float* window, const float2* tw, const int* pos, const float2* chirp,
           const float2* bspec, const float2* utw, const int* mel_first, const int* mel_ptr,
           const float* mel_w, int n_mels, int use_floor, float floor_v, float* out,
           cudaStream_t s) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(logmel_mixed_kernel<BLUE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    done.fetch_or(bit);
  }
  const int tpf = threads_per_frame(plan.n);
  const size_t per_frame = frame_smem(plan);
  int fpb = tpf >= MIN_THREADS ? 1 : MIN_THREADS / tpf;
  while (fpb > 1 && fpb * per_frame > (size_t)MAX_SMEM) --fpb;
  const size_t smem = fpb * per_frame;
  const int blocks = (n_frames + fpb - 1) / fpb;
  logmel_mixed_kernel<BLUE><<<blocks, tpf * fpb, smem, s>>>(
      src, stride, n_frames, n_fft, plan, tpf, fpb, window, tw, pos, chirp, bspec, utw,
      mel_first, mel_ptr, mel_w, n_mels, use_floor, floor_v, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* logmel_mixed_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int logmel_mixed_max_smem() { return MAX_SMEM; }
int logmel_mixed_max_stages() { return MAX_STAGES; }

// Frame t (t < n_frames) is the n_fft samples at src[t * stride]; the plan:
// transform length n (L = n_fft / 2 for an even n_fft, n_fft for an odd one;
// M >= 2L - 1 with bluestein), its DIF radices (each 2, 3, 4, 5 or 7, their
// product n); window (n_fft); tw (n) complex float32 pairs; pos (L, int32,
// direct only); chirp (L) and bspec (n) (Bluestein only); utw (L + 1, even
// n_fft only); the mel filterbank as CSR rows of contiguous bins: band m
// covers bins mel_first[m] .. mel_first[m] + mel_ptr[m + 1] - mel_ptr[m] - 1
// with weights mel_w[mel_ptr[m] ..]; out (n_frames, n_mels). Returns a
// cudaError_t: cudaErrorInvalidValue for a plan it does not take (one frame
// over 227 KB of shared memory included).
int logmel_mixed(const float* src, long long stride, int n_frames, int n_fft, int n,
                 int n_stages, const int* radices, int bluestein, const float* window,
                 const void* tw, const int* pos, const void* chirp, const void* bspec,
                 const void* utw, const int* mel_first, const int* mel_ptr, const float* mel_w,
                 int n_mels, int use_floor, float floor_v, float* out, void* stream) {
  if (n_frames <= 0 || stride <= 0 || n_mels <= 0 || n_fft <= 0 || src == nullptr ||
      out == nullptr || window == nullptr || tw == nullptr || n_stages < 0 ||
      n_stages > MAX_STAGES || (n_stages > 0 && radices == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan{};
  plan.n = n;
  plan.points = n_fft % 2 ? n_fft : n_fft / 2;
  plan.n_bins = n_fft / 2 + 1;
  plan.n_stages = n_stages;
  long long prod = 1;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radices[s];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7)
      return static_cast<int>(cudaErrorInvalidValue);
    plan.radix[s] = r;
    prod *= r;
  }
  const bool direct_ok = !bluestein && n == plan.points && pos != nullptr;
  const bool blue_ok = bluestein && n >= 2 * plan.points - 1 && chirp != nullptr &&
                       bspec != nullptr;
  if (prod != n || !(direct_ok || blue_ok) || (n_fft % 2 == 0 && utw == nullptr) ||
      frame_smem(plan) > (size_t)MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* tw2 = static_cast<const float2*>(tw);
  const float2* ch2 = static_cast<const float2*>(chirp);
  const float2* bs2 = static_cast<const float2*>(bspec);
  const float2* ut2 = static_cast<const float2*>(utw);
  if (bluestein)
    return launch<true>(src, stride, n_frames, n_fft, plan, window, tw2, pos, ch2, bs2, ut2,
                        mel_first, mel_ptr, mel_w, n_mels, use_floor, floor_v, out, s);
  return launch<false>(src, stride, n_frames, n_fft, plan, window, tw2, pos, ch2, bs2, ut2,
                       mel_first, mel_ptr, mel_w, n_mels, use_floor, floor_v, out, s);
}

}  // extern "C"
