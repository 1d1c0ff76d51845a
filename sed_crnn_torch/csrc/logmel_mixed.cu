// Log-mel by a mixed-radix FFT in shared memory, for Hopper (sm_90a), at
// every n_fft that csrc/logmel_fft.cu (powers of two 256 .. 16384) does not
// take, up to the shared-memory limit below: windowed frame -> DFT -> power
// -> sparse mel -> floor -> log, in one pass over the waveform, with no
// spectral intermediate in device memory.
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

namespace {

constexpr int MAX_STAGES = 16;
constexpr int MAX_THREADS = 1024;
constexpr int MIN_THREADS = 256;        // frames a block grow to this many threads
constexpr int POINTS = 8;               // transform points a thread owns per frame
constexpr int MAX_SMEM = 232448;        // 227 KB, the opt-in limit of a block

struct Plan {
  int n;                  // transform length N: L (direct) or M (Bluestein)
  int points;             // L
  int n_bins;             // n_fft / 2 + 1
  int n_stages;
  int radix[MAX_STAGES];  // DIF order; their product is N
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y)),
                     __fadd_rn(__fmul_rn(a.x, w.y), __fmul_rn(a.y, w.x)));
}

__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }

// In-place R-point forward DFT (e^{-2 pi i / R}) of v[0..R-1]; c[q] =
// e^{-2 pi i q / R} from the twiddle table (odd R only).
template <int R>
__device__ __forceinline__ void butterfly(float2* v, const float2* c) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = csub(v[1], v[3]);
    v[0] = cadd(t0, t2);
    v[2] = csub(t0, t2);
    v[1] = make_float2(__fadd_rn(t1.x, t3.y), __fsub_rn(t1.y, t3.x));   // t1 - i t3
    v[3] = make_float2(__fsub_rn(t1.x, t3.y), __fadd_rn(t1.y, t3.x));   // t1 + i t3
  } else {
    // Odd R, pairs r and R - r: a_r = v_r + v_{R-r}, b_r = v_r - v_{R-r};
    // V_s = P_s - i Q_s and V_{R-s} = P_s + i Q_s with P_s = v_0 + sum_r
    // cos(2 pi rs / R) a_r and Q_s = sum_r sin(2 pi rs / R) b_r.
    constexpr int H = (R - 1) / 2;
    float2 a[H + 1], b[H + 1], out[R];
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      a[r] = cadd(v[r], v[R - r]);
      b[r] = csub(v[r], v[R - r]);
    }
    out[0] = v[0];
#pragma unroll
    for (int r = 1; r <= H; ++r) out[0] = cadd(out[0], a[r]);
#pragma unroll
    for (int s = 1; s <= H; ++s) {
      float2 p = v[0], q = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const float cs = c[(r * s) % R].x, sn = -c[(r * s) % R].y;
        p = make_float2(__fadd_rn(p.x, __fmul_rn(cs, a[r].x)),
                        __fadd_rn(p.y, __fmul_rn(cs, a[r].y)));
        const float2 t = make_float2(__fmul_rn(sn, b[r].x), __fmul_rn(sn, b[r].y));
        q = r == 1 ? t : cadd(q, t);
      }
      out[s] = make_float2(__fadd_rn(p.x, q.y), __fsub_rn(p.y, q.x));
      out[R - s] = make_float2(__fsub_rn(p.x, q.y), __fadd_rn(p.y, q.x));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = out[r];
  }
}

// One radix-R stage on sub-transforms of length ls (m = ls / R) of the
// N-point array z, in place: butterfly b is sub-transform g = b / m, offset
// j = b % m, its points z[g ls + j + r m]. DIF (TRANSPOSED = false):
// butterfly, then output s times e^{-2 pi i j s / ls}. Transposed: input r
// times e^{-2 pi i j r / ls}, then butterfly. The last DIF stage (m = 1) has
// only unit twiddles and skips them.
template <int R, bool TRANSPOSED>
__device__ __forceinline__ void stage(float2* z, int N, int ls, int lt, int tpf,
                                      const float2* __restrict__ tw) {
  const int m = ls / R;
  const int step = N / ls;
  float2 c[R];
  if constexpr (R % 2 == 1) {
#pragma unroll
    for (int q = 0; q < R; ++q) c[q] = __ldg(tw + q * (N / R));
  }
  for (int b = lt; b < N / R; b += tpf) {
    const int g = b / m, j = b - g * m;
    float2* const base = z + g * ls + j;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = base[r * m];
    if (TRANSPOSED && m > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + j * r * step));
    }
    butterfly<R>(v, c);
    if (!TRANSPOSED && m > 1) {
#pragma unroll
      for (int s = 1; s < R; ++s) v[s] = cmul(v[s], __ldg(tw + j * s * step));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) base[r * m] = v[r];
  }
}

template <bool TRANSPOSED>
__device__ __forceinline__ void run_stage(int radix, float2* z, int N, int ls, int lt, int tpf,
                                          const float2* __restrict__ tw) {
  switch (radix) {
    case 2: stage<2, TRANSPOSED>(z, N, ls, lt, tpf, tw); break;
    case 3: stage<3, TRANSPOSED>(z, N, ls, lt, tpf, tw); break;
    case 4: stage<4, TRANSPOSED>(z, N, ls, lt, tpf, tw); break;
    case 5: stage<5, TRANSPOSED>(z, N, ls, lt, tpf, tw); break;
    default: stage<7, TRANSPOSED>(z, N, ls, lt, tpf, tw); break;
  }
}

// |X_k|^2 from Z_k = a and Z_{L-k} = b of the packed FFT, with
// w = e^{-2 pi i k / n_fft}: E = (a + conj b) / 2, O = (a - conj b) / 2i,
// X_k = E + w O.
__device__ __forceinline__ float bin_power(float2 a, float2 b, float2 w) {
  const float er = __fmul_rn(0.5f, __fadd_rn(a.x, b.x));
  const float ei = __fmul_rn(0.5f, __fsub_rn(a.y, b.y));
  const float o_r = __fmul_rn(0.5f, __fadd_rn(a.y, b.y));
  const float o_i = __fmul_rn(0.5f, __fsub_rn(b.x, a.x));
  const float xr = __fadd_rn(er, __fsub_rn(__fmul_rn(w.x, o_r), __fmul_rn(w.y, o_i)));
  const float xi = __fadd_rn(ei, __fadd_rn(__fmul_rn(w.x, o_i), __fmul_rn(w.y, o_r)));
  return __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi));
}

// Z_k of the L-point transform from the work array: at pos[k] (direct), or
// w_k conj(D_k) (Bluestein).
template <bool BLUE>
__device__ __forceinline__ float2 spectrum(const float2* z, int k, const int* __restrict__ pos,
                                           const float2* __restrict__ chirp) {
  if (BLUE) return cmul(cconj(z[k]), __ldg(chirp + k));
  return z[__ldg(pos + k)];
}

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
  for (int n = lt; n < N; n += tpf) {
    float2 v = make_float2(0.0f, 0.0f);
    if (live && n < L) {
      if (even) {
        v = make_float2(__fmul_rn(fr[2 * n], __ldg(window + 2 * n)),
                        __fmul_rn(fr[2 * n + 1], __ldg(window + 2 * n + 1)));
      } else {
        v = make_float2(__fmul_rn(fr[n], __ldg(window + n)), 0.0f);
      }
      if (BLUE) v = cmul(v, __ldg(chirp + n));
    }
    z[n] = v;
  }
  __syncthreads();

  int ls = N;
  for (int s = 0; s < plan.n_stages; ++s) {
    run_stage<false>(plan.radix[s], z, N, ls, lt, tpf, tw);
    ls /= plan.radix[s];
    __syncthreads();
  }

  if (BLUE) {
    // Pointwise product with the filter spectrum, conjugated, then the
    // transposed stages in reverse order: D = FFT(conj(A B)) in natural order.
    for (int p = lt; p < N; p += tpf) z[p] = cconj(cmul(z[p], __ldg(bspec + p)));
    __syncthreads();
    ls = 1;
    for (int s = plan.n_stages - 1; s >= 0; --s) {
      ls *= plan.radix[s];
      run_stage<true>(plan.radix[s], z, N, ls, lt, tpf, tw);
      __syncthreads();
    }
  }

  // Power of bins 0..NB-1: the real-to-complex untangle (even n_fft), or
  // |Z_k|^2 (odd).
  float* const p = pall + (size_t)f * NB;
  for (int k = lt; k < NB; k += tpf) {
    if (even) {
      const float2 a = spectrum<BLUE>(z, k == L ? 0 : k, pos, chirp);
      const float2 b = spectrum<BLUE>(z, k == 0 ? 0 : L - k, pos, chirp);
      p[k] = bin_power(a, b, __ldg(utw + k));
    } else {
      const float2 a = spectrum<BLUE>(z, k, pos, chirp);
      p[k] = __fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y));
    }
  }
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
