// Fused log-mel for Hopper (sm_90a): windowed real DFT -> power -> mel ->
// floor -> log, with no spectral intermediate in device memory.
//
// One body, two formulations, replaces the three TPU kernels of
// sed_crnn_tpu/ops/pallas/fused_logmel.py:
//
// * DIF (template DIRECT = false) replaces `_kernel_dif_chunked` (launched by
//   `_fused_dif_chunked`) and `_kernel_dif` (launched by `_fused_dif`). A
//   radix-2 decimation in frequency of the n_fft = 2M point real DFT: frame
//   t's two halves a, b are read at y[t*stride + k] and y[t*stride + M + k];
//   with the Hann window split into halves wa, wb,
//       s = wa*a + wb*b  -> even bins X[2f]   = DFT_M(s)[f],       f <= M/2
//       d = wa*a - wb*b  -> odd bins  X[2f+1] = shifted DFT_M(d)[f], f < M/2
//   so both halves are real products against (M x bins) cos / -sin bases,
//   and the even/odd split folds into the rows of the mel matrix. The frame
//   stride picks the frame source: stride = M is the TPU's chunked path
//   (hop == n_fft / 2, frame t is hop rows t and t+1), stride = hop any
//   other hop on the padded waveform, stride = n_fft a materialized
//   (n_frames, n_fft) frame matrix. No frame matrix is ever built for a
//   waveform.
// * direct (DIRECT = true) replaces `_kernel_exact` (launched by
//   `_fused_exact`: mode "exact", and any n_fft % 4 != 0): the A tile is the
//   raw frame sample y[t*stride + k], k < n_fft, against the window-folded
//   cos / -sin bases of the full n_fft-point DFT; no even/odd split.
//
// The TPU kernels ran their products as bf16x3 (DIF) or six-pass f32 dots
// (exact) because that matrix unit had no float32 path; here every product is
// a float32 FMA (no TF32, no bf16).
//
// What bounds it: operations. The DIF formulation does 2 * M * 2 * (M + 1)
// FLOPs per frame (about 4.2 MFLOP at n_fft 2048), the direct one twice that,
// against a few KB of waveform per frame, far above the card's float32 ratio
// of FLOPs to bytes. The function itself needs some 30x fewer: a real FFT
// (2.5 N log2 N), the power and the mel product come to about 0.14 MFLOP per
// frame at n_fft 2048, so the DFT-as-products formulation, not the card, sets
// this kernel's floor; an FFT in shared memory is the way below it. The bases
// (two K x bins float32 arrays: 8.9 MB for DIF at n_fft 2048, 34.6 MB at
// 4096) do not fit in shared memory; they are read from device memory, where
// they stay in the 50 MB L2, in tiles of KT rows x TB bins. Design: a block
// owns TF frames and a group of bin tiles; for each bin tile it runs a
// shared-memory tiled product (each thread 4 frames x 4 bins, real and
// imaginary parts), squares into a power tile in shared memory, and
// multiplies that by the tile's mel rows into a (TF x n_mels) accumulator in
// shared memory. When the bin tiles are split over several groups (to give
// short signals enough blocks to fill the card), each group writes its
// partial mel sums and a second small kernel adds them in fixed group order,
// so the result does not depend on the schedule, then applies the floor and
// the log. The log is logf, exact enough that log(0) stays -inf as in the
// reference. Frame samples are read with scalar loads indexed in size_t: a
// hop that is not a multiple of 4 (517) leaves no aligned vector load.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TF = 64;       // frames per block
constexpr int TB = 64;       // bins per tile
constexpr int KT = 16;       // reduction rows per step
constexpr int THREADS = 256; // 16 x 16, each thread 4 frames x 4 bins
constexpr int SA_LD = TF + 1;
constexpr int SP_LD = TB + 1;

__device__ __forceinline__ float finish(float mel, int use_floor, float floor_v) {
  return logf(use_floor ? fmaxf(mel, floor_v) : mel);
}

template <bool DIRECT>
__global__ void __launch_bounds__(THREADS)
logmel_kernel(const float* __restrict__ y,      // frame t starts at y[t * stride]
              const float* __restrict__ wa,     // (K), DIF only
              const float* __restrict__ wb,     // (K), DIF only
              const float* __restrict__ bc,     // (K, NB) cos basis
              const float* __restrict__ bs,     // (K, NB) -sin basis
              const float* __restrict__ melw,   // (NB, n_mels)
              float* __restrict__ partial,      // (G, n_frames, n_mels)
              float* __restrict__ out,          // (n_frames, n_mels)
              int n_frames, int K, long long stride, int NB, int n_even_tiles,
              int n_mels, int tiles_per_group, int use_floor, float floor_v) {
  extern __shared__ float smem[];
  float* sA = smem;                     // (KT, SA_LD) s or d, k-major
  float* sC = sA + KT * SA_LD;          // (KT, TB)
  float* sS = sC + KT * TB;             // (KT, TB)
  float* sP = sS + KT * TB;             // (TF, SP_LD) power
  float* sM = sP + TF * SP_LD;          // (TB, n_mels) mel rows of the tile
  float* sAcc = sM + TB * n_mels;       // (TF, n_mels) mel accumulator

  const int tid = threadIdx.x;
  const int tx = tid % 16;              // bin lane
  const int ty = tid / 16;              // frame lane
  const int t0 = blockIdx.x * TF;
  const int g = blockIdx.y;
  const int n_bin_tiles = NB / TB;
  const int bt_begin = g * tiles_per_group;
  int bt_end = bt_begin + tiles_per_group;
  if (bt_end > n_bin_tiles) bt_end = n_bin_tiles;

  for (int i = tid; i < TF * n_mels; i += THREADS) sAcc[i] = 0.0f;

  for (int bt = bt_begin; bt < bt_end; ++bt) {
    const bool even = DIRECT || bt < n_even_tiles;
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) re[i][q] = im[i][q] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += KT) {
      // A tile for TF frames x KT samples: the raw samples (direct), or s or
      // d windowed on the fly (DIF).
#pragma unroll
      for (int q = 0; q < (TF * KT) / THREADS; ++q) {
        const int idx = tid + q * THREADS;
        const int f = idx / KT, kk = idx % KT;
        const int t = t0 + f, k = k0 + kk;
        float v = 0.0f;
        if (t < n_frames && k < K) {
          const float* fr = y + (size_t)t * (size_t)stride;
          if (DIRECT) {
            v = fr[k];
          } else {
            const float ya = wa[k] * fr[k];
            const float yb = wb[k] * fr[(size_t)K + k];
            v = even ? ya + yb : ya - yb;
          }
        }
        sA[kk * SA_LD + f] = v;
      }
      // Basis tiles: KT rows x TB bins of cos and -sin.
#pragma unroll
      for (int q = 0; q < (KT * TB) / THREADS; ++q) {
        const int idx = tid + q * THREADS;
        const int kk = idx / TB, c = idx % TB;
        const int k = k0 + kk;
        const size_t o = (size_t)k * NB + (size_t)bt * TB + c;
        sC[kk * TB + c] = k < K ? bc[o] : 0.0f;
        sS[kk * TB + c] = k < K ? bs[o] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        float a[4], c[4], s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sA[kk * SA_LD + ty + 16 * i];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          c[q] = sC[kk * TB + tx + 16 * q];
          s[q] = sS[kk * TB + tx + 16 * q];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            re[i][q] = fmaf(a[i], c[q], re[i][q]);
            im[i][q] = fmaf(a[i], s[q], im[i][q]);
          }
      }
      __syncthreads();
    }

    // Power tile and this tile's mel rows into shared memory.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sP[(ty + 16 * i) * SP_LD + tx + 16 * q] =
            re[i][q] * re[i][q] + im[i][q] * im[i][q];
    const float* mrows = melw + (size_t)bt * TB * n_mels;
    for (int i = tid; i < TB * n_mels; i += THREADS) sM[i] = mrows[i];
    __syncthreads();
    // Accumulate power @ mel rows; each thread owns fixed accumulator cells.
    for (int i = tid; i < TF * n_mels; i += THREADS) {
      const int f = i / n_mels, m = i % n_mels;
      float acc = 0.0f;
      for (int c = 0; c < TB; ++c) acc = fmaf(sP[f * SP_LD + c], sM[c * n_mels + m], acc);
      sAcc[i] += acc;
    }
    __syncthreads();
  }

  const int n_groups = gridDim.y;
  for (int i = tid; i < TF * n_mels; i += THREADS) {
    const int t = t0 + i / n_mels;
    if (t >= n_frames) continue;
    const size_t o = (size_t)t * n_mels + i % n_mels;
    if (n_groups == 1) {
      out[o] = finish(sAcc[i], use_floor, floor_v);
    } else {
      partial[(size_t)g * n_frames * n_mels + o] = sAcc[i];
    }
  }
}

__global__ void logmel_finalize_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int n, int G,
                                       int use_floor, float floor_v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int g = 0; g < G; ++g) acc += partial[(size_t)g * n + i];
  out[i] = finish(acc, use_floor, floor_v);
}

template <bool DIRECT>
int launch(const float* y, const float* wa, const float* wb, const float* bc,
           const float* bs, const float* melw, float* partial, float* out,
           int n_frames, int K, long long stride, int NB, int n_even_tiles,
           int n_mels, int n_groups, int use_floor, float floor_v,
           cudaStream_t s) {
  const int n_bin_tiles = NB / TB;
  const int tiles_per_group = (n_bin_tiles + n_groups - 1) / n_groups;
  const int G = (n_bin_tiles + tiles_per_group - 1) / tiles_per_group;
  if (G != n_groups) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) *
      ((size_t)KT * SA_LD + 2 * KT * TB + TF * SP_LD + (size_t)TB * n_mels +
       (size_t)TF * n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<DIRECT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + TF - 1) / TF, G);
  logmel_kernel<DIRECT><<<grid, THREADS, smem, s>>>(
      y, wa, wb, bc, bs, melw, partial, out, n_frames, K, stride, NB,
      n_even_tiles, n_mels, tiles_per_group, use_floor, floor_v);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return static_cast<int>(err);
  const int n = n_frames * n_mels;
  logmel_finalize_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, out, n, G,
                                                          use_floor, floor_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fused_logmel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int fused_logmel_tile_bins() { return TB; }

// Frame t (t < n_frames) starts at y[t * stride]; it reads K samples there
// (direct) or K samples there and K more at y[t * stride + K] (DIF, K = M =
// n_fft / 2), so y holds at least (n_frames - 1) * stride + n_fft samples.
// wa, wb (K), DIF only (direct: may be null); bc, bs (K, NB) with NB a
// multiple of TB, for DIF the first n_even_tiles * TB columns the even-bin
// basis (direct: every column is a bin of the full DFT); melw (NB, n_mels);
// partial (G, n_frames, n_mels) scratch, unused when G == 1; out (n_frames,
// n_mels).
int fused_logmel(const float* y, const float* wa, const float* wb,
                 const float* bc, const float* bs, const float* melw,
                 float* partial, float* out, int n_frames, int K,
                 long long stride, int NB, int n_even_tiles, int n_mels,
                 int n_groups, int direct, int use_floor, float floor_v,
                 void* stream) {
  if (n_frames <= 0 || K <= 0 || stride <= 0 || NB <= 0 || NB % TB != 0 ||
      n_mels <= 0 || n_groups <= 0 || n_even_tiles < 0 || n_even_tiles > NB / TB ||
      (!direct && (wa == nullptr || wb == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (direct)
    return launch<true>(y, wa, wb, bc, bs, melw, partial, out, n_frames, K,
                        stride, NB, n_even_tiles, n_mels, n_groups, use_floor,
                        floor_v, s);
  return launch<false>(y, wa, wb, bc, bs, melw, partial, out, n_frames, K,
                       stride, NB, n_even_tiles, n_mels, n_groups, use_floor,
                       floor_v, s);
}

}  // extern "C"
