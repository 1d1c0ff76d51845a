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
// * direct: N = L, in-place decimation-in-frequency stages of radix 4, 2,
//   3, 5, 7, 11 and 13 in registers, then a matrix stage for each prime
//   factor above 13 (up to 1,021), which leave X_k at position pos[k] (a
//   table from the host); a matrix stage runs each butterfly's DFT as two
//   real products on the tensor cores (`matrix_stage`, three TF32 mma a
//   product: near float32's precision, not its bits) and writes out of
//   place, into a second work array. Its time is latency (PERF.md §5), so
//   its warps' jobs are few and independent: a row tile and all its
//   columns up to 4 tiles (each point gathered once up to R = 63), two
//   row tiles a job at R <= 31, at 128 registers a thread; 373 runs on
//   wgmma instead (`wgmma_stage`: a warpgroup's 32 butterflies against 8
//   column tiles, the B slabs in shared memory), in instantiations of its
//   own (WG, 384 threads);
// * direct with a Rader stage last for L's largest prime p (above 13; the
//   primes above 1,021 whose p - 1 has a direct plan, and smaller ones
//   where `plan_cost` finds it cheaper than a matrix stage): each p-point
//   butterfly as a cyclic convolution of p - 1 points, two inner p - 1
//   point transforms on register and matrix stages ping-ponging between the
//   two work arrays, with a pointwise product between them (`rader_gather`,
//   `rader_product` in csrc/logmel_stages.cuh; the gather folded into the
//   load where L = p and n_fft is at most 4,096); or
// * Bluestein, where L has a prime above 1,021 whose p - 1 has one too, or
//   `plan_cost` finds it cheaper: the chirp w_n = e^{-i pi (n^2 mod 2L) / L}, a_n = z_n w_n
//   zero-padded to N = M, the smallest 7-smooth length >= 2L - 1; the same
//   DIF stages on a (output at permuted positions), a pointwise product with
//   the filter spectrum B stored at those positions (1/M folded in on the
//   host), the conjugate, and the transposed stages run in reverse order
//   (twiddle, then butterfly), which take permuted input to natural output:
//   the inverse FFT as conj(FFT(conj(.))); X_k = w_k conj(D_k).
//
// What bounds it on an H100: as for the power-of-two body, the least work
// per frame is an FFT of n_fft points, the power and the sparse mel product,
// against 4 * hop bytes of new waveform per frame: device-memory bytes at
// the sizes users run (n_fft 400-3072). Bluestein costs two M-point FFTs a
// frame (M ~ 2L) and a frame of twice the shared memory, about 4x a direct
// transform, which is why wide primes run as matrix stages (an R-point DFT
// is O(R^2) work, too wide for registers above 13, and as two (R + 1) /
// 2-square products it fits the tensor cores) and the widest as Rader
// stages: two p - 1 point transforms, O(p log p), in two work arrays of N
// points (the inner transforms use N (p - 1) / p of each, the tails hold x_0
// and X_0), so a frame of L = 3 x 4289 (n_fft 12,867) or 11,527 (23,054)
// fits one block where Bluestein's M = 25,920 / 23,328 points did not. A
// Rader stage with an inner matrix stage reads its operands twice (forward
// and transposed) and adds two passes over N' points (gather and product):
// its time is those passes and the inner matrix stages' products.
// The design keeps every intermediate on chip: a frame is read once (scalar
// loads at src[t * stride + k], size_t index, the Hann window applied on
// load; a hop such as 517 rules out wider loads), the transform runs in
// shared memory (8 N bytes a frame, twice with matrix stages) with each
// register butterfly in registers; a stage's radix is uniform across the
// block, so its `switch` does not diverge. Then |X_k|^2 goes to a power row
// in shared memory and one warp sums each (frame, mel) cell, lane l over
// the band's bins l, l + 32, ... in bin order, a fixed shuffle tree over the
// lanes (the cluster body's order), applies the floor and logf. A block owns
// its frames whole: no partial sums, no atomics, no second pass. Every
// product and sum outside the matrix stages is an explicitly rounded float32
// operation (no FMA contraction), and the radix constants, stage twiddles,
// DFT matrices, chirp, B and untangle twiddles all come from tables
// computed in float64 and rounded once on the host, so the result is
// bitwise the same from run to run, and `mixed_log_mel_plain` repeats it
// bitwise at plans without a matrix stage. Shared memory: frames a block x
// (8 N (x2 with matrix or Rader stages) + 4 (n_fft / 2 + 1)) bytes, at most
// 227 KB (232,448 bytes), opted in once per instantiation, and no static
// shared memory: a Rader stage keeps x_0 and X_0 in the tails of the two
// work arrays (N / p points each), so 12,867 takes 231,608 bytes (840 to
// spare) and 23,054 230,544 (1,904 to spare). Radices 11, 13 and the matrix
// stages run in the wide instantiations (512 threads a frame at most), the
// Rader stage in its own wide instantiation; the others keep the radix-7
// kernel's code and registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "logmel_stages.cuh"

namespace {

using logmel::MAX_STAGES;
using logmel::Plan;
using logmel::Tables;

constexpr int MAX_THREADS = 1024;
constexpr int WIDE_THREADS = 512;       // the instantiations with radices 11, 13 and matrix stages
constexpr int MIN_THREADS = 256;        // frames a block grow to this many threads
constexpr int POINTS = 8;               // transform points a thread owns per frame
// The wgmma instantiations' threads a block at most: 384, 168 registers a
// thread for the stage's 64 accumulators (at 512 threads and 128 registers
// they spilled and n_fft 141,001 ran 4 % slower on an H100, PERF.md §6).
constexpr int WG_THREADS = 384;
constexpr int MAX_SMEM = 232448;        // 227 KB, the opt-in limit of a block

// Profiling cuts, for sed_crnn_torch/tools/logmel_phases.py only (the
// results are then wrong): built with -DLOGMEL_MIXED_CUT=1 the body leaves
// out the mel sums, with 2 also the bins' power, with 3 also the matrix
// stages (a Rader stage's inner ones too), with 4 also a nested Rader stage
// (its gather, inner register stages, products and scatter), with 5 also
// the Rader stage (gather, inner register stages, product), with 6 also
// Bluestein's filter product and second transform, with 7 also the register
// stages. 0, the default, cuts nothing. (-DLOGMEL_SKIP_RADIX=R, in
// csrc/logmel_stages.cuh, leaves out the register stages of one radix.)
#ifndef LOGMEL_MIXED_CUT
#define LOGMEL_MIXED_CUT 0
#endif
constexpr int CUT = LOGMEL_MIXED_CUT;

// The mel sums of a block's frames, a group of G lanes a (frame, band)
// (`group_band_sum`), its first lane storing the log.
template <int G>
__device__ __forceinline__ void mel_phase(const float* pall, int NB, int fpb, int n_frames,
                                          int t0, const int* __restrict__ mel_first,
                                          const int* __restrict__ mel_ptr,
                                          const float* __restrict__ mel_w, int n_mels,
                                          int use_floor, float floor_v, float* __restrict__ out) {
  const int groups = blockDim.x / G, k = threadIdx.x % G;
  // Whole warps loop together (the shuffles), past the last cell if need be.
  const int cells = fpb * n_mels, rounds = (cells + groups - 1) / groups;
  for (int r = 0; r < rounds; ++r) {
    const int c = r * groups + threadIdx.x / G;
    const int ff = c / n_mels, m = c - ff * n_mels;
    const bool on = c < cells && t0 + ff < n_frames;
    const int nbins = on && CUT < 1 ? mel_ptr[m + 1] - mel_ptr[m] : 0;
    const float acc = logmel::group_band_sum<G>(mel_w + (on ? mel_ptr[m] : 0),
                                                pall + (size_t)(on ? ff : 0) * NB +
                                                    (on ? mel_first[m] : 0),
                                                nbins, k);
    if (on && k == 0)
      out[(size_t)(t0 + ff) * n_mels + m] = logf(use_floor ? fmaxf(acc, floor_v) : acc);
  }
}

// BLOCKS: the blocks an SM the wide instantiations are compiled for, 2 (at
// most 64 registers a thread, a few spilled) where two blocks' shared
// memory fits an SM, else 1 (up to 128): small frames gain more from the
// occupancy than they lose to the spills, one frame a block only loses
// (sed_crnn_torch/tools/logmel_phases.py times both, PERF.md §6).
// -DLOGMEL_WIDE_BLOCKS=1 or 2 forces one, for that tool only.
#ifndef LOGMEL_WIDE_BLOCKS
#define LOGMEL_WIDE_BLOCKS 0
#endif
// DIF stages (register or matrix) of a batch of `len`-point transforms over
// `count` points of `cur` (twiddle table tw of len points), forward or
// transposed in reverse order, in the EXT instantiations: `ls0` the
// sub-transform length before the first forward stage (len), or before the
// first transposed one (what the stages left below them: 1, or a nested
// Rader stage's q); its matrix stages write the other array and swap the
// two.
template <bool TRANSPOSED, int COLS, class RG>
__device__ __forceinline__ void batch_stages(const int* radix, const int* table, int stages,
                                             int len, int ls0, float2*& cur, float2*& oth,
                                             int count, int lt, int tpf, const float2* tw,
                                             const float* dft, RG ring) {
  int ls = ls0;
  for (int i = 0; i < stages; ++i) {
    const int s = TRANSPOSED ? stages - 1 - i : i;
    const int r = radix[s];
    if (TRANSPOSED) ls *= r;
    if (logmel::matrix_radix(r)) {
      if (CUT < 3)
        logmel::run_matrix_stage<TRANSPOSED, COLS>(cur, oth, len, r, ls, 0, count / r, lt, tpf,
                                                   dft + table[s], tw, ring);
      float2* const t = cur;
      cur = oth;
      oth = t;
    } else {
      logmel::run_block_stage<TRANSPOSED, true, true>(r, cur, len, count, ls, lt, tpf, tw);
    }
    if (!TRANSPOSED) ls /= r;
    __syncthreads();
  }
}

// The nested Rader stage of prime q, the inner transforms' last (m = 1, on
// the runs of q points of the Np points of `cur`), into the other array,
// after which the two swap. Forward: gather from the runs (x_0 to the
// tail Np'' + b, Np'' = Np (q - 1) / q), then the convolution; transposed
// (the input in that layout already): the convolution, then the scatter
// back to the runs. The convolution: the q - 1 point transforms on the
// Np'' points, the product with nspec (x_0 and X_0 in the tail), the
// transposed transforms.
template <bool TRANSPOSED, int COLS, class RG>
__device__ __forceinline__ void nested_rader(const Plan& plan, float2*& cur, float2*& oth, int Np,
                                             int lt, int tpf, const Tables& t, RG ring) {
  const int q = plan.rader_radix[plan.rader_stages - 1], Npp = Np - Np / q;
  float2* w = cur;          // the array that holds the layout
  float2* o = oth;
  if (!TRANSPOSED) {
    if (CUT < 4) logmel::rader_gather(cur, oth, Np, q, 0, Np, lt, tpf, t.ngather);
    __syncthreads();
    w = oth;
    o = cur;
  }
  if (CUT < 4) {
    float2* c2 = w;
    float2* o2 = o;
    batch_stages<false, COLS>(plan.nested_radix, plan.nested_table, plan.nested_stages,
                                    q - 1, q - 1, c2, o2, Npp, lt, tpf, t.ntw, t.dft, ring);
    logmel::rader_product(c2, w, Np, q, 0, Npp, lt, tpf, t.nspec);
    __syncthreads();
    batch_stages<true, COLS>(plan.nested_radix, plan.nested_table, plan.nested_stages,
                                   q - 1, 1, c2, o2, Npp, lt, tpf, t.ntw, t.dft, ring);
  }
  if (TRANSPOSED) {
    if (CUT < 4) logmel::rader_scatter(w, o, Np, q, 0, Np, lt, tpf, t.ngather);
    __syncthreads();
    cur = o;
    oth = w;
  } else {
    cur = w;
    oth = o;
  }
}

// A Rader stage's inner p - 1 point transforms (steps 2-4 of the Rader stage
// in csrc/logmel_stages.cuh), forward or transposed in reverse order, on
// `cur` (its matrix stages write the other array and swap the two); Np the
// points they cover.
template <bool TRANSPOSED, int COLS, class RG>
__device__ __forceinline__ void rader_inner(const Plan& plan, float2*& cur, float2*& oth, int p,
                                            int Np, int lt, int tpf, const float2* rtw,
                                            const float* dft, RG ring) {
  int ls = TRANSPOSED ? 1 : p - 1;
  for (int i = 0; i < plan.rader_stages; ++i) {
    const int s = TRANSPOSED ? plan.rader_stages - 1 - i : i;
    const int r = plan.rader_radix[s];
    if (TRANSPOSED) ls *= r;
    if (r > logmel::MAX_REGISTER_RADIX) {
      if (CUT < 3)
        logmel::run_matrix_stage<TRANSPOSED, COLS>(cur, oth, p - 1, r, ls, 0, Np / r, lt, tpf,
                                                   dft + plan.rader_table[s], rtw, ring);
      float2* const t = cur;
      cur = oth;
      oth = t;
    } else {
      logmel::run_block_stage<TRANSPOSED, true>(r, cur, p - 1, Np, ls, lt, tpf, rtw);
    }
    if (!TRANSPOSED) ls /= r;
    __syncthreads();
  }
}

// `rader_inner` in the EXT instantiations: composite radices among the
// inner ones, and the inner transforms may end in a nested Rader stage
// (which writes the other array and swaps the two, as a matrix stage
// does).
template <bool TRANSPOSED, int COLS, class RG>
__device__ __forceinline__ void rader_inner_ext(const Plan& plan, float2*& cur, float2*& oth,
                                                int p, int Np, int lt, int tpf, const Tables& t,
                                                RG ring) {
  const bool nest = plan.nested_stages > 0;
  const int stages = plan.rader_stages - nest;
  const int below = nest ? plan.rader_radix[stages] : 1;
  if (TRANSPOSED && nest) nested_rader<true, COLS>(plan, cur, oth, Np, lt, tpf, t, ring);
  batch_stages<TRANSPOSED, COLS>(plan.rader_radix, plan.rader_table, stages, p - 1,
                                 TRANSPOSED ? below : p - 1, cur, oth, Np, lt, tpf, t.rtw, t.dft,
                                 ring);
  if (!TRANSPOSED && nest) nested_rader<false, COLS>(plan, cur, oth, Np, lt, tpf, t, ring);
}

// EXT: a plan with composite radices or a nested Rader stage (their code
// only in these instantiations, at one block an SM). WG: a plan with wgmma
// matrix stages (their code and B ring only in these, wide at one block an
// SM; the others keep the mma.sync form's code alone).
template <bool BLUE, bool WIDE, bool RADER, int BLOCKS, bool EXT, bool WG>
__global__ void __launch_bounds__(WG ? WG_THREADS : WIDE ? WIDE_THREADS : MAX_THREADS,
                                   BLOCKS)
logmel_mixed_kernel(const float* __restrict__ src,      // frame t at src[t * stride]
                    long long stride, int n_frames, int n_fft, Plan plan, int tpf, int fpb,
                    int alt,                            // 1: a second work array (matrix stages)
                    const float* __restrict__ window,   // (n_fft) Hann
                    const float2* __restrict__ tw,      // (N) e^{-2 pi i m / N}
                    const int* __restrict__ pos,        // (L) direct: position of X_k
                    const float2* __restrict__ chirp,   // (L) Bluestein: w_n
                    const float2* __restrict__ bspec,   // (M) Bluestein: B / M at DIF positions
                    const float2* __restrict__ utw,     // (L + 1) even n_fft: e^{-2 pi i k / n_fft}
                    const float* __restrict__ dft,      // matrix stages' B fragments
                    const int* __restrict__ rgather,    // (p - 1) Rader: g^m mod p
                    const float2* __restrict__ rtw,     // (p - 1) Rader: e^{-2 pi i q / (p - 1)}
                    const float2* __restrict__ rspec,   // (p - 1) Rader: B, DIF positions
                    const int* __restrict__ ngather,    // (q - 1) nested Rader: g^m mod q
                    const float2* __restrict__ ntw,     // (q - 1) nested: e^{-2 pi i m / (q - 1)}
                    const float2* __restrict__ nspec,   // (q - 1) nested: B, DIF positions
                    const int* __restrict__ mel_first,  // (n_mels) first bin of each band
                    const int* __restrict__ mel_ptr,    // (n_mels + 1) CSR row pointers
                    const float* __restrict__ mel_w,    // (nnz) weights in bin order
                    int n_mels, int mel_group, int use_floor, float floor_v,
                    float* __restrict__ out) {          // (n_frames, n_mels)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int COLS = BLOCKS == 1 ? 4 : 2;   // a wide matrix stage's column tiles a warp job
  const int N = plan.n, L = plan.points, NB = plan.n_bins;
  float2* const zall = reinterpret_cast<float2*>(smem_raw);
  float* const pall = reinterpret_cast<float*>(zall + (size_t)(1 + alt) * fpb * N);
  const bool even = (n_fft & 1) == 0;
  // The wgmma matrix stages' B ring, in the power rows' place.
  const auto ring = logmel::ring_at<WG>(pall, plan.ring);

  const int lt = threadIdx.x % tpf;     // thread within its frame
  const int f = threadIdx.x / tpf;      // frame within the block
  const int t0 = blockIdx.x * fpb;
  const bool live = t0 + f < n_frames;
  float2* z = zall + (size_t)f * N;                   // the current work array
  float2* zb = zall + (size_t)(fpb + f) * N;          // the other (matrix stages' output)

  // Load: window, pack (even) or zero imaginary part (odd), chirp
  // (Bluestein), zeros past L. A frame past the end computes on zeros. A
  // Rader stage that is the only stage of a small frame (`rader_first`)
  // gathers here, into the other array.
  const float* fr = src + (size_t)(live ? t0 + f : 0) * (size_t)stride;
  const bool gathered = RADER && plan.rader_first;
  float2* const zl = gathered ? zb : z;
  for (int n = lt; n < N; n += tpf) {
    const int k = gathered ? logmel::rader_load_index(n, N, rgather) : n;
    zl[n] = live ? logmel::load_point<BLUE>(fr, k, L, even, window, chirp)
                 : make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  int ls = N;
  for (int s = 0; s < plan.n_stages; ++s) {
    const int r = plan.radix[s];
    if constexpr (RADER) {
      if (s == plan.n_stages - 1) {
        // The Rader stage (the last): gather into zb, the inner transforms
        // and the product, after which zb holds X; then zb is the array.
        if (CUT < 5) {
          const int Np = N - N / r;
          if (!plan.rader_first) {
            logmel::rader_gather(z, zb, N, r, 0, N, lt, tpf, rgather);
            __syncthreads();
          }
          float2* cur = zb;
          float2* oth = z;
          if constexpr (EXT) {
            const Tables t{window, tw, pos, chirp, bspec, utw, dft, rgather, rtw, rspec,
                           ngather, ntw, nspec, mel_first, mel_ptr, mel_w};
            rader_inner_ext<false, COLS>(plan, cur, oth, r, Np, lt, tpf, t, ring);
            if (plan.nested_stages > 0) {
              const int q = plan.rader_radix[plan.rader_stages - 1];
              logmel::rader_product_split(cur, zb, N, r, (r - 1) - (r - 1) / q, 0, Np, lt, tpf,
                                          rspec);
            } else {
              logmel::rader_product(cur, zb, N, r, 0, Np, lt, tpf, rspec);
            }
            __syncthreads();
            rader_inner_ext<true, COLS>(plan, cur, oth, r, Np, lt, tpf, t, ring);
          } else {
            rader_inner<false, COLS>(plan, cur, oth, r, Np, lt, tpf, rtw, dft, ring);
            logmel::rader_product(cur, zb, N, r, 0, Np, lt, tpf, rspec);
            __syncthreads();
            rader_inner<true, COLS>(plan, cur, oth, r, Np, lt, tpf, rtw, dft, ring);
          }
        }
        float2* const t = z;
        z = zb;
        zb = t;
        __syncthreads();
        continue;
      }
    }
    if constexpr (WIDE) {
      if (logmel::matrix_radix(r)) {
        if (CUT < 3)
          logmel::run_matrix_stage<false, COLS>(static_cast<const float2*>(z), zb, N, r, ls, 0,
                                                N / r, lt, tpf, dft + plan.table[s], tw, ring);
        float2* const t = z;
        z = zb;
        zb = t;
      } else if (CUT < 7) {
        logmel::run_block_stage<false, true, EXT>(r, z, N, N, ls, lt, tpf, tw);
      }
    } else if (CUT < 7) {
      logmel::run_block_stage<false, false, EXT>(r, z, N, N, ls, lt, tpf, tw);
    }
    ls /= r;
    __syncthreads();
  }

  if (BLUE && CUT < 6) {
    // Pointwise product with the filter spectrum, conjugated, then the
    // transposed stages in reverse order: D = FFT(conj(A B)) in natural order.
    for (int p = lt; p < N; p += tpf) z[p] = logmel::cconj(logmel::cmul(z[p], __ldg(bspec + p)));
    __syncthreads();
    ls = 1;
    for (int s = plan.n_stages - 1; s >= 0; --s) {
      ls *= plan.radix[s];
      logmel::run_block_stage<true, WIDE, EXT>(plan.radix[s], z, N, N, ls, lt, tpf, tw);
      __syncthreads();
    }
  }

  // Power of bins 0..NB-1: the real-to-complex untangle (even n_fft), or
  // |Z_k|^2 (odd).
  float* const p = pall + (size_t)f * NB;
  for (int k = lt; k < NB; k += tpf)
    p[k] = CUT < 2 ? logmel::power<BLUE>(z, k, L, even, pos, chirp, utw) : 0.0f;
  __syncthreads();

  // Sparse mel: bin i of a band into partial i mod 32 in bin order, the
  // partials combined by the cluster body's fixed tree; floor, log. A group
  // of `mel_group` lanes (4, 8, 16 or 32; the host picks it from the bands'
  // mean width) a (frame, band), 32 / mel_group partials a lane.
  switch (mel_group) {
    case 4:
      mel_phase<4>(pall, NB, fpb, n_frames, t0, mel_first, mel_ptr, mel_w, n_mels, use_floor,
                   floor_v, out);
      break;
    case 8:
      mel_phase<8>(pall, NB, fpb, n_frames, t0, mel_first, mel_ptr, mel_w, n_mels, use_floor,
                   floor_v, out);
      break;
    case 16:
      mel_phase<16>(pall, NB, fpb, n_frames, t0, mel_first, mel_ptr, mel_w, n_mels, use_floor,
                    floor_v, out);
      break;
    default:
      mel_phase<32>(pall, NB, fpb, n_frames, t0, mel_first, mel_ptr, mel_w, n_mels, use_floor,
                    floor_v, out);
  }
}

// Threads per frame: POINTS transform points a thread, whole warps (whole
// warpgroups with a wgmma matrix stage), at most MAX_THREADS (WIDE_THREADS
// for the wide instantiation). Frames a block: up to MIN_THREADS threads,
// within MAX_SMEM.
int threads_per_frame(const Plan& plan, bool wide) {
  const int unit = plan.slab ? 128 : 32;
  int t = (plan.n + POINTS - 1) / POINTS;
  t = (t + unit - 1) / unit * unit;
  const int most = unit == 128 ? WG_THREADS : wide ? WIDE_THREADS : MAX_THREADS;
  return t > most ? most : t;
}

// A block's work arrays for fpb frames (two with matrix or Rader stages,
// which write out of place).
size_t block_arrays(const Plan& plan, bool alt, int fpb) {
  return sizeof(float2) * (size_t)plan.n * (alt ? 2 : 1) * fpb;
}

// A block's shared memory for fpb frames: their work arrays and power rows,
// whose place holds the wgmma stages' B ring (`logmel::ring_plan`, which
// sets plan.ring; its least, one slab, without `plan_ring`) where that is
// larger.
size_t block_smem(Plan plan, bool alt, int fpb, bool plan_ring = true) {
  const size_t rows = sizeof(float) * (size_t)plan.n_bins * fpb;
  const size_t arrays = block_arrays(plan, alt, fpb);
  const size_t ring = !plan.slab ? 0
                      : plan_ring ? logmel::ring_plan(plan, arrays, MAX_SMEM)
                                  : logmel::RING_ALIGN + (size_t)plan.slab;
  return arrays + (rows > ring ? rows : ring);
}

int frames_per_block(const Plan& plan, bool alt, int tpf) {
  int fpb = tpf >= MIN_THREADS ? 1 : MIN_THREADS / tpf;
  while (fpb > 1 && block_smem(plan, alt, fpb, false) > (size_t)MAX_SMEM) --fpb;
  return fpb;
}

// Host side: the dynamic shared memory attribute is set once per
// instantiation and device (bit d of `done`), then the launch.
template <bool BLUE, bool WIDE, bool RADER, int BLOCKS, bool EXT, bool WG>
int launch_as(const float* src, long long stride, int n_frames, int n_fft, Plan plan,
              bool alt, const Tables& t, int n_mels, int mel_group, int use_floor, float floor_v,
              float* out, cudaStream_t s) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(logmel_mixed_kernel<BLUE, WIDE, RADER, BLOCKS, EXT, WG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    done.fetch_or(bit);
  }
  const int tpf = threads_per_frame(plan, WIDE);
  const int fpb = frames_per_block(plan, alt, tpf);
  const size_t smem = block_smem(plan, alt, fpb);
  logmel::ring_plan(plan, block_arrays(plan, alt, fpb), MAX_SMEM);
  const int blocks = (n_frames + fpb - 1) / fpb;
  logmel_mixed_kernel<BLUE, WIDE, RADER, BLOCKS, EXT, WG><<<blocks, tpf * fpb, smem, s>>>(
      src, stride, n_frames, n_fft, plan, tpf, fpb, alt ? 1 : 0, t.window, t.tw, t.pos, t.chirp,
      t.bspec, t.utw, t.dft, t.rgather, t.rtw, t.rspec, t.ngather, t.ntw, t.nspec, t.mel_first,
      t.mel_ptr, t.mel_w, n_mels, mel_group, use_floor, floor_v, out);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation by the blocks an SM holds (see BLOCKS): the wide ones
// at 2 where two blocks' shared memory fits an SM; EXT (composite radices
// or a nested Rader stage) at 1, where they do not spill (n_fft 2579, its
// nested plan: 1.45 ms at one block an SM, 1.91 at two, PERF.md §6); a plan
// with wgmma matrix stages in its own (WG) wide instantiations at 1, whose
// accumulators want the 128 registers.
template <bool BLUE, bool WIDE, bool RADER, class... A>
int launch(const float* src, long long stride, int n_frames, int n_fft, const Plan& plan,
           bool alt, bool ext, A... rest) {
  if constexpr (WIDE && !BLUE) {
    if (plan.slab)
      return launch_as<BLUE, WIDE, RADER, 1, false, true>(src, stride, n_frames, n_fft, plan,
                                                          alt, rest...);
  }
  if (ext)
    return launch_as<BLUE, WIDE, RADER, 1, true, false>(src, stride, n_frames, n_fft, plan, alt,
                                                        rest...);
  if constexpr (WIDE) {
    const int fpb = frames_per_block(plan, alt, threads_per_frame(plan, true));
    const bool two = LOGMEL_WIDE_BLOCKS ? LOGMEL_WIDE_BLOCKS == 2
                                        : 2 * block_smem(plan, alt, fpb, false) <= (size_t)MAX_SMEM;
    if (two)
      return launch_as<BLUE, WIDE, RADER, 2, false, false>(src, stride, n_frames, n_fft, plan,
                                                           alt, rest...);
  }
  return launch_as<BLUE, WIDE, RADER, 1, false, false>(src, stride, n_frames, n_fft, plan, alt,
                                                       rest...);
}

}  // namespace

extern "C" {

const char* logmel_mixed_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int logmel_mixed_max_smem() { return MAX_SMEM; }
int logmel_mixed_max_stages() { return MAX_STAGES; }
// The most column tiles a matrix stage takes (`matrix_tiles`): the largest
// odd radix whose B fragments (2 x tiles^2 x 512 bytes) stay within 4 MB.
int logmel_mixed_matrix_tiles() { return 64; }

// The forms of the matrix stages a launch of this plan runs (`logmel_mixed`'s
// plan arguments): bit 0 mma.sync, bit 1 wgmma; -1 for a plan it does not
// take.
int logmel_mixed_forms(int n_fft, int n, int n_stages, const int* radices, int bluestein,
                       int rader_stages, const int* rader_radices, int nested_stages,
                       const int* nested_radices) {
  Plan plan;
  bool wide = false, matrix = false, alt = false, ext = false;
  if (!logmel::make_plan(plan, n_fft, n, n_stages, radices, rader_stages, rader_radices,
                         nested_stages, nested_radices, logmel_mixed_matrix_tiles(), wide, matrix,
                         alt, ext))
    return -1;
  return logmel::plan_forms(plan);
}

// Frame t (t < n_frames) is the n_fft samples at src[t * stride]; the plan:
// transform length n (L = n_fft / 2 for an even n_fft, n_fft for an odd one;
// M >= 2L - 1 with bluestein), its DIF radices (each 2, 3, 4, 5, 7, 11 or
// 13, or, direct only, any odd radix from 15 whose matrix_tiles fit
// logmel_mixed_matrix_tiles: a matrix stage; with rader_stages > 0 the last
// is a Rader stage's prime p, and rader_radices the rader_stages radices of
// its p - 1 point transforms, register or matrix; their product n); window
// (n_fft); tw (n) complex float32 pairs; pos (L, int32, direct only); chirp
// (L) and bspec (n) (Bluestein only); utw (L + 1, even n_fft only); dft
// (matrix stages only: each one's matrix_table, in stage order, the Rader
// stage's inner ones last); rgather (p - 1, int32), rtw and rspec (p - 1
// complex; Rader only); the mel filterbank as CSR rows of contiguous bins:
// band m covers bins mel_first[m] .. mel_first[m] + mel_ptr[m + 1] -
// mel_ptr[m] - 1 with weights mel_w[mel_ptr[m] ..], each band summed by
// mel_group lanes (4, 8, 16 or 32); out (n_frames, n_mels). Returns a
// cudaError_t: cudaErrorInvalidValue for a plan it does not take (one frame
// over 227 KB of shared memory included).
int logmel_mixed(const float* src, long long stride, int n_frames, int n_fft, int n,
                 int n_stages, const int* radices, int bluestein, int rader_stages,
                 const int* rader_radices, int nested_stages, const int* nested_radices,
                 const float* window, const void* tw, const int* pos, const void* chirp,
                 const void* bspec, const void* utw, const float* dft, const int* rgather,
                 const void* rtw, const void* rspec, const int* ngather, const void* ntw,
                 const void* nspec, const int* mel_first, const int* mel_ptr, const float* mel_w,
                 int n_mels, int mel_group, int use_floor, float floor_v, float* out,
                 void* stream) {
  if (n_frames <= 0 || stride <= 0 || n_mels <= 0 || n_fft <= 0 || src == nullptr ||
      out == nullptr || window == nullptr || tw == nullptr ||
      (mel_group != 4 && mel_group != 8 && mel_group != 16 && mel_group != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  bool wide = false, matrix = false, alt = false, ext = false;
  if (!logmel::make_plan(plan, n_fft, n, n_stages, radices, rader_stages, rader_radices,
                         nested_stages, nested_radices, logmel_mixed_matrix_tiles(), wide, matrix,
                         alt, ext))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool rader = rader_stages > 0;
  const bool direct_ok =
      !bluestein && n == plan.points && pos != nullptr &&
      (!rader || (rgather != nullptr && rtw != nullptr && rspec != nullptr)) &&
      (nested_stages == 0 || (ngather != nullptr && ntw != nullptr && nspec != nullptr));
  const bool blue_ok = bluestein && !wide && n >= 2 * plan.points - 1 && chirp != nullptr &&
                       bspec != nullptr;
  if (!(direct_ok || blue_ok) || (n_fft % 2 == 0 && utw == nullptr) ||
      (matrix && dft == nullptr) || block_smem(plan, alt, 1, false) > (size_t)MAX_SMEM ||
      (plan.slab && ext))   // a wgmma stage beside a composite radix or a nested stage
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tables t{window, static_cast<const float2*>(tw), pos,
                 static_cast<const float2*>(chirp), static_cast<const float2*>(bspec),
                 static_cast<const float2*>(utw), dft, rgather,
                 static_cast<const float2*>(rtw), static_cast<const float2*>(rspec), ngather,
                 static_cast<const float2*>(ntw), static_cast<const float2*>(nspec), mel_first,
                 mel_ptr, mel_w};
  if (bluestein)
    return launch<true, false, false>(src, stride, n_frames, n_fft, plan, false, ext, t, n_mels,
                                      mel_group, use_floor, floor_v, out, s);
  if (rader)
    return launch<false, true, true>(src, stride, n_frames, n_fft, plan, true, ext, t, n_mels,
                                     mel_group, use_floor, floor_v, out, s);
  if (wide)
    return launch<false, true, false>(src, stride, n_frames, n_fft, plan, alt, ext, t, n_mels,
                                      mel_group, use_floor, floor_v, out, s);
  return launch<false, false, false>(src, stride, n_frames, n_fft, plan, false, ext, t, n_mels,
                                     mel_group, use_floor, floor_v, out, s);
}

}  // extern "C"
