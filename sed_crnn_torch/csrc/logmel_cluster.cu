// Log-mel by the mixed-radix / Bluestein FFT of csrc/logmel_mixed.cu with
// one frame split over a thread-block cluster, for Hopper (sm_90a), at every
// n_fft whose plan takes more than one block's shared memory: windowed frame
// -> DFT -> power -> sparse mel -> floor -> log, in one pass over the
// waveform, with no spectral intermediate in device memory.
//
// Replaces, at those sizes, the three TPU kernels of
// sed_crnn_tpu/ops/pallas/fused_logmel.py: `_kernel_dif_chunked` (hop ==
// n_fft / 2), `_kernel_dif` (any hop, or a frame matrix) and `_kernel_exact`
// (mode "exact", any n_fft % 4 != 0). All three compute the same function;
// the frame stride picks the source.
//
// The plan is the mixed body's (ops/kernels/fused_logmel.py `mixed_plan`):
// the same radices (register radices 2-13, matrix stages for wider primes,
// a Rader stage last for the largest prime, or Bluestein), twiddle and
// value tables, Rader gather and filter spectrum, Bluestein chirp and filter
// spectrum, untangle and lane order of the mel sums, and the same operations
// from csrc/logmel_stages.cuh, so the result is the mixed body's bits (and
// `_mixed_plain`'s, or within its band with matrix stages) whatever the
// cluster size C. One cluster of C CTAs owns one frame: CTA c holds points
// [c chunk, (c + 1) chunk) of the N-point work array (and of the second one
// that matrix and Rader stages write out of place; chunk = ceil(N / C), or
// whole inner transforms of a Rader stage) and bins [c bin_chunk, (c + 1)
// bin_chunk) of the power row in its own shared memory, and reaches its
// partners' through distributed shared memory (`cluster.map_shared_rank`):
// point p lives in CTA p / chunk at offset p % chunk.
//
// A stage on sub-transforms of length ls whose span lies inside one CTA's
// chunk (chunk % ls == 0) runs each CTA's own butterflies on its own points
// between block barriers; a stage with a longer span (the first DIF stages,
// the last transposed ones) splits its butterflies evenly over the CTAs,
// which read and write each other's points, between cluster barriers
// (barrier.cluster arrive.release / wait.acquire). A matrix stage splits
// its butterflies the same way and reads and writes through the same
// accessors (a row of its mma products is one butterfly's, whatever the
// other rows: the mixed body's bits); a stage of 373 runs on wgmma
// (`wgmma_stage`, in the WG instantiations), its B slabs copied into each
// CTA's own shared memory, and `cluster_size` gives a plan with one 16
// CTAs, the most warpgroups on its butterflies. A Rader stage's gather and
// pointwise
// product always cross CTAs (x_0 and X_0 sit in the tails); its inner
// stages cross as the outer ones do, by their sub-transform length. A
// barrier is cluster-wide when the phase before it or after it reaches
// another CTA.
// The power of a bin reads its spectrum points anywhere in the cluster; the
// mel sum of a band runs on a warp of its own in the CTA that holds its
// middle bin, lane l adding the band's bins l, l + 32, ... in bin order
// (mostly from that CTA's shared memory) and a fixed shuffle tree combining
// the lanes; a last cluster barrier keeps every CTA's shared memory alive
// until no partner reads it.
//
// What bounds it on an H100: these sizes run O(N log N) operations a frame
// against 4 * hop bytes of new waveform, and the mel product of 2 nnz, so
// operations; Bluestein doubles the transform. The design keeps the frame on
// chip (C x up to 227 KB of shared memory, one CTA a SM at the real sizes)
// and pays for it with the distributed shared memory traffic and cluster
// barriers of the stages that cross CTAs. A band's mel sum, up to 4,019
// bins at n_fft 44,100, was one serial chain of adds on one lane and took
// about half the time at one-second windows; over 32 lanes it takes ~6 %
// (sed_crnn_torch/tools/logmel_phases.py splits the time by phase). With a
// Rader stage the transform is two p - 1 point transforms a butterfly,
// O(p log p), in place of Bluestein's two of M >= 2L - 1 points: at n_fft
// 25,734 the frame takes 2 CTAs either way and the Rader plan 0.63 ms to
// Bluestein's 0.83 (PERF.md §6). Radices 11 and 13 run in the wide
// instantiations (512 threads a CTA at most, up to 128 registers a thread),
// matrix and Rader stages in the wide instantiation with two work arrays,
// the others in the radix-7 one. Every product and sum outside the matrix
// stages is an explicitly rounded float32 operation (no FMA contraction) on
// tables computed in float64 and rounded once on the host: bitwise the same
// from run to run and at every C.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "logmel_stages.cuh"

namespace cg = cooperative_groups;

namespace {

using logmel::MAX_STAGES;
using logmel::Plan;
using logmel::Tables;

constexpr int MAX_THREADS = 1024;
constexpr int WIDE_THREADS = 512;       // the instantiation with radices 11 and 13
constexpr int POINTS = 8;               // transform points a thread owns per stage
// The wgmma instantiations' threads a CTA at most: 384, 168 registers a
// thread for the stage's 64 accumulators (at 512 threads and 128 registers
// they spilled and n_fft 141,001 ran 4 % slower on an H100, PERF.md §6).
constexpr int WG_THREADS = 384;
constexpr int MAX_SMEM = 232448;        // 227 KB, the opt-in limit of a CTA
constexpr int MAX_CLUSTER = 16;         // the non-portable cluster limit on Hopper
constexpr int NO_CLUSTER_FITS = -1;     // status: the card holds no cluster of this shape

// Profiling cuts, for sed_crnn_torch/tools/logmel_phases.py only
// (the results are then wrong): built with -DLOGMEL_CLUSTER_CUT=1 the body
// leaves out the mel sums, with 2 also the bins' power, with 3 also the
// matrix stages (a Rader stage's inner ones too), with 4 also the Rader
// stage (gather, inner register stages, product), with 5 also the register
// stages. 0, the default, cuts nothing. (-DLOGMEL_SKIP_RADIX=R, in
// csrc/logmel_stages.cuh, leaves out the register stages of one radix.)
#ifndef LOGMEL_CLUSTER_CUT
#define LOGMEL_CLUSTER_CUT 0
#endif
constexpr int CUT = LOGMEL_CLUSTER_CUT;

// How a frame is split over the cluster (the caller's choice, checked by
// the launcher).
struct Split {
  int ctas;         // C
  int chunk;        // work-array points a CTA: ceil(N / C), of each work array
  int bin_chunk;    // power-row bins a CTA: ceil(n_bins / C)
  unsigned cross;   // bit s: stage s (DIF s, and its transposed twin) reaches other CTAs
  unsigned rcross;  // bit s: the Rader stage's inner stage s (and its twin) does
};

// `Spread`: point p of the cluster's work array, in CTA p / chunk.
struct Spread {
  float2* z;        // this CTA's share; the same offset in every CTA
  int chunk;
  __device__ __forceinline__ float2& operator[](int p) const {
    const int r = p / chunk;
    return *cg::this_cluster().map_shared_rank(z + (p - r * chunk), r);
  }
};

// A barrier between two phases: cluster-wide when either reaches another
// CTA's shared memory, else this block's.
__device__ __forceinline__ void phase_barrier(bool cross) {
  if (cross) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Where a stage runs: this CTA's rank c of C, its points [lo, hi) of each
// work array (chunk a CTA), and its threads.
struct Part {
  int c, C, chunk, lo, hi, lt, nt;
};

// One register stage on either side of the split, on an array of `count`
// points (N the length of the twiddle table tw): a crossing stage's
// butterflies evenly over the CTAs, on points anywhere in the cluster; any
// other stage's own butterflies, on its own points.
template <bool TRANSPOSED, bool WIDE, bool EXT>
__device__ __forceinline__ void split_stage(int radix, bool cross, float2* z, const Part& q,
                                            int N, int count, int ls,
                                            const float2* __restrict__ tw) {
  const int nb = count / radix;
  if (cross) {
    const int per = (nb + q.C - 1) / q.C;
    logmel::run_stage<TRANSPOSED, WIDE, EXT>(radix, Spread{z, q.chunk}, N, ls,
                                             min(nb, q.c * per), min(nb, (q.c + 1) * per), q.lt,
                                             q.nt, tw);
  } else {
    logmel::run_stage<TRANSPOSED, WIDE, EXT>(radix, logmel::Shifted{z, q.lo}, N, ls,
                                             min(q.lo, count) / radix, min(q.hi, count) / radix,
                                             q.lt, q.nt, tw);
  }
}

// One matrix stage on either side of the split, from z into zo (the same
// butterflies as `split_stage` takes; each butterfly's products the same
// mma sequence wherever it runs, so the mixed body's bits).
template <bool TRANSPOSED, class RG>
__device__ __forceinline__ void split_matrix(int radix, bool cross, float2* z, float2* zo,
                                             const Part& q, int N, int count, int ls,
                                             const float* __restrict__ table,
                                             const float2* __restrict__ tw, RG ring) {
  const int nb = count / radix;
  if (cross) {
    const int per = (nb + q.C - 1) / q.C;
    logmel::run_matrix_stage<TRANSPOSED, 4>(Spread{z, q.chunk}, Spread{zo, q.chunk}, N, radix, ls,
                                     min(nb, q.c * per), min(nb, (q.c + 1) * per), q.lt, q.nt,
                                     table, tw, ring);
  } else {
    logmel::run_matrix_stage<TRANSPOSED, 4>(logmel::Shifted{z, q.lo}, logmel::Shifted{zo, q.lo}, N,
                                     radix, ls, min(q.lo, count) / radix,
                                     min(q.hi, count) / radix, q.lt, q.nt, table, tw, ring);
  }
}

// A Rader stage's inner p - 1 point transforms across the cluster (steps 2
// and 4 of the Rader stage in csrc/logmel_stages.cuh), forward or
// transposed in reverse order, on `cur` (a matrix stage writes `oth` and
// the two swap), each stage behind the barrier its crossing asks for.
template <bool TRANSPOSED, bool WIDE, bool EXT, class RG>
__device__ __forceinline__ void rader_inner(const Plan& plan, unsigned rcross, float2*& cur,
                                            float2*& oth, int p, int Np, const Part& q,
                                            const float2* rtw, const float* dft,
                                            RG ring, bool& cross_before) {
  int ls = TRANSPOSED ? 1 : p - 1;
  for (int i = 0; i < plan.rader_stages; ++i) {
    const int s = TRANSPOSED ? plan.rader_stages - 1 - i : i;
    const int r = plan.rader_radix[s];
    if (TRANSPOSED) ls *= r;
    const bool cross = (rcross >> s) & 1u;
    phase_barrier(cross_before || cross);
    cross_before = cross;
    if (logmel::matrix_radix(r)) {
      if (CUT < 3)
        split_matrix<TRANSPOSED>(r, cross, cur, oth, q, p - 1, Np, ls, dft + plan.rader_table[s],
                                 rtw, ring);
      float2* const t = cur;
      cur = oth;
      oth = t;
    } else if (CUT < 5) {
      split_stage<TRANSPOSED, WIDE, EXT>(r, cross, cur, q, p - 1, Np, ls, rtw);
    }
    if (!TRANSPOSED) ls /= r;
  }
}

// ALT: a plan with matrix or Rader stages, in two work arrays. EXT: with
// composite radices (their code only in these instantiations). WG: with
// wgmma matrix stages (their code and B ring only in these; ALT).
template <bool BLUE, bool WIDE, bool ALT, bool EXT, bool WG>
__global__ void __launch_bounds__(WG ? WG_THREADS : WIDE ? WIDE_THREADS : MAX_THREADS)
logmel_cluster_kernel(const float* __restrict__ src,      // frame t at src[t * stride]
                      long long stride, int n_fft, Plan plan, Split split,
                      const float* __restrict__ window,   // (n_fft) Hann
                      const float2* __restrict__ tw,      // (N) e^{-2 pi i m / N}
                      const int* __restrict__ pos,        // (L) direct: position of X_k
                      const float2* __restrict__ chirp,   // (L) Bluestein: w_n
                      const float2* __restrict__ bspec,   // (M) Bluestein: B / M, DIF positions
                      const float2* __restrict__ utw,     // (L + 1) even n_fft: e^{-2 pi i k / n_fft}
                      const float* __restrict__ dft,      // matrix stages' B fragments
                      const int* __restrict__ rgather,    // (p - 1) Rader: g^m mod p
                      const float2* __restrict__ rtw,     // (p - 1) Rader: e^{-2 pi i q / (p - 1)}
                      const float2* __restrict__ rspec,   // (p - 1) Rader: B, DIF positions
                      const int* __restrict__ mel_first,  // (n_mels) first bin of each band
                      const int* __restrict__ mel_ptr,    // (n_mels + 1) CSR row pointers
                      const float* __restrict__ mel_w,    // (nnz) weights in bin order
                      int n_mels, int use_floor, float floor_v,
                      float* __restrict__ out) {          // (n_frames, n_mels)
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = plan.n, L = plan.points, NB = plan.n_bins;
  const int C = split.ctas, chunk = split.chunk, bin_chunk = split.bin_chunk;
  float2* z = reinterpret_cast<float2*>(smem_raw);                     // points [lo, hi)
  float2* zb = z + chunk;                                               // the other (ALT)
  float* const pw = reinterpret_cast<float*>(z + (ALT ? 2 : 1) * chunk);   // bins [k_lo, k_hi)
  const bool even = (n_fft & 1) == 0;
  // The wgmma matrix stages' B ring, in the power row's place.
  const auto ring = logmel::ring_at<WG>(pw, plan.ring);

  const int c = static_cast<int>(cluster.block_rank());
  const int t = blockIdx.x / C;         // the frame of this cluster
  const int lt = threadIdx.x, nt = blockDim.x;
  const int lo = min(N, c * chunk), hi = min(N, lo + chunk);
  const Part q{c, C, chunk, lo, hi, lt, nt};

  bool cross_before = false;   // the last phase reached another CTA
  // Load this CTA's points: window, pack (even) or zero imaginary part
  // (odd), chirp (Bluestein), zeros past L.
  const float* fr = src + (size_t)t * (size_t)stride;
  for (int n = lo + lt; n < hi; n += nt)
    z[n - lo] = logmel::load_point<BLUE>(fr, n, L, even, window, chirp);

  int ls = N;
  for (int s = 0; s < plan.n_stages; ++s) {
    const int r = plan.radix[s];
    const bool cross = (split.cross >> s) & 1u;
    phase_barrier(cross_before || cross);
    cross_before = cross;
    if constexpr (ALT) {
      if (plan.rader_stages > 0 && s == plan.n_stages - 1) {
        // The Rader stage (the last; it crosses CTAs): gather into zb, the
        // inner transforms and the product, after which zb holds X.
        if (CUT < 4) {
          const int Np = N - N / r;
          logmel::rader_gather(Spread{z, chunk}, logmel::Shifted{zb, lo}, N, r, lo, hi, lt, nt,
                               rgather);
          float2* cur = zb;
          float2* oth = z;
          rader_inner<false, WIDE, EXT>(plan, split.rcross, cur, oth, r, Np, q, rtw, dft, ring,
                                        cross_before);
          phase_barrier(true);
          logmel::rader_product(logmel::Shifted{cur, lo}, Spread{zb, chunk}, N, r, min(lo, Np),
                                min(hi, Np), lt, nt, rspec);
          cross_before = true;
          rader_inner<true, WIDE, EXT>(plan, split.rcross, cur, oth, r, Np, q, rtw, dft, ring,
                                       cross_before);
        }
        float2* const tmp = z;
        z = zb;
        zb = tmp;
        continue;
      }
      if (logmel::matrix_radix(r)) {
        if (CUT < 3)
          split_matrix<false>(r, cross, z, zb, q, N, N, ls, dft + plan.table[s], tw, ring);
        float2* const tmp = z;
        z = zb;
        zb = tmp;
        ls /= r;
        continue;
      }
    }
    if (CUT < 5) split_stage<false, WIDE, EXT>(r, cross, z, q, N, N, ls, tw);
    ls /= r;
  }

  if (BLUE) {
    // Pointwise product with the filter spectrum, conjugated (own points
    // only), then the transposed stages in reverse order: D = FFT(conj(A B))
    // in natural order.
    phase_barrier(cross_before);
    cross_before = false;
    for (int p = lo + lt; p < hi; p += nt)
      z[p - lo] = logmel::cconj(logmel::cmul(z[p - lo], __ldg(bspec + p)));
    ls = 1;
    for (int s = plan.n_stages - 1; s >= 0; --s) {
      ls *= plan.radix[s];
      const bool cross = (split.cross >> s) & 1u;
      phase_barrier(cross_before || cross);
      cross_before = cross;
      if (CUT < 5) split_stage<true, WIDE, EXT>(plan.radix[s], cross, z, q, N, N, ls, tw);
    }
  }

  // Power of this CTA's bins: the untangle (even n_fft) or |Z_k|^2 (odd),
  // from spectrum points anywhere in the cluster.
  cluster.sync();
  const Spread all{z, chunk};
  const int k_lo = min(NB, c * bin_chunk), k_hi = min(NB, k_lo + bin_chunk);
  for (int k = k_lo + lt; k < k_hi; k += nt)
    pw[k - k_lo] = CUT < 2 ? logmel::power<BLUE>(all, k, L, even, pos, chirp, utw) : 0.0f;

  // Sparse mel: band m on warp m % warps of the CTA that holds its middle
  // bin, so that most of its bins are read from that CTA's own shared
  // memory; lane l adds the band's bins l, l + 32, ... in bin order, across
  // the CTAs that hold them, and a fixed tree of shuffles combines the 32
  // partials (`mel_tree_warp`, the mixed body's order); floor, log.
  cluster.sync();
  const int warps = nt / 32, lane = lt % 32;
  for (int m = lt / 32; m < n_mels; m += warps) {
    const int b = mel_ptr[m], e = mel_ptr[m + 1];
    if (min(C - 1, (mel_first[m] + (e - b) / 2) / bin_chunk) != c) continue;
    float acc = 0.0f;
    for (int i = b, k = mel_first[m]; CUT < 1 && i < e;) {
      const int r = k / bin_chunk, off = k - r * bin_chunk;
      const int run_len = min(e - i, bin_chunk - off);
      const float* q = r == c ? pw + off : cluster.map_shared_rank(pw + off, r);
      acc = logmel::lane_sum(acc, mel_w + i, q, run_len, (lane - (i - b)) & 31);
      i += run_len;
      k += run_len;
    }
    acc = logmel::mel_tree_warp(acc);
    if (lane == 0) out[(size_t)t * n_mels + m] = logf(use_floor ? fmaxf(acc, floor_v) : acc);
  }
  // No CTA leaves while a partner may still read its shared memory.
  cluster.sync();
}

// Threads a CTA: POINTS points of its chunk a thread, whole warps (whole
// warpgroups with a wgmma matrix stage), at most MAX_THREADS (WIDE_THREADS
// for the wide instantiation).
int threads_per_cta(int chunk, bool wide, bool wgmma) {
  const int unit = wgmma ? 128 : 32;
  int t = (chunk + POINTS - 1) / POINTS;
  t = (t + unit - 1) / unit * unit;
  const int most = unit == 128 ? WG_THREADS : wide ? WIDE_THREADS : MAX_THREADS;
  return t > most ? most : t;
}

// A CTA's shared memory: its share of the work array (two with matrix or
// Rader stages) and of the power row, whose place holds the wgmma stages'
// B ring (`logmel::ring_plan`, which sets plan.ring; its least, one slab,
// without `plan_ring`) where that is larger.
size_t cta_smem(const Split& split, bool alt, Plan plan, bool plan_ring = true) {
  const size_t row = sizeof(float) * (size_t)split.bin_chunk;
  const size_t arrays = sizeof(float2) * (size_t)split.chunk * (alt ? 2 : 1);
  const size_t ring = !plan.slab ? 0
                      : plan_ring ? logmel::ring_plan(plan, arrays, MAX_SMEM)
                                  : logmel::RING_ALIGN + (size_t)plan.slab;
  return arrays + (row > ring ? row : ring);
}

// Host side: the dynamic shared memory and non-portable cluster attributes
// are set once per instantiation and device (bit d of `done`).
template <bool BLUE, bool WIDE, bool ALT, bool EXT, bool WG>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(logmel_cluster_kernel<BLUE, WIDE, ALT, EXT, WG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(logmel_cluster_kernel<BLUE, WIDE, ALT, EXT, WG>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    done.fetch_or(bit);
  }
  return cudaSuccess;
}

// A launch of `clusters` clusters of `ctas` CTAs of `threads` threads and
// `smem` bytes, and how many such clusters the card holds at once (0: none,
// the launch would be refused).
template <bool BLUE, bool WIDE, bool ALT, bool EXT, bool WG>
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  Launch(int clusters, int ctas, int threads, size_t smem, cudaStream_t s) {
    cfg.gridDim = dim3(static_cast<unsigned>(clusters) * ctas, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }

  cudaError_t resident(int* clusters) {
    cudaError_t err = opt_in<BLUE, WIDE, ALT, EXT, WG>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(clusters, logmel_cluster_kernel<BLUE, WIDE, ALT, EXT, WG>,
                                          &cfg);
  }
};

// The launch: grid C CTAs a frame, cluster dimension C, after asking the
// card whether it holds one such cluster.
template <bool BLUE, bool WIDE, bool ALT, bool EXT, bool WG>
int launch_as(const float* src, long long stride, int n_frames, int n_fft, Plan plan,
              const Split& split, const Tables& t, int n_mels, int use_floor, float floor_v,
              float* out, cudaStream_t s) {
  logmel::ring_plan(plan, (long long)sizeof(float2) * split.chunk * (ALT ? 2 : 1), MAX_SMEM);
  Launch<BLUE, WIDE, ALT, EXT, WG> l(n_frames, split.ctas,
                                 threads_per_cta(split.chunk, WIDE, plan.slab > 0),
                                 cta_smem(split, ALT, plan), s);
  int clusters = 0;
  cudaError_t err = l.resident(&clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return NO_CLUSTER_FITS;
  err = cudaLaunchKernelEx(&l.cfg, logmel_cluster_kernel<BLUE, WIDE, ALT, EXT, WG>, src, stride,
                           n_fft, plan, split, t.window, t.tw, t.pos, t.chirp, t.bspec, t.utw,
                           t.dft, t.rgather, t.rtw, t.rspec, t.mel_first, t.mel_ptr, t.mel_w,
                           n_mels, use_floor, floor_v, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation: EXT where the plan has composite radices, WG where it
// has wgmma matrix stages.
template <bool BLUE, bool WIDE, bool ALT, class... A>
int launch(bool ext, bool wg, A... args) {
  if constexpr (ALT) {
    if (wg) return launch_as<BLUE, WIDE, ALT, false, true>(args...);
  }
  if (ext) return launch_as<BLUE, WIDE, ALT, true, false>(args...);
  return launch_as<BLUE, WIDE, ALT, false, false>(args...);
}

}  // namespace

extern "C" {

const char* logmel_cluster_error_string(int status) {
  if (status == NO_CLUSTER_FITS)
    return "the card cannot hold one cluster of this shape (cudaOccupancyMaxActiveClusters is 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int logmel_cluster_max_smem() { return MAX_SMEM; }
int logmel_cluster_max_ctas() { return MAX_CLUSTER; }
int logmel_cluster_max_stages() { return MAX_STAGES; }
// The most column tiles a matrix stage takes, as in csrc/logmel_mixed.cu.
int logmel_cluster_matrix_tiles() { return 64; }

// How many clusters of `ctas` CTAs (1 .. 16) of `threads` threads and
// `smem` bytes of dynamic shared memory each the card holds at once (0:
// such a launch is refused), or a negative cudaError_t.
int logmel_cluster_resident(int ctas, int threads, int smem) {
  if (ctas < 1 || ctas > MAX_CLUSTER || threads < 1 || threads > MAX_THREADS || smem < 0 ||
      smem > MAX_SMEM)
    return -static_cast<int>(cudaErrorInvalidValue);
  Launch<true, false, false, false, false> l(1, ctas, threads, smem, nullptr);
  int clusters = 0;
  const cudaError_t err = l.resident(&clusters);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// The forms of the matrix stages a launch of this plan runs
// (`logmel_cluster`'s plan arguments): bit 0 mma.sync, bit 1 wgmma; -1 for
// a plan it does not take.
int logmel_cluster_forms(int n_fft, int n, int n_stages, const int* radices, int bluestein,
                         int rader_stages, const int* rader_radices) {
  Plan plan;
  bool wide = false, matrix = false, alt = false, ext = false;
  if (!logmel::make_plan(plan, n_fft, n, n_stages, radices, rader_stages, rader_radices, 0,
                         nullptr, logmel_cluster_matrix_tiles(), wide, matrix, alt, ext))
    return -1;
  return logmel::plan_forms(plan);
}

// Frame t (t < n_frames) is the n_fft samples at src[t * stride]; the plan
// and tables as for logmel_mixed (csrc/logmel_mixed.cu: register, matrix
// and Rader stages, or Bluestein; no nested Rader stage), split over
// clusters of `ctas` CTAs (1 .. 16), one cluster a frame, as the caller
// chose (ops/kernels/fused_logmel.py `cluster_split`): `chunk` points of
// each work array and `bin_chunk` power-row bins a CTA, bit s of `cross` set
// where stage s reaches other CTAs (always for a Rader stage) and of
// `rcross` where the Rader stage's inner stage s does. The split is
// checked, not chosen, here: it must cover the array and the row, fit a
// CTA's shared memory, and a stage left inside the CTAs must have
// sub-transforms that divide the chunk. Returns a cudaError_t, or -1 when
// the card cannot hold one such cluster; cudaErrorInvalidValue for a plan or
// split it does not take.
int logmel_cluster(const float* src, long long stride, int n_frames, int n_fft, int n,
                   int n_stages, const int* radices, int bluestein, int rader_stages,
                   const int* rader_radices, int ctas, int chunk, int bin_chunk, unsigned cross,
                   unsigned rcross, const float* window, const void* tw, const int* pos,
                   const void* chirp, const void* bspec, const void* utw, const float* dft,
                   const int* rgather, const void* rtw, const void* rspec, const int* mel_first,
                   const int* mel_ptr, const float* mel_w, int n_mels, int use_floor,
                   float floor_v, float* out, void* stream) {
  if (n_frames <= 0 || stride <= 0 || n_mels <= 0 || n_fft <= 0 || n <= 0 || src == nullptr ||
      out == nullptr || window == nullptr || tw == nullptr || ctas < 1 || ctas > MAX_CLUSTER ||
      (long long)n_frames * ctas > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  bool wide = false, matrix = false, alt = false, ext = false;
  if (!logmel::make_plan(plan, n_fft, n, n_stages, radices, rader_stages, rader_radices, 0,
                         nullptr, logmel_cluster_matrix_tiles(), wide, matrix, alt, ext))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool rader = rader_stages > 0;
  const bool direct_ok = !bluestein && n == plan.points && pos != nullptr &&
                         (!rader || (rgather != nullptr && rtw != nullptr && rspec != nullptr));
  const bool blue_ok = bluestein && !wide && n >= 2 * plan.points - 1 && chirp != nullptr &&
                       bspec != nullptr;
  if (!(direct_ok || blue_ok) || (n_fft % 2 == 0 && utw == nullptr) ||
      (matrix && dft == nullptr) ||
      (plan.slab && ext))   // a wgmma stage beside a composite radix
    return static_cast<int>(cudaErrorInvalidValue);
  const Split split{ctas, chunk, bin_chunk, cross, rcross};
  if (chunk < 1 || bin_chunk < 1 || (long long)chunk * ctas < n ||
      (long long)bin_chunk * ctas < plan.n_bins ||
      cta_smem(split, alt, plan, false) > (size_t)MAX_SMEM ||
      (cross >> n_stages) != 0u || (rcross >> rader_stages) != 0u ||
      (rader && !((cross >> (n_stages - 1)) & 1u)))
    return static_cast<int>(cudaErrorInvalidValue);
  int ls = n;
  for (int s = 0; s < n_stages; ++s) {
    if (!((cross >> s) & 1u) && chunk % ls != 0) return static_cast<int>(cudaErrorInvalidValue);
    ls /= plan.radix[s];
  }
  ls = rader ? plan.radix[n_stages - 1] - 1 : 1;
  for (int s = 0; s < rader_stages; ++s) {
    if (!((rcross >> s) & 1u) && chunk % ls != 0) return static_cast<int>(cudaErrorInvalidValue);
    ls /= plan.rader_radix[s];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tables t{window, static_cast<const float2*>(tw), pos,
                 static_cast<const float2*>(chirp), static_cast<const float2*>(bspec),
                 static_cast<const float2*>(utw), dft, rgather,
                 static_cast<const float2*>(rtw), static_cast<const float2*>(rspec), nullptr,
                 nullptr, nullptr, mel_first, mel_ptr, mel_w};
  const bool wg = plan.slab > 0;
  if (bluestein)
    return launch<true, false, false>(ext, wg, src, stride, n_frames, n_fft, plan, split, t,
                                      n_mels, use_floor, floor_v, out, s);
  if (alt)
    return launch<false, true, true>(ext, wg, src, stride, n_frames, n_fft, plan, split, t,
                                     n_mels, use_floor, floor_v, out, s);
  if (wide)
    return launch<false, true, false>(ext, wg, src, stride, n_frames, n_fft, plan, split, t,
                                      n_mels, use_floor, floor_v, out, s);
  return launch<false, false, false>(ext, wg, src, stride, n_frames, n_fft, plan, split, t,
                                     n_mels, use_floor, floor_v, out, s);
}

}  // extern "C"
