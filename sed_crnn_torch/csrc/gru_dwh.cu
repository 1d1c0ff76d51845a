// The backward's dwh/dbh reduction of kernel B for Hopper (sm_90a) at every
// hidden width H > 32 (the wide, cluster and grid bodies' backward): a
// split-K product on the tensor cores in 3xTF32, and the fixed-order sum of
// its partials.
//
// Replaces, at H > 32, the dwh_ref / dbh_ref outputs of the TPU kernel
// `_bwd_kernel` of sed_crnn_tpu/ops/pallas/gru_scan.py, which the port
// computes after the gradient chain (csrc/gru_wide.cu, gru_cluster.cu,
// gru_grid.cu write dxp; csrc/gru_warp.cu keeps its own reduction at
// H <= 32). For each (direction, seed), over the N = B T stored rows
// n = b T + t, part p = 0, 1, 2 of dwh (H, 3H) is
//   dwh[:, p H : (p + 1) H] = L_p^T D_p,
// L = h_prev (the previous row of ys, h0 at a sequence's first step, the
// last step when the direction is reversed), times r (from res) for p = 2
// when not reset_after; D_p = dxp[:, p H : (p + 1) H], times r for p = 2
// when reset_after; dbh = the column sums of D (zeros unless reset_after).
//
// What bounds it: operations. At H = 1024, B = 128, T = 256 a pair's
// product is 2 N H 3H x 2 = 412 GFLOP against 1.6 GB of operands; 3xTF32
// runs three TF32 products for each (1.24 TFLOP at the card's 495 TFLOP/s
// dense TF32: 2.5 ms), and float32 FMAs would take 6.15 ms at 67 TFLOP/s.
//
// What the design does about it:
//   * the products on the tensor cores (mma.sync m16n8k8 TF32, float32
//     sums), each float32 operand split in registers into hi = tf32(x) and
//     lo = tf32(x - hi) (rounded to nearest, ties away: cvt.rna's bits, in
//     two integer operations, not the conversion unit's slower pipe) and the
//     three products lo.hi + hi.lo + hi.hi added into a float32 accumulator,
//     small terms first: the float32 band (within 1e-4 of the largest entry
//     of the plain float32 product over 32,768 rows), which one TF32 product
//     (10 mantissa bits) does not keep;
//   * the tensor cores' float32 adds truncate, so an accumulator that walked
//     a whole split (32,768 rows at H >= 1024: 2e-4 of max|dwh| on the card)
//     drifts toward zero: each chunk's 12 products go into a fresh
//     accumulator, added to the block's total by a rounded float32 add;
//   * a block owns a TILE x TILE output tile of one part p (rows k of wh,
//     columns c of the part), eight warps of TILE / 2 x TILE / 4, and walks
//     its row split in K-chunks of BK = 32 stored rows: TILE = 128 (4 x 4
//     MMA tiles a warp, 64 accumulators a thread, one block an SM), or 64
//     where H <= 64 (2 x 2, two blocks an SM), so that a narrow width does
//     not compute a tile that is mostly zeros;
//   * the chunks are staged with cp.async into a ring of STAGES = 3 in
//     shared memory: the L tile (the shift to h_prev is the row address, one
//     row of ys back or forward, h0 at a sequence start), the D tile and,
//     for p = 2, the r tile; 16-byte copies where H is a multiple of 4, else
//     4-byte ones; rows and columns beyond N or H are zeros, so any H takes
//     the same path. A row stride of TILE + 8 floats puts a fragment load's
//     32 lanes on 32 banks. r is applied to a fragment in registers
//     (__fmul_rn, the plain version's rounded product);
//   * dbh from the same D tiles: the blocks of row tile 0 add their columns
//     over the chunk's rows, one column a thread, in row order;
//   * split-K with one partial per row split and no atomics: the split count
//     is a function of (B, T, H) only (enough blocks for two waves of an
//     H100's 132 SMs, at most one split per 256 rows, whole chunks), the K order
//     in a split is the row order, and gru_dwh_sum adds the partials in
//     split order. So dwh is bitwise equal from run to run and seed s of a
//     stack sums as it would alone. Where the tiles already fill the card
//     twice there is one split, so the partials stay below 264 x 128 x 128
//     floats a (direction, seed) or one copy of dwh;
//   * grid.z is 2 * seed + direction, as in the recurrence kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

// One direction's operands, laid out as in csrc/gru_wide.cu: pointers of
// seed 0, the kernel steps to seed s by the tensor's size per seed.
struct DwhDir {
  const float* ys;
  const float* res;
  const float* h0;
  const float* dxp;
  float* part;
  int reverse;
};

namespace {

constexpr int MAX_DIRS = 2;
constexpr int BM = 128;              // the block tile (BM x BM); the split plan counts these
constexpr int BM_NARROW = 64;        // the block tile where H <= BM_NARROW
constexpr int BK = 32;               // stored rows a chunk of the ring
constexpr int STAGES = 3;            // the ring: STAGES - 1 chunks in flight
constexpr int THREADS = 256;         // eight warps: 2 along the rows x 4 along the columns
constexpr int SPLIT_BLOCKS = 264;    // two waves of an H100's 132 SMs
constexpr int MIN_SPLIT_ROWS = 256;  // at most one split per MIN_SPLIT_ROWS rows
constexpr int SUM_THREADS = 256;

// A staged row of a TILE-wide tile, padded: conflict-free fragment loads.
template <int TILE>
__host__ __device__ constexpr int row_stride() {
  return TILE + 8;
}

template <int TILE>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * 3 * BK * row_stride<TILE>() * 4;
}

// Profiling cuts, for sed_crnn_torch/tools/gru_phases.py only (the results
// are then wrong): built with -DGRU_DWH_CUT=1 a chunk runs one TF32 product
// (hi.hi) in place of three; with 2 no product (no fragment is loaded or
// split); with 3 also no copy of the chunks. 0, the default, cuts nothing.
#ifndef GRU_DWH_CUT
#define GRU_DWH_CUT 0
#endif
constexpr int CUT = GRU_DWH_CUT;

struct Dirs {
  DwhDir d[MAX_DIRS];
};

// A field of this block's direction `dsel`, selected field by field.
#define PICK(field) (dsel ? dirs.d[1].field : dirs.d[0].field)

__host__ __device__ __forceinline__ long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// The row split: `chunk` rows a split (a multiple of BK), `nsplit` splits,
// both functions of B, T and H only.
__host__ __device__ __forceinline__ void split_plan(int B, int T, int H, int* nsplit, int* chunk) {
  const long long rows = (long long)B * T;
  const long long t = cdiv(H, BM);
  long long want = SPLIT_BLOCKS / (3 * t * t);
  if (want < 1) want = 1;
  long long cap = cdiv(rows, MIN_SPLIT_ROWS);
  if (cap < 1) cap = 1;
  const long long n = want < cap ? want : cap;
  const long long c = cdiv(cdiv(rows, n), BK) * BK;
  *chunk = (int)c;
  *nsplit = (int)cdiv(rows, c);
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// the bits of cvt.rna.tf32.f32.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b: one m16n8k8 TF32 product, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (part p, row tile tm, column tile tn) of split blockIdx.y, for
// direction and seed blockIdx.z: the partial L_p^T D_p over the split's
// rows, and the blocks of row tile 0 the partial dbh of their columns.
// Warp w owns rows (w % 2) WM .. + WM and columns (w / 2) WN .. + WN of the
// TILE x TILE tile: MT x NT MMA tiles of 16 x 8.
template <int TILE, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    gru_dwh_kernel(Dirs dirs, int B, int T, int H, int reset_after, int chunk, int nsplit,
                   int vec) {
  constexpr int MT = TILE / 32, NT = TILE / 32, WM = 16 * MT, WN = 8 * NT;
  constexpr int LDS = row_stride<TILE>();
  static_assert(2 * WM == TILE && 4 * WN == TILE, "eight warps cover the tile");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dsel = blockIdx.z & 1;
  const size_t seed = blockIdx.z >> 1;
  const int H3 = 3 * H;
  const int RW = reset_after ? 4 * H : H3;
  const long long N = (long long)B * T;
  const float* ys = PICK(ys) + seed * N * H;
  const float* res = PICK(res) + seed * N * RW;
  const float* h0 = PICK(h0) + seed * B * H;
  const float* dxp = PICK(dxp) + seed * N * H3;
  const int rev = PICK(reverse);
  const int tiles = (int)cdiv(H, TILE);
  const int p = blockIdx.x / (tiles * tiles);
  const int tm = (blockIdx.x / tiles) % tiles, tn = blockIdx.x % tiles;
  const int m0 = tm * TILE, c0 = tn * TILE;
  const int n_lo = blockIdx.y * chunk;
  const int n_hi = (long long)n_lo + chunk < N ? n_lo + chunk : (int)N;
  const bool scale_l = p == 2 && !reset_after;
  const bool scale_d = p == 2 && reset_after;
  const bool with_r = scale_l || scale_d;
  const int r0 = scale_l ? m0 : c0;   // the r tile's first column
  const int tid = threadIdx.x;

  // Chunk ch of the split into ring slot ch % STAGES: L, D and (p = 2) r,
  // BK rows x TILE columns each, zeros beyond N and H.
  auto issue = [&](int ch) {
    if (CUT >= 3) return;
    float* sl = smem + (ch % STAGES) * 3 * BK * LDS;
    float* sd = sl + BK * LDS;
    float* sr = sd + BK * LDS;
    const int n0 = n_lo + ch * BK;
    const int per = vec ? 4 : 1;
    for (int e = tid; e < BK * TILE / per; e += THREADS) {
      const int rr = e / (TILE / per), col = (e % (TILE / per)) * per;
      const int n = n0 + rr;
      const bool row = n < n_hi;
      const float* lsrc = nullptr;
      if (row) {
        const int b = n / T, t = n - b * T;
        const bool first = rev ? t == T - 1 : t == 0;
        lsrc = first ? h0 + (size_t)b * H : ys + (size_t)(n + (rev ? 1 : -1)) * H;
      }
      const int k = m0 + col, c = c0 + col, rc = r0 + col;
      float* dl = sl + rr * LDS + col;
      float* dd = sd + rr * LDS + col;
      float* dr = sr + rr * LDS + col;
      if (vec) {
        if (row && k < H) cp16(dl, lsrc + k);
        else *reinterpret_cast<float4*>(dl) = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row && c < H) cp16(dd, dxp + (size_t)n * H3 + (size_t)p * H + c);
        else *reinterpret_cast<float4*>(dd) = make_float4(0.f, 0.f, 0.f, 0.f);
        if (with_r) {
          if (row && rc < H) cp16(dr, res + (size_t)n * RW + rc);
          else *reinterpret_cast<float4*>(dr) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        if (row && k < H) cp4(dl, lsrc + k);
        else *dl = 0.f;
        if (row && c < H) cp4(dd, dxp + (size_t)n * H3 + (size_t)p * H + c);
        else *dd = 0.f;
        if (with_r) {
          if (row && rc < H) cp4(dr, res + (size_t)n * RW + rc);
          else *dr = 0.f;
        }
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32, gid = lane >> 2, tig = lane & 3;
  const int wm = (warp % 2) * WM, wn = (warp / 2) * WN;
  float acc[MT][NT][4], tot[MT][NT][4];   // the chunk's products, the split's total
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) tot[i][j][v] = 0.f;
  const bool bias = tm == 0 && reset_after && tid < TILE;
  float bsum = 0.f;

  const int nch = (int)cdiv(n_hi - n_lo, BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) issue(s);
    cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of chunk ch have landed
    __syncthreads();               // everyone's, and everyone is done with chunk ch - 1
    if (ch + STAGES - 1 < nch) issue(ch + STAGES - 1);
    cp_async_commit();
    const float* sl = smem + (ch % STAGES) * 3 * BK * LDS;
    const float* sd = sl + BK * LDS;
    const float* sr = sd + BK * LDS;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < (CUT < 2 ? BK : 0); kk += 8) {
      const int ra = (kk + tig) * LDS, rb = (kk + tig + 4) * LDS;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wn + nt * 8 + gid;
        float d0 = sd[ra + col], d1 = sd[rb + col];
        if (scale_d) {
          d0 = __fmul_rn(d0, sr[ra + col]);
          d1 = __fmul_rn(d1, sr[rb + col]);
        }
        split(d0, bh[nt][0], bl[nt][0]);
        split(d1, bh[nt][1], bl[nt][1]);
      }
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm + mt * 16 + gid;
        float a[4] = {sl[ra + row], sl[ra + row + 8], sl[rb + row], sl[rb + row + 8]};
        if (scale_l) {
          a[0] = __fmul_rn(a[0], sr[ra + row]);
          a[1] = __fmul_rn(a[1], sr[ra + row + 8]);
          a[2] = __fmul_rn(a[2], sr[rb + row]);
          a[3] = __fmul_rn(a[3], sr[rb + row + 8]);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) split(a[v], ah[mt][v], al[mt][v]);
      }
      // lo.hi, then hi.lo, then hi.hi into each accumulator; the MT x NT
      // tiles of a term are independent, so a tile's three products are apart.
      if (CUT < 1) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) tot[i][j][v] = __fadd_rn(tot[i][j][v], acc[i][j][v]);
    if (bias) {
#pragma unroll 8
      for (int rr = 0; rr < BK; ++rr) {
        const float d = sd[rr * LDS + tid];
        bsum = __fadd_rn(bsum, scale_d ? __fmul_rn(d, sr[rr * LDS + tid]) : d);
      }
    }
  }
  cp_async_wait<0>();

  float* out = PICK(part) + (seed * nsplit + blockIdx.y) * ((size_t)H * H3 + H3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = m0 + wm + mt * 16 + gid + 8 * h;
      if (k >= H) continue;
      float* orow = out + (size_t)k * H3 + (size_t)p * H;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = c0 + wn + nt * 8 + 2 * tig;
        if (c < H) orow[c] = tot[mt][nt][2 * h];
        if (c + 1 < H) orow[c + 1] = tot[mt][nt][2 * h + 1];
      }
    }
  }
  if (tm == 0 && tid < TILE && c0 + tid < H)
    out[(size_t)H * H3 + (size_t)p * H + c0 + tid] = reset_after ? bsum : 0.f;
}

// out[q][e] = the sum over splits of part[q][s][e], splits added in index
// order, for each (direction, seed) row q.
__global__ void gru_dwh_sum(const float* __restrict__ part, float* __restrict__ out, int nsplit,
                            long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float* p = part + (size_t)blockIdx.y * nsplit * n + e;
  float s = 0.0f;
  for (int k = 0; k < nsplit; ++k) s += p[(size_t)k * n];
  out[(size_t)blockIdx.y * n + e] = s;
}

// Host side ------------------------------------------------------------------

// The dynamic shared memory attribute, set once per kernel and device.
cudaError_t opt_in(const void* fn, int bytes) {
  static std::mutex lock;
  static std::vector<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (const auto& e : done)
    if (e.first == fn && e.second == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  done.push_back({fn, dev});
  return cudaSuccess;
}

// One launch of the TILE-wide kernel over every (part, tile, split,
// direction and seed).
template <int TILE, int MIN_BLOCKS>
int launch(const Dirs& d, int ndir, int nseed, int B, int T, int H, int reset_after, int chunk,
           int nsplit, int vec, cudaStream_t s) {
  const void* fn = (const void*)gru_dwh_kernel<TILE, MIN_BLOCKS>;
  const cudaError_t err = opt_in(fn, smem_bytes<TILE>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = cdiv(H, TILE);
  gru_dwh_kernel<TILE, MIN_BLOCKS>
      <<<dim3((unsigned)(3 * tiles * tiles), nsplit, ndir * nseed), THREADS, smem_bytes<TILE>(),
         s>>>(d, B, T, H, reset_after, chunk, nsplit, vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

const char* gru_dwh_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Partials gru_dwh_launch writes per (direction, seed) for B*T rows.
int gru_dwh_splits(int B, int T, int H) {
  int nsplit = 1, chunk = BK;
  split_plan(B, T, H, &nsplit, &chunk);
  return nsplit;
}

// ndir (1 or 2) directions of nseed seeds (nseed > 1 only with both), each
// ys (nseed, B, T, H), res (nseed, B, T, RW), h0 (nseed, B, H), dxp (nseed,
// B, T, 3H) -> part (nseed, gru_dwh_splits(B, T, H), 3H * H + 3H): per
// split, dwh (row-major (H, 3H)) then dbh (zeros unless reset_after);
// float32, contiguous, on the device of `stream`.
int gru_dwh_launch(const DwhDir* dirs, int ndir, int nseed, int B, int T, int H, int reset_after,
                   void* stream) {
  if (ndir < 1 || ndir > MAX_DIRS || nseed < 1 || (nseed > 1 && ndir != MAX_DIRS) || B <= 0 ||
      T <= 0 || H <= 0 || (long long)ndir * nseed > 65535 || (long long)B * T >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int nsplit = 1, chunk = BK;
  split_plan(B, T, H, &nsplit, &chunk);
  int vec = H % 4 == 0;
  Dirs d = {};
  for (int i = 0; i < ndir; ++i) {
    d.d[i] = dirs[i];
    vec = vec && aligned16(dirs[i].ys) && aligned16(dirs[i].res) && aligned16(dirs[i].h0) &&
          aligned16(dirs[i].dxp);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= BM_NARROW)
    return launch<BM_NARROW, 2>(d, ndir, nseed, B, T, H, reset_after, chunk, nsplit, vec, s);
  return launch<BM, 1>(d, ndir, nseed, B, T, H, reset_after, chunk, nsplit, vec, s);
}

// out (nrows, n) = part (nrows, nsplit, n) summed over its split axis in
// index order; a row per (direction, seed).
int gru_dwh_sum_partials(const float* part, float* out, int nrows, int nsplit, long long n,
                         void* stream) {
  if (nrows < 1 || nrows > 65535 || nsplit <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  gru_dwh_sum<<<dim3((unsigned)cdiv(n, SUM_THREADS), nrows), SUM_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(part, out, nsplit, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
