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
// The arithmetic, shared by both bodies below:
//   * each float32 operand split into hi = tf32(x) and lo = tf32(x - hi)
//     (rounded to nearest, ties away: cvt.rna's bits, in two integer
//     operations, not the conversion unit's slower pipe) and the three TF32
//     products lo.hi + hi.lo + hi.hi added into a float32 accumulator, small
//     terms first, 8 rows (one k step) at a time: the float32 band (within
//     1e-4 of the largest entry of the plain float32 product over 32,768
//     rows), which one TF32 product (10 mantissa bits) does not keep;
//   * the tensor cores' float32 adds truncate, so an accumulator that walked
//     a whole split (32,768 rows at H >= 1024: 2e-4 of max|dwh| on the card)
//     drifts toward zero: each chunk of BK = 32 rows runs its 12 products
//     into a fresh accumulator, added to the block's total by a rounded
//     float32 add;
//   * r is applied before the split (__fmul_rn, the plain version's rounded
//     product); rows beyond N are zeros, columns beyond H are never stored;
//   * a block owns a BM x BM output tile of one part p (rows k of wh,
//     columns c of the part) and walks its row split in chunks;
//   * dbh from the same staged D tiles: the blocks of row tile 0 add their
//     columns over the chunk's rows, one column a thread, in row order;
//   * split-K with one partial per row split and no atomics: the split count
//     is a function of (B, T, H) only (enough blocks for two waves of an
//     H100's 132 SMs, at most one split per 256 rows, whole chunks), the K order
//     in a split is the row order, and gru_dwh_sum adds the partials in
//     split order. So dwh is bitwise equal from run to run and seed s of a
//     stack sums as it would alone. Where the tiles already fill the card
//     twice there is one split, so the partials stay below 264 x 128 x 128
//     floats a (direction, seed) or one copy of dwh;
//   * grid.z is 2 * seed + direction, as in the recurrence kernels.
//
// Which body a launch takes is `dwh_body` (H and the operands' addresses),
// one rule (the Python mirror is ops/kernels/gru_scan.py::dwh_body): the
// wgmma body where H is a multiple of 4 above WGMMA_MIN_H and every operand
// starts on a 16-byte boundary (what its tensor maps need), the mma.sync
// tile elsewhere. B and T do not choose, though the tile is as fast or
// faster up to about 512 stored rows (on an H100, B T = 128: 0.022 against
// 0.039 ms at H = 128): no path of the port runs a backward that small.
// Timed in turns on an H100 (a pair, B = 128, T = 256): at H = 36-64 the
// tile's 64-wide instantiation takes 0.069-0.070 ms against the wgmma
// body's 0.110-0.112 (a 128-wide tile mostly of zeros there); at 96 and 128
// the wgmma body 0.118 / 0.131 against 0.195 / 0.197.
//
// The wgmma body (gru_dwh_wgmma), Hopper's own tensor-core path:
//   * roles: two consumer warpgroups, each 64 rows x 128 columns of the
//     tile, run wgmma.mma_async m64n128k8 .tf32 (64 + 64 accumulator
//     registers a thread: the chunk's and the total); one producer warp
//     keeps a ring of WSTAGES chunks in flight. The roles are one if/else
//     that never reconverges, so setmaxnreg takes: the producer warpgroup
//     drops to 40 registers, the consumers rise to 232 (ptxas's report,
//     _build.ptxas_reports, shows the spills, if any);
//   * .tf32 wgmma reads K-major operands only: the transpose flags exist for
//     16-bit types alone, and both stored operands arrive MN-major (rows
//     over n, the contraction index). So A = L^T comes from registers
//     (wgmma's register-A form): each warp loads its own 16 rows x 8 k of
//     the raw L tile, applies r and splits them, so every A element is split
//     once a block. B = D is transposed once a block: a split pass of all
//     256 consumer threads reads the raw D tile (each thread a column),
//     applies r, splits, and writes hi and lo K-major into the 128-byte
//     swizzled layout the wgmma descriptor names (row c at 128 c bytes, the
//     16-byte group g of k at (g ^ (c % 8)) 16: conflict-free 16-byte
//     stores), double-buffered so that the pass over chunk ch + 1 runs while
//     the products of chunk ch are in flight; chunk ch + 1's A is loaded
//     once they are done, before the total's adds (64 + 64 + 32 registers
//     a thread; a second A set, loaded under the products, gained nothing);
//   * the two warpgroups meet on mbarriers, not on a block barrier: a B
//     buffer's "ready" (each consumer warp's part of the split written and
//     fenced for the async proxy) and "free" (each warp's products of it
//     done), so one warpgroup's total adds overlap the other's products
//     (6-8 % at H = 1024 and 2048 against one bar.sync a chunk, the same
//     bits); only a chunk with sequence starts adds a barrier of the
//     consumers, between the h0 rows' writes and the A loads;
//   * copies: three TMA boxes a chunk (cp.async.bulk.tensor, one each of L,
//     D and r, issued by one lane of the producer warp), completing on the
//     stage's mbarrier with their byte count. A box is LDR = BM + 8 columns
//     x BK rows of one seed: the 8 columns beyond the tile land as the
//     padding of a row, so the raw rows sit at a stride of 136 floats and
//     the A loads' 32 lanes fall on 32 banks. The h_prev shift is a box that
//     starts one row back (forward when reversed); a row out of bounds reads
//     as zeros, and the rows at a sequence start (several in one chunk where
//     T < 32) are h0's: the consumers overwrite them in the raw tile, one
//     pass in a chunk that has any, before they load A (read in place of
//     the row in every A element, a division and a global load predicated
//     into each, they cost 2.7 ms at H = 1024). One 1-D bulk copy a row (96
//     a chunk) held the body to the copies' rate: 8.0 of 9.6 ms at
//     H = 1024 (the phase tool's cuts);
//   * the tensor maps (ys, dxp, res as (columns, rows, seeds) per
//     direction) are host-side driver API: cuTensorMapEncodeTiled comes
//     through cudaGetDriverEntryPoint, since the kernels link no -lcuda, and
//     the maps, encoded at each launch (never cached by pointer), reach the
//     kernel as a __grid_constant__ parameter. TMA needs 16-byte strides and
//     bases, so a width that is not a multiple of 4, or an operand off a
//     16-byte boundary, goes to the tile, whose 4-byte copies take it;
//   * shared memory: a stage holds raw L, D and r, 32 x 136 floats each
//     (52,224 bytes, 3 stages), the two B buffers hi + lo 32 KB each, and
//     the ten barriers: 223,312 bytes with the 1,024-byte alignment of the
//     swizzle atoms, within the 232,448 a block may take;
//   * the order of a chunk's products is the tile body's: per k step lo.hi,
//     hi.lo, hi.hi, the first with scale-d 0 (a fresh accumulator).
//
// The mma.sync tile (gru_dwh_kernel), which the narrow widths, H not a
// multiple of 4 and operands off a 16-byte boundary keep:
//   * mma.sync m16n8k8 TF32, each warp loading and splitting its own
//     fragments; eight warps of TILE / 2 x TILE / 4: TILE = 128 (4 x 4 MMA
//     tiles a warp, 64 accumulators a thread, one block an SM), or 64 where
//     H <= 64 (2 x 2, two blocks an SM), so that a narrow width does not
//     compute a tile that is mostly zeros;
//   * the chunks staged with cp.async into a ring of STAGES = 3: 16-byte
//     copies where H is a multiple of 4, else 4-byte ones, zeros beyond N
//     and H; a row stride of TILE + 8 floats puts a fragment load's 32 lanes
//     on 32 banks.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
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

// The wgmma body's tensor maps, per direction: ys, dxp and res as
// (columns, rows, seeds) float32 tensors.
struct Maps {
  CUtensorMap ys[2];
  CUtensorMap dxp[2];
  CUtensorMap res[2];
};

constexpr int MAX_DIRS = 2;
constexpr int BM = 128;              // the block tile (BM x BM); the split plan counts these
constexpr int BM_NARROW = 64;        // the mma.sync tile where H <= BM_NARROW
constexpr int BK = 32;               // stored rows a chunk of the ring
constexpr int STAGES = 3;            // the mma.sync tile's ring: STAGES - 1 chunks in flight
constexpr int THREADS = 256;         // eight warps: 2 along the rows x 4 along the columns
constexpr int SPLIT_BLOCKS = 264;    // two waves of an H100's 132 SMs
constexpr int MIN_SPLIT_ROWS = 256;  // at most one split per MIN_SPLIT_ROWS rows
constexpr int SUM_THREADS = 256;
constexpr int WGMMA_MIN_H = 64;      // the wgmma body above this width (16-byte rows)

// The wgmma body's shape.
constexpr int CONSUMERS = 256;                    // two warpgroups of 64 x BM each
constexpr int WG_THREADS = CONSUMERS + 128;       // and the producer warpgroup
constexpr int WSTAGES = 3;                        // raw chunks in the ring
constexpr int LDR = BM + 8;                       // a raw row's stride, floats
constexpr int RAW_TILE = BK * LDR;                // floats of one raw operand a stage
constexpr int OPND_BYTES = BM * BK * 4;           // one K-major operand (hi or lo) of B
constexpr int SPLIT_BYTES = 2 * OPND_BYTES;       // B's hi and lo
constexpr int WG_SMEM = 1024 + 2 * SPLIT_BYTES + WSTAGES * 3 * RAW_TILE * 4 + 2 * WSTAGES * 8 + 4 * 8;
static_assert(WG_SMEM <= 232448, "the wgmma body fits a block's shared memory");

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
// (hi.hi) in place of three; with 2 no product (no A fragment is loaded or
// split, no MMA issued); with 3 no product and no copy of the chunks (the
// wgmma body's split pass of B alone, with the ring's waits); with 4 no
// product and no split pass (the copies alone; the tile body has no split
// pass, so 4 is its 2); with 5 the products and their A loads alone (no
// copy, no split pass); with 6 the products alone (nor the A loads). 0, the
// default, cuts nothing.
#ifndef GRU_DWH_CUT
#define GRU_DWH_CUT 0
#endif
constexpr int CUT = GRU_DWH_CUT;
constexpr bool COPIES = CUT != 3 && CUT < 5;
constexpr bool SPLIT_PASS = CUT != 4 && CUT < 5;
constexpr bool PRODUCTS = CUT < 2 || CUT >= 5;
constexpr bool A_LOADS = CUT < 2 || CUT == 5;
constexpr bool THREE_PRODUCTS = CUT != 1;

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
    if (!COPIES) return;
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
    for (int kk = 0; kk < (PRODUCTS ? BK : 0); kk += 8) {
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
      if (THREE_PRODUCTS) {
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

// The wgmma body's primitives -------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive, and expect `bytes` more of bulk copies before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` (LDR columns x BK rows of one seed) from (column c,
// row n, seed) into shared memory at `dst` (128-byte aligned), counted on
// `bar` when it lands; coordinates out of bounds read as zeros.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c, int n, int seed,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(n), "r"(seed), "r"(bar)
      : "memory");
}

// The generic proxy's writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumer warpgroups' own barrier (the producer never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// A B operand of BM rows (n) x 8 k in the 128-byte swizzled K-major layout:
// start address, leading offset 1 (unused where a row of k fits the swizzle
// width), stride 1,024 bytes between groups of 8 rows, layout type 1.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (+)= a b over 64 rows x 128 columns x 8 k: A from registers (this
// thread's fragment: rows gid and gid + 8 of its warp's 16, k tig and
// tig + 4), B from shared memory; SCALE_D 0 starts from zero.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}

// Keeps the registers of an asynchronous product where it reads or writes
// them until wgmma.wait_group has returned.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// gru_dwh_wgmma's block from its indices: its shared memory (B's hi and lo
// buffers, the raw ring, the barriers' addresses) and its work (part, tiles,
// rows, direction and seed). Each role builds its own after its setmaxnreg:
// ptxas spilled values that lived across the registers' reallocation.
struct WgBlock {
  unsigned char* bsplit;   // [2] x (hi, lo)
  float* raw;              // [WSTAGES] x (L, D, r)
  uint32_t full0, empty0, bready0, bfree0;
  int dsel, p, tm, m0, c0, n_lo, n_hi, nch, rev;
  size_t seed;
  bool scale_l, scale_d;

  __device__ __forceinline__ WgBlock(unsigned char* wsmem, const Dirs& dirs, int B, int T, int H,
                                     int reset_after, int chunk) {
    // The swizzle repeats every 1,024 bytes of the address: B's buffers
    // start on such a boundary.
    bsplit = wsmem + ((1024 - (smem_u32(wsmem) & 1023)) & 1023);
    raw = reinterpret_cast<float*>(bsplit + 2 * SPLIT_BYTES);
    const uint64_t* bars = reinterpret_cast<const uint64_t*>(raw + WSTAGES * 3 * RAW_TILE);
    full0 = smem_u32(bars);
    empty0 = smem_u32(bars + WSTAGES);
    bready0 = smem_u32(bars + 2 * WSTAGES);
    bfree0 = bready0 + 16;
    dsel = blockIdx.z & 1;
    seed = blockIdx.z >> 1;
    const long long N = (long long)B * T;
    const int tiles = (int)cdiv(H, BM);
    p = blockIdx.x / (tiles * tiles);
    tm = (blockIdx.x / tiles) % tiles;
    m0 = tm * BM;
    c0 = (blockIdx.x % tiles) * BM;
    n_lo = blockIdx.y * chunk;
    n_hi = (long long)n_lo + chunk < N ? n_lo + chunk : (int)N;
    scale_l = p == 2 && !reset_after;
    scale_d = p == 2 && reset_after;
    nch = (int)cdiv(n_hi - n_lo, BK);
    rev = PICK(reverse);
  }
};

// The wgmma body: block (part p, row tile tm, column tile tn) of split
// blockIdx.y, for direction and seed blockIdx.z, as gru_dwh_kernel's.
// Warps 0-7 consume (warpgroup g the tile's rows 64 g .. + 64, warp w % 4 of
// it 16 of those), warp 8 produces, warps 9-11 only give up registers.
__global__ void __launch_bounds__(WG_THREADS, 1)
    gru_dwh_wgmma(const __grid_constant__ Maps maps, Dirs dirs, int B, int T, int H,
                  int reset_after, int chunk, int nsplit) {
  extern __shared__ unsigned char wsmem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    const WgBlock blk(wsmem, dirs, B, T, H, reset_after, chunk);
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(blk.full0 + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(blk.empty0 + 8 * s, CONSUMERS / 32);
    }
    // B buffer j: ready (its split written: 8 warp arrivals), free (both
    // warpgroups' products done reading it: 8 warp arrivals).
    for (int j = 0; j < 2; ++j) {
      mbar_init(blk.bready0 + 8 * j, CONSUMERS / 32);
      mbar_init(blk.bfree0 + 8 * j, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // The producer warpgroup: warp 8 keeps the ring full, its lane 0 by
    // three tensor-map boxes a chunk.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == CONSUMERS / 32) {
      const WgBlock blk(wsmem, dirs, B, T, H, reset_after, chunk);
      const int r0 = blk.scale_l ? blk.m0 : blk.c0;   // the r tile's first column
      const uint32_t box_bytes = (blk.scale_l || blk.scale_d ? 3u : 2u) * RAW_TILE * 4u;
      for (int ch = 0; ch < blk.nch; ++ch) {
        const int s = ch % WSTAGES;
        const uint32_t full = blk.full0 + 8 * s;
        if (ch >= WSTAGES) mbar_wait(blk.empty0 + 8 * s, (ch / WSTAGES - 1) & 1);
        const int n0 = blk.n_lo + ch * BK;
        float* sl = blk.raw + s * 3 * RAW_TILE;
        if (lane != 0) continue;
        if (!COPIES) {
          mbar_arrive(full);
          continue;
        }
        // L's box starts a row back (forward on the reversed direction):
        // h_prev; the consumers write h0's rows over those at a sequence
        // start.
        const int seed = (int)blk.seed;
        mbar_expect_tx(full, box_bytes);
        tma_box(smem_u32(sl), &maps.ys[blk.dsel], blk.m0, n0 + (blk.rev ? 1 : -1), seed, full);
        tma_box(smem_u32(sl + RAW_TILE), &maps.dxp[blk.dsel], blk.p * H + blk.c0, n0, seed, full);
        if (blk.scale_l || blk.scale_d)
          tma_box(smem_u32(sl + 2 * RAW_TILE), &maps.res[blk.dsel], r0, n0, seed, full);
      }
    }
  } else {
    // The consumers.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const WgBlock blk(wsmem, dirs, B, T, H, reset_after, chunk);
    unsigned char* const bsplit = blk.bsplit;
    float* const raw = blk.raw;
    const uint32_t full0 = blk.full0, empty0 = blk.empty0;
    const uint32_t bready0 = blk.bready0, bfree0 = blk.bfree0;
    const int dsel = blk.dsel, tm = blk.tm, m0 = blk.m0, c0 = blk.c0, p = blk.p;
    const int n_lo = blk.n_lo, n_hi = blk.n_hi, nch = blk.nch, rev = blk.rev;
    const bool scale_l = blk.scale_l, scale_d = blk.scale_d;
    const size_t seed = blk.seed;
    const int H3 = 3 * H;
    const float* h0 = PICK(h0) + seed * B * H;
    const int gid = lane >> 2, tig = lane & 3;
    const int arow = (warp / 4) * 64 + (warp % 4) * 16 + gid;   // this thread's A rows: + 0, + 8
    const int bc = tid & (BM - 1);       // the column of B this thread splits
    const int bg = (tid / BM) * 4;       // its first group of 4 k (rows of the chunk)
    const bool bias = tm == 0 && reset_after && tid < BM;
    float bsum = 0.f;
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
    uint32_t ah[4][4], al[4][4];   // A's hi and lo [k step][fragment]

    // Chunk ch's B (D, times r when scale_d) split into hi and lo, K-major
    // and swizzled, into buffer ch % 2; and the bias columns' sums.
    auto split_b = [&](int ch) {
      const int s = ch % WSTAGES;
      mbar_wait(full0 + 8 * s, (ch / WSTAGES) & 1);
      if (!SPLIT_PASS) return;
      const float* sd = raw + s * 3 * RAW_TILE + RAW_TILE;
      const float* sr = sd + RAW_TILE;
      const int valid = min(BK, n_hi - (n_lo + ch * BK));
      unsigned char* hi = bsplit + (ch & 1) * SPLIT_BYTES;
#pragma unroll
      for (int g = bg; g < bg + 4; ++g) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = 4 * g + i;
          float x = k < valid ? sd[k * LDR + bc] : 0.f;
          if (scale_d && k < valid) x = __fmul_rn(x, sr[k * LDR + bc]);
          split(x, h[i], l[i]);
        }
        const int off = bc * 128 + ((g ^ (bc & 7)) << 4);
        *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(hi + OPND_BYTES + off) = make_uint4(l[0], l[1], l[2], l[3]);
      }
      if (bias) {
        for (int k = 0; k < valid; ++k) {
          const float d = sd[k * LDR + tid];
          bsum = __fadd_rn(bsum, scale_d ? __fmul_rn(d, sr[k * LDR + tid]) : d);
        }
      }
    };

    // The rows of chunk ch's raw L tile at a sequence start (t = 0, or
    // T - 1 reversed) overwritten by h0[b]: one pass a chunk that has such
    // rows (the same for the whole block), half the rows by each warpgroup;
    // true if it wrote any, and then the caller syncs the consumers.
    auto patch_starts = [&](int ch) {
      const int n0 = n_lo + ch * BK;
      const int valid = min(BK, n_hi - n0);
      const int t0 = n0 % T;
      int k = rev ? T - 1 - t0 : (T - t0) % T;
      if (k >= valid) return false;
      float* sl = raw + (ch % WSTAGES) * 3 * RAW_TILE;
      const int c = tid & (BM - 1);
      for (int j = 0; k < valid; k += T, ++j)
        if ((j & 1) == tid / BM)
          sl[k * LDR + c] = m0 + c < H ? h0[(size_t)((n0 + k) / T) * H + m0 + c] : 0.f;
      fence_async_smem();   // before the stage's next TMA writes
      return true;
    };

    // Chunk ch's A fragments (L, times r when scale_l) split in registers.
    auto load_a = [&](int ch) {
      const float* sl = raw + (ch % WSTAGES) * 3 * RAW_TILE;
      const float* sr = sl + 2 * RAW_TILE;
      const int valid = min(BK, n_hi - (n_lo + ch * BK));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = ks * 8 + tig + 4 * (v >> 1), m = arow + 8 * (v & 1);
          float x = k < valid ? sl[k * LDR + m] : 0.f;
          if (scale_l && k < valid) x = __fmul_rn(x, sr[k * LDR + m]);
          split(x, ah[ks][v], al[ks][v]);
        }
    };

    // B of chunk ch written into buffer ch % 2: this warp's part published.
    auto publish_b = [&](int ch) {
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(bready0 + 8 * (ch & 1));
    };

    // Chunk ch's products into a fresh accumulator, with chunk ch + 1's B
    // split while they run; then chunk ch + 1's A loaded, and the
    // accumulator added into the total.
    auto step = [&](int ch) {
      if (PRODUCTS) {
        mbar_wait(bready0 + 8 * (ch & 1), (ch >> 1) & 1);
        const uint32_t hb = smem_u32(bsplit + (ch & 1) * SPLIT_BYTES), lb = hb + OPND_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t dh = b_desc(hb + 32 * ks), dl = b_desc(lb + 32 * ks);
          if (THREE_PRODUCTS) {
            if (ks == 0) wgmma_tf32<0>(acc, al[ks], dh);
            else wgmma_tf32<1>(acc, al[ks], dh);
            wgmma_tf32<1>(acc, ah[ks], dl);
            wgmma_tf32<1>(acc, ah[ks], dh);
          } else if (ks == 0) {
            wgmma_tf32<0>(acc, ah[ks], dh);
          } else {
            wgmma_tf32<1>(acc, ah[ks], dh);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      }
      if (ch + 1 < nch) {   // while the products run
        if (ch >= 1) mbar_wait(bfree0 + 8 * ((ch + 1) & 1), ((ch - 1) >> 1) & 1);
        split_b(ch + 1);
        publish_b(ch + 1);
        if (patch_starts(ch + 1)) consumers_sync();
      }
      if (PRODUCTS) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        hold(acc);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          hold(ah[ks]);
          hold(al[ks]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bfree0 + 8 * (ch & 1));   // this warp's products of chunk ch read B
      if (ch + 1 < nch) {
        if (A_LOADS) load_a(ch + 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * ((ch + 1) % WSTAGES));   // done with the stage
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
    };

    split_b(0);
    publish_b(0);
    if (patch_starts(0)) consumers_sync();
    if (A_LOADS) load_a(0);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0);
    for (int ch = 0; ch < nch; ++ch) step(ch);

    float* out = PICK(part) + (seed * nsplit + blockIdx.y) * ((size_t)H * H3 + H3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = m0 + arow + 8 * h, c = c0 + 8 * j + 2 * tig;
        if (k >= H) continue;
        float* orow = out + (size_t)k * H3 + (size_t)p * H;
        if (c < H) orow[c] = tot[4 * j + 2 * h];
        if (c + 1 < H) orow[c + 1] = tot[4 * j + 2 * h + 1];
      }
    if (tm == 0 && tid < BM && c0 + tid < H)
      out[(size_t)H * H3 + (size_t)p * H + c0 + tid] = reset_after ? bsum : 0.f;
  }
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

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query: the kernels' libraries link no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// The map of `nseed` (rows, cols) float32 tensors from `base`, in boxes of
// LDR columns x BK rows x 1 seed: the 8 columns beyond the tile's BM give
// the padded row stride, and rows or columns beyond the tensor read as zeros.
bool encode(EncodeTiled fn, CUtensorMap* map, const float* base, long long rows, long long cols,
            int nseed) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)nseed};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)(rows * cols * 4)};
  const cuuint32_t box[3] = {LDR, BK, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch of the wgmma body over every (part, tile, split, direction and
// seed), its tensor maps encoded for this launch's operands.
int launch_wgmma(const Dirs& d, int ndir, int nseed, int B, int T, int H, int reset_after,
                 int chunk, int nsplit, cudaStream_t s) {
  const void* fn = (const void*)gru_dwh_wgmma;
  const cudaError_t err = opt_in(fn, WG_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled enc = encoder();
  if (!enc) return static_cast<int>(cudaErrorNotSupported);
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const long long N = (long long)B * T;
  for (int i = 0; i < ndir; ++i)
    if (!encode(enc, &maps.ys[i], d.d[i].ys, N, H, nseed) ||
        !encode(enc, &maps.dxp[i], d.d[i].dxp, N, 3LL * H, nseed) ||
        !encode(enc, &maps.res[i], d.d[i].res, N, reset_after ? 4LL * H : 3LL * H, nseed))
      return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = cdiv(H, BM);
  gru_dwh_wgmma<<<dim3((unsigned)(3 * tiles * tiles), nsplit, ndir * nseed), WG_THREADS, WG_SMEM,
                  s>>>(maps, d, B, T, H, reset_after, chunk, nsplit);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Whether every operand's row is whole 16-byte groups on 16-byte
// boundaries: H a multiple of 4 and each pointer aligned.
bool rows16(const DwhDir* dirs, int ndir, int H) {
  bool vec = H % 4 == 0;
  for (int i = 0; i < ndir; ++i)
    vec = vec && aligned16(dirs[i].ys) && aligned16(dirs[i].res) && aligned16(dirs[i].h0) &&
          aligned16(dirs[i].dxp);
  return vec;
}

// Which body reduces H-wide operands `dirs`: 1 the wgmma body, 0 the
// mma.sync tile.
int dwh_body(const DwhDir* dirs, int ndir, int H) {
  return H > WGMMA_MIN_H && rows16(dirs, ndir, H) ? 1 : 0;
}

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

// Which body gru_dwh_launch runs on the ndir directions' operands `dirs` of
// width H: 1 the wgmma body, 0 the mma.sync tile.
int gru_dwh_body(const DwhDir* dirs, int ndir, int H) {
  if (ndir < 1 || ndir > MAX_DIRS) return 0;
  return dwh_body(dirs, ndir, H);
}

// ndir (1 or 2) directions of nseed seeds (nseed > 1 only with both), each
// ys (nseed, B, T, H), res (nseed, B, T, RW), h0 (nseed, B, H), dxp (nseed,
// B, T, 3H) -> part (nseed, gru_dwh_splits(B, T, H), 3H * H + 3H): per
// split, dwh (row-major (H, 3H)) then dbh (zeros unless reset_after);
// float32, contiguous, on the device of `stream`; on the body gru_dwh_body
// gives.
int gru_dwh_launch(const DwhDir* dirs, int ndir, int nseed, int B, int T, int H, int reset_after,
                   void* stream) {
  if (ndir < 1 || ndir > MAX_DIRS || nseed < 1 || (nseed > 1 && ndir != MAX_DIRS) || B <= 0 ||
      T <= 0 || H <= 0 || (long long)ndir * nseed > 65535 || (long long)B * T >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int nsplit = 1, chunk = BK;
  split_plan(B, T, H, &nsplit, &chunk);
  Dirs d = {};
  for (int i = 0; i < ndir; ++i) d.d[i] = dirs[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dwh_body(dirs, ndir, H))
    return launch_wgmma(d, ndir, nseed, B, T, H, reset_after, chunk, nsplit, s);
  const int vec = rows16(dirs, ndir, H);
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
