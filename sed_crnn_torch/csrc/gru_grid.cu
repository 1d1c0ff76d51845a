// GRU recurrence for Hopper (sm_90a) at hidden widths above the cluster
// body's (H > gru_cluster_max_h(), 512): the grid tier of kernel B, one
// persistent cooperative grid whose CTAs hold a direction's recurrent
// weights spread over every SM's shared memory.
//
// Replaces, in that range, the TPU kernels of
// sed_crnn_tpu/ops/pallas/gru_scan.py:
//   * `_fwd_kernel` with with_res=False (`gru_scan_tc`) and with_res=True
//     (`_gru_fwd`): gru_grid_fwd<SPLIT, RB, UL, false / true>;
//   * `_bwd_kernel` (`_gru_bwd`): its gradient chain (dxp and dh0),
//     gru_grid_bwd<SPLIT, RB, UL>; dwh and dbh are reduced after it from the
//     stored rows by gru_dwh_kernel and gru_dwh_sum (csrc/gru_dwh.cu).
// The contract is csrc/gru_wide.cu's: pre-projected inputs xp = x @ wi + bi
// (B, T, 3H), recurrent kernel wh (H, 3H) in gate order (reset, update,
// candidate), bias bh (3H) read only when reset_after, initial state h0
// (B, H) -> ys (B, T, H), h_last (B, H) and, with residuals, res (B, T, RW)
// = r | z | n (| hn when reset_after); both conventions, the logistic
// sigmoid or keras-2.2 hard_sigmoid gate, reverse time, one or two
// directions and S seeds per launch.
//
// What bounds it: operations at large B, latency at small B. A step of one
// direction is a (B, H) x (H, 3H) product; at H = 1024, B = 128, T = 256 a
// pair's residual forward is 412 GFLOP, 6.15 ms at the card's 67 TFLOP/s
// float32. One direction's wh is 12 H^2 bytes, 12.6 MB at H = 1024: no
// cluster's shared memory holds it (16 CTAs hold 3.6 MB), the card's 132
// SMs together do (30 MB).
//
// What the design does about it:
//   * one CTA an SM, launched cooperatively (cudaLaunchCooperativeKernel),
//     so that a grid the card cannot hold at once is refused with an error,
//     never run into a spin barrier that cannot complete. K CTAs serve each
//     direction; CTA c owns hidden units [c U, (c + 1) U), U = ceil(H / K),
//     laid out as UP (a power of two, 8 .. 256) units: their three gate
//     columns of wh in the forward, their rows of wh in the backward chain,
//     (3 UP) weight vectors over k. The S seeds of a stack take turns in the
//     same CTAs within the launch;
//   * weights resident in shared memory for the whole sequence where the
//     slice and the smallest state ring fit (a pair to H = 1056 on 132 SMs,
//     66 CTAs of 16 units), else streamed each step with the state, chunk
//     by chunk, through the same cp.async ring. A CTA lays out at most
//     UP_MAX units at once: where a direction's SMs need more (a pair above
//     H = 66 x 256 = 16,896 on 132 SMs, one direction above 33,792) each of
//     its K CTAs walks its U units in blocks of UP_MAX through the streamed
//     tile body, one product of the step's rows per block, so every width
//     whose operands fit in the card's memory has a plan;
//   * the step's exchange: each CTA writes its units' new values for every
//     row into a double-buffered state in device memory (B x HP floats,
//     512 KB at B = 128, H = 1024, which L2 keeps) and passes its
//     direction's barrier (red.release.gpu of a counter, ld.acquire.gpu spin
//     until K arrivals); the next product reads every row back from L2
//     (cp.async.cg, never through L1). reset_after=False exchanges r h
//     before the candidate's product: two barriers a step. The backward
//     chain exchanges the three gate-gradient rows. The two directions
//     never wait on each other;
//   * the products: each unit's dot product over k is split into SLABS = 8
//     slabs of HP / 8 (HP = H rounded up to 32); a slab is one chain of
//     fused multiply-adds in k order and the slabs are added in order,
//     ((p0 + p1) + p2) + ... + p7. So the bits depend on H alone: not on K,
//     the rows a pass, B, S, or resident against streamed. Two bodies walk
//     that order:
//       - the tile body (SPLIT = 1, any B): a thread holds a register tile
//         of RB (<= 4) rows x 2 units x 3 gates and walks every slab in
//         turn, so one shared-memory read of a weight serves RB rows and one
//         read of a state value six columns (ten 16-byte reads for 96 FMAs
//         at RB = 4; 4 units x 2 rows took 14 and ran 1.2x slower at H =
//         1024, B = 128); the state rows arrive in chunks of KC = 16 k
//         through a ring of 2 or 3 stages (6 ran no faster);
//       - the lanes body (SPLIT = 8, B <= LANES_MAX_B, weights resident):
//         eight consecutive lanes take one slab each of the same RB rows x 1
//         unit x 3 gates and add their partials in slab order by shuffles,
//         so a small batch's step is HP / 8 k long, not HP;
//   * float32 FMAs, no tensor cores: the forward is held to 1e-5 of the
//     plain version.

#include <cuda_runtime.h>
#include <math.h>

#include <initializer_list>
#include <mutex>
#include <vector>

// One direction's operands, laid out as in csrc/gru_wide.cu.
struct FwdDir {
  const float* xp;
  const float* wh;
  const float* bh;
  const float* h0;
  float* ys;
  float* res;
  float* h_last;
  int reverse;
};

struct BwdDir {
  const float* ys;
  const float* res;
  const float* wh;
  const float* h0;
  const float* dys;
  const float* dhl;
  float* dxp;
  float* dh0;
  int reverse;
};

namespace {

constexpr int MAX_DIRS = 2;
constexpr int THREADS = 256;
constexpr int SLABS = 8;              // slabs of a dot product, added in order
constexpr int KC = 16;                // k a chunk of the tile body's ring
constexpr int KCP = KC + 4;           // a chunk row, padded against bank conflicts
constexpr int LANES_MAX_B = 16;       // widest batch the lanes body takes
constexpr int MAX_SMEM = 232448;      // 227 KB, the opt-in limit of a CTA
constexpr int UP_MIN = 8;             // units a CTA, padded: 8 .. UP_MAX
constexpr int UP_MAX = 256;
constexpr int COUNTER_FLOATS = 64;    // the scratch's head: one barrier counter a direction
constexpr int TILE_UNITS = 2;         // units a thread of the tile body, up to 4 rows
constexpr int MAX_STAGES = 3;         // the tile body's deepest ring
constexpr int NO_PLAN = -1;           // status: no plan of this shape

// Profiling cuts, for sed_crnn_torch/tools/gru_phases.py only (the results
// are then wrong): built with -DGRU_GRID_CUT=1 the barriers wait for no
// other CTA; with 2 the products are also left out; with 3 also the loads of
// the state rows and streamed weight chunks. 0, the default, cuts nothing.
#ifndef GRU_GRID_CUT
#define GRU_GRID_CUT 0
#endif
constexpr int CUT = GRU_GRID_CUT;

template <typename D>
struct Dirs {
  D d[MAX_DIRS];
};

// A field of this block's direction `dsel`, selected field by field so that
// the kernel never copies a whole direction struct to local memory.
#define PICK(field) (dsel ? a.dirs.d[1].field : a.dirs.d[0].field)

// The launch plan: K CTAs a direction of U units (walked in blocks of UP,
// the padded units a CTA lays out: one block unless U > UP_MAX), state rows HP
// floats in HS-float slabs (SS apart in the lanes body's layout), the body
// (split 8: lanes, 1: tile), RB rows a thread and RT rows a pass, the ring's
// stages (tile body), and whether the weights stay resident.
struct Plan {
  int K, U, UP, HP, HS, SS, split, RB, RT, stages, resident, threads;
  long long smem;
};

struct FwdArgs {
  Dirs<FwdDir> dirs;
  int nseed, B, T, H, reset_after, hard;
  Plan p;
  float* scratch;
  unsigned* counters;
};

struct BwdArgs {
  Dirs<BwdDir> dirs;
  int nseed, B, T, H, reset_after, hard;
  Plan p;
  float* scratch;
  unsigned* counters;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ int round_up(int a, int m) { return cdiv(a, m) * m; }

// Scratch floats a direction: the forward's state rows [2][B][HP], r h rows
// [B][HP] and its units' r, z [B][2][H]; the backward's gate-gradient rows
// [2][3][B][HP], dh carry [B][H] and step values [B][3][H]; rounded up to
// 32 floats, so that every direction's rows start 128-byte aligned.
__host__ __device__ __forceinline__ long long dir_scratch(int B, int H, int HP, bool backward) {
  const long long n = backward ? 6LL * B * HP + 4LL * B * H : 3LL * B * HP + 2LL * B * H;
  return (n + 31) / 32 * 32;
}

__device__ __forceinline__ float gate(float v, int hard) {
  return hard ? fminf(fmaxf(fmaf(0.2f, v, 0.5f), 0.0f), 1.0f)
              : __fdividef(1.0f, 1.0f + __expf(-v));
}

__device__ __forceinline__ float tanh_fast(float v) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * v));
}

// d gate / d pre-activation from the gate's output value.
__device__ __forceinline__ float gate_grad(float g, int hard) {
  return hard ? ((g > 0.0f && g < 1.0f) ? 0.2f : 0.0f) : g * (1.0f - g);
}

// (1 - z) n + z h, rounded product by product as the plain version.
__device__ __forceinline__ float blend(float z, float n, float h) {
  return __fadd_rn(__fmul_rn(1.0f - z, n), __fmul_rn(z, h));
}

// 16 bytes from device memory into shared memory through L2 only (rows that
// other CTAs wrote during the launch), 4 bytes through L1 (weights).
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

// Wait until at most stages - 2 chunk groups are in flight (2 or 3 stages).
__device__ __forceinline__ void wait_ring(int stages) {
  if (stages == 2)
    cp_async_wait<0>();
  else
    cp_async_wait<1>();
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void zero4(float* p) {
  *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void fma4(const float4 v, const float4 w, float& a) {
  a = fmaf(v.x, w.x, a);
  a = fmaf(v.y, w.y, a);
  a = fmaf(v.z, w.z, a);
  a = fmaf(v.w, w.w, a);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The direction's barrier: every write of the K CTAs before it is seen by
// every thread of them after it. `target` counts the arrivals so far.
__device__ __forceinline__ void dir_barrier(unsigned* ctr, unsigned& target, int K) {
  __syncthreads();
  target += K;
  if (CUT < 1 && threadIdx.x == 0) {
    __threadfence();
    red_release(ctr, 1u);
    while (ld_acquire(ctr) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// A CTA's view of the plan: its units [base, base + units), walked in nub
// blocks of UP; lo and own are the current block's first unit and count.
struct Geo {
  int B, H, HP, HS, SS, UP, U, base, units, nub, lo, own, RT, WS, stages, resident;
  int sl, ug, rg, NUG, NRG;
  float* s_w;    // resident weights [3 UP][WS]
  float* s_x;    // lanes: the pass's rows [NG][RT][WS]; tile: the state ring
  float* s_wr;   // tile, streamed: the weight ring
};

template <int SPLIT, int UL>
__device__ __forceinline__ void make_geo(Geo& g, const Plan& p, int B, int H, int c, int G,
                                         float* smem) {
  g.B = B;
  g.H = H;
  g.HP = p.HP;
  g.HS = p.HS;
  g.SS = p.SS;
  g.UP = p.UP;
  g.U = p.U;
  g.base = c * p.U;
  g.units = min(p.U, H - g.base);
  g.nub = max(1, cdiv(g.units, p.UP));
  g.lo = g.base;
  g.own = min(p.UP, g.units);
  g.RT = p.RT;
  g.stages = p.stages;
  g.resident = p.resident;
  g.WS = SPLIT > 1 ? SLABS * p.SS + 4 : p.HP + 4;
  const int tid = threadIdx.x;
  g.sl = tid % SPLIT;
  g.NUG = p.UP / UL;
  g.NRG = THREADS / SPLIT / g.NUG;
  g.ug = (tid / SPLIT) % g.NUG;
  g.rg = (tid / SPLIT) / g.NUG;
  g.s_w = smem;
  g.s_x = g.s_w + (p.resident ? 3 * p.UP * g.WS : 0);
  g.s_wr = g.s_x + (SPLIT > 1 ? G * p.RT * g.WS : p.stages * G * p.RT * KCP);
}

// Make unit block ub (of UP units) the CTA's current one.
__device__ __forceinline__ void unit_block(Geo& g, int ub) {
  g.lo = g.base + ub * g.UP;
  g.own = min(g.UP, g.units - ub * g.UP);
}

// The shared-memory offset of weight (or row) element k in the body's
// layout: k contiguous (tile), or slab by slab SS apart (lanes).
template <int SPLIT>
__device__ __forceinline__ int koff(const Geo& g, int k) {
  return SPLIT > 1 ? (k / g.HS) * g.SS + k % g.HS : k;
}

// The seed's weight vectors of this CTA's units into shared memory: vector
// (gate gg, unit u) element k is src[gg H + k ks + u us] (forward: ks = 3H,
// us = 1, the columns of wh; backward: ks = 1, us = 3H, its rows).
template <int SPLIT>
__device__ __forceinline__ void load_weights(const Geo& g, const float* src, int ks, int us) {
  const int n = 3 * g.UP * g.HP;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    int u, k, gg;
    if (us == 1) {
      u = e % g.UP;
      gg = (e / g.UP) % 3;
      k = e / (3 * g.UP);
    } else {
      k = e % g.HP;
      u = (e / g.HP) % g.UP;
      gg = e / (g.HP * g.UP);
    }
    const bool ok = u < g.own && k < g.H;
    g.s_w[(gg * g.UP + u) * g.WS + koff<SPLIT>(g, k)] =
        ok ? __ldg(src + (size_t)gg * g.H + (size_t)k * ks + (size_t)u * us) : 0.f;
  }
}

template <int NG>
__device__ __forceinline__ const float* pick_row(const float* const (&rows)[NG], int i) {
  if constexpr (NG == 1) {
    return rows[0];
  } else if constexpr (NG == 2) {
    return i == 0 ? rows[0] : rows[1];
  } else {
    return i == 0 ? rows[0] : i == 1 ? rows[1] : rows[2];
  }
}

template <int RB, int NC>
__device__ __forceinline__ void flush(float (&o)[RB][NC], float (&part)[RB][NC], int slab) {
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      o[r][n] = slab == 0 ? part[r][n] : o[r][n] + part[r][n];
      part[r][n] = 0.f;
    }
}

// The tile body's products of one pass (rows b0 .. b0 + RT - 1): thread
// (ug, rg) sums, for rows rg + NRG r (r < RB) and the columns of gates
// `gates` of its units ug + NUG cc (cc < UL), o[r][gi UL + cc] = the dot
// product of row set `rows[gi]` (or rows[0] when NG == 1; each [B][HP] in
// device memory) with that weight vector. Streamed weights come from wsrc
// (see load_weights).
template <int RB, int UL, int NGATE, int NG>
__device__ __forceinline__ void tile_product(const Geo& g, const float* const (&rows)[NG],
                                             const int (&gates)[NGATE], int b0, const float* wsrc,
                                             int ks, int us, float (&o)[RB][NGATE * UL]) {
  constexpr int NC = NGATE * UL;
  constexpr int Q4 = KC / 4;
  const int tid = threadIdx.x;
  const int wstride = g.resident ? g.WS : KCP;
  int woff[NC];
#pragma unroll
  for (int gi = 0; gi < NGATE; ++gi)
#pragma unroll
    for (int cc = 0; cc < UL; ++cc)
      woff[gi * UL + cc] = (gates[gi] * g.UP + g.ug + g.NUG * cc) * wstride;
  float part[RB][NC];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      part[r][n] = 0.f;
      o[r][n] = 0.f;
    }
  const int nch = g.HP / KC;
  const int slot_x = NG * g.RT * KCP, slot_w = 3 * g.UP * KCP;
  auto issue = [&](int ch) {
    if (CUT < 3 && ch < nch) {
      float* dx = g.s_x + (ch % g.stages) * slot_x;
      for (int e = tid; e < NG * g.RT * Q4; e += THREADS) {
        const int q = e % Q4, r = (e / Q4) % g.RT, gs = e / (Q4 * g.RT);
        const int b = b0 + r;
        float* dst = dx + (gs * g.RT + r) * KCP + 4 * q;
        if (b < g.B)
          cp16(dst, pick_row<NG>(rows, gs) + (size_t)b * g.HP + ch * KC + 4 * q);
        else
          zero4(dst);
      }
      if (!g.resident) {
        float* dw = g.s_wr + (ch % g.stages) * slot_w;
        for (int e = tid; e < 3 * g.UP * KC; e += THREADS) {
          int u, kk, gg;
          if (us == 1) {
            u = e % g.UP;
            kk = (e / g.UP) % KC;
            gg = e / (g.UP * KC);
          } else {
            kk = e % KC;
            u = (e / KC) % g.UP;
            gg = e / (KC * g.UP);
          }
          const int k = ch * KC + kk;
          float* dst = dw + (gg * g.UP + u) * KCP + kk;
          if (u < g.own && k < g.H)
            cp4(dst, wsrc + (size_t)gg * g.H + (size_t)k * ks + (size_t)u * us);
          else
            *dst = 0.f;
        }
      }
    }
    cp_async_commit();
  };
  __syncthreads();   // the ring's readers of the last product are done
  for (int s = 0; s < g.stages - 1; ++s) issue(s);
  int slab = 0, slab_end = g.HS;
  for (int ch = 0; ch < nch; ++ch) {
    wait_ring(g.stages);   // this thread's copies of chunk ch have landed
    __syncthreads();       // everyone's, and everyone is done with chunk ch - 1
    issue(ch + g.stages - 1);
    const float* xs = g.s_x + (ch % g.stages) * slot_x;
    const float* ws = g.resident ? g.s_w + ch * KC : g.s_wr + (ch % g.stages) * slot_w;
#pragma unroll
    for (int q = 0; q < Q4; ++q) {
      if (ch * KC + 4 * q == slab_end) {
        flush<RB, NC>(o, part, slab);
        ++slab;
        slab_end += g.HS;
      }
      if (CUT < 2) {
        float4 xv[NG][RB];
#pragma unroll
        for (int gs = 0; gs < NG; ++gs)
#pragma unroll
          for (int r = 0; r < RB; ++r)
            xv[gs][r] = ld4(xs + (gs * g.RT + g.rg + g.NRG * r) * KCP + 4 * q);
#pragma unroll
        for (int gi = 0; gi < NGATE; ++gi)
#pragma unroll
          for (int cc = 0; cc < UL; ++cc) {
            const float4 w = ld4(ws + woff[gi * UL + cc] + 4 * q);
#pragma unroll
            for (int r = 0; r < RB; ++r) fma4(xv[NG == 1 ? 0 : gi][r], w, part[r][gi * UL + cc]);
          }
      }
    }
  }
  flush<RB, NC>(o, part, slab);
  cp_async_wait<0>();
}

// The lanes body's products of one pass: the pass's rows, whole, into
// shared memory in the slab layout; lane sl of each group of eight sums slab
// sl of the dot products of rows rg + NRG r with its units' vectors, then
// the eight partials are added in slab order (every lane of the group ends
// with the same bits). Weights resident.
template <int RB, int UL, int NGATE, int NG>
__device__ __forceinline__ void lanes_product(const Geo& g, const float* const (&rows)[NG],
                                              const int (&gates)[NGATE], int b0,
                                              float (&o)[RB][NGATE * UL]) {
  constexpr int NC = NGATE * UL;
  const int tid = threadIdx.x;
  __syncthreads();   // the last pass's readers of the rows are done
  if (CUT < 3) {
    const int q4 = g.HP / 4;
    for (int e = tid; e < NG * g.RT * q4; e += THREADS) {
      const int q = e % q4, r = (e / q4) % g.RT, gs = e / (q4 * g.RT);
      const int k = 4 * q, b = b0 + r;
      float* dst = g.s_x + (gs * g.RT + r) * g.WS + koff<SLABS>(g, k);
      if (b < g.B)
        cp16(dst, pick_row<NG>(rows, gs) + (size_t)b * g.HP + k);
      else
        zero4(dst);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  int woff[NC];
#pragma unroll
  for (int gi = 0; gi < NGATE; ++gi)
#pragma unroll
    for (int cc = 0; cc < UL; ++cc)
      woff[gi * UL + cc] = (gates[gi] * g.UP + g.ug + g.NUG * cc) * g.WS;
  float part[RB][NC];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) part[r][n] = 0.f;
  const float* xb = g.s_x + g.sl * g.SS;
  const float* wb = g.s_w + g.sl * g.SS;
  if (CUT < 2) {
#pragma unroll 2
    for (int kk = 0; kk < g.HS; kk += 4) {
      float4 xv[NG][RB];
#pragma unroll
      for (int gs = 0; gs < NG; ++gs)
#pragma unroll
        for (int r = 0; r < RB; ++r) xv[gs][r] = ld4(xb + (gs * g.RT + g.rg + g.NRG * r) * g.WS + kk);
#pragma unroll
      for (int gi = 0; gi < NGATE; ++gi)
#pragma unroll
        for (int cc = 0; cc < UL; ++cc) {
          const float4 w = ld4(wb + woff[gi * UL + cc] + kk);
#pragma unroll
          for (int r = 0; r < RB; ++r) fma4(xv[NG == 1 ? 0 : gi][r], w, part[r][gi * UL + cc]);
        }
    }
  }
  const int base = (tid & 31) & ~(SLABS - 1);
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float v = part[r][n];
      float s = __shfl_sync(0xffffffffu, v, base);
#pragma unroll
      for (int l = 1; l < SLABS; ++l) s += __shfl_sync(0xffffffffu, v, base + l);
      o[r][n] = s;
    }
}

template <int SPLIT, int RB, int UL, int NGATE, int NG>
__device__ __forceinline__ void product(const Geo& g, const float* const (&rows)[NG],
                                        const int (&gates)[NGATE], int b0, const float* wsrc,
                                        int ks, int us, float (&o)[RB][NGATE * UL]) {
  if constexpr (SPLIT == 1) {
    tile_product<RB, UL, NGATE, NG>(g, rows, gates, b0, wsrc, ks, us, o);
  } else {
    lanes_product<RB, UL, NGATE, NG>(g, rows, gates, b0, o);
  }
}

// Entry (r, cc) of a thread: row b0 + rg + NRG r, unit ug + NUG cc; the
// lanes body spreads a group's entries over its eight lanes.
template <int SPLIT, int UL>
__device__ __forceinline__ bool mine(const Geo& g, int r, int cc) {
  return SPLIT == 1 || (r * UL + cc) % SPLIT == g.sl;
}

// Zero the padding columns [H, HP) of `nrows` exchanged rows of HP floats:
// the products read them, no CTA writes them.
__device__ __forceinline__ void zero_padding(float* rows, long long nrows, int H, int HP, int c,
                                             int K) {
  const int pad = HP - H;
  if (pad == 0) return;
  for (long long e = (long long)c * THREADS + threadIdx.x; e < nrows * pad;
       e += (long long)K * THREADS)
    rows[(e / pad) * HP + H + e % pad] = 0.f;
}

// Forward: the K CTAs of blockIdx.x / K serve that direction; per seed, per
// step, per pass of RT rows: the gate products of the state rows, then the
// units' new values into the exchanged state, ys, res and h_last.
template <int SPLIT, int RB, int UL, bool WITH_RES>
__global__ void __launch_bounds__(THREADS, 1) gru_grid_fwd(const FwdArgs a) {
  extern __shared__ float4 smem4[];
  const int K = a.p.K;
  const int dsel = blockIdx.x / K, c = blockIdx.x % K;
  const int B = a.B, T = a.T, H = a.H, H3 = 3 * H;
  const int ra = a.reset_after, hard = a.hard;
  const int RW = ra ? 4 * H : H3;
  Geo g;
  make_geo<SPLIT, UL>(g, a.p, B, H, c, 1, reinterpret_cast<float*>(smem4));
  const int HP = g.HP;
  float* sc = a.scratch + (size_t)dsel * dir_scratch(B, H, HP, false);
  float* hb0 = sc;
  float* hb1 = sc + (size_t)B * HP;
  float* rhb = sc + 2 * (size_t)B * HP;
  float* gzb = sc + 3 * (size_t)B * HP;   // [B][2][H]: r, z of the units
  unsigned* ctr = a.counters + 32 * dsel;
  unsigned target = 0;
  zero_padding(sc, 3LL * B, H, HP, c, K);
  const int rev = PICK(reverse);
  int unit[UL];
#pragma unroll
  for (int cc = 0; cc < UL; ++cc) unit[cc] = g.ug + g.NUG * cc;

  for (int seed = 0; seed < a.nseed; ++seed) {
    const float* wh = PICK(wh) + (size_t)seed * H * H3;
    const float* xp = PICK(xp) + (size_t)seed * B * T * H3;
    const float* h0 = PICK(h0) + (size_t)seed * B * H;
    float* ys = PICK(ys) + (size_t)seed * B * T * H;
    float* res = WITH_RES ? PICK(res) + (size_t)seed * B * T * RW : nullptr;
    float* hl = PICK(h_last) + (size_t)seed * B * H;
    __syncthreads();   // the last seed's products are done with the weights
    if (g.resident) load_weights<SPLIT>(g, wh + g.base, H3, 1);
    for (int e = threadIdx.x; e < B * g.U; e += THREADS) {
      const int b = e / g.U, u = e % g.U;
      if (u < g.units) hb0[(size_t)b * HP + g.base + u] = h0[(size_t)b * H + g.base + u];
    }
    const float* bh = ra ? PICK(bh) + (size_t)seed * H3 : nullptr;
    dir_barrier(ctr, target, K);   // h0 and the padding are in place

    for (int i = 0; i < T; ++i) {
      const int t = rev ? T - 1 - i : i;
      const float* hb = (i & 1) ? hb1 : hb0;
      float* hn = (i & 1) ? hb0 : hb1;
      for (int ub = 0; ub < g.nub; ++ub) {
        unit_block(g, ub);
        const float* wsrc = wh + g.lo;
        for (int b0 = 0; b0 < B; b0 += g.RT) {
          const float* const rows[1] = {hb};
          if (ra) {
            const int gates[3] = {0, 1, 2};
            float o[RB][3 * UL];
            product<SPLIT, RB, UL, 3, 1>(g, rows, gates, b0, wsrc, H3, 1, o);
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
              for (int cc = 0; cc < UL; ++cc) {
                const int b = b0 + g.rg + g.NRG * r;
                if (!mine<SPLIT, UL>(g, r, cc) || b >= B || unit[cc] >= g.own) continue;
                const int j = g.lo + unit[cc];
                const size_t n = (size_t)b * T + t;
                const float* x = xp + n * H3 + j;
                const float* bj = bh + j;
                const float hv = o[r][2 * UL + cc] + __ldg(bj + 2 * H);
                const float rg = gate(__ldg(x) + (o[r][cc] + __ldg(bj)), hard);
                const float zg = gate(__ldg(x + H) + (o[r][UL + cc] + __ldg(bj + H)), hard);
                const float ng = tanh_fast(fmaf(rg, hv, __ldg(x + 2 * H)));
                const float h = blend(zg, ng, __ldcg(hb + (size_t)b * HP + j));
                hn[(size_t)b * HP + j] = h;
                ys[n * H + j] = h;
                if (WITH_RES) {
                  float* out = res + n * RW + j;
                  out[0] = rg;
                  out[H] = zg;
                  out[2 * H] = ng;
                  out[3 * H] = hv;
                }
                if (i == T - 1) hl[(size_t)b * H + j] = h;
              }
          } else {
            const int gates[2] = {0, 1};
            float o[RB][2 * UL];
            product<SPLIT, RB, UL, 2, 1>(g, rows, gates, b0, wsrc, H3, 1, o);
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
              for (int cc = 0; cc < UL; ++cc) {
                const int b = b0 + g.rg + g.NRG * r;
                if (!mine<SPLIT, UL>(g, r, cc) || b >= B || unit[cc] >= g.own) continue;
                const int j = g.lo + unit[cc];
                const float* x = xp + ((size_t)b * T + t) * H3 + j;
                const float rg = gate(__ldg(x) + o[r][cc], hard);
                const float zg = gate(__ldg(x + H) + o[r][UL + cc], hard);
                rhb[(size_t)b * HP + j] = __fmul_rn(rg, __ldcg(hb + (size_t)b * HP + j));
                gzb[(size_t)b * 2 * H + j] = rg;
                gzb[((size_t)b * 2 + 1) * H + j] = zg;
              }
          }
        }
      }
      if (!ra) {
        dir_barrier(ctr, target, K);   // every CTA's r h rows are in place
        for (int ub = 0; ub < g.nub; ++ub) {
          unit_block(g, ub);
          const float* wsrc = wh + g.lo;
          for (int b0 = 0; b0 < B; b0 += g.RT) {
            const float* const rows[1] = {rhb};
            const int gates[1] = {2};
            float o[RB][UL];
            product<SPLIT, RB, UL, 1, 1>(g, rows, gates, b0, wsrc, H3, 1, o);
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
              for (int cc = 0; cc < UL; ++cc) {
                const int b = b0 + g.rg + g.NRG * r;
                if (!mine<SPLIT, UL>(g, r, cc) || b >= B || unit[cc] >= g.own) continue;
                const int j = g.lo + unit[cc];
                const size_t n = (size_t)b * T + t;
                const float rg = __ldcg(gzb + (size_t)b * 2 * H + j);
                const float zg = __ldcg(gzb + ((size_t)b * 2 + 1) * H + j);
                const float ng = tanh_fast(__ldg(xp + n * H3 + 2 * H + j) + o[r][cc]);
                const float h = blend(zg, ng, __ldcg(hb + (size_t)b * HP + j));
                hn[(size_t)b * HP + j] = h;
                ys[n * H + j] = h;
                if (WITH_RES) {
                  float* out = res + n * RW + j;
                  out[0] = rg;
                  out[H] = zg;
                  out[2 * H] = ng;
                }
                if (i == T - 1) hl[(size_t)b * H + j] = h;
              }
          }
        }
      }
      dir_barrier(ctr, target, K);   // every CTA's new state rows are in place
    }
  }
}

// Backward chain: the K CTAs of a direction hold their units' rows of wh and
// carry dh of those units; each step exchanges the rows' gate-input
// gradients and writes dxp[t]. dwh and dbh are left to csrc/gru_dwh.cu.
template <int SPLIT, int RB, int UL>
__global__ void __launch_bounds__(THREADS, 1) gru_grid_bwd(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  const int K = a.p.K;
  const int dsel = blockIdx.x / K, c = blockIdx.x % K;
  const int B = a.B, T = a.T, H = a.H, H3 = 3 * H;
  const int ra = a.reset_after, hard = a.hard;
  const int RW = ra ? 4 * H : H3;
  Geo g;
  make_geo<SPLIT, UL>(g, a.p, B, H, c, 3, reinterpret_cast<float*>(smem4));
  const int HP = g.HP;
  const size_t BHP = (size_t)B * HP;
  float* sc = a.scratch + (size_t)dsel * dir_scratch(B, H, HP, true);
  float* dab = sc;                    // [2][3][B][HP]: da_r, da_z, da_n (times r when reset_after)
  float* dhc = sc + 6 * BHP;          // [B][H]: the units' dh
  float* cs = dhc + (size_t)B * H;    // [B][3][H]: dht, drh, dzs
  unsigned* ctr = a.counters + 32 * dsel;
  unsigned target = 0;
  zero_padding(sc, 6LL * B, H, HP, c, K);
  const int rev = PICK(reverse);
  int unit[UL];
#pragma unroll
  for (int cc = 0; cc < UL; ++cc) unit[cc] = g.ug + g.NUG * cc;

  for (int seed = 0; seed < a.nseed; ++seed) {
    const size_t so = (size_t)seed * B * T;
    const float* wh = PICK(wh) + (size_t)seed * H * H3;
    const float* ys = PICK(ys) + so * H;
    const float* res = PICK(res) + so * RW;
    const float* dys = PICK(dys) + so * H;
    const float* h0 = PICK(h0) + (size_t)seed * B * H;
    const float* dhl = PICK(dhl) + (size_t)seed * B * H;
    float* dxp = PICK(dxp) + so * H3;
    float* dh0 = PICK(dh0) + (size_t)seed * B * H;
    __syncthreads();
    if (g.resident) load_weights<SPLIT>(g, wh + (size_t)g.base * H3, 1, H3);
    dir_barrier(ctr, target, K);   // the last seed's readers of the exchanged rows are done

    // Step i visits the forward's steps in reverse: t = T-1 .. 0 for a
    // forward direction, t = 0 .. T-1 for a reverse one. h_prev of step t is
    // ys[t-1] (forward) or ys[t+1] (reverse), and h0 at the chain's end.
    for (int i = 0; i < T; ++i) {
      const int t = rev ? i : T - 1 - i;
      const int tp = rev ? t + 1 : t - 1;
      float* ar = dab + (size_t)(i & 1) * 3 * BHP;
      float* az = ar + BHP;
      float* an = az + BHP;
      for (int ub = 0; ub < g.nub; ++ub) {
        unit_block(g, ub);
        for (int b0 = 0; b0 < B; b0 += g.RT) {
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int cc = 0; cc < UL; ++cc) {
              const int b = b0 + g.rg + g.NRG * r;
              if (!mine<SPLIT, UL>(g, r, cc) || b >= B || unit[cc] >= g.own) continue;
              const int j = g.lo + unit[cc];
              const size_t n = (size_t)b * T + t;
              const float hp =
                  i == T - 1 ? h0[(size_t)b * H + j] : ys[((size_t)b * T + tp) * H + j];
              const float* gr = res + n * RW + j;
              const float rr = gr[0], z = gr[H], nn = gr[2 * H];
              const float dh = i == 0 ? dhl[(size_t)b * H + j] : __ldcg(dhc + (size_t)b * H + j);
              const float dht = dys[n * H + j] + dh;
              const float daz = dht * (hp - nn) * gate_grad(z, hard);
              const float dan = dht * (1.0f - z) * fmaf(-nn, nn, 1.0f);
              float* d = dxp + n * H3 + j;
              const size_t k = (size_t)b * HP + j;
              if (ra) {
                const float dar = dan * gr[3 * H] * gate_grad(rr, hard);
                ar[k] = dar;
                an[k] = __fmul_rn(dan, rr);
                d[0] = dar;
              } else {
                an[k] = dan;
              }
              az[k] = daz;
              d[H] = daz;
              d[2 * H] = dan;
              cs[(size_t)b * 3 * H + j] = dht;
            }
        }
      }
      dir_barrier(ctr, target, K);   // every CTA's gradient rows are in place
      float* dh_out = i == T - 1 ? dh0 : dhc;
      if (ra) {
        for (int ub = 0; ub < g.nub; ++ub) {
          unit_block(g, ub);
          const float* wsrc = wh + (size_t)g.lo * H3;
          for (int b0 = 0; b0 < B; b0 += g.RT) {
            const float* const rows[3] = {ar, az, an};
            const int gates[3] = {0, 1, 2};
            float o[RB][3 * UL];
            product<SPLIT, RB, UL, 3, 3>(g, rows, gates, b0, wsrc, 1, H3, o);
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
              for (int cc = 0; cc < UL; ++cc) {
                const int b = b0 + g.rg + g.NRG * r;
                if (!mine<SPLIT, UL>(g, r, cc) || b >= B || unit[cc] >= g.own) continue;
                const int j = g.lo + unit[cc];
                const float v = (o[r][cc] + o[r][UL + cc]) + o[r][2 * UL + cc];
                const float z = res[((size_t)b * T + t) * RW + H + j];
                const float dht = __ldcg(cs + (size_t)b * 3 * H + j);
                dh_out[(size_t)b * H + j] = fmaf(dht, z, v);
              }
          }
        }
      } else {
        for (int ub = 0; ub < g.nub; ++ub) {
          unit_block(g, ub);
          const float* wsrc = wh + (size_t)g.lo * H3;
          for (int b0 = 0; b0 < B; b0 += g.RT) {
            const float* const rows[2] = {an, az};
            const int gates[2] = {2, 1};
            float o[RB][2 * UL];
            product<SPLIT, RB, UL, 2, 2>(g, rows, gates, b0, wsrc, 1, H3, o);
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
              for (int cc = 0; cc < UL; ++cc) {
                const int b = b0 + g.rg + g.NRG * r;
                if (!mine<SPLIT, UL>(g, r, cc) || b >= B || unit[cc] >= g.own) continue;
                const int j = g.lo + unit[cc];
                const size_t n = (size_t)b * T + t;
                const float hp =
                  i == T - 1 ? h0[(size_t)b * H + j] : ys[((size_t)b * T + tp) * H + j];
                const float rr = res[n * RW + j];
                const float drh = o[r][cc], dzs = o[r][UL + cc];
                const float dar = drh * hp * gate_grad(rr, hard);
                ar[(size_t)b * HP + j] = dar;
                dxp[n * H3 + j] = dar;
                cs[((size_t)b * 3 + 1) * H + j] = drh;
                cs[((size_t)b * 3 + 2) * H + j] = dzs;
              }
          }
        }
        dir_barrier(ctr, target, K);   // every CTA's da_r rows are in place
        for (int ub = 0; ub < g.nub; ++ub) {
          unit_block(g, ub);
          const float* wsrc = wh + (size_t)g.lo * H3;
          for (int b0 = 0; b0 < B; b0 += g.RT) {
            const float* const rows[1] = {ar};
            const int gates[1] = {0};
            float o[RB][UL];
            product<SPLIT, RB, UL, 1, 1>(g, rows, gates, b0, wsrc, 1, H3, o);
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
              for (int cc = 0; cc < UL; ++cc) {
                const int b = b0 + g.rg + g.NRG * r;
                if (!mine<SPLIT, UL>(g, r, cc) || b >= B || unit[cc] >= g.own) continue;
                const int j = g.lo + unit[cc];
                const size_t n = (size_t)b * T + t;
                const float* cb = cs + (size_t)b * 3 * H + j;
                const float dht = __ldcg(cb), drh = __ldcg(cb + H), dzs = __ldcg(cb + 2 * H);
                const float rr = res[n * RW + j], z = res[n * RW + H + j];
                dh_out[(size_t)b * H + j] = fmaf(drh, rr, fmaf(dht, z, o[r][cc] + dzs));
              }
          }
        }
      }
    }
  }
}

// Host side ------------------------------------------------------------------

const void* fwd_kernel(int split, int RB, bool with_res) {
  if (split == 1) {
    if (RB == 4)
      return with_res ? (const void*)gru_grid_fwd<1, 4, TILE_UNITS, true>
                      : (const void*)gru_grid_fwd<1, 4, TILE_UNITS, false>;
    if (RB == 2)
      return with_res ? (const void*)gru_grid_fwd<1, 2, TILE_UNITS, true>
                      : (const void*)gru_grid_fwd<1, 2, TILE_UNITS, false>;
    return with_res ? (const void*)gru_grid_fwd<1, 1, TILE_UNITS, true>
                    : (const void*)gru_grid_fwd<1, 1, TILE_UNITS, false>;
  }
  if (RB == 4)
    return with_res ? (const void*)gru_grid_fwd<SLABS, 4, 1, true>
                    : (const void*)gru_grid_fwd<SLABS, 4, 1, false>;
  if (RB == 2)
    return with_res ? (const void*)gru_grid_fwd<SLABS, 2, 1, true>
                    : (const void*)gru_grid_fwd<SLABS, 2, 1, false>;
  return with_res ? (const void*)gru_grid_fwd<SLABS, 1, 1, true>
                  : (const void*)gru_grid_fwd<SLABS, 1, 1, false>;
}

const void* bwd_kernel(int split, int RB) {
  if (split == 1)
    return RB == 4   ? (const void*)gru_grid_bwd<1, 4, TILE_UNITS>
           : RB == 2 ? (const void*)gru_grid_bwd<1, 2, TILE_UNITS>
                     : (const void*)gru_grid_bwd<1, 1, TILE_UNITS>;
  return RB == 4   ? (const void*)gru_grid_bwd<SLABS, 4, 1>
         : RB == 2 ? (const void*)gru_grid_bwd<SLABS, 2, 1>
                   : (const void*)gru_grid_bwd<SLABS, 1, 1>;
}

// The plan of ndir directions at (B, H) on a card of `sms` SMs, `ctas` > 0
// forcing K. UP: the fewest units a CTA (a power of two from UP_MIN) whose
// K = ceil(H / UP) CTAs a direction fit the card, or the power of two that
// holds ceil(H / ctas); where that passes UP_MAX, UP = UP_MAX and K the
// direction's SMs (or `ctas`), each CTA walking its U units in blocks. The
// lanes body where B <= LANES_MAX_B and its resident weights and whole rows
// fit, the most rows a thread up to what B needs; else the tile body, its
// weights resident when one block holds the CTA's units and they fit beside
// the smallest ring (one row a thread, two stages), with the most rows a
// thread that B needs and fit, then the most stages.
int make_plan(int ndir, int B, int H, bool backward, int ctas, int sms, Plan* out) {
  if (ndir < 1 || ndir > MAX_DIRS || B < 1 || H < 1 || sms < ndir) return NO_PLAN;
  Plan p = {};
  p.HP = round_up(H, 4 * SLABS);
  p.HS = p.HP / SLABS;
  p.SS = p.HS + (p.HS % 8 == 0 ? 4 : 8);
  p.threads = THREADS;
  if (ctas > 0) {
    p.K = ctas;
    const int U = cdiv(H, ctas);
    p.UP = UP_MIN;
    while (p.UP < U && p.UP < UP_MAX) p.UP *= 2;
  } else {
    const int kmax = sms / ndir;
    p.UP = UP_MIN;
    while (p.UP < UP_MAX && cdiv(H, p.UP) > kmax) p.UP *= 2;
    p.K = cdiv(H, p.UP) < kmax ? cdiv(H, p.UP) : kmax;
  }
  p.U = cdiv(H, p.K);
  const long long G = backward ? 3 : 1;
  if (B <= LANES_MAX_B && p.UP <= 32) {
    const int nrg = 32 / p.UP;
    const long long ws = (long long)SLABS * p.SS + 4;
    for (const int RB : {4, 2, 1}) {
      if (RB > 1 && RB / 2 * nrg >= B) continue;
      const long long smem = 4 * (3LL * p.UP + G * RB * nrg) * ws;
      if (smem <= MAX_SMEM) {
        p.split = SLABS;
        p.RB = RB;
        p.RT = RB * nrg;
        p.stages = 0;
        p.resident = 1;
        p.smem = smem;
        *out = p;
        return 0;
      }
    }
  }
  const int nrg = THREADS / (p.UP / TILE_UNITS);
  const long long weights = 3LL * p.UP * (p.HP + 4);
  p.resident = p.U <= p.UP && 4 * (weights + 2 * G * nrg * KCP) <= MAX_SMEM;
  for (const int RB : {4, 2, 1}) {
    if (RB > 1 && RB / 2 * nrg >= B) continue;
    for (int stages = MAX_STAGES; stages >= 2; --stages) {
      const long long ring = (long long)stages * G * RB * nrg * KCP;
      const long long smem =
          4 * (p.resident ? weights + ring : ring + (long long)stages * 3 * p.UP * KCP);
      if (smem <= MAX_SMEM) {
        p.split = 1;
        p.RB = RB;
        p.RT = RB * nrg;
        p.stages = stages;
        p.smem = smem;
        *out = p;
        return 0;
      }
    }
  }
  return NO_PLAN;
}

cudaError_t sm_count(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
}

// The dynamic shared memory attribute, set once per kernel and device.
cudaError_t opt_in(const void* fn) {
  static std::mutex lock;
  static std::vector<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (const auto& e : done)
    if (e.first == fn && e.second == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return err;
  done.push_back({fn, dev});
  return cudaSuccess;
}

bool bad_shape(int ndir, int nseed, int B, int T, int H) {
  return ndir < 1 || ndir > MAX_DIRS || nseed < 1 || (nseed > 1 && ndir != MAX_DIRS) || B <= 0 ||
         T <= 0 || H <= 0;
}

template <typename D>
Dirs<D> pack(const D* dirs, int ndir) {
  Dirs<D> out = {};
  for (int i = 0; i < ndir; ++i) out.d[i] = dirs[i];
  return out;
}

// CTAs of the plan's kernel the card holds at once (the occupancy an SM
// times the SMs): the most a cooperative launch takes.
cudaError_t resident_ctas(const void* fn, const Plan& p, int sms, int* out) {
  cudaError_t err = opt_in(fn);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      static_cast<size_t>(p.smem));
  *out = per_sm * sms;
  return err;
}

// The plan, the attribute, the counters zeroed and one cooperative launch
// of ndir K CTAs (refused by the runtime when the card cannot hold them).
template <typename Args>
int launch(Args& a, int ndir, bool backward, bool with_res, int ctas, float* scratch,
           cudaStream_t s) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (make_plan(ndir, a.B, a.H, backward, ctas, sms, &a.p) != 0) return NO_PLAN;
  const void* fn = backward ? bwd_kernel(a.p.split, a.p.RB) : fwd_kernel(a.p.split, a.p.RB, with_res);
  err = opt_in(fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.counters = reinterpret_cast<unsigned*>(scratch);
  a.scratch = scratch + COUNTER_FLOATS;
  err = cudaMemsetAsync(scratch, 0, COUNTER_FLOATS * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(ndir * a.p.K), dim3(THREADS), args,
                                    static_cast<size_t>(a.p.smem), s);
  if (err != cudaSuccess) {
    cudaGetLastError();   // a refused launch leaves no error for the next one to report
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gru_grid_error_string(int status) {
  if (status == NO_PLAN) return "no grid plan fits this shape on this card";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Floats of device scratch a launch of ndir directions at (B, H) needs: the
// barrier counters, then each direction's exchanged rows and step values.
long long gru_grid_scratch_floats(int ndir, int B, int H, int backward) {
  return COUNTER_FLOATS + ndir * dir_scratch(B, H, round_up(H, 4 * SLABS), backward != 0);
}

// CTAs that the card holds at once of the kernel the plan of ndir
// directions at (B, H) launches (`ctas` > 0 forces K).
int gru_grid_resident_ctas(int ndir, int B, int H, int backward, int with_res, int ctas) {
  int sms = 0;
  Plan p = {};
  if (sm_count(&sms) != cudaSuccess || make_plan(ndir, B, H, backward != 0, ctas, sms, &p) != 0)
    return -1;
  const void* fn = backward ? bwd_kernel(p.split, p.RB) : fwd_kernel(p.split, p.RB, with_res != 0);
  int n = 0;
  return resident_ctas(fn, p, sms, &n) == cudaSuccess ? n : -1;
}

// The launch plan of ndir directions of nseed seeds at (B, H) on this card:
// out = {K, U, UP, split, RB, RT, stages, resident, threads, smem bytes};
// `ctas` > 0 forces K.
int gru_grid_plan(int ndir, int nseed, int B, int H, int backward, int with_res, int ctas,
                  long long* out) {
  (void)with_res;
  if (bad_shape(ndir, nseed, B, 1, H)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p = {};
  if (make_plan(ndir, B, H, backward != 0, ctas, sms, &p) != 0) return NO_PLAN;
  const long long v[10] = {p.K, p.U, p.UP, p.split, p.RB, p.RT, p.stages, p.resident, p.threads,
                           p.smem};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// ndir (1 or 2) directions of nseed seeds (nseed > 1 only with both
// directions), each xp (nseed, B, T, 3H), wh (nseed, H, 3H), bh (nseed, 3H)
// or null, h0 (nseed, B, H) -> ys (nseed, B, T, H), res (nseed, B, T, RW)
// when with_res, h_last (nseed, B, H); float32, contiguous, on the device of
// `stream`; scratch holds gru_grid_scratch_floats(ndir, B, H, 0) floats.
// `ctas` > 0 forces K (the order of sums does not depend on it).
int gru_grid_fwd_launch(const FwdDir* dirs, int ndir, int nseed, int B, int T, int H,
                        int reset_after, int hard_sigmoid, int with_res, int ctas, float* scratch,
                        void* stream) {
  if (bad_shape(ndir, nseed, B, T, H) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a = {};
  a.dirs = pack(dirs, ndir);
  a.nseed = nseed;
  a.B = B;
  a.T = T;
  a.H = H;
  a.reset_after = reset_after;
  a.hard = hard_sigmoid;
  return launch(a, ndir, false, with_res != 0, ctas, scratch, static_cast<cudaStream_t>(stream));
}

// ndir directions of nseed seeds, each ys (nseed, B, T, H), res (nseed, B,
// T, RW), wh (nseed, H, 3H), h0 (nseed, B, H), dys (nseed, B, T, H), dhl
// (nseed, B, H) -> dxp (nseed, B, T, 3H), dh0 (nseed, B, H); scratch holds
// gru_grid_scratch_floats(ndir, B, H, 1) floats.
int gru_grid_bwd_launch(const BwdDir* dirs, int ndir, int nseed, int B, int T, int H,
                        int reset_after, int hard_sigmoid, int ctas, float* scratch, void* stream) {
  if (bad_shape(ndir, nseed, B, T, H) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = {};
  a.dirs = pack(dirs, ndir);
  a.nseed = nseed;
  a.B = B;
  a.T = T;
  a.H = H;
  a.reset_after = reset_after;
  a.hard = hard_sigmoid;
  return launch(a, ndir, true, false, ctas, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
