// GRU recurrence for Hopper (sm_90a) with the recurrent weights resident in
// the shared memory of a thread-block cluster for the whole sequence: the
// cluster tier of kernel B, for 128 < H <= gru_cluster_max_h() (512).
//
// Replaces, in that range, the TPU kernels of
// sed_crnn_tpu/ops/pallas/gru_scan.py:
//   * `_fwd_kernel` with with_res=False (`gru_scan_tc`) and with_res=True
//     (`_gru_fwd`): gru_cluster_fwd<RB, false / true>;
//   * `_bwd_kernel` (`_gru_bwd`): its gradient chain (dxp and dh0),
//     gru_cluster_bwd<RB>; dwh and dbh are reduced after it from the stored
//     rows by gru_dwh_kernel and gru_dwh_sum (csrc/gru_dwh.cu).
// The contract is csrc/gru_wide.cu's: pre-projected inputs xp = x @ wi + bi
// (B, T, 3H), recurrent kernel wh (H, 3H) in gate order (reset, update,
// candidate), bias bh (3H) read only when reset_after, initial state h0
// (B, H) -> ys (B, T, H), h_last (B, H) and, with residuals, res (B, T, RW)
// = r | z | n (| hn when reset_after); both conventions, the logistic
// sigmoid or keras-2.2 hard_sigmoid gate, reverse time, one or two
// directions and S seeds per launch (grid.y = 2 * seed + direction).
//
// What bounds it: operations, once the weights stop streaming. A step of
// one direction is a (B, H) x (H, 3H) product and the chain has T steps; at
// H = 256, B = 128, T = 256 both directions' residual forward are 25.8
// GFLOP, 0.39 ms at the card's 67 TFLOP/s float32. The wide body's retired
// L2 tier read all of wh (786 KB at H = 256) from L2 for each batch row at
// each step, so it ran at L2's bandwidth with each weight serving one row.
//
// What the design does about it:
//   * a cluster of C CTAs serves R batch rows of one direction of one seed;
//     CTA c owns hidden units [c U, (c + 1) U), U = ceil(H / C), and holds
//     their part of wh in its shared memory, loaded once: the three gate
//     columns of each unit in the forward, (3, U, H), the unit's rows of wh
//     in the backward chain, (3, U, H), k contiguous; C is a function of H
//     alone (gru_cluster_ctas: the fewest CTAs, a power of two, whose slice
//     fits WEIGHT_BYTES), 8 at H = 256;
//   * a group of KQ = 16 consecutive lanes owns UPL = 2 units of its CTA (at
//     most 32 units, 256 threads a CTA, so that a lane may hold up to 255
//     registers); lane kq sums the k-slices k = 4 (kq + 16 i) .. + 3 of the
//     group's six dot products (two units x three gates) for a block of RB
//     rows, one accumulator each, so that every weight read from shared
//     memory serves RB rows and every state value six columns; the sixteen
//     partials of a row are combined by a fixed tree of shuffles that leaves
//     each row's sums on its own lane (a reduce-scatter over lanes kq ^ 8,
//     ^ 4, ^ 2, ^ 1). The order of every sum depends on H only: not on C,
//     R, B or S, so a stacked seed is bitwise the unstacked pair;
//   * the step: each CTA computes its units' gates for its rows from the
//     full state rows in its own shared memory; the lanes that end with a
//     row write the new state values into the CTA's next state buffer, and
//     after a block barrier the CTA's threads copy its slice of every row
//     into the other CTAs' buffers, 16 bytes a store where the slice allows
//     (distributed shared memory); one cluster barrier (arrive.release /
//     wait.acquire) follows and the next step reads the whole row locally.
//     reset_after=False exchanges r h the same way before the candidate's
//     product: two barriers a step. The backward chain exchanges the gate
//     gradients (da_r, da_z, da_n, times r when reset_after) and reduces
//     dh = da @ wh^T over its units' rows;
//   * state rows live only in shared memory (double-buffered); the step's
//     xp (forward) or h_prev, gates and dys (backward) of a lane's own row
//     and unit are copied STAGES - 1 steps ahead into a ring with cp.async,
//     read back by the lane that copied them;
//   * R (1 .. 32 rows a cluster, in blocks of up to RB = 8 rows held in
//     registers, 48 accumulators a lane) is chosen on the host: the fewest rows whose clusters the
//     card holds at once (cudaOccupancyMaxActiveClusters), read once per
//     kernel, device and shape. A cluster that the card cannot hold is
//     refused with an error, never run another way;
//   * float32 FMAs, no tensor cores, as the register tier: the forward is
//     held to 1e-5 of the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

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
constexpr int KQ = 16;                      // lanes per group of units
constexpr int UPL = 2;                      // units per group
constexpr int UNITS_PER_WARP = 32 / KQ * UPL;
constexpr int STAGES = 4;                   // staging ring: STAGES - 1 steps in flight
constexpr int ROW_BLOCK = 8;                // rows a lane's accumulators hold at once
// Threads a CTA: 32 units, so that a lane may hold 255 registers (the phase
// tool also builds 512, for C = 4 at H = 256).
#ifndef GRU_CLUSTER_MAX_THREADS
#define GRU_CLUSTER_MAX_THREADS 256
#endif
constexpr int MAX_THREADS = GRU_CLUSTER_MAX_THREADS;
constexpr int MAX_SMEM = 232448;            // 227 KB, the opt-in limit of a CTA
constexpr int MAX_CTAS = 16;                // the non-portable cluster limit on Hopper
// The rule's weight slice a CTA: at H = 256 it picks C = 8 (98 KB), which
// sed_crnn_torch/tools/gru_phases.py times faster over a pair's forward and
// backward chain at B = 1 and 128 than C = 4 (196 KB) or C = 16.
constexpr int WEIGHT_BYTES = 104000;
constexpr int ROW_OPTIONS[] = {1, 2, 4, 8, 16, 32};
constexpr int SCAN_MAX_H = 4096;
constexpr int NO_CLUSTER_FITS = -1;         // status: the card holds no cluster of this shape

// Profiling cuts, for sed_crnn_torch/tools/gru_phases.py only (the results
// are then wrong): built with -DGRU_CLUSTER_CUT=1 the body writes new state
// values and gate gradients into its own CTA only and replaces the cluster
// barriers by block barriers; with 2 it also leaves out the gate products;
// with 3 also the staging copies. 0, the default, cuts nothing.
#ifndef GRU_CLUSTER_CUT
#define GRU_CLUSTER_CUT 0
#endif
constexpr int CUT = GRU_CLUSTER_CUT;

template <typename D>
struct Dirs {
  D d[MAX_DIRS];
};

// A field of this block's direction `dsel`, selected field by field so that
// the kernel never copies a whole direction struct to local memory.
#define PICK(field) (dsel ? dirs.d[1].field : dirs.d[0].field)

// The shapes of a CTA's share for hidden width H on C CTAs: U units (UP
// rounded up to whole warps), state rows HP floats (H rounded up to the k
// slices of a unit's lanes), weight rows WS floats (HP + 4, so that the
// float4 writes of neighbouring units fall on other banks).
struct Geom {
  int U, UP, HP, WS;
};

__host__ __device__ __forceinline__ int round_up(int a, int m) { return (a + m - 1) / m * m; }

__host__ __device__ __forceinline__ Geom geom(int H, int C) {
  Geom g;
  g.U = (H + C - 1) / C;
  g.UP = round_up(g.U, UNITS_PER_WARP);   // a CTA runs UP / UPL * KQ threads
  g.HP = round_up(H, 4 * KQ);
  g.WS = g.HP + 4;
  return g;
}

// Shared memory of a CTA in floats. Forward: weights [3][UP][WS], state rows
// [2][R][HP], r h rows [R][HP], staged xp [STAGES][R][3][UP]. Backward:
// weights [3][UP][WS], gate gradients [2][3][R][HP], staged h_prev, r, z, n,
// hn, dys [STAGES][R][6][UP], a lane's carries [R][4][UP].
__host__ __device__ __forceinline__ long long smem_floats(const Geom& g, int R, bool backward) {
  const long long w = 3LL * g.UP * g.WS;
  if (!backward) return w + 3LL * R * g.HP + (long long)STAGES * R * 3 * g.UP;
  return w + 6LL * R * g.HP + (long long)STAGES * R * 6 * g.UP + 4LL * R * g.UP;
}

__device__ __forceinline__ float gate(float v, int hard) {
  return hard ? fminf(fmaxf(0.2f * v + 0.5f, 0.0f), 1.0f)
              : __fdividef(1.0f, 1.0f + __expf(-v));
}

__device__ __forceinline__ float tanh_fast(float v) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * v));
}

// d gate / d pre-activation from the gate's output value.
__device__ __forceinline__ float gate_grad(float g, int hard) {
  return hard ? ((g > 0.0f && g < 1.0f) ? 0.2f : 0.0f) : g * (1.0f - g);
}

// Asynchronous 4-byte copy from device to shared memory (sm_80+).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(const float4 v, const float4 w, float& a) {
  a = fmaf(v.x, w.x, a);
  a = fmaf(v.y, w.y, a);
  a = fmaf(v.z, w.z, a);
  a = fmaf(v.w, w.w, a);
}

// The barrier between a step's exchange and the reads of its results.
__device__ __forceinline__ void exchange_barrier(const cg::cluster_group& cl) {
  if (CUT >= 1) {
    __syncthreads();
  } else {
    cl.sync();
  }
}

// This CTA's columns [lo, lo + n) of R rows of stride HP of the shared array
// `buf` into the same place in every other CTA of the cluster, 16 bytes a
// store where the columns allow it. The caller has finished writing them
// (a block barrier) and follows with a cluster barrier.
__device__ __forceinline__ void spread(const cg::cluster_group& cl, float* buf, int R, int HP,
                                       int lo, int n, int C, int c) {
  if (CUT >= 1 || n <= 0) return;
  const int tid = threadIdx.x, nthr = blockDim.x;
  if ((lo & 3) == 0 && (n & 3) == 0) {
    const int n4 = n / 4, per = R * n4;
    for (int e = tid; e < (C - 1) * per; e += nthr) {
      const int d = (c + 1 + e / per) % C, f = e % per;
      float* p = buf + (f / n4) * HP + lo + 4 * (f % n4);
      *reinterpret_cast<float4*>(cl.map_shared_rank(p, d)) = *reinterpret_cast<const float4*>(p);
    }
  } else {
    const int per = R * n;
    for (int e = tid; e < (C - 1) * per; e += nthr) {
      const int d = (c + 1 + e / per) % C, f = e % per;
      float* p = buf + (f / n) * HP + lo + f % n;
      *cl.map_shared_rank(p, d) = *p;
    }
  }
}

// Lane kq's partial dot products, for the UPL units u of its group and G
// gates g, of RB rows (rows[g] + r HP, or rows[0] for every g when SAME)
// with the weight rows w[u][g] (k contiguous), over its k-slices
// k = 4 (kq + KQ i) .. + 3 in order, one accumulator each:
// o[u G + g][r].
template <int RB, int G, bool SAME>
__device__ __forceinline__ void dots(const float* const (&rows)[SAME ? 1 : G], int HP,
                                     const float* const (&w)[UPL][G], int kq,
                                     float (&o)[UPL * G][RB]) {
#pragma unroll
  for (int v = 0; v < UPL * G; ++v)
#pragma unroll
    for (int r = 0; r < RB; ++r) o[v][r] = 0.f;
  const int n = CUT >= 2 ? 0 : HP / (4 * KQ);
#pragma unroll 2
  for (int i = 0; i < n; ++i) {
    const int k = 4 * (kq + KQ * i);
    float4 wv[UPL][G];
#pragma unroll
    for (int u = 0; u < UPL; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) wv[u][g] = ld4(w[u][g] + k);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if constexpr (SAME) {
        const float4 x = ld4(rows[0] + r * HP + k);
#pragma unroll
        for (int u = 0; u < UPL; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g) fma4(x, wv[u][g], o[u * G + g][r]);
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 x = ld4(rows[g] + r * HP + k);
#pragma unroll
          for (int u = 0; u < UPL; ++u) fma4(x, wv[u][g], o[u * G + g][r]);
        }
      }
    }
  }
}

// The sum over the KQ lanes of a group of each of A rows' V partials, by a
// fixed tree: over lanes kq ^ M, ^ M / 2, ..., ^ 1. While more than one row
// is left, a lane keeps half of them (the upper half when kq & M) and adds
// its partner's half of the same rows; then it adds its partner's whole
// value. Every sum is the same tree over the KQ partials whatever A (a sum
// of two terms is the same either way round), and row kq / (KQ / A) of the
// block ends in v[.][0] of lane kq.
template <int V, int N, int A, int M>
__device__ __forceinline__ void reduce_rows(float (&v)[V][N], int kq) {
  if constexpr (M > 0) {
    if constexpr (A >= 2) {
      const bool up = kq & M;
#pragma unroll
      for (int i = 0; i < A / 2; ++i) {
#pragma unroll
        for (int g = 0; g < V; ++g) {
          const float lo = v[g][i], hi = v[g][i + A / 2];
          const float other = __shfl_xor_sync(0xffffffffu, up ? lo : hi, M);
          v[g][i] = (up ? hi : lo) + other;
        }
      }
      reduce_rows<V, N, A / 2, M / 2>(v, kq);
    } else {
#pragma unroll
      for (int g = 0; g < V; ++g) v[g][0] += __shfl_xor_sync(0xffffffffu, v[g][0], M);
      reduce_rows<V, N, 1, M / 2>(v, kq);
    }
  }
}

template <int V, int RB>
__device__ __forceinline__ void reduce_block(float (&v)[V][RB], int kq) {
  reduce_rows<V, RB, RB, KQ / 2>(v, kq);
}

// Forward: lane group q = threadIdx.x / KQ of CTA c serves units
// j = c U + UPL q + s, s < UPL (local unit u >= U or j >= H: zero weights,
// no writes), for the cluster's R rows b0 .. b0 + R - 1 (rows >= B read row
// B - 1 and write nothing), in blocks of RB rows.
template <int RB, bool WITH_RES>
__global__ void __launch_bounds__(MAX_THREADS, 1) gru_cluster_fwd(Dirs<FwdDir> dirs, int B, int T,
                                                                  int H, int R, int reset_after,
                                                                  int hard) {
  const cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int c = static_cast<int>(cl.block_rank());
  const Geom gm = geom(H, C);
  const int U = gm.U, UP = gm.UP, HP = gm.HP, WS = gm.WS;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);   // [3][UP][WS]: wh[k, g H + c U + u]
  float* s_h = s_w + 3 * UP * WS;                 // [2][R][HP]
  float* s_rh = s_h + 2 * R * HP;                 // [R][HP]
  float* s_x = s_rh + R * HP;                     // [STAGES][R][3][UP]

  const int dsel = blockIdx.y & 1;
  const size_t seed = blockIdx.y >> 1;
  const int H3 = 3 * H;
  const int RW = reset_after ? 4 * H : H3;
  const float* wh = PICK(wh) + seed * H * H3;
  const int rev = PICK(reverse);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int kq = tid % KQ, u0 = UPL * (tid / KQ);
  const int lo = c * U;                               // this CTA's first unit
  const int own = min(U, H - lo);                     // and its count
  const int b0 = (blockIdx.x / C) * R;
  constexpr int SPREAD = KQ / RB;                     // lanes that end with one row's sums
  const int rl = kq / SPREAD;
  const bool lead = kq % SPREAD == 0 && u0 < own;     // the lane that writes that row
  const int nblk = R / RB;

  for (int e = tid; e < 3 * UP * HP; e += nthr) {
    const int uu = e % UP, rest = e / UP, g = rest % 3, k = rest / 3;
    s_w[(g * UP + uu) * WS + k] = (uu < own && k < H) ? wh[(size_t)k * H3 + g * H + lo + uu] : 0.f;
  }
  const float* h0 = PICK(h0);
  for (int e = tid; e < 3 * R * HP; e += nthr) {
    const int r = e / HP, k = e - r * HP;
    s_h[e] = (r < R && b0 + r < B && k < H) ? h0[(seed * B + b0 + r) * H + k] : 0.f;
  }
  float bias[UPL][3] = {};
  if (reset_after) {
    const float* bh = PICK(bh) + seed * H3;
#pragma unroll
    for (int s = 0; s < UPL; ++s)
#pragma unroll
      for (int g = 0; g < 3; ++g) bias[s][g] = u0 + s < own ? bh[g * H + lo + u0 + s] : 0.f;
  }

  const float* xp = PICK(xp);
  const int slot_len = R * 3 * UP;
  auto stage = [&](int i) {
    if (CUT < 3 && lead) {
      const int ic = i < T ? i : T - 1;
      const int t = rev ? T - 1 - ic : ic;
      float* slot = s_x + (i % STAGES) * slot_len;
      for (int q = 0; q < nblk; ++q) {
        const int row = q * RB + rl;
        const int b = b0 + row < B ? b0 + row : B - 1;
        const float* src = xp + ((seed * B + b) * T + t) * H3 + lo + u0;
        float* dst = slot + row * 3 * UP + u0;
#pragma unroll
        for (int s = 0; s < UPL; ++s) {
          if (u0 + s >= own) break;
          cp_async4(dst + s, src + s);
          cp_async4(dst + UP + s, src + H + s);
          cp_async4(dst + 2 * UP + s, src + 2 * H + s);
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) stage(i);
  cl.sync();   // every CTA's buffers are set before a partner writes into them

  float* ys = PICK(ys);
  float* res = WITH_RES ? PICK(res) : nullptr;
  const float* const w3[UPL][3] = {
      {s_w + u0 * WS, s_w + (UP + u0) * WS, s_w + (2 * UP + u0) * WS},
      {s_w + (u0 + 1) * WS, s_w + (UP + u0 + 1) * WS, s_w + (2 * UP + u0 + 1) * WS}};
  const float* const w2[UPL][2] = {{w3[0][0], w3[0][1]}, {w3[1][0], w3[1][1]}};
  const float* const w1[UPL][1] = {{w3[0][2]}, {w3[1][2]}};
  auto write_out = [&](int row, int t, int s, float h, float rg, float zg, float ng, float hv) {
    const int b = b0 + row;
    if (b >= B) return;
    const size_t n = (seed * B + b) * T + t;
    const int j = lo + u0 + s;
    ys[n * H + j] = h;
    if (WITH_RES) {
      float* o = res + n * RW + j;
      o[0] = rg;
      o[H] = zg;
      o[2 * H] = ng;
      if (reset_after) o[3 * H] = hv;
    }
  };
  for (int i = 0; i < T; ++i) {
    const int t = rev ? T - 1 - i : i;
    cp_async_wait<STAGES - 2>();   // this lane's copies of step i have landed
    stage(i + STAGES - 1);         // into the slot step i - 1 read
    const float* hb = s_h + (i & 1) * R * HP;
    float* hnext = s_h + ((i + 1) & 1) * R * HP;
    float* xs = s_x + (i % STAGES) * slot_len;
    for (int q = 0; q < nblk; ++q) {
      const float* const rows[1] = {hb + q * RB * HP};
      const int row = q * RB + rl;
      float* x = xs + row * 3 * UP + u0;
      const float* hr = hb + row * HP + lo + u0;
      if (reset_after) {
        float o[UPL * 3][RB];
        dots<RB, 3, true>(rows, HP, w3, kq, o);
        reduce_block<UPL * 3, RB>(o, kq);
        if (lead) {
#pragma unroll
          for (int s = 0; s < UPL; ++s) {
            if (u0 + s >= own) break;
            const float hv = o[3 * s + 2][0] + bias[s][2];
            const float rg = gate(x[s] + (o[3 * s][0] + bias[s][0]), hard);
            const float zg = gate(x[UP + s] + (o[3 * s + 1][0] + bias[s][1]), hard);
            const float ng = tanh_fast(x[2 * UP + s] + rg * hv);
            const float h = (1.0f - zg) * ng + zg * hr[s];
            hnext[row * HP + lo + u0 + s] = h;
            write_out(row, t, s, h, rg, zg, ng, hv);
          }
        }
      } else {
        float o[UPL * 2][RB];
        dots<RB, 2, true>(rows, HP, w2, kq, o);
        reduce_block<UPL * 2, RB>(o, kq);
        if (lead) {
#pragma unroll
          for (int s = 0; s < UPL; ++s) {
            if (u0 + s >= own) break;
            const float rg = gate(x[s] + o[2 * s][0], hard);
            const float zg = gate(x[UP + s] + o[2 * s + 1][0], hard);
            x[s] = rg;   // this lane's own slot entries, kept for the candidate
            x[UP + s] = zg;
            s_rh[row * HP + lo + u0 + s] = rg * hr[s];
          }
        }
      }
    }
    if (!reset_after) {
      __syncthreads();
      spread(cl, s_rh, R, HP, lo, own, C, c);
      exchange_barrier(cl);   // every CTA's r h rows are in place
      for (int q = 0; q < nblk; ++q) {
        const float* const rows[1] = {s_rh + q * RB * HP};
        float o[UPL][RB];
        dots<RB, 1, true>(rows, HP, w1, kq, o);
        reduce_block<UPL, RB>(o, kq);
        const int row = q * RB + rl;
        if (lead) {
          const float* x = xs + row * 3 * UP + u0;
          const float* hr = hb + row * HP + lo + u0;
#pragma unroll
          for (int s = 0; s < UPL; ++s) {
            if (u0 + s >= own) break;
            const float ng = tanh_fast(x[2 * UP + s] + o[s][0]);
            const float h = (1.0f - x[UP + s]) * ng + x[UP + s] * hr[s];
            hnext[row * HP + lo + u0 + s] = h;
            write_out(row, t, s, h, x[s], x[UP + s], ng, 0.f);
          }
        }
      }
    }
    __syncthreads();
    spread(cl, hnext, R, HP, lo, own, C, c);
    exchange_barrier(cl);     // every CTA's new state rows are in place
  }
  cp_async_wait<0>();
  if (lead) {
    const float* hl = s_h + (T & 1) * R * HP;
    for (int q = 0; q < nblk; ++q) {
      const int row = q * RB + rl;
      if (b0 + row >= B) continue;
      for (int s = 0; s < UPL && u0 + s < own; ++s)
        PICK(h_last)[(seed * B + b0 + row) * H + lo + u0 + s] = hl[row * HP + lo + u0 + s];
    }
  }
}

// Backward chain: lane group q of CTA c holds rows j = c U + UPL q + s of wh
// and carries dh[j] of the cluster's rows; each step exchanges the rows'
// gate-input gradients and writes dxp[t]. dwh and dbh are left to
// csrc/gru_dwh.cu.
template <int RB>
__global__ void __launch_bounds__(MAX_THREADS, 1) gru_cluster_bwd(Dirs<BwdDir> dirs, int B, int T,
                                                                  int H, int R, int reset_after,
                                                                  int hard) {
  const cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int c = static_cast<int>(cl.block_rank());
  const Geom gm = geom(H, C);
  const int U = gm.U, UP = gm.UP, HP = gm.HP, WS = gm.WS;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);   // [3][UP][WS]: wh[c U + u, g H + k]
  float* s_da = s_w + 3 * UP * WS;                // [2][3][R][HP]
  float* s_q = s_da + 6 * R * HP;                 // [STAGES][R][6][UP]
  float* s_c = s_q + STAGES * R * 6 * UP;         // [R][4][UP]: dh, dht, dzs, drh

  const int dsel = blockIdx.y & 1;
  const size_t seed = blockIdx.y >> 1;
  const int H3 = 3 * H;
  const int RW = reset_after ? 4 * H : H3;
  const float* wh = PICK(wh) + seed * H * H3;
  const int rev = PICK(reverse);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int kq = tid % KQ, u0 = UPL * (tid / KQ);
  const int lo = c * U;
  const int own = min(U, H - lo);
  const int b0 = (blockIdx.x / C) * R;
  constexpr int SPREAD = KQ / RB;
  const int rl = kq / SPREAD;
  const bool lead = kq % SPREAD == 0 && u0 < own;
  const int nblk = R / RB;

  for (int e = tid; e < 3 * UP * HP; e += nthr) {
    const int k = e % HP, rest = e / HP, uu = rest % UP, g = rest / UP;
    s_w[(g * UP + uu) * WS + k] = (uu < own && k < H) ? wh[(size_t)(lo + uu) * H3 + g * H + k] : 0.f;
  }
  for (int e = tid; e < 6 * R * HP; e += nthr) s_da[e] = 0.f;
  const float* dhl = PICK(dhl);
  if (lead) {
    for (int q = 0; q < nblk; ++q) {
      const int row = q * RB + rl;
      for (int s = 0; s < UPL && u0 + s < own; ++s)
        s_c[row * 4 * UP + u0 + s] = b0 + row < B ? dhl[(seed * B + b0 + row) * H + lo + u0 + s]
                                                  : 0.f;
    }
  }

  // Step i visits the forward's steps in reverse: t = T-1 .. 0 for a forward
  // direction, t = 0 .. T-1 for a reverse one. h_prev of step t is ys[t-1]
  // (forward) or ys[t+1] (reverse), and h0 at the chain's end (step T-1).
  const float* ys = PICK(ys);
  const float* res = PICK(res);
  const float* dys = PICK(dys);
  const float* h0 = PICK(h0);
  const int slot_len = R * 6 * UP;
  auto stage = [&](int i) {
    if (CUT < 3 && lead) {
      const int ic = i < T ? i : T - 1;
      const int t = rev ? ic : T - 1 - ic;
      const int tp = rev ? t + 1 : t - 1;
      float* slot = s_q + (i % STAGES) * slot_len;
      for (int q = 0; q < nblk; ++q) {
        const int row = q * RB + rl;
        const size_t bb = seed * B + (b0 + row < B ? b0 + row : B - 1);
        const int j = lo + u0;
        float* dst = slot + row * 6 * UP + u0;
        const float* hp = ic == T - 1 ? h0 + bb * H + j : ys + (bb * T + tp) * H + j;
        const float* g = res + (bb * T + t) * RW + j;
        const float* dy = dys + (bb * T + t) * H + j;
#pragma unroll
        for (int s = 0; s < UPL; ++s) {
          if (u0 + s >= own) break;
          cp_async4(dst + s, hp + s);
          cp_async4(dst + UP + s, g + s);
          cp_async4(dst + 2 * UP + s, g + H + s);
          cp_async4(dst + 3 * UP + s, g + 2 * H + s);
          if (reset_after) cp_async4(dst + 4 * UP + s, g + 3 * H + s);
          cp_async4(dst + 5 * UP + s, dy + s);
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) stage(i);
  cl.sync();   // every CTA's buffers are set before a partner writes into them

  float* dxp = PICK(dxp);
  const float* const w3[UPL][3] = {
      {s_w + u0 * WS, s_w + (UP + u0) * WS, s_w + (2 * UP + u0) * WS},
      {s_w + (u0 + 1) * WS, s_w + (UP + u0 + 1) * WS, s_w + (2 * UP + u0 + 1) * WS}};
  const float* const w_nz[UPL][2] = {{w3[0][2], w3[0][1]}, {w3[1][2], w3[1][1]}};
  const float* const w_r[UPL][1] = {{w3[0][0]}, {w3[1][0]}};
  for (int i = 0; i < T; ++i) {
    const int t = rev ? i : T - 1 - i;
    cp_async_wait<STAGES - 2>();
    stage(i + STAGES - 1);
    const float* slot = s_q + (i % STAGES) * slot_len;
    float* ar = s_da + (i & 1) * 3 * R * HP;
    float* az = ar + R * HP;
    float* an = az + R * HP;
    if (lead) {
      for (int q = 0; q < nblk; ++q) {
        const int row = q * RB + rl;
        const int b = b0 + row;
        float* d = dxp + ((seed * B + (b < B ? b : 0)) * T + t) * H3 + lo + u0;
        for (int s = 0; s < UPL && u0 + s < own; ++s) {
          const float* g = slot + row * 6 * UP + u0 + s;
          float* cr = s_c + row * 4 * UP + u0 + s;
          const int k = row * HP + lo + u0 + s;
          const float hp = g[0], r = g[UP], z = g[2 * UP], n = g[3 * UP];
          const float dht = g[5 * UP] + cr[0];
          const float daz = dht * (hp - n) * gate_grad(z, hard);
          const float dan = dht * (1.0f - z) * (1.0f - n * n);
          cr[UP] = dht;
          az[k] = daz;
          if (reset_after) {
            const float dar = dan * g[4 * UP] * gate_grad(r, hard);
            ar[k] = dar;
            an[k] = dan * r;
            if (b < B) d[s] = dar;
          } else {
            an[k] = dan;
          }
          if (b < B) {
            d[H + s] = daz;
            d[2 * H + s] = dan;
          }
        }
      }
    }
    __syncthreads();
    if (reset_after) spread(cl, ar, R, HP, lo, own, C, c);
    spread(cl, az, R, HP, lo, own, C, c);
    spread(cl, an, R, HP, lo, own, C, c);
    exchange_barrier(cl);
    if (reset_after) {
      for (int q = 0; q < nblk; ++q) {
        const float* const rows[3] = {ar + q * RB * HP, az + q * RB * HP, an + q * RB * HP};
        float o[UPL * 3][RB], v[UPL][RB];
        dots<RB, 3, false>(rows, HP, w3, kq, o);
#pragma unroll
        for (int s = 0; s < UPL; ++s)
#pragma unroll
          for (int r = 0; r < RB; ++r) v[s][r] = (o[3 * s][r] + o[3 * s + 1][r]) + o[3 * s + 2][r];
        reduce_block<UPL, RB>(v, kq);
        const int row = q * RB + rl;
        if (lead) {
          for (int s = 0; s < UPL && u0 + s < own; ++s) {
            float* cr = s_c + row * 4 * UP + u0 + s;
            cr[0] = cr[UP] * slot[row * 6 * UP + 2 * UP + u0 + s] + v[s][0];
          }
        }
      }
    } else {
      for (int q = 0; q < nblk; ++q) {
        const float* const rows[2] = {an + q * RB * HP, az + q * RB * HP};
        float o[UPL * 2][RB];
        dots<RB, 2, false>(rows, HP, w_nz, kq, o);
        reduce_block<UPL * 2, RB>(o, kq);
        const int row = q * RB + rl;
        if (lead) {
          const int b = b0 + row;
          for (int s = 0; s < UPL && u0 + s < own; ++s) {
            const float* g = slot + row * 6 * UP + u0 + s;
            float* cr = s_c + row * 4 * UP + u0 + s;
            const float drh = o[2 * s][0], dzs = o[2 * s + 1][0];
            const float dar = drh * g[0] * gate_grad(g[UP], hard);
            cr[2 * UP] = dzs;
            cr[3 * UP] = drh;
            ar[row * HP + lo + u0 + s] = dar;
            if (b < B) dxp[((seed * B + b) * T + t) * H3 + lo + u0 + s] = dar;
          }
        }
      }
      __syncthreads();
      spread(cl, ar, R, HP, lo, own, C, c);
      exchange_barrier(cl);
      for (int q = 0; q < nblk; ++q) {
        const float* const rows[1] = {ar + q * RB * HP};
        float o[UPL][RB];
        dots<RB, 1, true>(rows, HP, w_r, kq, o);
        reduce_block<UPL, RB>(o, kq);
        const int row = q * RB + rl;
        if (lead) {
          for (int s = 0; s < UPL && u0 + s < own; ++s) {
            const float* g = slot + row * 6 * UP + u0 + s;
            float* cr = s_c + row * 4 * UP + u0 + s;
            cr[0] = cr[UP] * g[2 * UP] + (o[s][0] + cr[2 * UP]) + cr[3 * UP] * g[UP];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (lead) {
    for (int q = 0; q < nblk; ++q) {
      const int row = q * RB + rl;
      if (b0 + row >= B) continue;
      for (int s = 0; s < UPL && u0 + s < own; ++s)
        PICK(dh0)[(seed * B + b0 + row) * H + lo + u0 + s] = s_c[row * 4 * UP + u0 + s];
    }
  }
}

// Host side ------------------------------------------------------------------

using FwdKernel = void (*)(Dirs<FwdDir>, int, int, int, int, int, int);

template <int RB>
FwdKernel fwd_rb(bool with_res) {
  return with_res ? gru_cluster_fwd<RB, true> : gru_cluster_fwd<RB, false>;
}

const void* kernel_for(int RB, bool backward, bool with_res) {
  if (backward) {
    return RB == 1   ? (const void*)gru_cluster_bwd<1>
           : RB == 2 ? (const void*)gru_cluster_bwd<2>
           : RB == 4 ? (const void*)gru_cluster_bwd<4>
           : (const void*)gru_cluster_bwd<8>;
  }
  return RB == 1   ? (const void*)fwd_rb<1>(with_res)
         : RB == 2 ? (const void*)fwd_rb<2>(with_res)
         : RB == 4 ? (const void*)fwd_rb<4>(with_res)
         : (const void*)fwd_rb<8>(with_res);
}

// The rule: the fewest CTAs, a power of two, whose weight slice fits
// WEIGHT_BYTES with at most MAX_THREADS threads; else MAX_CTAS.
int rule_ctas(int H) {
  for (int C = 2; C <= MAX_CTAS; C *= 2) {
    const Geom g = geom(H, C);
    if (g.UP / UPL * KQ <= MAX_THREADS && 3LL * g.UP * g.WS * 4 <= WEIGHT_BYTES) return C;
  }
  return MAX_CTAS;
}

bool shape_fits(int H, int C, int R, bool backward) {
  const Geom g = geom(H, C);
  return H >= 1 && C >= 1 && C <= MAX_CTAS && g.UP / UPL * KQ <= MAX_THREADS &&
         smem_floats(g, R, backward) * 4 <= MAX_SMEM;
}

// The widest H up to which every width fits one row a cluster on the
// rule's CTAs, forward and backward.
int max_h() {
  static int known = 0;
  if (known) return known;
  int h = 1;
  while (h < SCAN_MAX_H && shape_fits(h + 1, rule_ctas(h + 1), 1, false) &&
         shape_fits(h + 1, rule_ctas(h + 1), 1, true))
    ++h;
  known = h;
  return h;
}

// The dynamic shared memory and non-portable cluster attributes, set once
// per kernel and device.
cudaError_t opt_in(const void* fn, int dev) {
  static std::mutex lock;
  static std::vector<std::pair<const void*, int>> done;
  std::lock_guard<std::mutex> guard(lock);
  for (const auto& e : done)
    if (e.first == fn && e.second == dev) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  done.push_back({fn, dev});
  return cudaSuccess;
}

cudaLaunchConfig_t launch_config(int clusters_x, int ny, int C, int threads, size_t smem,
                                 cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters_x) * C, ny, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of C CTAs of `threads` threads and `smem` bytes of kernel `fn`
// that the device holds at once, read once per (kernel, device, shape).
cudaError_t resident_clusters(const void* fn, int C, int threads, size_t smem, int* out) {
  struct Entry {
    const void* fn;
    int dev, C, threads;
    size_t smem;
    int clusters;
  };
  static std::mutex lock;
  static std::vector<Entry> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> guard(lock);
    for (const Entry& e : known) {
      if (e.fn == fn && e.dev == dev && e.C == C && e.threads == threads && e.smem == smem) {
        *out = e.clusters;
        return cudaSuccess;
      }
    }
  }
  err = opt_in(fn, dev);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, 1, C, threads, smem, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  known.push_back({fn, dev, C, threads, smem, n});
  *out = n;
  return cudaSuccess;
}

struct Plan {
  int C, R, threads;
  size_t smem;
  const void* fn;
};

// C by the rule (or `ctas` when > 0); R the fewest rows of ROW_OPTIONS whose
// ceil(B / R) x ny clusters the card holds at once (or that cover B), else
// the most that fit: a function of B, ny and the card, which only the
// launch geometry depends on.
int make_plan(bool backward, bool with_res, int ny, int B, int H, int ctas, Plan* p) {
  const int C = ctas > 0 ? ctas : rule_ctas(H);
  if (!shape_fits(H, C, 1, backward)) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = geom(H, C);
  const int threads = g.UP / UPL * KQ;
  bool found = false;
  for (const int R : ROW_OPTIONS) {
    if (!shape_fits(H, C, R, backward)) break;
    const size_t smem = static_cast<size_t>(smem_floats(g, R, backward)) * 4;
    const void* fn = kernel_for(R < ROW_BLOCK ? R : ROW_BLOCK, backward, with_res);
    int n = 0;
    const cudaError_t err = resident_clusters(fn, C, threads, smem, &n);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) break;
    *p = {C, R, threads, smem, fn};
    found = true;
    if ((long long)(B + R - 1) / R * ny <= n || R >= B) break;
  }
  return found ? 0 : NO_CLUSTER_FITS;
}

bool bad_shape(int ndir, int nseed, int B, int T, int H) {
  return ndir < 1 || ndir > MAX_DIRS || nseed < 1 || (nseed > 1 && ndir != MAX_DIRS) ||
         B <= 0 || T <= 0 || H <= 0 || H > max_h() || (long long)ndir * nseed > 65535;
}

template <typename D>
Dirs<D> pack(const D* dirs, int ndir) {
  Dirs<D> out = {};
  for (int i = 0; i < ndir; ++i) out.d[i] = dirs[i];
  return out;
}

}  // namespace

extern "C" {

const char* gru_cluster_error_string(int status) {
  if (status == NO_CLUSTER_FITS)
    return "the card cannot hold one cluster of this shape (cudaOccupancyMaxActiveClusters is 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The widest H the tier takes, and its constants, for the Python mirror.
int gru_cluster_max_h() { return max_h(); }
int gru_cluster_ctas(int H) { return rule_ctas(H); }
long long gru_cluster_smem_bytes(int H, int ctas, int R, int backward) {
  return smem_floats(geom(H, ctas), R, backward != 0) * 4;
}

// The launch plan of ndir directions of nseed seeds at (B, H): out = {C, R,
// threads a CTA, shared memory bytes a CTA}; `ctas` > 0 forces C.
int gru_cluster_plan(int ndir, int nseed, int B, int H, int backward, int with_res, int ctas,
                     long long* out) {
  if (bad_shape(ndir, nseed, B, 1, H)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p = {};
  const int status = make_plan(backward != 0, with_res != 0, ndir * nseed, B, H, ctas, &p);
  if (status != 0) return status;
  out[0] = p.C;
  out[1] = p.R;
  out[2] = p.threads;
  out[3] = static_cast<long long>(p.smem);
  return 0;
}

// ndir (1 or 2) directions of nseed seeds (nseed > 1 only with both
// directions), each xp (nseed, B, T, 3H), wh (nseed, H, 3H), bh (nseed, 3H)
// or null, h0 (nseed, B, H) -> ys (nseed, B, T, H), res (nseed, B, T, RW)
// when with_res, h_last (nseed, B, H); float32, contiguous, on the device of
// `stream`. `ctas` > 0 forces the cluster size (the order of sums does not
// depend on it).
int gru_cluster_fwd_launch(const FwdDir* dirs, int ndir, int nseed, int B, int T, int H,
                           int reset_after, int hard_sigmoid, int with_res, int ctas,
                           void* stream) {
  if (bad_shape(ndir, nseed, B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const int ny = ndir * nseed;
  Plan p = {};
  const int status = make_plan(false, with_res != 0, ny, B, H, ctas, &p);
  if (status != 0) return status;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config((B + p.R - 1) / p.R, ny, p.C, p.threads, p.smem,
                                         static_cast<cudaStream_t>(stream), attr);
  Dirs<FwdDir> d = pack(dirs, ndir);
  void* args[] = {&d, &B, &T, &H, &p.R, &reset_after, &hard_sigmoid};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, p.fn, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ndir directions of nseed seeds, each ys (nseed, B, T, H), res (nseed, B,
// T, RW), wh (nseed, H, 3H), h0 (nseed, B, H), dys (nseed, B, T, H), dhl
// (nseed, B, H) -> dxp (nseed, B, T, 3H), dh0 (nseed, B, H).
int gru_cluster_bwd_launch(const BwdDir* dirs, int ndir, int nseed, int B, int T, int H,
                           int reset_after, int hard_sigmoid, int ctas, void* stream) {
  if (bad_shape(ndir, nseed, B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const int ny = ndir * nseed;
  Plan p = {};
  const int status = make_plan(true, false, ny, B, H, ctas, &p);
  if (status != 0) return status;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config((B + p.R - 1) / p.R, ny, p.C, p.threads, p.smem,
                                         static_cast<cudaStream_t>(stream), attr);
  Dirs<BwdDir> d = pack(dirs, ndir);
  void* args[] = {&d, &B, &T, &H, &p.R, &reset_after, &hard_sigmoid};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, p.fn, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
