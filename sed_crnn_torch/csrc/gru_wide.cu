// GRU recurrence for Hopper (sm_90a) at hidden widths 32 < H <= 128: a block
// of Q = 4 lanes per hidden unit and R batch rows, the recurrent weights
// split over the lanes' registers, both directions of a BiGRU and every seed
// of a stack in one launch.
//
// Replaces, for 32 < H <= 128 (the warp body, csrc/gru_warp.cu, takes
// H <= 32, the cluster body, csrc/gru_cluster.cu, 128 < H <= 512, the grid
// body, csrc/gru_grid.cu, H > 512), the TPU kernels of
// sed_crnn_tpu/ops/pallas/gru_scan.py:
//   * `_fwd_kernel` with with_res=False (`gru_scan_tc`) and with_res=True
//     (`_gru_fwd`): gru_wide_fwd<KS, R, false / true>;
//   * `_bwd_kernel` (`_gru_bwd`): gru_wide_bwd<KS, R>, the gradient chain
//     (dxp and dh0); dwh and dbh are reduced after it from the stored rows
//     by csrc/gru_dwh.cu (tensor cores, 3xTF32), as for the cluster and
//     grid bodies.
// The contract is the warp body's: pre-projected inputs xp = x @ wi + bi
// (B, T, 3H), recurrent kernel wh (H, 3H) in gate order (reset, update,
// candidate), bias bh (3H) read only when reset_after, initial state h0 (B, H)
// -> ys (B, T, H), h_last (B, H) and, with residuals, res (B, T, RW) =
// r | z | n (| hn when reset_after). Both conventions:
//   reset_after=1: hp = h @ wh + bh; r = g(xr + hp_r); z = g(xz + hp_z);
//                  n = tanh(xn + r * hp_n)
//   reset_after=0: r = g(xr + h @ wh_r); z = g(xz + h @ wh_z);
//                  n = tanh(xn + (r * h) @ wh_n)
//   h' = (1 - z) * n + z * h
// with g the logistic sigmoid or keras-2.2 hard_sigmoid clip(0.2 v + 0.5, 0, 1).
// Every tensor of a direction holds S seeds one after another; grid.y is
// 2 * seed + direction.
//
// What bounds it: latency. The T steps of a direction form one chain; a step
// is a (rows, H) x (H, 3H) product, and when not reset_after a second product
// that depends on r. At H=128, B=128, T=256 the residual forward's 3.2 GFLOP
// per direction would take 0.048 ms at the card's float32 rate, so what a
// step costs is its dependent instructions and barriers, not bytes or FLOPs.
//
// What the design does about it:
//   * weights in registers, split over lanes: hidden unit j owns Q = 4
//     consecutive lanes, lane q holds the k-slice k = 4 (q + Q i) + c of the
//     unit's three weight columns (wh[k, j], wh[k, H+j], wh[k, 2H+j]; in the
//     backward row j of wh), KS values per gate, KS = 8, 16, 24 or 32 for H
//     up to 32, 64, 96, 128 (H <= 32 only through the private launcher); the
//     partial sums are combined with two __shfl_xor_sync, which give every
//     lane of the unit the same bits;
//   * the state rows broadcast through shared memory, double-buffered, one
//     block barrier per dependent phase (one a step with reset_after, two
//     without); interleaved slices put the four lanes of a unit on four
//     consecutive 16-byte words, so the float4 reads do not conflict;
//   * R batch rows a block (1, 2 or 4), chosen on the host from the card's
//     resident blocks, so that B x 2 directions x S seeds fill the SMs once
//     and each weight register serves R rows;
//   * staged inputs: the step's xp (forward) or h_prev, gates and dys
//     (backward) are copied STAGES - 1 steps ahead into a ring in shared
//     memory with cp.async;
//   * the launchers refuse H > 128 (cudaErrorInvalidValue): the cluster and
//     grid bodies take those widths;
//   * the dynamic shared memory attribute and the occupancy are read once
//     per kernel and device.

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <vector>

// One direction's operands; the C entry points take an array of 1 or 2.
// Each pointer is that of seed 0; the kernels step to seed s by the
// tensor's size per seed, from B, T and H. Same layout as gru_warp.cu's.
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
constexpr int Q = 4;               // lanes per hidden unit
constexpr int STAGES = 4;          // staging ring: STAGES - 1 steps in flight
constexpr int REG_MAX_H = 128;     // widest H whose weights stay in registers

template <typename D>
struct Dirs {
  D d[MAX_DIRS];
};

// A field of this block's direction `dsel`, selected field by field so that
// the kernel never copies a whole direction struct to local memory.
#define PICK(field) (dsel ? dirs.d[1].field : dirs.d[0].field)

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

// The sum over the Q lanes of a unit; every lane gets the same bits.
__device__ __forceinline__ float qsum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Asynchronous 4-byte copy from device to shared memory (sm_80+).
using SharedAddr = unsigned;

__device__ __forceinline__ SharedAddr shared_addr(const float* p) {
  return static_cast<SharedAddr>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(SharedAddr dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The register tier's slices: lane q's weight k for slot i is
// k = 4 (q + Q (i / 4)) + i % 4.
__device__ __forceinline__ int slice_k(int q, int i) { return 4 * (q + Q * (i >> 2)) + (i & 3); }

// Partial dot products of R state rows (stride HP, 16-byte aligned) with one
// to three weight slices, two accumulators each.
template <int KS, int R>
__device__ __forceinline__ void dot1(const float* rows, int q, const float (&w)[KS],
                                     float (&o)[R]) {
  constexpr int HP = Q * KS;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < KS / 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(rows + r * HP + 4 * (q + Q * i));
      a = fmaf(v.x, w[4 * i], a);
      b = fmaf(v.y, w[4 * i + 1], b);
      a = fmaf(v.z, w[4 * i + 2], a);
      b = fmaf(v.w, w[4 * i + 3], b);
    }
    o[r] = a + b;
  }
}

template <int KS, int R, int NW>
__device__ __forceinline__ void dot_same(const float* rows, int q, const float (&w0)[KS],
                                         const float (&w1)[KS], const float (&w2)[KS],
                                         float (&o0)[R], float (&o1)[R], float (&o2)[R]) {
  constexpr int HP = Q * KS;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float a0 = 0.f, b0 = 0.f, a1 = 0.f, b1 = 0.f, a2 = 0.f, b2 = 0.f;
#pragma unroll
    for (int i = 0; i < KS / 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(rows + r * HP + 4 * (q + Q * i));
      a0 = fmaf(v.x, w0[4 * i], a0);
      b0 = fmaf(v.y, w0[4 * i + 1], b0);
      a0 = fmaf(v.z, w0[4 * i + 2], a0);
      b0 = fmaf(v.w, w0[4 * i + 3], b0);
      a1 = fmaf(v.x, w1[4 * i], a1);
      b1 = fmaf(v.y, w1[4 * i + 1], b1);
      a1 = fmaf(v.z, w1[4 * i + 2], a1);
      b1 = fmaf(v.w, w1[4 * i + 3], b1);
      if (NW == 3) {
        a2 = fmaf(v.x, w2[4 * i], a2);
        b2 = fmaf(v.y, w2[4 * i + 1], b2);
        a2 = fmaf(v.z, w2[4 * i + 2], a2);
        b2 = fmaf(v.w, w2[4 * i + 3], b2);
      }
    }
    o0[r] = a0 + b0;
    o1[r] = a1 + b1;
    if (NW == 3) o2[r] = a2 + b2;
  }
}

// Shared memory of the register tier, in floats.
template <int KS, int R>
constexpr int fwd_smem_floats() { return 3 * R * Q * KS + STAGES * R * 3 * Q * KS; }
template <int KS, int R>
constexpr int bwd_smem_floats() { return 6 * R * Q * KS + STAGES * R * 6 * Q * KS; }

// Forward, register tier: thread 4 j + q serves unit j (j >= H: zeros, no
// writes) for the block's R rows b0 .. b0 + R - 1 (rows >= B read row B - 1
// and write nothing).
template <int KS, int R, bool WITH_RES>
__global__ void __launch_bounds__(16 * KS) gru_wide_fwd(Dirs<FwdDir> dirs, int B, int T, int H,
                                                        int reset_after, int hard) {
  constexpr int HP = Q * KS;   // state row stride: the tier's widest H
  constexpr int XW = 3 * HP;   // ring row stride
  extern __shared__ float4 smem4[];
  float* s_h = reinterpret_cast<float*>(smem4);   // [2][R][HP]
  float* s_rh = s_h + 2 * R * HP;                 // [R][HP]
  float* s_x = s_rh + R * HP;                     // [STAGES][R][XW]

  const int dsel = blockIdx.y & 1;
  const size_t seed = blockIdx.y >> 1;
  const int H3 = 3 * H;
  const int RW = reset_after ? 4 * H : H3;
  const float* wh = PICK(wh) + seed * H * H3;
  const int rev = PICK(reverse);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j = tid / Q, q = tid % Q;
  const bool unit = j < H;
  const int jc = unit ? j : 0;
  const int b0 = blockIdx.x * R;

  float wr[KS], wz[KS], wn[KS];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int k = slice_k(q, i);
    const bool ok = unit && k < H;
    wr[i] = ok ? wh[k * H3 + j] : 0.f;
    wz[i] = ok ? wh[k * H3 + H + j] : 0.f;
    wn[i] = ok ? wh[k * H3 + 2 * H + j] : 0.f;
  }
  float br = 0.f, bz = 0.f, bn = 0.f;
  if (reset_after && unit) {
    const float* bh = PICK(bh) + seed * H3;
    br = bh[j];
    bz = bh[H + j];
    bn = bh[2 * H + j];
  }
  float h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + r;
    h[r] = (unit && b < B) ? PICK(h0)[(seed * B + b) * H + j] : 0.f;
  }
  for (int e = tid; e < 3 * R * HP; e += nthr) s_h[e] = 0.f;   // zero padding of the rows
  __syncthreads();
  if (unit && q == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) s_h[r * HP + j] = h[r];
  }

  const float* xp = PICK(xp);
  const int per_step = R * H3;
  auto stage = [&](int i) {
    const int ic = i < T ? i : T - 1;
    const int t = rev ? T - 1 - ic : ic;
    float* slot = s_x + (i % STAGES) * R * XW;
    for (int e = tid; e < per_step; e += nthr) {
      const int r = e / H3, c = e - r * H3;
      const int b = b0 + r < B ? b0 + r : B - 1;
      cp_async4(shared_addr(slot + r * XW + c), xp + ((seed * B + b) * T + t) * H3 + c);
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) stage(i);

  float* ys = PICK(ys);
  float* res = WITH_RES ? PICK(res) : nullptr;
  for (int i = 0; i < T; ++i) {
    const int t = rev ? T - 1 - i : i;
    cp_async_wait<STAGES - 2>();     // this thread's copies of step i have landed
    __syncthreads();                 // everyone's, and the state row of step i - 1
    stage(i + STAGES - 1);           // into the slot step i - 1 read
    const float* hb = s_h + (i & 1) * R * HP;
    float* hnext = s_h + ((i + 1) & 1) * R * HP;
    const float* xs = s_x + (i % STAGES) * R * XW;
    float ar[R], az[R], an[R], rg[R], zg[R], ng[R], hv[R];
    if (reset_after) {
      dot_same<KS, R, 3>(hb, q, wr, wz, wn, ar, az, an);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* x = xs + r * XW;
        hv[r] = qsum(an[r]) + bn;
        rg[r] = gate(x[jc] + (qsum(ar[r]) + br), hard);
        zg[r] = gate(x[H + jc] + (qsum(az[r]) + bz), hard);
        ng[r] = tanh_fast(x[2 * H + jc] + rg[r] * hv[r]);
      }
    } else {
      dot_same<KS, R, 2>(hb, q, wr, wz, wz, ar, az, an);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* x = xs + r * XW;
        rg[r] = gate(x[jc] + qsum(ar[r]), hard);
        zg[r] = gate(x[H + jc] + qsum(az[r]), hard);
        hv[r] = 0.f;
        if (unit && q == 0) s_rh[r * HP + j] = rg[r] * h[r];
      }
      __syncthreads();
      dot1<KS, R>(s_rh, q, wn, an);
#pragma unroll
      for (int r = 0; r < R; ++r) ng[r] = tanh_fast(xs[r * XW + 2 * H + jc] + qsum(an[r]));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      h[r] = (1.0f - zg[r]) * ng[r] + zg[r] * h[r];
      const int b = b0 + r;
      if (!unit) continue;
      if (q == 0) hnext[r * HP + j] = h[r];
      if (b >= B) continue;
      const size_t row = (seed * B + b) * T + t;
      if (q == 0) ys[row * H + j] = h[r];
      if (WITH_RES && (q < 3 || reset_after)) {
        const float v = q == 0 ? rg[r] : q == 1 ? zg[r] : q == 2 ? ng[r] : hv[r];
        res[row * RW + q * H + j] = v;
      }
    }
  }
  cp_async_wait<0>();
  if (unit && q == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (b0 + r < B) PICK(h_last)[(seed * B + b0 + r) * H + j] = h[r];
  }
}

// Backward chain, register tier: thread 4 j + q carries dh[j] of the block's
// rows and holds lane q's slice of row j of wh; each step broadcasts the
// rows' gate-input gradients and writes dxp[t]. dwh and dbh are left to
// csrc/gru_dwh.cu.
template <int KS, int R>
__global__ void __launch_bounds__(16 * KS) gru_wide_bwd(Dirs<BwdDir> dirs, int B, int T, int H,
                                                        int reset_after, int hard) {
  constexpr int HP = Q * KS;
  constexpr int QW = 6 * HP;   // ring row: h_prev at 0, res at HP, dys at 5 HP
  extern __shared__ float4 smem4[];
  float* s_da = reinterpret_cast<float*>(smem4);   // [2][3][R][HP]
  float* s_q = s_da + 6 * R * HP;                  // [STAGES][R][QW]

  const int dsel = blockIdx.y & 1;
  const size_t seed = blockIdx.y >> 1;
  const int H3 = 3 * H;
  const int RW = reset_after ? 4 * H : H3;
  const int WQ = 2 * H + RW;   // staged values a row
  const float* wh = PICK(wh) + seed * H * H3;
  const int rev = PICK(reverse);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j = tid / Q, q = tid % Q;
  const bool unit = j < H;
  const int jc = unit ? j : 0;
  const int b0 = blockIdx.x * R;

  float wr[KS], wz[KS], wn[KS];   // lane q's slice of row j of wh
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int k = slice_k(q, i);
    const bool ok = unit && k < H;
    wr[i] = ok ? wh[j * H3 + k] : 0.f;
    wz[i] = ok ? wh[j * H3 + H + k] : 0.f;
    wn[i] = ok ? wh[j * H3 + 2 * H + k] : 0.f;
  }
  float dh[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + r;
    dh[r] = (unit && b < B) ? PICK(dhl)[(seed * B + b) * H + j] : 0.f;
  }
  for (int e = tid; e < 6 * R * HP; e += nthr) s_da[e] = 0.f;

  // Step i visits the forward's steps in reverse: t = T-1 .. 0 for a forward
  // direction, t = 0 .. T-1 for a reverse one. h_prev of step t is ys[t-1]
  // (forward) or ys[t+1] (reverse), and h0 at the chain's end (step T-1).
  const float* ys = PICK(ys);
  const float* res = PICK(res);
  const float* dys = PICK(dys);
  const float* h0 = PICK(h0);
  const int per_step = R * WQ;
  auto stage = [&](int i) {
    const int ic = i < T ? i : T - 1;
    const int t = rev ? ic : T - 1 - ic;
    const int tp = rev ? t + 1 : t - 1;
    float* slot = s_q + (i % STAGES) * R * QW;
    for (int e = tid; e < per_step; e += nthr) {
      const int r = e / WQ, c = e - r * WQ;
      const size_t bb = seed * B + (b0 + r < B ? b0 + r : B - 1);
      const float* src;
      int dst;
      if (c < H) {
        src = ic == T - 1 ? h0 + bb * H + c : ys + (bb * T + tp) * H + c;
        dst = c;
      } else if (c < H + RW) {
        src = res + (bb * T + t) * RW + (c - H);
        dst = HP + (c - H);
      } else {
        src = dys + (bb * T + t) * H + (c - H - RW);
        dst = 5 * HP + (c - H - RW);
      }
      cp_async4(shared_addr(slot + r * QW + dst), src);
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) stage(i);

  float* dxp = PICK(dxp);
  for (int i = 0; i < T; ++i) {
    const int t = rev ? i : T - 1 - i;
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    stage(i + STAGES - 1);
    const float* slot = s_q + (i % STAGES) * R * QW;
    float* ar = s_da + (i & 1) * 3 * R * HP;
    float* az = ar + R * HP;
    float* an = az + R * HP;
    float hp[R], rr[R], zz[R], dht[R], dar[R], daz[R], dan[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* g = slot + r * QW;
      hp[r] = g[jc];
      rr[r] = g[HP + jc];
      zz[r] = g[HP + H + jc];
      const float n = g[HP + 2 * H + jc];
      const float hn = reset_after ? g[HP + 3 * H + jc] : 0.f;
      dht[r] = g[5 * HP + jc] + dh[r];
      daz[r] = dht[r] * (hp[r] - n) * gate_grad(zz[r], hard);
      dan[r] = dht[r] * (1.0f - zz[r]) * (1.0f - n * n);
      dar[r] = dan[r] * hn * gate_grad(rr[r], hard);   // reset_after only
    }
    if (reset_after) {
      if (unit && q == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ar[r * HP + j] = dar[r];
          az[r * HP + j] = daz[r];
          an[r * HP + j] = dan[r] * rr[r];
        }
      }
      __syncthreads();
      float s0[R], s1[R], s2[R];
      dot1<KS, R>(ar, q, wr, s0);
      dot1<KS, R>(az, q, wz, s1);
      dot1<KS, R>(an, q, wn, s2);
#pragma unroll
      for (int r = 0; r < R; ++r) dh[r] = dht[r] * zz[r] + qsum((s0[r] + s1[r]) + s2[r]);
    } else {
      if (unit && q == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          az[r * HP + j] = daz[r];
          an[r * HP + j] = dan[r];
        }
      }
      __syncthreads();
      float drh[R], dzs[R], s0[R];
      dot1<KS, R>(an, q, wn, drh);
      dot1<KS, R>(az, q, wz, dzs);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        drh[r] = qsum(drh[r]);
        dzs[r] = qsum(dzs[r]);
        dar[r] = drh[r] * hp[r] * gate_grad(rr[r], hard);
        if (unit && q == 0) ar[r * HP + j] = dar[r];
      }
      __syncthreads();
      dot1<KS, R>(ar, q, wr, s0);
#pragma unroll
      for (int r = 0; r < R; ++r)
        dh[r] = dht[r] * zz[r] + (qsum(s0[r]) + dzs[r]) + drh[r] * rr[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r;
      if (!unit || b >= B) {
        dh[r] = 0.f;
        continue;
      }
      if (q < 3) {
        const float v = q == 0 ? dar[r] : q == 1 ? daz[r] : dan[r];
        dxp[((seed * B + b) * T + t) * H3 + q * H + j] = v;
      }
    }
  }
  cp_async_wait<0>();
  if (unit && q == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (b0 + r < B) PICK(dh0)[(seed * B + b0 + r) * H + j] = dh[r];
  }
}

// Host side ------------------------------------------------------------------

// The blocks of one kernel that the device holds at once (occupancy at
// `threads` and `smem`, times the SMs), read once per kernel and device,
// after the dynamic shared memory attribute is set (also once).
cudaError_t resident_blocks(const void* fn, int threads, size_t smem, int* out) {
  struct Entry {
    const void* fn;
    int dev;
    int blocks;
  };
  static std::mutex lock;
  static std::vector<Entry> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (const Entry& e : known) {
    if (e.fn == fn && e.dev == dev) {
      *out = e.blocks;
      return cudaSuccess;
    }
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  known.push_back({fn, dev, per_sm * sms});
  *out = per_sm * sms;
  return cudaSuccess;
}

// Units rounded up to whole warps of Q-lane units.
int units(int H) { return (H + 7) / 8 * 8; }

// The register tier's slice length for H.
int slice_len(int H) { return H <= 32 ? 8 : H <= 64 ? 16 : H <= 96 ? 24 : 32; }

// More than one seed takes both directions: grid.y is 2 * seed + direction.
bool bad_shape(int ndir, int nseed, int B, int T, int H) {
  return ndir < 1 || ndir > MAX_DIRS || nseed < 1 || (nseed > 1 && ndir != MAX_DIRS) ||
         B <= 0 || T <= 0 || H <= 0 || (long long)ndir * nseed > 65535;
}

template <typename D>
Dirs<D> pack(const D* dirs, int ndir) {
  Dirs<D> out = {};
  for (int i = 0; i < ndir; ++i) out.d[i] = dirs[i];
  return out;
}

using FwdKernel = void (*)(Dirs<FwdDir>, int, int, int, int, int);
using BwdKernel = void (*)(Dirs<BwdDir>, int, int, int, int, int);

template <int KS, int R>
FwdKernel fwd_kernel(bool with_res) {
  return with_res ? gru_wide_fwd<KS, R, true> : gru_wide_fwd<KS, R, false>;
}

// Rows a block: the fewest (1, 2, 4; 1, 2 at KS = 32, whose 96 weight
// registers leave no room for more) whose blocks all fit on the card at
// once, else the most. Returns the error of the occupancy query, if any.
template <int KS, typename K>
cudaError_t pick_rows(K (*kernel_for)(int, bool), bool flag, int B, int ny, size_t (*smem_for)(int),
                      int* rows, K* kernel) {
  const int options[3] = {1, 2, 4};
  const int n = KS == 32 ? 2 : 3;
  for (int i = 0; i < n; ++i) {
    const int R = options[i];
    const K k = kernel_for(R, flag);
    int resident = 0;
    const cudaError_t err = resident_blocks((const void*)k, 16 * KS, smem_for(R), &resident);
    if (err != cudaSuccess) return err;
    *rows = R;
    *kernel = k;
    if ((long long)(B + R - 1) / R * ny <= resident || R >= B) break;
  }
  return cudaSuccess;
}

template <int KS>
FwdKernel fwd_for(int R, bool with_res) {
  return R == 1 ? fwd_kernel<KS, 1>(with_res)
         : R == 2 ? fwd_kernel<KS, 2>(with_res)
                  : fwd_kernel<KS, KS == 32 ? 2 : 4>(with_res);
}

template <int KS>
BwdKernel bwd_for(int R, bool) {
  return R == 1 ? gru_wide_bwd<KS, 1> : R == 2 ? gru_wide_bwd<KS, 2>
                                                : gru_wide_bwd<KS, KS == 32 ? 2 : 4>;
}

template <int KS>
size_t fwd_smem(int R) {
  return sizeof(float) * (R == 1 ? fwd_smem_floats<KS, 1>() : R == 2 ? fwd_smem_floats<KS, 2>()
                                                                     : fwd_smem_floats<KS, 4>());
}

template <int KS>
size_t bwd_smem(int R) {
  return sizeof(float) * (R == 1 ? bwd_smem_floats<KS, 1>() : R == 2 ? bwd_smem_floats<KS, 2>()
                                                                     : bwd_smem_floats<KS, 4>());
}

template <int KS>
int launch_fwd_reg(const Dirs<FwdDir>& d, int ny, int B, int T, int H, int reset_after, int hard,
                   int with_res, cudaStream_t s) {
  int R = 1;
  FwdKernel k = nullptr;
  const cudaError_t err = pick_rows<KS>(fwd_for<KS>, with_res != 0, B, ny, fwd_smem<KS>, &R, &k);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<dim3((B + R - 1) / R, ny), Q * units(H), fwd_smem<KS>(R), s>>>(d, B, T, H, reset_after,
                                                                     hard);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_bwd_reg(const Dirs<BwdDir>& d, int ny, int B, int T, int H, int reset_after, int hard,
                   cudaStream_t s) {
  int R = 1;
  BwdKernel k = nullptr;
  const cudaError_t err = pick_rows<KS>(bwd_for<KS>, false, B, ny, bwd_smem<KS>, &R, &k);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<dim3((B + R - 1) / R, ny), Q * units(H), bwd_smem<KS>(R), s>>>(d, B, T, H, reset_after,
                                                                     hard);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gru_wide_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// ndir (1 or 2) directions of nseed seeds (nseed > 1 only with both
// directions), each xp (nseed, B, T, 3H), wh (nseed, H, 3H), bh (nseed, 3H)
// or null, h0 (nseed, B, H) -> ys (nseed, B, T, H), res (nseed, B, T, RW)
// when with_res, h_last (nseed, B, H); float32, contiguous, on the device of
// `stream`; H <= 128.
int gru_wide_fwd_launch(const FwdDir* dirs, int ndir, int nseed, int B, int T, int H,
                        int reset_after, int hard_sigmoid, int with_res, void* stream) {
  if (bad_shape(ndir, nseed, B, T, H) || H > REG_MAX_H)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dirs<FwdDir> d = pack(dirs, ndir);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ny = ndir * nseed;
  switch (slice_len(H)) {
    case 8: return launch_fwd_reg<8>(d, ny, B, T, H, reset_after, hard_sigmoid, with_res, s);
    case 16: return launch_fwd_reg<16>(d, ny, B, T, H, reset_after, hard_sigmoid, with_res, s);
    case 24: return launch_fwd_reg<24>(d, ny, B, T, H, reset_after, hard_sigmoid, with_res, s);
    default: return launch_fwd_reg<32>(d, ny, B, T, H, reset_after, hard_sigmoid, with_res, s);
  }
}

// ndir directions of nseed seeds, each ys (nseed, B, T, H), res (nseed, B,
// T, RW), wh (nseed, H, 3H), h0 (nseed, B, H), dys (nseed, B, T, H), dhl
// (nseed, B, H) -> dxp (nseed, B, T, 3H), dh0 (nseed, B, H); H <= 128.
int gru_wide_bwd_launch(const BwdDir* dirs, int ndir, int nseed, int B, int T, int H,
                        int reset_after, int hard_sigmoid, void* stream) {
  if (bad_shape(ndir, nseed, B, T, H) || H > REG_MAX_H)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dirs<BwdDir> d = pack(dirs, ndir);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ny = ndir * nseed;
  switch (slice_len(H)) {
    case 8: return launch_bwd_reg<8>(d, ny, B, T, H, reset_after, hard_sigmoid, s);
    case 16: return launch_bwd_reg<16>(d, ny, B, T, H, reset_after, hard_sigmoid, s);
    case 24: return launch_bwd_reg<24>(d, ny, B, T, H, reset_after, hard_sigmoid, s);
    default: return launch_bwd_reg<32>(d, ny, B, T, H, reset_after, hard_sigmoid, s);
  }
}

}  // extern "C"
