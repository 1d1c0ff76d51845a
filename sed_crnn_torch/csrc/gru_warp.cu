// GRU recurrence for Hopper (sm_90a) at hidden widths H <= 32: one warp per
// batch row, the recurrent weights in registers, one or two directions of a
// BiGRU in one launch, and the backward's dwh/dbh reduced after the chain.
//
// Replaces, for H <= 32 (every preset: sednet 32/32, timepooled-v1 32/32,
// timepooled-v2 16/8), the TPU kernels of sed_crnn_tpu/ops/pallas/gru_scan.py:
//   * `_fwd_kernel` with with_res=False (`gru_scan_tc`) and with_res=True
//     (`_gru_fwd`): gru_warp_fwd<HP, false / true>;
//   * `_bwd_kernel` (`_gru_bwd`): gru_warp_bwd<HP> (the gradient chain:
//     dxp and dh0), then gru_warp_dwh (dwh and dbh from the stored rows, one
//     partial per block) and gru_warp_sum_partials (the partials added in
//     block order, so dwh is bitwise equal from run to run).
// csrc/gru_scan.cu keeps serving 32 < H <= 128 (forward) and <= 64
// (backward). The contract is the same: pre-projected inputs xp = x @ wi + bi
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
//
// What bounds them: latency. The T steps of a direction form one chain of
// dependent steps, each a (1, H) x (H, 3H) product plus gates; the bytes (xp
// in, ys and res out, 0.1 MB per direction at B=1, T=256, H=32) and FLOPs
// are tiny next to the card's rates, so the roofline bound (about 0.04 us at
// B=1) is kept for the record only. A step costs its dependent instructions
// on the one warp that owns the row: at H=32 about 240 (the broadcast reads
// and 96 FMAs of the dot products, the gates, the stores), 0.33-0.36 us a
// step forward and 0.35 us backward on an H100, where the first body
// (csrc/gru_scan.cu) took 1.0 and 6.97 us.
//
// What the design does about it:
//   * registers, not shared memory: lane j owns hidden unit j and holds the
//     three weight columns it needs (wh[:, j], wh[:, H+j], wh[:, 2H+j]; in
//     the backward row j of wh) in 3 * HP registers, loaded once, so a step
//     reads only the broadcast state from shared memory;
//   * warp-local sync: the state is broadcast through a per-warp shared row
//     (written, __syncwarp, read back as float4 broadcasts); no block
//     barrier on the chain. HP = H rounded up to a power of two (4..32);
//     a warp carries 32 / HP batch rows, lanes beyond H hold zeros;
//   * short FMA chains: each dot product keeps four independent
//     accumulators (one per float4 component), so its dependent chain is
//     HP / 4 deep rather than H;
//   * deep prefetch: the per-step inputs (xp forward; h_prev, gates and dys
//     backward) are copied STAGES - 1 steps ahead into a per-warp ring in
//     shared memory with cp.async, so a load from L2 or HBM never waits on
//     the chain (a ring of registers filled by plain loads left the backward
//     chain at 0.51 us a step on an H100, this ring at 0.33-0.35); the
//     copies take no branch and the ring's shared address is computed once,
//     which took another 12 % off the forward's step;
//   * cheap gates: sigmoid and tanh from __expf and __fdividef (a fifth off
//     the forward's step against expf, a division and tanhf on an H100),
//     within a few 1e-7 of the plain version's;
//   * directions and seeds in parallel: grid.y is 2 * seed + direction,
//     each direction with its own pointers and time order, so the two
//     recurrences of a BiGRU run side by side; one warp per block, so B=128 x
//     2 directions spread over the SMs. Stacked multi-seed training runs S
//     independent weight sets at once: every tensor of a direction holds S
//     seeds one after another (xp (S, B, T, 3H), wh (S, H, 3H), ...), so
//     seed s of a direction is its pointer plus s times the tensor's size per
//     seed, and one launch takes all S seeds x 2 directions;
//   * the dwh reduction off the chain: dwh[:, :2H] = sum h_prev^T dxp[:, :2H],
//     dwh[:, 2H:] = sum (r h_prev)^T da_n (reset_after=0) or
//     sum h_prev^T (da_n r) (reset_after=1), dbh = sum [da_r, da_z, da_n r],
//     over the B*T stored rows in float32 FMAs (no tensor cores: float32
//     keeps the 1e-4 band) by a tiled kernel after the chain, each block a
//     fixed slice of rows, each thread a 4 x 4 register tile.
// Static shared memory only (under 48 KB), so no launch sets an attribute.

#include <cuda_runtime.h>
#include <math.h>

// One direction's operands; the C entry points take an array of 1 or 2.
// Each pointer is that of seed 0; the kernels step to seed s by the
// tensor's size per seed, from B, T and H.
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
constexpr int STAGES = 8;           // staging ring: STAGES - 1 steps in flight
constexpr int DWH_THREADS = 256;
constexpr int DWH_TILE = 32;        // rows staged in shared memory at a time
constexpr int DWH_MAX_BLOCKS = 128; // partials per (seed, direction)

template <typename D>
struct Dirs {
  D d[MAX_DIRS];
};

// A field of this block's direction (bit 0 of grid.y; the rest is the
// seed), selected field by field so that the kernel never copies a whole
// direction struct to local memory.
#define PICK(field) ((blockIdx.y & 1) ? dirs.d[1].field : dirs.d[0].field)

__device__ __forceinline__ size_t seed_of_block() { return blockIdx.y >> 1; }

// The gates from the hardware's exp2 and reciprocal (__expf, __fdividef):
// within a few 1e-7 of the correctly rounded functions, and at the extremes
// exactly 0, 1 or -1 (__fdividef of a huge or infinite divisor gives 0).
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

// sum_k row[k] * w[k] over HP terms, row in shared memory (16-byte aligned),
// four independent accumulators of HP / 4 terms each.
template <int HP>
__device__ __forceinline__ float dot(const float* row, const float (&w)[HP]) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int k = 0; k < HP; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    a0 = fmaf(v.x, w[k], a0);
    a1 = fmaf(v.y, w[k + 1], a1);
    a2 = fmaf(v.z, w[k + 2], a2);
    a3 = fmaf(v.w, w[k + 3], a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// Asynchronous 4-byte copy from device to shared memory (sm_80+): the copy
// does not hold a register or a dependency barrier of the issuing warp, and
// cp.async.wait_group waits for the older groups only.
using SharedAddr = unsigned;               // the 32-bit address cp.async takes

__device__ __forceinline__ SharedAddr shared_addr(const float* p) {
  return static_cast<SharedAddr>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(SharedAddr dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int HP, bool WITH_RES>
__global__ void __launch_bounds__(32) gru_warp_fwd(Dirs<FwdDir> dirs, int B, int T, int H,
                                                   int reset_after, int hard) {
  constexpr int S = STAGES;
  const int H3 = 3 * H;
  const int RW = reset_after ? 4 * H : H3;
  const size_t seed = seed_of_block();
  const float* wh = PICK(wh) + seed * H * H3;
  const float* bh = reset_after ? PICK(bh) + seed * H3 : nullptr;
  const int rev = PICK(reverse);
  const int lane = threadIdx.x;
  const int seg = lane / HP;               // batch row within the warp
  const int j = lane % HP;                 // hidden unit
  const int b = blockIdx.x * (32 / HP) + seg;
  const bool act = b < B && j < H;

  // Per-warp broadcast rows: h (double-buffered: one barrier per step when
  // reset_after) and r * h; and the staging ring of xp, each lane's own three
  // inputs of a step in slot i % S.
  __shared__ __align__(16) float s_h[2][32];
  __shared__ __align__(16) float s_rh[32];
  __shared__ float s_x[S][3][32];

  float wr[HP], wz[HP], wn[HP];
#pragma unroll
  for (int k = 0; k < HP; ++k) {
    const bool ok = j < H && k < H;
    wr[k] = ok ? wh[k * H3 + j] : 0.f;
    wz[k] = ok ? wh[k * H3 + H + j] : 0.f;
    wn[k] = ok ? wh[k * H3 + 2 * H + j] : 0.f;
  }
  float br = 0.f, bz = 0.f, bn = 0.f;
  if (reset_after && j < H) {
    br = bh[j];
    bz = bh[H + j];
    bn = bh[2 * H + j];
  }
  const size_t bb = seed * B + (act ? b : 0);   // the row among all seeds' rows
  const float* x_b = PICK(xp) + bb * T * H3;
  float* y_b = PICK(ys) + bb * T * H;
  float* res_b = WITH_RES ? PICK(res) + bb * T * RW : nullptr;
  float h = act ? PICK(h0)[bb * H + j] : 0.f;

  // One group per step, so that group i is step i. Every lane copies a
  // word of the tensor (padded lanes their row's column H-1, steps past
  // the end the last step), so the copy needs no branch; what a padded lane
  // or a step past the end copies is never read.
  const float* x_lane = x_b + (j < H ? j : H - 1);
  const SharedAddr slot0 = shared_addr(&s_x[0][0][lane]);
  auto stage = [&](int i) {
    const int ic = i < T ? i : T - 1;
    const float* src = x_lane + (rev ? T - 1 - ic : ic) * H3;
    const SharedAddr dst = slot0 + (i % S) * (3 * 32 * 4);
    cp_async4(dst, src);
    cp_async4(dst + 32 * 4, src + H);
    cp_async4(dst + 64 * 4, src + 2 * H);
    cp_async_commit();
  };
  for (int i = 0; i < S - 1; ++i) stage(i);

  for (int i = 0; i < T; ++i) {
    const int t = rev ? T - 1 - i : i;
    cp_async_wait<S - 2>();                // step i's copies have landed
    const float* x = &s_x[i % S][0][lane];
    const float cr = act ? x[0] : 0.f, cz = act ? x[32] : 0.f, cn = act ? x[64] : 0.f;
    stage(i + S - 1);                      // into the slot step i - 1 read
    float* hrow = s_h[i & 1] + seg * HP;
    hrow[j] = h;
    __syncwarp();
    float r, z, n;
    if (reset_after) {
      const float hn = dot<HP>(hrow, wn) + bn;
      r = gate(cr + (dot<HP>(hrow, wr) + br), hard);
      z = gate(cz + (dot<HP>(hrow, wz) + bz), hard);
      n = tanh_fast(cn + r * hn);
      if (WITH_RES && act) res_b[t * RW + 3 * H + j] = hn;
    } else {
      r = gate(cr + dot<HP>(hrow, wr), hard);
      z = gate(cz + dot<HP>(hrow, wz), hard);
      float* rhrow = s_rh + seg * HP;
      rhrow[j] = r * h;
      __syncwarp();
      n = tanh_fast(cn + dot<HP>(rhrow, wn));
    }
    if (WITH_RES && act) {
      float* rt = res_b + t * RW;
      rt[j] = r;
      rt[H + j] = z;
      rt[2 * H + j] = n;
    }
    h = act ? (1.0f - z) * n + z * h : 0.f;
    if (act) y_b[t * H + j] = h;
  }
  cp_async_wait<0>();
  if (act) PICK(h_last)[bb * H + j] = h;
}

// Reverse-time gradient recurrence: lane j carries dh[j] of its row and holds
// row j of wh; each step broadcasts the row's gate-input gradients and writes
// dxp[t]. dwh and dbh are left to gru_warp_dwh.
template <int HP>
__global__ void __launch_bounds__(32) gru_warp_bwd(Dirs<BwdDir> dirs, int B, int T, int H,
                                                   int reset_after, int hard) {
  constexpr int S = STAGES;
  const int H3 = 3 * H;
  const int RW = reset_after ? 4 * H : H3;
  const size_t seed = seed_of_block();
  const float* wh = PICK(wh) + seed * H * H3;
  const int rev = PICK(reverse);
  const int lane = threadIdx.x;
  const int seg = lane / HP;
  const int j = lane % HP;
  const int b = blockIdx.x * (32 / HP) + seg;
  const bool act = b < B && j < H;

  // Per-warp broadcast rows, double-buffered: da_r | da_z | da_n (times r
  // when reset_after), each HP wide; and the staging ring of the saved
  // values, each lane's own h_prev, r, z, n, hn, dys of a step in slot i % S.
  __shared__ __align__(16) float s_da[2][3][32];
  __shared__ float s_q[S][6][32];

  float wr[HP], wz[HP], wn[HP];             // row j of wh
#pragma unroll
  for (int k = 0; k < HP; ++k) {
    const bool ok = j < H && k < H;
    wr[k] = ok ? wh[j * H3 + k] : 0.f;
    wz[k] = ok ? wh[j * H3 + H + k] : 0.f;
    wn[k] = ok ? wh[j * H3 + 2 * H + k] : 0.f;
  }
  const size_t bb = seed * B + (act ? b : 0);
  const float* y_b = PICK(ys) + bb * T * H;
  const float* res_b = PICK(res) + bb * T * RW;
  const float* dy_b = PICK(dys) + bb * T * H;
  float* dx_b = PICK(dxp) + bb * T * H3;
  const float h0j = act ? PICK(h0)[bb * H + j] : 0.f;
  float dh = act ? PICK(dhl)[bb * H + j] : 0.f;

  // Step i visits the forward's steps in reverse: t = T-1 .. 0 for a forward
  // direction, t = 0 .. T-1 for a reverse one. h_prev of step t is ys[t-1]
  // (forward) or ys[t+1] (reverse), and h0 at the chain's start (step T-1).
  // Branch-free copies as in the forward: the last step (which takes h0)
  // copies its own row in place of h_prev, and without reset_after the hn
  // slot gets n again; neither is read.
  const int jc = j < H ? j : H - 1;
  const SharedAddr slot0 = shared_addr(&s_q[0][0][lane]);
  auto stage = [&](int i) {
    const int ic = i < T ? i : T - 1;
    const int t = rev ? ic : T - 1 - ic;
    const int tp = ic == T - 1 ? t : rev ? t + 1 : t - 1;
    const float* rt = res_b + t * RW + jc;
    const SharedAddr dst = slot0 + (i % S) * (6 * 32 * 4);
    cp_async4(dst, y_b + tp * H + jc);
    cp_async4(dst + 32 * 4, rt);
    cp_async4(dst + 64 * 4, rt + H);
    cp_async4(dst + 96 * 4, rt + 2 * H);
    cp_async4(dst + 128 * 4, rt + (reset_after ? 3 * H : 2 * H));
    cp_async4(dst + 160 * 4, dy_b + t * H + jc);
    cp_async_commit();
  };
  for (int i = 0; i < S - 1; ++i) stage(i);

  for (int i = 0; i < T; ++i) {
    const int t = rev ? i : T - 1 - i;
    cp_async_wait<S - 2>();                // step i's copies have landed
    const float* q = &s_q[i % S][0][lane];
    const float hp = !act ? 0.f : i < T - 1 ? q[0] : h0j;
    const float r = act ? q[32] : 0.f, z = act ? q[64] : 0.f, n = act ? q[96] : 0.f;
    const float hn = act && reset_after ? q[128] : 0.f, dy = act ? q[160] : 0.f;
    stage(i + S - 1);                      // into the slot step i - 1 read

    const float dht = dy + dh;
    const float da_z = dht * (hp - n) * gate_grad(z, hard);
    const float da_n = dht * (1.0f - z) * (1.0f - n * n);
    float* ar = s_da[i & 1][0] + seg * HP;
    float* az = s_da[i & 1][1] + seg * HP;
    float* an = s_da[i & 1][2] + seg * HP;
    float da_r;
    if (reset_after) {
      da_r = da_n * hn * gate_grad(r, hard);
      ar[j] = da_r;
      az[j] = da_z;
      an[j] = da_n * r;
      __syncwarp();
      dh = dht * z + ((dot<HP>(ar, wr) + dot<HP>(az, wz)) + dot<HP>(an, wn));
    } else {
      az[j] = da_z;
      an[j] = da_n;
      __syncwarp();
      const float drh = dot<HP>(an, wn);
      da_r = drh * hp * gate_grad(r, hard);
      ar[j] = da_r;
      __syncwarp();
      dh = dht * z + (dot<HP>(ar, wr) + dot<HP>(az, wz)) + drh * r;
    }
    if (act) {
      float* dx_t = dx_b + t * H3;
      dx_t[j] = da_r;
      dx_t[H + j] = da_z;
      dx_t[2 * H + j] = da_n;
    } else {
      dh = 0.f;
    }
  }
  cp_async_wait<0>();
  if (act) PICK(dh0)[bb * H + j] = dh;
}

// One partial of dwh (H, 3H) and dbh (3H) per block over a fixed slice of the
// B*T rows (n = b*T + t). Each tile of DWH_TILE rows is staged in shared
// memory as L = [h_prev | r*h_prev | 1 0 0 0] and R = [da_r | da_z | da_n or
// da_n*r], each part HP wide and zero-padded; thread p owns the 4 x 4 block
// (k-group, column group) of L^T R, the last k-group being the bias row.
// Rows are added in index order, so a partial is the same from run to run.
template <int HP>
__global__ void __launch_bounds__(DWH_THREADS) gru_warp_dwh(Dirs<DwhDir> dirs, int B, int T,
                                                            int H, int reset_after, int nblk) {
  constexpr int LW = 2 * HP + 4;
  constexpr int KG = HP / 4 + 1;           // k-groups, the last one the bias
  constexpr int CG = 3 * HP / 4;           // column groups
  static_assert(KG * CG <= DWH_THREADS, "one 4 x 4 tile per thread");
  const int H3 = 3 * H;
  const int RW = reset_after ? 4 * H : H3;
  const long long N = (long long)B * T;
  const size_t seed = seed_of_block();
  const float* ys = PICK(ys) + seed * N * H;
  const float* res = PICK(res) + seed * N * RW;
  const float* h0 = PICK(h0) + seed * B * H;
  const float* dxp = PICK(dxp) + seed * N * H3;
  const int rev = PICK(reverse);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long chunk = (N + nblk - 1) / nblk;
  const long long n_lo = blockIdx.x * chunk;
  const long long n_hi = n_lo + chunk < N ? n_lo + chunk : N;

  __shared__ __align__(16) float sL[DWH_TILE][LW];
  __shared__ __align__(16) float sR[DWH_TILE][3 * HP];

  const int kg = tid / CG, cg = tid % CG;
  const bool owner = tid < KG * CG;
  const int part3 = cg / (HP / 4);         // 0: r, 1: z, 2: candidate columns
  const int c0 = (cg % (HP / 4)) * 4;      // first column within the part
  const bool bias = kg == HP / 4;
  const int loff = bias ? 2 * HP : (part3 == 2 && !reset_after ? HP : 0) + 4 * kg;
  const int roff = part3 * HP + c0;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (long long n0 = n_lo; n0 < n_hi; n0 += DWH_TILE) {
    for (int rr = warp; rr < DWH_TILE; rr += DWH_THREADS / 32) {
      const long long n = n0 + rr;
      float hp = 0.f, r = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
      if (n < n_hi && lane < H) {
        const long long bq = n / T;
        const int t = (int)(n - bq * T);
        const bool first = rev ? (t == T - 1) : (t == 0);
        hp = first ? h0[bq * H + lane] : ys[(n + (rev ? 1 : -1)) * H + lane];
        r = res[n * RW + lane];
        const float* dx = dxp + n * H3;
        d0 = dx[lane];
        d1 = dx[H + lane];
        d2 = dx[2 * H + lane];
        if (reset_after) d2 *= r;
      }
      if (lane < HP) {
        sL[rr][lane] = hp;
        sL[rr][HP + lane] = r * hp;
        sR[rr][lane] = d0;
        sR[rr][HP + lane] = d1;
        sR[rr][2 * HP + lane] = d2;
      }
      if (lane < 4) sL[rr][2 * HP + lane] = lane == 0 ? 1.f : 0.f;
    }
    __syncthreads();
    if (owner) {
      const int rows = n_hi - n0 < DWH_TILE ? (int)(n_hi - n0) : DWH_TILE;
      for (int rr = 0; rr < rows; ++rr) {
        const float4 l = *reinterpret_cast<const float4*>(&sL[rr][loff]);
        const float4 v = *reinterpret_cast<const float4*>(&sR[rr][roff]);
        const float lv[4] = {l.x, l.y, l.z, l.w};
        const float rv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(lv[a], rv[c], acc[a][c]);
      }
    }
    __syncthreads();
  }

  if (!owner) return;
  float* p = PICK(part) + (seed * nblk + blockIdx.x) * (H * H3 + H3);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cc = c0 + c;
    if (cc >= H) continue;
    const int col = part3 * H + cc;
    if (bias) {
      p[H * H3 + col] = reset_after ? acc[0][c] : 0.f;
      continue;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int k = 4 * kg + a;
      if (k < H) p[k * H3 + col] = acc[a][c];
    }
  }
}

// out[q][e] = sum over blocks of part[q][blk][e], blocks added in index
// order, for each (direction, seed) row q.
__global__ void gru_warp_sum(const float* __restrict__ part, float* __restrict__ out,
                             int nblk, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float* p = part + (size_t)blockIdx.y * nblk * n + e;
  float s = 0.0f;
  for (int k = 0; k < nblk; ++k) s += p[(size_t)k * n];
  out[(size_t)blockIdx.y * n + e] = s;
}

// Host side ------------------------------------------------------------------

int padded(int H) { return H <= 4 ? 4 : H <= 8 ? 8 : H <= 16 ? 16 : 32; }

// More than one seed takes both directions: grid.y is 2 * seed + direction.
bool bad_shape(int ndir, int nseed, int B, int T, int H) {
  return ndir < 1 || ndir > MAX_DIRS || nseed < 1 || (nseed > 1 && ndir != MAX_DIRS) ||
         B <= 0 || T <= 0 || H <= 0 || H > 32;
}

template <typename D>
Dirs<D> pack(const D* dirs, int ndir) {
  Dirs<D> out = {};
  for (int i = 0; i < ndir; ++i) out.d[i] = dirs[i];
  return out;
}

template <int HP>
void launch_fwd(const Dirs<FwdDir>& dirs, int ny, int B, int T, int H, int reset_after,
                int hard, int with_res, cudaStream_t stream) {
  const dim3 grid((B + 32 / HP - 1) / (32 / HP), ny);
  if (with_res) {
    gru_warp_fwd<HP, true><<<grid, 32, 0, stream>>>(dirs, B, T, H, reset_after, hard);
  } else {
    gru_warp_fwd<HP, false><<<grid, 32, 0, stream>>>(dirs, B, T, H, reset_after, hard);
  }
}

template <int HP>
void launch_bwd(const Dirs<BwdDir>& dirs, int ny, int B, int T, int H, int reset_after,
                int hard, cudaStream_t stream) {
  const dim3 grid((B + 32 / HP - 1) / (32 / HP), ny);
  gru_warp_bwd<HP><<<grid, 32, 0, stream>>>(dirs, B, T, H, reset_after, hard);
}

template <int HP>
void launch_dwh(const Dirs<DwhDir>& dirs, int ny, int B, int T, int H, int reset_after,
                int nblk, cudaStream_t stream) {
  gru_warp_dwh<HP><<<dim3(nblk, ny), DWH_THREADS, 0, stream>>>(dirs, B, T, H, reset_after,
                                                               nblk);
}

}  // namespace

extern "C" {

const char* gru_warp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// ndir (1 or 2) directions of nseed seeds (nseed > 1 only with both
// directions), each xp (nseed, B, T, 3H), wh (nseed, H, 3H), bh (nseed, 3H)
// or null, h0 (nseed, B, H) -> ys (nseed, B, T, H), res (nseed, B, T, RW)
// when with_res, h_last (nseed, B, H); float32, contiguous, on the device of
// `stream`; 0 < H <= 32.
int gru_warp_fwd_launch(const FwdDir* dirs, int ndir, int nseed, int B, int T, int H,
                        int reset_after, int hard_sigmoid, int with_res, void* stream) {
  if (bad_shape(ndir, nseed, B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const Dirs<FwdDir> d = pack(dirs, ndir);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ny = ndir * nseed;
  switch (padded(H)) {
    case 4: launch_fwd<4>(d, ny, B, T, H, reset_after, hard_sigmoid, with_res, s); break;
    case 8: launch_fwd<8>(d, ny, B, T, H, reset_after, hard_sigmoid, with_res, s); break;
    case 16: launch_fwd<16>(d, ny, B, T, H, reset_after, hard_sigmoid, with_res, s); break;
    default: launch_fwd<32>(d, ny, B, T, H, reset_after, hard_sigmoid, with_res, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// ndir directions of nseed seeds, each ys (nseed, B, T, H), res (nseed, B,
// T, RW), wh (nseed, H, 3H), h0 (nseed, B, H), dys (nseed, B, T, H), dhl
// (nseed, B, H) -> dxp (nseed, B, T, 3H), dh0 (nseed, B, H).
int gru_warp_bwd_launch(const BwdDir* dirs, int ndir, int nseed, int B, int T, int H,
                        int reset_after, int hard_sigmoid, void* stream) {
  if (bad_shape(ndir, nseed, B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const Dirs<BwdDir> d = pack(dirs, ndir);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ny = ndir * nseed;
  switch (padded(H)) {
    case 4: launch_bwd<4>(d, ny, B, T, H, reset_after, hard_sigmoid, s); break;
    case 8: launch_bwd<8>(d, ny, B, T, H, reset_after, hard_sigmoid, s); break;
    case 16: launch_bwd<16>(d, ny, B, T, H, reset_after, hard_sigmoid, s); break;
    default: launch_bwd<32>(d, ny, B, T, H, reset_after, hard_sigmoid, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Partials gru_warp_dwh_launch writes per (seed, direction) for B*T rows.
int gru_warp_dwh_blocks(int B, int T) {
  const long long rows = (long long)B * T;
  const long long tiles = (rows + DWH_TILE - 1) / DWH_TILE;
  return (int)(tiles < DWH_MAX_BLOCKS ? (tiles > 0 ? tiles : 1) : DWH_MAX_BLOCKS);
}

// ndir directions of nseed seeds, each ys (nseed, B, T, H), res (nseed, B,
// T, RW), h0 (nseed, B, H), dxp (nseed, B, T, 3H) -> part (nseed,
// gru_warp_dwh_blocks(B, T), 3H * H + 3H): per block, dwh (row-major (H,
// 3H)) then dbh (zeros unless reset_after).
int gru_warp_dwh_launch(const DwhDir* dirs, int ndir, int nseed, int B, int T, int H,
                        int reset_after, void* stream) {
  if (bad_shape(ndir, nseed, B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const Dirs<DwhDir> d = pack(dirs, ndir);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = gru_warp_dwh_blocks(B, T);
  const int ny = ndir * nseed;
  switch (padded(H)) {
    case 4: launch_dwh<4>(d, ny, B, T, H, reset_after, nblk, s); break;
    case 8: launch_dwh<8>(d, ny, B, T, H, reset_after, nblk, s); break;
    case 16: launch_dwh<16>(d, ny, B, T, H, reset_after, nblk, s); break;
    default: launch_dwh<32>(d, ny, B, T, H, reset_after, nblk, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// out (nrows, n) = part (nrows, nblk, n) summed over its block axis in index
// order; a row per (direction, seed).
int gru_warp_sum_partials(const float* part, float* out, int nrows, int nblk, int n,
                          void* stream) {
  if (nrows < 1 || nrows > 65535 || nblk <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  gru_warp_sum<<<dim3((n + threads - 1) / threads, nrows), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(part, out, nblk, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
