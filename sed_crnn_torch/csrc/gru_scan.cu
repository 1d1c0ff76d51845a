// GRU recurrence for Hopper (sm_90a): one direction, all T steps in one
// launch, forward and backward.
//
// Replaces the TPU kernels of sed_crnn_tpu/ops/pallas/gru_scan.py:
//   * `_fwd_kernel` with with_res=False (launched by `_fwd_call` from
//     `gru_scan_tc`): gru_fwd_kernel<false>, the serving forward;
//   * `_fwd_kernel` with with_res=True (from `_gru_fwd`): gru_fwd_kernel<true>,
//     which also stores the gates r|z|n of every step (plus the projected
//     candidate hn when reset_after) for the backward;
//   * `_bwd_kernel` (from `_gru_bwd`): gru_bwd_kernel, the reverse-time
//     recurrence of the gradient, plus gru_sum_partials, which adds the
//     per-block partial dwh/dbh in a fixed order.
// Same contract: pre-projected inputs xp = x @ wi + bi, recurrent kernel wh
// (H, 3H) in gate order (reset, update, candidate), bias bh (3H) read only
// when reset_after, initial state h0; outputs ys (every step's state) and
// h_last. Both conventions:
//   reset_after=1 (torch/cuDNN): hp = h @ wh + bh; r = g(xr + hp_r);
//       z = g(xz + hp_z); n = tanh(xn + r * hp_n)
//   reset_after=0 (keras-2.2 SEDnet): r = g(xr + h @ wh_r); z = g(xz + h @ wh_z);
//       n = tanh(xn + (r * h) @ wh_n)      -- two dependent phases per step
//   h' = (1 - z) * n + z * h
// Gate g is the logistic sigmoid or keras-2.2 hard_sigmoid
// clip(0.2 v + 0.5, 0, 1) (not torch's relu6(v + 3) / 6). The backward takes
// gate derivatives from the stored outputs: g(1 - g) for the sigmoid, 0.2 on
// the open interval (0, 1) for hard_sigmoid, as the TPU kernel does.
//
// What bounds them: latency. Each step is a (rows, H) x (H, 3H) product that
// depends on the previous step, so the T steps form one serial chain; the
// bytes (xp in, ys and res out; ys, res, dys in, dxp out) and FLOPs are tiny
// next to what the card can move or compute. The design keeps the chain
// short: a block owns a tile of batch rows (rows are independent, so no
// grid-wide sync), holds the weights and the per-step state in shared memory
// for the whole sequence, gives each hidden unit of a row its own thread,
// and loads the next step's inputs into registers before the current step's
// arithmetic so that the global load latency leaves the chain. Any T and B
// are taken: every per-step array streams from and to device memory.
//
// The backward differs from the TPU kernel in two places. (1) The TPU kernel
// reduced dwh/dbh over the whole batch inside one program; here each block
// accumulates its rows' share over all T steps in shared memory (each
// element owned by one thread, so no atomics), writes one partial per block,
// and gru_sum_partials adds the partials in block order: deterministic, run
// to run. (2) dh = da @ wh^T has thread j read row j of wh, a stride of 3H
// words that puts every thread of a warp on one bank; the block keeps the
// transposed copy whT (3H, H) instead, so thread j reads column j.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float gate(float v, int hard) {
  return hard ? fminf(fmaxf(0.2f * v + 0.5f, 0.0f), 1.0f)
              : 1.0f / (1.0f + expf(-v));
}

// d gate / d pre-activation from the gate's output value.
__device__ __forceinline__ float gate_grad(float g, int hard) {
  return hard ? ((g > 0.0f && g < 1.0f) ? 0.2f : 0.0f) : g * (1.0f - g);
}

template <bool WITH_RES>
__global__ void gru_fwd_kernel(const float* __restrict__ xp,
                               const float* __restrict__ wh,
                               const float* __restrict__ bh,
                               const float* __restrict__ h0,
                               float* __restrict__ ys,
                               float* __restrict__ res,
                               float* __restrict__ h_last,
                               int B, int T, int H, int reset_after, int hard,
                               int reverse) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  const int R = blockDim.y;
  float* s_wh = smem;              // (H, 3H)
  float* s_bh = s_wh + H * H3;     // (3H)
  float* s_h = s_bh + H3;          // (R, H) current state
  float* s_rh = s_h + R * H;       // (R, H) r * h (reset_after=0 only)

  const int j = threadIdx.x;       // hidden unit
  const int row = threadIdx.y;     // batch row within the block
  const int tid = row * H + j;
  const int nthreads = H * R;
  for (int i = tid; i < H * H3; i += nthreads) s_wh[i] = wh[i];
  for (int i = tid; i < H3; i += nthreads) s_bh[i] = reset_after ? bh[i] : 0.0f;

  const int b = blockIdx.x * R + row;
  const bool active = b < B;
  float* hrow = s_h + row * H;
  float* rhrow = s_rh + row * H;
  float h = active ? h0[(size_t)b * H + j] : 0.0f;
  hrow[j] = h;
  const float* x_b = xp + (size_t)(active ? b : 0) * T * H3;
  float* y_b = ys + (size_t)(active ? b : 0) * T * H;
  const int RW = reset_after ? 4 * H : H3;   // residual row width
  float* res_b = WITH_RES ? res + (size_t)(active ? b : 0) * T * RW : nullptr;

  int t = reverse ? T - 1 : 0;
  float xr = 0.f, xz = 0.f, xn = 0.f;
  if (active) {
    xr = x_b[(size_t)t * H3 + j];
    xz = x_b[(size_t)t * H3 + H + j];
    xn = x_b[(size_t)t * H3 + 2 * H + j];
  }
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    t = reverse ? T - 1 - i : i;
    const float cr = xr, cz = xz, cn = xn;
    if (active && i + 1 < T) {     // prefetch the next step's inputs
      const size_t o = (size_t)(reverse ? t - 1 : t + 1) * H3;
      xr = x_b[o + j];
      xz = x_b[o + H + j];
      xn = x_b[o + 2 * H + j];
    }
    float r, z, n;
    if (reset_after) {
      float ar = 0.f, az = 0.f, an = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float hk = hrow[k];
        const float* w = s_wh + k * H3;
        ar = fmaf(hk, w[j], ar);
        az = fmaf(hk, w[H + j], az);
        an = fmaf(hk, w[2 * H + j], an);
      }
      const float hn = an + s_bh[2 * H + j];
      r = gate(cr + (ar + s_bh[j]), hard);
      z = gate(cz + (az + s_bh[H + j]), hard);
      n = tanhf(cn + r * hn);
      if (WITH_RES && active) res_b[(size_t)t * RW + 3 * H + j] = hn;
      __syncthreads();             // every read of hrow for this step is done
    } else {
      float ar = 0.f, az = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float hk = hrow[k];
        const float* w = s_wh + k * H3;
        ar = fmaf(hk, w[j], ar);
        az = fmaf(hk, w[H + j], az);
      }
      r = gate(cr + ar, hard);
      z = gate(cz + az, hard);
      rhrow[j] = r * h;
      __syncthreads();             // r * h complete; hrow no longer read
      float an = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) an = fmaf(rhrow[k], s_wh[k * H3 + 2 * H + j], an);
      n = tanhf(cn + an);
    }
    if (WITH_RES && active) {
      float* rt = res_b + (size_t)t * RW;
      rt[j] = r;
      rt[H + j] = z;
      rt[2 * H + j] = n;
    }
    h = (1.0f - z) * n + z * h;
    hrow[j] = h;
    if (active) y_b[(size_t)t * H + j] = h;
    __syncthreads();             // new state visible; rhrow reads done
  }
  if (active) h_last[(size_t)b * H + j] = h;
}

// Reverse-time gradient recurrence for one direction. Thread (row, j) carries
// dh[j] of its batch row in a register; the block's rows share whT, the
// step's gate gradients and predecessor states, and the partial dwh/dbh.
__global__ void gru_bwd_kernel(const float* __restrict__ ys,
                               const float* __restrict__ res,
                               const float* __restrict__ wh,
                               const float* __restrict__ h0,
                               const float* __restrict__ dys,
                               const float* __restrict__ dhl,
                               float* __restrict__ dxp,
                               float* __restrict__ dh0,
                               float* __restrict__ part,
                               int B, int T, int H, int reset_after, int hard,
                               int reverse) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  const int R = blockDim.y;
  const int RW = reset_after ? 4 * H : H3;
  float* s_whT = smem;             // (3H, H): s_whT[c * H + k] = wh[k, c]
  float* s_dwh = s_whT + H3 * H;   // (H, 3H) this block's partial dwh
  float* s_dbh = s_dwh + H * H3;   // (3H) partial dbh (reset_after only)
  float* s_da = s_dbh + H3;        // (R, 3H) gradients of the gate inputs
  float* s_hp = s_da + R * H3;     // (R, H) predecessor state h_prev
  float* s_rhp = s_hp + R * H;     // (R, H) r * h_prev (reset_after=0 only)

  const int j = threadIdx.x;
  const int row = threadIdx.y;
  const int tid = row * H + j;
  const int nthreads = H * R;
  for (int i = tid; i < H * H3; i += nthreads) {
    const int k = i / H3, c = i % H3;
    s_whT[c * H + k] = wh[i];
    s_dwh[i] = 0.0f;
  }
  for (int i = tid; i < H3; i += nthreads) s_dbh[i] = 0.0f;

  const int b = blockIdx.x * R + row;
  const bool active = b < B;
  const size_t bb = (size_t)(active ? b : 0);
  const float* y_b = ys + bb * T * H;
  const float* res_b = res + bb * T * RW;
  const float* dy_b = dys + bb * T * H;
  float* dx_b = dxp + bb * T * H3;
  float* da = s_da + row * H3;
  float* hprow = s_hp + row * H;
  float* rhprow = s_rhp + row * H;
  const float h0j = active ? h0[bb * H + j] : 0.0f;
  float dh = active ? dhl[bb * H + j] : 0.0f;

  // Step i visits the forward's steps in reverse: t = T-1 .. 0 for a forward
  // direction, t = 0 .. T-1 for a reverse one. The predecessor state of step
  // t is ys[t-1] (forward) or ys[t+1] (reverse), and h0 at the chain's start.
  float hp = 0.f, r = 0.f, z = 0.f, n = 0.f, hn = 0.f, dy = 0.f;
  auto load = [&](int t) {
    if (!active) return;
    const bool first = reverse ? (t == T - 1) : (t == 0);
    hp = first ? h0j : y_b[(size_t)(reverse ? t + 1 : t - 1) * H + j];
    const float* rt = res_b + (size_t)t * RW;
    r = rt[j];
    z = rt[H + j];
    n = rt[2 * H + j];
    if (reset_after) hn = rt[3 * H + j];
    dy = dy_b[(size_t)t * H + j];
  };
  load(reverse ? 0 : T - 1);
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int t = reverse ? i : T - 1 - i;
    const float chp = hp, cr = r, cz = z, cn = n, chn = hn, cdy = dy;
    if (i + 1 < T) load(reverse ? t + 1 : t - 1);   // prefetch the next step

    const float dht = cdy + dh;
    const float da_z = dht * (chp - cn) * gate_grad(cz, hard);
    const float da_n = dht * (1.0f - cz) * (1.0f - cn * cn);
    float* dx_t = dx_b + (size_t)t * H3;
    if (reset_after) {
      const float da_r = da_n * chn * gate_grad(cr, hard);
      // gradient of the projected hidden state hp = h_prev @ wh + bh
      da[j] = active ? da_r : 0.0f;
      da[H + j] = active ? da_z : 0.0f;
      da[2 * H + j] = active ? da_n * cr : 0.0f;
      hprow[j] = active ? chp : 0.0f;
      if (active) {
        dx_t[j] = da_r;
        dx_t[H + j] = da_z;
        dx_t[2 * H + j] = da_n;
      }
      __syncthreads();             // the row's da and h_prev complete
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < H3; ++c) acc = fmaf(da[c], s_whT[c * H + j], acc);
      dh = dht * cz + acc;
      for (int e = tid; e < H * H3; e += nthreads) {
        const int k = e / H3, c = e % H3;
        float s = s_dwh[e];
        for (int rr = 0; rr < R; ++rr) s = fmaf(s_hp[rr * H + k], s_da[rr * H3 + c], s);
        s_dwh[e] = s;
      }
      for (int c = tid; c < H3; c += nthreads) {
        float s = s_dbh[c];
        for (int rr = 0; rr < R; ++rr) s += s_da[rr * H3 + c];
        s_dbh[c] = s;
      }
    } else {
      da[H + j] = active ? da_z : 0.0f;
      da[2 * H + j] = active ? da_n : 0.0f;
      hprow[j] = active ? chp : 0.0f;
      __syncthreads();             // da_n of the row complete
      float drh = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) drh = fmaf(da[2 * H + k], s_whT[(2 * H + k) * H + j], drh);
      const float da_r = drh * chp * gate_grad(cr, hard);
      da[j] = active ? da_r : 0.0f;
      rhprow[j] = active ? cr * chp : 0.0f;
      if (active) {
        dx_t[j] = da_r;
        dx_t[H + j] = da_z;
        dx_t[2 * H + j] = da_n;
      }
      __syncthreads();             // da_r and r * h_prev of the row complete
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < 2 * H; ++c) acc = fmaf(da[c], s_whT[c * H + j], acc);
      dh = dht * cz + acc + drh * cr;
      for (int e = tid; e < H * H3; e += nthreads) {
        const int k = e / H3, c = e % H3;
        const float* src = c < 2 * H ? s_hp : s_rhp;
        float s = s_dwh[e];
        for (int rr = 0; rr < R; ++rr) s = fmaf(src[rr * H + k], s_da[rr * H3 + c], s);
        s_dwh[e] = s;
      }
    }
    __syncthreads();             // s_da, s_hp and s_rhp free for the next step
  }
  if (active) dh0[bb * H + j] = dh;
  float* p = part + (size_t)blockIdx.x * (H * H3 + H3);
  for (int i = tid; i < H * H3; i += nthreads) p[i] = s_dwh[i];
  for (int i = tid; i < H3; i += nthreads) p[H * H3 + i] = s_dbh[i];
}

// out[e] = sum over blocks of part[blk][e], blocks added in index order.
__global__ void gru_sum_partials(const float* __restrict__ part,
                                 float* __restrict__ out, int nblk, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int k = 0; k < nblk; ++k) s += part[(size_t)k * n + e];
  out[e] = s;
}

int rows_per_block(int H, int B) {
  int rows = 128 / H;
  if (rows < 1) rows = 1;
  if (rows > B) rows = B;
  return rows;
}

template <bool WITH_RES>
int launch_fwd(const float* xp, const float* wh, const float* bh, const float* h0,
               float* ys, float* res, float* h_last, int B, int T, int H,
               int reset_after, int hard_sigmoid, int reverse, void* stream) {
  if (H <= 0 || H > 1024 || B <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = rows_per_block(H, B);
  const dim3 block(H, rows);
  const dim3 grid((B + rows - 1) / rows);
  const size_t smem = sizeof(float) * ((size_t)H * 3 * H + 3 * H + 2 * (size_t)rows * H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<WITH_RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_fwd_kernel<WITH_RES><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, wh, bh, h0, ys, res, h_last, B, T, H, reset_after, hard_sigmoid, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gru_scan_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// xp (B, T, 3H), wh (H, 3H), bh (3H) or null, h0 (B, H) -> ys (B, T, H),
// h_last (B, H); all float32, contiguous, on the device of `stream`.
int gru_scan_fwd(const float* xp, const float* wh, const float* bh,
                 const float* h0, float* ys, float* h_last, int B, int T,
                 int H, int reset_after, int hard_sigmoid, int reverse,
                 void* stream) {
  return launch_fwd<false>(xp, wh, bh, h0, ys, nullptr, h_last, B, T, H,
                           reset_after, hard_sigmoid, reverse, stream);
}

// As gru_scan_fwd, and res (B, T, 4H if reset_after else 3H) receives
// r | z | n (| hn) of every step.
int gru_scan_fwd_res(const float* xp, const float* wh, const float* bh,
                     const float* h0, float* ys, float* res, float* h_last,
                     int B, int T, int H, int reset_after, int hard_sigmoid,
                     int reverse, void* stream) {
  return launch_fwd<true>(xp, wh, bh, h0, ys, res, h_last, B, T, H,
                          reset_after, hard_sigmoid, reverse, stream);
}

// Blocks the backward launches for a batch of B rows; `part` must hold
// gru_scan_bwd_blocks(H, B) * (3H * H + 3H) floats.
int gru_scan_bwd_blocks(int H, int B) {
  const int rows = rows_per_block(H, B);
  return (B + rows - 1) / rows;
}

// ys (B, T, H), res (B, T, RW), wh (H, 3H), h0 (B, H), dys (B, T, H),
// dhl (B, H) -> dxp (B, T, 3H), dh0 (B, H) and per-block partials
// part (nblk, 3H * H + 3H) of dwh (row-major (H, 3H)) then dbh.
int gru_scan_bwd(const float* ys, const float* res, const float* wh,
                 const float* h0, const float* dys, const float* dhl,
                 float* dxp, float* dh0, float* part, int B, int T, int H,
                 int reset_after, int hard_sigmoid, int reverse, void* stream) {
  if (H <= 0 || H > 1024 || B <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = rows_per_block(H, B);
  const dim3 block(H, rows);
  const dim3 grid((B + rows - 1) / rows);
  const size_t smem = sizeof(float) *
      (2 * (size_t)H * 3 * H + 3 * H + (size_t)rows * 3 * H + 2 * (size_t)rows * H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_bwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      ys, res, wh, h0, dys, dhl, dxp, dh0, part, B, T, H, reset_after,
      hard_sigmoid, reverse);
  return static_cast<int>(cudaGetLastError());
}

// out (n) = part (nblk, n) summed over its first axis in index order.
int gru_scan_sum_partials(const float* part, float* out, int nblk, int n,
                          void* stream) {
  if (nblk <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  gru_sum_partials<<<(n + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(part, out, nblk, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
