// GRU forward recurrence for Hopper (sm_90a): one direction, all T steps in
// one launch.
//
// Replaces the TPU kernel `_fwd_kernel` of sed_crnn_tpu/ops/pallas/gru_scan.py
// (launched by `_fwd_call`, with_res=False). Same contract: pre-projected
// inputs xp = x @ wi + bi, recurrent kernel wh (H, 3H) in gate order
// (reset, update, candidate), bias bh (3H) read only when reset_after, initial
// state h0; outputs ys (every step's state) and h_last. Both conventions:
//   reset_after=1 (torch/cuDNN): hp = h @ wh + bh; r = g(xr + hp_r);
//       z = g(xz + hp_z); n = tanh(xn + r * hp_n)
//   reset_after=0 (keras-2.2 SEDnet): r = g(xr + h @ wh_r); z = g(xz + h @ wh_z);
//       n = tanh(xn + (r * h) @ wh_n)      -- two dependent phases per step
//   h' = (1 - z) * n + z * h
// Gate g is the logistic sigmoid or keras-2.2 hard_sigmoid
// clip(0.2 v + 0.5, 0, 1) (not torch's relu6(v + 3) / 6).
//
// What bounds it: latency. Each step is a (rows, H) x (H, 3H) product that
// depends on the previous step, so the T steps form one serial chain; the
// bytes (xp in, ys out) and FLOPs are tiny next to what the card can move
// or compute. The design keeps the chain short: a block owns a tile of
// batch rows (rows are independent, so no grid-wide sync), holds wh, bh and
// the state in shared memory for the whole sequence, gives each hidden unit
// of a row its own thread (3H FMAs per step), and loads the next step's xp
// into registers before the current step's arithmetic so that the global
// load latency leaves the chain. Any T and B are taken: xp and ys stream
// from and to device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float gate(float v, int hard) {
  return hard ? fminf(fmaxf(0.2f * v + 0.5f, 0.0f), 1.0f)
              : 1.0f / (1.0f + expf(-v));
}

__global__ void gru_fwd_kernel(const float* __restrict__ xp,
                               const float* __restrict__ wh,
                               const float* __restrict__ bh,
                               const float* __restrict__ h0,
                               float* __restrict__ ys,
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
    float z, n;
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
      const float r = gate(cr + (ar + s_bh[j]), hard);
      z = gate(cz + (az + s_bh[H + j]), hard);
      n = tanhf(cn + r * (an + s_bh[2 * H + j]));
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
      const float r = gate(cr + ar, hard);
      z = gate(cz + az, hard);
      rhrow[j] = r * h;
      __syncthreads();             // r * h complete; hrow no longer read
      float an = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) an = fmaf(rhrow[k], s_wh[k * H3 + 2 * H + j], an);
      n = tanhf(cn + an);
    }
    h = (1.0f - z) * n + z * h;
    hrow[j] = h;
    if (active) y_b[(size_t)t * H + j] = h;
    __syncthreads();             // new state visible; rhrow reads done
  }
  if (active) h_last[(size_t)b * H + j] = h;
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
  if (H <= 0 || H > 1024 || B <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int rows = 128 / H;
  if (rows < 1) rows = 1;
  if (rows > B) rows = B;
  const dim3 block(H, rows);
  const dim3 grid((B + rows - 1) / rows);
  const size_t smem = sizeof(float) * ((size_t)H * 3 * H + 3 * H + 2 * (size_t)rows * H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, wh, bh, h0, ys, h_last, B, T, H, reset_after, hard_sigmoid, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
