// Device code shared by the log-mel FFT bodies (csrc/logmel_fft.cu,
// csrc/logmel_mixed.cu and csrc/logmel_cluster.cu): complex float32
// arithmetic in which every product and sum is an explicitly rounded
// operation (no FMA contraction), the R-point butterflies, one in-place
// decimation-in-frequency (or transposed) stage of the mixed-radix FFT, the
// real-to-complex untangle's bin power and the spectrum lookup.
//
// A stage of the cluster body reaches its work array through an accessor,
// `z[p]` for point p: its own share (`Shifted`) or the whole cluster's
// (`Spread`, through distributed shared memory); the mixed body's stages
// (`block_stage`) index its block's shared memory. The operations and their
// order are the same either way, so a frame's bits do not depend on where
// its points live, and `_mixed_plain` in ops/kernels/fused_logmel.py
// repeats them.

#pragma once

#include <cuda_runtime.h>

namespace logmel {

constexpr int MAX_STAGES = 16;

struct Plan {
  int n;                  // transform length N: L (direct) or M (Bluestein)
  int points;             // L
  int n_bins;             // n_fft / 2 + 1
  int n_stages;
  int radix[MAX_STAGES];  // DIF order; their product is N
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y)),
                     __fadd_rn(__fmul_rn(a.x, w.y), __fmul_rn(a.y, w.x)));
}

__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }

// In-place R-point forward DFT (e^{-2 pi i / R}) of v[0..R-1]; c[q] =
// e^{-2 pi i q / R} from the twiddle table (odd R only; radix 2 and 4 read
// no constants).
template <int R>
__device__ __forceinline__ void butterfly(float2* v, const float2* c) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = csub(v[1], v[3]);
    v[0] = cadd(t0, t2);
    v[2] = csub(t0, t2);
    v[1] = make_float2(__fadd_rn(t1.x, t3.y), __fsub_rn(t1.y, t3.x));   // t1 - i t3
    v[3] = make_float2(__fsub_rn(t1.x, t3.y), __fadd_rn(t1.y, t3.x));   // t1 + i t3
  } else {
    // Odd R, pairs r and R - r: a_r = v_r + v_{R-r}, b_r = v_r - v_{R-r};
    // V_s = P_s - i Q_s and V_{R-s} = P_s + i Q_s with P_s = v_0 + sum_r
    // cos(2 pi rs / R) a_r and Q_s = sum_r sin(2 pi rs / R) b_r.
    constexpr int H = (R - 1) / 2;
    float2 a[H + 1], b[H + 1], out[R];
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      a[r] = cadd(v[r], v[R - r]);
      b[r] = csub(v[r], v[R - r]);
    }
    out[0] = v[0];
#pragma unroll
    for (int r = 1; r <= H; ++r) out[0] = cadd(out[0], a[r]);
#pragma unroll
    for (int s = 1; s <= H; ++s) {
      float2 p = v[0], q = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const float cs = c[(r * s) % R].x, sn = -c[(r * s) % R].y;
        p = make_float2(__fadd_rn(p.x, __fmul_rn(cs, a[r].x)),
                        __fadd_rn(p.y, __fmul_rn(cs, a[r].y)));
        const float2 t = make_float2(__fmul_rn(sn, b[r].x), __fmul_rn(sn, b[r].y));
        q = r == 1 ? t : cadd(q, t);
      }
      out[s] = make_float2(__fadd_rn(p.x, q.y), __fsub_rn(p.y, q.x));
      out[R - s] = make_float2(__fsub_rn(p.x, q.y), __fadd_rn(p.y, q.x));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = out[r];
  }
}

// Work array accessor `Shifted`: this block holds points [off, off + its
// share) of the array.
struct Shifted {
  float2* z;
  int off;
  __device__ __forceinline__ float2& operator[](int p) const { return z[p - off]; }
};

// One radix-R stage on sub-transforms of length ls (m = ls / R) of the
// N-point array z, in place, butterflies b0 <= b < b1 by the nt threads lt
// = 0 .. nt-1: butterfly b is sub-transform g = b / m, offset j = b % m,
// its points z[g ls + j + r m]. DIF (TRANSPOSED = false): butterfly, then
// output s times e^{-2 pi i j s / ls}. Transposed: input r times
// e^{-2 pi i j r / ls}, then butterfly. The last DIF stage (m = 1) has only
// unit twiddles and skips them.
template <int R, bool TRANSPOSED, class Z>
__device__ __forceinline__ void stage(Z z, int N, int ls, int b0, int b1, int lt, int nt,
                                      const float2* __restrict__ tw) {
  const int m = ls / R;
  const int step = N / ls;
  float2 c[R];
  if constexpr (R % 2 == 1) {
#pragma unroll
    for (int q = 0; q < R; ++q) c[q] = __ldg(tw + q * (N / R));
  }
  for (int b = b0 + lt; b < b1; b += nt) {
    const int g = b / m, j = b - g * m;
    const int base = g * ls + j;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = z[base + r * m];
    if (TRANSPOSED && m > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + j * r * step));
    }
    butterfly<R>(v, c);
    if (!TRANSPOSED && m > 1) {
#pragma unroll
      for (int s = 1; s < R; ++s) v[s] = cmul(v[s], __ldg(tw + j * s * step));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) z[base + r * m] = v[r];
  }
}

// The same stage over a whole array in this block's shared memory, all N /
// R butterflies: what `stage` does with z as the accessor, b0 = 0 and b1 = N
// / R, as a loop of its own (a pointer base, the bound from the radix), the
// mixed body's. Through `stage` that body ran 1-7 % slower on an H100 with
// nearly the same instructions (PERF.md §6).
template <int R, bool TRANSPOSED>
__device__ __forceinline__ void block_stage(float2* z, int N, int ls, int lt, int nt,
                                            const float2* __restrict__ tw) {
  const int m = ls / R;
  const int step = N / ls;
  float2 c[R];
  if constexpr (R % 2 == 1) {
#pragma unroll
    for (int q = 0; q < R; ++q) c[q] = __ldg(tw + q * (N / R));
  }
  for (int b = lt; b < N / R; b += nt) {
    const int g = b / m, j = b - g * m;
    float2* const base = z + g * ls + j;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = base[r * m];
    if (TRANSPOSED && m > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + j * r * step));
    }
    butterfly<R>(v, c);
    if (!TRANSPOSED && m > 1) {
#pragma unroll
      for (int s = 1; s < R; ++s) v[s] = cmul(v[s], __ldg(tw + j * s * step));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) base[r * m] = v[r];
  }
}

template <bool TRANSPOSED>
__device__ __forceinline__ void run_block_stage(int radix, float2* z, int N, int ls, int lt,
                                                int nt, const float2* __restrict__ tw) {
  switch (radix) {
    case 2: block_stage<2, TRANSPOSED>(z, N, ls, lt, nt, tw); break;
    case 3: block_stage<3, TRANSPOSED>(z, N, ls, lt, nt, tw); break;
    case 4: block_stage<4, TRANSPOSED>(z, N, ls, lt, nt, tw); break;
    case 5: block_stage<5, TRANSPOSED>(z, N, ls, lt, nt, tw); break;
    default: block_stage<7, TRANSPOSED>(z, N, ls, lt, nt, tw); break;
  }
}

template <bool TRANSPOSED, class Z>
__device__ __forceinline__ void run_stage(int radix, Z z, int N, int ls, int b0, int b1,
                                          int lt, int nt, const float2* __restrict__ tw) {
  switch (radix) {
    case 2: stage<2, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw); break;
    case 3: stage<3, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw); break;
    case 4: stage<4, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw); break;
    case 5: stage<5, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw); break;
    default: stage<7, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw); break;
  }
}

// |X_k|^2 from Z_k = a and Z_{L-k} = b of the packed FFT, with
// w = e^{-2 pi i k / n_fft}: E = (a + conj b) / 2, O = (a - conj b) / 2i,
// X_k = E + w O.
__device__ __forceinline__ float bin_power(float2 a, float2 b, float2 w) {
  const float er = __fmul_rn(0.5f, __fadd_rn(a.x, b.x));
  const float ei = __fmul_rn(0.5f, __fsub_rn(a.y, b.y));
  const float o_r = __fmul_rn(0.5f, __fadd_rn(a.y, b.y));
  const float o_i = __fmul_rn(0.5f, __fsub_rn(b.x, a.x));
  const float xr = __fadd_rn(er, __fsub_rn(__fmul_rn(w.x, o_r), __fmul_rn(w.y, o_i)));
  const float xi = __fadd_rn(ei, __fadd_rn(__fmul_rn(w.x, o_i), __fmul_rn(w.y, o_r)));
  return __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi));
}

// Z_k of the L-point transform from the work array: at pos[k] (direct), or
// w_k conj(D_k) (Bluestein).
template <bool BLUE, class Z>
__device__ __forceinline__ float2 spectrum(Z z, int k, const int* __restrict__ pos,
                                           const float2* __restrict__ chirp) {
  if (BLUE) return cmul(cconj(z[k]), __ldg(chirp + k));
  return z[__ldg(pos + k)];
}

// Power of bin k (0 <= k <= n_fft / 2) of an L-point transform: the
// untangle at an even n_fft, |Z_k|^2 at an odd one.
template <bool BLUE, class Z>
__device__ __forceinline__ float power(Z z, int k, int L, bool even,
                                       const int* __restrict__ pos,
                                       const float2* __restrict__ chirp,
                                       const float2* __restrict__ utw) {
  if (even) {
    const float2 a = spectrum<BLUE>(z, k == L ? 0 : k, pos, chirp);
    const float2 b = spectrum<BLUE>(z, k == 0 ? 0 : L - k, pos, chirp);
    return bin_power(a, b, __ldg(utw + k));
  }
  const float2 a = spectrum<BLUE>(z, k, pos, chirp);
  return __fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y));
}

// The windowed input point n of a frame fr (n < N): the packed pair (even
// n_fft) or the real sample with a zero imaginary part (odd), times the
// chirp (Bluestein); zero from L on.
template <bool BLUE>
__device__ __forceinline__ float2 load_point(const float* fr, int n, int L, bool even,
                                             const float* __restrict__ window,
                                             const float2* __restrict__ chirp) {
  float2 v = make_float2(0.0f, 0.0f);
  if (n < L) {
    if (even) {
      v = make_float2(__fmul_rn(fr[2 * n], __ldg(window + 2 * n)),
                      __fmul_rn(fr[2 * n + 1], __ldg(window + 2 * n + 1)));
    } else {
      v = make_float2(__fmul_rn(fr[n], __ldg(window + n)), 0.0f);
    }
    if (BLUE) v = cmul(v, __ldg(chirp + n));
  }
  return v;
}

}  // namespace logmel
