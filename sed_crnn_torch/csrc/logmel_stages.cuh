// Device code shared by the log-mel FFT bodies (csrc/logmel_fft.cu,
// csrc/logmel_mixed.cu and csrc/logmel_cluster.cu): complex float32
// arithmetic in which every product and sum is an explicitly rounded
// operation (no FMA contraction), the R-point butterflies, one in-place
// decimation-in-frequency (or transposed) stage of the mixed-radix FFT in
// registers, the matrix stage of a wide radix on the tensor cores (the
// mixed and cluster bodies'), the Rader stage's gather, pointwise product
// and (for a Rader stage nested in another's inner transforms) scatter, the
// real-to-complex untangle's bin power, the spectrum lookup and the mel
// sums' tree over 32 partials.
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
#include <stdint.h>

namespace logmel {

constexpr int MAX_STAGES = 16;
constexpr int MAX_REGISTER_RADIX = 13;  // the largest prime radix in registers; odd radices
                                        // above run as matrix or Rader stages
constexpr int MEL_LANES = 32;           // a band's partial sums
// The mixed body folds the gather of a Rader stage that is the only one
// into the load up to this n_fft (see `rader_gather`).
constexpr int RADER_FOLD_MAX_NFFT = 4096;

struct Plan {
  int n;                  // transform length N: L (direct) or M (Bluestein)
  int points;             // L
  int n_bins;             // n_fft / 2 + 1
  int n_stages;
  int radix[MAX_STAGES];  // DIF order; their product is N
  int table[MAX_STAGES];  // matrix stage s: its B fragments at dft + table[s] (floats)
  // A Rader stage, the last (radix[n_stages - 1] = p): its inner p - 1 point
  // transforms' radices and their matrix stages' fragments; rader_first: it
  // is the only stage (L = p) and the frame is small, so the mixed body's
  // load gathers (the cluster body always runs the gather pass).
  int rader_stages;       // 0: no Rader stage
  int rader_first;
  int rader_radix[MAX_STAGES];
  int rader_table[MAX_STAGES];
  // A Rader stage nested in the inner transforms, their last stage
  // (rader_radix[rader_stages - 1] = q): its q - 1 point transforms'
  // radices and matrix fragments.
  int nested_stages;      // 0: none
  int nested_radix[MAX_STAGES];
  int nested_table[MAX_STAGES];
};

// The tables a mixed or cluster launch reads, as the C interfaces take them
// (csrc/logmel_mixed.cu `logmel_mixed`).
struct Tables {
  const float* window;
  const float2* tw;
  const int* pos;
  const float2 *chirp, *bspec, *utw;
  const float* dft;
  const int* rgather;
  const float2 *rtw, *rspec;
  const int* ngather;
  const float2 *ntw, *nspec;
  const int *mel_first, *mel_ptr;
  const float* mel_w;
};

// A register radix of the wide instantiations (2, 3, 4, 5, 7, 8, 9, 11, 13,
// 16), or of the others (to 9: radix 16 spills at their 64 registers a
// thread).
__host__ __device__ constexpr bool register_radix(int r, bool wide) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8 || r == 9 ||
         (wide && (r == 11 || r == 13 || r == 16));
}

// A radix that runs as a matrix stage: odd, above the register primes.
__host__ __device__ constexpr bool matrix_radix(int r) {
  return r > MAX_REGISTER_RADIX && (r & 1);
}

// The 8-wide tiles of a matrix stage's products each way: (R + 1) / 2 rows
// and columns (r, s = 0 .. (R - 1) / 2), padded to the mma depth of 8.
__host__ __device__ constexpr int matrix_tiles(int r) { return (r + 16) / 16; }

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

// v times W_R^e inside a composite butterfly (`_rotate` in
// ops/kernels/fused_logmel.py). Radix 8 and 16, e in 16ths of a turn (16 e
// / R): a quarter turn as a swap, an eighth and three eighths by cos(pi / 4)
// on the sum and difference, the others by cmul with float32 constants;
// radix 9 by cmul with the stage's constant c[e] = e^{-2 pi i e / 9}. The
// butterflies call it with e known once unrolled, so the branches fold.
template <int R>
__device__ __forceinline__ float2 rotate(float2 v, int e, const float2* c) {
  if constexpr (R == 9) {
    return cmul(v, c[e]);
  } else {
    constexpr float C8 = 0.70710677f, C16 = 0.9238795f, S16 = 0.38268343f;
    switch (e * (16 / R)) {
      case 4: return make_float2(v.y, -v.x);
      case 2: return make_float2(__fmul_rn(C8, __fadd_rn(v.x, v.y)),
                                 __fmul_rn(C8, __fsub_rn(v.y, v.x)));
      case 6: return make_float2(__fmul_rn(C8, __fsub_rn(v.y, v.x)),
                                 -__fmul_rn(C8, __fadd_rn(v.x, v.y)));
      case 1: return cmul(v, make_float2(C16, -S16));
      case 3: return cmul(v, make_float2(S16, -C16));
      default: return cmul(v, make_float2(-C16, S16));   // 9
    }
  }
}

template <int R>
__device__ __forceinline__ void butterfly(float2* v, const float2* c);

// A composite radix R = A B in registers: n = n1 + B n2, the B A-point
// butterflies over n2, the twiddles W_R^(n1 k2), then the A B-point
// butterflies over n1, X_{k2 + A k1}: one pass through shared memory where
// its factors took two. Radix 9's sub-butterflies take the radix-3
// constants c[3 q]; 8 and 16 read none.
template <int R, int B, int A>
__device__ __forceinline__ void composite(float2* v, const float2* c) {
  float2 ca[A], cb[B];
  if constexpr (R == 9) {
#pragma unroll
    for (int q = 0; q < 3; ++q) ca[q] = cb[q] = c[3 * q];
  }
  float2 u[B][A];
#pragma unroll
  for (int n1 = 0; n1 < B; ++n1) {
#pragma unroll
    for (int n2 = 0; n2 < A; ++n2) u[n1][n2] = v[n1 + B * n2];
    butterfly<A>(u[n1], ca);
#pragma unroll
    for (int k2 = 1; k2 < A; ++k2)
      if (n1 > 0) u[n1][k2] = rotate<R>(u[n1][k2], n1 * k2, c);
  }
#pragma unroll
  for (int k2 = 0; k2 < A; ++k2) {
    float2 w[B];
#pragma unroll
    for (int n1 = 0; n1 < B; ++n1) w[n1] = u[n1][k2];
    butterfly<B>(w, cb);
#pragma unroll
    for (int k1 = 0; k1 < B; ++k1) v[k2 + A * k1] = w[k1];
  }
}

// In-place R-point forward DFT (e^{-2 pi i / R}) of v[0..R-1]; c[q] =
// e^{-2 pi i q / R} from the twiddle table (odd R only; radix 2, 4, 8 and
// 16 read no constants).
template <int R>
__device__ __forceinline__ void butterfly(float2* v, const float2* c) {
  if constexpr (R == 8) {
    composite<8, 2, 4>(v, c);
  } else if constexpr (R == 9) {
    composite<9, 3, 3>(v, c);
  } else if constexpr (R == 16) {
    composite<16, 4, 4>(v, c);
  } else if constexpr (R == 2) {
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

// The same stage over a whole array of `count` points in this block's shared
// memory (N, the length whose twiddle table tw is, divides into it: a
// batch of count / N transforms), all count / R butterflies: what `stage`
// does with z as the accessor, b0 = 0 and b1 = count / R, as a loop of its
// own (a pointer base, the bound from the radix), the mixed body's. Through
// `stage` that body ran 1-7 % slower on an H100 with nearly the same
// instructions (PERF.md §6).
template <int R, bool TRANSPOSED>
__device__ __forceinline__ void block_stage(float2* z, int N, int count, int ls, int lt, int nt,
                                            const float2* __restrict__ tw) {
  const int m = ls / R;
  const int step = N / ls;
  float2 c[R];
  if constexpr (R % 2 == 1) {
#pragma unroll
    for (int q = 0; q < R; ++q) c[q] = __ldg(tw + q * (N / R));
  }
  for (int b = lt; b < count / R; b += nt) {
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

// Profiling cut, for sed_crnn_torch/tools/logmel_phases.py only (the
// results are then wrong): built with -DLOGMEL_SKIP_RADIX=R the bodies leave
// out every register stage of radix R (outer, inner and nested, forward and
// transposed), so that the time of its passes is the difference. 0, the
// default, skips none and leaves no test in the code.
#ifndef LOGMEL_SKIP_RADIX
#define LOGMEL_SKIP_RADIX 0
#endif

// The register stage of `radix`: 2, 3, 4, 5, 7, and with WIDE also 11 and
// 13 (the instantiations that take them, with fewer threads and more
// registers a thread; the others keep the code they had before); with EXT
// (the instantiations of plans with composite radices or a nested Rader
// stage) also 8, 9 and, WIDE, 16. The others keep the code they had without
// them: at 64 registers a thread the composite butterflies spill, and their
// code in every kernel cost the plans without them (PERF.md §6).
template <bool TRANSPOSED, bool WIDE, bool EXT = false>
__device__ __forceinline__ void run_block_stage(int radix, float2* z, int N, int count, int ls,
                                                int lt, int nt, const float2* __restrict__ tw) {
#if LOGMEL_SKIP_RADIX
  if (radix == LOGMEL_SKIP_RADIX) return;
#endif
  if constexpr (EXT) {
    if (radix == 8) return block_stage<8, TRANSPOSED>(z, N, count, ls, lt, nt, tw);
    if (radix == 9) return block_stage<9, TRANSPOSED>(z, N, count, ls, lt, nt, tw);
    if constexpr (WIDE) {
      if (radix == 16) return block_stage<16, TRANSPOSED>(z, N, count, ls, lt, nt, tw);
    }
  }
  switch (radix) {
    case 2: block_stage<2, TRANSPOSED>(z, N, count, ls, lt, nt, tw); break;
    case 3: block_stage<3, TRANSPOSED>(z, N, count, ls, lt, nt, tw); break;
    case 4: block_stage<4, TRANSPOSED>(z, N, count, ls, lt, nt, tw); break;
    case 5: block_stage<5, TRANSPOSED>(z, N, count, ls, lt, nt, tw); break;
    default:
      if constexpr (WIDE) {
        if (radix == 11) {
          block_stage<11, TRANSPOSED>(z, N, count, ls, lt, nt, tw);
          break;
        }
        if (radix == 13) {
          block_stage<13, TRANSPOSED>(z, N, count, ls, lt, nt, tw);
          break;
        }
      }
      block_stage<7, TRANSPOSED>(z, N, count, ls, lt, nt, tw);
      break;
  }
}

template <bool TRANSPOSED, bool WIDE, bool EXT = false, class Z>
__device__ __forceinline__ void run_stage(int radix, Z z, int N, int ls, int b0, int b1,
                                          int lt, int nt, const float2* __restrict__ tw) {
#if LOGMEL_SKIP_RADIX
  if (radix == LOGMEL_SKIP_RADIX) return;
#endif
  if constexpr (EXT) {
    if (radix == 8) return stage<8, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw);
    if (radix == 9) return stage<9, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw);
    if constexpr (WIDE) {
      if (radix == 16) return stage<16, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw);
    }
  }
  switch (radix) {
    case 2: stage<2, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw); break;
    case 3: stage<3, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw); break;
    case 4: stage<4, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw); break;
    case 5: stage<5, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw); break;
    default:
      if constexpr (WIDE) {
        if (radix == 11) {
          stage<11, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw);
          break;
        }
        if (radix == 13) {
          stage<13, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw);
          break;
        }
      }
      stage<7, TRANSPOSED>(z, N, ls, b0, b1, lt, nt, tw);
      break;
  }
}

// The TF32 rounding of x (to nearest, ties away from zero), as bits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b: one m16n8k8 TF32 product on the tensor cores, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One radix-R DIF stage as matrix products on the tensor cores (odd R, in
// practice the primes above 13), its butterflies b0 <= b < b1 by nt threads
// (whole warps, lt = 0 .. nt-1), from the array z into zo (accessors, as for
// `stage`; N the length of the twiddle table tw). Butterfly b (sub-
// transform g = b / m, offset j = b % m, m = ls / R) has points v_r =
// z[g ls + j + r m]; with H = (R - 1) / 2, a_r = v_r + v_{R-r} and b_r = v_r
// - v_{R-r} (r = 1 .. H), its outputs are V_0 = v_0 + sum a_r = P_0, V_s =
// P_s - i Q_s and V_{R-s} = P_s + i Q_s (s = 1 .. H), where P_s = v_0 +
// sum_r cos(2 pi r s / R) a_r and Q_s = sum_r sin(2 pi r s / R) b_r: two
// real (H + 1) x (H + 1) products, the real and imaginary parts as rows.
// A row tile is 8 butterflies (rows 0-7 their real parts, 8-15 their
// imaginary parts), so that a lane's accumulators hold P_s and Q_s of one
// butterfly, real and imaginary, and combine in registers. The matrices
// come from the host (`matrix_table` in ops/kernels/fused_logmel.py: cos
// and sin, rows r, columns s, zero-padded to T = matrix_tiles(R) tiles of 8,
// in mma.m16n8k8 B-fragment order, each value as TF32 hi and lo parts).
// Each product runs as three TF32 mma, a_lo b_hi + a_hi b_lo + a_hi b_hi,
// the a = a_hi + a_lo split here: about float32's precision, not its bits.
// Then the DIF twiddles (not at m = 1), written to the same positions of zo.
// TRANSPOSED: the twiddles multiply the inputs v_r instead (before the
// pairs), and the outputs are written as they come, as a transposed
// register stage does. Each row of an mma is one butterfly's, and the tensor
// cores sum a row's products in a fixed order whatever the other rows hold,
// so a butterfly's bits do not depend on which butterflies share its tile:
// the cluster body's split of the butterflies gives the mixed body's bits.
//
// Work: a warp's job is a row tile and COLS column tiles (fewer at the
// last), the cos and sin fragments of its row built once a k tile for all
// of them: COLS 4 in the instantiations with 128 registers a thread, 2 in
// those with 64; jobs are independent, since the stage reads z and writes
// zo, so a warp holds only its job's accumulators. Each column's sums run
// over the k tiles in order whatever COLS is: the same bits.
__device__ __forceinline__ void split_tf32(const float (&a)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = to_tf32(a[e]);
    lo[e] = to_tf32(__fsub_rn(a[e], __uint_as_float(hi[e])));
  }
}

__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&hi)[4],
                                           const uint32_t (&lo)[4], float4 b) {
  mma_tf32(d, lo, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(d, hi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, hi, __float_as_uint(b.x), __float_as_uint(b.y));
}

template <bool TRANSPOSED, int COLS = 2, class ZI, class ZO>
__device__ __forceinline__ void matrix_stage(ZI z, ZO zo, int N, int R, int ls, int b0, int b1,
                                             int lt, int nt, const float* __restrict__ table,
                                             const float2* __restrict__ tw) {
  const int m = ls / R, step = N / ls, H = (R - 1) / 2;
  const int T = matrix_tiles(R), groups = (T + COLS - 1) / COLS;
  const int jobs = (b1 - b0 + 7) / 8 * groups;
  const int lane = lt % 32, gid = lane >> 2, tig = lane & 3;
  const float4* frag = reinterpret_cast<const float4*>(table);
  for (int job = lt / 32; job < jobs; job += nt / 32) {
    const int mi = job / groups, n0 = COLS * (job - mi * groups);
    const bool two = n0 + 1 < T;
    const int b = b0 + 8 * mi + gid, g = b / m;
    const int base = b < b1 ? g * ls + b - g * m : -1;   // g ls + j, -1 past the last
    const int j = b - g * m;
    float p[COLS][4], q[COLS][4];
#pragma unroll
    for (int t = 0; t < COLS; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[t][e] = q[t][e] = 0.0f;
    for (int kt = 0; kt < T; ++kt) {
      // A fragments: (row gid, r0), (row gid + 8, r0), (row gid, r1), (row
      // gid + 8, r1): rows gid and gid + 8 are this butterfly's real and
      // imaginary parts; column r of the cos product is a_r (v_0 at r = 0),
      // of the sin product b_r (0 at r = 0).
      float2 sa[2], sb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 8 * kt + tig + 4 * h;
        sa[h] = sb[h] = make_float2(0.0f, 0.0f);
        if (base >= 0 && r <= H) {
          float2 v = z[base + r * m];
          if (r == 0) {
            sa[h] = v;
          } else {
            float2 w = z[base + (R - r) * m];
            if (TRANSPOSED && m > 1) {
              v = cmul(v, __ldg(tw + j * r * step));
              w = cmul(w, __ldg(tw + j * (R - r) * step));
            }
            sa[h] = cadd(v, w);
            sb[h] = csub(v, w);
          }
        }
      }
      const float fa[4] = {sa[0].x, sa[0].y, sa[1].x, sa[1].y};
      const float fb[4] = {sb[0].x, sb[0].y, sb[1].x, sb[1].y};
      uint32_t ahi[4], alo[4], bhi[4], blo[4];
      split_tf32(fa, ahi, alo);
      split_tf32(fb, bhi, blo);
      const float4* f = frag + 2 * ((kt * T + n0) * 32 + lane);
#pragma unroll
      for (int t = 0; t < COLS; ++t) {
        if (t == 0 || (t == 1 ? two : n0 + t < T)) {
          mma_tf32x3(p[t], ahi, alo, __ldg(f + 64 * t));
          mma_tf32x3(q[t], bhi, blo, __ldg(f + 64 * t + 1));
        }
      }
    }
    if (base < 0) continue;
#pragma unroll
    for (int t = 0; t < COLS; ++t) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // Column 2 tig + c of tile n0 + t: P_s in p[t][c] (real) and
        // p[t][c + 2] (imaginary), Q_s likewise.
        const int s = 8 * (n0 + t) + 2 * tig + c;
        if (s > H || (t == 1 && !two) || (t > 1 && n0 + t >= T)) continue;
        const float pr = p[t][c], pi = p[t][c + 2], qr = q[t][c], qi = q[t][c + 2];
        if (s == 0) {
          zo[base] = make_float2(pr, pi);
          continue;
        }
        float2 lo_s = make_float2(__fadd_rn(pr, qi), __fsub_rn(pi, qr));
        float2 hi_s = make_float2(__fsub_rn(pr, qi), __fadd_rn(pi, qr));
        if (!TRANSPOSED && m > 1) {
          lo_s = cmul(lo_s, __ldg(tw + j * s * step));
          hi_s = cmul(hi_s, __ldg(tw + j * (R - s) * step));
        }
        zo[base + s * m] = lo_s;
        zo[base + (R - s) * m] = hi_s;
      }
    }
  }
}

// A matrix stage with COLS column tiles a job where the radix has more than
// 4 tiles (R above 63), else 2: on an H100 four columns were faster at R =
// 113 and 149 and two at 31 and 83 (PERF.md §6).
template <bool TRANSPOSED, int COLS, class ZI, class ZO>
__device__ __forceinline__ void run_matrix_stage(ZI z, ZO zo, int N, int R, int ls, int b0, int b1,
                                                 int lt, int nt, const float* __restrict__ table,
                                                 const float2* __restrict__ tw) {
  if (COLS > 2 && matrix_tiles(R) > 4)
    matrix_stage<TRANSPOSED, COLS>(z, zo, N, R, ls, b0, b1, lt, nt, table, tw);
  else
    matrix_stage<TRANSPOSED, 2>(z, zo, N, R, ls, b0, b1, lt, nt, table, tw);
}

// The Rader stage of a prime p, the plan's last (m = 1: butterfly b is the
// points b p .. b p + p - 1 of the N-point array). Writing k = g^{-q} and n
// = g^m (g a generator mod p), X_k - x_0 is the cyclic convolution of a_m =
// x_{g^m} with b_m = e^{-2 pi i g^{-m} / p}, of length p - 1:
//
// 1. `rader_gather`: a_m of butterfly b to b (p - 1) + m of the other work
//    array, and x_0 to its tail N' + b (N' = N (p - 1) / p; the inner
//    transforms never touch the tail); in the mixed body, where the Rader
//    stage is the only one (L = p) and n_fft is at most
//    RADER_FOLD_MAX_NFFT, the load gathers instead (`rader_load_index`: a
//    pass and a barrier fewer). On an H100, in turns with the pass, the
//    fold was 1.5-8.3 % faster at every n_fft measured up to 4,001 (1103,
//    1999, 2206, 3001, 3998, 4001) and 15 % slower at 6,007, 12 % at
//    23,054, where the frame's permuted reads from device memory cost more
//    than the pass in shared memory (PERF.md §6, tools/logmel_phases.py
//    --sizes ... --against);
// 2. the inner DIF stages, register and matrix, forward, on the N' points as
//    a batch of p - 1 point transforms (their own twiddle table);
// 3. `rader_product`: X_0 = x_0 + A_0 (A_0 the DC term, at b (p - 1)) goes
//    to the tail, and each A_q is multiplied by the filter spectrum B_q =
//    DFT(b)_q / (p - 1) (from the host, at the DIF positions), x_0 added to
//    the DC product;
// 4. the transposed stages in reverse order (a forward DFT with permuted
//    input and natural output), which give D_n = conv_{-n} + x_0 = X_{g^n}.
//
// So X_{g^m} of butterfly b is at b (p - 1) + m and X_0 at N' + b: the
// host's `pos` table says so, and no scatter pass is needed.
template <class ZI, class ZO>
__device__ __forceinline__ void rader_gather(ZI z, ZO w, int N, int p, int t0, int t1, int lt,
                                             int nt, const int* __restrict__ rgather) {
  const int count = p - 1, tail = N - N / p;
  for (int t = t0 + lt; t < t1; t += nt) {
    if (t < tail) {
      const int b = t / count;
      w[t] = z[b * p + __ldg(rgather + t - b * count)];
    } else {
      w[t] = z[(t - tail) * p];
    }
  }
}

// The input point that a Rader stage which is the only stage (L = p, one
// butterfly) gathers into point t of its work array.
__device__ __forceinline__ int rader_load_index(int t, int p, const int* __restrict__ rgather) {
  return t < p - 1 ? __ldg(rgather + t) : 0;
}

template <class ZF, class ZT>
__device__ __forceinline__ void rader_product(ZF f, ZT tail, int N, int p, int t0, int t1, int lt,
                                              int nt, const float2* __restrict__ rspec) {
  const int count = p - 1, base = N - N / p;
  for (int t = t0 + lt; t < t1; t += nt) {
    const int b = t / count, q = t - b * count;
    const float2 a = f[t];
    float2 y = cmul(a, __ldg(rspec + q));
    if (q == 0) {
      const float2 x0 = tail[base + b];
      tail[base + b] = cadd(x0, a);
      y = cadd(y, x0);
    }
    f[t] = y;
  }
}

// `rader_product` where the inner transforms end in a nested Rader stage of
// prime q (the mixed body's EXT instantiations only): they leave transform
// b's body at b split + l (split = (p - 1)(q - 1) / q) and its tail of (p -
// 1) / q after every body, at N'' + b (p - 1 - split) + (l - split) (N'' =
// N' split / (p - 1)), its DC term first there; rspec is stored in that
// order (l < p - 1).
template <class ZF, class ZT>
__device__ __forceinline__ void rader_product_split(ZF f, ZT tail, int N, int p, int split,
                                                    int t0, int t1, int lt, int nt,
                                                    const float2* __restrict__ rspec) {
  const int count = p - 1, base = N - N / p;
  const int body_end = base / count * split, rest = count - split;
  for (int t = t0 + lt; t < t1; t += nt) {
    int b, q;
    if (t < body_end) {
      b = t / split;
      q = t - b * split;
    } else {
      const int u = t - body_end;
      b = u / rest;
      q = split + u - b * rest;
    }
    const float2 a = f[t];
    float2 y = cmul(a, __ldg(rspec + q));
    if (q == split) {
      const float2 x0 = tail[base + b];
      tail[base + b] = cadd(x0, a);
      y = cadd(y, x0);
    }
    f[t] = y;
  }
}

// The transposed nested Rader stage's last step: its outputs, X_{g^m} of
// butterfly b at b (p - 1) + m and X_0 at the tail N' + b of z (N' = N (p
// - 1) / p), back to the runs of p points of w, b p + g^m and b p (the
// points t0 <= t < t1 of z).
template <class ZI, class ZO>
__device__ __forceinline__ void rader_scatter(ZI z, ZO w, int N, int p, int t0, int t1, int lt,
                                              int nt, const int* __restrict__ rgather) {
  const int count = p - 1, tail = N - N / p;
  for (int t = t0 + lt; t < t1; t += nt) {
    if (t < tail) {
      const int b = t / count;
      w[b * p + __ldg(rgather + t - b * count)] = z[t];
    } else {
      w[(t - tail) * p] = z[t];
    }
  }
}

// One lane's share of a run of a band's bins: acc + w[t] p[t] + w[t + 32]
// p[t + 32] + ... (t < n), added in that order, the loads and products
// issued MEL_BATCH at a time ahead of their adds.
constexpr int MEL_BATCH = 4;
__device__ __forceinline__ float lane_sum(float acc, const float* __restrict__ w, const float* p,
                                          int n, int t) {
  for (; t + 32 * (MEL_BATCH - 1) < n; t += 32 * MEL_BATCH) {
    float prod[MEL_BATCH];
#pragma unroll
    for (int k = 0; k < MEL_BATCH; ++k) prod[k] = __fmul_rn(__ldg(w + t + 32 * k), p[t + 32 * k]);
#pragma unroll
    for (int k = 0; k < MEL_BATCH; ++k) acc = __fadd_rn(acc, prod[k]);
  }
  for (; t < n; t += 32) acc = __fadd_rn(acc, __fmul_rn(__ldg(w + t), p[t]));
  return acc;
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

// A band's 32 partial sums, lane l's (its bins l, l + 32, ... in order) in
// `acc`, combined by a fixed tree over the lanes of a warp: at each step s =
// 16, 8, 4, 2, 1 lane l adds lane l ^ s's, which for l < s is l + s; every
// lane ends with the sum (an addition's operands commute bitwise).
__device__ __forceinline__ float mel_tree_warp(float acc) {
#pragma unroll
  for (int s = MEL_LANES / 2; s > 0; s /= 2)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, s));
  return acc;
}

// A band's sum in the same order on a group of G lanes (G = 1, 2, 4, 8, 16
// or 32, the group aligned to G lanes of its warp): lane k of the group
// holds the partials k, k + G, ... (32 / G of them), each over the bins l,
// l + 32, ... in bin order, and the tree's steps s >= G run in the lane,
// the others as shuffles within the group. Bitwise `mel_tree_warp`
// (lane_sum).
template <int G>
__device__ __forceinline__ float group_band_sum(const float* __restrict__ w, const float* p,
                                                int n, int k) {
  constexpr int P = MEL_LANES / G;
  float acc[P];
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = 0.0f;
  for (int i = k; i < n; i += MEL_LANES) {
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (i + q * G < n) acc[q] = __fadd_rn(acc[q], __fmul_rn(__ldg(w + i + q * G), p[i + q * G]));
  }
#pragma unroll
  for (int s = MEL_LANES / 2; s >= G; s /= 2) {
#pragma unroll
    for (int q = 0; q < s / G; ++q) acc[q] = __fadd_rn(acc[q], acc[q + s / G]);
  }
  float sum = acc[0];
#pragma unroll
  for (int s = G / 2; s > 0; s /= 2) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, s));
  return sum;
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

// Host side: the plan a launcher takes, from its C interface's radices (the
// last the Rader prime where rader_stages > 0), the Rader stage's inner
// radices (the last the nested Rader prime q where nested_stages > 0) and the
// nested stage's; each a register radix, or an odd radix above 13 whose
// matrix_tiles are at most max_tiles (a matrix stage, its fragments' offset
// in `table` order: the outer stages', then the inner ones', then the
// nested ones'). Sets `wide` (radix 11, 13 or 16, a matrix or a Rader
// stage), `matrix` (any matrix stage), `alt` (a second work array: a matrix
// or Rader stage) and `ext` (a composite radix or a nested Rader stage: the
// EXT instantiations). False for a plan the bodies do not take.
inline bool make_plan(Plan& plan, int n_fft, int n, int n_stages, const int* radices,
                      int rader_stages, const int* rader_radices, int nested_stages,
                      const int* nested_radices, int max_tiles, bool& wide, bool& matrix,
                      bool& alt, bool& ext) {
  if (n_stages < 0 || n_stages > MAX_STAGES || (n_stages > 0 && radices == nullptr) ||
      rader_stages < 0 || rader_stages > MAX_STAGES ||
      (rader_stages > 0 && (rader_radices == nullptr || n_stages == 0)) || nested_stages < 0 ||
      nested_stages > MAX_STAGES ||
      (nested_stages > 0 && (nested_radices == nullptr || rader_stages == 0)))
    return false;
  plan = Plan{};
  plan.n = n;
  plan.points = n_fft % 2 ? n_fft : n_fft / 2;
  plan.n_bins = n_fft / 2 + 1;
  plan.n_stages = n_stages;
  plan.rader_stages = rader_stages;
  plan.nested_stages = nested_stages;
  plan.rader_first = rader_stages > 0 && n_stages == 1 && n_fft <= RADER_FOLD_MAX_NFFT;
  wide = matrix = false;
  alt = rader_stages > 0;
  ext = nested_stages > 0;
  int table = 0;
  auto take = [&](int r, int& offset) {
    offset = 0;
    if (register_radix(r, true)) {
      wide = wide || !register_radix(r, false);
      ext = ext || r == 8 || r == 9 || r == 16;
      return true;
    }
    if (!matrix_radix(r) || matrix_tiles(r) > max_tiles) return false;
    wide = matrix = alt = true;
    offset = table;
    table += matrix_tiles(r) * matrix_tiles(r) * 32 * 8;
    return true;
  };
  // A Rader stage's prime: odd, above the register primes, its inner
  // transforms' radices `inner` (each taken) multiplying to p - 1; the last
  // of them a nested Rader stage's prime where `nest` is set.
  auto rader = [&](int p, int stages, const int* inner, int* radix, int* tables, bool nest) {
    if (!matrix_radix(p)) return false;
    wide = true;
    long long prod = 1;
    for (int s = 0; s < stages; ++s) {
      radix[s] = inner[s];
      prod *= inner[s];
      tables[s] = 0;
      if (!(nest && s == stages - 1) && !take(inner[s], tables[s])) return false;
    }
    return prod == p - 1;
  };
  long long prod = 1;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radices[s];
    plan.radix[s] = r;
    prod *= r;
    plan.table[s] = 0;
    if (!(rader_stages > 0 && s == n_stages - 1) && !take(r, plan.table[s])) return false;
  }
  if (prod != n) return false;
  if (rader_stages == 0) return true;
  if (!rader(plan.radix[n_stages - 1], rader_stages, rader_radices, plan.rader_radix,
             plan.rader_table, nested_stages > 0))
    return false;
  return nested_stages == 0 ||
         rader(plan.rader_radix[rader_stages - 1], nested_stages, nested_radices,
               plan.nested_radix, plan.nested_table, false);
}

}  // namespace logmel
