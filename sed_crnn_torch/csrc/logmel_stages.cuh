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
  int table[MAX_STAGES];  // matrix stage s: its B values at dft + table[s] (floats)
  // A Rader stage, the last (radix[n_stages - 1] = p): its inner p - 1 point
  // transforms' radices and their matrix stages' B values; rader_first: it
  // is the only stage (L = p) and the frame is small, so the mixed body's
  // load gathers (the cluster body always runs the gather pass).
  int rader_stages;       // 0: no Rader stage
  int rader_first;
  int rader_radix[MAX_STAGES];
  int rader_table[MAX_STAGES];
  // A Rader stage nested in the inner transforms, their last stage
  // (rader_radix[rader_stages - 1] = q): its q - 1 point transforms'
  // radices and matrix stages' B values.
  int nested_stages;      // 0: none
  int nested_radix[MAX_STAGES];
  int nested_table[MAX_STAGES];
  // The wgmma matrix stages' B ring: the largest slab of a k step, bytes
  // (0: no such stage), and the slabs a block holds (`ring_plan`: 2 where
  // they fit beside its work arrays, else 1).
  int slab;
  int ring;
  int mma;                // 1: a matrix stage on mma.sync
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

// The matrix stage's two forms, chosen by R alone (`wgmma_radix`), so that
// a butterfly's bits never depend on the body, the cluster size or the
// free shared memory: `wgmma_stage` for the radices from WGMMA_MIN_RADIX
// to WGMMA_MAX_RADIX, `matrix_stage` / `matrix_stage_pair` on mma.sync for
// the others. On an H100 (PERF.md §6) the wgmma form was faster at 373
// alone (n_fft 141,001: 1.59x in its matrix phase), slower at 277 and 331
// (more than 32 butterflies of the stage a CTA: two passes of its k steps)
// and at 17-149 (many passes a frame, against the mma.sync form's
// independent warps), so the rule names 373; up to 383 (24 column tiles)
// a k step's B slab, 24,576 bytes, fits beside the largest frame of one
// block. (The two forms' three TF32 products gave the same bits there;
// the rule does not lean on it.)
constexpr int WGMMA_MIN_RADIX = 373;
constexpr int WGMMA_MAX_RADIX = 373;
constexpr int RING_ALIGN = 256;   // the 32-byte swizzle's atom: a B slab's alignment

__host__ __device__ constexpr bool wgmma_radix(int r) {
  return (r & 1) && r >= WGMMA_MIN_RADIX && r <= WGMMA_MAX_RADIX;
}

// A wgmma's column tiles (n = 64): a stage runs column groups of 8, the
// last padded with zero columns; every radix of the rule in as many groups
// (a constant of the stage's code).
constexpr int WGMMA_COLS = 8;
constexpr int WGMMA_GROUPS = (matrix_tiles(WGMMA_MAX_RADIX) + WGMMA_COLS - 1) / WGMMA_COLS;
static_assert((matrix_tiles(WGMMA_MIN_RADIX) + WGMMA_COLS - 1) / WGMMA_COLS == WGMMA_GROUPS,
              "the wgmma radices share their column groups");

// One k step's B slab: cos hi, cos lo, sin hi, sin lo, each the stage's
// column groups x 64 rows (the columns s) of 32 bytes (8 k, the rows r).
__host__ __device__ constexpr int wgmma_slab_bytes(int r) {
  return 4 * ((matrix_tiles(r) + WGMMA_COLS - 1) / WGMMA_COLS) * WGMMA_COLS * 8 * 32;
}

// A matrix stage's B values in the table, floats: the wgmma form's slabs,
// one a k step, or the mma.sync fragments.
__host__ __device__ constexpr int matrix_table_floats(int r) {
  return wgmma_radix(r) ? matrix_tiles(r) * wgmma_slab_bytes(r) / 4
                        : matrix_tiles(r) * matrix_tiles(r) * 32 * 8;
}

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
// on one float32 accumulator, the k tiles in order: about float32's
// precision, not its bits, and the order a function of R alone. Then the
// DIF twiddles (not at m = 1), written to the same positions of zo.
// TRANSPOSED: the twiddles multiply the inputs v_r instead (before the
// pairs), and the outputs are written as they come, as a transposed
// register stage does. Each row of an mma is one butterfly's, and the tensor
// cores sum a row's products in a fixed order whatever the other rows hold,
// so a butterfly's bits do not depend on which butterflies share its tile or
// which warp or CTA runs it: the cluster body's split of the butterflies
// gives the mixed body's bits.
//
// Work: a warp's job is a row tile and COLS column tiles (fewer at the
// last), the cos and sin fragments of its row gathered and split once a k
// tile for all of them (`matrix_stage`), or, where T = 2 at 4 columns, two
// row tiles of 2 column tiles (`matrix_stage_pair`); jobs are independent,
// since the stage reads z and writes zo, so each warp runs its own and the
// others hide its latency. In the 128-register instantiations COLS is 4:
// one job a row tile covers every column up to 4 tiles (R <= 63: each
// point gathered once, where 2 columns a job gathered it twice from 3
// tiles on), and at 2 tiles (R <= 31) a job takes 2 row tiles (half the
// jobs, two independent chains of products, each B fragment loaded for 16
// butterflies); in the 64-register ones COLS is 2. Each column's sums run
// over the k tiles in order whatever the job: the same bits.
//
// What bounds it on an H100 (tools/logmel_phases.py's part builds, PERF.md
// §5): not the tensor cores. At n_fft 141,001 (a Rader stage's inner stage
// of 373, crossing CTAs) the gathers alone took 1.49 ms of the stage's
// 1.73, the B loads alone 1.03 and the products alone 0.88; in one block
// each part alone took 80-90 % of the whole: latency, 16 warps an SM each
// a chain of loads and products, so the jobs' count and independence set
// its time. This form keeps every radix but 373, which `wgmma_stage` runs
// (below: each point gathered 3 times there, not 6, B from shared memory);
// at 17-149, 277 and 331 that form was slower (PERF.md §6): its
// warpgroups walk the k steps together behind a block barrier a step,
// where these jobs run free. A copy of a crossing stage's points into the
// CTA's own shared memory has no room (at 141,001's 13 CTAs a CTA's 30
// butterflies of 373 points take 89,520 bytes; the two work arrays and the
// B ring leave 9,488).
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

// Profiling cut, for sed_crnn_torch/tools/logmel_phases.py only (the
// results are then wrong): built with -DLOGMEL_MATRIX_PART=1 a matrix stage
// keeps only the gather and TF32 split of its A operands, with 2 only the
// loads of its B operands, with 3 only its products (on constant
// operands); each part's time is the difference to the build without
// matrix stages.
#ifndef LOGMEL_MATRIX_PART
#define LOGMEL_MATRIX_PART 0
#endif
constexpr int MATRIX_PART = LOGMEL_MATRIX_PART;

// A lane's A fragments of k tile kt for the butterfly at `base` (g ls + j;
// -1: none, zeros): (row gid, r0), (row gid + 8, r0), (row gid, r1), (row
// gid + 8, r1), r0 = 8 kt + tig, r1 = r0 + 4: rows gid and gid + 8 are the
// butterfly's real and imaginary parts; column r of the cos product is a_r
// (v_0 at r = 0), of the sin product b_r (0 at r = 0); each as TF32 hi and
// lo parts.
struct AFrag {
  uint32_t ahi[4], alo[4], bhi[4], blo[4];
};

// The wgmma form's `gather_a`, in two halves (kept apart from it: through
// them the mma.sync form's code made ptxas spill in the cluster body's WG
// instantiation, which holds both forms; PERF.md §6): a lane's raw points
// of k step kt, loaded a step ahead of their use, v_r and v_{R-r} at r = 8
// kt + tig and r + 4 (zeros where there is no such point). The transposed
// stage's twiddles are loaded at their use, in `form_a`: held across the
// step they made ptxas spill there.
struct ARaw {
  float2 v[2], w[2];
};

template <class ZI>
__device__ __forceinline__ ARaw load_a(ZI z, int R, int m, int base, int kt, int tig) {
  const int H = (R - 1) / 2;
  ARaw x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 8 * kt + tig + 4 * h;
    x.v[h] = x.w[h] = make_float2(0.0f, 0.0f);
    if (base >= 0 && r <= H) {
      x.v[h] = z[base + r * m];
      if (r > 0) x.w[h] = z[base + (R - r) * m];
    }
  }
  return x;
}

// `gather_a`'s arithmetic on loaded points: the same operations, the same
// bits (a missing point stays +0, as +0 times a zero twiddle gives).
template <bool TRANSPOSED>
__device__ __forceinline__ AFrag form_a(const ARaw& x, int R, int m, int step, int base, int j,
                                        int kt, int tig, const float2* __restrict__ tw) {
  const int H = (R - 1) / 2;
  float2 sa[2], sb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 8 * kt + tig + 4 * h;
    if (r == 0) {   // a_0 = v_0, b_0 = 0
      sa[h] = x.v[h];
      sb[h] = make_float2(0.0f, 0.0f);
    } else {
      float2 v = x.v[h], w = x.w[h];
      if (TRANSPOSED && m > 1 && base >= 0 && r <= H) {
        v = cmul(v, __ldg(tw + j * r * step));
        w = cmul(w, __ldg(tw + j * (R - r) * step));
      }
      sa[h] = cadd(v, w);
      sb[h] = csub(v, w);
    }
  }
  AFrag f;
  const float fa[4] = {sa[0].x, sa[0].y, sa[1].x, sa[1].y};
  const float fb[4] = {sb[0].x, sb[0].y, sb[1].x, sb[1].y};
  split_tf32(fa, f.ahi, f.alo);
  split_tf32(fb, f.bhi, f.blo);
  return f;
}

// The outputs of one column tile (P_s in p[c] real and p[c + 2]
// imaginary, Q_s in q likewise, column 2 tig + c), as `matrix_stage`
// writes them.
template <bool TRANSPOSED, class ZO>
__device__ __forceinline__ void store_tile(ZO zo, const float* p, const float* q, int tile,
                                           int R, int m, int step, int base, int j, int tig,
                                           const float2* __restrict__ tw) {
  const int H = (R - 1) / 2;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int s = 8 * tile + 2 * tig + c;
    if (s > H) continue;
    const float pr = p[c], pi = p[c + 2], qr = q[c], qi = q[c + 2];
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

template <bool TRANSPOSED, class ZI>
__device__ __forceinline__ AFrag gather_a(ZI z, int R, int m, int step, int base, int j, int kt,
                                          int lane, const float2* __restrict__ tw) {
  const int H = (R - 1) / 2, tig = lane & 3;
  AFrag f;
  if (MATRIX_PART >= 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f.ahi[e] = f.bhi[e] = 0x3f800000u + (static_cast<uint32_t>(kt + lane) << 13);
      f.alo[e] = f.blo[e] = 0x34000000u;
    }
    return f;
  }
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
  split_tf32(fa, f.ahi, f.alo);
  split_tf32(fb, f.bhi, f.blo);
  return f;
}

// One column tile's products: p += the cos product, q += the sin product,
// with this lane's B fragments at f (cos) and f + 1 (sin).
__device__ __forceinline__ void tile_mma(float (&p)[4], float (&q)[4], const AFrag& a,
                                         const float4* __restrict__ f, int lane) {
  if (MATRIX_PART == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = __fadd_rn(p[e], __uint_as_float(a.ahi[e] ^ a.alo[e]));
      q[e] = __fadd_rn(q[e], __uint_as_float(a.bhi[e] ^ a.blo[e]));
    }
  } else if (MATRIX_PART == 2) {
    const float4 fp = __ldg(f), fq = __ldg(f + 1);
    p[0] = __fadd_rn(p[0], __fadd_rn(fp.x, fp.z));
    p[1] = __fadd_rn(p[1], __fadd_rn(fp.y, fp.w));
    q[0] = __fadd_rn(q[0], __fadd_rn(fq.x, fq.z));
    q[1] = __fadd_rn(q[1], __fadd_rn(fq.y, fq.w));
  } else if (MATRIX_PART == 3) {
    const float c = 0.5f + 0.0625f * lane;
    const float4 fc = make_float4(c, 0.25f, 0.125f, 0.0625f);
    mma_tf32x3(p, a.ahi, a.alo, fc);
    mma_tf32x3(q, a.bhi, a.blo, fc);
  } else {
    mma_tf32x3(p, a.ahi, a.alo, __ldg(f));
    mma_tf32x3(q, a.bhi, a.blo, __ldg(f + 1));
  }
}

template <bool TRANSPOSED, int COLS, class ZI, class ZO>
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
      const AFrag a = gather_a<TRANSPOSED>(z, R, m, step, base, j, kt, lane, tw);
      const float4* f = frag + 2 * ((kt * T + n0) * 32 + lane);
#pragma unroll
      for (int t = 0; t < COLS; ++t)
        if (t == 0 || (t == 1 ? two : n0 + t < T)) tile_mma(p[t], q[t], a, f + 64 * t, lane);
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

// Two row tiles a job of two column tiles each (T = 2, at 128 registers a
// thread): 16 butterflies, two independent chains of products.
template <bool TRANSPOSED, class ZI, class ZO>
__device__ __forceinline__ void matrix_stage_pair(ZI z, ZO zo, int N, int R, int ls, int b0,
                                                  int b1, int lt, int nt,
                                                  const float* __restrict__ table,
                                                  const float2* __restrict__ tw) {
  constexpr int COLS = 4, ROWS = 2, W = COLS / ROWS;   // W: column tiles of each row tile
  const int m = ls / R, step = N / ls, H = (R - 1) / 2;
  const int T = matrix_tiles(R), groups = (T + W - 1) / W;
  const int jobs = ((b1 - b0 + 7) / 8 + ROWS - 1) / ROWS * groups;
  const int lane = lt % 32, gid = lane >> 2, tig = lane & 3;
  const float4* frag = reinterpret_cast<const float4*>(table);
  for (int job = lt / 32; job < jobs; job += nt / 32) {
    const int mi = job / groups, n0 = W * (job - mi * groups);
    int base[ROWS], j[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int b = b0 + 8 * (ROWS * mi + u) + gid, g = b / m;
      j[u] = b - g * m;
      base[u] = b < b1 ? g * ls + j[u] : -1;   // g ls + j, -1 past the last
    }
    float p[COLS][4], q[COLS][4];
#pragma unroll
    for (int t = 0; t < COLS; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[t][e] = q[t][e] = 0.0f;
    for (int kt = 0; kt < T; ++kt) {
      AFrag a[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
        a[u] = gather_a<TRANSPOSED>(z, R, m, step, base[u], j[u], kt, lane, tw);
      const float4* f = frag + 2 * ((kt * T + n0) * 32 + lane);
#pragma unroll
      for (int t = 0; t < COLS; ++t)
        if (n0 + t % W < T) tile_mma(p[t], q[t], a[t / W], f + 64 * (t % W), lane);
    }
#pragma unroll
    for (int t = 0; t < COLS; ++t) {
      const int u = t / W, tile = n0 + t % W;
      if (base[u] < 0 || tile >= T) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // Column 2 tig + c of tile `tile`: P_s in p[t][c] (real) and
        // p[t][c + 2] (imaginary), Q_s likewise.
        const int s = 8 * tile + 2 * tig + c;
        if (s > H) continue;
        const float pr = p[t][c], pi = p[t][c + 2], qr = q[t][c], qi = q[t][c + 2];
        if (s == 0) {
          zo[base[u]] = make_float2(pr, pi);
          continue;
        }
        float2 lo_s = make_float2(__fadd_rn(pr, qi), __fsub_rn(pi, qr));
        float2 hi_s = make_float2(__fsub_rn(pr, qi), __fadd_rn(pi, qr));
        if (!TRANSPOSED && m > 1) {
          lo_s = cmul(lo_s, __ldg(tw + j[u] * s * step));
          hi_s = cmul(hi_s, __ldg(tw + j[u] * (R - s) * step));
        }
        zo[base[u] + s * m] = lo_s;
        zo[base[u] + (R - s) * m] = hi_s;
      }
    }
  }
}

// The wgmma form of the stage (the radices `wgmma_radix` names), Hopper's
// own tensor-core path: the same butterflies, products, order of sums and
// outputs as `matrix_stage`, with
//   * A from registers (wgmma's register-A form): a warpgroup's job is 32
//     butterflies (its 64 rows: warp w's 16 rows are butterflies 8 w ..
//     8 w + 7, real and imaginary, the mma.sync fragment) and one column
//     group of WGMMA_COLS = 8 tiles (n = 64), so each point is gathered,
//     paired and split once a k step for 8 column tiles: ceil(T / 8) times
//     a stage (3 at R = 373, where the mma.sync form gathers it 6 times);
//     a k step's points are loaded as soon as the previous step's products
//     are done and waited for behind the next barrier;
//   * B from shared memory, read by the tensor cores through a descriptor:
//     the host lays each k step's slab out (`wgmma_table` in
//     ops/kernels/fused_logmel.py: cos hi, cos lo, sin hi, sin lo, each
//     column s a row of 8 k in the 32-byte swizzle), the block copies it
//     into a ring (cp.async, 16 bytes a thread) in the power row's place,
//     which no stage uses, behind one block barrier a k step, and every
//     warpgroup of the block (every frame of the mixed body's) reads it: at
//     depth 2 step k + 1's slab is copied while step k's products run, at
//     depth 1 after them (a barrier more). The depth is where the
//     launchers have room (`ring_plan`); it changes no sum;
//   * each k step's six wgmma (P: a_lo cos_hi, a_hi cos_lo, a_hi cos_hi; Q
//     the same with b and sin) in one group, m64n64k8 .tf32, the first of a
//     job's sums from scale-d 0, the k steps in order: the mma.sync form's
//     order (its bits, on an H100).
// It needs whole warpgroups: the launchers give a plan with such a stage a
// multiple of 128 threads a frame (mixed) or a CTA (cluster), and run it in
// instantiations of its own (WG, 128 registers a thread: 64 of them the
// accumulators), so that the other plans keep the mma.sync form's code and
// registers. Every thread of the block calls it with the same butterfly
// count (the mixed body's frames alike, the cluster body's CTAs each its
// own): its barriers are the block's.
struct Ring {
  static constexpr bool on = true;
  unsigned char* base;   // RING_ALIGN-aligned, depth x the plan's largest slab
  int depth;             // 1 or 2
};

// The instantiations without wgmma stages take no ring (their code is the
// mma.sync form's alone).
struct NoRing {
  static constexpr bool on = false;
};

template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[4 * NT], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// A B operand of n rows (columns s) x 8 k in the 32-byte swizzled K-major
// layout: row n at 32 n bytes, its two 16-byte halves swapped where bit 2
// of n is set; start >> 4, leading offset 1 (unused: a row is the swizzle's
// width), 256 bytes between groups of 8 rows, layout type 3.
__device__ __forceinline__ uint64_t b32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(256 >> 4) << 32) |
         ((uint64_t)3 << 62);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The bytes from p up to the next RING_ALIGN boundary of shared memory.
__device__ __forceinline__ int ring_pad(const void* p) {
  return (RING_ALIGN - (smem_addr(p) & (RING_ALIGN - 1))) & (RING_ALIGN - 1);
}

// A kernel's ring in the power row's place at p (the instantiations with
// wgmma stages, WG), or none.
template <bool WG>
__device__ __forceinline__ auto ring_at(void* p, int depth) {
  if constexpr (WG) {
    return Ring{static_cast<unsigned char*>(p) + ring_pad(p), depth};
  } else {
    return NoRing{};
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// This thread's copies landed and made visible to the tensor cores' reads;
// then the block barrier.
__device__ __forceinline__ void ring_sync() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void hold(AFrag& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm volatile("" : "+r"(f.ahi[i]), "+r"(f.alo[i]), "+r"(f.bhi[i]), "+r"(f.blo[i])::"memory");
}

template <bool TRANSPOSED, class ZI, class ZO>
__device__ __forceinline__ void wgmma_stage(ZI z, ZO zo, int N, int R, int ls, int b0, int b1,
                                            int lt, int nt, const float* __restrict__ table,
                                            const float2* __restrict__ tw, Ring ring) {
  constexpr int NT = WGMMA_COLS, groups = WGMMA_GROUPS;
  constexpr int part = groups * NT * 256, slab = 4 * part;
  const int m = ls / R, step = N / ls, T = matrix_tiles(R);
  const int jobs = (b1 - b0 + 31) / 32 * groups;
  const int nwg = nt / 128, wg = lt / 128, steps = (jobs + nwg - 1) / nwg * T;
  if (steps == 0) return;   // a CTA with none of a crossing stage's butterflies
  const int lane = lt % 32, gid = lane >> 2, tig = lane & 3, row = 8 * ((lt / 32) % 4) + gid;
  // The profiling cuts (MATRIX_PART): 1 the gathers and splits alone, 2
  // the slabs' copies alone, 3 the products alone, on constant operands.
  constexpr bool GATHER = MATRIX_PART == 0 || MATRIX_PART == 1;
  constexpr bool COPY = MATRIX_PART == 0 || MATRIX_PART == 2;
  constexpr bool MMA = MATRIX_PART == 0 || MATRIX_PART == 3;
  const uint32_t ring0 = smem_addr(ring.base);
  const char* const src = reinterpret_cast<const char*>(table);
  // Slab kt into buffer `buf`, 16 bytes a thread of the block.
  auto copy = [&](int kt, int buf) {
    if (!COPY) return;
    for (int o = 16 * static_cast<int>(threadIdx.x); o < slab; o += 16 * blockDim.x)
      cp_async16(ring0 + buf * slab + o, src + (size_t)kt * slab + o);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // This thread's butterfly in a job: g ls + j, -1 past the last (or no job).
  auto where = [&](int job, int& base, int& j) {
    const int b = b0 + 32 * (job / groups) + row, g = b / m;
    j = b - g * m;
    base = job < jobs && b < b1 ? g * ls + j : -1;
  };
  float p[4 * NT], q[4 * NT];
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) p[i] = q[i] = 0.0f;
  int job = wg, base, j;
  where(job, base, j);
  copy(0, 0);
  ARaw raw = load_a(z, R, m, base, 0, tig);
  for (int s = 0; s < steps; ++s) {
    const int kt = s % T, buf = ring.depth == 2 ? s & 1 : 0;
    ring_sync();
    if (ring.depth == 2 && s + 1 < steps) copy((s + 1) % T, (s + 1) & 1);
    const bool live = job < jobs;   // the warpgroup's
    AFrag a;
    if (!GATHER) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a.ahi[e] = a.bhi[e] = 0x3f800000u + (static_cast<uint32_t>(kt + lane) << 13);
        a.alo[e] = a.blo[e] = 0x34000000u;
      }
    } else {
      a = form_a<TRANSPOSED>(raw, R, m, step, base, j, kt, tig, tw);
    }
    const int cg = job % groups;
    if (live && MMA) {
      const uint32_t hb = ring0 + buf * slab + cg * NT * 256;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_tf32<NT>(p, a.alo, b32_desc(hb), kt > 0);
      wgmma_tf32<NT>(p, a.ahi, b32_desc(hb + part), 1);
      wgmma_tf32<NT>(p, a.ahi, b32_desc(hb), 1);
      wgmma_tf32<NT>(q, a.blo, b32_desc(hb + 2 * part), kt > 0);
      wgmma_tf32<NT>(q, a.bhi, b32_desc(hb + 3 * part), 1);
      wgmma_tf32<NT>(q, a.bhi, b32_desc(hb + 2 * part), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      hold(p);
      hold(q);
      hold(a);
    } else if (live && GATHER) {   // the gather alone: keep its values
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = __fadd_rn(p[e], __uint_as_float(a.ahi[e] ^ a.alo[e]));
        q[e] = __fadd_rn(q[e], __uint_as_float(a.bhi[e] ^ a.blo[e]));
      }
    }
    // A job's outputs after its last k step; then the next step's job and
    // points, loaded once the products are done and the outputs stored
    // (their registers free again), waited for behind the next barrier.
    if (kt == T - 1) {
      if (live && base >= 0) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
          if (cg * NT + t < T)
            store_tile<TRANSPOSED>(zo, p + 4 * t, q + 4 * t, cg * NT + t, R, m, step, base, j,
                                   tig, tw);
      }
      job += nwg;
      where(job, base, j);
    }
    if (s + 1 < steps && GATHER)
      raw = load_a(z, R, m, base, (s + 1) % T, tig);
    if (ring.depth == 1 && s + 1 < steps) {
      __syncthreads();
      copy((s + 1) % T, 0);
    }
  }
}

// The stage (see above), COLS column tiles a job: 4 in the instantiations
// with 128 registers a thread (two row tiles of 2 where T = 2), 2 in those
// with 64.
template <bool TRANSPOSED, int COLS, class ZI, class ZO, class RG>
__device__ __forceinline__ void run_matrix_stage(ZI z, ZO zo, int N, int R, int ls, int b0, int b1,
                                                 int lt, int nt, const float* __restrict__ table,
                                                 const float2* __restrict__ tw, RG ring) {
  if (wgmma_radix(R)) {
    // The launchers run a plan with such a stage in the instantiations
    // with a ring (WG) only.
    if constexpr (RG::on && COLS > 2) return wgmma_stage<TRANSPOSED>(z, zo, N, R, ls, b0, b1, lt,
                                                                    nt, table, tw, ring);
    __trap();
  }
  if (COLS > 2 && matrix_tiles(R) == 2)
    matrix_stage_pair<TRANSPOSED>(z, zo, N, R, ls, b0, b1, lt, nt, table, tw);
  else
    matrix_stage<TRANSPOSED, COLS>(z, zo, N, R, ls, b0, b1, lt, nt, table, tw);
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
// matrix_tiles are at most max_tiles (a matrix stage, its B values' offset
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
    table += matrix_table_floats(r);
    if (!wgmma_radix(r)) plan.mma = 1;
    else if (wgmma_slab_bytes(r) > plan.slab) plan.slab = wgmma_slab_bytes(r);
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
  if (rader_stages > 0 &&
      (!rader(plan.radix[n_stages - 1], rader_stages, rader_radices, plan.rader_radix,
              plan.rader_table, nested_stages > 0) ||
       (nested_stages > 0 && !rader(plan.rader_radix[rader_stages - 1], nested_stages,
                                    nested_radices, plan.nested_radix, plan.nested_table, false))))
    return false;
  return true;
}

// The forms a launch of the plan runs its matrix stages on: bit 0 mma.sync,
// bit 1 wgmma (the WG instantiations, which the launchers pick by the same
// plan.slab).
inline int plan_forms(const Plan& plan) { return (plan.mma ? 1 : 0) | (plan.slab ? 2 : 0); }

// The B ring of a block whose work arrays take `arrays` bytes: two slabs of
// the largest wgmma stage where they fit beside them, else one. Sets
// plan.ring; returns the block's bytes for the ring (0 without a wgmma
// stage), RING_ALIGN of alignment included.
inline long long ring_plan(Plan& plan, long long arrays, long long max_smem) {
  plan.ring = 0;
  if (!plan.slab) return 0;
  plan.ring = arrays + RING_ALIGN + 2LL * plan.slab <= max_smem ? 2 : 1;
  return RING_ALIGN + (long long)plan.ring * plan.slab;
}

}  // namespace logmel
