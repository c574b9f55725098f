// The MSM's scalar and point preparation: `glv_digits` (the GLV split of a
// scalar and the signed-digit recode of its windows) and `fq_scale`
// (packed Fq / Fq2 coordinates times a Montgomery constant, or negated).
//
// Replaces no Pallas kernel: on the TPU these were XLA programs over
// 16-bit limbs, rapidsnark_tpu/ops/glv.py:230 `decompose` (Babai
// round-off by two constant products, the k1 / k2 halves as 176-bit
// two's-complement values and their signs), ops/msm.py:304
// `signed_digit_carries` and :330 `group_signed_digits` (the windows'
// carry chain and the encoded digits |d|*2 + (d<0), folded with the sign
// of the GLV half), :535 `_phi_apply_x` (x * beta on the table's phi
// image), :756-761 (the G2 window totals mapped back off the iso-twist)
// and :792-831 `g2_rescale_packed` (the G2 table mapped onto it).
//
// What bounds them on the H100: bytes, and launches. A scalar is 32
// bytes in and one 8-byte digit a window out for ~240 IMADs of GLV
// arithmetic a half; a point is 64-192 bytes in and out for 0-6
// Montgomery products: both sit near the card's ~5 IMADs a byte, where
// the plain versions ran thousands of torch operations a call, each a
// pass over device memory. So one thread holds one scalar half (or one
// point) in registers from its load to its stores:
//   * glv_digits: k * g1 and k * g2 as 8 x 5-word schoolbook products
//     (64-bit accumulators), the rounding add of 2^271 and the shift by
//     272, then k1 = k + c1 t1a + c2 t2a and k2 = c1 t1b + c2 t2b mod
//     2^192 (the low words of 5 x 6-word products), cut to 176 bits, the
//     sign and the magnitude: the plain version's integers, so its words.
//     The recode walks the windows from the bottom, shifting the scalar
//     by c (funnel shifts, no indexed register array) with the carry of
//     the previous window, and writes the requested windows' encoded
//     digits as int64, window-major: a warp's stores of one window are
//     one contiguous run. Without GLV the scalar itself is recoded.
//   * fq_scale: one thread a point; each coordinate is copied, negated
//     (canonically, or as 2p - a for the relaxed G1 law), or multiplied
//     by a constant passed by value (Fq, or Fq2 by the plain version's
//     Karatsuba: a0 b0, a1 b1, (a0 + a1)(b0 + b1), canonical differences)
//     so every word equals the plain version's.
#include "field.cuh"

#define MSM_THREADS 256

// ---- glv_digits -----------------------------------------------------------

// The constants of one group's decomposition (ops/glv.GLVParams): the
// Babai rounding constants g1, g2 (< 2^160) and t1a, t2a, t1b, t2b (the
// lattice basis terms mod 2^176), little-endian words
struct GlvConsts {
  u32 g[2][5];
  u32 t[4][6];
};

// x[0..5] += a[0..4] * b[0..5] mod 2^192
__device__ __forceinline__ void mad_lo6(u32 x[6], const u32 a[5],
                                        const u32 b[6]) {
#pragma unroll
  for (int i = 0; i < 5; i++) {
    unsigned long long carry = 0;
#pragma unroll
    for (int j = 0; i + j < 6; j++) {
      const unsigned long long t =
          (unsigned long long)a[i] * b[j] + x[i + j] + carry;
      x[i + j] = (u32)t;
      carry = t >> 32;
    }
  }
}

// c = (k * g + 2^271) >> 272 for k < 2^256, g < 2^160 (exact: the product
// is under 2^416, the plain version's width)
__device__ __forceinline__ void babai(u32 c[5], const u32 k[8],
                                      const u32 g[5]) {
  u32 p[13];
#pragma unroll
  for (int i = 0; i < 13; i++) p[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    unsigned long long carry = 0;
#pragma unroll
    for (int j = 0; j < 5; j++) {
      const unsigned long long t =
          (unsigned long long)k[i] * g[j] + p[i + j] + carry;
      p[i + j] = (u32)t;
      carry = t >> 32;
    }
    p[i + 5] = (u32)carry;
  }
  // + 2^271 (word 8, bit 15), carried up through word 12
  unsigned long long t = (unsigned long long)p[8] + (1u << 15);
  p[8] = (u32)t;
#pragma unroll
  for (int i = 9; i < 13; i++) {
    t = (unsigned long long)p[i] + (t >> 32);
    p[i] = (u32)t;
  }
#pragma unroll
  for (int m = 0; m < 4; m++) c[m] = __funnelshift_r(p[8 + m], p[9 + m], 16);
  c[4] = p[12] >> 16;
}

// The GLV half `half` (0: k1, 1: k2) of the scalar in s[0..7]: on return
// s[0..3] holds its magnitude, s[4..8] zero, and the result is its sign
__device__ __forceinline__ u32 glv_half(u32 s[9], const GlvConsts& k,
                                        int half) {
  u32 c1[5], c2[5], x[6];
  babai(c1, s, k.g[0]);
  babai(c2, s, k.g[1]);
#pragma unroll
  for (int i = 0; i < 6; i++) x[i] = half ? 0u : s[i];
  mad_lo6(x, c1, k.t[half ? 2 : 0]);
  mad_lo6(x, c2, k.t[half ? 3 : 1]);
  x[5] &= 0xFFFFu;                       // mod 2^176
  const u32 neg = (x[5] >> 15) & 1u;
  // the two's-complement magnitude: ~x + 1 mod 2^176 when negative
  unsigned long long t = 1;
#pragma unroll
  for (int i = 0; i < 6; i++) {
    const u32 y = neg ? ~x[i] : x[i];
    t = (unsigned long long)y + (neg ? t : 0ull);
    x[i] = (u32)t;
    t >>= 32;
  }
#pragma unroll
  for (int i = 0; i < 4; i++) s[i] = x[i];
#pragma unroll
  for (int i = 4; i < 9; i++) s[i] = 0;
  return neg;
}

// sc: rows of n scalars (8 words each), row b at sc + b * row_stride
// words. Entry t = (b * nhalves + h) * n + i is scalar (b, i), GLV half
// half0 + h (glv != 0) or the scalar itself; out[g * total + t] (int64) is
// the encoded signed digit of window w0 + g, g < G, of that entry's
// recode into c-bit windows.
__global__ void __launch_bounds__(MSM_THREADS)
k_glv_digits(const u32* __restrict__ sc, long long row_stride, long long n,
             long long total, GlvConsts kc, int glv, int half0, int nhalves,
             int c, int w0, int G, long long* __restrict__ out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long i = t % n;
  const long long bh = t / n;
  const int h = (int)(bh % nhalves);
  const long long b = bh / nhalves;
  u32 s[9];
  ld8(s, sc + b * row_stride + i * 8);
  s[8] = 0;
  long long neg = 0;
  if (glv) neg = glv_half(s, kc, half0 + h);
  const u32 mask = (1u << c) - 1, half = 1u << (c - 1), full = 1u << c;
  u32 carry = 0;
  for (int w = 0; w < w0 + G; w++) {
    const u32 d = (s[0] & mask) + carry;
#pragma unroll
    for (int j = 0; j < 8; j++) s[j] = __funnelshift_r(s[j], s[j + 1], c);
    s[8] >>= c;
    if (w >= w0) {
      // d - full when d >= half: negative, or 0 for d = full
      long long enc = (long long)d * 2;
      if (d >= half) enc = (long long)(full - d) * 2 + (d < full);
      out[(w - w0) * total + t] = enc ^ neg;
    }
    carry = d >= half;
  }
}

// ---- fq_scale -------------------------------------------------------------

#define SCALE_MAX 6  // components a point

// a point's coordinates: `ext` components each (1: Fq, 2: Fq2); op[m] of
// coordinate m: 0 copy, 1 times the constant k[m*ext ..], 2 canonical
// negation, 3 2p - a (the relaxed law's)
struct ScaleSpec {
  int ncomp, ext;
  int op[SCALE_MAX];
  u32 k[SCALE_MAX][8];
};

__global__ void __launch_bounds__(MSM_THREADS)
k_fq_scale(const u32* __restrict__ in, long long row_stride, long long n,
           long long total, ScaleSpec sp, u32* __restrict__ out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int A = sp.ncomp;
  const u32* src = in + (t / n) * row_stride + (t % n) * A * 8;
  u32* dst = out + t * A * 8;
  u32 a[SCALE_MAX][8];
#pragma unroll
  for (int j = 0; j < SCALE_MAX; j++)
    if (j < A) ld8(a[j], src + j * 8);
#pragma unroll
  for (int j = 0; j < SCALE_MAX; j++) {
    if (j >= A) continue;
    const int m = j / sp.ext;
    const int op = sp.op[m];
    u32 r[8];
    if (op == 0) {
      cp8(r, a[j]);
    } else if (op == 2) {
      f_neg<FQ_ID>(r, a[j]);
    } else if (op == 3) {
      f_neg_rx<FQ_ID>(r, a[j]);
    } else if (sp.ext == 1) {
      f_mul<FQ_ID>(r, a[j], sp.k[j]);
    } else if (j % 2 == 0) {
      // (a0 + a1 i)(k0 + k1 i): both components from the even one
      const u32* k0 = sp.k[j];
      const u32* k1 = sp.k[j + 1];
      u32 m0[8], m1[8], s0[8], s1[8], tt[8];
      f_mul<FQ_ID>(m0, a[j], k0);
      f_mul<FQ_ID>(m1, a[j + 1], k1);
      f_add_lazy(s0, a[j], a[j + 1]);
      f_add_lazy(s1, k0, k1);
      f_mul<FQ_ID>(tt, s0, s1);
      f_sub<FQ_ID>(r, m0, m1);
      f_sub<FQ_ID>(tt, tt, m0);
      f_sub<FQ_ID>(tt, tt, m1);
      st8(dst + (j + 1) * 8, tt);
    } else {
      continue;  // the odd component of a product, stored above
    }
    st8(dst + j * 8, r);
  }
}

static inline unsigned msm_blocks(long long n) {
  return (unsigned)((n + MSM_THREADS - 1) / MSM_THREADS);
}

extern "C" {

// consts: 34 words (g1, g2 of 5 words, t1a, t2a, t1b, t2b of 6), or null
// for no GLV split. One launch; out has G * rows * nhalves * n int64.
int rs_glv_digits(const void* sc, long long rows, long long row_stride,
                  long long n, const unsigned* consts, int half0,
                  int nhalves, int c, int w0, int G, void* out,
                  void* stream) {
  const long long total = rows * nhalves * n;
  if (total <= 0 || G <= 0) return 0;
  if (c < 1 || c > 16 || w0 < 0 || nhalves < 1 || nhalves > 2 ||
      half0 < 0 || half0 + nhalves > 2 || (!consts && (half0 || nhalves > 1)))
    return (int)cudaErrorInvalidValue;
  GlvConsts kc = {};
  if (consts) {
    for (int j = 0; j < 2; j++)
      for (int w = 0; w < 5; w++) kc.g[j][w] = consts[5 * j + w];
    for (int j = 0; j < 4; j++)
      for (int w = 0; w < 6; w++) kc.t[j][w] = consts[10 + 6 * j + w];
  }
  k_glv_digits<<<msm_blocks(total), MSM_THREADS, 0, (cudaStream_t)stream>>>(
      (const u32*)sc, row_stride, n, total, kc, consts != nullptr, half0,
      nhalves, c, w0, G, (long long*)out);
  return (int)cudaGetLastError();
}

// ops: ncomp / ext codes; consts: ncomp x 8 words (a component's constant,
// read for op 1). in: rows of n points of ncomp x 8 words, row b at in +
// b * row_stride words; out contiguous.
int rs_fq_scale(const void* in, long long rows, long long row_stride,
                long long n, int ncomp, int ext, const int* ops,
                const unsigned* consts, void* out, void* stream) {
  const long long total = rows * n;
  if (total <= 0) return 0;
  if (ncomp < 1 || ncomp > SCALE_MAX || (ext != 1 && ext != 2) ||
      ncomp % ext)
    return (int)cudaErrorInvalidValue;
  ScaleSpec sp = {};
  sp.ncomp = ncomp;
  sp.ext = ext;
  for (int m = 0; m < ncomp / ext; m++) {
    if (ops[m] < 0 || ops[m] > 3) return (int)cudaErrorInvalidValue;
    sp.op[m] = ops[m];
  }
  for (int j = 0; j < ncomp; j++)
    for (int w = 0; w < 8; w++) sp.k[j][w] = consts[8 * j + w];
  k_fq_scale<<<msm_blocks(total), MSM_THREADS, 0, (cudaStream_t)stream>>>(
      (const u32*)in, row_stride, n, total, sp, (u32*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
