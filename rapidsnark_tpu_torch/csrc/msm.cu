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
//   * fq_scale: one lane a point and one step a work item of the spec:
//     a negation (canonically, or as 2p - a for the relaxed G1 law) or a
//     product by an Fq constant of one Fq component, or an Fq2 product of
//     one coordinate by the plain version's Karatsuba (a0 b0, a1 b1,
//     (a0 + a1)(k0 + k1) with the constants' sum made on the host,
//     canonical differences), so every word equals the plain version's;
//     a copied component is no step. A warp takes a tile of 32 points of
//     one row: its 16-byte chunks go into shared memory by cp.async and
//     back out as 16-byte stores, lane c on the c-th chunk, so neighbouring
//     lanes touch neighbouring addresses and every sector is used whole;
//     the points sit 8A + 4 words apart there, so a lane's reads of its
//     component do not conflict. Warps run on their own (only __syncwarp
//     orders a tile's steps) over a persistent grid of tiles, each step is
//     one op for the whole warp, no thread divides a 64-bit index, the
//     constants come from the launch's parameters, and <= 64 registers
//     keep 32 warps on an SM.
#include <climits>

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

#define SCALE_MAX 6      // components a point
#define SCALE_KW 72      // constant words: 6 components, 3 Fq2 sums
#define SCALE_WARPS 4    // warps a block
#define SCALE_WT 32      // points a warp tile: one a lane

// the kinds of a work item (ops/msm.py SCALE_NEG ..); a copied component
// is no item: the tile's loads and stores move it
#define SC_NEG 1         // canonical p - a
#define SC_NEG_RX 2      // 2p - a
#define SC_MUL 3         // one component times its Fq constant
#define SC_MUL2 4        // an Fq2 coordinate (two components) times a pair

// item q of a launch: bits 6q .. 6q+2 its kind, 6q+3 .. 6q+5 its (first)
// component. k[8j ..]: component j's constant; k[8 (6 + m) ..]: the sum
// k0 + k1 of Fq2 coordinate m (< 2p: no carry out)
struct ScaleSpec {
  unsigned long long items;
  int nitems;
  u32 k[SCALE_KW];
};

// A point takes S = 8A + 4 words of shared memory: 8 lanes' 16-byte reads
// of one component at a time (a phase) then fall on 8 distinct bank groups
template <int A>
struct ScaleTile {
  static constexpr int S = 8 * A + 4;
  static constexpr int CH = 2 * A;     // 16-byte chunks a point
};

__device__ __forceinline__ void scale_cp16(u32* smem, const u32* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

// one item on the words of its component(s) at e (shared memory)
__device__ __forceinline__ void scale_item(u32* e, int kind, int j,
                                           const ScaleSpec& sp) {
  u32 a[8], r[8];
  ld8(a, e);
  if (kind == SC_MUL2) {
    // (a0 + a1 i)(k0 + k1 i) = (m0 - m1) + ((a0 + a1)(k0 + k1) - m0 - m1) i
    u32 b[8], m0[8], m1[8];
    ld8(b, e + 8);
    f_mul<FQ_ID>(m0, a, sp.k + 8 * j);
    f_mul<FQ_ID>(m1, b, sp.k + 8 * (j + 1));
    f_add_lazy(r, a, b);
    f_mul<FQ_ID>(b, r, sp.k + 8 * (6 + j / 2));
    f_sub<FQ_ID>(r, m0, m1);
    f_sub<FQ_ID>(b, b, m0);
    f_sub<FQ_ID>(b, b, m1);
    st8(e + 8, b);
  } else if (kind == SC_MUL) {
    f_mul<FQ_ID>(r, a, sp.k + 8 * j);
  } else if (kind == SC_NEG) {
    f_neg<FQ_ID>(r, a);
  } else {
    f_neg_rx<FQ_ID>(r, a);
  }
  st8(e, r);
}

// Warp tiles: tile t is the SCALE_WT points from (t % tpr) * SCALE_WT of
// row t / tpr, taken by warps in turn (a persistent grid). A warp copies
// its tile's 16-byte chunks into its shared memory with cp.async (lane c
// the c-th chunk: neighbouring lanes on neighbouring addresses), runs the
// items one after the other (lane l on point l: one op a warp at a time),
// and stores the chunks the same way; only __syncwarp orders the steps,
// so every warp runs on its own and the others hide its waits.
template <int A>
__global__ void __launch_bounds__(32 * SCALE_WARPS, 32 / SCALE_WARPS)
k_fq_scale(const u32* __restrict__ in, long long row_stride, int n, int tpr,
           int total, ScaleSpec sp, u32* __restrict__ out) {
  extern __shared__ uint4 scale_smem[];
  constexpr int S = ScaleTile<A>::S, CH = ScaleTile<A>::CH;
  const int lane = threadIdx.x & 31;
  u32* buf = reinterpret_cast<u32*>(scale_smem) +
             (threadIdx.x >> 5) * SCALE_WT * S;
  for (int t = blockIdx.x * SCALE_WARPS + (threadIdx.x >> 5); t < total;
       t += gridDim.x * SCALE_WARPS) {
    const int row = t / tpr, i0 = (t - row * tpr) * SCALE_WT;
    const int valid = min(SCALE_WT, n - i0);
    const u32* src = in + row * row_stride + (long long)i0 * (8 * A);
    for (int c = lane; c < valid * CH; c += 32) {
      const int pt = c / CH;
      scale_cp16(buf + pt * S + (c - pt * CH) * 4, src + c * 4);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();
    if (lane < valid) {
      for (int q = 0; q < sp.nitems; q++) {
        const unsigned long long code = sp.items >> (6 * q);
        const int j = (int)((code >> 3) & 7);
        scale_item(buf + lane * S + j * 8, (int)(code & 7), j, sp);
      }
    }
    __syncwarp();
    uint4* dst = reinterpret_cast<uint4*>(
        out + ((long long)row * n + i0) * (8 * A));
    for (int c = lane; c < valid * CH; c += 32) {
      const int pt = c / CH;
      dst[c] = *reinterpret_cast<const uint4*>(buf + pt * S +
                                               (c - pt * CH) * 4);
    }
    __syncwarp();
  }
}

template <int A>
static int scale_launch(const u32* in, long long row_stride, int n,
                        long long rows, const ScaleSpec& sp, u32* out,
                        cudaStream_t stream) {
  constexpr size_t smem =
      (size_t)SCALE_WARPS * SCALE_WT * ScaleTile<A>::S * 4;
  static int per_sm = 0;               // blocks an SM, from the occupancy
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      (!per_sm && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, k_fq_scale<A>, 32 * SCALE_WARPS, smem) !=
                      cudaSuccess) ||
      per_sm < 1)
    return (int)cudaErrorInvalidConfiguration;
  const long long tpr = (n + SCALE_WT - 1) / SCALE_WT;
  const long long total = rows * tpr;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long blocks = min((total + SCALE_WARPS - 1) / SCALE_WARPS,
                               (long long)sms * per_sm);
  k_fq_scale<A><<<(unsigned)blocks, 32 * SCALE_WARPS, smem, stream>>>(
      in, row_stride, n, (int)tpr, (int)total, sp, out);
  return (int)cudaGetLastError();
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

// items / nitems: the launch's work items (ScaleSpec); consts: SCALE_KW
// words. in: rows of n points of ncomp x 8 words, row b at in + b *
// row_stride words; out contiguous. Rows that lie back to back are one
// row.
int rs_fq_scale(const void* in, long long rows, long long row_stride,
                long long n, int ncomp, unsigned long long items, int nitems,
                const unsigned* consts, void* out, void* stream) {
  if (rows * n <= 0) return 0;
  if (ncomp < 1 || ncomp > SCALE_MAX || nitems < 0 || nitems > SCALE_MAX)
    return (int)cudaErrorInvalidValue;
  if (rows > 1 && row_stride == n * ncomp * 8) {
    n *= rows;
    rows = 1;
  }
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  ScaleSpec sp;
  sp.items = items;
  sp.nitems = nitems;
  for (int w = 0; w < SCALE_KW; w++) sp.k[w] = consts[w];
  const u32* src = (const u32*)in;
  u32* dst = (u32*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (ncomp) {
#define SCALE_CASE(A) \
  case A:             \
    return scale_launch<A>(src, row_stride, (int)n, rows, sp, dst, st);
    SCALE_CASE(1) SCALE_CASE(2) SCALE_CASE(3) SCALE_CASE(4) SCALE_CASE(5)
    default: SCALE_CASE(6)
#undef SCALE_CASE
  }
}

}  // extern "C"
