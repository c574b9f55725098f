// Frozen copy of rapidsnark_tpu_torch/csrc/curve.cu at commit 6caa3f5 for the benchmark's input maker.
// Changed: only the strict mixed adds (`add_mixed_packed`, `add_mixed`),
// and what they call, kept.
// The fixture generator's fixed-base ladders: `add_mixed_packed` and
// `add_mixed`, the strict (canonical) mixed add on G1 and on G2's
// original twist (b3 = 9/(9+i), a product by a constant), the affine
// operand as packed words or as 16-bit limbs.
//
// Replaces the TPU kernels rapidsnark_tpu/ops/fused.py:219
// `add_mixed_packed` and fused.py:170 `add_mixed` (through `_binary`, the
// pallas_call at fused.py:142).
//
// What bounds them on the H100: 32-bit integer multiply-adds, and on G2
// the latency of their dependent chains. A Montgomery product (field.cuh)
// is two carry chains of mad.lo/madc.hi, which ptxas fuses into about
// 136 wide IMADs, plus some 50 other instructions. A G1 mixed add is 14
// products, a G2 one 11 Fq2 products, against 64-288 bytes moved, far
// above the card's ~5 IMADs per byte. So every coordinate stays in
// registers, device memory holds only operands and results, and:
//   * add_mixed_packed / add_mixed: the strict law. G1 one thread a lane
//     (11 Fq products). G2 two threads a lane on the schedule of `add`
//     (64-thread blocks, <= 168 registers): 13 Fq2 products a lane
//     by Karatsuba, 39 Fq products, ran on one thread at 254-255
//     registers and eight warps an SM, under half its bound; a thread
//     now runs 26 (two a schoolbook component of each of 11 products,
//     two for each of the two products by b3 = 9/(9+i), whose constant
//     both threads hold). `add_mixed` reads its affine operand as 16
//     limbs per coordinate and packs limb pairs in registers, the rest
//     is shared.
// Points are element-major packed words: a lane's point is L x 8
// contiguous u32 (L = 3 for G1, 6 for G2: x0 x1 y0 y1 z0 z1), loaded as
// 16-byte vectors.
#include "field.cuh"

// ---------------------------------------------------------------- G1 ------
struct P1 {
  u32 x[8], y[8], z[8];
};

// 9 * t, canonical: three doublings and an add
__device__ __forceinline__ void g1_mul_b3(u32 r[8], const u32 t[8]) {
  u32 d[8];
  f_dbl<FQ_ID>(d, t);
  f_dbl<FQ_ID>(d, d);
  f_dbl<FQ_ID>(d, d);
  f_add<FQ_ID>(r, d, t);
}

// canonical projective + canonical affine (x2, y2), the strict law:
// every output < p; (0,0) = infinity
__device__ __forceinline__ void g1_add_mixed(P1& r, const P1& p,
                                             const u32 x2[8],
                                             const u32 y2[8]) {
  u32 t0[8], t1[8], sa[8], sb[8], t3[8], t4[8], y3l[8];
  f_mul<FQ_ID>(t0, p.x, x2);
  f_mul<FQ_ID>(t1, p.y, y2);
  f_add_lazy(sa, p.x, p.y);
  f_add_lazy(sb, x2, y2);
  f_mul<FQ_ID>(t3, sa, sb);
  f_sub<FQ_ID>(t3, t3, t0);
  f_sub<FQ_ID>(t3, t3, t1);
  f_mul<FQ_ID>(t4, y2, p.z);
  f_add<FQ_ID>(t4, t4, p.y);
  f_mul<FQ_ID>(y3l, x2, p.z);
  f_add<FQ_ID>(y3l, y3l, p.x);
  u32 t0_3[8], t2b[8], y3b[8], z3[8], t1m[8];
  f_dbl<FQ_ID>(t0_3, t0);
  f_add<FQ_ID>(t0_3, t0_3, t0);
  g1_mul_b3(t2b, p.z);
  g1_mul_b3(y3b, y3l);
  f_add<FQ_ID>(z3, t1, t2b);
  f_sub<FQ_ID>(t1m, t1, t2b);
  bool q_inf = is_zero8(x2) && is_zero8(y2);
  u32 m1[8], m2[8], ox[8], oy[8], oz[8];
  f_mul<FQ_ID>(m1, t4, y3b);
  f_mul<FQ_ID>(m2, t3, t1m);
  f_sub<FQ_ID>(ox, m2, m1);
  f_mul<FQ_ID>(m1, y3b, t0_3);
  f_mul<FQ_ID>(m2, t1m, z3);
  f_add<FQ_ID>(oy, m2, m1);
  f_mul<FQ_ID>(m1, t0_3, t3);
  f_mul<FQ_ID>(m2, z3, t4);
  f_add<FQ_ID>(oz, m2, m1);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    r.x[i] = q_inf ? p.x[i] : ox[i];
    r.y[i] = q_inf ? p.y[i] : oy[i];
    r.z[i] = q_inf ? p.z[i] : oz[i];
  }
}

// ------------------------------------- G2, one component a thread ------
// Two neighbouring threads of a warp share a lane: thread c holds
// component c of every Fq2 value. Adds and subtractions stay in the
// thread; a product hands both operands' components to the partner
// (__shfl_xor_sync, 16 words) and each thread computes its own component
// by schoolbook, c = 0: a0b0 - a1b1, c = 1: a1b0 + a0b1 (two Fq products
// a thread, where Karatsuba takes three a lane); b3 = 9/(9+i) (the
// zkey's own twist, the strict law) is a product by a constant that both
// threads hold whole, so only t crosses. Every value is canonical, so the words are those of
// the plain law, whatever the order of its products. Every thread of a
// warp runs every shuffle.
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ void xchg8(u32 o[8], const u32 a[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) o[i] = __shfl_xor_sync(FULL_MASK, a[i], 1);
}

__device__ __forceinline__ void sel8(u32 r[8], bool c, const u32 a[8],
                                     const u32 b[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = c ? a[i] : b[i];
}

// r = component c1 of a * b
__device__ __forceinline__ void s_mul(u32 r[8], const u32 a[8], const u32 b[8],
                                      bool c1) {
  u32 ao[8], bo[8], u[8], v[8], t0[8], t1[8];
  xchg8(ao, a);
  xchg8(bo, b);
  sel8(u, c1, bo, b);
  sel8(v, c1, b, bo);
  f_mul<FQ_ID>(t0, a, u);
  f_mul<FQ_ID>(t1, ao, v);
  f_sub<FQ_ID>(u, t0, t1);
  f_add<FQ_ID>(v, t0, t1);
  sel8(r, c1, v, u);
}

// component c1 of b3 * t on the zkey's twist, b3 = (B0, B1) = 9/(9+i):
// (t0 B0 - t1 B1, t1 B0 + t0 B1)
__device__ __forceinline__ void s_mul_b3_twist(u32 r[8], const u32 t[8],
                                               bool c1) {
  u32 to[8], t0[8], t1[8];
  xchg8(to, t);
  f_mul<FQ_ID>(t0, t, K_B3_G2[0]);
  f_mul<FQ_ID>(t1, to, K_B3_G2[1]);
  f_sub<FQ_ID>(to, t0, t1);
  f_add<FQ_ID>(t1, t0, t1);
  sel8(r, c1, t1, to);
}

struct Q2 {
  u32 x[8], y[8], z[8];
};

// projective + affine (x2, y2), one component a thread, on the zkey's
// twist; r may alias p
__device__ __forceinline__ void s_add_mixed(Q2& r, const Q2& p,
                                            const u32 x2[8], const u32 y2[8],
                                            bool c1) {
  u32 t0[8], t1[8], s[8], u[8], t3[8], t4[8], y3l[8];
  s_mul(t0, p.x, x2, c1);
  s_mul(t1, p.y, y2, c1);
  f_add<FQ_ID>(s, p.x, p.y);
  f_add<FQ_ID>(u, x2, y2);
  s_mul(t3, s, u, c1);
  f_sub<FQ_ID>(t3, t3, t0);
  f_sub<FQ_ID>(t3, t3, t1);
  s_mul(t4, y2, p.z, c1);
  f_add<FQ_ID>(t4, t4, p.y);
  s_mul(y3l, x2, p.z, c1);
  f_add<FQ_ID>(y3l, y3l, p.x);
  u32 t0_3[8], t2b[8], y3b[8], z3[8], t1m[8];
  f_dbl<FQ_ID>(t0_3, t0);
  f_add<FQ_ID>(t0_3, t0_3, t0);
  s_mul_b3_twist(t2b, p.z, c1);
  s_mul_b3_twist(y3b, y3l, c1);
  f_add<FQ_ID>(z3, t1, t2b);
  f_sub<FQ_ID>(t1m, t1, t2b);
  u32 m1[8], m2[8];
  s_mul(m1, t4, y3b, c1);
  s_mul(m2, t3, t1m, c1);
  f_sub<FQ_ID>(r.x, m2, m1);
  s_mul(m1, y3b, t0_3, c1);
  s_mul(m2, t1m, z3, c1);
  f_add<FQ_ID>(r.y, m2, m1);
  s_mul(m1, t0_3, t3, c1);
  s_mul(m2, z3, t4, c1);
  f_add<FQ_ID>(r.z, m2, m1);
}

// ---------------------------------------------------- loads / stores ------
__device__ __forceinline__ void ld_p1(P1& p, const u32* a) {
  ld8(p.x, a);
  ld8(p.y, a + 8);
  ld8(p.z, a + 16);
}
__device__ __forceinline__ void st_p1(u32* a, const P1& p) {
  st8(a, p.x);
  st8(a + 8, p.y);
  st8(a + 16, p.z);
}
// one affine coordinate of a lane's operand: 8 packed words, or 16 words
// of one 16-bit limb each, packed in pairs here
template <bool UNPACKED>
__device__ __forceinline__ void ld_coord(u32 r[8], const u32* q, int k) {
  if constexpr (UNPACKED) {
    u32 lo[8], hi[8];
    ld8(lo, q + k * 16);
    ld8(hi, q + k * 16 + 8);
#pragma unroll
    for (int i = 0; i < 4; i++) {
      r[i] = lo[2 * i] | (lo[2 * i + 1] << 16);
      r[4 + i] = hi[2 * i] | (hi[2 * i + 1] << 16);
    }
  } else {
    ld8(r, q + k * 8);
  }
}

// a lane's half of a G2 point: component c1 of x, y and z
__device__ __forceinline__ void ld_q2(Q2& a, const u32* p, bool c1) {
  ld8(a.x, p + (c1 ? 8 : 0));
  ld8(a.y, p + (c1 ? 24 : 16));
  ld8(a.z, p + (c1 ? 40 : 32));
}
__device__ __forceinline__ void st_q2(u32* p, const Q2& a, bool c1) {
  st8(p + (c1 ? 8 : 0), a.x);
  st8(p + (c1 ? 24 : 16), a.y);
  st8(p + (c1 ? 40 : 32), a.z);
}
__device__ __forceinline__ void zero_q2(Q2& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) a.x[i] = a.y[i] = a.z[i] = 0;
}

// ------------------------------------------------------------ kernels ------
constexpr int G2_THREADS = 64;   // two threads a lane, <= 168 registers

// p (n, 3, 8) canonical projective; q (n, 2, 8) packed or (n, 2, 16)
// limbs, canonical affine; out (n, 3, 8) = p + q, canonical
template <bool UNPACKED>
__global__ void __launch_bounds__(128)
k_add_mixed_g1(const u32* __restrict__ p, const u32* __restrict__ q,
               u32* __restrict__ out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  P1 a, r;
  ld_p1(a, p + i * 24);
  const u32* qi = q + i * (UNPACKED ? 32 : 16);
  u32 x2[8], y2[8];
  ld_coord<UNPACKED>(x2, qi, 0);
  ld_coord<UNPACKED>(y2, qi, 1);
  g1_add_mixed(r, a, x2, y2);
  st_p1(out + i * 24, r);
}

// p (n, 6, 8); q (n, 4, 8) packed or (n, 4, 16) limbs; the zkey twist.
// Two threads a lane, each holding one Fq2 component.
template <bool UNPACKED>
__global__ void __launch_bounds__(G2_THREADS, 6)
k_add_mixed_g2(const u32* __restrict__ p, const u32* __restrict__ q,
               u32* __restrict__ out, long long n) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long i = t >> 1;
  bool c1 = t & 1, live = i < n;
  Q2 a, r;
  u32 x2[8], y2[8];
  if (live) {
    ld_q2(a, p + i * 48, c1);
    const u32* qi = q + i * (UNPACKED ? 64 : 32);
    ld_coord<UNPACKED>(x2, qi, c1 ? 1 : 0);
    ld_coord<UNPACKED>(y2, qi, c1 ? 3 : 2);
  } else {
    zero_q2(a);
#pragma unroll
    for (int w = 0; w < 8; w++) x2[w] = y2[w] = 0;
  }
  int z = is_zero8(x2) && is_zero8(y2);
  bool inf = z & __shfl_xor_sync(FULL_MASK, z, 1);
  s_add_mixed(r, a, x2, y2, c1);
  if (inf) r = a;                              // (0,0) = infinity
  if (live) st_q2(out + i * 48, r, c1);
}

static inline unsigned nblocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// the strict mixed adds; curve: 0 = G1, 1 = G2 on the zkey's twist;
// limbs: the affine operand as 16-bit limbs (add_mixed), else packed
// words (add_mixed_packed). One thread a G1 lane, two a G2 lane.
static int launch_add_mixed(bool limbs, int curve, const void* p,
                            const void* q, void* out, long long n,
                            void* stream) {
  if (n <= 0) return 0;
  const void* fn = curve == 0
      ? (limbs ? (const void*)k_add_mixed_g1<true>
               : (const void*)k_add_mixed_g1<false>)
      : (limbs ? (const void*)k_add_mixed_g2<true>
               : (const void*)k_add_mixed_g2<false>);
  int T = curve == 0 ? 128 : G2_THREADS;
  unsigned blocks = nblocks(curve == 0 ? n : 2 * n, T);
  void* args[] = {&p, &q, &out, &n};
  cudaLaunchKernel(fn, dim3(blocks), dim3(T), args, 0,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" {

int rs_add_mixed_packed(int curve, const void* p, const void* q, void* out,
                        long long n, void* stream) {
  return launch_add_mixed(false, curve, p, q, out, n, stream);
}

int rs_add_mixed(int curve, const void* p, const void* q, void* out,
                 long long n, void* stream) {
  return launch_add_mixed(true, curve, p, q, out, n, stream);
}

}  // extern "C"
