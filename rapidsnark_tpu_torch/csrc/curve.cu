// Complete projective point adders. For the MSM: `add` and
// `scan_cols_packed`, G1 (relaxed [0, 2p] law, b3 = 9) and the G2
// iso-twist (canonical Fq2 law, b3 = 3+27i as a shift-add chain). For
// the fixture generator's fixed-base ladders: `add_mixed_packed` and
// `add_mixed`, the strict (canonical) mixed add on G1 and on G2's
// original twist (b3 = 9/(9+i), a product by a constant), the affine
// operand as packed words or as 16-bit limbs.
//
// Replaces the TPU kernels rapidsnark_tpu/ops/fused.py:159 `add`,
// fused.py:176 `scan_cols_packed`, fused.py:219 `add_mixed_packed` and
// fused.py:170 `add_mixed` (all through `_binary`, the pallas_call at
// fused.py:142).
//
// What bounds them on the H100: 32-bit integer multiply-adds, and on G2
// the latency of their dependent chains. A Montgomery product (field.cuh)
// is two carry chains of mad.lo/madc.hi, which ptxas fuses into about
// 136 wide IMADs, plus some 50 other instructions. A G1 mixed add is 14
// products, a G2 one 11 Fq2 products, against 64-288 bytes moved, far
// above the card's ~5 IMADs per byte. So every coordinate stays in
// registers, device memory holds only operands and results, and:
//   * G1, one thread a lane, 128 threads a block, <= 128 registers: four
//     blocks an SM, and the scan issues IMADs at close to the card's rate.
//   * G2, two threads a lane, each holding one Fq2 component of every
//     value (see "G2, one component a thread"): for each Fq2 product a
//     thread reduces one sum of two Fq products (field.cuh `mont2`, 392
//     IMADs, 784 a lane where Karatsuba takes 792), and at <= 168
//     registers (a cap that costs at most a few spilled words) six
//     blocks of 64 threads fit an SM, twelve warps where one thread a
//     lane (255 registers) left eight, too few to cover the chains'
//     latency.
//   * scan_cols_packed: a lane's accumulator stays in registers across
//     all K columns of a launch (the TPU's sequential grid covered 1-2
//     columns per launch; here one launch loops over the whole C = 256
//     column chunk), every intermediate accumulator is written (the MSM's
//     prefix sums need them), and column k+1 is copied into shared memory
//     with cp.async while column k is added. A (0,0) column leaves the
//     accumulator as it is, without its arithmetic where a whole warp's
//     lanes have one.
//   * add_mixed_packed / add_mixed: the strict law. G1 one thread a lane
//     (11 Fq products). G2 two threads a lane on the schedule of `add`
//     (64-thread blocks, the same register cap): 13 Fq2 products a lane
//     by Karatsuba, 39 Fq products, ran on one thread at 254-255
//     registers and eight warps an SM, under half its bound; a thread
//     now runs 13 `mont2`s (one a component of each of 11 products, one
//     for each of the two products by b3 = 9/(9+i), whose constant both
//     threads hold). `add_mixed` reads its affine operand as 16
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

__device__ __forceinline__ void g1_add_rx(P1& r, const P1& p, const P1& q) {
  u32 t0[8], t1[8], t2[8], u0[8], u1[8], t3[8], t4[8], t5[8];
  mont<FQ_ID>(t0, p.x, q.x);
  mont<FQ_ID>(t1, p.y, q.y);
  mont<FQ_ID>(t2, p.z, q.z);
  mont<FQ_ID>(u0, p.x, q.y);
  mont<FQ_ID>(u1, p.y, q.x);
  f_add_rx<FQ_ID>(t3, u0, u1);
  mont<FQ_ID>(u0, p.y, q.z);
  mont<FQ_ID>(u1, p.z, q.y);
  f_add_rx<FQ_ID>(t4, u0, u1);
  mont<FQ_ID>(u0, p.x, q.z);
  mont<FQ_ID>(u1, p.z, q.x);
  f_add_rx<FQ_ID>(t5, u0, u1);
  u32 t2b[8], y3b[8], t0_3[8], z3[8], t1m[8];
  mont<FQ_ID>(t2b, t2, K_C9);
  mont<FQ_ID>(y3b, t5, K_C9);
  f_triple_rx<FQ_ID>(t0_3, t0);
  f_add_rx<FQ_ID>(z3, t1, t2b);
  f_sub_rx<FQ_ID>(t1m, t1, t2b);
  u32 m1[8], m2[8];
  mont<FQ_ID>(m1, t4, y3b);
  mont<FQ_ID>(m2, t3, t1m);
  f_sub_rx<FQ_ID>(r.x, m2, m1);
  mont<FQ_ID>(m1, y3b, t0_3);
  mont<FQ_ID>(m2, t1m, z3);
  f_add_rx<FQ_ID>(r.y, m2, m1);
  mont<FQ_ID>(m1, t0_3, t3);
  mont<FQ_ID>(m2, z3, t4);
  f_add_rx<FQ_ID>(r.z, m2, m1);
}

// projective (<= 2p) + canonical affine (x2, y2), which the caller has
// checked is not (0,0); r may alias p
__device__ __forceinline__ void g1_add_mixed_rx(P1& r, const P1& p,
                                                const u32 x2[8],
                                                const u32 y2[8]) {
  u32 t0[8], t1[8], u0[8], u1[8], t3[8], t4[8], y3l[8], t2b[8];
  mont<FQ_ID>(t0, p.x, x2);
  mont<FQ_ID>(t1, p.y, y2);
  mont<FQ_ID>(u0, p.x, y2);
  mont<FQ_ID>(u1, p.y, x2);
  f_add_rx<FQ_ID>(t3, u0, u1);
  mont<FQ_ID>(u0, y2, p.z);
  f_add_rx<FQ_ID>(t4, u0, p.y);
  mont<FQ_ID>(u0, x2, p.z);
  f_add_rx<FQ_ID>(y3l, u0, p.x);
  mont<FQ_ID>(t2b, p.z, K_C9);
  u32 t0_3[8], y3b[8], z3[8], t1m[8];
  f_triple_rx<FQ_ID>(t0_3, t0);
  mont<FQ_ID>(y3b, y3l, K_C9);
  f_add_rx<FQ_ID>(z3, t1, t2b);
  f_sub_rx<FQ_ID>(t1m, t1, t2b);
  u32 m1[8], m2[8];
  mont<FQ_ID>(m1, t4, y3b);
  mont<FQ_ID>(m2, t3, t1m);
  f_sub_rx<FQ_ID>(r.x, m2, m1);
  mont<FQ_ID>(m1, y3b, t0_3);
  mont<FQ_ID>(m2, t1m, z3);
  f_add_rx<FQ_ID>(r.y, m2, m1);
  mont<FQ_ID>(m1, t0_3, t3);
  mont<FQ_ID>(m2, z3, t4);
  f_add_rx<FQ_ID>(r.z, m2, m1);
}

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
// by schoolbook as one reduction of a sum of two products (`mont2`),
// c = 0: a0b0 + a1(p - b1), c = 1: a1b0 + a0b1 (1.5 Fq products' IMADs a
// thread, where Karatsuba takes three a lane); b3 = 3 + 27i (the
// iso-twist) hands over 27t, and b3 = 9/(9+i) (the zkey's own twist, the
// strict law) is a product by a constant that both threads hold whole
// with its c1 negated, so only t crosses. Every value is canonical, so
// the words are those of the plain law, whatever the order of its
// products. Every thread of a warp runs every shuffle.
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

// r = component c1 of a * b: c1 = 0 a0 b0 + a1 (p - b1), c1 = 1 a1 b0 + a0 b1
// (p - b1 is p for b1 = 0, which mont2 takes)
__device__ __forceinline__ void s_mul(u32 r[8], const u32 a[8], const u32 b[8],
                                      bool c1) {
  u32 ao[8], bo[8], nb[8], u[8], v[8];
  xchg8(ao, a);
  xchg8(bo, b);
  sub8(nb, K_P[FQ_ID], bo);
  sel8(u, c1, bo, b);
  sel8(v, c1, b, nb);
  mont2<FQ_ID>(r, a, u, ao, v);
}

// component c1 of (3 + 27i) * t: (3t0 - 27t1, 27t0 + 3t1)
__device__ __forceinline__ void s_mul_b3(u32 r[8], const u32 t[8], bool c1) {
  u32 d[8], s3[8], s27[8], so[8];
  f_dbl<FQ_ID>(d, t);
  f_add<FQ_ID>(s3, d, t);
  f_dbl<FQ_ID>(d, s3);
  f_dbl<FQ_ID>(d, d);
  f_dbl<FQ_ID>(d, d);
  f_add<FQ_ID>(s27, d, s3);
  xchg8(so, s27);
  f_sub<FQ_ID>(d, s3, so);
  f_add<FQ_ID>(s27, so, s3);
  sel8(r, c1, s27, d);
}

// component c1 of b3 * t on the zkey's twist, b3 = (B0, B1) = 9/(9+i):
// (t0 B0 + t1 (p - B1), t1 B0 + t0 B1)
__device__ __forceinline__ void s_mul_b3_twist(u32 r[8], const u32 t[8],
                                               bool c1) {
  u32 to[8], v[8];
  xchg8(to, t);
  sel8(v, c1, K_B3_G2[1], K_B3_G2_NEG1);
  mont2<FQ_ID>(r, t, K_B3_G2[0], to, v);
}

// component c1 of b3 * t: the iso-twist's (ISO) or the zkey twist's b3
template <bool ISO>
__device__ __forceinline__ void s_b3(u32 r[8], const u32 t[8], bool c1) {
  if constexpr (ISO)
    s_mul_b3(r, t, c1);
  else
    s_mul_b3_twist(r, t, c1);
}

struct Q2 {
  u32 x[8], y[8], z[8];
};

// g2_add, one component a thread
__device__ __forceinline__ void s_add(Q2& r, const Q2& p, const Q2& q,
                                      bool c1) {
  u32 t0[8], t1[8], t2[8], s[8], u[8], t3[8], t4[8], t5[8];
  s_mul(t0, p.x, q.x, c1);
  s_mul(t1, p.y, q.y, c1);
  s_mul(t2, p.z, q.z, c1);
  f_add<FQ_ID>(s, p.x, p.y);
  f_add<FQ_ID>(u, q.x, q.y);
  s_mul(t3, s, u, c1);
  f_sub<FQ_ID>(t3, t3, t0);
  f_sub<FQ_ID>(t3, t3, t1);
  f_add<FQ_ID>(s, p.y, p.z);
  f_add<FQ_ID>(u, q.y, q.z);
  s_mul(t4, s, u, c1);
  f_sub<FQ_ID>(t4, t4, t1);
  f_sub<FQ_ID>(t4, t4, t2);
  f_add<FQ_ID>(s, p.x, p.z);
  f_add<FQ_ID>(u, q.x, q.z);
  s_mul(t5, s, u, c1);
  f_sub<FQ_ID>(t5, t5, t0);
  f_sub<FQ_ID>(t5, t5, t2);
  u32 t0_3[8], t2b[8], y3b[8], z3[8], t1m[8];
  f_dbl<FQ_ID>(t0_3, t0);
  f_add<FQ_ID>(t0_3, t0_3, t0);
  s_mul_b3(t2b, t2, c1);
  s_mul_b3(y3b, t5, c1);
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

// projective + affine (x2, y2) != (0,0), one component a thread, on the
// iso-twist (ISO: the MSM's scan) or on the zkey's twist (the strict
// mixed adders); r may alias p
template <bool ISO>
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
  s_b3<ISO>(t2b, p.z, c1);
  s_b3<ISO>(y3b, y3l, c1);
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

// ------------------------------------------------- column prefetch ------
// The scan copies column k+1 (a thread's words of the affine operand, and
// the sign) into its own shared-memory slot with cp.async while it adds
// column k; two slots a thread, 20 words each (16 of the operand, the
// sign, padding), so that a warp's 16-byte reads of its slots fall on
// distinct banks. A thread reads only what it copied itself: no barrier.
constexpr int SLOT = 20;

__device__ __forceinline__ void cp_async16(u32* smem, const u32* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(u32* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// 16 words at x and 16 words at y (8 and 8 from a G2 thread's component)
// and the sign into slot
__device__ __forceinline__ void fetch_col(u32* slot, const u32* x,
                                          const u32* y, const int* sg) {
  cp_async16(slot, x);
  cp_async16(slot + 4, x + 4);
  cp_async16(slot + 8, y);
  cp_async16(slot + 12, y + 4);
  cp_async4(slot + 16, sg);
}

// ------------------------------------------------------------ kernels ------
constexpr int G1_THREADS = 128;  // one thread a lane, <= 128 registers
constexpr int G2_THREADS = 64;   // two threads a lane, <= 168 registers

__global__ void __launch_bounds__(G1_THREADS)
k_add_g1(const u32* __restrict__ p, const u32* __restrict__ q,
         u32* __restrict__ out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  P1 a, b, r;
  ld_p1(a, p + i * 24);
  ld_p1(b, q + i * 24);
  g1_add_rx(r, a, b);
  st_p1(out + i * 24, r);
}

// acc (n, 3, 8); cols (K, n, 2, 8) canonical affine; sign (K, n);
// out (K, n, 3, 8): out[k] = acc + sum_{j<=k} (+-) cols[j]
__global__ void __launch_bounds__(G1_THREADS)
k_scan_g1(const u32* __restrict__ acc, const u32* __restrict__ cols,
          const int* __restrict__ sign, u32* __restrict__ out, long long n,
          int K) {
  extern __shared__ __align__(16) u32 stage[];   // 2 x blockDim x SLOT
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32* slot = stage + threadIdx.x * SLOT;   // and slot + blockDim.x * SLOT
  P1 a;
  ld_p1(a, acc + i * 24);
  fetch_col(slot, cols + i * 16, cols + i * 16 + 8, sign + i);
  cp_async_commit();
#pragma unroll 1
  for (int k = 0; k < K; k++) {
    long long e = (long long)k * n + i;
    if (k + 1 < K) {
      const u32* c = cols + (e + n) * 16;
      fetch_col(slot + ((k + 1) & 1) * blockDim.x * SLOT, c, c + 8,
                sign + e + n);
    }
    cp_async_commit();
    cp_async_wait1();
    const u32* cur = slot + (k & 1) * blockDim.x * SLOT;
    u32 x2[8], y2[8];
    ld8(x2, cur);
    ld8(y2, cur + 8);
    if (!(is_zero8(x2) && is_zero8(y2))) {     // (0,0) leaves a as it is
      if (cur[16] != 0) f_neg<FQ_ID>(y2, y2);
      g1_add_mixed_rx(a, a, x2, y2);
    }
    st_p1(out + e * 24, a);
  }
}

// G2, two threads a lane (c1 = thread & 1 holds component c1). Lanes past
// n run the arithmetic on zeros, since their partners and warps need
// them in every shuffle, and store nothing.
__global__ void __launch_bounds__(G2_THREADS, 6)
k_add_g2(const u32* __restrict__ p, const u32* __restrict__ q,
         u32* __restrict__ out, long long n) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long i = t >> 1;
  bool c1 = t & 1, live = i < n;
  Q2 a, b, r;
  if (live) {
    ld_q2(a, p + i * 48, c1);
    ld_q2(b, q + i * 48, c1);
  } else {
    zero_q2(a);
    zero_q2(b);
  }
  s_add(r, a, b, c1);
  if (live) st_q2(out + i * 48, r, c1);
}

// acc (n, 6, 8); cols (K, n, 4, 8); sign (K, n); out (K, n, 6, 8)
__global__ void __launch_bounds__(G2_THREADS, 6)
k_scan_g2(const u32* __restrict__ acc, const u32* __restrict__ cols,
          const int* __restrict__ sign, u32* __restrict__ out, long long n,
          int K) {
  extern __shared__ __align__(16) u32 stage[];   // 2 x blockDim x SLOT
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long i = t >> 1;
  bool c1 = t & 1, live = i < n;
  int off = c1 ? 8 : 0;
  u32* slot = stage + threadIdx.x * SLOT;   // and slot + blockDim.x * SLOT
  Q2 a;
  if (live) {
    ld_q2(a, acc + i * 48, c1);
    fetch_col(slot, cols + i * 32 + off, cols + i * 32 + 16 + off, sign + i);
  } else {
    zero_q2(a);
  }
  cp_async_commit();
#pragma unroll 1
  for (int k = 0; k < K; k++) {
    long long e = (long long)k * n + i;
    if (live && k + 1 < K) {
      const u32* c = cols + (e + n) * 32 + off;
      fetch_col(slot + ((k + 1) & 1) * blockDim.x * SLOT, c, c + 16,
                sign + e + n);
    }
    cp_async_commit();
    cp_async_wait1();
    const u32* cur = slot + (k & 1) * blockDim.x * SLOT;
    u32 x2[8], y2[8];
    int sg = 0;
    if (live) {
      ld8(x2, cur);
      ld8(y2, cur + 8);
      sg = (int)cur[16];
    } else {
#pragma unroll
      for (int w = 0; w < 8; w++) x2[w] = y2[w] = 0;
    }
    int z = is_zero8(x2) && is_zero8(y2);
    bool inf = z & __shfl_xor_sync(FULL_MASK, z, 1);
    if (__any_sync(FULL_MASK, !inf)) {
      if (sg != 0) f_neg<FQ_ID>(y2, y2);
      s_add_mixed<true>(a, a, x2, y2, c1);
      // (0,0) leaves the accumulator as it is: such a lane reads back
      // what it stored last rather than keeping a copy in registers
      if (inf && live) ld_q2(a, k ? out + (e - n) * 48 : acc + i * 48, c1);
    }
    if (live) st_q2(out + e * 48, a, c1);
  }
}

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
// Two threads a lane, as k_add_g2.
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
  s_add_mixed<false>(r, a, x2, y2, c1);
  if (inf) r = a;                              // (0,0) = infinity
  if (live) st_q2(out + i * 48, r, c1);
}

// ------------------------------------------------------- prefix_totals ----
// The exclusive running sum of each row of the MSM's chunk totals: R rows
// of nb projective points in, out[r][k] = tot[r][0] + ... + tot[r][k-1]
// with infinity at k = 0, the offsets that the bucket lookups add to the
// in-chunk prefixes. It replaces no TPU kernel: the JAX package and the
// port before it ran a two-level Hillis-Steele prefix of `add`s, rolls
// and selects (~9 complete adds a total in ~80 launches a window group).
// Bound, like `add`'s, by the adds' multiply-adds; so the design spends
// few adds a total and keeps the card full:
//   * a lane (one thread on G1, two on G2, as `add`) folds PFX_T
//     consecutive totals of a row in registers; a block's LANES lanes
//     cover a tile of LANES x PFX_T totals;
//   * k_prefix_tiles: each block scans its lanes' sums in shared memory
//     (Hillis-Steele, log2(LANES) steps of one add) and writes each lane's
//     exclusive prefix inside the tile and the tile's total;
//   * k_prefix_out: each block sums the totals of its row's earlier tiles
//     (the carry: a lane folds every LANES-th, a halving tree in shared
//     memory), adds it to each lane's prefix, and the lane walks its
//     PFX_T totals again, writing the exclusive prefix before each.
// A lane runs 2 (PFX_T - 1) + log2(LANES) + 1 adds and its share of the
// carry: ~2.9 adds a total on G1, ~2.6 on G2, in two launches for any
// nb >= 1. PFX_T = 8 against 2 and 4: 0.289 / 0.664 / 0.425 ms for the
// 2^24 plan's G1 window group (16 x 16,384 totals), 0.300 / 0.753 /
// 0.350 for its G2 one (4 x 16,384; H100, PERF.md): a longer fold
// spreads the lanes' scan over more totals, which gains more than the
// fewer lanes lose in occupancy. The adds run in another order than the
// plain version's, so the words differ from it and the points are the
// same. Every warp runs each add whenever one of its lanes needs it
// (G2's adds shuffle between a lane's two threads), on infinity where a
// lane has no total.
constexpr int PFX_T = 8;   // totals a lane folds

template <int CURVE>
struct Pfx;

template <>
struct Pfx<0> {            // G1, relaxed law, one thread a lane
  using V = P1;
  static constexpr int W = 24, THREADS = G1_THREADS, TPL = 1, MINB = 1;
  static constexpr int LANES = THREADS / TPL;
  __device__ static void ld(V& a, const u32* p, bool) { ld_p1(a, p); }
  __device__ static void st(u32* p, const V& a, bool) { st_p1(p, a); }
  __device__ static void add(V& r, const V& a, const V& b, bool) {
    g1_add_rx(r, a, b);
  }
  __device__ static void inf(V& a, bool) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
      a.x[i] = a.z[i] = 0;
      a.y[i] = K_R1[FQ_ID][i];
    }
  }
};

template <>
struct Pfx<1> {            // G2 iso-twist, two threads a lane
  using V = Q2;
  static constexpr int W = 48, THREADS = G2_THREADS, TPL = 2, MINB = 6;
  static constexpr int LANES = THREADS / TPL;
  __device__ static void ld(V& a, const u32* p, bool c1) { ld_q2(a, p, c1); }
  __device__ static void st(u32* p, const V& a, bool c1) { st_q2(p, a, c1); }
  __device__ static void add(V& r, const V& a, const V& b, bool c1) {
    s_add(r, a, b, c1);
  }
  __device__ static void inf(V& a, bool c1) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
      a.x[i] = a.z[i] = 0;
      a.y[i] = c1 ? 0u : K_R1[FQ_ID][i];
    }
  }
};

// s += p[k], for the lanes whose `live` holds; the warp adds if any does
template <class F>
__device__ __forceinline__ void pfx_acc(typename F::V& s, const u32* p,
                                        bool live, bool c1) {
  if (__any_sync(FULL_MASK, live)) {
    typename F::V b, r;
    if (live)
      F::ld(b, p, c1);
    else
      F::inf(b, c1);
    F::add(r, s, b, c1);
    if (live) s = r;
  }
}

// tot (R, nb, W); block (row, tile) of R x tiles: lane_ex (R x tiles,
// LANES, W) each lane's exclusive prefix in the tile, tile_tot (R x tiles,
// W) the tile's total
template <int CURVE>
__global__ void __launch_bounds__(Pfx<CURVE>::THREADS, Pfx<CURVE>::MINB)
k_prefix_tiles(const u32* __restrict__ tot, u32* __restrict__ lane_ex,
               u32* __restrict__ tile_tot, long long nb, int tiles) {
  using F = Pfx<CURVE>;
  __shared__ __align__(16) u32 sm[F::LANES * F::W];
  const int lane = threadIdx.x / F::TPL;
  const bool c1 = threadIdx.x % F::TPL;
  const long long row = blockIdx.x / tiles;
  const long long first =
      ((long long)(blockIdx.x % tiles) * F::LANES + lane) * PFX_T;
  const u32* src = tot + row * nb * F::W;
  typename F::V s, b;
  if (first < nb)
    F::ld(s, src + first * F::W, c1);
  else
    F::inf(s, c1);
#pragma unroll 1
  for (int i = 1; i < PFX_T; i++)
    pfx_acc<F>(s, src + (first + i) * F::W, first + i < nb, c1);
  // inclusive scan of the lanes' sums
  u32* mine = sm + lane * F::W;
  F::st(mine, s, c1);
  __syncthreads();
#pragma unroll 1
  for (int sh = 1; sh < F::LANES; sh <<= 1) {
    bool act = lane >= sh;
    if (act)
      F::ld(b, mine - sh * F::W, c1);
    else
      F::inf(b, c1);
    __syncthreads();
    if (__any_sync(FULL_MASK, act)) {
      typename F::V r;
      F::add(r, b, s, c1);
      if (act) s = r;
    }
    F::st(mine, s, c1);
    __syncthreads();
  }
  if (lane)
    F::ld(b, mine - F::W, c1);
  else
    F::inf(b, c1);
  F::st(lane_ex + ((long long)blockIdx.x * F::LANES + lane) * F::W, b, c1);
  if (lane == F::LANES - 1)
    F::st(tile_tot + (long long)blockIdx.x * F::W, s, c1);
}

// out (R, nb, W): the carry of the row's earlier tiles plus each lane's
// prefix, then the lane's walk over its totals
template <int CURVE>
__global__ void __launch_bounds__(Pfx<CURVE>::THREADS, Pfx<CURVE>::MINB)
k_prefix_out(const u32* __restrict__ tot, const u32* __restrict__ lane_ex,
             const u32* __restrict__ tile_tot, u32* __restrict__ out,
             long long nb, int tiles) {
  using F = Pfx<CURVE>;
  __shared__ __align__(16) u32 sm[F::LANES * F::W];
  const int lane = threadIdx.x / F::TPL;
  const bool c1 = threadIdx.x % F::TPL;
  const long long row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  typename F::V c, e;
  F::inf(c, c1);
  if (tile) {                                  // the same in the block
    const u32* tt = tile_tot + row * tiles * F::W;
#pragma unroll 1
    for (int k = lane; k - lane < tile; k += F::LANES)
      pfx_acc<F>(c, tt + (long long)k * F::W, k < tile, c1);
    // halving tree over the m lanes that hold tiles
    const int m = tile < F::LANES ? tile : F::LANES;
    u32* mine = sm + lane * F::W;
    F::st(mine, c, c1);
    __syncthreads();
    int h = 1;
    while (2 * h < m) h *= 2;
#pragma unroll 1
    for (; h >= 1 && m > 1; h >>= 1) {
      bool act = lane < h && lane + h < m;
      pfx_acc<F>(c, mine + h * F::W, act, c1);
      __syncthreads();
      if (act) F::st(mine, c, c1);
      __syncthreads();
    }
    F::ld(c, sm, c1);
  }
  F::ld(e, lane_ex + ((long long)blockIdx.x * F::LANES + lane) * F::W, c1);
  if (tile) {
    typename F::V r;
    F::add(r, c, e, c1);
    e = r;
  }
  const long long first = ((long long)tile * F::LANES + lane) * PFX_T;
  const u32* src = tot + row * nb * F::W;
  u32* dst = out + row * nb * F::W;
#pragma unroll 1
  for (int i = 0; i < PFX_T; i++) {
    long long k = first + i;
    if (k < nb) F::st(dst + k * F::W, e, c1);
    if (i + 1 < PFX_T) pfx_acc<F>(e, src + k * F::W, k + 1 < nb, c1);
  }
}

// R rows of nb totals: both launches; work holds lane_ex then tile_tot
template <int CURVE>
static int launch_prefix(const void* tot, void* out, void* work,
                         long long work_words, long long rows, long long nb,
                         void* stream) {
  using F = Pfx<CURVE>;
  long long tiles = (nb + F::LANES * PFX_T - 1) / (F::LANES * PFX_T);
  long long blocks = rows * tiles;
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL || tiles > 0x7fffffffLL ||
      work_words < blocks * (F::LANES + 1) * F::W)
    return (int)cudaErrorInvalidValue;
  u32* lane_ex = (u32*)work;
  u32* tile_tot = lane_ex + blocks * F::LANES * F::W;
  int nt = (int)tiles;
  cudaStream_t s = (cudaStream_t)stream;
  k_prefix_tiles<CURVE><<<(unsigned)blocks, F::THREADS, 0, s>>>(
      (const u32*)tot, lane_ex, tile_tot, nb, nt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k_prefix_out<CURVE><<<(unsigned)blocks, F::THREADS, 0, s>>>(
      (const u32*)tot, lane_ex, tile_tot, (u32*)out, nb, nt);
  return (int)cudaGetLastError();
}

static inline unsigned nblocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// launch geometry for n lanes of `add` (op 0), `scan_cols_packed` (op 1),
// `add_mixed_packed` (op 2) and `add_mixed` (op 3): one thread a G1 lane,
// two a G2 lane
struct Geom {
  const void* fn;
  int threads;        // per block
  long long blocks;
  int smem;           // dynamic shared memory a block, bytes
};

static Geom pick(int op, int curve, long long n) {
  static const void* const fns[4][2] = {
      {(const void*)k_add_g1, (const void*)k_add_g2},
      {(const void*)k_scan_g1, (const void*)k_scan_g2},
      {(const void*)k_add_mixed_g1<false>, (const void*)k_add_mixed_g2<false>},
      {(const void*)k_add_mixed_g1<true>, (const void*)k_add_mixed_g2<true>}};
  int T = curve == 0 ? G1_THREADS : G2_THREADS;
  return {fns[op][curve != 0], T,
          (long long)nblocks(curve == 0 ? n : 2 * n, T),
          op == 1 ? 2 * T * SLOT * 4 : 0};
}

// the strict mixed adds (op 2, 3); curve: 0 = G1, 1 = G2 on the zkey's twist
static int launch_add_mixed(int op, int curve, const void* p, const void* q,
                            void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  Geom g = pick(op, curve, n);
  void* args[] = {&p, &q, &out, &n};
  cudaLaunchKernel(g.fn, dim3((unsigned)g.blocks), dim3(g.threads), args,
                   g.smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" {

// curve: 0 = G1 (relaxed law), 1 = G2 iso-twist
int rs_add(int curve, const void* p, const void* q, void* out, long long n,
           void* stream) {
  if (n <= 0) return 0;
  Geom g = pick(0, curve, n);
  void* args[] = {&p, &q, &out, &n};
  cudaLaunchKernel(g.fn, dim3((unsigned)g.blocks), dim3(g.threads), args,
                   g.smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int rs_scan_cols(int curve, const void* acc, const void* cols,
                 const void* sign, void* out, long long n, int K,
                 void* stream) {
  if (n <= 0 || K <= 0) return 0;
  Geom g = pick(1, curve, n);
  void* args[] = {&acc, &cols, &sign, &out, &n, &K};
  cudaLaunchKernel(g.fn, dim3((unsigned)g.blocks), dim3(g.threads), args,
                   g.smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// curve: 0 = G1 (relaxed law), 1 = G2 iso-twist; tot and out (rows, nb,
// L, 8); work: the wrapper's workspace of work_words int32 words
int rs_prefix_totals(int curve, const void* tot, void* out, void* work,
                     long long work_words, long long rows, long long nb,
                     void* stream) {
  return curve == 0
             ? launch_prefix<0>(tot, out, work, work_words, rows, nb, stream)
             : launch_prefix<1>(tot, out, work, work_words, rows, nb, stream);
}

int rs_add_mixed_packed(int curve, const void* p, const void* q, void* out,
                        long long n, void* stream) {
  return launch_add_mixed(2, curve, p, q, out, n, stream);
}

int rs_add_mixed(int curve, const void* p, const void* q, void* out,
                 long long n, void* stream) {
  return launch_add_mixed(3, curve, p, q, out, n, stream);
}

// The geometry `rs_add` (op 0), `rs_scan_cols` (op 1),
// `rs_add_mixed_packed` (op 2) or `rs_add_mixed` (op 3) launches for n
// lanes: out = {threads per block, blocks, resident blocks per SM}.
int rs_curve_geometry(int op, int curve, long long n, int* out) {
  if (op < 0 || op > 3) return (int)cudaErrorInvalidValue;
  Geom g = pick(op, curve, n);
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, g.fn, g.threads, g.smem);
  out[0] = g.threads;
  out[1] = (int)g.blocks;
  out[2] = per_sm;
  return (int)e;
}

}  // extern "C"
