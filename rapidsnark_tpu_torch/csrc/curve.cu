// Complete projective point adders. For the MSM: `add` and
// `scan_cols_packed`, G1 (relaxed [0, 2p] law, b3 = 9) and the G2
// iso-twist (canonical Fq2 law, b3 = 3+27i as a shift-add chain). For
// the fixture generator's fixed-base ladders: `add_mixed_packed` and
// `add_mixed`, the strict (canonical) mixed add on G1 and on G2's
// original twist (b3 = 9/(9+i), a full Fq2 product), the affine operand
// as packed words or as 16-bit limbs.
//
// Replaces the TPU kernels rapidsnark_tpu/ops/fused.py:159 `add`,
// fused.py:176 `scan_cols_packed`, fused.py:219 `add_mixed_packed` and
// fused.py:170 `add_mixed` (all through `_binary`, the pallas_call at
// fused.py:142).
//
// What bounds them on the H100: 32-bit integer multiply-adds. One G1
// mixed add is 14 Montgomery products of 8 x 8 limbs (~264 IMADs each:
// the a*b and m*p passes, low and high halves) against 64 + 96 bytes
// moved, far above the card's ~5 IMADs per byte; a G2 add is ~2.4x that
// work (33 Fq products).
// So the design keeps every coordinate in registers and touches device
// memory only for its operands and results:
//   * add: one thread per lane, the RCB formula fully in registers;
//     the ragged edge is masked in the kernel (no padding).
//   * scan_cols_packed: one thread per lane keeps the projective
//     accumulator in registers across all K columns of a launch (the
//     TPU's sequential grid covered 1-2 columns per launch; here one
//     launch loops over the whole C = 256-column chunk) and writes every
//     intermediate accumulator, which the MSM's prefix sums need.
//   * add_mixed_packed / add_mixed: one thread per lane, 11 Fq products
//     on G1 and 39 on G2 (13 Fq2 products by Karatsuba) against 160-448
//     bytes moved, so they too are bound by the multiply-adds; `add_mixed`
//     reads its affine operand as 16 limbs per coordinate and packs limb
//     pairs in registers, the rest is shared.
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

// projective (<= 2p) + canonical affine (x2, y2); (0,0) = infinity
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
  bool q_inf = is_zero8(x2) && is_zero8(y2);
  u32 m1[8], m2[8], o[8];
  mont<FQ_ID>(m1, t4, y3b);
  mont<FQ_ID>(m2, t3, t1m);
  f_sub_rx<FQ_ID>(o, m2, m1);
  u32 ox[8];
  cp8(ox, o);
  mont<FQ_ID>(m1, y3b, t0_3);
  mont<FQ_ID>(m2, t1m, z3);
  u32 oy[8];
  f_add_rx<FQ_ID>(oy, m2, m1);
  mont<FQ_ID>(m1, t0_3, t3);
  mont<FQ_ID>(m2, z3, t4);
  f_add_rx<FQ_ID>(o, m2, m1);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    r.x[i] = q_inf ? p.x[i] : ox[i];
    r.y[i] = q_inf ? p.y[i] : oy[i];
    r.z[i] = q_inf ? p.z[i] : o[i];
  }
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

// ---------------------------------------------------------------- G2 ------
struct P2 {
  Fe2 x, y, z;
};

// b3 * t. ISO: the iso-twist's b3 = 3 + 27i as a shift-add chain,
// (3t0 - 27t1, 27t0 + 3t1); else the zkey twist's b3 = 9/(9+i), a full
// Fq2 product by the constant.
template <bool ISO>
__device__ __forceinline__ void g2_mul_b3(Fe2& r, const Fe2& t) {
  if constexpr (ISO) {
    Fe2 s3, s27, d;
    f2_dbl(d, t);
    f2_add(s3, d, t);
    f2_dbl(d, s3);
    f2_dbl(d, d);
    f2_dbl(d, d);
    f2_add(s27, d, s3);
    f_sub<FQ_ID>(r.c0, s3.c0, s27.c1);
    f_add<FQ_ID>(r.c1, s27.c0, s3.c1);
  } else {
    Fe2 b3;
    cp8(b3.c0, K_B3_G2[0]);
    cp8(b3.c1, K_B3_G2[1]);
    f2_mul(r, t, b3);
  }
}

__device__ __forceinline__ void g2_add(P2& r, const P2& p, const P2& q) {
  Fe2 t0, t1, t2, s, u, t3, t4, t5;
  f2_mul(t0, p.x, q.x);
  f2_mul(t1, p.y, q.y);
  f2_mul(t2, p.z, q.z);
  f2_add(s, p.x, p.y);
  f2_add(u, q.x, q.y);
  f2_mul(t3, s, u);
  f2_sub(t3, t3, t0);
  f2_sub(t3, t3, t1);
  f2_add(s, p.y, p.z);
  f2_add(u, q.y, q.z);
  f2_mul(t4, s, u);
  f2_sub(t4, t4, t1);
  f2_sub(t4, t4, t2);
  f2_add(s, p.x, p.z);
  f2_add(u, q.x, q.z);
  f2_mul(t5, s, u);
  f2_sub(t5, t5, t0);
  f2_sub(t5, t5, t2);
  Fe2 t0_3, t2b, y3b, z3, t1m;
  f2_dbl(t0_3, t0);
  f2_add(t0_3, t0_3, t0);
  g2_mul_b3<true>(t2b, t2);
  g2_mul_b3<true>(y3b, t5);
  f2_add(z3, t1, t2b);
  f2_sub(t1m, t1, t2b);
  Fe2 m1, m2;
  f2_mul(m1, t4, y3b);
  f2_mul(m2, t3, t1m);
  f2_sub(r.x, m2, m1);
  f2_mul(m1, y3b, t0_3);
  f2_mul(m2, t1m, z3);
  f2_add(r.y, m2, m1);
  f2_mul(m1, t0_3, t3);
  f2_mul(m2, z3, t4);
  f2_add(r.z, m2, m1);
}

template <bool ISO>
__device__ __forceinline__ void g2_add_mixed(P2& r, const P2& p,
                                             const Fe2& x2, const Fe2& y2) {
  Fe2 t0, t1, s, u, t3, t4, y3l;
  f2_mul(t0, p.x, x2);
  f2_mul(t1, p.y, y2);
  f2_add(s, p.x, p.y);
  f2_add(u, x2, y2);
  f2_mul(t3, s, u);
  f2_sub(t3, t3, t0);
  f2_sub(t3, t3, t1);
  f2_mul(t4, y2, p.z);
  f2_add(t4, t4, p.y);
  f2_mul(y3l, x2, p.z);
  f2_add(y3l, y3l, p.x);
  Fe2 t0_3, t2b, y3b, z3, t1m;
  f2_dbl(t0_3, t0);
  f2_add(t0_3, t0_3, t0);
  g2_mul_b3<ISO>(t2b, p.z);
  g2_mul_b3<ISO>(y3b, y3l);
  f2_add(z3, t1, t2b);
  f2_sub(t1m, t1, t2b);
  bool q_inf = f2_is_zero(x2) && f2_is_zero(y2);
  Fe2 m1, m2, ox, oy, oz;
  f2_mul(m1, t4, y3b);
  f2_mul(m2, t3, t1m);
  f2_sub(ox, m2, m1);
  f2_mul(m1, y3b, t0_3);
  f2_mul(m2, t1m, z3);
  f2_add(oy, m2, m1);
  f2_mul(m1, t0_3, t3);
  f2_mul(m2, z3, t4);
  f2_add(oz, m2, m1);
  if (q_inf) {
    r = p;
  } else {
    r.x = ox;
    r.y = oy;
    r.z = oz;
  }
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
__device__ __forceinline__ void ld_f2(Fe2& e, const u32* a) {
  ld8(e.c0, a);
  ld8(e.c1, a + 8);
}
__device__ __forceinline__ void st_f2(u32* a, const Fe2& e) {
  st8(a, e.c0);
  st8(a + 8, e.c1);
}
__device__ __forceinline__ void ld_p2(P2& p, const u32* a) {
  ld_f2(p.x, a);
  ld_f2(p.y, a + 16);
  ld_f2(p.z, a + 32);
}
__device__ __forceinline__ void st_p2(u32* a, const P2& p) {
  st_f2(a, p.x);
  st_f2(a + 16, p.y);
  st_f2(a + 32, p.z);
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

// ------------------------------------------------------------ kernels ------
__global__ void __launch_bounds__(128)
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

__global__ void __launch_bounds__(128)
k_add_g2(const u32* __restrict__ p, const u32* __restrict__ q,
         u32* __restrict__ out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  P2 a, b, r;
  ld_p2(a, p + i * 48);
  ld_p2(b, q + i * 48);
  g2_add(r, a, b);
  st_p2(out + i * 48, r);
}

// acc (n, 3, 8); cols (K, n, 2, 8) canonical affine; sign (K, n);
// out (K, n, 3, 8): out[k] = acc + sum_{j<=k} (+-) cols[j]
__global__ void __launch_bounds__(128)
k_scan_g1(const u32* __restrict__ acc, const u32* __restrict__ cols,
          const int* __restrict__ sign, u32* __restrict__ out, long long n,
          int K) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  P1 a;
  ld_p1(a, acc + i * 24);
  for (int k = 0; k < K; k++) {
    long long e = (long long)k * n + i;
    u32 x2[8], y2[8], ny[8];
    ld8(x2, cols + e * 16);
    ld8(y2, cols + e * 16 + 8);
    if (sign[e] != 0) {
      f_neg<FQ_ID>(ny, y2);
      cp8(y2, ny);
    }
    g1_add_mixed_rx(a, a, x2, y2);
    st_p1(out + e * 24, a);
  }
}

// acc (n, 6, 8); cols (K, n, 4, 8); sign (K, n); out (K, n, 6, 8)
__global__ void __launch_bounds__(128)
k_scan_g2(const u32* __restrict__ acc, const u32* __restrict__ cols,
          const int* __restrict__ sign, u32* __restrict__ out, long long n,
          int K) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  P2 a;
  ld_p2(a, acc + i * 48);
  for (int k = 0; k < K; k++) {
    long long e = (long long)k * n + i;
    Fe2 x2, y2;
    ld_f2(x2, cols + e * 32);
    ld_f2(y2, cols + e * 32 + 16);
    if (sign[e] != 0) {
      Fe2 ny;
      f2_neg(ny, y2);
      y2 = ny;
    }
    P2 r;
    g2_add_mixed<true>(r, a, x2, y2);
    a = r;
    st_p2(out + e * 48, a);
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

// p (n, 6, 8); q (n, 4, 8) packed or (n, 4, 16) limbs; the zkey twist
template <bool UNPACKED>
__global__ void __launch_bounds__(128)
k_add_mixed_g2(const u32* __restrict__ p, const u32* __restrict__ q,
               u32* __restrict__ out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  P2 a, r;
  ld_p2(a, p + i * 48);
  const u32* qi = q + i * (UNPACKED ? 64 : 32);
  Fe2 x2, y2;
  ld_coord<UNPACKED>(x2.c0, qi, 0);
  ld_coord<UNPACKED>(x2.c1, qi, 1);
  ld_coord<UNPACKED>(y2.c0, qi, 2);
  ld_coord<UNPACKED>(y2.c1, qi, 3);
  g2_add_mixed<false>(r, a, x2, y2);
  st_p2(out + i * 48, r);
}

static inline unsigned nblocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// curve: 0 = G1 (strict law), 1 = G2 on the zkey's twist
template <bool UNPACKED>
static int launch_add_mixed(int curve, const void* p, const void* q,
                            void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == 0)
    k_add_mixed_g1<UNPACKED><<<nblocks(n, 128), 128, 0, s>>>(
        (const u32*)p, (const u32*)q, (u32*)out, n);
  else
    k_add_mixed_g2<UNPACKED><<<nblocks(n, 128), 128, 0, s>>>(
        (const u32*)p, (const u32*)q, (u32*)out, n);
  return (int)cudaGetLastError();
}

extern "C" {

// curve: 0 = G1 (relaxed law), 1 = G2 iso-twist
int rs_add(int curve, const void* p, const void* q, void* out, long long n,
           void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == 0)
    k_add_g1<<<nblocks(n, 128), 128, 0, s>>>((const u32*)p, (const u32*)q,
                                             (u32*)out, n);
  else
    k_add_g2<<<nblocks(n, 128), 128, 0, s>>>((const u32*)p, (const u32*)q,
                                             (u32*)out, n);
  return (int)cudaGetLastError();
}

int rs_scan_cols(int curve, const void* acc, const void* cols,
                 const void* sign, void* out, long long n, int K,
                 void* stream) {
  if (n <= 0 || K <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == 0)
    k_scan_g1<<<nblocks(n, 128), 128, 0, s>>>(
        (const u32*)acc, (const u32*)cols, (const int*)sign, (u32*)out, n, K);
  else
    k_scan_g2<<<nblocks(n, 128), 128, 0, s>>>(
        (const u32*)acc, (const u32*)cols, (const int*)sign, (u32*)out, n, K);
  return (int)cudaGetLastError();
}

int rs_add_mixed_packed(int curve, const void* p, const void* q, void* out,
                        long long n, void* stream) {
  return launch_add_mixed<false>(curve, p, q, out, n, stream);
}

int rs_add_mixed(int curve, const void* p, const void* q, void* out,
                 long long n, void* stream) {
  return launch_add_mixed<true>(curve, p, q, out, n, stream);
}

}  // extern "C"
