// BN254 Fq / Fr Montgomery arithmetic for the device (sm_90a).
//
// Device counterpart of rapidsnark_tpu_torch/ops/field.py: an element is
// 8 little-endian 32-bit limbs (the packed u32 words of the zkey/wtns
// payloads). Montgomery radix R = 2^256, the same as the 16 x 16-bit
// plain version, and the REDC output T = (a*b + m*p) / R is unique (m is
// the one value in [0, R) that makes the division exact), so every
// operation here returns the plain version's words exactly, the relaxed
// [0, 2p] family included. Sums are taken mod 2^256 (the carry out of
// the top limb is dropped) exactly where the plain version drops it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;

#define FQ_ID 0
#define FR_ID 1

// [field][limb]: modulus, 2*modulus, R mod modulus
__constant__ u32 K_P[2][8] = {
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}};
__constant__ u32 K_P2[2][8] = {
    {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
     0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u},
    {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
     0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u}};
__constant__ u32 K_R1[2][8] = {
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
     0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
     0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}};
// Montgomery form of 9 in Fq: the G1 b3 constant of the relaxed adders
__constant__ u32 K_C9[8] = {0x410d7ff7u, 0xf60647ceu, 0xd31bd011u,
                            0x2f3d6f4du, 0x3940c6d1u, 0x2943337eu,
                            0xa7e39857u, 0x1d9598e8u};

// Montgomery form of b3 = 3b = 9/(9+i) of the zkey's G2 twist, (c0, c1)
__constant__ u32 K_B3_G2[2][8] = {
    {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
     0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u},
    {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
     0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au}};
// p - K_B3_G2[1]: the Montgomery form of -B1
__constant__ u32 K_B3_G2_NEG1[8] = {0x62e5ff12u, 0x9168c5b0u, 0xad07a2d2u,
                                    0x65af5018u, 0x197d565eu, 0x3272d31fu,
                                    0x01f7f840u, 0x2c9f2108u};

// -p^-1 mod 2^32
template <int F>
__device__ __forceinline__ u32 n0inv() {
  return F == FQ_ID ? 0xe4866389u : 0xefffffffu;
}

__device__ __forceinline__ void cp8(u32 r[8], const u32 a[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = a[i];
}

// r = a + b mod 2^256; returns the carry out of the top limb
__device__ __forceinline__ u32 add8(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return c;
}

// r = a - b mod 2^256; returns the borrow (1 when a < b)
__device__ __forceinline__ u32 sub8(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 br;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(br)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return br & 1;
}

// s = s - k if s >= k else s
__device__ __forceinline__ void csub(u32 s[8], const u32 k[8]) {
  u32 d[8];
  u32 br = sub8(d, s, k);
#pragma unroll
  for (int i = 0; i < 8; i++) s[i] = br ? s[i] : d[i];
}

__device__ __forceinline__ bool is_zero8(const u32 a[8]) {
  u32 o = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) o |= a[i];
  return o == 0;
}

// ---- the Montgomery product -------------------------------------------
// CIOS, word by word (b[0] .. b[7]), written as carry chains of
// mad.lo.cc / madc.hi.cc. The running sum t*2^32 of one round is kept in
// two frames so that the a*b[i] and m*p rows split into two independent
// chains each: an even frame (words 0..7 of t) takes the products
// a[2k]*b[i] and p[2k]*m, an odd frame (words 1..8) a[2k+1]*b[i] and
// p[2k+1]*m, each product's low and high halves landing on two adjacent
// words of its frame. After a round the even frame's word 0 is zero;
// the next round reads the odd frame as its even frame and the even
// frame, two words down, as its odd frame, so the frames swap roles.
// A carry out of the even frame lands on the odd frame's top word; none
// leaves the odd frame: t < (a + p) * 2^32 < 2^288 for a <= 2p, since
// p < 2^254. The REDC output T = (a*b + m*p) / R is unique, so the words
// are those of the plain version; T < a*b/R + p < 2p for a, b <= 2p.

// x[0..7] = lo, hi of a[2k+O] * b at words 2k, 2k+1 (k = 0..3)
template <int O>
__device__ __forceinline__ void mul_row(u32 x[8], const u32 a[8], u32 b) {
#pragma unroll
  for (int k = 0; k < 4; k++)
    asm("mul.lo.u32 %0, %2, %3;\n\tmul.hi.u32 %1, %2, %3;"
        : "=r"(x[2 * k]), "=r"(x[2 * k + 1])
        : "r"(a[2 * k + O]), "r"(b));
}

// y[0..7] += w[2k+O] * b at words 2k, 2k+1; the carry out onto *top
template <int O>
__device__ __forceinline__ void mad_row(u32 y[8], u32* top, const u32 w[8],
                                        u32 b) {
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(y[0]), "+r"(y[1]), "+r"(y[2]), "+r"(y[3]), "+r"(y[4]),
        "+r"(y[5]), "+r"(y[6]), "+r"(y[7]), "+r"(*top)
      : "r"(w[O]), "r"(w[2 + O]), "r"(w[4 + O]), "r"(w[6 + O]), "r"(b));
}

// x[0..7] += w[2k+1] * b at words 2k, 2k+1, no carry out (the odd frame)
__device__ __forceinline__ void mad_row_odd(u32 x[8], const u32 w[8], u32 b) {
  asm("mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32 %7, %11, %12, %7;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
        "+r"(x[5]), "+r"(x[6]), "+r"(x[7])
      : "r"(w[1]), "r"(w[3]), "r"(w[5]), "r"(w[7]), "r"(b));
}

// The frame swap of a round: y[0] += x[1], then x becomes the odd frame
// x[2..7] + a[2k+1] * b (words 1..8 of the new t). The top word cannot
// carry: hi(a*b) <= 2^32 - 2.
__device__ __forceinline__ void shift_row_odd(u32 x[8], u32 y[8],
                                              const u32 a[8], u32 b) {
  asm("add.cc.u32 %8, %8, %1;\n\t"
      "madc.lo.cc.u32 %0, %9, %13, %2;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %4;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %5;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %6;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %7;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, 0;\n\t"
      "madc.hi.u32 %7, %12, %13, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
        "+r"(x[5]), "+r"(x[6]), "+r"(x[7]), "+r"(y[0])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
}

// the reduction of a round: m = y[0] * -p^-1; x += p_odd * m, y += p_even
// * m (y[0] becomes 0), y's carry onto x[7]
template <int F>
__device__ __forceinline__ void redc_row(u32 y[8], u32 x[8], const u32 p[8]) {
  u32 m = y[0] * n0inv<F>();
  mad_row_odd(x, p, m);
  mad_row<0>(y, &x[7], p, m);
}

// one round after the first: x is the frame whose word 0 is zero, y the
// odd frame; on return y is the zero frame and x the odd one
template <int F>
__device__ __forceinline__ void mont_round(u32 x[8], u32 y[8], const u32 a[8],
                                           u32 b, const u32 p[8]) {
  shift_row_odd(x, y, a, b);
  mad_row<0>(y, &x[7], a, b);
  redc_row<F>(y, x, p);
}

// the end of the loop: o is the zero frame, e the odd one; r = e + (o >> 32)
__device__ __forceinline__ void merge_frames(u32 r[8], const u32 e[8],
                                             const u32 o[8]) {
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(r[6]), "=r"(r[7])
      : "r"(e[0]), "r"(e[1]), "r"(e[2]), "r"(e[3]), "r"(e[4]), "r"(e[5]),
        "r"(e[6]), "r"(e[7]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]),
        "r"(o[5]), "r"(o[6]), "r"(o[7]));
}

// r = (a*b + m*p) / R, no final subtraction; r may alias a or b
template <int F>
__device__ __forceinline__ void mont(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 p[8], e[8], o[8];
  cp8(p, K_P[F]);
  mul_row<0>(e, a, b[0]);
  mul_row<1>(o, a, b[0]);
  redc_row<F>(e, o, p);
#pragma unroll
  for (int i = 1; i < 8; i += 2) {
    mont_round<F>(e, o, a, b[i], p);
    if (i + 1 < 8) mont_round<F>(o, e, a, b[i + 1], p);
  }
  merge_frames(r, e, o);
}

// ---- the reduction of a sum of two products ---------------------------
// mont2: r = (a*b + c*d + m*p) / R on the schedule of `mont`, each round
// adding both rows, a*b[i] and c*d[i], to the two frames before its one
// reduction row: a sum of two products for 2 x 128 + 136 multiply-adds,
// where two products take 2 x 264. Bounds, for a, b, c < p and d <= p
// (p - x for a canonical x, 0 included): the running sum stays under
// (a + c + p) * 2^32 < 3p * 2^32 < 2^288, so the odd frame never carries
// out; the REDC output is under (a*b + c*d) / R + p < 2p^2 / R + p < 2p,
// so one conditional subtraction makes it canonical, and since it is
// unique the words are those of f_add(f_mul(a, b), f_mul(c, d)).

// one round of mont2 after the first, as mont_round
template <int F>
__device__ __forceinline__ void mont2_round(u32 x[8], u32 y[8], const u32 a[8],
                                            u32 b, const u32 c[8], u32 d,
                                            const u32 p[8]) {
  shift_row_odd(x, y, a, b);
  mad_row<0>(y, &x[7], a, b);
  mad_row_odd(x, c, d);
  mad_row<0>(y, &x[7], c, d);
  redc_row<F>(y, x, p);
}

// r = (a*b + c*d) * R^-1 mod p, canonical; r may alias any operand
template <int F>
__device__ __forceinline__ void mont2(u32 r[8], const u32 a[8], const u32 b[8],
                                      const u32 c[8], const u32 d[8]) {
  u32 p[8], e[8], o[8];
  cp8(p, K_P[F]);
  mul_row<0>(e, a, b[0]);
  mul_row<1>(o, a, b[0]);
  mad_row_odd(o, c, d[0]);
  mad_row<0>(e, &o[7], c, d[0]);
  redc_row<F>(e, o, p);
#pragma unroll
  for (int i = 1; i < 8; i += 2) {
    mont2_round<F>(e, o, a, b[i], c, d[i], p);
    if (i + 1 < 8) mont2_round<F>(o, e, a, b[i + 1], c, d[i + 1], p);
  }
  merge_frames(r, e, o);
  csub(r, K_P[F]);
}

// ---- canonical ops (values < p) -------------------------------------------
template <int F>
__device__ __forceinline__ void f_mul(u32 r[8], const u32 a[8], const u32 b[8]) {
  mont<F>(r, a, b);
  csub(r, K_P[F]);
}

template <int F>
__device__ __forceinline__ void f_add(u32 r[8], const u32 a[8], const u32 b[8]) {
  add8(r, a, b);
  csub(r, K_P[F]);
}

// a + b without reduction (a `mul` input only)
__device__ __forceinline__ void f_add_lazy(u32 r[8], const u32 a[8], const u32 b[8]) {
  add8(r, a, b);
}

template <int F>
__device__ __forceinline__ void f_sub(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 d[8], e[8];
  u32 br = sub8(d, a, b);
  add8(e, d, K_P[F]);
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = br ? e[i] : d[i];
}

template <int F>
__device__ __forceinline__ void f_neg(u32 r[8], const u32 a[8]) {
  u32 z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  f_sub<F>(r, z, a);
}

template <int F>
__device__ __forceinline__ void f_dbl(u32 r[8], const u32 a[8]) {
  f_add<F>(r, a, a);
}

// ---- relaxed ops (values in [0, 2p]) ----------------------------------------
template <int F>
__device__ __forceinline__ void f_add_rx(u32 r[8], const u32 a[8], const u32 b[8]) {
  add8(r, a, b);
  csub(r, K_P2[F]);
}

// a - b + 2p mod 2^256, then one conditional subtraction of 2p
template <int F>
__device__ __forceinline__ void f_sub_rx(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 d[8];
  sub8(d, a, b);
  add8(r, d, K_P2[F]);
  csub(r, K_P2[F]);
}

template <int F>
__device__ __forceinline__ void f_neg_rx(u32 r[8], const u32 a[8]) {
  sub8(r, K_P2[F], a);
}

// 3*a mod 2^256, then one conditional subtraction of 2p
template <int F>
__device__ __forceinline__ void f_triple_rx(u32 r[8], const u32 a[8]) {
  u32 t[8];
  add8(t, a, a);
  add8(r, t, a);
  csub(r, K_P2[F]);
}

// ---- packed element-major loads / stores (16-byte vectors) ----------------
__device__ __forceinline__ void ld8(u32 r[8], const u32* p) {
  uint4 a = reinterpret_cast<const uint4*>(p)[0];
  uint4 b = reinterpret_cast<const uint4*>(p)[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__device__ __forceinline__ void st8(u32* p, const u32 r[8]) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(r[4], r[5], r[6], r[7]);
}
