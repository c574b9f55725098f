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
typedef uint64_t u64;

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

// -p^-1 mod 2^32
template <int F>
__device__ __forceinline__ u32 n0inv() {
  return F == FQ_ID ? 0xe4866389u : 0xefffffffu;
}

__device__ __forceinline__ void cp8(u32 r[8], const u32 a[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = a[i];
}

__device__ __forceinline__ u32 add8(u32 r[8], const u32 a[8], const u32 b[8]) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (u64)a[i] + b[i];
    r[i] = (u32)c;
    c >>= 32;
  }
  return (u32)c;
}

// r = a - b mod 2^256; returns the borrow (1 when a < b)
__device__ __forceinline__ u32 sub8(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 br = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 t = (u64)a[i] - b[i] - br;
    r[i] = (u32)t;
    br = (u32)(t >> 63);
  }
  return br;
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

// CIOS Montgomery product, no final subtraction: r = (a*b + m*p) / R
// mod 2^256. r may alias a or b.
template <int F>
__device__ __forceinline__ void mont(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (u64)a[j] * b[i] + t[j];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (u32)c;
    t[9] = (u32)(c >> 32);
    u32 m = t[0] * n0inv<F>();
    c = ((u64)m * K_P[F][0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (u64)m * K_P[F][j] + t[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (u32)c;
    t[8] = t[9] + (u32)(c >> 32);
  }
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = t[i];
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

// ---- Fq2 = Fq[i]/(i^2+1), canonical -----------------------------------------
struct Fe2 {
  u32 c0[8];
  u32 c1[8];
};

__device__ __forceinline__ void f2_add(Fe2& r, const Fe2& a, const Fe2& b) {
  f_add<FQ_ID>(r.c0, a.c0, b.c0);
  f_add<FQ_ID>(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void f2_sub(Fe2& r, const Fe2& a, const Fe2& b) {
  f_sub<FQ_ID>(r.c0, a.c0, b.c0);
  f_sub<FQ_ID>(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void f2_neg(Fe2& r, const Fe2& a) {
  f_neg<FQ_ID>(r.c0, a.c0);
  f_neg<FQ_ID>(r.c1, a.c1);
}

__device__ __forceinline__ void f2_dbl(Fe2& r, const Fe2& a) {
  f_add<FQ_ID>(r.c0, a.c0, a.c0);
  f_add<FQ_ID>(r.c1, a.c1, a.c1);
}

// Karatsuba: re = a0b0 - a1b1, im = (a0+a1)(b0+b1) - a0b0 - a1b1.
// An out-of-line call: with every Fq2 product inlined into the G2
// adders, nvcc 12.9's front end crashes (seen with CUDA 12.9 on the
// H100 machine); one call per Fq2 product keeps the kernels compact.
__device__ __noinline__ void f2_mul(Fe2& r, const Fe2& a, const Fe2& b) {
  u32 m0[8], m1[8], sa[8], sb[8], t[8];
  f_mul<FQ_ID>(m0, a.c0, b.c0);
  f_mul<FQ_ID>(m1, a.c1, b.c1);
  f_add_lazy(sa, a.c0, a.c1);
  f_add_lazy(sb, b.c0, b.c1);
  f_mul<FQ_ID>(t, sa, sb);
  f_sub<FQ_ID>(r.c0, m0, m1);
  f_sub<FQ_ID>(t, t, m0);
  f_sub<FQ_ID>(r.c1, t, m1);
}

__device__ __forceinline__ bool f2_is_zero(const Fe2& a) {
  return is_zero8(a.c0) && is_zero8(a.c1);
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
