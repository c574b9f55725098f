// Radix-2 NTT kernels over BN254 Fr: `ntt_butterfly` (one layer),
// `ntt_fused_pass` (a run of consecutive layers in one pass) and
// `ntt_tail` (the seven lowest layers of the per-stage configuration).
//
// Replaces the TPU kernels rapidsnark_tpu/ops/fused.py:233
// `ntt_butterfly` (pallas_call at fused.py:278), fused.py:371
// `ntt_fused_pass` (pallas_call at fused.py:448) and fused.py:458
// `ntt_tail` (pallas_call at fused.py:524).
//
// What bounds them on the H100. A butterfly is one Montgomery product
// (~264 IMADs: the a*b and m*p passes, low and high halves) per pair.
// The card's balance is about 5 IMADs per byte of device memory (16.7e12
// IMAD/s over 3.35 TB/s), so one layer per round trip (128 bytes a pair)
// is bound by bytes, and a pass that keeps 3 or more layers on chip is
// bound by the multiply-adds. The designs:
//   * ntt_butterfly: one (lo, hi) pair per thread, DIF or DIT; bytes
//     bound. It carries the per-stage configuration (RSTPU_NTT_FUSE=0):
//     the layers from bit 7 up, and every layer below 2^12 points.
//   * ntt_tail: the layers on bits 0-6, whose partners all lie inside
//     a contiguous 128-element tile. A block holds 8 such tiles (32 KB)
//     and the 127 twiddles of the seven layers (4 KB) in shared memory
//     and does one product per butterfly, 7 layers per round trip:
//     bound by the multiply-adds. (The TPU kernel multiplied every lane
//     and selected; the canonical words are the same.)
//   * ntt_fused_pass: one block loads a tile of 2^10 elements (32 KB of
//     shared memory) holding every partner of `nbits` consecutive
//     layers (bits lo_bit .. lo_bit+nbits-1) plus the contiguous low
//     bits that fill the tile (so global loads stay coalesced), applies
//     the optional elementwise pre-multiply, runs all those layers in
//     shared memory with one barrier per layer, and writes the tile
//     back: a 2^20 transform is 3 passes instead of 20, which moves the
//     bound from bytes to the multiply-adds. Up to 2^10 points one pass
//     is the whole transform of a polynomial (w = 0, one block each), so
//     a small domain costs one launch a direction, not one a layer plus
//     its relayout: there launch latency is the cost, not the card.
// Elements are packed Montgomery words, 8 x u32 each, element-major;
// twiddles are the (N/2, 8) table w^0 .. w^(N/2-1) of the direction.
#include "field.cuh"

#define TILE_BITS 10
#define NTT_THREADS 256

__device__ __forceinline__ void bfly(u32 lo[8], u32 hi[8], const u32 tw[8],
                                     bool dif) {
  u32 a[8], b[8];
  if (dif) {  // (lo + hi, tw * (lo - hi))
    f_add<FR_ID>(a, lo, hi);
    f_sub<FR_ID>(b, lo, hi);
    f_mul<FR_ID>(b, tw, b);
  } else {  // m = tw * hi; (lo + m, lo - m)
    u32 m[8];
    f_mul<FR_ID>(m, tw, hi);
    f_add<FR_ID>(a, lo, m);
    f_sub<FR_ID>(b, lo, m);
  }
  cp8(lo, a);
  cp8(hi, b);
}

__global__ void k_butterfly(const u32* __restrict__ lo,
                            const u32* __restrict__ hi,
                            const u32* __restrict__ tw, u32* __restrict__ olo,
                            u32* __restrict__ ohi, long long n, int dif) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 a[8], b[8], t[8];
  ld8(a, lo + i * 8);
  ld8(b, hi + i * 8);
  ld8(t, tw + i * 8);
  bfly(a, b, t, dif != 0);
  st8(olo + i * 8, a);
  st8(ohi + i * 8, b);
}

// x, out: (batch, 2^logn, 8); tw: (2^(logn-1), 8); pre_mul: (2^logn, 8)
// or null. Layers run on bits lo_bit .. lo_bit + nbits - 1, descending
// for DIF, ascending for DIT. w = contiguous low bits in the tile.
__global__ void __launch_bounds__(NTT_THREADS)
k_fused_pass(const u32* __restrict__ x, u32* __restrict__ out,
             const u32* __restrict__ tw, const u32* __restrict__ pre_mul,
             int logn, int lo_bit, int nbits, int w, int dif) {
  __shared__ uint4 tile[(1 << TILE_BITS) * 2];
  const int tbits = nbits + w;
  const int tsize = 1 << tbits;
  // block -> (batch, high bits above the layers, low bits above w)
  long long blk = blockIdx.x;
  const int nlowblk = lo_bit - w;
  const long long lowblk = blk & ((1LL << nlowblk) - 1);
  blk >>= nlowblk;
  const int nhigh = logn - lo_bit - nbits;
  const long long high = blk & ((1LL << nhigh) - 1);
  const long long b = blk >> nhigh;
  const long long base = (b << logn) | (high << (lo_bit + nbits)) |
                         (lowblk << w);
  const long long nmask = (1LL << logn) - 1;

  for (int i = threadIdx.x; i < tsize; i += blockDim.x) {
    long long t = i >> w, low = i & ((1 << w) - 1);
    long long e = base | (t << lo_bit) | low;
    u32 v[8];
    ld8(v, x + e * 8);
    if (pre_mul != nullptr) {
      u32 m[8];
      ld8(m, pre_mul + (e & nmask) * 8);
      f_mul<FR_ID>(v, v, m);
    }
    tile[2 * i] = make_uint4(v[0], v[1], v[2], v[3]);
    tile[2 * i + 1] = make_uint4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();

  for (int st = 0; st < nbits; st++) {
    const int ls = dif ? nbits - 1 - st : st;  // layer bit within t
    const int s = lo_bit + ls;                 // global layer bit
    const int pos = ls + w;                    // partner bit within tile
    for (int j = threadIdx.x; j < tsize / 2; j += blockDim.x) {
      const int ilo = ((j >> pos) << (pos + 1)) | (j & ((1 << pos) - 1));
      const int ihi = ilo | (1 << pos);
      const long long tl = ilo >> w, low = ilo & ((1 << w) - 1);
      // position within the half-block of size 2^s, then the table
      // stride N / 2^(s+1)
      const long long jj = ((tl & ((1LL << ls) - 1)) << lo_bit) |
                           (lowblk << w) | low;
      u32 a[8], c[8], t[8];
      uint4 q0 = tile[2 * ilo], q1 = tile[2 * ilo + 1];
      a[0] = q0.x; a[1] = q0.y; a[2] = q0.z; a[3] = q0.w;
      a[4] = q1.x; a[5] = q1.y; a[6] = q1.z; a[7] = q1.w;
      q0 = tile[2 * ihi];
      q1 = tile[2 * ihi + 1];
      c[0] = q0.x; c[1] = q0.y; c[2] = q0.z; c[3] = q0.w;
      c[4] = q1.x; c[5] = q1.y; c[6] = q1.z; c[7] = q1.w;
      ld8(t, tw + (jj << (logn - 1 - s)) * 8);
      bfly(a, c, t, dif != 0);
      tile[2 * ilo] = make_uint4(a[0], a[1], a[2], a[3]);
      tile[2 * ilo + 1] = make_uint4(a[4], a[5], a[6], a[7]);
      tile[2 * ihi] = make_uint4(c[0], c[1], c[2], c[3]);
      tile[2 * ihi + 1] = make_uint4(c[4], c[5], c[6], c[7]);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < tsize; i += blockDim.x) {
    long long t = i >> w, low = i & ((1 << w) - 1);
    long long e = base | (t << lo_bit) | low;
    reinterpret_cast<uint4*>(out + e * 8)[0] = tile[2 * i];
    reinterpret_cast<uint4*>(out + e * 8)[1] = tile[2 * i + 1];
  }
}

#define TAIL_BITS 7
#define TAIL_ELEMS 1024  // elements a block holds: 8 tiles of 2^TAIL_BITS

// x, out: (total, 8) with total a multiple of 128 (whole transforms of
// 2^logn >= 128 points, back to back); tw: (2^(logn-1), 8). Layers on
// bits 6..0 for DIF, 0..6 for DIT.
__global__ void __launch_bounds__(NTT_THREADS)
k_tail(const u32* __restrict__ x, u32* __restrict__ out,
       const u32* __restrict__ tw, long long total, int logn, int dif) {
  __shared__ uint4 tile[TAIL_ELEMS * 2];
  __shared__ uint4 stw[(1 << TAIL_BITS) * 2];
  const long long base = blockIdx.x * (long long)TAIL_ELEMS;
  const long long left = total - base;
  const int count = left < TAIL_ELEMS ? (int)left : TAIL_ELEMS;

  // stw[h + j] = the layer with half size h = 2^s, position j < h:
  // w^(j * N / 2h), the table row j << (logn - 1 - s)
  for (int t = threadIdx.x + 1; t < (1 << TAIL_BITS); t += blockDim.x) {
    const int s = 31 - __clz(t);
    const long long j = t - (1 << s);
    const uint4* src =
        reinterpret_cast<const uint4*>(tw + (j << (logn - 1 - s)) * 8);
    stw[2 * t] = src[0];
    stw[2 * t + 1] = src[1];
  }
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const uint4* src = reinterpret_cast<const uint4*>(x + (base + i) * 8);
    tile[2 * i] = src[0];
    tile[2 * i + 1] = src[1];
  }
  __syncthreads();

  for (int st = 0; st < TAIL_BITS; st++) {
    const int s = dif ? TAIL_BITS - 1 - st : st;
    const int h = 1 << s;
    for (int k = threadIdx.x; k < count / 2; k += blockDim.x) {
      const int j = k & (h - 1);
      const int ilo = ((k >> s) << (s + 1)) | j;
      const int ihi = ilo | h;
      u32 a[8], c[8], t[8];
      uint4 q0 = tile[2 * ilo], q1 = tile[2 * ilo + 1];
      a[0] = q0.x; a[1] = q0.y; a[2] = q0.z; a[3] = q0.w;
      a[4] = q1.x; a[5] = q1.y; a[6] = q1.z; a[7] = q1.w;
      q0 = tile[2 * ihi];
      q1 = tile[2 * ihi + 1];
      c[0] = q0.x; c[1] = q0.y; c[2] = q0.z; c[3] = q0.w;
      c[4] = q1.x; c[5] = q1.y; c[6] = q1.z; c[7] = q1.w;
      q0 = stw[2 * (h + j)];
      q1 = stw[2 * (h + j) + 1];
      t[0] = q0.x; t[1] = q0.y; t[2] = q0.z; t[3] = q0.w;
      t[4] = q1.x; t[5] = q1.y; t[6] = q1.z; t[7] = q1.w;
      bfly(a, c, t, dif != 0);
      tile[2 * ilo] = make_uint4(a[0], a[1], a[2], a[3]);
      tile[2 * ilo + 1] = make_uint4(a[4], a[5], a[6], a[7]);
      tile[2 * ihi] = make_uint4(c[0], c[1], c[2], c[3]);
      tile[2 * ihi + 1] = make_uint4(c[4], c[5], c[6], c[7]);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    uint4* dst = reinterpret_cast<uint4*>(out + (base + i) * 8);
    dst[0] = tile[2 * i];
    dst[1] = tile[2 * i + 1];
  }
}

extern "C" {

int rs_ntt_butterfly(const void* lo, const void* hi, const void* tw,
                     void* olo, void* ohi, long long n, int dif,
                     void* stream) {
  if (n <= 0) return 0;
  k_butterfly<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const u32*)lo, (const u32*)hi, (const u32*)tw, (u32*)olo, (u32*)ohi, n,
      dif);
  return (int)cudaGetLastError();
}

int rs_ntt_fused_pass(const void* x, void* out, const void* tw,
                      const void* pre_mul, long long batch, int logn,
                      int lo_bit, int nbits, int dif, void* stream) {
  if (nbits < 1 || nbits > TILE_BITS || lo_bit < 0 ||
      lo_bit + nbits > logn)
    return (int)cudaErrorInvalidValue;
  int w = TILE_BITS - nbits;
  if (w > lo_bit) w = lo_bit;
  long long nblk = batch << (logn - nbits - w);
  k_fused_pass<<<(unsigned)nblk, NTT_THREADS, 0, (cudaStream_t)stream>>>(
      (const u32*)x, (u32*)out, (const u32*)tw, (const u32*)pre_mul, logn,
      lo_bit, nbits, w, dif);
  return (int)cudaGetLastError();
}

int rs_ntt_tail(const void* x, void* out, const void* tw, long long batch,
                int logn, int dif, void* stream) {
  if (logn < TAIL_BITS) return (int)cudaErrorInvalidValue;
  const long long total = batch << logn;
  if (total <= 0) return 0;
  k_tail<<<(unsigned)((total + TAIL_ELEMS - 1) / TAIL_ELEMS), NTT_THREADS, 0,
           (cudaStream_t)stream>>>((const u32*)x, (u32*)out, (const u32*)tw,
                                   total, logn, dif);
  return (int)cudaGetLastError();
}

}  // extern "C"
