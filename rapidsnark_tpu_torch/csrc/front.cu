// The prover's front in BN254 Fr: `fr_slot_acc` (the coefficient
// accumulation) and `fr_pointwise` (elementwise products, differences and
// h = from_mont(a*b - c)), on packed Montgomery words.
//
// Replaces no Pallas kernel: on the TPU these were XLA programs,
// rapidsnark_tpu/prover.py:578-640 (`slot_acc`: witness gather, FR.mul
// and the slot sum; `segment_sum` over the spilled records, two-level
// past 2^15 terms a row; `reduce_wide`), :654-660 (cvec = a*b) and
// :686-700 (`_h_poly`), on 16-bit limbs in u32 lanes with deferred
// carries.
//
// What bounds them on the H100: bytes. `fr_slot_acc` moves 40 bytes of
// table a coefficient slot (an 8-byte witness index and a 32-byte value),
// the gathered witness row and 32 bytes out a row, for one Montgomery
// product (~264 IMADs) a slot: at the card's ~5 IMADs a byte of device
// memory, under two products a byte. `fr_pointwise` is 96-128 bytes an
// element for one or two products. So both keep everything between the
// loads and the store in registers (the plain versions materialise
// (32, lanes) int64 columns and their ripple temporaries, ~1.6 KB a
// lane), and:
//   * fr_slot_acc: one thread a row sums its K slots as modular adds of
//     canonical products (a canonical residue is unique, so the words are
//     those of the deferred-carry columns + reduce_wide); a slot whose
//     value is zero (padding) is skipped, witness gather included. The
//     records that spilled past K slots are sorted by row at set-up into
//     CSR offsets: a warp walks the rows of its 32 lanes that have any
//     and sums each one with all 32 lanes (a strided loop, then a
//     shuffle tree of modular adds), so a row of 2^15 terms is not one
//     thread's serial chain. No second pass and no atomics: the 2^15-
//     term carry headroom that made the TPU's pass two-level does not
//     exist for modular sums.
//   * fr_pointwise: one thread an element; the second operand may be a
//     row broadcast over the first (index i mod nb: the coset table over
//     a stack of polynomials, or 1/N over all of them).
#include "field.cuh"

#define FRONT_THREADS 256
#define FULL_MASK 0xffffffffu

// Fr 1 in standard form: from_mont(x) = mont(x, 1)
__constant__ u32 K_FR_ONE[8] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};

// acc += mont(witness[s], v) for one record (v != 0)
__device__ __forceinline__ void acc_term(u32 acc[8], const u32* __restrict__ wit,
                                         long long s, const u32 v[8]) {
  u32 w[8], t[8];
  ld8(w, wit + s * 8);
  f_mul<FR_ID>(t, w, v);
  f_add<FR_ID>(acc, acc, t);
}

// wit (nvars, 8) standard-form words; cs (rows * K,) int64 and cv
// (rows * K, 8) Montgomery words, row r's slots at r*K .. r*K+K-1 (value
// 0 = an empty slot); the spilled records ls (nleft,) int64 and lv
// (nleft, 8), lord (nleft,) int32 sorting them by row, loff (rows + 1,)
// int32 the CSR offsets of each row into lord (null when none spilled).
// out (rows, 8): row r = sum of mont(wit[s], v) over its slots and
// spilled records, canonical.
__global__ void __launch_bounds__(FRONT_THREADS)
k_slot_acc(const u32* __restrict__ wit, const long long* __restrict__ cs,
           const u32* __restrict__ cv, int K, const long long* __restrict__ ls,
           const u32* __restrict__ lv, const int* __restrict__ lord,
           const int* __restrict__ loff, u32* __restrict__ out,
           long long rows) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool live = r < rows;
  u32 acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (live) {
    for (int k = 0; k < K; k++) {
      const long long e = r * K + k;
      u32 v[8];
      ld8(v, cv + e * 8);
      if (!is_zero8(v)) acc_term(acc, wit, cs[e], v);
    }
  }
  if (loff != nullptr) {
    // every lane of the warp runs this part (rows past the end have no
    // records), so that the shuffles see the whole warp
    const int lane = threadIdx.x & 31;
    int beg = 0, end = 0;
    if (live) {
      beg = loff[r];
      end = loff[r + 1];
    }
    unsigned todo = __ballot_sync(FULL_MASK, end > beg);
    while (todo) {
      const int owner = __ffs(todo) - 1;
      todo &= todo - 1;
      const int b = __shfl_sync(FULL_MASK, beg, owner);
      const int e = __shfl_sync(FULL_MASK, end, owner);
      u32 part[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int j = b + lane; j < e; j += 32) {
        const long long o = lord[j];
        u32 v[8];
        ld8(v, lv + o * 8);
        acc_term(part, wit, ls[o], v);
      }
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
        u32 other[8];
#pragma unroll
        for (int i = 0; i < 8; i++)
          other[i] = __shfl_xor_sync(FULL_MASK, part[i], d);
        f_add<FR_ID>(part, part, other);
      }
      if (lane == owner) f_add<FR_ID>(acc, acc, part);
    }
  }
  if (live) st8(out + r * 8, acc);
}

// op 0: a*b; op 1: a - b; op 2: from_mont(a*b - c). a, c, out (n, 8);
// b (nb, 8), element i reads row i mod nb.
__global__ void __launch_bounds__(FRONT_THREADS)
k_pointwise(int op, const u32* __restrict__ a, const u32* __restrict__ b,
            const u32* __restrict__ c, u32* __restrict__ out, long long n,
            long long nb) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 x[8], y[8], r[8];
  ld8(x, a + i * 8);
  ld8(y, b + (nb == n ? i : i % nb) * 8);
  if (op == 1) {
    f_sub<FR_ID>(r, x, y);
  } else {
    f_mul<FR_ID>(r, x, y);
    if (op == 2) {
      ld8(x, c + i * 8);
      f_sub<FR_ID>(r, r, x);
      f_mul<FR_ID>(r, r, K_FR_ONE);
    }
  }
  st8(out + i * 8, r);
}

static inline unsigned front_blocks(long long n) {
  return (unsigned)((n + FRONT_THREADS - 1) / FRONT_THREADS);
}

extern "C" {

int rs_fr_slot_acc(const void* wit, const void* cs, const void* cv, int K,
                   const void* ls, const void* lv, const void* lord,
                   const void* loff, void* out, long long rows,
                   void* stream) {
  if (rows <= 0) return 0;
  if (K < 1) return (int)cudaErrorInvalidValue;
  k_slot_acc<<<front_blocks(rows), FRONT_THREADS, 0, (cudaStream_t)stream>>>(
      (const u32*)wit, (const long long*)cs, (const u32*)cv, K,
      (const long long*)ls, (const u32*)lv, (const int*)lord,
      (const int*)loff, (u32*)out, rows);
  return (int)cudaGetLastError();
}

int rs_fr_pointwise(int op, const void* a, const void* b, const void* c,
                    void* out, long long n, long long nb, void* stream) {
  if (n <= 0) return 0;
  if (op < 0 || op > 2 || nb < 1 || n % nb) return (int)cudaErrorInvalidValue;
  k_pointwise<<<front_blocks(n), FRONT_THREADS, 0, (cudaStream_t)stream>>>(
      op, (const u32*)a, (const u32*)b, (const u32*)c, (u32*)out, n, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
