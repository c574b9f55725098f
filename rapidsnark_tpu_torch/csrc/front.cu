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
// What bounds them on the H100: bytes. `fr_slot_acc` moves 36 bytes of
// table a coefficient slot (a 4-byte witness index and a 32-byte value),
// the gathered witness row and 32 bytes out a row, for one Montgomery
// product (~264 IMADs) a slot: at the card's ~5 IMADs a byte of device
// memory, under two products a byte. `fr_pointwise` is 96-128 bytes an
// element for one or two products. So both keep everything between the
// loads and the store in registers (the plain versions materialise
// (32, lanes) int64 columns and their ripple temporaries, ~1.6 KB a
// lane), and:
//   * fr_slot_acc is a gather: a slot's witness row is a random 32-byte
//     read, and the card streams only with ~2 MB of reads in flight. So
//     a thread a row first issues the index and value loads of all its
//     slots (slot-major tables: slot k of a warp's 32 rows is one
//     contiguous run), then the witness gathers of the filled ones (an
//     empty slot, value 0, is a predicate on its gather), then the
//     products: two memory latencies a group of up to 4 slots, not
//     three a slot. A row's sum is modular adds of canonical products
//     (a canonical residue is unique, so the words are those of the
//     deferred-carry columns + reduce_wide).
//   * The records that spilled past K slots are stored sorted by row
//     (set-up), so a record's only dependent load is its gather, and a
//     lane keeps SPILL_UNROLL of them in flight. A row's records are cut
//     into chunks of at most ops/front.SPILL_CHUNK (spill_work there lists
//     the (row, begin, end) items): a warp sums an item with a strided loop
//     and a shuffle tree, and adds it into the row itself when it is the
//     row's only item; otherwise it writes a partial, and a second
//     launch sums each such row's partials, a warp a row. A row of 2^24
//     terms is 16,384 warps, not one warp's serial walk. Rows are
//     written by one thread each, in stream order: no atomics, and no
//     carry headroom to run out of (the TPU's pass was two-level past
//     2^15 terms).
//   * fr_pointwise: one thread an element; the second operand may be a
//     row broadcast over the first (index i mod nb: the coset table over
//     a stack of polynomials, or 1/N over all of them).
#include "field.cuh"

#define FRONT_THREADS 256
#define FULL_MASK 0xffffffffu
#define SLOT_GROUP 4     // slots a thread loads before its first product
#define SPILL_UNROLL 4   // spilled records a lane has in flight

// Fr 1 in standard form: from_mont(x) = mont(x, 1)
__constant__ u32 K_FR_ONE[8] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};

__device__ __forceinline__ void zero8(u32 a[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) a[i] = 0;
}

// every lane ends with the modular sum of the warp's a (all 32 lanes must
// run it)
__device__ __forceinline__ void warp_sum(u32 a[8]) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    u32 other[8];
#pragma unroll
    for (int i = 0; i < 8; i++) other[i] = __shfl_xor_sync(FULL_MASK, a[i], d);
    f_add<FR_ID>(a, a, other);
  }
}

// row o += a (its only writer at this point of the stream)
__device__ __forceinline__ void add_into(u32* o, const u32 a[8]) {
  u32 x[8];
  ld8(x, o);
  f_add<FR_ID>(x, x, a);
  st8(o, x);
}

// wit (nvars, 8) words; cs (K, rows) int32 witness indices and cv (K,
// rows, 8) values, slot-major. A value of 0 is an empty slot. out (rows,
// 8): row r = sum over its slots of mont(wit[s], v), canonical.
template <int G>
__global__ void __launch_bounds__(FRONT_THREADS)
k_slot_rows(const u32* __restrict__ wit, const int* __restrict__ cs,
            const u32* __restrict__ cv, int K, u32* __restrict__ out,
            long long rows) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= rows) return;
  u32 acc[8];
  zero8(acc);
  for (int k0 = 0; k0 < K; k0 += G) {
    long long s[G];
    u32 v[G][8], w[G][8];
#pragma unroll
    for (int j = 0; j < G; j++) {
      const long long e = (k0 + j) * rows + r;
      s[j] = 0;
      zero8(v[j]);
      if (k0 + j < K) {
        s[j] = cs[e];
        ld8(v[j], cv + e * 8);
      }
    }
#pragma unroll
    for (int j = 0; j < G; j++)
      if (!is_zero8(v[j])) ld8(w[j], wit + s[j] * 8);
#pragma unroll
    for (int j = 0; j < G; j++) {
      if (!is_zero8(v[j])) {
        u32 t[8];
        f_mul<FR_ID>(t, w[j], v[j]);
        f_add<FR_ID>(acc, acc, t);
      }
    }
  }
  st8(out + r * 8, acc);
}

// The spilled records ls (int32 witness indices) and lv, sorted by row;
// off (rows + 1) their CSR offsets; items (nitems, 3) = (row, begin, end)
// spans of at most one chunk, a row's in order. A warp an item: into the
// row when the item is the whole row, else into part[item].
__global__ void __launch_bounds__(FRONT_THREADS)
k_spill_items(const u32* __restrict__ wit, const int* __restrict__ ls,
              const u32* __restrict__ lv, const int* __restrict__ off,
              const int* __restrict__ items, long long nitems,
              u32* __restrict__ part, u32* __restrict__ out) {
  const long long it = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (it >= nitems) return;  // the same for the whole warp
  const int lane = threadIdx.x & 31;
  const int row = items[3 * it], beg = items[3 * it + 1],
            end = items[3 * it + 2];
  u32 acc[8];
  zero8(acc);
  for (int j0 = beg + lane; j0 < end; j0 += 32 * SPILL_UNROLL) {
    long long s[SPILL_UNROLL];
    u32 v[SPILL_UNROLL][8], w[SPILL_UNROLL][8];
#pragma unroll
    for (int u = 0; u < SPILL_UNROLL; u++) {
      const int j = j0 + 32 * u;
      s[u] = 0;
      if (j < end) {
        s[u] = ls[j];
        ld8(v[u], lv + (long long)j * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < SPILL_UNROLL; u++)
      if (j0 + 32 * u < end) ld8(w[u], wit + s[u] * 8);
#pragma unroll
    for (int u = 0; u < SPILL_UNROLL; u++) {
      if (j0 + 32 * u < end) {
        u32 t[8];
        f_mul<FR_ID>(t, w[u], v[u]);
        f_add<FR_ID>(acc, acc, t);
      }
    }
  }
  warp_sum(acc);
  if (lane == 0) {
    if (beg == off[row] && end == off[row + 1])
      add_into(out + (long long)row * 8, acc);
    else
      st8(part + it * 8, acc);
  }
}

// multi (nmulti, 3) = (row, first item, end item) of the rows of two or
// more items: a warp a row adds the row's partials into it.
__global__ void __launch_bounds__(FRONT_THREADS)
k_spill_rows(const u32* __restrict__ part, const int* __restrict__ multi,
             long long nmulti, u32* __restrict__ out) {
  const long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (i >= nmulti) return;  // the same for the whole warp
  const int lane = threadIdx.x & 31;
  u32 acc[8];
  zero8(acc);
  for (long long j = multi[3 * i + 1] + lane; j < multi[3 * i + 2]; j += 32) {
    u32 t[8];
    ld8(t, part + j * 8);
    f_add<FR_ID>(acc, acc, t);
  }
  warp_sum(acc);
  if (lane == 0) add_into(out + (long long)multi[3 * i] * 8, acc);
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

template <int G>
static void launch_slot_rows(const void* wit, const void* cs, const void* cv,
                             int K, void* out, long long rows,
                             cudaStream_t st) {
  k_slot_rows<G><<<front_blocks(rows), FRONT_THREADS, 0, st>>>(
      (const u32*)wit, (const int*)cs, (const u32*)cv, K, (u32*)out, rows);
}

static inline unsigned warp_blocks(long long n) {
  return (unsigned)((n * 32 + FRONT_THREADS - 1) / FRONT_THREADS);
}

extern "C" {

// The slots (K >= 0), then, with nitems > 0, the spilled records' items
// and, with nmulti > 0, the rows of several items (part: nitems x 8
// words of scratch): 1 + (nitems > 0) + (nmulti > 0) launches on the
// stream.
int rs_fr_slot_acc(const void* wit, const void* cs, const void* cv, int K,
                   const void* ls, const void* lv, const void* off,
                   const void* items, long long nitems, const void* multi,
                   long long nmulti, void* part, void* out, long long rows,
                   void* stream) {
  if (rows <= 0) return 0;
  if (K < 0 || nitems < 0 || nmulti < 0 || (nmulti > 0 && nitems == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (K <= 1)
    launch_slot_rows<1>(wit, cs, cv, K, out, rows, st);
  else if (K == 2)
    launch_slot_rows<2>(wit, cs, cv, K, out, rows, st);
  else if (K == 3)
    launch_slot_rows<3>(wit, cs, cv, K, out, rows, st);
  else
    launch_slot_rows<SLOT_GROUP>(wit, cs, cv, K, out, rows, st);
  if (nitems > 0)
    k_spill_items<<<warp_blocks(nitems), FRONT_THREADS, 0, st>>>(
        (const u32*)wit, (const int*)ls, (const u32*)lv, (const int*)off,
        (const int*)items, nitems, (u32*)part, (u32*)out);
  if (nmulti > 0)
    k_spill_rows<<<warp_blocks(nmulti), FRONT_THREADS, 0, st>>>(
        (const u32*)part, (const int*)multi, nmulti, (u32*)out);
  return (int)cudaGetLastError();
}

// Resident blocks per SM (FRONT_THREADS threads each) of the launch that
// fr_slot_acc makes for K slots a row (which 0), of
// k_spill_items (1) and of k_spill_rows (2).
int rs_front_occupancy(int which, int K, int* per_sm) {
  const void* fn;
  if (which == 1) {
    fn = (const void*)k_spill_items;
  } else if (which == 2) {
    fn = (const void*)k_spill_rows;
  } else if (K <= 1) {
    fn = (const void*)k_slot_rows<1>;
  } else if (K == 2) {
    fn = (const void*)k_slot_rows<2>;
  } else if (K == 3) {
    fn = (const void*)k_slot_rows<3>;
  } else {
    fn = (const void*)k_slot_rows<SLOT_GROUP>;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, fn, FRONT_THREADS, 0);
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
