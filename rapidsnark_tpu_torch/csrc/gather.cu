// Row gather `dma_gather`: out[i, :] = table[idx[i], :] over rows of R
// 32-bit words (4R a multiple of 16 bytes).
//
// Replaces the TPU kernel tools/bench_dma_gather.py:32 `dma_gather`
// (pallas_call at bench_dma_gather.py:58), which stages a block's
// indices in scalar memory, starts `nsem` row copies from device memory
// into the output block and waits on `nsem` semaphores.
//
// What bounds it on the H100: bytes only (m*4R read, m*4R written, 4m of
// indices; no arithmetic). Rows of 64 bytes and more, 64-byte aligned,
// use whole 32-byte sectors even at random addresses, so what holds a
// gather under the byte bound is the number of independent requests in
// flight on each SM. The design states that number directly:
//   * a block takes `blk` consecutive output rows and reads its own
//     indices; a row is R/4 pieces of 16 bytes, one thread a piece,
//     neighbouring threads on neighbouring pieces, so the block's output
//     is one contiguous span written with coalesced 16-byte stores;
//   * every thread starts `nsem` 16-byte `cp.async` copies (device memory
//     to shared memory, one commit group) before it waits, then stores
//     the pieces it staged. A thread reads back only what it copied
//     itself, so a wave needs no block barrier.
// `blk` and `nsem` keep the TPU kernel's meaning (rows a block, copies in
// flight), since the tool beside this kernel reads the request rate as
// they vary. One wave is waited for before the next is started (no second
// stage buffer), and the copies are per-thread `cp.async`, not bulk
// tensor copies with an mbarrier: both are left for a faster version.
// Indices are not checked against the table's length.
//
// Column gather `gather_cols`: the MSM's sorted points straight into the
// prefix scan's column layout, out[col, r, k, :] = table[r % B][perm[r,
// k*256 + col], :] for the R = G x B (window, table row) rows of a window
// group, 256 columns and nb = n / 256 chunks, rows of 2A 16-byte pieces
// (64 bytes on G1, 128 on G2's iso-twist).
//
// Replaces no Pallas kernel: on the TPU this was XLA's gather of
// rapidsnark_tpu/ops/msm.py `_gather_last` (:117), called at :484 with the
// sort's permutation. What bounds it on the H100: bytes (a row read and a
// row written an entry, 4 bytes of index). The same shape as
// `dma_gather`, so the same means: a block takes one row r and a span of
// up to GCOL_SPAN chunks k0.., loads that span's 256 x span indices
// coalesced into shared memory and reads them transposed; its work items
// are ordered (column, chunk, piece), so the pieces of one column's span
// are one contiguous run of the output and neighbouring threads store
// neighbouring 16-byte pieces, while a row's pieces are read by
// neighbouring threads as whole sectors. Every thread keeps GCOL_NSEM
// 16-byte cp.async copies in flight (dma_gather's helpers) and stores what
// it staged itself, so a wave needs no block barrier. Indices are not
// checked against the table's length. The transposed index tensor is
// never built: the index is computed here.
#include <cuda_runtime.h>

#define GATHER_THREADS 128
#define GATHER_MAX_SMEM 232448  // what one block may use on sm_90
#define GCOL_THREADS 256
#define GCOL_SPAN 8   // chunks of 256 entries a block
#define GCOL_NSEM 8   // 16-byte copies in flight a thread

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// pieces: 16-byte pieces a row (R / 4)
__global__ void k_dma_gather(const int4* __restrict__ table,
                             const int* __restrict__ idx,
                             int4* __restrict__ out, int pieces, int blk,
                             int nsem) {
  extern __shared__ int4 stage[];  // nsem x GATHER_THREADS pieces
  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * blk;
  const int total = blk * pieces;  // pieces of this block's rows
  int4* dst = out + row0 * pieces;
  for (int base = 0; base < total; base += nsem * GATHER_THREADS) {
    for (int k = 0; k < nsem; ++k) {
      const int pc = base + k * GATHER_THREADS + t;
      if (pc < total) {
        const int r = pc / pieces;
        const long long src =
            (long long)idx[row0 + r] * pieces + (pc - r * pieces);
        cp_async16(&stage[k * GATHER_THREADS + t], &table[src]);
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    for (int k = 0; k < nsem; ++k) {
      const int pc = base + k * GATHER_THREADS + t;
      if (pc < total) dst[pc] = stage[k * GATHER_THREADS + t];
    }
  }
}

// pts: B table rows of n entries, row b at pts + b * stride pieces; P: pieces
// an entry; perm (R, n) int32; out (256, R, nb, P pieces)
__global__ void __launch_bounds__(GCOL_THREADS)
    k_gather_cols(const int4* __restrict__ pts, long long stride, int P,
                  const int* __restrict__ perm, long long n, long long B,
                  long long R, int nb, int4* __restrict__ out) {
  __shared__ int idx[256 * GCOL_SPAN];
  __shared__ int4 stage[GCOL_NSEM * GCOL_THREADS];
  const int t = threadIdx.x;
  const int spans = (nb + GCOL_SPAN - 1) / GCOL_SPAN;
  const long long r = blockIdx.x / spans;
  const int k0 = (int)(blockIdx.x - r * spans) * GCOL_SPAN;
  const int T = min(GCOL_SPAN, nb - k0);
  const int* pr = perm + r * n + (long long)k0 * 256;
  for (int i = t; i < 256 * T; i += GCOL_THREADS) idx[i] = pr[i];
  __syncthreads();
  const int4* tb = pts + (r % B) * stride;
  const int run = T * P;        // pieces of one column's span
  const int total = 256 * run;
  for (int base = 0; base < total; base += GCOL_NSEM * GCOL_THREADS) {
#pragma unroll
    for (int s = 0; s < GCOL_NSEM; ++s) {
      const int q = base + s * GCOL_THREADS + t;
      if (q < total) {
        const int col = q / run, rem = q - col * run;
        const int tt = rem / P;
        cp_async16(&stage[s * GCOL_THREADS + t],
                   &tb[(long long)idx[tt * 256 + col] * P + (rem - tt * P)]);
      }
    }
    cp_async_commit();
    cp_async_wait_all();
#pragma unroll
    for (int s = 0; s < GCOL_NSEM; ++s) {
      const int q = base + s * GCOL_THREADS + t;
      if (q < total) {
        const int col = q / run, rem = q - col * run;
        out[(((long long)col * R + r) * nb + k0) * P + rem] =
            stage[s * GCOL_THREADS + t];
      }
    }
  }
}

extern "C" {

// table (n, R) int32, idx (m,) int32, out (m, R) int32, all contiguous
// and 16-byte aligned; R % 4 == 0, m % blk == 0, blk % nsem == 0 (the
// caller checks). n is taken for the interface's sake: rows are not
// checked against it.
int rs_dma_gather(const void* table, const void* idx, void* out, long long n,
                  long long m, int R, int blk, int nsem, void* stream) {
  (void)n;
  if (m <= 0) return 0;
  if (R <= 0 || R % 4 || blk <= 0 || nsem <= 0 || m % blk || blk % nsem)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nsem * GATHER_THREADS * sizeof(int4);
  if (smem > GATHER_MAX_SMEM || (long long)blk * (R / 4) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k_dma_gather, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k_dma_gather<<<(unsigned)(m / blk), GATHER_THREADS, smem,
                 (cudaStream_t)stream>>>((const int4*)table, (const int*)idx,
                                         (int4*)out, R / 4, blk, nsem);
  return (int)cudaGetLastError();
}

// pts: B rows of n entries of A x 8 words, row b at pts + b * stride words
// (stride % 4 == 0), 16-byte aligned; perm (G, B, n) int32 contiguous; out
// (256, G, B, n / 256, A, 8) int32 contiguous. n % 256 == 0 (the caller
// checks).
int rs_gather_cols(const void* pts, long long B, long long stride,
                   long long n, int A, const void* perm, long long G,
                   void* out, void* stream) {
  if (B <= 0 || G <= 0) return 0;
  if (n < 256 || n % 256 || A < 1 || A > 6 || stride % 4)
    return (int)cudaErrorInvalidValue;
  const int nb = (int)(n / 256);
  const long long blocks = G * B * ((nb + GCOL_SPAN - 1) / GCOL_SPAN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k_gather_cols<<<(unsigned)blocks, GCOL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)pts, stride / 4, 2 * A, (const int*)perm, n, B, G * B, nb,
      (int4*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
