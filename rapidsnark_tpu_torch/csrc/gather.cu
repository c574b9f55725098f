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
#include <cuda_runtime.h>

#define GATHER_THREADS 128
#define GATHER_MAX_SMEM 232448  // what one block may use on sm_90

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

}  // extern "C"
