// The MSM's bucket sort `digit_sort`: R rows of n encoded signed digits
// |d|*2 + (d<0) (each < 2^(c+1), int64 as glv_digits writes them) sorted
// stably row by row, with the permutation, the sign bit of each sorted
// entry in the prefix scan's column layout, and the bucket boundaries.
//
// Replaces no Pallas kernel: on the TPU this was XLA work of
// rapidsnark_tpu/ops/msm.py `_window_group`: :482 `jax.lax.sort_key_val`
// (the stable sort of the digits with an iota), :485 the sign row
// `sorted & 1`, and :490-493 `jnp.searchsorted` of the keys 2j+1, j =
// 0..M (M = 2^(c-1)), the end of bucket |d| <= j.
//
// What bounds it on the H100: bytes. A key is read once as int64 (8 B);
// the sorted key, the permutation and the sign are written once as int32
// (12 B); the boundaries are M+1 words a row. No arithmetic to speak of.
// The design is an LSD radix sort over the c+1 key bits in passes of at
// most SORT_MAX_BITS bits (two passes at c = 13..16, one up to c = 9),
// rows sorted independently but in the same launches. Each pass:
//   * k_sort_hist: a block counts the digits of one tile of SORT_TILE
//     keys of one row in shared memory (a warp's lanes with the same
//     digit add once, by __match_any_sync) and writes them digit-major,
//     hist[(row, digit, tile)];
//   * k_sort_scan_*: one exclusive scan of the whole histogram (a block sum a
//     chunk, a scan of the sums, a block scan a chunk). Every row holds
//     exactly n keys, so the scan of row r starts at r * n: its values are
//     the flat output index of each (row, digit, tile)'s first key, and
//     no row needs a segment of its own;
//   * k_sort_scatter: a block ranks its tile stably. Warp w takes the
//     w-th run of 32 * SORT_KPT keys in rounds of 32 consecutive keys;
//     a key's rank is the count of its digit in the warp's earlier rounds
//     (a counter a warp and digit in shared memory) plus its lower peers
//     (__match_any_sync); the warps' counts are then scanned in warp
//     order, so input order is kept across warps. The tile is reordered
//     by digit in shared memory and written out in that order, so a
//     digit's keys leave as one coalesced run.
// The first pass makes the permutation's iota values itself. Then
// k_sort_tail reads the sorted keys once, a block a row's span of
// TAIL_SPAN chunks staged in shared memory: it writes each entry's sign
// into its column slot (sorted position k*256 + col of row r -> sign[col,
// r, k]), a column's span as one contiguous run, and fills the
// boundaries: where sorted keys i and i+1 of a row fall in different
// buckets (key >> 1), the thread of i writes i + 1 for the buckets in
// between, and the first and last key write the ends. Keys are not
// checked against 2^(c+1) on the card (that needs a host sync): a key out
// of range is sorted by its low c+1 bits and never written out of bounds.
// Workspace (ping-pong keys and values of the first pass, histogram, scan
// sums) comes from the caller; nothing is allocated or synchronised here.
// A faster version would keep the histogram's scan in one pass (decoupled
// look-back) and count a pass's digits without __match_any_sync.
#include <cuda_runtime.h>

#define SORT_THREADS 256
#define SORT_KPT 16                               // keys a thread a tile
#define SORT_TILE (SORT_THREADS * SORT_KPT)       // 4096 keys a tile
#define SORT_WARPS (SORT_THREADS / 32)
#define SORT_MAX_BITS 10                          // bits a pass at most
#define SCAN_CHUNK 4096                           // histogram words a block
#define TAIL_SPAN 32                              // chunks a block of k_sort_tail
#define FULL_MASK 0xffffffffu

// exclusive scan of v over the block's NT threads; *total gets the sum.
// ws: NT / 32 words of shared memory, free again on return
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* ws,
                                                    int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < NT / 32 ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, s, o);
      if (lane >= o) s += y;
    }
    if (lane < NT / 32) ws[lane] = s;
  }
  __syncthreads();
  const int before = w ? ws[w - 1] : 0;
  *total = ws[NT / 32 - 1];
  __syncthreads();
  return before + x - v;
}

// ---- one radix pass ---------------------------------------------------------

template <typename K>
__global__ void __launch_bounds__(SORT_THREADS)
    k_sort_hist(const K* __restrict__ keys, int n, int ntiles, int shift,
                int bits, int* __restrict__ hist) {
  extern __shared__ int sh[];  // 1 << bits counters
  const int nbins = 1 << bits, mask = nbins - 1;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < nbins; i += SORT_THREADS) sh[i] = 0;
  __syncthreads();
  const int row = blockIdx.x / ntiles, tile = blockIdx.x - row * ntiles;
  const long long base = (long long)row * n + (long long)tile * SORT_TILE;
  const int valid = min(SORT_TILE, n - tile * SORT_TILE);
#pragma unroll 4
  for (int j = 0; j < SORT_KPT; j++) {
    const int p = j * SORT_THREADS + tid;
    const int d = p < valid ? (int)((keys[base + p] >> shift) & mask) : nbins;
    const unsigned peers = __match_any_sync(FULL_MASK, d);
    if (d < nbins && lane == __ffs(peers) - 1) atomicAdd(&sh[d], __popc(peers));
  }
  __syncthreads();
  for (int d = tid; d < nbins; d += SORT_THREADS)
    hist[((long long)row * nbins + d) * ntiles + tile] = sh[d];
}

__global__ void __launch_bounds__(SORT_THREADS)
    k_sort_scan_reduce(const int* __restrict__ h, long long H,
                  int* __restrict__ part) {
  __shared__ int ws[SORT_WARPS];
  const long long base = (long long)blockIdx.x * SCAN_CHUNK;
  int s = 0;
  for (int j = 0; j < SCAN_CHUNK / SORT_THREADS; j++) {
    const long long i = base + j * SORT_THREADS + threadIdx.x;
    if (i < H) s += h[i];
  }
  int tot;
  block_exclusive_scan<SORT_THREADS>(s, ws, &tot);
  if (threadIdx.x == 0) part[blockIdx.x] = tot;
}

// one block of 1024 threads: the chunk sums, exclusive, in place
__global__ void __launch_bounds__(1024)
    k_sort_scan_partials(int* __restrict__ part, int np) {
  __shared__ int ws[32];
  const int per = (np + 1023) / 1024;
  const int lo = min(np, (int)threadIdx.x * per), hi = min(np, lo + per);
  int s = 0;
  for (int i = lo; i < hi; i++) s += part[i];
  int tot;
  int ex = block_exclusive_scan<1024>(s, ws, &tot);
  for (int i = lo; i < hi; i++) {
    const int v = part[i];
    part[i] = ex;
    ex += v;
  }
}

__global__ void __launch_bounds__(SORT_THREADS)
    k_sort_scan_down(int* __restrict__ h, long long H,
                const int* __restrict__ part) {
  __shared__ int buf[SCAN_CHUNK];
  __shared__ int ws[SORT_WARPS];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * SCAN_CHUNK;
  for (int j = 0; j < SCAN_CHUNK / SORT_THREADS; j++) {
    const long long i = base + j * SORT_THREADS + tid;
    buf[j * SORT_THREADS + tid] = i < H ? h[i] : 0;
  }
  __syncthreads();
  const int per = SCAN_CHUNK / SORT_THREADS;
  int s = 0;
  for (int q = 0; q < per; q++) s += buf[tid * per + q];
  int tot;
  int ex = block_exclusive_scan<SORT_THREADS>(s, ws, &tot) + part[blockIdx.x];
  for (int q = 0; q < per; q++) {
    const int v = buf[tid * per + q];
    buf[tid * per + q] = ex;
    ex += v;
  }
  __syncthreads();
  for (int j = 0; j < SCAN_CHUNK / SORT_THREADS; j++) {
    const long long i = base + j * SORT_THREADS + tid;
    if (i < H) h[i] = buf[j * SORT_THREADS + tid];
  }
}

// offs: the scanned histogram. FIRST: the values are the keys' indices in
// their row (made here, vals unread)
template <typename K, bool FIRST>
__global__ void __launch_bounds__(SORT_THREADS)
    k_sort_scatter(const K* __restrict__ keys, const int* __restrict__ vals,
                   int n, int ntiles, int shift, int bits,
                   const int* __restrict__ offs, int* __restrict__ okeys,
                   int* __restrict__ ovals) {
  extern __shared__ int sm[];
  const int nbins = 1 << bits, mask = nbins - 1;
  int* wc = sm;                        // SORT_WARPS x nbins: warp counts
  int* dstart = wc + SORT_WARPS * nbins;  // a digit's first slot in the tile
  int* goff = dstart + nbins;          // its first output index, less dstart
  int* tk = goff + nbins;              // the tile's keys, ordered by digit
  int* tv = tk + SORT_TILE;            // and their values
  __shared__ int ws[SORT_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int row = blockIdx.x / ntiles, tile = blockIdx.x - row * ntiles;
  const long long base = (long long)row * n + (long long)tile * SORT_TILE;
  const int valid = min(SORT_TILE, n - tile * SORT_TILE);
  for (int i = tid; i < SORT_WARPS * nbins; i += SORT_THREADS) wc[i] = 0;
  __syncthreads();
  // rank each key among the earlier keys of its digit in its warp's run
  int key[SORT_KPT], rk[SORT_KPT];
  int* mywc = wc + w * nbins;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < SORT_KPT; j++) {
    const int p = w * (32 * SORT_KPT) + j * 32 + lane;
    const bool ok = p < valid;
    key[j] = ok ? (int)keys[base + p] : 0;
    const int d = ok ? (key[j] >> shift) & mask : nbins;
    const unsigned peers = __match_any_sync(FULL_MASK, d);
    const int cnt = ok ? mywc[d] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) mywc[d] = cnt + __popc(peers);
    __syncwarp();
    rk[j] = cnt + __popc(peers & lower);
  }
  __syncthreads();
  // per digit: the warps' counts -> exclusive offsets in warp order; the
  // digit's count in the tile, then its first slot (a block scan)
  const int per = (nbins + SORT_THREADS - 1) / SORT_THREADS;
  int tot = 0;
  for (int q = 0; q < per; q++) {
    const int d = tid * per + q;
    if (d >= nbins) break;
    int s = 0;
#pragma unroll
    for (int ww = 0; ww < SORT_WARPS; ww++) {
      const int v = wc[ww * nbins + d];
      wc[ww * nbins + d] = s;
      s += v;
    }
    dstart[d] = s;
    tot += s;
  }
  int all;
  int ex = block_exclusive_scan<SORT_THREADS>(tot, ws, &all);
  for (int q = 0; q < per; q++) {
    const int d = tid * per + q;
    if (d >= nbins) break;
    const int v = dstart[d];
    dstart[d] = ex;
    goff[d] = offs[((long long)row * nbins + d) * ntiles + tile] - ex;
    ex += v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SORT_KPT; j++) {
    const int p = w * (32 * SORT_KPT) + j * 32 + lane;
    if (p < valid) {
      const int d = (key[j] >> shift) & mask;
      const int slot = dstart[d] + mywc[d] + rk[j];
      tk[slot] = key[j];
      tv[slot] = FIRST ? tile * SORT_TILE + p : vals[base + p];
    }
  }
  __syncthreads();
  for (int i = tid; i < valid; i += SORT_THREADS) {
    const int k = tk[i];
    const long long g = (long long)goff[(k >> shift) & mask] + i;
    okeys[g] = k;
    ovals[g] = tv[i];
  }
}

// A block: row r's chunks k0 .. k0 + T (T <= TAIL_SPAN) of sorted keys.
// sign[(col * R + r) * nb + k] = key[k * 256 + col] & 1, items (col, k) so
// a column's T signs are one run; cum[r, j] = the keys of the row with
// key >> 1 <= j, j = 0..M, written where a key and the next differ there
__global__ void __launch_bounds__(SORT_THREADS)
    k_sort_tail(const int* __restrict__ sk, long long R, int n, int M,
                int* __restrict__ sign, int* __restrict__ cum) {
  __shared__ int ks[TAIL_SPAN * 257];  // chunk t at t * 257: no conflicts
  const int tid = threadIdx.x;
  const int nb = n / 256;
  const int spans = (nb + TAIL_SPAN - 1) / TAIL_SPAN;
  const long long r = blockIdx.x / spans;
  const int k0 = (int)(blockIdx.x - r * spans) * TAIL_SPAN;
  const int T = min(TAIL_SPAN, nb - k0);
  const int* row = sk + r * n;
  for (int i = tid; i < T * 256; i += SORT_THREADS)
    ks[(i >> 8) * 257 + (i & 255)] = row[k0 * 256 + i];
  __syncthreads();
  for (int q = tid; q < T * 256; q += SORT_THREADS) {
    const int col = q / T, t = q - col * T;
    sign[((long long)col * R + r) * nb + k0 + t] = ks[t * 257 + col] & 1;
  }
  int* cr = cum + r * (M + 1);
  for (int i = tid; i < T * 256; i += SORT_THREADS) {
    const int p = k0 * 256 + i;
    const int a = min(max(ks[(i >> 8) * 257 + (i & 255)] >> 1, 0), M + 1);
    if (p == 0)
      for (int j = 0; j < a; j++) cr[j] = 0;
    const int nxt = i + 1 < T * 256 ? ks[((i + 1) >> 8) * 257 + ((i + 1) & 255)]
                    : p + 1 < n ? row[p + 1] : -1;
    const int b = p == n - 1 ? M + 1 : min(max(nxt >> 1, 0), M + 1);
    for (int j = a; j < b; j++) cr[j] = p + 1;
  }
}

// ---- host side --------------------------------------------------------------

static int scatter_smem(int bits) {
  return (int)sizeof(int) * ((SORT_WARPS + 2) * (1 << bits) + 2 * SORT_TILE);
}

template <typename K, bool FIRST>
static cudaError_t run_pass(const K* keys, const int* vals, long long R, int n,
                            int ntiles, int shift, int bits, int* hist,
                            int* part, int* okeys, int* ovals,
                            cudaStream_t st) {
  const unsigned blocks = (unsigned)(R * ntiles);
  const int nbins = 1 << bits;
  k_sort_hist<K><<<blocks, SORT_THREADS, nbins * sizeof(int), st>>>(
      keys, n, ntiles, shift, bits, hist);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long H = R * nbins * (long long)ntiles;
  const int np = (int)((H + SCAN_CHUNK - 1) / SCAN_CHUNK);
  k_sort_scan_reduce<<<np, SORT_THREADS, 0, st>>>(hist, H, part);
  k_sort_scan_partials<<<1, 1024, 0, st>>>(part, np);
  k_sort_scan_down<<<np, SORT_THREADS, 0, st>>>(hist, H, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem = scatter_smem(bits);
  e = cudaFuncSetAttribute(k_sort_scatter<K, FIRST>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  k_sort_scatter<K, FIRST><<<blocks, SORT_THREADS, smem, st>>>(
      keys, vals, n, ntiles, shift, bits, hist, okeys, ovals);
  return cudaGetLastError();
}

extern "C" {

// keys: (R, n) int64, contiguous. Outputs, contiguous: okeys, operm (R, n)
// int32; osign (256, R, n / 256) int32; ocum (R, 2^(c-1) + 1) int32.
// Workspace: tkeys, tvals (R, n) int32 (read only with two passes), hist
// of hist_len words, part of part_len words (ops/msm.sort_plan sizes
// them; too small a workspace is refused).
int rs_digit_sort(const void* keys, long long R, long long n, int c,
                  void* okeys, void* operm, void* osign, void* ocum,
                  void* tkeys, void* tvals, void* hist, long long hist_len,
                  void* part, long long part_len, void* stream) {
  if (R <= 0) return 0;
  if (c < 1 || c > 16 || n < 256 || n % 256 || R * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int bits = c + 1;
  const int npass = (bits + SORT_MAX_BITS - 1) / SORT_MAX_BITS;
  const int b0 = (bits + npass - 1) / npass;
  const int ntiles = (int)((n + SORT_TILE - 1) / SORT_TILE);
  const long long H = R * (1LL << b0) * ntiles;
  if (npass > 2 || hist_len < H ||
      part_len < (H + SCAN_CHUNK - 1) / SCAN_CHUNK ||
      (npass == 2 && (!tkeys || !tvals)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nn = (int)n;
  cudaError_t e;
  if (npass == 1) {
    e = run_pass<long long, true>((const long long*)keys, nullptr, R, nn,
                                  ntiles, 0, bits, (int*)hist, (int*)part,
                                  (int*)okeys, (int*)operm, st);
  } else {
    e = run_pass<long long, true>((const long long*)keys, nullptr, R, nn,
                                  ntiles, 0, b0, (int*)hist, (int*)part,
                                  (int*)tkeys, (int*)tvals, st);
    if (e == cudaSuccess)
      e = run_pass<int, false>((const int*)tkeys, (const int*)tvals, R, nn,
                               ntiles, b0, bits - b0, (int*)hist, (int*)part,
                               (int*)okeys, (int*)operm, st);
  }
  if (e != cudaSuccess) return (int)e;
  const long long spans = (n / 256 + TAIL_SPAN - 1) / TAIL_SPAN;
  k_sort_tail<<<(unsigned)(R * spans), SORT_THREADS, 0, st>>>(
      (const int*)okeys, R, nn, 1 << (c - 1), (int*)osign, (int*)ocum);
  return (int)cudaGetLastError();
}

}  // extern "C"
