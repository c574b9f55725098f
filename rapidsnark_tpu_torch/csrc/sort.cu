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
// What bounds it on the H100: bytes. The least traffic for the function
// is 20 B a key: the int64 key read once (8 B), the sorted key, the
// permutation and the sign written once as int32 (12 B), and M+1 words a
// row of boundaries. A stable LSD radix sort in two passes (c = 10..16)
// cannot reach it: it reads the keys, writes an intermediate and reads it
// back. This design moves 48 B a key at c = 16 (the count reads 8; the
// first pass reads 8 and writes key and index packed, 8; the second
// reads those 8 and writes key and permutation, 8; the tail reads the
// sorted key, 4, and writes the sign, 4) and 32 B with one pass (c <= 9).
// The launches (Onesweep: Adinets & Merrill, 2022, written here by hand):
//   * k_sort_count reads every key once and counts the digits of every
//     pass at once, each warp into its own bins in shared memory (plain
//     shared atomics: counting needs no order); a block writes its
//     counts as one partial histogram of its chunk of COUNT_CHUNK keys.
//     It also zeroes the scatters' status words and tile counters.
//   * k_sort_scan: a block a (row, pass) sums the row's partials and
//     scans them: base[row, digit] = row * n + the keys of the row with
//     a lower digit, the flat output index of the digit's first key.
//   * one scatter a pass (k_sort_scatter_one / _lo / _hi) with decoupled
//     look-back. A block takes its tile of SORT_TILE keys from an atomic
//     counter (so the tile it waits on has always started) and ranks it
//     stably: warp w takes the w-th run of 32 * SORT_KPT keys in rounds
//     of 32; a key's rank is its digit's count in the warp's earlier
//     rounds (a counter a warp and digit in shared memory) plus its
//     lower peers, found by a warp multisplit (one __ballot_sync a digit
//     bit, ANDed or AND-NOTed: no __match_any_sync); the warps' counts
//     are scanned in warp order, so input order is kept across warps.
//     Each digit's count in the tile is published at once as one status
//     word (2-bit flag, 30-bit count: "aggregate"), then a thread a
//     digit walks back over earlier tiles of the row, adding aggregates
//     until it meets an "inclusive" prefix, and publishes its own. The
//     tile is reordered by digit in shared memory and leaves in that
//     order, a digit's keys as one coalesced run (16 keys on average at
//     9 bits, 32 at 8). The first of two passes writes key and index as
//     one 64-bit word; the last writes keys and permutation.
//   * k_sort_tail reads the sorted keys once, a block a row's span of
//     TAIL_SPAN chunks staged in shared memory: it writes each entry's
//     sign into its column slot (sorted position k*256 + col of row r ->
//     sign[col, r, k]), a column's span as one contiguous run, and fills
//     the boundaries: where sorted keys i and i+1 fall in different
//     buckets (key >> 1), i + 1 is written for the buckets in between,
//     and the first and last key write the ends. A run longer than
//     TAIL_RUN buckets (a row of equal keys: M+1 of them) goes to a list
//     that the whole block fills, not one thread; keys in range list
//     fewer than TAIL_GAPS a block, and a run past a full list (keys out
//     of range) is written by its own thread.
// Every row holds exactly n keys, so no row needs a segment of its own.
// Keys are not checked against 2^(c+1) on the card (that needs a host
// sync): a key out of range is sorted by its low c+1 bits and never
// written out of bounds. Workspace (the packed intermediate, tile
// counters, status words, partial histograms, digit bases) comes from
// the caller; nothing is allocated or synchronised here.
#include <cuda_runtime.h>

#define SORT_THREADS 512
#define SORT_WARPS (SORT_THREADS / 32)
#define SORT_KPT 16                               // keys a thread a tile
#define SORT_TILE (SORT_THREADS * SORT_KPT)       // 8192 keys a tile
#define SORT_MAX_BITS 10                          // bits a pass at most
#define COUNT_CHUNK 32768                         // keys a block of k_sort_count
#define CTR_WORDS 32                              // the tile counters' words
#define TAIL_SPAN 32                              // chunks a block of k_sort_tail
#define TAIL_RUN 32                               // boundaries a thread writes
#define TAIL_GAPS 1024                            // longer runs a block lists
#define FULL_MASK 0xffffffffu
#define ST_AGG (1u << 30)                         // the tile's own count
#define ST_INC (2u << 30)                         // the count up to the tile
#define ST_COUNT ((1u << 30) - 1)

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

// ---- the counting pass and the scan of its counts ---------------------------

// block (row, chunk): the digit counts of both passes (nb0 + nb1 = tb
// bins) of keys chunk * COUNT_CHUNK .. of the row -> partial[row, chunk];
// every block also zeroes its share of zero[0 .. nzero)
__global__ void __launch_bounds__(SORT_THREADS)
    k_sort_count(const long long* __restrict__ keys, int n, int chunks,
                 int b0, int b1, int* __restrict__ partial,
                 int* __restrict__ zero, long long nzero) {
  extern __shared__ int wh[];  // SORT_WARPS x tb counters
  const int nb0 = 1 << b0, tb = nb0 + (b1 ? 1 << b1 : 0);
  const int m0 = nb0 - 1, m1 = (1 << b1) - 1;
  const int tid = threadIdx.x;
  for (long long i = (long long)blockIdx.x * SORT_THREADS + tid; i < nzero;
       i += (long long)gridDim.x * SORT_THREADS)
    zero[i] = 0;
  for (int i = tid; i < SORT_WARPS * tb; i += SORT_THREADS) wh[i] = 0;
  __syncthreads();
  const int row = blockIdx.x / chunks, ch = blockIdx.x - row * chunks;
  const long long* kr = keys + (long long)row * n;
  const int lo = ch * COUNT_CHUNK, hi = min(n, lo + COUNT_CHUNK);
  int* mine = wh + (tid >> 5) * tb;
#pragma unroll 4
  for (int i = lo + tid; i < hi; i += SORT_THREADS) {
    const int k = (int)kr[i];
    atomicAdd(&mine[k & m0], 1);
    if (b1) atomicAdd(&mine[nb0 + ((k >> b0) & m1)], 1);
  }
  __syncthreads();
  int* out = partial + (long long)blockIdx.x * tb;
  for (int d = tid; d < tb; d += SORT_THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < SORT_WARPS; w++) s += wh[w * tb + d];
    out[d] = s;
  }
}

// block (row, pass): base[row, off + d] = row * n + the row's keys whose
// digit of the pass is below d (off: the pass's first bin)
__global__ void __launch_bounds__(1024)
    k_sort_scan(const int* __restrict__ partial, int n, int chunks, int tb,
                int nb0, int npass, int* __restrict__ base) {
  __shared__ int ws[32];
  const int row = blockIdx.x / npass, p = blockIdx.x - row * npass;
  const int off = p ? nb0 : 0, nbins = p ? tb - nb0 : nb0;
  const int d = threadIdx.x;
  int s = 0;
  if (d < nbins) {
    const int* pr = partial + (long long)row * chunks * tb + off + d;
    for (int ch = 0; ch < chunks; ch++) s += pr[(long long)ch * tb];
  }
  int tot;
  const int ex = block_exclusive_scan<1024>(s, ws, &tot);
  if (d < nbins) base[(long long)row * tb + off + d] = row * n + ex;
}

// ---- one scatter pass with decoupled look-back ------------------------------

// FIRST: the input is the caller's int64 keys and a key's value its index
// in the row (made here); else the previous pass's packed words (key low,
// value high). LAST: write keys and values as two int32 arrays; else one
// packed word a key. ctr: the pass's tile counter; status: (R x ntiles)
// x nbins words; base: the pass's digit bases of row 0 (rows tb apart)
template <bool FIRST, bool LAST>
__device__ __forceinline__ void sort_scatter(
    const void* __restrict__ in, int n, int ntiles, int shift, int bits,
    const int* __restrict__ base, int tb, int* __restrict__ ctr,
    unsigned* __restrict__ status, long long* __restrict__ omid,
    int* __restrict__ okeys, int* __restrict__ ovals) {
  extern __shared__ long long smem_ll[];
  const int nbins = 1 << bits, mask = nbins - 1;
  long long* tbuf = smem_ll;                  // SORT_TILE: the tile, by digit
  int* wc = (int*)(tbuf + SORT_TILE);         // SORT_WARPS x nbins
  int* dstart = wc + SORT_WARPS * nbins;      // a digit's first slot
  int* goff = dstart + nbins;                 // its output index, less dstart
  __shared__ int ws[SORT_WARPS];
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ctr, 1);
  for (int i = tid; i < SORT_WARPS * nbins; i += SORT_THREADS) wc[i] = 0;
  __syncthreads();
  const int t = s_tile;                       // row * ntiles + tile
  const int row = t / ntiles, tile = t - row * ntiles;
  const long long rbase = (long long)row * n;
  const long long ibase = rbase + (long long)tile * SORT_TILE;
  const int valid = min(SORT_TILE, n - tile * SORT_TILE);
  // load the warp's run, then rank each key among the earlier keys of
  // its digit in the run; ranks < 2^13, two to a register
  int key[SORT_KPT], val[FIRST ? 1 : SORT_KPT];
  unsigned rk[SORT_KPT / 2];
#pragma unroll
  for (int j = 0; j < SORT_KPT; j++) {
    const int p = w * (32 * SORT_KPT) + j * 32 + lane;
    if (FIRST) {
      key[j] = p < valid ? (int)((const long long*)in)[ibase + p] : 0;
    } else {
      const long long x =
          p < valid ? ((const long long*)in)[ibase + p] : 0LL;
      key[j] = (int)x;
      val[j] = (int)(x >> 32);
    }
  }
  int* mywc = wc + w * nbins;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < SORT_KPT; j++) {
    const int p = w * (32 * SORT_KPT) + j * 32 + lane;
    const bool ok = p < valid;
    const int d = (key[j] >> shift) & mask;
    unsigned peers = __ballot_sync(FULL_MASK, ok);
    for (int b = 0; b < bits; b++) {
      const bool set = (d >> b) & 1;
      const unsigned x = __ballot_sync(FULL_MASK, set);
      peers &= set ? x : ~x;
    }
    const int cnt = ok ? mywc[d] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) mywc[d] = cnt + __popc(peers);
    __syncwarp();
    const unsigned r = (unsigned)(cnt + __popc(peers & lower));
    if (j & 1)
      rk[j >> 1] |= r << 16;
    else
      rk[j >> 1] = r;
  }
  __syncthreads();
  // a thread's digits d0 .. d0 + per: the warps' counts -> exclusive
  // offsets in warp order, the tile's count published as an aggregate
  // (tile 0 of a row: as its inclusive prefix)
  const int per = (nbins + SORT_THREADS - 1) / SORT_THREADS;
  const int d0 = tid * per;
  int cnt[2] = {0, 0}, tot = 0;
  volatile unsigned* st = status + (long long)t * nbins;
#pragma unroll
  for (int q = 0; q < 2; q++) {
    const int d = d0 + q;
    if (q >= per || d >= nbins) break;
    int s = 0;
#pragma unroll
    for (int ww = 0; ww < SORT_WARPS; ww++) {
      const int v = wc[ww * nbins + d];
      wc[ww * nbins + d] = s;
      s += v;
    }
    cnt[q] = s;
    tot += s;
    st[d] = (tile ? ST_AGG : ST_INC) | (unsigned)s;
  }
  int all;
  int ex = block_exclusive_scan<SORT_THREADS>(tot, ws, &all);
#pragma unroll
  for (int q = 0; q < 2; q++) {
    const int d = d0 + q;
    if (q >= per || d >= nbins) break;
    dstart[d] = ex;
    ex += cnt[q];
  }
  __syncthreads();
  // the tile into shared memory, ordered by digit
#pragma unroll
  for (int j = 0; j < SORT_KPT; j++) {
    const int p = w * (32 * SORT_KPT) + j * 32 + lane;
    if (p < valid) {
      const int d = (key[j] >> shift) & mask;
      const int slot =
          dstart[d] + mywc[d] + (int)((rk[j >> 1] >> (16 * (j & 1))) & 0xffff);
      const int v = FIRST ? tile * SORT_TILE + p : val[j];
      if (LAST) {
        ((int*)tbuf)[slot] = key[j];
        ((int*)tbuf)[SORT_TILE + slot] = v;
      } else {
        tbuf[slot] = (long long)(unsigned)key[j] |
                     ((long long)(unsigned)v << 32);
      }
    }
  }
  // look back: the digit's keys in the row's earlier tiles
#pragma unroll
  for (int q = 0; q < 2; q++) {
    const int d = d0 + q;
    if (q >= per || d >= nbins) break;
    unsigned prefix = 0;
    if (tile) {
      for (long long pt = t - 1;; pt--) {
        const volatile unsigned* ps = status + pt * nbins + d;
        unsigned s;
        do {
          s = *ps;
        } while (!(s & (ST_AGG | ST_INC)));
        prefix += s & ST_COUNT;
        if (s & ST_INC) break;
      }
      st[d] = ST_INC | (prefix + (unsigned)cnt[q]);
    }
    goff[d] = base[(long long)row * tb + d] + (int)prefix - dstart[d];
  }
  __syncthreads();
  for (int i = tid; i < valid; i += SORT_THREADS) {
    if (LAST) {
      const int k = ((const int*)tbuf)[i];
      const long long g = (long long)goff[(k >> shift) & mask] + i;
      okeys[g] = k;
      ovals[g] = ((const int*)tbuf)[SORT_TILE + i];
    } else {
      const long long x = tbuf[i];
      const long long g = (long long)goff[((int)x >> shift) & mask] + i;
      omid[g] = x;
    }
  }
}

// one pass (c <= 9): int64 keys in, keys and permutation out
__global__ void __launch_bounds__(SORT_THREADS, 2)
    k_sort_scatter_one(const long long* __restrict__ keys, int n, int ntiles,
                       int bits, const int* __restrict__ base, int tb,
                       int* __restrict__ ctr, unsigned* __restrict__ status,
                       int* __restrict__ okeys, int* __restrict__ operm) {
  sort_scatter<true, true>(keys, n, ntiles, 0, bits, base, tb, ctr, status,
                           nullptr, okeys, operm);
}

// the first of two passes: int64 keys in, packed (key, index) words out
__global__ void __launch_bounds__(SORT_THREADS, 2)
    k_sort_scatter_lo(const long long* __restrict__ keys, int n, int ntiles,
                      int bits, const int* __restrict__ base, int tb,
                      int* __restrict__ ctr, unsigned* __restrict__ status,
                      long long* __restrict__ mid) {
  sort_scatter<true, false>(keys, n, ntiles, 0, bits, base, tb, ctr, status,
                            mid, nullptr, nullptr);
}

// the second pass: packed words in, keys and permutation out
__global__ void __launch_bounds__(SORT_THREADS, 2)
    k_sort_scatter_hi(const long long* __restrict__ mid, int n, int ntiles,
                      int shift, int bits, const int* __restrict__ base,
                      int tb, int* __restrict__ ctr,
                      unsigned* __restrict__ status, int* __restrict__ okeys,
                      int* __restrict__ operm) {
  sort_scatter<false, true>(mid, n, ntiles, shift, bits, base, tb, ctr,
                            status, nullptr, okeys, operm);
}

// ---- the tail: signs and boundaries -----------------------------------------

// A block: row r's chunks k0 .. k0 + T (T <= TAIL_SPAN) of sorted keys.
// sign[(col * R + r) * nb + k] = key[k * 256 + col] & 1, items (col, k) so
// a column's T signs are one run; cum[r, j] = the keys of the row with
// key >> 1 <= j, j = 0..M, written where a key and the next differ there.
// With keys in range a row's runs of boundaries are disjoint and cover
// 0..M, so a block lists at most (M + 1) / (TAIL_RUN + 1) < TAIL_GAPS long
// ones; keys out of range can list more, and a run past the full list is
// written by the thread that found it
__global__ void __launch_bounds__(256)
    k_sort_tail(const int* __restrict__ sk, long long R, int n, int M,
                int* __restrict__ sign, int* __restrict__ cum) {
  __shared__ int ks[TAIL_SPAN * 257];  // chunk t at t * 257: no conflicts
  __shared__ int3 gaps[TAIL_GAPS];     // (first, end, value) of long runs
  __shared__ int ngaps;
  const int tid = threadIdx.x;
  const int nb = n / 256;
  const int spans = (nb + TAIL_SPAN - 1) / TAIL_SPAN;
  const long long r = blockIdx.x / spans;
  const int k0 = (int)(blockIdx.x - r * spans) * TAIL_SPAN;
  const int T = min(TAIL_SPAN, nb - k0);
  const int* row = sk + r * n;
  if (tid == 0) ngaps = 0;
  for (int i = tid; i < T * 256; i += 256)
    ks[(i >> 8) * 257 + (i & 255)] = row[k0 * 256 + i];
  __syncthreads();
  for (int q = tid; q < T * 256; q += 256) {
    const int col = q / T, t = q - col * T;
    sign[((long long)col * R + r) * nb + k0 + t] = ks[t * 257 + col] & 1;
  }
  int* cr = cum + r * (M + 1);
  for (int i = tid; i < T * 256; i += 256) {
    const int p = k0 * 256 + i;
    const int a = min(max(ks[(i >> 8) * 257 + (i & 255)] >> 1, 0), M + 1);
    const int nxt = i + 1 < T * 256 ? ks[((i + 1) >> 8) * 257 + ((i + 1) & 255)]
                    : p + 1 < n ? row[p + 1] : -1;
    const int b = p == n - 1 ? M + 1 : min(max(nxt >> 1, 0), M + 1);
    // the runs [0, a) of the first key and [a, b) of key p
    for (int e = p == 0 ? 0 : 1; e < 2; e++) {
      const int lo = e ? a : 0, hi = e ? b : a, v = e ? p + 1 : 0;
      if (hi - lo <= TAIL_RUN) {
        for (int j = lo; j < hi; j++) cr[j] = v;
      } else {
        const int g = atomicAdd(&ngaps, 1);
        if (g < TAIL_GAPS) {
          gaps[g] = make_int3(lo, hi, v);
        } else {  // the list is full (keys out of range): write it here
          for (int j = lo; j < hi; j++) cr[j] = v;
        }
      }
    }
  }
  __syncthreads();
  for (int g = 0; g < min(ngaps, TAIL_GAPS); g++) {
    const int3 e = gaps[g];
    for (int j = e.x + tid; j < e.y; j += 256) cr[j] = e.z;
  }
}

// ---- host side --------------------------------------------------------------

static int count_smem(int tb) { return (int)sizeof(int) * SORT_WARPS * tb; }

static int scatter_smem(int bits) {
  return (int)(sizeof(long long) * SORT_TILE +
               sizeof(int) * (SORT_WARPS + 2) * (1 << bits));
}

// the kernels' shared memory above 48 KB, allowed once a process and card
static cudaError_t allow_smem() {
  static unsigned done = 0;  // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && ((done >> dev) & 1)) return cudaSuccess;
  const int most = scatter_smem(SORT_MAX_BITS);
  const void* fns[] = {(const void*)k_sort_scatter_one,
                       (const void*)k_sort_scatter_lo,
                       (const void*)k_sort_scatter_hi};
  for (const void* f : fns) {
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
    if (e != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute((const void*)k_sort_count,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           count_smem(1 << SORT_MAX_BITS));
  if (e != cudaSuccess) return e;
  if (dev < 32) done |= 1u << dev;
  return cudaSuccess;
}

extern "C" {

// keys: (R, n) int64, contiguous. Outputs, contiguous: okeys, operm (R, n)
// int32; osign (256, R, n / 256) int32; ocum (R, 2^(c-1) + 1) int32.
// Workspace: mid (R, n) int64, read only with two passes; ws of ws_len
// int32 words: the tile counters (CTR_WORDS), the status words of each
// pass ((R x tiles) x 2^bits), the partial histograms (R x chunks x tb)
// and the digit bases (R x tb), tb the passes' bins together
// (ops/msm.sort_plan sizes them; too small a workspace is refused).
int rs_digit_sort(const void* keys, long long R, long long n, int c,
                  void* okeys, void* operm, void* osign, void* ocum,
                  void* mid, void* ws, long long ws_len, void* stream) {
  if (R <= 0) return 0;
  if (c < 1 || c > 16 || n < 256 || n % 256 || n > ST_COUNT ||
      R * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int bits = c + 1;
  const int npass = (bits + SORT_MAX_BITS - 1) / SORT_MAX_BITS;
  const int b0 = (bits + npass - 1) / npass, b1 = bits - b0;
  const int nb0 = 1 << b0, tb = nb0 + (npass > 1 ? 1 << b1 : 0);
  const int nn = (int)n;
  const int ntiles = (nn + SORT_TILE - 1) / SORT_TILE;
  const int chunks = (nn + COUNT_CHUNK - 1) / COUNT_CHUNK;
  const long long tiles = R * ntiles;
  const long long nstatus = tiles * tb;
  const long long need = CTR_WORDS + nstatus + R * chunks * tb + R * tb;
  if (npass > 2 || ws_len < need || (npass == 2 && !mid))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  int* ctr = (int*)ws;
  unsigned* status = (unsigned*)(ctr + CTR_WORDS);
  int* partial = (int*)(status + nstatus);
  int* base = partial + R * chunks * tb;
  k_sort_count<<<(unsigned)(R * chunks), SORT_THREADS, count_smem(tb), st>>>(
      (const long long*)keys, nn, chunks, b0, npass > 1 ? b1 : 0, partial,
      ctr, CTR_WORDS + nstatus);
  k_sort_scan<<<(unsigned)(R * npass), 1024, 0, st>>>(partial, nn, chunks, tb,
                                                      nb0, npass, base);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (npass == 1) {
    k_sort_scatter_one<<<(unsigned)tiles, SORT_THREADS, scatter_smem(b0),
                         st>>>((const long long*)keys, nn, ntiles, b0, base,
                               tb, ctr, status, (int*)okeys, (int*)operm);
  } else {
    k_sort_scatter_lo<<<(unsigned)tiles, SORT_THREADS, scatter_smem(b0),
                        st>>>((const long long*)keys, nn, ntiles, b0, base,
                              tb, ctr, status, (long long*)mid);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    k_sort_scatter_hi<<<(unsigned)tiles, SORT_THREADS, scatter_smem(b1),
                        st>>>((const long long*)mid, nn, ntiles, b0, b1,
                              base + nb0, tb, ctr + 1, status + tiles * nb0,
                              (int*)okeys, (int*)operm);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long spans = (n / 256 + TAIL_SPAN - 1) / TAIL_SPAN;
  k_sort_tail<<<(unsigned)(R * spans), 256, 0, st>>>(
      (const int*)okeys, R, nn, 1 << (c - 1), (int*)osign, (int*)ocum);
  return (int)cudaGetLastError();
}

}  // extern "C"
