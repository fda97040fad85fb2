// compact_runs: sorted int64 keys (+ optional counts) -> the unique
// non-sentinel keys in order, their run sums, and the unique count.
//
// Replaces the Pallas kernel rufus_tpu/ops/pallas_fold.py:compact_sorted_hilo
// together with the head detection and prefix-coded run sums around it in
// rufus_tpu/parallel/sharded.py:_rle_compact_hilo. The TPU kernel sorted
// each block in VMEM and chained a carry row between sequential grid
// steps; blocks here run in parallel, so the compaction is scan-then-
// scatter instead:
//
//   1. stats:   per tile of 2048 elements, the number of run heads and the
//               sum of counts (coalesced, one pass over the keys);
//   2. scan:    one block turns the per-tile figures into exclusive offsets
//               and writes the totals (unique count, count sum);
//   3. scatter: each tile re-derives its heads, ranks them with a block
//               scan in element order, and writes key and exclusive count
//               prefix to slot offset + rank;
//   4. diff:    run sum = next head's prefix - this head's prefix (the last
//               run ends at the total).
//
// A head is an element whose key differs from its predecessor's and is not
// the INT64_MAX sentinel. Counts: kind 0 = none (each key counts 1, the raw
// windows of the count step), 1 = int32, 2 = int64. Sentinels count 0.
//
// Bound: bytes. Steps 1 and 3 each read the keys (and counts); step 3
// writes 16 bytes per unique key. The host reads the unique count between
// steps 2 and 3 to size the output exactly.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

__device__ __forceinline__ long long load_count(const void* counts, int kind,
                                                long long i) {
  if (kind == 1) return (long long)((const int*)counts)[i];
  if (kind == 2) return ((const long long*)counts)[i];
  return 1;
}

// Block-wide exclusive scan of the pair (h, s) in thread order; also gives
// the block totals. Every thread of the block must call it.
__device__ void block_scan(long long& h, long long& s, long long& total_h,
                           long long& total_s) {
  __shared__ long long wh[32], ws[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long ih = h, is = s;
  for (int o = 1; o < 32; o <<= 1) {
    const long long th = __shfl_up_sync(0xffffffffu, ih, o);
    const long long ts = __shfl_up_sync(0xffffffffu, is, o);
    if (lane >= o) {
      ih += th;
      is += ts;
    }
  }
  if (lane == 31) {
    wh[warp] = ih;
    ws[warp] = is;
  }
  __syncthreads();
  if (warp == 0) {
    long long vh = lane < nw ? wh[lane] : 0, vs = lane < nw ? ws[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long th = __shfl_up_sync(0xffffffffu, vh, o);
      const long long ts = __shfl_up_sync(0xffffffffu, vs, o);
      if (lane >= o) {
        vh += th;
        vs += ts;
      }
    }
    if (lane < nw) {
      wh[lane] = vh;
      ws[lane] = vs;
    }
  }
  __syncthreads();
  total_h = wh[nw - 1];
  total_s = ws[nw - 1];
  const long long bh = warp ? wh[warp - 1] : 0, bs = warp ? ws[warp - 1] : 0;
  h = bh + ih - h;
  s = bs + is - s;
  __syncthreads();  // wh/ws are reused by the next call
}

// (is_head, count) of element i.
__device__ __forceinline__ void element(const long long* __restrict__ keys,
                                        const void* counts, int kind,
                                        long long n, long long i,
                                        long long& key, long long& h,
                                        long long& s) {
  key = RT_SENTINEL;
  h = 0;
  s = 0;
  if (i < n) {
    key = keys[i];
    if (key != RT_SENTINEL) {
      s = load_count(counts, kind, i);
      h = (i == 0 || keys[i - 1] != key) ? 1 : 0;
    }
  }
}

__global__ void stats_kernel(const long long* __restrict__ keys,
                             const void* counts, int kind, long long n,
                             long long* block_heads, long long* block_sums) {
  const long long base = (long long)blockIdx.x * kTile;
  long long h = 0, s = 0;
  for (int j = 0; j < kItems; ++j) {
    long long key, eh, es;
    element(keys, counts, kind, n, base + (long long)j * kThreads + threadIdx.x,
            key, eh, es);
    h += eh;
    s += es;
  }
  long long th, ts;
  block_scan(h, s, th, ts);
  if (threadIdx.x == 0) {
    block_heads[blockIdx.x] = th;
    block_sums[blockIdx.x] = ts;
  }
}

__global__ void scan_kernel(long long* heads, long long* sums, long long nb,
                            long long* totals) {
  const long long per = (nb + blockDim.x - 1) / blockDim.x;
  const long long lo = min(nb, (long long)threadIdx.x * per);
  const long long hi = min(nb, lo + per);
  long long h = 0, s = 0;
  for (long long b = lo; b < hi; ++b) {
    h += heads[b];
    s += sums[b];
  }
  long long th, ts;
  block_scan(h, s, th, ts);
  for (long long b = lo; b < hi; ++b) {
    const long long vh = heads[b], vs = sums[b];
    heads[b] = h;
    sums[b] = s;
    h += vh;
    s += vs;
  }
  if (threadIdx.x == 0) {
    totals[0] = th;
    totals[1] = ts;
  }
}

__global__ void scatter_kernel(const long long* __restrict__ keys,
                               const void* counts, int kind, long long n,
                               const long long* __restrict__ head_off,
                               const long long* __restrict__ sum_off,
                               long long* __restrict__ out_keys,
                               long long* __restrict__ out_pref) {
  const long long base = (long long)blockIdx.x * kTile;
  long long run_h = head_off[blockIdx.x], run_s = sum_off[blockIdx.x];
  for (int j = 0; j < kItems; ++j) {
    long long key, h, s;
    element(keys, counts, kind, n, base + (long long)j * kThreads + threadIdx.x,
            key, h, s);
    long long eh = h, es = s, th, ts;
    block_scan(eh, es, th, ts);
    if (h) {
      out_keys[run_h + eh] = key;
      out_pref[run_h + eh] = run_s + es;
    }
    run_h += th;
    run_s += ts;
  }
}

__global__ void diff_kernel(const long long* __restrict__ pref, long long m,
                            const long long* __restrict__ totals,
                            long long* __restrict__ sums) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < m) sums[r] = (r + 1 < m ? pref[r + 1] : totals[1]) - pref[r];
}

}  // namespace

// Steps 1-2. block_heads/block_sums: ceil(n / 2048) scratch slots each;
// totals[0] = unique keys, totals[1] = count sum.
extern "C" int rt_compact_stats(const long long* keys, const void* counts,
                                int kind, long long n, long long* block_heads,
                                long long* block_sums, long long* totals,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nb = (n + kTile - 1) / kTile;
  if (nb == 0) {
    cudaMemsetAsync(totals, 0, 2 * sizeof(long long), st);
  } else {
    stats_kernel<<<(unsigned)nb, kThreads, 0, st>>>(keys, counts, kind, n,
                                                    block_heads, block_sums);
    scan_kernel<<<1, 1024, 0, st>>>(block_heads, block_sums, nb, totals);
  }
  return (int)cudaGetLastError();
}

// Steps 3-4, after the host has read m = totals[0]. out_keys, out_sums and
// the scratch pref each hold m slots.
extern "C" int rt_compact_scatter(const long long* keys, const void* counts,
                                  int kind, long long n,
                                  const long long* block_heads,
                                  const long long* block_sums,
                                  const long long* totals, long long m,
                                  long long* out_keys, long long* pref,
                                  long long* out_sums, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nb = (n + kTile - 1) / kTile;
  if (m > 0) {
    scatter_kernel<<<(unsigned)nb, kThreads, 0, st>>>(
        keys, counts, kind, n, block_heads, block_sums, out_keys, pref);
    diff_kernel<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(pref, m, totals,
                                                             out_sums);
  }
  return (int)cudaGetLastError();
}
