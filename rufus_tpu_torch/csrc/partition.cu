// partition: MSD radix partition of int64 k-mer keys into 16 buckets, by
// their first two bases.
//
// Replaces the Pallas kernel tools/radixbench.py:partition (pallas_call at
// line 159): per 8192-key block, a bitonic sort in fast memory, then one
// copy of each bucket's run to that bucket's region at a running cursor.
// The TPU kernel copied row-aligned runs, boundary rows duplicated, because
// it had no scatter; its traffic was an upper bound on the exact kernel's.
// Here every key is written once, to its exact slot.
//
// Layout of out: bucket b holds out[offsets[b] : offsets[b + 1]]; inside
// it the blocks' runs follow in block order, each run ascending. A key's
// bucket is clamp(key >> shift, 0, 15) with shift = 2k - 4, so the
// INT64_MAX sentinel closes bucket 15. The clamp is monotone, so a sorted
// block holds each bucket as one contiguous run.
//
// Bound: bytes (8n read, 8n written). The run metadata reads the keys once
// more (8n), so the whole call moves 24n.
//
// What held the first design back, at 25,993,216 keys on the H100,
// 4.34 ms a call for a 0.124 ms bound: its metadata, torch.bincount onto
// 16 bins a block after a clamp, a shift and an arange // 8192 (several
// passes over the keys, 2.5 ms), cost more than the kernel (1.84 ms); and
// the kernel's block sort ran 91 bitonic stages over 8192 keys in shared
// memory, a barrier after each, with 1024 threads and 64 KB a block (2
// blocks an SM, 12 waves).
//
// This design:
//
//   count    (count_kernel) A block takes a run of `per_group` consecutive
//            8192-key blocks; a thread reads 16 keys of each with 16-byte
//            loads and counts them in registers, 8 bits a bucket; a warp
//            sums its counts with __reduce_add_sync. It writes each block's
//            16 run lengths, their exclusive scan over the blocks of its
//            run (as cursors), and the run's totals.
//   cursors  (cursor_kernel) One block a run scans the runs' totals, bucket
//            by bucket, and adds to its blocks' cursors the keys of earlier
//            buckets and of earlier runs of the same bucket; block 0 writes
//            the offsets. No chain between blocks, no library call.
//   sort     (partition_kernel) 512 threads a block, 16 keys a thread.
//            A thread sorts its 16 in registers (a bitonic network); then 9
//            levels merge sorted runs pairwise in shared memory, 16 keys to
//            8192: thread t makes positions 16t .. 16t+15 of its merged
//            pair from the merge path's split at position 16t (a binary
//            search along the diagonal, Green, McColl and Bader, ICS 2012)
//            and a serial merge of 16. The 5 levels whose pairs lie in one
//            warp wait on __syncwarp: 9 block barriers instead of 91. 68 KB
//            of shared memory and at most 64 registers a thread, 2 blocks
//            an SM.
//   scatter  The sorted block goes out through shared memory in the
//            transposed order, so neighbouring threads write neighbouring
//            slots of a run: key i of bucket b to cursors[b] + i - start[b],
//            start[b] being the block's keys of lower buckets.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBlock = 8192;
constexpr int kThreads = 512;
constexpr int kItems = kBlock / kThreads;  // 16
constexpr int kWarps = kThreads / 32;
constexpr int kBuckets = 16;
constexpr int kGroupsPerSm = 2;      // count_kernel's runs of blocks
constexpr int kSortBlocksPerSm = 2;  // registers: 64 a thread
constexpr int kCursorThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int bucket_of(long long key, int shift) {
  if (key < 0) return 0;
  const long long b = key >> shift;
  return b < kBuckets - 1 ? (int)b : kBuckets - 1;
}

// x[0..15] = 16 keys of block `blk`, pair v of thread t from pair t + 512v
// of the block (neighbouring threads on neighbouring addresses); positions
// past n read as the sentinel.
__device__ __forceinline__ void load_block(const long long* __restrict__ keys,
                                           long long n, long long blk, int vec,
                                           long long (&x)[kItems]) {
  const long long base = blk * kBlock;
  const long long* src = keys + base;
  const bool full = base + kBlock <= n;
#pragma unroll
  for (int v = 0; v < kItems / 2; ++v) {
    const int i = 2 * (threadIdx.x + kThreads * v);
    if (full && vec) {
      const longlong2 p = *(const longlong2*)(src + i);
      x[2 * v] = p.x;
      x[2 * v + 1] = p.y;
    } else {
      x[2 * v] = base + i < n ? src[i] : RT_SENTINEL;
      x[2 * v + 1] = base + i + 1 < n ? src[i + 1] : RT_SENTINEL;
    }
  }
}

// --- the run metadata ----------------------------------------------------

// Blocks [g * per_group, min(nblk, (g + 1) * per_group)) for CUDA block g:
// runlen[j][b] and cursors[j][b] (the exclusive scan of runlen[.][b] over
// the run's blocks before j), and totals[g][b].
__global__ void __launch_bounds__(kThreads)
count_kernel(const long long* __restrict__ keys, long long n, int shift,
             long long nblk, long long per_group, int vec,
             long long* __restrict__ runlen, long long* __restrict__ cursors,
             long long* __restrict__ totals) {
  __shared__ unsigned s_w[2][kWarps][kBuckets / 2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long j0 = blockIdx.x * per_group;
  const long long j1 = min(nblk, j0 + per_group);
  long long run = 0;  // thread b < 16: bucket b's keys in the run so far
  for (long long j = j0; j < j1; ++j) {
    long long x[kItems];
    load_block(keys, n, j, vec, x);
    // 8 bits a bucket: buckets 0-7 in c[0], 8-15 in c[1]
    unsigned long long c[2] = {0ull, 0ull};
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (j * kBlock + 2 * (threadIdx.x + kThreads * (u / 2)) + (u & 1) >= n)
        continue;  // padding
      const int b = bucket_of(x[u], shift);
      const unsigned long long inc = 1ull << (8 * (b & 7));
      c[0] += b < 8 ? inc : 0ull;
      c[1] += b < 8 ? 0ull : inc;
    }
    // 16 bits a bucket, two buckets a word, summed over the warp
    const int par = (int)(j & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned half = (unsigned)(c[h] >> (32 * (q >> 1)));
        const unsigned w = __byte_perm(half, 0u, (q & 1) ? 0x4342 : 0x4140);
        const unsigned sum = __reduce_add_sync(kFull, w);
        if (lane == 0) s_w[par][warp][4 * h + q] = sum;
      }
    }
    __syncthreads();
    if (threadIdx.x < kBuckets) {
      const int b = threadIdx.x;
      long long cnt = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        cnt += (s_w[par][w][b >> 1] >> (16 * (b & 1))) & 0xFFFFu;
      runlen[j * kBuckets + b] = cnt;
      cursors[j * kBuckets + b] = run;
      run += cnt;
    }
  }
  if (threadIdx.x < kBuckets && j0 < j1)
    totals[blockIdx.x * kBuckets + threadIdx.x] = run;
}

// CUDA block g adds to the cursors of its run of blocks the keys that go
// before the run in each bucket's region: those of lower buckets and those
// of the same bucket in earlier runs. Block 0 writes offsets[0..16].
__global__ void __launch_bounds__(kCursorThreads)
cursor_kernel(const long long* __restrict__ totals, int groups,
              long long nblk, long long per_group,
              long long* __restrict__ cursors,
              long long* __restrict__ offsets) {
  __shared__ long long s_before[kCursorThreads], s_all[kCursorThreads];
  __shared__ long long s_base[kBuckets];
  const int g = blockIdx.x;
  const int b = threadIdx.x & (kBuckets - 1), c = threadIdx.x / kBuckets;
  constexpr int kChunks = kCursorThreads / kBuckets;
  long long before = 0, all = 0;
  for (int h = c; h < groups; h += kChunks) {
    const long long v = totals[h * kBuckets + b];
    all += v;
    before += h < g ? v : 0;
  }
  s_before[threadIdx.x] = before;
  s_all[threadIdx.x] = all;
  __syncthreads();
  if (threadIdx.x < kBuckets) {
    long long bf = 0, al = 0;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      bf += s_before[i * kBuckets + b];
      al += s_all[i * kBuckets + b];
    }
    // exclusive scan of the bucket totals over the 16 lanes
    long long incl = al;
#pragma unroll
    for (int o = 1; o < kBuckets; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffu, incl, o, kBuckets);
      if (b >= o) incl += y;
    }
    s_base[b] = incl - al + bf;
    if (g == 0) {
      offsets[b] = incl - al;
      if (b == kBuckets - 1) offsets[kBuckets] = incl;
    }
  }
  __syncthreads();
  const long long j0 = g * per_group;
  const long long rows = min(nblk, j0 + per_group) - j0;
  for (long long i = threadIdx.x; i < rows * kBuckets; i += kCursorThreads)
    cursors[j0 * kBuckets + i] += s_base[i & (kBuckets - 1)];
}

// --- the block sort --------------------------------------------------------

// Slot of position i in the shared block: a spare slot after every 16, so
// that 16 threads on 8-byte keys 16t + u, and 16 neighbouring positions,
// meet distinct banks.
__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }
constexpr int kSlots = kBlock + kBlock / 16;

// Positions j and j + S of x ascending where ((base + j) & size) == 0,
// else descending, for all j with bit S clear: one stage of a bitonic
// network in registers.
template <int S>
__device__ __forceinline__ void thread_stage(long long (&x)[kItems], int size,
                                             int base) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j & S) continue;
    const bool up = ((base + j) & size) == 0;
    const long long a = x[j], b = x[j + S];
    const bool swap = up ? a > b : a < b;
    x[j] = swap ? b : a;
    x[j + S] = swap ? a : b;
  }
}

__global__ void __launch_bounds__(kThreads, kSortBlocksPerSm)
partition_kernel(const long long* __restrict__ keys, long long n, int shift,
                 int vec, const long long* __restrict__ runlen,
                 const long long* __restrict__ cursors,
                 long long* __restrict__ out) {
  extern __shared__ __align__(16) long long s[];
  __shared__ long long s_delta[kBuckets];
  const int t = threadIdx.x;
  const long long blk = blockIdx.x;
  long long x[kItems];
  load_block(keys, n, blk, vec, x);
  if (t < kBuckets) {
    long long start = 0;
    for (int b = 0; b < t; ++b) start += runlen[blk * kBuckets + b];
    s_delta[t] = cursors[blk * kBuckets + t] - start;
  }

  // a thread's 16 keys ascending: a bitonic network in registers
#pragma unroll
  for (int size = 2; size <= kItems; size <<= 1) {
    if (size >= 16) thread_stage<8>(x, size, 0);
    if (size >= 8) thread_stage<4>(x, size, 0);
    if (size >= 4) thread_stage<2>(x, size, 0);
    thread_stage<1>(x, size, 0);
  }

  // merge sorted runs pairwise, 16 keys to 8192: thread t makes positions
  // 16t .. 16t+15 of the merged pair, from the merge path's split of its
  // first position (a binary search along the diagonal). Keys carry no
  // payload, so an exhausted run reads as INT64_MAX: a tie with a real
  // sentinel outputs the same value.
  const int d0 = kItems * t;
  for (int run = kItems; run < kBlock; run <<= 1) {
    // a pair of runs up to 512 keys lies in one warp's threads
    const bool warp_pair = 2 * run <= 32 * kItems;
#pragma unroll
    for (int u = 0; u < kItems; ++u) s[slot(d0 + u)] = x[u];
    if (warp_pair)
      __syncwarp();
    else
      __syncthreads();
    const int a0 = d0 & ~(2 * run - 1), b0 = a0 + run, d = d0 - a0;
    int lo = max(0, d - run), hi = min(d, run);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s[slot(a0 + mid)] <= s[slot(b0 + d - 1 - mid)])
        lo = mid + 1;
      else
        hi = mid;
    }
    int ia = a0 + lo, ib = b0 + d - lo;
    const int ae = b0, be = b0 + run;
    long long av = ia < ae ? s[slot(ia)] : RT_SENTINEL;
    long long bv = ib < be ? s[slot(ib)] : RT_SENTINEL;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const bool ta = av <= bv;
      x[u] = ta ? av : bv;
      ia += ta;
      ib += !ta;
      const int at = ta ? ia : ib;
      const long long v = (ta ? ia < ae : ib < be) ? s[slot(at)] : RT_SENTINEL;
      av = ta ? v : av;
      bv = ta ? bv : v;
    }
    if (warp_pair)
      __syncwarp();
    else
      __syncthreads();
  }

  // scatter through shared memory, position t + 512u, so that neighbouring
  // threads write neighbouring slots; the padding sorts last
#pragma unroll
  for (int u = 0; u < kItems; ++u) s[slot(d0 + u)] = x[u];
  __syncthreads();
  const int valid = (int)min((long long)kBlock, n - blk * kBlock);
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = t + kThreads * u;
    if (i >= valid) break;
    const long long key = s[slot(i)];
    out[s_delta[bucket_of(key, shift)] + i] = key;
  }
}

// The grid is one block per 8192 keys; the opt-in to more than 48 KB of
// dynamic shared memory is made once a card.
cudaError_t sort_opt_in() {
  static bool done[RT_MAX_DEVICES] = {};
  int dev = 0, sms = 0;
  cudaError_t e = rt_current_card(dev, sms);
  if (e != cudaSuccess || done[dev]) return e;
  e = cudaFuncSetAttribute(partition_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSlots * (int)sizeof(long long));
  done[dev] = e == cudaSuccess;
  return e;
}

int aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// The run metadata of n keys: runlen and cursors (ceil(n / 8192) x 16
// int64 each) and offsets (17 int64). totals holds `groups_cap` x 16 int64
// of scratch.
extern "C" int rt_partition_meta(const long long* keys, long long n, int shift,
                                 long long* runlen, long long* cursors,
                                 long long* offsets, long long* totals,
                                 int groups_cap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nblk = (n + kBlock - 1) / kBlock;
  if (nblk == 0)
    return (int)cudaMemsetAsync(offsets, 0, (kBuckets + 1) * sizeof(long long),
                                st);
  int dev = 0, sms = 0;
  const cudaError_t e = rt_current_card(dev, sms);
  if (e != cudaSuccess) return (int)e;
  long long groups = std::min<long long>(
      std::min<long long>(nblk, (long long)kGroupsPerSm * sms), groups_cap);
  const long long per_group = (nblk + groups - 1) / groups;
  groups = (nblk + per_group - 1) / per_group;
  count_kernel<<<(unsigned)groups, kThreads, 0, st>>>(
      keys, n, shift, nblk, per_group, aligned16(keys), runlen, cursors,
      totals);
  cursor_kernel<<<(unsigned)groups, kCursorThreads, 0, st>>>(
      totals, (int)groups, nblk, per_group, cursors, offsets);
  return (int)cudaGetLastError();
}

// keys, out: n int64 each; runlen and cursors: rt_partition_meta's.
extern "C" int rt_partition(const long long* keys, long long n, int shift,
                            const long long* runlen, const long long* cursors,
                            long long* out, void* stream) {
  if (n > 0) {
    const cudaError_t e = sort_opt_in();
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (n + kBlock - 1) / kBlock;
    partition_kernel<<<(unsigned)blocks, kThreads,
                       kSlots * sizeof(long long), (cudaStream_t)stream>>>(
        keys, n, shift, aligned16(keys), runlen, cursors, out);
  }
  return (int)cudaGetLastError();
}
