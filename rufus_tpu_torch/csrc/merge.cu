// merge_runs: two sorted unique int64 key runs with int64 counts -> their
// union in order, the counts of a key that both hold summed.
//
// Replaces no TPU kernel. The JAX package merges a fold's pending run into
// its table by sorting table || pending (rufus_tpu/parallel/sharded.py:
// sharded_fold_step, step 3, :684-686), and the port did the same with a
// stable torch.sort (ops/count.py:merge_sum), at 64 device bytes a key.
// Both runs are sorted and unique, so their union is one linear pass: this
// kernel is what lets the count fold each batch as it arrives instead of
// buffering 96 M keys to amortise two sorts (ops/table.py).
//
// Bound: bytes. The output needs 16(N + u) bytes read and 16m written (N
// and u the runs' lengths, m the union's); the kernels read the keys twice
// and the counts once, 24(N + u) + 16m in all. Device memory at the peak:
// both runs and the output, at most 32(N + u) bytes, and no scratch to
// speak of.
//
// The merged sequence of the two runs (both copies of a shared key kept,
// the table's first) is cut into tiles of 4096 positions by merge-path
// co-ranks (Green, McColl and Bader, ICS 2012): the co-rank i of position d
// is the number of the table's keys among the first d, found by one binary
// search. A key in both runs must not be split between two tiles, or
// neither tile could sum it: where a[i-1] == b[d-i] the cut moves one
// place on, past the run's copy, so a tile holds 4095 to 4097 positions.
// The passes:
//
//   corank  (rt_merge_count) One thread a tile boundary: its co-ranks.
//   count   One block a tile brings the tile's keys into shared memory;
//           each thread cuts its 16 positions from them by the same
//           co-rank rule, merges them and counts its keys; the block's
//           sum is the tile's.
//   offsets One block scans the tiles' counts into each tile's first
//           output slot and the union's size m.
//   -       the wrapper reads m once and makes outputs of exactly m.
//   write   (rt_merge_write) As count, with the counts too: each thread
//           merges its positions into registers, a block scan gives it its
//           place in the tile's output, the output is staged in shared
//           memory and written on neighbouring addresses.
//
// Shared memory keeps one pad word every 16 (`at`): a thread's positions
// are contiguous, so without it the 32 threads of a warp would read one
// bank.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;
// a tile's positions, at most kTile + 1, padded
constexpr int kSlots = (kTile + 1) + (kTile + 1) / 16 + 2;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int at(int x) { return x + (x >> 4); }

// Co-rank of merged position d of a (na keys) and b (nb keys), ties to a,
// then moved past b[j] where a[i-1] == b[j]: returns i, sets j.
template <typename I, typename KA, typename KB>
__device__ __forceinline__ I corank(KA ka, I na, KB kb, I nb, I d, I& j) {
  I lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (ka(mid) <= kb(d - mid - 1)) lo = mid + 1;
    else hi = mid;
  }
  j = d - lo;
  if (lo > 0 && j < nb && ka(lo - 1) == kb(j)) ++j;
  return lo;
}

// ia[t], jb[t] for t = 0..nt: the tile boundaries at positions t * kTile
// (the last at na + nb).
__global__ void __launch_bounds__(kThreads)
corank_kernel(const long long* __restrict__ a, long long na,
              const long long* __restrict__ b, long long nb, long long nt,
              long long* __restrict__ ia, long long* __restrict__ jb) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t > nt) return;
  const long long d = min(t * kTile, na + nb);
  long long j;
  const long long i = corank<long long>(
      [&](long long x) { return a[x]; }, na, [&](long long x) { return b[x]; },
      nb, d, j);
  ia[t] = i;
  jb[t] = j;
}

// Exclusive block-wide scan of v; *all receives the block's sum.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0;
  all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += s_warp[w];
    all += s_warp[w];
  }
  return before + inc - v;
}

// One block a tile. WRITE = false: uniq[t] = the tile's output keys.
// WRITE = true: the tile's output, from slot first[t].
template <bool WRITE>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const long long* __restrict__ a, const long long* __restrict__ ca,
             const long long* __restrict__ b, const long long* __restrict__ cb,
             const long long* __restrict__ ia, const long long* __restrict__ jb,
             int* __restrict__ uniq, const long long* __restrict__ first,
             long long* __restrict__ out_keys,
             long long* __restrict__ out_counts) {
  extern __shared__ __align__(16) long long s_mem[];  // keys, then counts
  long long* sk = s_mem;
  long long* sc = s_mem + kSlots;
  __shared__ int s_warp[kWarps];
  const long long t = blockIdx.x;
  const long long a0 = ia[t], b0 = jb[t];
  const int na = (int)(ia[t + 1] - a0), nb = (int)(jb[t + 1] - b0);
  const int len = na + nb;
#pragma unroll 4
  for (int e = threadIdx.x; e < na; e += kThreads) {
    sk[at(e)] = a[a0 + e];
    if (WRITE) sc[at(e)] = ca[a0 + e];
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < nb; e += kThreads) {
    sk[at(na + e)] = b[b0 + e];
    if (WRITE) sc[at(na + e)] = cb[b0 + e];
  }
  __syncthreads();

  // this thread's positions [d0, d1) of the tile; the last takes the
  // tile's 4097th, if it has one
  const auto ka = [&](int x) { return sk[at(x)]; };
  const auto kb = [&](int x) { return sk[at(na + x)]; };
  const int d0 = min((int)threadIdx.x * kItems, len);
  const int d1 = threadIdx.x == kThreads - 1 ? len : min(d0 + kItems, len);
  int j0, j1;
  int i = corank<int>(ka, na, kb, nb, d0, j0);
  const int i1 = corank<int>(ka, na, kb, nb, d1, j1);
  int j = j0;

  // merge them: each step emits one key (both copies of a shared one at
  // once), so a thread emits at most kItems + 1
  long long ok[kItems + 1], oc[kItems + 1];
  int n = 0;
#pragma unroll
  for (int q = 0; q <= kItems; ++q) {
    const bool ha = i < i1, hb = j < j1;
    if (ha || hb) {
      const long long x = ha ? ka(i) : RT_SENTINEL;
      const long long y = hb ? kb(j) : RT_SENTINEL;
      const bool ta = x <= y, tb = y <= x;
      ok[q] = ta ? x : y;
      if (WRITE)
        oc[q] = (ta ? sc[at(i)] : 0) + (tb ? sc[at(na + j)] : 0);
      i += ta;
      j += tb;
      n = q + 1;
    }
  }
  int all;
  const int off = block_scan(n, s_warp, all);
  if (!WRITE) {
    if (threadIdx.x == 0) uniq[t] = all;
    return;
  }
  __syncthreads();  // every thread is done reading the tile
#pragma unroll
  for (int q = 0; q <= kItems; ++q) {
    if (q < n) {
      sk[at(off + q)] = ok[q];
      sc[at(off + q)] = oc[q];
    }
  }
  __syncthreads();
  const long long slot = first[t];
  for (int r = threadIdx.x; r < all; r += kThreads) {
    out_keys[slot + r] = sk[at(r)];
    out_counts[slot + r] = sc[at(r)];
  }
}

// first[t] = the output keys of the tiles before t, *total = m. One block;
// a thread sums a contiguous share of the tiles.
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads)
offsets_kernel(const int* __restrict__ uniq, long long nt,
               long long* __restrict__ first, long long* __restrict__ total) {
  __shared__ long long s_w[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long per = (nt + kScanThreads - 1) / kScanThreads;
  const long long lo = min((long long)threadIdx.x * per, nt);
  const long long hi = min(lo + per, nt);
  long long sum = 0;
  for (long long x = lo; x < hi; ++x) sum += uniq[x];
  long long inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const long long up = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) s_w[warp] = inc;
  __syncthreads();
  long long run = inc - sum, all = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) {
    if (w < warp) run += s_w[w];
    all += s_w[w];
  }
  for (long long x = lo; x < hi; ++x) {
    first[x] = run;
    run += uniq[x];
  }
  if (threadIdx.x == 0) *total = all;
}

// Scratch, in int64 words, for nt tiles: [0] the union's size, [1] unused,
// ia[nt + 1], jb[nt + 1], first[nt], then the int32 uniq[nt]
// (ops/cuda_merge.py:_scratch_words sizes it).
struct Scratch {
  long long *total, *ia, *jb, *first;
  int* uniq;
};

Scratch scratch_layout(long long* s, long long nt) {
  Scratch d;
  d.total = s;
  d.ia = s + 2;
  d.jb = d.ia + nt + 1;
  d.first = d.jb + nt + 1;
  d.uniq = (int*)(d.first + nt);
  return d;
}

// The merge kernel of one mode with its dynamic shared memory (above 48 KB
// only after the opt-in, made once a card).
template <bool WRITE>
cudaError_t merge_launch(int& smem) {
  static bool ready[RT_MAX_DEVICES] = {};
  smem = (WRITE ? 2 : 1) * kSlots * (int)sizeof(long long);
  int dev = 0, sms = 0;
  cudaError_t e = rt_current_card(dev, sms);
  if (e != cudaSuccess || ready[dev]) return e;
  e = cudaFuncSetAttribute(merge_kernel<WRITE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) ready[dev] = true;
  return e;
}

long long tiles(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Step 1: the co-ranks, each tile's output count and first slot; scratch[0]
// receives the union's size m.
extern "C" int rt_merge_count(const long long* a, long long na,
                              const long long* b, long long nb,
                              long long* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = tiles(na + nb);
  const Scratch d = scratch_layout(scratch, nt);
  corank_kernel<<<(unsigned)((nt + kThreads) / kThreads), kThreads, 0, st>>>(
      a, na, b, nb, nt, d.ia, d.jb);
  if (nt > 0) {
    int smem = 0;
    const cudaError_t e = merge_launch<false>(smem);
    if (e != cudaSuccess) return (int)e;
    merge_kernel<false><<<(unsigned)nt, kThreads, smem, st>>>(
        a, nullptr, b, nullptr, d.ia, d.jb, d.uniq, nullptr, nullptr,
        nullptr);
  }
  offsets_kernel<<<1, kScanThreads, 0, st>>>(d.uniq, nt, d.first, d.total);
  return (int)cudaGetLastError();
}

// Step 2, after rt_merge_count on the same runs and scratch: the union's
// keys and summed counts into out_keys and out_counts (scratch[0] slots).
extern "C" int rt_merge_write(const long long* a, const long long* ca,
                              long long na, const long long* b,
                              const long long* cb, long long nb,
                              const long long* scratch, long long* out_keys,
                              long long* out_counts, void* stream) {
  const long long nt = tiles(na + nb);
  if (nt == 0) return (int)cudaGetLastError();
  const Scratch d = scratch_layout(const_cast<long long*>(scratch), nt);
  int smem = 0;
  const cudaError_t e = merge_launch<true>(smem);
  if (e != cudaSuccess) return (int)e;
  merge_kernel<true><<<(unsigned)nt, kThreads, smem, (cudaStream_t)stream>>>(
      a, ca, b, cb, d.ia, d.jb, nullptr, d.first, out_keys, out_counts);
  return (int)cudaGetLastError();
}
