// compact_runs: sorted int64 keys (+ optional counts) -> the unique
// non-sentinel keys in order, their run sums, and the unique count.
//
// Replaces the Pallas kernel rufus_tpu/ops/pallas_fold.py:compact_sorted_hilo
// together with the head detection and prefix-coded run sums around it in
// rufus_tpu/parallel/sharded.py:_rle_compact_hilo. The TPU kernel ran its
// grid in order and chained a carry row between steps; blocks here run in
// parallel and in no order.
//
// A head is an element whose key differs from its predecessor's and is not
// the INT64_MAX sentinel. Counts: kind 0 = none (each key counts 1, the raw
// windows of the count step), 1 = int32, 2 = int64. Sentinels count 0.
//
// Bound: bytes (8n keys + counts read, 16 per unique key written). The
// output must be sized exactly, m is known only when every key has been
// seen, and the host reads it once a call. Around that read the two modes
// take different routes, the cheaper in bytes for each; both share one
// main kernel.
//
//   main    Reads keys and counts once. A block takes tiles of 4096 at a
//           stride; each arrives in shared memory by cp.async a tile
//           ahead. A thread holds 16 contiguous elements, finds its heads
//           in registers, and a block-wide segmented scan of the pair
//           (heads, open) gives every head its rank in the tile and the
//           sum of the run it closes. The tile's heads are staged by rank
//           in shared memory and written on neighbouring addresses. A tile
//           also records `lead`, the sum of its elements before its first
//           head: a run that crosses a tile edge gets only the part inside
//           its head's tile here, and its tail (the leads of the tiles
//           after it, as far as the next tile with a head) later, from one
//           warp a tile, in one step unless a run spans more than 32 tiles.
//
// Raw keys (few are unique: 8n + 40m bytes, where a count pass in front
// makes 16n + 16m):
//   stage   (rt_compact_stage) The main kernel writes a tile's heads to
//           the tile's own 4096 slots of an n-slot stage, keys as int64
//           and sums as int32, and the tile's head count; one block then
//           turns the counts into the first output slot of every 32 tiles
//           and the unique count m.
//   -       the wrapper reads m and makes outputs of exactly m elements.
//   gather  (rt_compact_gather) One warp a tile moves the tile's heads
//           from the stage to their slots and adds the tail.
//
// Keys with counts (most are unique: 24n + 16m with int64 counts, where a
// stage makes 16n + 48m):
//   count   (rt_compact_count) One warp a tile counts the tile's heads,
//           16 bytes a lane on neighbouring addresses, keys only; then the
//           offsets as above.
//   -       the wrapper reads m.
//   main    (rt_compact_runs) The main kernel writes straight to the slot
//           the count pass gave the tile; a fix-up kernel adds the tails.
//
// The scan's operator is reduce-by-key's,
//   (a.h, a.o) + (b.h, b.o) = (a.h + b.h, (b.h ? 0 : a.o) + b.o),
// associative but not commutative.
//
// What was built and measured before this, on an H100 at 106,954,752 raw
// keys (then 52,224 tiles of 2048): a single pass with decoupled look-back
// (Merrill and Garland, NVIDIA NVR-2016-002), tiles chained through
// 16-byte descriptors in device memory, into n-slot scratch that the
// wrapper then copied from.
// The pass alone never went under 0.68 ms, where a pass that only scans
// runs at 0.29 ms: a tile cannot end its look-back before every tile ahead
// of it has published, a poll's trip to L2 takes 2,000 cycles once the
// memory is busy, and the chain of inclusive prefixes moves a few hundred
// tiles a trip however wide the window. Polling with acquire loads (which
// empty the SM's L1), one ticket a tile (a block then sits on the tickets
// of prefetched tiles: 20 ms), a block-wide window, back-off, and sending
// a tile's polls a whole step before their use were each tried. With the
// copy out of the scratch that route took 0.91 ms. Neither route above has
// a chain: a tile's place in the stage, or its count, needs no other tile.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;
constexpr int kStages = 2;  // tiles a block holds: one worked on, one arriving
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// (h, o) <- (h, o) + (bh, bo) with the operator above. Inside a tile the
// heads fit an int, and so do the sums where each key counts 1.
template <typename S>
__device__ __forceinline__ void append(int& h, S& o, int bh, S bo) {
  o = (bh ? 0 : o) + bo;
  h += bh;
}

template <int KIND> struct Sum { using type = long long; };
template <> struct Sum<0> { using type = int; };

// --- the count pass ------------------------------------------------------

// heads[t] = the heads of tile t. A warp takes a tile as 64 rows of 64
// keys, a lane 2 keys of a row; the key before a lane's pair comes from
// the lane below, for lane 0 from the row before.
__global__ void __launch_bounds__(kThreads)
count_kernel(const long long* __restrict__ keys, long long n, long long nt,
             int aligned, int* __restrict__ heads) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       tile < nt; tile += warps) {
    const long long base = tile * kTile;
    long long carry = base > 0 ? keys[base - 1] : RT_SENTINEL;
    int h = 0;
    if (aligned && base + kTile <= n) {
      const longlong2* kp = (const longlong2*)(keys + base);
#pragma unroll 8
      for (int r = 0; r < kTile / 64; ++r) {
        const longlong2 v = kp[32 * r + lane];
        long long prev = __shfl_up_sync(kFull, v.y, 1);
        if (lane == 0) prev = carry;
        carry = __shfl_sync(kFull, v.y, 31);
        h += (v.x != RT_SENTINEL && v.x != prev) +
             (v.y != RT_SENTINEL && v.y != v.x);
      }
    } else {
      for (int r = 0; r < kTile / 32; ++r) {
        const long long i = base + 32 * r + lane;
        const long long v = i < n ? keys[i] : RT_SENTINEL;
        long long prev = __shfl_up_sync(kFull, v, 1);
        if (lane == 0) prev = carry;
        carry = __shfl_sync(kFull, v, 31);
        h += v != RT_SENTINEL && v != prev;
      }
    }
    h = (int)warp_sum(h);
    if (lane == 0) heads[tile] = h;  // at most kTile
  }
}

// gfirst[g] = the heads before group g of 32 tiles, *total = the unique
// count. One block; a thread takes a group a round with 16-byte loads
// (heads is padded to a multiple of 4 entries), and the rounds chain
// through `before`. A tile finds its own first slot from its group's.
constexpr int kScanThreads = 1024, kGroup = 32;

__global__ void __launch_bounds__(kScanThreads)
offsets_kernel(const int* __restrict__ heads, long long nt,
               long long* __restrict__ gfirst, long long* total) {
  __shared__ long long s_w[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long before = 0;  // the heads of the rounds so far
  for (long long r0 = 0; r0 < nt; r0 += kScanThreads * kGroup) {
    const long long lo = r0 + (long long)threadIdx.x * kGroup;
    long long sum = 0;
#pragma unroll
    for (int i = 0; i < kGroup / 4; ++i) {
      if (lo + 4 * i < nt) {
        const int4 q = *(const int4*)(heads + lo + 4 * i);
        sum += q.x;
        if (lo + 4 * i + 1 < nt) sum += q.y;
        if (lo + 4 * i + 2 < nt) sum += q.z;
        if (lo + 4 * i + 3 < nt) sum += q.w;
      }
    }
    long long inc = sum;  // inclusive over the warp's threads
    for (int o = 1; o < 32; o <<= 1) {
      const long long up = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += up;
    }
    if (lane == 31) s_w[warp] = inc;
    __syncthreads();
    long long run = before + inc - sum;
    for (int w = 0; w < kScanThreads / 32; ++w) {
      if (w < warp) run += s_w[w];
      before += s_w[w];
    }
    if (lo < nt) gfirst[lo / kGroup] = run;
    __syncthreads();  // s_w is written again
  }
  if (threadIdx.x == 0) *total = before;
}

// --- the tile ring in shared memory --------------------------------------
//
// A stage holds one tile: kTile keys, then its counts. Tiles arrive by
// cp.async, 16 bytes a thread on neighbouring addresses, a tile ahead of
// the one being worked on, so the memory system stays busy while a block
// scans and writes. A thread then reads its 16 contiguous elements from
// the stage; to keep those 16-byte reads off each other's banks, 16-byte
// chunk c of a buffer lives in slot swz(c), c with its low bits flipped by
// the bits above them. Once its elements are in
// registers the stage is reused to stage the tile's output keys, and its
// sums where the counts were 8 bytes; otherwise the sums have a buffer of
// their own behind the ring (less shared memory a block is more blocks an
// SM).

template <int P>  // P = 16-byte chunks a thread reads from the buffer
__device__ __forceinline__ int swz(int c) {
  return c ^ ((c >> 3) & (P >= 8 ? 7 : 3));
}

// Bytes of one count, and 8-byte words of one stage.
__host__ __device__ constexpr int count_bytes(int kind) {
  return kind == 0 ? 0 : kind == 1 ? 4 : 8;
}
__host__ __device__ constexpr int stage_words(int kind) {
  return kTile + kTile * count_bytes(kind) / 8;
}
__host__ __device__ constexpr int ring_words(int kind) {
  return kStages * stage_words(kind) + (kind == 2 ? 0 : kTile);
}

// Start the copy of tile `tile` into a stage (keys at sk, counts at sv) and
// of the key before the tile into *sprev. A whole, 16-byte aligned tile
// goes by cp.async; any other is filled with plain loads, sentinel-padded.
template <int KIND>
__device__ __forceinline__ void fetch_tile(const long long* __restrict__ keys,
                                           const void* __restrict__ counts,
                                           long long n, long long tile,
                                           bool aligned,
                                           long long* sk, long long* sv,
                                           long long* sprev) {
  if (tile < 0) return;
  const long long base = tile * kTile;
  constexpr int CB = count_bytes(KIND);
  if (threadIdx.x == 0) {
    if (base > 0) cp_async8(sprev, keys + base - 1);
    else *sprev = RT_SENTINEL;
  }
  if (aligned && base + kTile <= n) {
    const char* gk = (const char*)(keys + base);
    for (int c = threadIdx.x; c < kTile / 2; c += kThreads)
      cp_async16((char*)sk + 16 * swz<kItems / 2>(c), gk + 16 * c);
    if (CB) {
      const char* gv = (const char*)counts + base * CB;
      for (int c = threadIdx.x; c < kTile * CB / 16; c += kThreads)
        cp_async16((char*)sv + 16 * swz<kItems * CB / 16>(c), gv + 16 * c);
    }
  } else {
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      const long long i = base + e;
      sk[2 * swz<kItems / 2>(e >> 1) + (e & 1)] =
          i < n ? keys[i] : RT_SENTINEL;
      if (KIND == 1)
        ((int*)sv)[4 * swz<kItems / 4>(e >> 2) + (e & 3)] =
            i < n ? ((const int*)counts)[i] : 0;
      if (KIND == 2)
        sv[2 * swz<kItems / 2>(e >> 1) + (e & 1)] =
            i < n ? ((const long long*)counts)[i] : 0;
    }
  }
}

// This thread's 16 elements of a stage, into registers.
template <int KIND>
__device__ __forceinline__ void read_tile(const long long* sk,
                                          const long long* sv,
                                          long long (&key)[kItems],
                                          typename Sum<KIND>::type (
                                              &val)[kItems]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kItems / 2; ++j) {
    const longlong2 v =
        ((const longlong2*)sk)[swz<kItems / 2>(kItems / 2 * t + j)];
    key[2 * j] = v.x;
    key[2 * j + 1] = v.y;
  }
  if (KIND == 1) {
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      const int4 v = ((const int4*)sv)[swz<kItems / 4>(kItems / 4 * t + j)];
      val[4 * j] = v.x;
      val[4 * j + 1] = v.y;
      val[4 * j + 2] = v.z;
      val[4 * j + 3] = v.w;
    }
  } else if (KIND == 2) {
#pragma unroll
    for (int j = 0; j < kItems / 2; ++j) {
      const longlong2 v =
          ((const longlong2*)sv)[swz<kItems / 2>(kItems / 2 * t + j)];
      val[2 * j] = v.x;
      val[2 * j + 1] = v.y;
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (KIND == 0) val[j] = 1;
    if (key[j] == RT_SENTINEL) val[j] = 0;
  }
}

// 16 elements a thread and two blocks an SM: with 8 and three blocks the
// main pass took 0.46 ms where this takes 0.40 (raw keys; the scan's cost
// a thread is spread over more elements).
//
// STAGED: there was no count pass. The tile's heads go to the tile's own
// place in a stage of n slots (keys int64, sums int32: a tile's part of a
// run fits an int) and heads_of[tile] is written here, not read.
template <int KIND, bool STAGED>
__global__ void __launch_bounds__(kThreads, 2)
compact_kernel(const long long* __restrict__ keys,
               const void* __restrict__ counts, long long n, long long nt,
               int aligned, int* __restrict__ heads_of,
               const long long* __restrict__ gfirst,
               long long* __restrict__ first, long long* __restrict__ lead,
               long long* __restrict__ out_keys, void* __restrict__ out_sums) {
  using S = typename Sum<KIND>::type;
  extern __shared__ __align__(16) long long s_ring[];  // ring_words(KIND)
  constexpr int kStage = stage_words(KIND);
  __shared__ int s_wh[kWarps];  // warp aggregates
  __shared__ S s_wo[kWarps];
  __shared__ long long s_prev[kStages];  // the key before each stage's tile
  __shared__ long long s_slot;           // the tile's first output slot
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // Block b takes tiles nt-1-b, nt-1-b-G, ... of the G blocks launched:
  // from the end, where a count pass has left the keys in L2.
  long long tile = nt - 1 - blockIdx.x;
  fetch_tile<KIND>(keys, counts, n, tile, aligned, s_ring, s_ring + kTile,
                   s_prev);
  cp_async_commit();
  for (int cur = 0; tile >= 0; tile -= gridDim.x, cur ^= 1) {
    // this tile has arrived, and every thread is done with the one before,
    // whose stage takes the next
    cp_async_wait<0>();
    __syncthreads();
    const int nxt = cur ^ 1;
    fetch_tile<KIND>(keys, counts, n, tile - gridDim.x, aligned,
                     s_ring + nxt * kStage, s_ring + nxt * kStage + kTile,
                     s_prev + nxt);
    cp_async_commit();
    long long* s_keys = s_ring + cur * kStage;
    long long* s_sums =
        KIND == 2 ? s_keys + kTile : s_ring + kStages * kStage;

    // the tile's first slot: its group's, and the group's tiles before it
    if (!STAGED && warp == 0) {
      const long long g0 = tile / kGroup * kGroup;
      const int before = g0 + lane < tile ? heads_of[g0 + lane] : 0;
      const long long slot = gfirst[tile / kGroup] + warp_sum(before);
      if (lane == 0) {
        s_slot = slot;
        first[tile] = slot;
      }
    }

    long long key[kItems];
    S val[kItems];
    read_tile<KIND>(s_keys, s_keys + kTile, key, val);
    long long prev = __shfl_up_sync(kFull, key[kItems - 1], 1);
    if (lane == 0)
      prev = warp
                 ? s_keys[2 * swz<kItems / 2>(kItems / 2 * threadIdx.x - 1) + 1]
                 : s_prev[cur];

    // this thread's heads (a bit each) and its aggregate
    unsigned heads = 0;
    int ih = 0;
    S io = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool h =
          key[j] != RT_SENTINEL && key[j] != (j ? key[j - 1] : prev);
      heads |= (unsigned)h << j;
      append(ih, io, h, val[j]);
    }
    // inclusive scan across the warp, then the warps' aggregates
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int uh = __shfl_up_sync(kFull, ih, o);
      const S uo = __shfl_up_sync(kFull, io, o);
      if (lane >= o) {
        io = (ih ? 0 : uo) + io;
        ih += uh;
      }
    }
    if (lane == 31) {
      s_wh[warp] = ih;
      s_wo[warp] = io;
    }
    __syncthreads();  // every thread also has its elements in registers

    // this thread's prefix inside the tile (rh, ro) and the tile's
    // aggregate (ah, ao)
    int ah = 0, rh = 0;
    S ao = 0, ro = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) {
        rh = ah;
        ro = ao;
      }
      append(ah, ao, s_wh[w], s_wo[w]);
    }
    const int lh = __shfl_up_sync(kFull, ih, 1);
    const S lo = __shfl_up_sync(kFull, io, 1);
    if (lane > 0) append(rh, ro, lh, lo);

    // Stage the tile's output by rank: the key of the tile's r-th head in
    // slot r; the sum a head closes belongs to the head before it, so it
    // goes to slot r - 1, and the first head instead gives `lead`, what
    // lies before it in the tile. The last head's slot takes the part of
    // its run inside the tile.
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if ((heads >> j) & 1u) {
        s_keys[rh] = key[j];
        if (rh == 0) lead[tile] = ro;
        else s_sums[rh - 1] = ro;
        ++rh;
        ro = val[j];
      } else {
        ro += val[j];
      }
    }
    if (threadIdx.x == 0) {
      if (ah == 0) lead[tile] = ao;  // no head: the whole tile leads
      else s_sums[ah - 1] = ao;
      if (STAGED) heads_of[tile] = ah;
    }
    __syncthreads();
    // neighbouring threads write neighbouring slots
    const long long slot = STAGED ? tile * kTile : s_slot;
    for (int r = threadIdx.x; r < ah; r += kThreads) {
      out_keys[slot + r] = s_keys[r];
      if (STAGED) ((int*)out_sums)[slot + r] = (int)s_sums[r];
      else ((long long*)out_sums)[slot + r] = s_sums[r];
    }
  }
  cp_async_wait<0>();
}

// What tile t's last run takes from the tiles after it: their leads,
// through the next tile that holds a head. A warp looks at 32 tiles a
// step; a tile that opens with a sentinel ends the walk (the keys are
// sorted: only sentinels follow, and they count 0). Every lane gets the sum.
__device__ __forceinline__ long long tail_of(
    const long long* __restrict__ keys, const int* __restrict__ heads,
    const long long* __restrict__ lead, long long nt, long long t, int lane) {
  long long add = 0;
  for (long long base = t + 1; base < nt; base += 32) {
    const long long j = base + lane;
    const bool in = j < nt;
    const bool stop =
        !in || heads[j] != 0 || keys[j * kTile] == RT_SENTINEL;
    const unsigned stops = __ballot_sync(kFull, stop);
    const int last = stops ? __ffs(stops) - 1 : 31;
    add += warp_sum(in && lane <= last ? lead[j] : 0);
    if (stops) break;
  }
  return add;
}

// After the counted main pass, one warp a tile: a run that crosses a tile
// edge got only the part inside its head's tile.
__global__ void __launch_bounds__(kThreads)
fixup_kernel(const long long* __restrict__ keys,
             const int* __restrict__ heads,
             const long long* __restrict__ first,
             const long long* __restrict__ lead, long long nt,
             long long* __restrict__ out_sums) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= nt || heads[t] == 0) return;
  const long long add = tail_of(keys, heads, lead, nt, t, lane);
  if (lane == 0) out_sums[first[t] + heads[t] - 1] += add;
}

// After the staged main pass and the offsets, one warp a tile: the tile's
// heads move from its stage to their slots in the output, the sums widen
// to int64, and the tile's last run takes its tail. A lane has 16 loads in
// flight before its first store, and the first 16 are on their way while
// the warp finds its slot and tail: with one load a store the kernel took
// 0.23 ms on an H100 at 14.8 M heads of 107 M keys, with 4, 8 and 16 in
// flight 0.17, 0.16 and 0.15.
constexpr int kBatch = 16;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const long long* __restrict__ keys,
              const long long* __restrict__ stage_keys,
              const int* __restrict__ stage_sums,
              const int* __restrict__ heads,
              const long long* __restrict__ gfirst,
              const long long* __restrict__ lead, long long nt,
              long long* __restrict__ out_keys,
              long long* __restrict__ out_sums) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= nt) return;
  const int h = heads[t];
  if (h == 0) return;
  const long long src = t * kTile;
  long long slot = 0, add = 0;
  for (int r0 = 0; r0 < h; r0 += 32 * kBatch) {
    long long k[kBatch];
    int v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int r = r0 + 32 * b + lane;
      if (r < h) {
        k[b] = stage_keys[src + r];
        v[b] = stage_sums[src + r];
      }
    }
    if (r0 == 0) {
      const long long g0 = t / kGroup * kGroup;
      const int before = g0 + lane < t ? heads[g0 + lane] : 0;
      slot = gfirst[t / kGroup] + warp_sum(before);
      add = tail_of(keys, heads, lead, nt, t, lane);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int r = r0 + 32 * b + lane;
      if (r < h) {
        out_keys[slot + r] = k[b];
        out_sums[slot + r] = v[b] + (r == h - 1 ? add : 0);
      }
    }
  }
}

bool aligned16(const void* a, const void* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15u) == 0;
}

// Scratch, in int64 words, for nt = ceil(n / 4096) tiles in ng =
// ceil(nt / 32) groups: [0] the unique count, [1] unused, then first[nt],
// lead[nt], gfirst[ng] and, 16-byte aligned, the int32 heads[nt] padded to
// a multiple of 4 (ops/cuda_fold.py:_scratch_words sizes it). Nothing
// needs clearing.
struct Scratch {
  long long *total, *first, *lead, *gfirst;
  int* heads;
};

Scratch scratch_layout(long long* s, long long nt) {
  const long long ng = (nt + kGroup - 1) / kGroup;
  Scratch d;
  d.total = s;
  d.first = s + 2;
  d.lead = d.first + nt;
  d.gfirst = d.lead + nt;
  const long long words = 2 + 2 * nt + ng;
  d.heads = (int*)(s + words + (words & 1));
  return d;
}

// The main kernel of one kind, and how many of its blocks the current card
// holds at once (asked once a card: the query takes longer than the
// kernels' gaps).
using MainKernel = void (*)(const long long*, const void*, long long,
                            long long, int, int*, const long long*,
                            long long*, long long*, long long*, void*);

struct MainLaunch {
  MainKernel kernel;
  int smem;
  long long resident;
};

constexpr int kCountBlocksPerSm = 8;  // of the count pass

cudaError_t main_launch(int kind, MainLaunch& out) {
  static MainLaunch cache[RT_MAX_DEVICES][3] = {};
  int dev = 0, sms = 0;
  cudaError_t e = rt_current_card(dev, sms);
  if (e != cudaSuccess) return e;
  MainLaunch& c = cache[dev][kind];
  if (c.kernel == nullptr) {
    const MainKernel kernel = kind == 0 ? compact_kernel<0, true>
                              : kind == 1 ? compact_kernel<1, false>
                                          : compact_kernel<2, false>;
    const int smem = ring_words(kind) * (int)sizeof(long long);
    // above 48 KB of dynamic shared memory only after this opt-in
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 0;
    if (e != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return e;
    c.smem = smem;
    c.resident = (long long)sms * std::max(per_sm, 1);
    c.kernel = kernel;
  }
  out = c;
  return cudaSuccess;
}


// As many blocks of the main kernel as the card holds at once walk the
// tiles.
cudaError_t launch_main(int kind, const long long* keys, const void* counts,
                        long long n, long long nt, const Scratch& d,
                        long long* out_keys, void* out_sums,
                        cudaStream_t st) {
  MainLaunch m;
  const cudaError_t e = main_launch(kind, m);
  if (e != cudaSuccess) return e;
  m.kernel<<<(unsigned)std::min(nt, m.resident), kThreads, m.smem, st>>>(
      keys, counts, n, nt, aligned16(keys, counts), d.heads, d.gfirst, d.first,
      d.lead, out_keys, out_sums);
  return cudaSuccess;
}

}  // namespace

// Keys with counts, step 1, the count pass: scratch[0] receives the unique
// count.
extern "C" int rt_compact_count(const long long* keys, long long n,
                                long long* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = (n + kTile - 1) / kTile;
  const Scratch d = scratch_layout(scratch, nt);
  if (nt > 0) {
    int dev = 0, sms = 0;
    const cudaError_t e = rt_current_card(dev, sms);
    if (e != cudaSuccess) return (int)e;
    const long long want = (nt + kWarps - 1) / kWarps;
    const long long blocks = (long long)kCountBlocksPerSm * sms;
    count_kernel<<<(unsigned)std::min(want, blocks), kThreads, 0, st>>>(
        keys, n, nt, aligned16(keys, nullptr), d.heads);
  }
  offsets_kernel<<<1, kScanThreads, 0, st>>>(d.heads, nt, d.gfirst, d.total);
  return (int)cudaGetLastError();
}

// Keys with counts (kind 1 or 2), step 2, after rt_compact_count on the
// same keys and scratch: the main pass and the fix-up. out_keys and
// out_sums hold scratch[0] slots.
extern "C" int rt_compact_runs(const long long* keys, const void* counts,
                               int kind, long long n, long long* scratch,
                               long long* out_keys, long long* out_sums,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = (n + kTile - 1) / kTile;
  if (nt == 0) return (int)cudaGetLastError();
  const Scratch d = scratch_layout(scratch, nt);
  const cudaError_t e =
      launch_main(kind, keys, counts, n, nt, d, out_keys, out_sums, st);
  if (e != cudaSuccess) return (int)e;
  fixup_kernel<<<(unsigned)((nt + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      keys, d.heads, d.first, d.lead, nt, out_sums);
  return (int)cudaGetLastError();
}

// Raw keys, step 1: the main pass into the stage (stage_keys and stage_sums
// hold ceil(n / 4096) * 4096 slots), then the offsets; scratch[0] receives
// the unique count.
extern "C" int rt_compact_stage(const long long* keys, long long n,
                                long long* scratch, long long* stage_keys,
                                int* stage_sums, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = (n + kTile - 1) / kTile;
  const Scratch d = scratch_layout(scratch, nt);
  if (nt > 0) {
    const cudaError_t e =
        launch_main(0, keys, nullptr, n, nt, d, stage_keys, stage_sums, st);
    if (e != cudaSuccess) return (int)e;
  }
  offsets_kernel<<<1, kScanThreads, 0, st>>>(d.heads, nt, d.gfirst, d.total);
  return (int)cudaGetLastError();
}

// Raw keys, step 2, after rt_compact_stage on the same keys, scratch and
// stage: the gather. out_keys and out_sums hold scratch[0] slots.
extern "C" int rt_compact_gather(const long long* keys, long long n,
                                 const long long* scratch,
                                 const long long* stage_keys,
                                 const int* stage_sums, long long* out_keys,
                                 long long* out_sums, void* stream) {
  const long long nt = (n + kTile - 1) / kTile;
  if (nt == 0) return (int)cudaGetLastError();
  const Scratch d = scratch_layout(const_cast<long long*>(scratch), nt);
  gather_kernel<<<(unsigned)((nt + kWarps - 1) / kWarps), kThreads, 0,
                  (cudaStream_t)stream>>>(keys, stage_keys, stage_sums, d.heads,
                                          d.gfirst, d.lead, nt, out_keys,
                                          out_sums);
  return (int)cudaGetLastError();
}
