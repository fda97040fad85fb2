// window_hits: per read, the number of k-mer windows that pass RUFUS.Filter's
// streak rule and whose canonical key is in the sorted mutant HashList.
//
// Replaces the Pallas kernel rufus_tpu/ops/pallas_filter.py:pallas_window_hits,
// which compared every window with every table entry in an unrolled loop
// (so the JAX package sent tables above 1024 keys to a Bloom filter plus
// host verification). Here membership is exact for any T.
//
// A base is bad iff it is not ACGT (either case) or qual - 33 < min_q. A
// window ending at position p is scanned iff its k bases are all good and
// p <= len - 2 (the reference never examines the window ending at the last
// base); so a read has min(W, len - k) windows to look at, and no base at
// or past len is ever in one.
//
// Bound: bytes. The reads and quals (2*B*L) are read once; the table, its
// index and the counts are small beside them (21.5 MB, 6.4 us on an H100
// at the trio's (65536, 160) against 2,498 keys).
//
// What held the first design back there, 0.193 ms: a block of 64
// reads staged them a byte at a time (an integer division and three loads
// an element), 1,024 blocks each copied the whole table into shared
// memory, each thread rolled the key over 8 + k - 1 bases for 8 windows
// (3/4 of it repeated between threads) and binary-searched the table with
// ~12 dependent loads a window (~17 from L2 above ~27,700 keys), and 1,088
// window spans a block went over 256 threads in 4.25 rounds.
//
// This design, for this card:
//
//   table    A prefix index over the sorted table, built once per HashList
//            (ops/cuda_filter.py:hashlist_index): index[p] is the first
//            position whose key's top `bits` bits (of 2k) are >= p, bits =
//            ceil(log2 T) + 1, at most 15. Blocks are persistent (as many
//            as the card holds, asked once a card and size), and each
//            copies the index, and the keys while they fit beside it, into
//            shared memory once, by cp.async.
//   steps    A warp takes 4 consecutive reads a step (2 or 1 for long
//            reads) and works alone: cp.async brings the next step's reads,
//            quals and lens into its own buffer while it works on this
//            one, and only __syncwarp orders its lanes (one block barrier,
//            after the table arrives).
//   pack     Its lanes turn 16 bases and their quals at a time into 2-bit
//            codes (first base highest, 64-bit words) and bad bits, in
//            shared memory. A base is checked with one __byte_perm against
//            "ACGT", a qual with one subtraction.
//   windows  8 lanes a read, lane j taking a span of 16 windows: the span's
//            first key is a field of the codes, its reverse complement a
//            bit reversal; the next windows roll 2 bits in, and a running
//            count of good bases gives the streak rule.
//   lookup   A window reads index[p], index[p + 1] (usually an empty or a
//            one-key range) and that range's first key, which settles a
//            range of one; longer ranges are binary-searched, 4 windows in
//            lockstep (8 where the keys are in L2) so their loads overlap.
//   count    Summed over a read's lanes with shuffles, written by one lane.
//
// Tried on the H100 and slower (PERF.md, Findings): a whole warp on a read with
// every window's keys cut out as fields; blocks that stage and pack a group
// together between block barriers; 2 reads a step; 256 or 1024 threads.

#include <algorithm>

#include "packed.cuh"

namespace {

using packed::row_words;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kResidentCache = 16;  // shared-memory sizes remembered a card
// windows a lane looks up together: more where the keys are in L2
template <bool kKeysSmem>
constexpr int kBatch = kKeysSmem ? 4 : 8;

__host__ __device__ inline long long align16(long long x) {
  return (x + 15) & ~15ll;
}

// A warp's own shared memory: two raw buffers (reads, quals and lens of
// `rw` reads: the step being packed and the next one arriving), then the
// packed step (codes and bad bits, 12 bytes a word), then 16 spare bytes
// (a read of the word after a row's last may pass the end).
struct WarpLayout {
  long long rb, buf, packed, bytes;
};

__host__ __device__ inline WarpLayout warp_layout(int rw, int L) {
  WarpLayout w;
  w.rb = align16((long long)rw * L + 32);  // from the 16-byte boundary below
  w.buf = 2 * w.rb + align16(4ll * rw);
  w.packed = 2 * w.buf;
  w.bytes = w.packed + align16((long long)rw * row_words(L) * 12 + 16);
  return w;
}

// Byte offset of the warps' memory in a block's: after the index and, when
// they are staged, the keys.
__host__ __device__ inline long long warps_at(int bits, long long T,
                                              int keys_smem) {
  return align16(4ll * ((1ll << bits) + 1)) + (keys_smem ? align16(8 * T) : 0);
}

__host__ __device__ inline long long block_bytes(int bits, long long T,
                                                 int keys_smem, int rw, int L) {
  return warps_at(bits, T, keys_smem) + kWarps * warp_layout(rw, L).bytes;
}

// Four ASCII bases -> their codes in the low 2 bits of each byte, and in
// bit 7 of each byte of `invalid` whether the base is not ACGT (either
// case). A base is valid iff its byte equals the letter its code stands
// for: one __byte_perm for the 4 lanes in place of 4 compares.
__device__ __forceinline__ unsigned codes4(unsigned ascii, unsigned& invalid) {
  const unsigned u = ascii & 0xDFDFDFDFu;
  unsigned c = (u >> 1) & packed::kLow2;
  c ^= (c >> 1) & packed::kLow1;
  const unsigned sel = __byte_perm(c | (c >> 4), 0u, 0x4420u);
  const unsigned d = u ^ __byte_perm(0x54474341u, 0u, sel);  // "ACGT"
  invalid = ((d & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | d;  // a lane of d not 0
  return c;
}

// The reverse complement of a 2k-bit key: its codes in reverse order, each
// complemented.
__device__ __forceinline__ unsigned long long revcomp(unsigned long long key,
                                                      int k) {
  unsigned long long r = __brevll(key << (64 - 2 * k));
  r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
  return r ^ ((1ull << (2 * k)) - 1ull);
}

// Bit 7 of each byte: whether that qual (byte) of q is below thr. thr4
// holds min(thr, 255) in each byte. Where thr <= 128 no lane borrows from
// the next in (q | 0x80) - thr, and its bit 7 is set iff q mod 128 >= thr.
__device__ __forceinline__ unsigned qual_bad(unsigned q, int thr,
                                             unsigned thr4) {
  if (thr <= 128) return ~((q & 0x80808080u) | ((q | 0x80808080u) - thr4));
  return thr < 256 ? __vcmpltu4(q, thr4) : ~0u;
}

// Starts the copy of `bytes` (a multiple of 4) from src to dst, 16 bytes a
// thread on neighbouring addresses where both are 16-byte aligned.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           long long bytes) {
  const bool vec = (((uintptr_t)dst | (uintptr_t)src) & 15) == 0;
  const long long head = vec ? bytes / 16 * 16 : 0;
  for (long long i = 16 * threadIdx.x; i < head; i += 16 * kThreads)
    cp_async16((char*)dst + i, (const char*)src + i);
  for (long long i = head + 4 * threadIdx.x; i < bytes; i += 4 * kThreads)
    cp_async4((char*)dst + i, (const char*)src + i);
}

// Starts a warp's copy of reads [row0, row0 + nrows), their quals and
// lens into one of its raw buffers.
__device__ __forceinline__ void stage_step(
    unsigned char* buf, const uint8_t* __restrict__ reads,
    const uint8_t* __restrict__ quals, const int* __restrict__ lens, int L,
    long long rb, long long row0, int nrows, int lane) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const uint8_t* src = (a ? quals : reads) + row0 * L;
    const uint8_t* a0 = (const uint8_t*)((uintptr_t)src & ~(uintptr_t)15);
    const int chunks = (int)((src - a0 + (long long)nrows * L + 15) / 16);
    for (int i = lane; i < chunks; i += 32)
      cp_async16(buf + a * rb + 16 * i, a0 + 16 * i);
  }
  if (lane < nrows) cp_async4(buf + 2 * rb + 4 * lane, lens + row0 + lane);
}

// Key i of the table: from shared memory where the keys were staged.
template <bool kKeysSmem>
__device__ __forceinline__ long long table_key(const long long* s_keys,
                                               const long long* table, int i) {
  return kKeysSmem ? s_keys[i] : __ldg(table + i);
}

template <bool kKeysSmem>
__global__ void __launch_bounds__(kThreads)
window_hits_kernel(const uint8_t* __restrict__ reads,
                   const uint8_t* __restrict__ quals,
                   const int* __restrict__ lens, long long B, int L,
                   const long long* __restrict__ table, int T,
                   const int* __restrict__ index, int bits, int k, int qthr,
                   unsigned qthr4, int rw, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_idx = (int*)smem;
  long long* s_keys = (long long*)(smem + align16(4ll * ((1ll << bits) + 1)));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const WarpLayout wl = warp_layout(rw, L);
  unsigned char* mine =
      smem + warps_at(bits, T, kKeysSmem) + (long long)warp * wl.bytes;
  const int F = row_words(L);
  unsigned long long* s_fwd = (unsigned long long*)(mine + wl.packed);
  unsigned* s_bad = (unsigned*)(s_fwd + rw * F);

  // a step is rw consecutive reads; warp w of the grid takes steps w,
  // w + (warps in the grid), ...
  const long long steps = (B + rw - 1) / rw;
  const long long stride = (long long)gridDim.x * kWarps;
  long long st = (long long)blockIdx.x * kWarps + warp;
  copy_async(s_idx, index, 4ll * ((1ll << bits) + 1));
  if (kKeysSmem) copy_async(s_keys, table, 8ll * T);
  if (st < steps)
    stage_step(mine, reads, quals, lens, L, wl.rb, st * rw,
               (int)min((long long)rw, B - st * rw), lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the index and keys are in: no block barrier after

  const int W = L - k + 1;
  const int chunks = 2 * F;
  const int shift = 2 * k - bits, top = 2 * k - 2, down = 64 - 2 * k;
  const unsigned long long mask = (1ull << (2 * k)) - 1ull;
  const unsigned kmask = (1u << k) - 1u;
  constexpr int kB = kBatch<kKeysSmem>;
  const int seg = 32 / rw, r = lane / seg, sl = lane & (seg - 1);
  const int i_first = lane / chunks;  // the read of a lane's first item
  for (int it = 0; st < steps; st += stride, ++it) {
    const long long nst = st + stride;
    if (nst < steps)
      stage_step(mine + ((it + 1) & 1) * wl.buf, reads, quals, lens, L, wl.rb,
                 nst * rw, (int)min((long long)rw, B - nst * rw), lane);
    cp_async_commit();
    cp_async_wait<1>();  // this step has landed
    __syncwarp();        // for every lane; and the step before is counted

    // pack: one item is 16 bases, chunk c of read i; chunks past the read
    // fill the spare word
    const long long row0 = st * rw;
    const int nrows = (int)min((long long)rw, B - row0);
    const unsigned char* raw = mine + (it & 1) * wl.buf;
    const int dr = (int)((uintptr_t)(reads + row0 * L) & 15);
    const int dq = (int)((uintptr_t)(quals + row0 * L) & 15);
    const bool vec = dr == 0 && dq == 0 && L % 16 == 0;
    for (int t = lane; t < nrows * chunks; t += 32) {
      const int i = t < 32 ? i_first : t / chunks;
      const int c = t - i * chunks;
      unsigned a[4], q[4];
      packed::load16(raw + dr + i * L, L, c, vec, 'N', a);
      packed::load16(raw + wl.rb + dq + i * L, L, c, vec, 0u, q);
      unsigned fwd = 0, bad = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned invalid;
        const unsigned codes = codes4(a[j], invalid);
        fwd |= packed::gather2(__byte_perm(codes, 0u, 0x0123u)) << (24 - 8 * j);
        bad |= packed::lane_bits((invalid | qual_bad(q[j], qthr, qthr4)) >> 7)
               << (4 * j);
      }
      // a 64-bit word holds chunk 2q in its high half
      ((unsigned*)(s_fwd + i * F))[c ^ 1] = fwd;
      ((unsigned short*)(s_bad + i * F))[c] = (unsigned short)bad;
    }
    const int len = r < nrows ? ((const int*)(raw + 2 * wl.rb))[r] : 0;
    __syncwarp();

    // windows: `seg` lanes a read; lane j of a read's segment takes the
    // span [j s, j s + s) of its nw windows
    unsigned found = 0;
    const int nw = min(W, len - k);
    const int span = (nw + seg - 1) / seg;
    const unsigned long long* f = s_fwd + r * F;
    const unsigned* bm = s_bad + r * F;
    const int w1 = min(nw, (sl + 1) * span);
    for (int c0 = sl * span; c0 < w1; c0 += 32) {
      // fk, rk and run start as the window before c0 would leave them (its
      // first base is never looked at), so that every window rolls: a
      // base's 2-bit code comes from `next` (bases c0 + k - 1 onwards),
      // its bad bit from `nb`; `run` counts the good bases ending the
      // window.
      const int e0 = c0 + k - 1;
      unsigned long long fk =
          packed::field(f[c0 >> 5], f[(c0 >> 5) + 1], 2 * (c0 & 31)) >> down;
      unsigned long long rk = (revcomp(fk, k) << 2) & mask;
      fk >>= 2;
      unsigned long long next =
          packed::field(f[e0 >> 5], f[(e0 >> 5) + 1], 2 * (e0 & 31));
      const unsigned m = __funnelshift_r(bm[c0 >> 5], bm[(c0 >> 5) + 1],
                                         c0 & 31) & (kmask >> 1);
      int run = m ? k - 33 + __clz(m) : k - 1;
      unsigned nb = __funnelshift_r(bm[e0 >> 5], bm[(e0 >> 5) + 1], e0 & 31);
      const int c1 = min(c0 + 32, w1);
      for (int b0 = c0; b0 < c1; b0 += kB) {
        // kB windows' keys and table ranges; then each range's first
        // key, which settles a range of one; then a search of the rest in
        // lockstep, up to kB independent loads in flight a step
        long long key[kB];
        int lo[kB], hi[kB];
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const unsigned long long code = next >> 62;
          next <<= 2;
          fk = ((fk << 2) | code) & mask;
          rk = (rk >> 2) | ((3ull - code) << top);
          run = nb & 1u ? 0 : run + 1;
          nb >>= 1;
          key[u] = (long long)(fk < rk ? fk : rk);
          const int p = (int)(key[u] >> shift);
          const bool good = b0 + u < c1 && run >= k;
          lo[u] = good ? s_idx[p] : 0;
          hi[u] = good ? s_idx[p + 1] : 0;
        }
        unsigned pending = 0;
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const bool act = lo[u] < hi[u];
          const long long x =
              act ? table_key<kKeysSmem>(s_keys, table, lo[u]) : ~key[u];
          found += x == key[u];
          ++lo[u];
          pending |= (unsigned)(x < key[u] && lo[u] < hi[u]) << u;
        }
        while (pending) {
          unsigned still = 0;
#pragma unroll
          for (int u = 0; u < kB; ++u) {
            const bool act = (pending >> u) & 1u;
            const int mid = (lo[u] + hi[u]) >> 1;
            const long long x =
                act ? table_key<kKeysSmem>(s_keys, table, mid) : ~key[u];
            found += x == key[u];
            lo[u] = x < key[u] ? mid + 1 : lo[u];
            hi[u] = x > key[u] ? mid : hi[u];
            still |= (unsigned)(act && x != key[u] && lo[u] < hi[u]) << u;
          }
          pending = still;
        }
      }
    }
    for (int o = seg >> 1; o > 0; o >>= 1)
      found += __shfl_xor_sync(kFull, found, o);
    if (r < nrows && sl == 0) out[row0 + r] = (int)found;
  }
  cp_async_wait<0>();
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, const int*,
                        long long, int, const long long*, int, const int*,
                        int, int, int, unsigned, int, int*);

// The kernel of one kind and how many of its blocks the current card holds
// at once with `smem` bytes of shared memory. The opt-in to more than 48 KB
// is made once a card and kind; the occupancy query once a card, kind and
// size (it takes longer than a launch).
cudaError_t resident(int keys_smem, long long smem, Kernel& kernel,
                     long long& blocks) {
  struct Entry {
    long long smem, blocks;
  };
  static bool opted[RT_MAX_DEVICES][2] = {};
  static Entry cache[RT_MAX_DEVICES][2][kResidentCache] = {};
  static int next[RT_MAX_DEVICES][2] = {};
  int dev = 0, sms = 0;
  cudaError_t e = rt_current_card(dev, sms);
  if (e != cudaSuccess) return e;
  kernel = keys_smem ? window_hits_kernel<true> : window_hits_kernel<false>;
  if (!opted[dev][keys_smem]) {
    int optin = 0;
    if ((e = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (e = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
            cudaSuccess)
      return e;
    opted[dev][keys_smem] = true;
  }
  Entry* c = cache[dev][keys_smem];
  for (int i = 0; i < kResidentCache; ++i)
    if (c[i].smem == smem) {
      blocks = c[i].blocks;
      return cudaSuccess;
    }
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, (size_t)smem)) != cudaSuccess)
    return e;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  blocks = (long long)sms * per_sm;
  c[next[dev][keys_smem]] = {smem, blocks};
  next[dev][keys_smem] = (next[dev][keys_smem] + 1) % kResidentCache;
  return cudaSuccess;
}

}  // namespace

// reads, quals: (B, L) uint8; lens: (B,) int32; table: (T,) sorted int64;
// index: (2^bits + 1,) int32, hashlist_index's; out: (B,) int32. The
// caller picks `rw` reads a warp step (1, 2 or 4) and whether the keys go
// to shared memory (keys_smem), so that block_bytes(...) fits a block.
extern "C" int rt_window_hits(const uint8_t* reads, const uint8_t* quals,
                              const int* lens, long long B, int L,
                              const long long* table, int T, const int* index,
                              int bits, int k, int min_q, int rw,
                              int keys_smem, int* out, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const long long smem = block_bytes(bits, T, keys_smem, rw, L);
  Kernel kernel;
  long long resident_blocks = 0;
  const cudaError_t e = resident(keys_smem, smem, kernel, resident_blocks);
  if (e != cudaSuccess) return (int)e;
  // bad iff qual < min_q + 33
  const int thr = std::min(std::max(min_q + 33, 0), 256);
  const unsigned qthr4 = (unsigned)std::min(thr, 255) * 0x01010101u;
  const long long steps = (B + rw - 1) / rw;
  const long long grid =
      std::min((steps + kWarps - 1) / kWarps, resident_blocks);
  kernel<<<(unsigned)grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      reads, quals, lens, B, L, table, T, index, bits, k, thr, qthr4, rw, out);
  return (int)cudaGetLastError();
}
