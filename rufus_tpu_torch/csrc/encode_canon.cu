// encode_canon: (B, L) ASCII reads -> (B, W) canonical int64 k-mer keys.
//
// Replaces the Pallas kernel rufus_tpu/ops/pallas_count.py:encode_canon_hilo
// (which wrote (hi, lo) u32 planes because the TPU has no 64-bit lanes).
// Here a key is one int64, INT64_MAX for a window with any non-ACGT base.
//
// Bound: bytes (read B*L, write 8*B*W; the output is 87% of them), with the
// integer work close behind. The design, for this card:
//
//   pack   A block takes `rows` reads. A thread loads 16 bases (one 16-byte
//          load where L and the pointer allow, bytes otherwise; the helpers
//          shared with window_hits.cu are in csrc/packed.cuh) and turns
//          them, four at a time in a 32-bit register, into 32 bits of 2-bit
//          codes, 32 bits of complement codes in reverse order, and 16
//          bad-base bits. Shared memory then holds, per read, the codes
//          packed first-base-highest in 64-bit words, a second packed copy
//          of the reverse complement, and the bad-base mask.
//   window Thread t computes output elements 2t and 2t+1 of the block's
//          contiguous span. A window's forward key is the 2k-bit field at
//          base w of the first copy, its reverse-complement key the field
//          at base R-k-w of the second (R = the padded row length): two
//          words, two shifts and an or each, no prologue and no loop over
//          k. The window is the sentinel if any of the mask's k bits at w
//          is set.
//   store  One 16-byte store a thread on neighbouring addresses; an odd
//          first or last element of the span goes out alone.
//
// The other candidate, keeping the rolling recurrence with a
// staged output tile, does k-1 steps of prologue per thread or serialises
// a whole read in one thread; the field extraction needs neither.

#include "packed.cuh"

namespace {

using packed::field;
using packed::gather2;
using packed::kLow1;
using packed::kLow2;
using packed::row_words;

constexpr int kThreads = 256;

// Four ASCII bases (the first in the lowest byte) -> 8 bits of codes with
// the first base highest, 8 bits of complement codes with the last base
// highest, 4 bad-base bits with the first base lowest. The same arithmetic
// as ops/codec.encode_bases, four lanes at a time.
__device__ __forceinline__ void pack4(unsigned ascii, unsigned& fwd,
                                      unsigned& rc, unsigned& bad) {
  const unsigned u = ascii & 0xDFDFDFDFu;
  const unsigned ok = __vcmpeq4(u, 0x41414141u) | __vcmpeq4(u, 0x43434343u) |
                      __vcmpeq4(u, 0x47474747u) | __vcmpeq4(u, 0x54545454u);
  unsigned c = (u >> 1) & kLow2;
  c ^= (c >> 1) & kLow1;
  fwd = gather2(__byte_perm(c, 0u, 0x0123u));
  rc = gather2(c ^ kLow2);
  bad = packed::lane_bits(~ok);
}

__global__ void __launch_bounds__(kThreads)
encode_canon_kernel(const uint8_t* __restrict__ reads, long long B, int L,
                    int k, int rows, int vec, long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int F = row_words(L);
  unsigned long long* s_fwd = smem;             // rows * F
  unsigned long long* s_rc = smem + rows * F;   // rows * F
  unsigned* s_bad = (unsigned*)(smem + 2 * rows * F);  // rows * F
  const int W = L - k + 1;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, B - row0);
  const uint8_t* src = reads + row0 * L;

  // pack: one item is 16 bases, chunk c of read r; chunks past the read
  // fill the spare word. A 64-bit word holds chunk 2q in its high half, so
  // chunk c lands in 32-bit slot c ^ 1.
  const int chunks = 2 * F, real = chunks - 2;
  for (int t = threadIdx.x; t < nrows * chunks; t += kThreads) {
    const int r = t / chunks, c = t - r * chunks;
    unsigned a[4];
    packed::load16(src + (long long)r * L, L, c, vec, 'N', a);
    unsigned fwd = 0, rc = 0, bad = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned f4, r4, b4;
      pack4(a[i], f4, r4, b4);
      fwd |= f4 << (24 - 8 * i);
      rc |= r4 << (8 * i);
      bad |= b4 << (4 * i);
    }
    // base p sits at base R-1-p of the reverse copy, R = 16 * real
    const int cr = c < real ? real - 1 - c : c;
    ((unsigned*)(s_fwd + r * F))[c ^ 1] = fwd;
    ((unsigned*)(s_rc + r * F))[cr ^ 1] = rc;
    ((unsigned short*)(s_bad + r * F))[c] = (unsigned short)bad;
  }
  __syncthreads();

  const int R = 16 * real;
  const int down = 64 - 2 * k;
  const unsigned kmask = (1u << k) - 1u;
  auto window = [&](int r, int w) -> long long {
    const unsigned long long* f = s_fwd + r * F + (w >> 5);
    const int v = R - k - w;
    const unsigned long long* g = s_rc + r * F + (v >> 5);
    const unsigned* b = s_bad + r * F + (w >> 5);
    const unsigned long long fk = field(f[0], f[1], 2 * (w & 31)) >> down;
    const unsigned long long rk = field(g[0], g[1], 2 * (v & 31)) >> down;
    const unsigned any = __funnelshift_r(b[0], b[1], w & 31) & kmask;
    return any ? RT_SENTINEL : (long long)(fk < rk ? fk : rk);
  };

  // the block's output is one contiguous span; pairs start at an even
  // element of the whole output so that each is one aligned 16-byte store
  long long* dst = out + row0 * W;
  const int total = nrows * W;
  const int odd = (int)((row0 * W) & 1);
  const int pairs = (total - odd) / 2;
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int e = odd + 2 * p;
    const int r = e / W, w = e - r * W;
    longlong2 v;
    v.x = window(r, w);
    v.y = w + 1 < W ? window(r, w + 1) : window(r + 1, 0);
    *(longlong2*)(dst + e) = v;
  }
  if (threadIdx.x == 0 && odd) dst[0] = window(0, 0);
  if (threadIdx.x == 32 && ((total - odd) & 1))
    dst[total - 1] = window(nrows - 1, W - 1);
}

}  // namespace

extern "C" int rt_encode_canon(const uint8_t* reads, long long B, int L,
                               int k, int rows, long long* out,
                               void* stream) {
  if (B > 0) {
    const long long blocks = (B + rows - 1) / rows;
    const int vec = L % 16 == 0 && ((uintptr_t)reads & 15u) == 0;
    const size_t smem = (size_t)rows * row_words(L) * 20;
    encode_canon_kernel<<<(unsigned)blocks, kThreads, smem,
                          (cudaStream_t)stream>>>(reads, B, L, k, rows, vec,
                                                  out);
  }
  return (int)cudaGetLastError();
}
