// unpack: packed transport planes -> the ASCII read and quality batch.
//
// Replaces the jit program rufus_tpu/ops/pack.py:66-91 (unpack_reads_device
// and unpack_qual_device), not a Pallas kernel: the JAX package packs reads
// into 2-bit codes plus a 1-bit N mask, and quals into a 1-bit "passes
// min_q" plane, so that fewer bytes cross to the device, and unpacks them
// there with a few fused u8 ops.
//
// Base j of a read is the 2-bit code in bits 2*(j%4) of byte j/4 of its
// packed row; its N bit is bit j%8 of byte j/8 of its mask row (numpy's
// packbits, little bit order). The read byte is 'N' where the N bit is set,
// else "ACGT"[code]; the qual byte is 'I' where the ok bit is set, else '#'.
//
// Bound: bytes. A read of L bases reads ceil(L/4) + ceil(L/8) bytes (and
// ceil(L/8) more for quals) and writes L (and L); the arithmetic is a few
// shifts and selects a byte. The design: the (B, L) outputs are one
// contiguous span each, so thread t owns output bytes [16t, 16t + 16) of
// the span whatever L is, whether or not a row ends inside them, and
// writes them with one 16-byte store (bytes only for the span's last,
// short group). It finds its row and column with one division, then walks
// the 16 bytes, moving to the next row where one ends; its input bytes are
// re-read from L1 by neighbouring bytes of the group. Both planes come from
// one launch when both are asked for (a null pointer skips a plane).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;  // output bytes a thread writes

__device__ __forceinline__ void store_group(uint8_t* dst, const unsigned* w,
                                            int n, bool vec) {
  if (n == kGroup && vec) {
    *(uint4*)dst = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i)  // unrolled: w stays in registers
    if (i < n) dst[i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
}

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint8_t* __restrict__ packed,
              const uint8_t* __restrict__ nmask,
              const uint8_t* __restrict__ okmask, long long total, int L,
              int P4, int P8, int vec, uint8_t* __restrict__ reads,
              uint8_t* __restrict__ quals) {
  const long long e0 = ((long long)blockIdx.x * kThreads + threadIdx.x) *
                       kGroup;
  if (e0 >= total) return;
  const int n = (int)min((long long)kGroup, total - e0);
  long long b = e0 / L;
  int j = (int)(e0 - b * L);
  unsigned r[4] = {0u, 0u, 0u, 0u}, q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    if (i < n) {
      const int sh = 8 * (i & 3);
      if (reads) {
        const unsigned code = (packed[b * P4 + (j >> 2)] >> (2 * (j & 3))) & 3u;
        const unsigned bad = (nmask[b * P8 + (j >> 3)] >> (j & 7)) & 1u;
        // "ACGT" as one little-endian word: byte `code` is the base
        const unsigned base = bad ? (unsigned)'N'
                                  : (0x54474341u >> (8 * code)) & 0xFFu;
        r[i >> 2] |= base << sh;
      }
      if (quals) {
        const unsigned ok = (okmask[b * P8 + (j >> 3)] >> (j & 7)) & 1u;
        q[i >> 2] |= (ok ? (unsigned)'I' : (unsigned)'#') << sh;
      }
      if (++j == L) {
        j = 0;
        ++b;
      }
    }
  }
  if (reads) store_group(reads + e0, r, n, vec);
  if (quals) store_group(quals + e0, q, n, vec);
}

}  // namespace

// packed (B, ceil(L/4)), nmask and okmask (B, ceil(L/8)) uint8, contiguous;
// reads and quals (B, L) uint8. Pass packed, nmask and reads null to skip
// the reads, okmask and quals null to skip the quals.
extern "C" int rt_unpack(const uint8_t* packed, const uint8_t* nmask,
                         const uint8_t* okmask, long long B, int L,
                         uint8_t* reads, uint8_t* quals, void* stream) {
  const long long total = B * (long long)L;
  if (total > 0) {
    const long long groups = (total + kGroup - 1) / kGroup;
    const long long blocks = (groups + kThreads - 1) / kThreads;
    const int vec = ((uintptr_t)reads & 15u) == 0 && ((uintptr_t)quals & 15u) == 0;
    unpack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        packed, nmask, okmask, total, L, (L + 3) / 4, (L + 7) / 8, vec, reads,
        quals);
  }
  return (int)cudaGetLastError();
}
