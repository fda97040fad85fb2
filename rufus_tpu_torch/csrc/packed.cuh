// Reads packed as 2-bit codes in shared memory: the helpers encode_canon.cu
// and window_hits.cu share.
//
// A row of L bases is held in row_words(L) 64-bit words of codes, first
// base highest (A0 C1 G2 T3), beside one bad-base bit a base, first base
// lowest. A thread packs 16 bases at a time, four to a 32-bit register; a
// window's key is then a 2k-bit field of the codes.
#pragma once

#include "common.cuh"

namespace packed {

constexpr unsigned kLow2 = 0x03030303u, kLow1 = 0x01010101u;

// 64-bit words of packed codes per read: the bases, plus one word so that
// a field may always read the word after its first.
__host__ __device__ inline int row_words(int L) { return (L + 31) / 32 + 1; }

// The byte v of each of the 4 lanes of x gathered into one byte, 2 bits a
// lane, the lowest lane in the lowest bits.
__device__ __forceinline__ unsigned gather2(unsigned x) {
  return (x | (x >> 6) | (x >> 12) | (x >> 18)) & 0xFFu;
}

// Bit 0 of each of the 4 lanes of x gathered into 4 bits, the lowest lane
// lowest.
__device__ __forceinline__ unsigned lane_bits(unsigned x) {
  const unsigned b = x & kLow1;
  return (b | (b >> 7) | (b >> 14) | (b >> 21)) & 0xFu;
}

// The top 64 bits of (hi:lo) << s, 0 <= s <= 62.
__device__ __forceinline__ unsigned long long field(unsigned long long hi,
                                                    unsigned long long lo,
                                                    int s) {
  return (hi << s) | ((lo >> 1) >> (63 - s));
}

// Bytes 16c .. 16c+15 of a row of L bytes into a[0..3], the first byte in
// the lowest bits of a[0]; bytes past L read as `pad`. One 16-byte load
// when vec (the row is 16-byte aligned) and the chunk lies inside L.
__device__ __forceinline__ void load16(const uint8_t* __restrict__ row, int L,
                                       int c, bool vec, unsigned pad,
                                       unsigned a[4]) {
  if (vec && 16 * c + 16 <= L) {
    const uint4 v = *(const uint4*)(row + 16 * c);
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 16 * c + 4 * i + j;
      a[i] |= (p < L ? (unsigned)row[p] : pad) << (8 * j);
    }
  }
}

}  // namespace packed
