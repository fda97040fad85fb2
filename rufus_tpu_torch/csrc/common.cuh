// Shared device helpers for the rufus_tpu_torch kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Invalid-window sentinel (INT64_MAX): sorts after every key of k <= 31.
#define RT_SENTINEL 0x7FFFFFFFFFFFFFFFLL

// ASCII base -> 2-bit code, A0 C1 G2 T3 (lowercase accepted), -1 if not
// ACGT. The same arithmetic as ops/codec.encode_bases.
__device__ __forceinline__ int rt_base_code(uint8_t ch) {
  unsigned u = ch & 0xDFu;
  bool valid = (u == 65u) | (u == 67u) | (u == 71u) | (u == 84u);
  unsigned code = (u >> 1) & 3u;
  code = code >= 2u ? (code ^ 1u) : code;
  return valid ? (int)code : -1;
}

// One step of the rolling canonical pack: append base code v (0..3) to the
// forward key and prepend its complement to the reverse-complement key.
// mask keeps the low 2k bits; shift = 2(k-1).
__device__ __forceinline__ void rt_roll(unsigned long long& fwd,
                                        unsigned long long& rc,
                                        unsigned long long v,
                                        unsigned long long mask, int shift) {
  fwd = ((fwd << 2) | v) & mask;
  rc = (rc >> 2) | ((3ull - v) << shift);
}
