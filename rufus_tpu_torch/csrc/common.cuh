// Shared device helpers for the rufus_tpu_torch kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Invalid-window sentinel (INT64_MAX): sorts after every key of k <= 31.
#define RT_SENTINEL 0x7FFFFFFFFFFFFFFFLL

constexpr int RT_MAX_DEVICES = 64;

// The current card and its SM count (asked once a card).
inline cudaError_t rt_current_card(int& dev, int& sms) {
  static int cache[RT_MAX_DEVICES] = {};
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= RT_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[dev] == 0 &&
      (e = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  sms = cache[dev];
  return cudaSuccess;
}

// cp.async: a copy from global to shared memory that the issuing thread
// does not wait for; commit closes a group of them, wait<N> waits until at
// most N groups are still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}
