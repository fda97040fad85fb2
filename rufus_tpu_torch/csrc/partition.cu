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
// One CUDA block per 8192-key block: it stages the keys in 64 KB of
// dynamic shared memory (a partial last block is padded with the sentinel
// there, and the padding is never written out), sorts them with a bitonic
// network, finds where each bucket's run starts, and writes each key to
// cursors[block][bucket] + its rank in the run. The cursors (a bucket-major
// exclusive scan of the per-(block, bucket) counts) come from the wrapper,
// as the JAX tool computed its run metadata in XLA outside the kernel.
//
// Bound: bytes (8n read, 8n written). The network's 91 compare-exchange
// stages stay in shared memory; one __syncthreads() separates each stage.

#include "common.cuh"

namespace {

constexpr int kBlock = 8192;
constexpr int kThreads = 1024;
constexpr int kBuckets = 16;

__device__ __forceinline__ int bucket_of(long long key, int shift) {
  if (key < 0) return 0;
  const long long b = key >> shift;
  return b < kBuckets - 1 ? (int)b : kBuckets - 1;
}

__global__ void __launch_bounds__(kThreads)
    partition_kernel(const long long* __restrict__ keys, long long n,
                     int shift, const long long* __restrict__ cursors,
                     long long* __restrict__ out) {
  extern __shared__ long long s[];
  __shared__ int start[kBuckets];
  const long long base = (long long)blockIdx.x * kBlock;
  const int valid = (int)min((long long)kBlock, n - base);
  for (int i = threadIdx.x; i < kBlock; i += kThreads)
    s[i] = i < valid ? keys[base + i] : RT_SENTINEL;
  __syncthreads();

  // Bitonic sort, ascending. Pair t of a stage joins lo (t with a zero bit
  // inserted at `stride`) and hi = lo + stride; the pair sorts up where
  // lo's `size` bit is clear (always, in the last merge).
  for (int size = 2; size <= kBlock; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < kBlock / 2; t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const long long a = s[lo], b = s[hi];
        const bool up = (lo & size) == 0;
        if (up ? a > b : a < b) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // The padding sorts last, so the block's keys are s[0 .. valid). Buckets
  // absent from the block get no start, and no key reads theirs.
  for (int i = threadIdx.x; i < valid; i += kThreads) {
    const int b = bucket_of(s[i], shift);
    if (i == 0 || bucket_of(s[i - 1], shift) != b) start[b] = i;
  }
  __syncthreads();
  const long long* cur = cursors + (long long)blockIdx.x * kBuckets;
  for (int i = threadIdx.x; i < valid; i += kThreads) {
    const long long key = s[i];
    const int b = bucket_of(key, shift);
    out[cur[b] + (i - start[b])] = key;
  }
}

}  // namespace

// keys, out: n int64 each; cursors: ceil(n / 8192) x 16 int64, where the
// run of bucket b of block j starts in out.
extern "C" int rt_partition(const long long* keys, long long n, int shift,
                            const long long* cursors, long long* out,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    const int smem = kBlock * (int)sizeof(long long);
    // above 48 KB of dynamic shared memory only after this opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        partition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (n + kBlock - 1) / kBlock;
    partition_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(keys, n, shift,
                                                              cursors, out);
  }
  return (int)cudaGetLastError();
}
