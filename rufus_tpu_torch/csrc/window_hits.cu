// window_hits: per read, the number of k-mer windows that pass RUFUS.Filter's
// streak rule and whose canonical key is in the sorted mutant HashList.
//
// Replaces the Pallas kernel rufus_tpu/ops/pallas_filter.py:pallas_window_hits,
// which compared every window with every table entry in an unrolled loop
// (so the JAX package sent tables above 1024 keys to a Bloom filter plus
// host verification). Here membership is a binary search in the sorted
// int64 table, exact for any T: the table sits in shared memory when it
// fits beside the staged reads, else it is read from global memory through
// the read-only cache.
//
// A base is good iff it is ACGT (either case), qual - 33 >= min_q and its
// position is below the read's length. A window ending at position p is
// scanned iff its k bases are all good and p <= len - 2 (the reference
// never examines the window ending at the last base).
//
// Bound: bytes (reads and quals, 2*B*L, dominate). A block stages `rows`
// reads as good-base codes in shared memory with coalesced loads; each
// thread rolls the canonical key over a run of windows of one read.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 8;

template <bool kSmemTable>
__global__ void window_hits_kernel(const uint8_t* __restrict__ reads,
                                   const uint8_t* __restrict__ quals,
                                   const int* __restrict__ lens, long long B,
                                   int L, const long long* __restrict__ table,
                                   long long T, int k, int min_q, int rows,
                                   int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* tab = (long long*)smem;
  int* hits = (int*)(smem + (kSmemTable ? T * sizeof(long long) : 0));
  int8_t* codes = (int8_t*)(hits + rows);

  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, B - row0);
  if (kSmemTable)
    for (long long i = threadIdx.x; i < T; i += blockDim.x) tab[i] = table[i];
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) hits[r] = 0;
  for (int i = threadIdx.x; i < nrows * L; i += blockDim.x) {
    const int r = i / L, p = i - r * L;
    const long long g = row0 * L + i;
    const int b = rt_base_code(reads[g]);
    const bool good =
        b >= 0 && (int)quals[g] - 33 >= min_q && p < lens[row0 + r];
    codes[i] = (int8_t)(good ? b : -1);
  }
  __syncthreads();

  const long long* tb = kSmemTable ? tab : table;
  const unsigned long long mask = (1ull << (2 * k)) - 1ull;
  const int shift = 2 * (k - 1);
  const int W = L - k + 1;
  const int per_row = (W + kSpan - 1) / kSpan;
  for (int t = threadIdx.x; t < nrows * per_row; t += blockDim.x) {
    const int r = t / per_row;
    const int w0 = (t - r * per_row) * kSpan;
    const int w1 = min(w0 + kSpan, W);
    const int len = lens[row0 + r];
    const int8_t* c = codes + r * L;
    unsigned long long fwd = 0, rc = 0;
    int run = 0;
    int found = 0;
    for (int p = w0; p < w1 + k - 1; ++p) {
      const int b = c[p];
      rt_roll(fwd, rc, (unsigned long long)(b & 3), mask, shift);
      run = b >= 0 ? run + 1 : 0;
      if (p >= w0 + k - 1 && run >= k && p <= len - 2 && T > 0) {
        const long long key = (long long)(fwd < rc ? fwd : rc);
        long long lo = 0, hi = T;
        while (lo < hi) {
          const long long mid = (lo + hi) >> 1;
          const long long v = kSmemTable ? tb[mid] : __ldg(tb + mid);
          if (v < key)
            lo = mid + 1;
          else
            hi = mid;
        }
        if (lo < T && (kSmemTable ? tb[lo] : __ldg(tb + lo)) == key) ++found;
      }
    }
    if (found) atomicAdd(&hits[r], found);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) out[row0 + r] = hits[r];
}

}  // namespace

// Launch with the table in shared memory when smem_table != 0 (the caller
// checked that T * 8 + rows * (L + 4) bytes fit the block's limit).
extern "C" int rt_window_hits(const uint8_t* reads, const uint8_t* quals,
                              const int* lens, long long B, int L,
                              const long long* table, long long T, int k,
                              int min_q, int rows, int smem_table, int* out,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B > 0) {
    const long long blocks = (B + rows - 1) / rows;
    size_t smem = (size_t)rows * sizeof(int) + (size_t)rows * L;
    if (smem_table) {
      smem += (size_t)T * sizeof(long long);
      cudaFuncSetAttribute(window_hits_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      window_hits_kernel<true><<<(unsigned)blocks, kThreads, smem, st>>>(
          reads, quals, lens, B, L, table, T, k, min_q, rows, out);
    } else {
      window_hits_kernel<false><<<(unsigned)blocks, kThreads, smem, st>>>(
          reads, quals, lens, B, L, table, T, k, min_q, rows, out);
    }
  }
  return (int)cudaGetLastError();
}
