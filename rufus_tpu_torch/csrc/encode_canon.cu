// encode_canon: (B, L) ASCII reads -> (B, W) canonical int64 k-mer keys.
//
// Replaces the Pallas kernel rufus_tpu/ops/pallas_count.py:encode_canon_hilo
// (which wrote (hi, lo) u32 planes because the TPU has no 64-bit lanes).
// Here a key is one int64, INT64_MAX for a window with any non-ACGT base.
//
// Bound: bytes (read B*L, write 8*B*W). A block stages `rows` reads as
// 2-bit codes in shared memory with coalesced loads; each thread then
// rolls the forward and reverse-complement keys over a run of S windows
// of one read, so a window costs a few integer operations instead of k.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 8;  // windows rolled by one thread

__global__ void encode_canon_kernel(const uint8_t* __restrict__ reads,
                                    long long B, int L, int k, int rows,
                                    long long* __restrict__ out) {
  extern __shared__ int8_t codes[];  // rows * L
  const int W = L - k + 1;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, B - row0);
  const uint8_t* src = reads + row0 * L;
  for (int i = threadIdx.x; i < nrows * L; i += blockDim.x)
    codes[i] = (int8_t)rt_base_code(src[i]);
  __syncthreads();

  const unsigned long long mask = (1ull << (2 * k)) - 1ull;
  const int shift = 2 * (k - 1);
  const int per_row = (W + kSpan - 1) / kSpan;
  long long* dst = out + row0 * W;
  for (int t = threadIdx.x; t < nrows * per_row; t += blockDim.x) {
    const int r = t / per_row;
    const int w0 = (t - r * per_row) * kSpan;
    const int w1 = min(w0 + kSpan, W);
    const int8_t* c = codes + r * L;
    unsigned long long fwd = 0, rc = 0;
    int run = 0;  // consecutive ACGT bases ending at p
    for (int p = w0; p < w1 + k - 1; ++p) {
      const int b = c[p];
      rt_roll(fwd, rc, (unsigned long long)(b & 3), mask, shift);
      run = b >= 0 ? run + 1 : 0;
      if (p >= w0 + k - 1) {
        const unsigned long long canon = fwd < rc ? fwd : rc;
        dst[(long long)r * W + (p - k + 1)] =
            run >= k ? (long long)canon : RT_SENTINEL;
      }
    }
  }
}

}  // namespace

extern "C" int rt_encode_canon(const uint8_t* reads, long long B, int L,
                               int k, int rows, long long* out,
                               void* stream) {
  if (B > 0) {
    const long long blocks = (B + rows - 1) / rows;
    encode_canon_kernel<<<(unsigned)blocks, kThreads, (size_t)rows * L,
                          (cudaStream_t)stream>>>(reads, B, L, k, rows, out);
  }
  return (int)cudaGetLastError();
}
