// sw_batch: batched local affine-gap Smith-Waterman, the full H matrix, the
// best score and the first best cell of each (query, window) pair.
//
// Replaces the JAX device program rufus_tpu/align/sw_device.py:_sw_batch (a
// jitted lax.scan over query rows, not a Pallas kernel), which read and
// contig alignment both run through Aligner._align_group. The contract is
// bit-identity with it: H (B, n+1, m+1) int32 including the padded rows and
// columns, the best score, and the first maximum of the row-major H as
// (i, j), (0, 0, 0) for an all-zero H. Codes are 0-3, 255 = N or padding,
// which never matches. Each row i (query base i-1) is
//
//   F[j]    = max(F[j] - ext, H[i-1][j] - open - ext)          (vertical gap)
//   cand[j] = max(H[i-1][j-1] + sub(i, j), F[j], 0),  cand[0] = 0
//   H[i][j] = max(cand[j], max_{t<j}(cand[t] + ext*t) - open - ext*j)
//
// the last term being the horizontal gap in the closed form of the JAX
// program (a running max, no chain of gaps), which ties with one longer gap
// when ext = 0 (the MOB scoring) and so gives the same H.
//
// Bound: bytes. The function must write 4(n+1)(m+1) bytes of H a pair and
// read n+m bytes of codes; the DP's integer work is a few operations a cell,
// far below what the card issues in that time. The design, a simple one:
//
//   block  one block a pair; a thread owns a contiguous chunk of the m+1
//          columns (chunk = ceil((m+1)/1024), threads a multiple of 32), so
//          any m runs.
//   state  the previous and the current row (double-buffered) and F, one
//          int32 each a column, in shared memory, or, past 17,066 columns,
//          in a global workspace the wrapper allocates.
//   row    pass 1 computes cand and F over the chunk and the chunk's max of
//          cand[t] + ext*t; a warp-shuffle scan and the warps' totals give
//          each thread the exclusive max over the columns before its chunk;
//          pass 2 applies the horizontal-gap term. The row then goes to H
//          with coalesced int32 stores, after the barrier that also
//          publishes it as the next row's previous row: two barriers a row.
//   best   each thread keeps its first maximum (strictly greater replaces,
//          rows and its columns in order); a block reduction takes the
//          largest score and, among equals, the smallest flat index.
//
// Later work (not here): a warp a pair for reads, and the traceback on the
// card so that H never crosses to the host.

#include "common.cuh"

#include <climits>

namespace {

constexpr int kNeg = -1000000;           // F's start, as in the JAX program
constexpr int kMinusInf = INT_MIN / 2;   // the empty max, never written out
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(1024)
sw_batch_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ r,
                int n, int m, int match, int mismatch, int gap_open,
                int gap_ext, int chunk, int* __restrict__ H,
                int* __restrict__ best_score, int* __restrict__ best_i,
                int* __restrict__ best_j, int* __restrict__ workspace) {
  extern __shared__ int smem[];
  __shared__ int s_warp[32];
  __shared__ int s_score[32];
  __shared__ long long s_flat[32];

  const long long b = blockIdx.x;
  const int M = m + 1;
  const int T = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* rows = workspace ? workspace + b * 3 * M : smem;
  int* prev = rows;
  int* cur = rows + M;
  int* F = rows + 2 * M;
  const uint8_t* qb = q + b * n;
  const uint8_t* rb = r + b * m;
  int* Hb = H + b * (long long)(n + 1) * M;

  const int j0 = min(tid * chunk, M);
  const int j1 = min(j0 + chunk, M);
  for (int j = j0; j < j1; ++j) {
    prev[j] = 0;
    F[j] = kNeg;
  }
  for (int j = tid; j < M; j += T) Hb[j] = 0;
  __syncthreads();

  const int oe = gap_open + gap_ext;
  int bs = 0;
  long long bflat = 0;
  for (int i = 1; i <= n; ++i) {
    const int qi = qb[i - 1];
    // pass 1: cand, F, and the chunk's max of cand[t] + ext*t
    int run = kMinusInf;
    for (int j = j0; j < j1; ++j) {
      int cand = 0;
      if (j > 0) {
        const int f = max(F[j] - gap_ext, prev[j] - oe);
        F[j] = f;
        const int rc = rb[j - 1];
        const int sub = (qi == rc && qi != 255 && rc != 255) ? match
                                                             : mismatch;
        cand = max(max(prev[j - 1] + sub, f), 0);
      }
      cur[j] = cand;
      run = max(run, cand + gap_ext * j);
    }
    // the exclusive max over every column before this thread's chunk
    int incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, v);
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = kMinusInf;
    for (int w = 0; w < warp; ++w) excl = max(excl, s_warp[w]);
    // pass 2: the horizontal gap; the best cell
    const long long rowflat = (long long)i * M;
    for (int j = j0; j < j1; ++j) {
      const int cand = cur[j];
      const int v = j > 0 ? max(cand, excl - oe - gap_ext * (j - 1)) : 0;
      cur[j] = v;
      if (v > bs) {
        bs = v;
        bflat = rowflat + j;
      }
      excl = max(excl, cand + gap_ext * j);
    }
    __syncthreads();
    int* Hrow = Hb + rowflat;
    for (int j = tid; j < M; j += T) Hrow[j] = cur[j];
    int* t = prev;
    prev = cur;
    cur = t;
  }

  // the largest score; among equal scores the smallest flat index
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int os = __shfl_down_sync(kFull, bs, d);
    const long long of = __shfl_down_sync(kFull, bflat, d);
    if (os > bs || (os == bs && of < bflat)) {
      bs = os;
      bflat = of;
    }
  }
  if (lane == 0) {
    s_score[warp] = bs;
    s_flat[warp] = bflat;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < T / 32; ++w) {
      if (s_score[w] > bs || (s_score[w] == bs && s_flat[w] < bflat)) {
        bs = s_score[w];
        bflat = s_flat[w];
      }
    }
    best_score[b] = bs;
    best_i[b] = (int)(bflat / M);
    best_j[b] = (int)(bflat % M);
  }
}

}  // namespace

// threads: a multiple of 32, at most 1024, with threads * chunk >= m + 1.
// workspace: null to keep the rows in shared memory (12 (m+1) bytes), else
// B * 3 * (m+1) int32 of device memory.
extern "C" int rt_sw_batch(const uint8_t* q, const uint8_t* r, long long B,
                           int n, int m, int match, int mismatch, int gap_open,
                           int gap_ext, int threads, int chunk, int* H,
                           int* score, int* bi, int* bj, int* workspace,
                           void* stream) {
  if (B > 0) {
    const size_t smem = workspace ? 0 : (size_t)12 * (m + 1);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          sw_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    sw_batch_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
        q, r, n, m, match, mismatch, gap_open, gap_ext, chunk, H, score, bi,
        bj, workspace);
  }
  return (int)cudaGetLastError();
}
