// sw_batch: batched local affine-gap Smith-Waterman with its traceback, one
// warp a (query, window) pair, over a ragged batch of pairs.
//
// Replaces the JAX device program rufus_tpu/align/sw_device.py:_sw_batch (a
// jitted lax.scan over query rows, not a Pallas kernel) and the host
// traceback rufus_tpu/align/aligner.py:_traceback that reads its H. The
// contract is bit-identity with both: H (n+1, m+1) int32 a pair (kept on the
// card, in a workspace the wrapper allocates), the best score and the first
// maximum of the row-major H as (i, j), (0, 0, 0) for an all-zero H; then
// the walk back from (i, j) with its end (qi, rj), mismatches plus gap
// lengths (nm) and its ops in walk order (0 = M, 1 = D, 2 = I). Codes are
// 0-3, 255 = N or padding, which never matches. Each row i (query base i-1)
// is
//
//   F[j]    = max(F[j] - ext, H[i-1][j] - open - ext)          (vertical gap)
//   cand[j] = max(H[i-1][j-1] + sub(i, j), F[j], 0),  cand[0] = 0
//   H[i][j] = max(cand[j], max_{t<j}(cand[t] + ext*t) - open - ext*j)
//
// the last term being the horizontal gap in the closed form of the JAX
// program. Only integer max and plus are at stake, which are exact in any
// order, so any evaluation order gives the same H.
//
// Bound: integer operations. Without H among the outputs the function reads
// n+m bytes of codes and writes 28 bytes and at most n+m ops a pair; the DP
// does 15 integer operations a cell (F 3: two subtractions and a max; sub
// 2: a compare and a select; cand 3: an add and two max; the scan term 2;
// the gap term 2: a three-input add and a max; its running max 2; the best
// cell 1), which at Hopper's 64 INT32 lanes an SM is far more time than
// those bytes take. The traceback is O(n+m) steps a pair and is left out
// of the bound. The design:
//
//   warp   one warp a pair, no block barriers; pairs come sorted by n*m,
//          largest first, so the longest starts first.
//   lane   a lane owns C contiguous columns of a tile of 32*C (C = 4, 8, 12
//          or 16, picked by the wrapper for the launch's widest pair);
//          a block is one warp, so that a launch of few pairs spreads over
//          the SMs (a pair's rows are a chain: a shared scheduler slows it);
//          in a window of one tile its previous row, F and its codes stay in
//          registers; the diagonal H[i-1][j0-1] comes from lane-1 by
//          shuffle.
//   scan   the horizontal gap is a 5-step warp max-scan of cand[t] + ext*t;
//          wider windows sweep the row tile by tile, carrying the scan
//          prefix and lane 0's diagonal, with the previous row, F and the
//          codes in the warp's shared memory (10 bytes a column, up to
//          23,040 columns for the launch's widest row) or past that in a
//          global workspace; each lane reads back only the columns it
//          wrote.
//   H      a tile goes out through a staging tile in shared memory, so that
//          consecutive lanes store 16 bytes at consecutive addresses (a
//          lane's own chunk is 16 * C / 4 bytes apart from the next lane's);
//          rows are padded to a multiple of 4 columns.
//   best   each lane takes its maximum over a tile's chunk and, when it
//          beats the lane's best, its first column: the lane's first
//          maximum in row-major order; a warp reduction takes the largest
//          score, among equals the smallest (i, j). Columns past m need no
//          mask (see the row loop).
//   walk   after __syncwarp() the same warp walks back through H (still in
//          L2 for most pairs): 32 diagonal steps a round (lane l tests the
//          cell l steps down the diagonal; a ballot gives the run), and each
//          gap search tests 32 lengths a round (a ballot, then the lowest
//          set bit: the smallest g, as the host loop finds).

#include "common.cuh"

#include <climits>

namespace {

constexpr int kNeg = -1000000;           // F's start, as in the JAX program
constexpr int kMinusInf = INT_MIN / 2;   // the empty max, never written out
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMeta = 7;                 // qoff roff n m hoff woff ooff
constexpr int kOut = 7;                  // score bi bj qi rj nm nops
constexpr uint8_t kOpM = 0, kOpD = 1, kOpI = 2;

__device__ __forceinline__ int sub_score(int a, int b, int match,
                                         int mismatch) {
  return (a == b && a != 255 && b != 255) ? match : mismatch;
}

// the window's code at column j (base j-1), 256 for N and outside 1..m
__device__ __forceinline__ int window_code(const uint8_t* r, int m, int j) {
  const int c = (j >= 1 && j <= m) ? __ldg(r + j - 1) : 255;
  return c == 255 ? 256 : c;
}

template <int C>
__global__ void __launch_bounds__(32)
sw_ragged_kernel(const uint8_t* __restrict__ codes,
                 const long long* __restrict__ meta, long long B, int match,
                 int mismatch, int gap_open, int gap_ext, int gap_max,
                 int smem_cols, int* __restrict__ H, int* __restrict__ ws,
                 int* __restrict__ out, uint8_t* __restrict__ ops) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31;
  const long long p = blockIdx.x;
  const long long* mp = meta + p * kMeta;
  const uint8_t* q = codes + mp[0];
  const uint8_t* r = codes + mp[1];
  const int n = (int)mp[2], m = (int)mp[3];
  int* Hp = H + mp[4];
  uint8_t* op = ops + mp[6];
  const int M = m + 1;
  const int S = (M + 3) & ~3;  // the row stride, 16-byte rows
  constexpr int W = 32 * C;
  const int tiles = (M + W - 1) / W;
  const bool multi = tiles > 1;
  const int oe = gap_open + gap_ext;

  for (int j = 4 * lane; j < S; j += 128)
    *reinterpret_cast<int4*>(Hp + j) = make_int4(0, 0, 0, 0);
  // shared memory: the staging tile (W columns: a row's chunks go out to
  // H through it, coalesced), then the row state
  int* stage = reinterpret_cast<int*>(smem4);
  // a window of several tiles keeps its previous row and F (st[0, S) and
  // st[S, 2S)) in shared memory, or past it in the workspace; in shared
  // memory also the window's codes, 2 bytes a column (window_code's
  // values), which reloaded from device memory cost a trip to L2 a tile
  const bool in_smem = smem_cols > 0;
  int* st_s = reinterpret_cast<int*>(smem4) + W;
  const unsigned short* rc_s =
      reinterpret_cast<const unsigned short*>(st_s + 2 * smem_cols);
  int* st_g = ws + mp[5];
  if (multi) {
    for (int j = lane; j < S; j += 32) {
      if (in_smem) {
        st_s[j] = 0;
        st_s[S + j] = kNeg;
        reinterpret_cast<unsigned short*>(st_s + 2 * smem_cols)[j] =
            (unsigned short)window_code(r, m, j);
      } else {
        st_g[j] = 0;
        st_g[S + j] = kNeg;
      }
    }
  }

  // rc: the window's code at each column, 256 (never a query code) for N,
  // padding and the columns outside 1..m
  int prev[C], Fr[C], rc[C], cur[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    prev[c] = 0;
    Fr[c] = kNeg;
    rc[c] = window_code(r, m, lane * C + c);
  }
  __syncwarp();

  // Columns past m (the row's padding and idle lanes) are computed like
  // the others: each such cell is below an earlier cell of the window, so
  // it never is the first best cell and needs no test.
  int bs = 0, bi = 0, bj = 0;
  int qnext = n > 0 ? q[0] : 255;  // the next row's query code, loaded ahead
  for (int i = 1; i <= n; ++i) {
    const int qc = qnext;
    if (i < n) qnext = q[i];
    const int qi = qc == 255 ? 257 : qc;  // N matches nothing
    int* row = Hp + (long long)i * S;
    int carry = kMinusInf;  // max of cand[t] + ext*t over earlier tiles
    int dcarry = 0;         // H[i-1][jt-1], lane 0's diagonal
    for (int t = 0; t < tiles; ++t) {
      const int jt = t * W;
      const int j0 = jt + lane * C;
      const int x0 = gap_ext * j0;
      if (multi) {
#pragma unroll
        for (int c = 0; c < C; c += 4) {
          int4 v = make_int4(0, 0, 0, 0);
          int4 f = make_int4(kNeg, kNeg, kNeg, kNeg);
          if (j0 + c < S) {
            if (in_smem) {
              v = *reinterpret_cast<const int4*>(st_s + j0 + c);
              f = *reinterpret_cast<const int4*>(st_s + S + j0 + c);
            } else {
              v = *reinterpret_cast<const int4*>(st_g + j0 + c);
              f = *reinterpret_cast<const int4*>(st_g + S + j0 + c);
            }
          }
          prev[c] = v.x;
          prev[c + 1] = v.y;
          prev[c + 2] = v.z;
          prev[c + 3] = v.w;
          Fr[c] = f.x;
          Fr[c + 1] = f.y;
          Fr[c + 2] = f.z;
          Fr[c + 3] = f.w;
        }
        if (in_smem) {
#pragma unroll
          for (int c = 0; c < C; c += 4) {
            uint2 w = make_uint2(256 | 256u << 16, 256 | 256u << 16);
            if (j0 + c < S)
              w = *reinterpret_cast<const uint2*>(rc_s + j0 + c);
            rc[c] = w.x & 0xFFFF;
            rc[c + 1] = w.x >> 16;
            rc[c + 2] = w.y & 0xFFFF;
            rc[c + 3] = w.y >> 16;
          }
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) rc[c] = window_code(r, m, j0 + c);
        }
      }
      // H[i-1][j0-1], the diagonal of the lane's first column: lane-1's
      // last previous-row column, for lane 0 the previous tile's
      int dg = __shfl_up_sync(kFull, prev[C - 1], 1);
      if (lane == 0) dg = dcarry;
      dcarry = __shfl_sync(kFull, prev[C - 1], 31);
      // cand, and pre[c], the max of cand[t] + ext*t over the lane's
      // columns before c (so that the gap term below has no chain)
      int cand[C], pre[C];
      int run = kMinusInf;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d = c == 0 ? dg : prev[c - 1];
        const int f = max(Fr[c] - gap_ext, prev[c] - oe);
        Fr[c] = f;
        int v = max(max(d + (qi == rc[c] ? match : mismatch), f), 0);
        if (c == 0 && j0 == 0) v = 0;  // column 0
        cand[c] = v;
        pre[c] = run;
        run = max(run, v + x0 + gap_ext * c);
      }
      // the exclusive max over every column before this lane's chunk
      int incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = max(incl, v);
      }
      int e = __shfl_up_sync(kFull, incl, 1);
      e = lane == 0 ? carry : max(e, carry);
      carry = max(carry, __shfl_sync(kFull, incl, 31));
      // column 0 of tile 0 meets e = kMinusInf and stays 0
#pragma unroll
      for (int c = 0; c < C; ++c)
        cur[c] = max(cand[c],
                     max(e, pre[c]) - (oe - gap_ext) - (x0 + gap_ext * c));
      int rmax = 0;  // a tree: no chain through the columns
#pragma unroll
      for (int c = 0; c < C; c += 4)
        rmax = max(rmax, max(max(cur[c], cur[c + 1]),
                             max(cur[c + 2], cur[c + 3])));
      if (rmax > bs) {  // the lane's first maximum, in row-major order
        int cc = C - 1;
#pragma unroll
        for (int c = C - 1; c >= 0; --c)
          if (cur[c] == rmax) cc = c;
        bs = rmax;
        bi = i;
        bj = j0 + cc;
      }
      // the tile to H: chunks into the staging tile, then 16-byte stores of
      // consecutive lanes to consecutive addresses
#pragma unroll
      for (int c = 0; c < C; c += 4)
        *reinterpret_cast<int4*>(stage + lane * C + c) =
            make_int4(cur[c], cur[c + 1], cur[c + 2], cur[c + 3]);
      __syncwarp();
#pragma unroll
      for (int k = 4 * lane; k < W; k += 128)
        if (jt + k < S)
          *reinterpret_cast<int4*>(row + jt + k) =
              *reinterpret_cast<const int4*>(stage + k);
      __syncwarp();  // before the next tile overwrites the staging tile
      if (multi) {  // each lane reads back only its own columns
#pragma unroll
        for (int c = 0; c < C; c += 4)
          if (j0 + c < S) {
            const int4 v = make_int4(cur[c], cur[c + 1], cur[c + 2],
                                     cur[c + 3]);
            const int4 f = make_int4(Fr[c], Fr[c + 1], Fr[c + 2], Fr[c + 3]);
            if (in_smem) {
              *reinterpret_cast<int4*>(st_s + j0 + c) = v;
              *reinterpret_cast<int4*>(st_s + S + j0 + c) = f;
            } else {
              *reinterpret_cast<int4*>(st_g + j0 + c) = v;
              *reinterpret_cast<int4*>(st_g + S + j0 + c) = f;
            }
          }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) prev[c] = cur[c];
      }
    }
  }
  __syncwarp();  // H is written before any lane reads it back

  // the largest score; among equal scores the smallest (i, j)
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int os = __shfl_xor_sync(kFull, bs, d);
    const int oi = __shfl_xor_sync(kFull, bi, d);
    const int oj = __shfl_xor_sync(kFull, bj, d);
    if (os > bs || (os == bs && (oi < bi || (oi == bi && oj < bj)))) {
      bs = os;
      bi = oi;
      bj = oj;
    }
  }

  // the walk back from (bi, bj), as aligner._traceback; (i, j) and every
  // decision are the same in all lanes
  int i = bi, j = bj, nm = 0, k = 0;
  for (;;) {
    // a run of diagonal steps: lane l tests the cell l steps down
    const int ii = i - lane, jj = j - lane;
    bool ok = false, mm = false;
    if (ii > 0 && jj > 0) {
      const int h = Hp[(long long)ii * S + jj];
      if (h > 0) {
        const int s = sub_score(q[ii - 1], r[jj - 1], match, mismatch);
        ok = h == Hp[(long long)(ii - 1) * S + jj - 1] + s;
        mm = s == mismatch;
      }
    }
    const unsigned okb = __ballot_sync(kFull, ok);
    const int steps = okb == kFull ? 32 : __ffs(~okb) - 1;
    if (steps > 0) {
      const unsigned below = steps == 32 ? kFull : (1u << steps) - 1;
      if (lane < steps) op[k + lane] = kOpM;
      nm += __popc(__ballot_sync(kFull, mm) & below);
      k += steps;
      i -= steps;
      j -= steps;
    }
    if (steps == 32) continue;
    if (i <= 0 || j <= 0) break;
    const int h = Hp[(long long)i * S + j];
    if (h <= 0) break;
    // a horizontal gap (D), the smallest g, then a vertical one (I)
    int g = 0;
    const int gh = min(j, gap_max);
    for (int g0 = 1; g0 <= gh && !g; g0 += 32) {
      const int gg = g0 + lane;
      const bool hit = gg <= gh &&
          h == Hp[(long long)i * S + j - gg] - gap_open - gap_ext * gg;
      const unsigned b = __ballot_sync(kFull, hit);
      if (b) g = g0 + __ffs(b) - 1;
    }
    if (g) {
      for (int t = lane; t < g; t += 32) op[k + t] = kOpD;
      k += g;
      nm += g;
      j -= g;
      continue;
    }
    const int gv = min(i, gap_max);
    for (int g0 = 1; g0 <= gv && !g; g0 += 32) {
      const int gg = g0 + lane;
      const bool hit = gg <= gv &&
          h == Hp[(long long)(i - gg) * S + j] - gap_open - gap_ext * gg;
      const unsigned b = __ballot_sync(kFull, hit);
      if (b) g = g0 + __ffs(b) - 1;
    }
    if (!g) break;
    for (int t = lane; t < g; t += 32) op[k + t] = kOpI;
    k += g;
    nm += g;
    i -= g;
  }
  if (lane == 0) {
    int* o = out + p * kOut;
    o[0] = bs;
    o[1] = bi;
    o[2] = bj;
    o[3] = i;
    o[4] = j;
    o[5] = nm;
    o[6] = k;
  }
}

template <int C>
int launch(const uint8_t* codes, const long long* meta, long long B,
           int match, int mismatch, int gap_open, int gap_ext, int gap_max,
           int smem_cols, int* H, int* ws, int* out, uint8_t* ops,
           cudaStream_t stream) {
  const size_t smem = (size_t)(32 * C + 5 * smem_cols / 2) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_ragged_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sw_ragged_kernel<C><<<(unsigned)B, 32, smem, stream>>>(
      codes, meta, B, match, mismatch, gap_open, gap_ext, gap_max, smem_cols,
      H, ws, out, ops);
  return 0;
}

}  // namespace

// meta: B rows of 7 int64, each pair's query offset and window offset into
// codes, n, m, then its offsets into H (int32; (n+1) rows of (m+1) rounded
// up to 4 columns, 16-byte aligned), into ws (int32, two rows of H, for a
// pair of more than one tile when smem_cols is 0) and into ops (n+m bytes).
// smem_cols: 0, or the widest such row of the launch rounded up to 8
// columns, which then keeps its row state and codes in 10 * smem_cols bytes
// of shared memory a warp (beside a staging tile of 128 * chunk bytes a
// warp). out: B rows of
// 7 int32. chunk: 4, 8, 12 or 16 columns a lane.
extern "C" int rt_sw_ragged(const uint8_t* codes, const long long* meta,
                            long long B, int match, int mismatch,
                            int gap_open, int gap_ext, int gap_max, int chunk,
                            int smem_cols, int* H, int* ws, int* out,
                            uint8_t* ops, void* stream) {
  int err = 0;
  if (B > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
#define RT_SW_LAUNCH(C)                                                     \
  err = launch<C>(codes, meta, B, match, mismatch, gap_open, gap_ext,       \
                  gap_max, smem_cols, H, ws, out, ops, s)
    switch (chunk) {
      case 4: RT_SW_LAUNCH(4); break;
      case 8: RT_SW_LAUNCH(8); break;
      case 12: RT_SW_LAUNCH(12); break;
      case 16: RT_SW_LAUNCH(16); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef RT_SW_LAUNCH
  }
  return err ? err : (int)cudaGetLastError();
}
