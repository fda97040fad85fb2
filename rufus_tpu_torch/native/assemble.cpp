// Align3 overlap scoring of the greedy assembler: one query read against a
// list of candidates, the three phases of OverlapSam.cpp:33-241 (also
// OverlapRegion's) and of Overlap.cpp:169-357, whose Python statement is
// the JAX package's assembly/core.py:align3 and
// assembly/overlap_rounds.py:_align3_overlap. Single-threaded: the
// reference runs the candidates under OpenMP, but the semantics kept are
// the sequential ones.
//
// Sequences are UTF-32 code points (Python's str.encode("utf-32-le")), so
// any character compares as it does in Python. Every quirk is kept:
//   * scores are doubles, MM = window - window * min_percent, and a
//     comparison aborts once (kk - score) > MM (counted here in whole
//     mismatches, which is the same test: mismatch_limit);
//   * phases 2 and 3 break early on score == ov, and divide by kk after
//     an abort (by -1 when kk is 0);
//   * the perfect-match flag is shared across candidates and across the
//     caller's forward and reverse calls: once set, later candidates still
//     run phase 1 but skip phases 2 and 3;
//   * Overlap (tool 1) starts each candidate's best at -1, tests phase 3
//     with a strict >, and sets the flag only on an improving score.
//
// API (extern "C", consumed by rufus_tpu_torch/assembly/core.py):
//   align3_score(A, alen, cat, offs, idx, n, min_percent, min_overlap,
//                tool, perfect, score, overlap) -> best index (-1: none)
//     candidate t is cat[offs[t] .. offs[t+1]) with index idx[t]; the best
//     score and its overlap are written to *score and *overlap.

#include <cmath>
#include <cstdint>

namespace {

constexpr uint32_t kN = 'N';

// The reference's running double score is a whole number of matches until
// it aborts, so (kk - score) > MM is (mismatches - 1) > MM, and for a whole
// number that is mismatches > floor(MM) + 1: `lim`, the mismatches allowed.
long long mismatch_limit(double MM) {
  if (!(MM == MM) || MM >= 9.0e18) return INT64_MAX;  // never aborts
  if (MM < -9.0e18) return INT64_MIN;                 // aborts at once
  return (long long)std::floor(MM) + 1;
}

// One comparison of a[0..len) with b[0..len): a position matches where
// the characters are equal and not 'N'. Returns the matches as the
// reference's double score, or -1 where the mismatches pass `lim`, with
// the position of the abort (len when none) in *at.
inline double compare(const uint32_t* a, const uint32_t* b, long long len,
                      long long lim, long long* at) {
  long long mism = 0;
  for (long long kk = 0; kk < len; ++kk) {
    mism += (a[kk] != b[kk]) | (a[kk] == kN);
    if (mism > lim) {
      *at = kk;
      return -1.0;
    }
  }
  *at = len;
  return (double)(len - mism);
}

}  // namespace

extern "C" long long align3_score(const uint32_t* A, long long alen,
                                  const uint32_t* cat, const long long* offs,
                                  const long long* idx, long long n,
                                  double min_percent, long long min_overlap,
                                  int tool, int* perfect, double* score_out,
                                  long long* overlap_out) {
  const bool rounds = tool == 1;
  double best_score = 0;
  long long best_index = -1, best_overlap = 0;
  for (long long t = 0; t < n; ++t) {
    const uint32_t* B = cat + offs[t];
    const long long blen = offs[t + 1] - offs[t];
    const long long j = idx[t];
    long long window, longest;
    bool a_is_long;
    if (blen > alen) {
      window = alen, longest = blen, a_is_long = false;
    } else {
      window = blen, longest = alen, a_is_long = true;
    }
    if (window == 0) continue;
    const double w = (double)window;
    const long long lim = mismatch_limit(w - (w * min_percent));
    double local_best = rounds ? -1.0 : 0.0;
    long long local_idx = -1, local_ov = 0;
    long long at;
    // phase 1: slide the shorter read fully inside the longer
    for (long long off = 0; off <= longest - window; ++off) {
      const double score = a_is_long ? compare(A + off, B, window, lim, &at)
                                     : compare(A, B + off, window, lim, &at);
      const double percent = score / w;
      if (percent >= min_percent) {
        const bool better = local_best < score;
        if (better) {
          local_best = score;
          local_idx = j;
          local_ov = a_is_long ? -off : off;
        }
        if ((better || !rounds) && score == w) {
          *perfect = 1;
          break;
        }
      }
    }
    if (!*perfect) {
      // phase 2: A's suffix against B's prefix
      for (long long ov = window - 1; ov >= min_overlap; --ov) {
        const double score =
            ov + 1 > 0 ? compare(A + (alen - ov - 1), B, ov + 1, lim, &at)
                       : 0.0;
        const long long kdiv = score < 0 ? at : ov + 1;
        const double percent = kdiv ? score / (double)kdiv : -1.0;
        if (percent >= min_percent && local_best < score) {
          local_best = score;
          local_idx = j;
          local_ov = ov - alen + 1;
          if (score == (double)ov) break;
        }
      }
      // phase 3: B's suffix against A's prefix
      for (long long ov = window - 1; ov >= min_overlap; --ov) {
        const double score =
            ov + 1 > 0 ? compare(B + (blen - ov - 1), A, ov + 1, lim, &at)
                       : 0.0;
        const long long kdiv = score < 0 ? at : ov + 1;
        const double percent = kdiv ? score / (double)kdiv : -1.0;
        const bool pass =
            rounds ? percent > min_percent : percent >= min_percent;
        if (pass && local_best < score) {
          local_best = score;
          local_idx = j;
          local_ov = blen - ov - 1;
          if (score == (double)ov) break;
        }
      }
    }
    if (best_score < local_best) {
      best_score = local_best;
      best_index = local_idx;
      best_overlap = local_ov;
    }
  }
  *score_out = best_score;
  *overlap_out = best_overlap;
  return best_index;
}
