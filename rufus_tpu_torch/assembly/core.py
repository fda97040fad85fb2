"""Shared assembly primitives: Align3 scoring, contig collapse, trims.

Semantics-exact re-derivation of the reference's greedy overlap assembler
core (OverlapSam.cpp:33-241 Align3, 243-357 ColapsContigs, 381-390
ReplaceLowQBase, 359-379 TrimNends, 445-500 TrimLowCoverageEnds). Every
output-visible quirk is kept:

* Align3's three phases (full-overlap slide, A-suffix/B-prefix,
  B-suffix/A-prefix) with percent = score / post-loop k (= i+1 unless the
  early-abort break fired);
* the `score == i` (not i+1) early break in phases 2/3;
* the raw-char qual guard `> 5` is vacuously true (ASCII), so only the
  both-N match exclusion matters;
* "Asmaller" is true when A is the LONGER read (inverted name, logic kept);
* strand strings are bags of per-read +/-/. chars concatenated on merge,
  not per-base tracks;
* depth values cap at 250 per base on merge.

The pairwise scoring is O(window) per (pair, offset), on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Contig:
    seq: str
    qual: str
    depth: list  # per-base ints
    strand: str  # bag of strand chars


def replace_low_q(seq: str, qual: str, min_q: int = 10) -> str:
    return "".join("N" if ord(q) - 33 < min_q else c for c, q in zip(seq, qual))


def num_low_q(qual: str, min_q: int) -> int:
    return sum(1 for q in qual if ord(q) - 33 < min_q)


def trim_n_ends(seq: str, qual: str):
    """Strip non-ACGT from both ends (TrimNends)."""
    lo, hi = 0, len(seq)
    while lo < hi and seq[lo] not in "ACGT":
        lo += 1
    while hi > lo and seq[hi - 1] not in "ACGT":
        hi -= 1
    return seq[lo:hi], qual[lo:hi]


def count_hashes(seq: str, table: set, k: int) -> int:
    """CountHashes (OverlapSam.cpp:523-538): windows START at 0..len-k-1 —
    the final window is skipped (size_t loop bound quirk). `table` holds
    both strands as strings."""
    count = 0
    for i in range(0, len(seq) - k):
        w = seq[i : i + k]
        if "N" not in w and w in table:
            count += 1
    return count


def align3(seqs, quals, A: str, Aq: str, i: int, min_percent: float,
           min_overlap: int, j_range, perfect_box: list):
    """Align3 core for one query A against candidate indices j_range.

    perfect_box is a 1-element mutable [bool] shared across calls (the
    reference shares PerfectMatch across the omp loop AND the fwd/rev
    calls). Returns (best_score, overlap_k, best_index).
    """
    best_score = 0
    best_index = -1
    best_overlap = 0
    Alen = len(A)
    for j in j_range:
        B = seqs[j]
        Bq = quals[j]
        Blen = len(B)
        if Blen > Alen:
            window, longest, a_is_long = Alen, Blen, False
        else:
            window, longest, a_is_long = Blen, Alen, True
        if window == 0:
            continue
        MM = window - (window * min_percent)
        local_best, local_idx, local_ov = 0, -1, 0
        # phase 1: slide the shorter fully inside the longer
        a_off = b_off = 0
        for off in range(0, longest - window + 1):
            score = 0.0
            aborted = False
            for kk in range(window):
                ca = A[kk + a_off]
                cb = B[kk + b_off]
                if ca == cb and cb != "N":
                    score += 1
                if (kk - score) > MM:
                    score = -1.0
                    aborted = True
                    break
            if a_is_long:
                a_off += 1
            else:
                b_off += 1
            percent = score / window
            if percent >= min_percent:
                if local_best < score:
                    local_best = score
                    local_idx = j
                    local_ov = -off if a_is_long else off
                if score == window:
                    perfect_box[0] = True
                    break
        if not perfect_box[0]:
            # phase 2: A suffix vs B prefix
            for ov in range(window - 1, min_overlap - 1, -1):
                score = 0.0
                kk = 0
                brk = False
                for kk in range(ov + 1):
                    ca = A[Alen - ov + kk - 1]
                    cb = B[kk]
                    if ca == cb and cb != "N":
                        score += 1
                    if (kk - score) > MM:
                        score = -1.0
                        brk = True
                        break
                kdiv = kk if brk else ov + 1
                percent = score / kdiv if kdiv else -1
                if percent >= min_percent:
                    if local_best < score:
                        local_best = score
                        local_idx = j
                        local_ov = ov - Alen + 1
                        if score == ov:
                            break
            # phase 3: B suffix vs A prefix
            for ov in range(window - 1, min_overlap - 1, -1):
                score = 0.0
                kk = 0
                brk = False
                for kk in range(ov + 1):
                    cb = B[Blen - ov + kk - 1]
                    ca = A[kk]
                    if cb == ca and ca != "N":
                        score += 1
                    if (kk - score) > MM:
                        score = -1.0
                        brk = True
                        break
                kdiv = kk if brk else ov + 1
                percent = score / kdiv if kdiv else -1
                if percent >= min_percent:
                    if local_best < score:
                        local_best = score
                        local_idx = j
                        local_ov = Blen - ov - 1
                        if score == ov:
                            break
        if best_score < local_best:
            best_score = local_best
            best_index = local_idx
            best_overlap = local_ov
    return best_score, best_overlap, best_index


def colaps_contigs(A: Contig, B: Contig, k: int) -> Contig:
    """ColapsContigs: positional consensus merge of A onto B (243-357)."""
    a_off = k if k > 0 else 0
    b_off = -k if k < 0 else 0
    seq, qual, depth = [], [], []
    for i in range(len(A.seq) + len(B.seq)):
        ia, ib = i - a_off, i - b_off
        a_ok = 0 <= ia < len(A.seq)
        b_ok = 0 <= ib < len(B.seq)
        if a_ok and b_ok:
            ca, cb = A.seq[ia], B.seq[ib]
            qa, qb = A.qual[ia], B.qual[ib]
            da, db = A.depth[ia], B.depth[ib]
            if ca == cb:
                seq.append(ca)
                qual.append(qa if qa >= qb else qb)
                depth.append(da + db if da + db < 250 else 250)
            elif ca == "N" and cb != "N":
                seq.append(cb); qual.append(qb); depth.append(db)
            elif ca != "N" and cb == "N":
                seq.append(ca); qual.append(qa); depth.append(da)
            elif qa >= qb:
                seq.append(ca); qual.append(qa); depth.append(da)
            else:
                seq.append(cb); qual.append(qb); depth.append(db)
        elif b_ok:
            seq.append(B.seq[ib]); qual.append(B.qual[ib]); depth.append(B.depth[ib])
        elif a_ok:
            seq.append(A.seq[ia]); qual.append(A.qual[ia]); depth.append(A.depth[ia])
        else:
            break
    return Contig("".join(seq), "".join(qual), depth, B.strand + A.strand)


def flip_strands(s: str) -> str:
    return "".join("-" if c == "+" else "+" if c == "-" else "." for c in s if c in "+-.")


def compress_strand(s: str):
    return s.count("+"), s.count("-")


def trim_low_coverage_ends(c: Contig, cutoff: int) -> Contig:
    """TrimLowCoverageEnds (Overlap.cpp:510-557): strip both ends where
    depth <= cutoff (strictly-greater keeps)."""
    hi = len(c.seq)
    while hi > 0 and c.depth[hi - 1] <= cutoff:
        hi -= 1
    seq, qual, depth = c.seq[:hi], c.qual[:hi], c.depth[:hi]
    if len(seq) > 1:
        lo = 0
        while lo < len(seq) and depth[lo] <= cutoff:
            lo += 1
        seq, qual, depth = seq[lo:], qual[lo:], depth[lo:]
    return Contig(seq, qual, depth, c.strand)
