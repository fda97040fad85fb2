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

The pairwise scoring is O(window) per (pair, offset), on the host, in the
port's native library (`Align3`).
"""

from __future__ import annotations

import ctypes
import itertools
from array import array
from dataclasses import dataclass

from ..ops import _build


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


class Align3:
    """The Align3 overlap scorer of one reference tool, in the port's native
    host library (``native/assemble.cpp``): `OVERLAP_SAM` for OverlapSam
    and OverlapRegion (OverlapSam.cpp:33-241), `OVERLAP` for the Overlap
    rounds (Overlap.cpp:169-357: each candidate's best starts at -1 and
    phase 3 tests `percent > minPercent`). A call scores one query A
    against the candidates `cands` (indices into `seqs`, as they stand
    after earlier merges) and returns (best_score, overlap_k, best_index);
    `perfect_box` is a 1-element mutable [bool] shared across calls (the
    reference shares PerfectMatch across the omp loop AND the fwd/rev
    calls). `queries` and `pairs` count the calls and the query-candidate
    pairs scored."""

    OVERLAP_SAM, OVERLAP = 0, 1

    def __init__(self, tool: int):
        self.tool = tool
        self.queries = 0
        self.pairs = 0
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        self._fn = _build.host_function(
            "align3_score", i64,
            (p, i64, p, p, p, i64, ctypes.c_double, i64, ctypes.c_int, p, p,
             p))

    def __call__(self, seqs, A: str, cands, min_percent: float,
                 min_overlap: int, perfect_box: list):
        cands = list(cands)
        n = len(cands)
        self.queries += 1
        self.pairs += n
        picked = [seqs[j] for j in cands]
        a = A.encode("utf-32-le")
        cat = "".join(picked).encode("utf-32-le")
        offs = array("q", [0])
        offs.extend(itertools.accumulate(len(s) for s in picked))
        idx = array("q", cands)
        flag = ctypes.c_int(bool(perfect_box[0]))
        score = ctypes.c_double()
        overlap = ctypes.c_longlong()
        best = self._fn(a, len(A), cat, offs.buffer_info()[0],
                        idx.buffer_info()[0], n, min_percent, min_overlap,
                        self.tool, ctypes.byref(flag), ctypes.byref(score),
                        ctypes.byref(overlap))
        perfect_box[0] = bool(flag.value)
        # the reference's score stays the integer 0 until a candidate wins
        return (score.value if score.value > 0 else 0), overlap.value, best


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
