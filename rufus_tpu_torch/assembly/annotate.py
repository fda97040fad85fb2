"""Post-assembly contig annotation (ReplaceQwithD / ConvertFASTqD /
AnnotateOverlap transcriptions; Overlap.shorter.sh:190-194).
"""

from __future__ import annotations

from ..io.fastq import FastqdRecord
from ..ops import codec


def replace_qual_with_depth(records):
    """ReplaceQwithDinFASTQD.cpp:168-201: qual := depth+33 capped at 126.
    Depth values pass through `unsigned char` first (mod 256)."""
    out = []
    for r in records:
        caps = []
        for d in r.depths:
            d8 = d & 0xFF
            caps.append(chr(126 if d8 + 33 > 126 else d8 + 33))
        out.append(FastqdRecord(r.name, r.seq, "".join(caps), r.strands,
                                list(r.depths)))
    return out


def fastqd_to_fastq(records):
    """ConvertFASTqD.to.FASTQ.cpp:54-64: drop strand/depth lines."""
    return [(r.name, r.seq, r.qual) for r in records]


def annotate_overlap(hashlist_pairs, contigs, k: int):
    """AnnotateOverlap.cpp:25-161.

    hashlist_pairs: [(kmer_str, count)] — table stores FWD strings only;
    lookups try fwd then revcomp. contigs: [(name, seq, qual)] where qual
    is the depth-derived string (depth+33). Windows start at 0..len-k-1
    (last window skipped); a window is skipped when it contains N or any
    base with qual-33 < 3 (i.e. depth < 3).

    Returns ([(name+":MH0", seq, hashcount_qual)], side_kmer_lines) where
    hashcount_qual = per-base count of covering mutant windows + 33 capped
    at 126 (cap applies when count >= 93), and side_kmer_lines are the
    canonical "kmer 1" lines of every contig window (min(fwd, revcomp) by
    STRING comparison).
    """
    table = {s for s, _ in hashlist_pairs}
    out = []
    side = []
    for name, seq, qual in contigs:
        n = len(seq)
        hashpos = [0] * n
        for i in range(0, n - k):
            w = seq[i : i + k]
            qw = qual[i : i + k]
            if "N" in w or any(ord(c) - 33 < 3 for c in qw):
                continue
            if w in table or codec.revcomp_str(w) in table:
                for j in range(i, i + k):
                    hashpos[j] += 1
        hq = "".join(chr(h + 33) if h < 93 else chr(126) for h in hashpos)
        out.append((name + ":MH0", seq, hq))
        for i in range(0, n - k):
            w = seq[i : i + k]
            r = codec.revcomp_str(w)
            side.append((w if w < r else r) + " 1")
    return out, side
