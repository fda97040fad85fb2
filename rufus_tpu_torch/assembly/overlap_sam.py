"""Assembly round 0: greedy merge of position-sorted aligned mutant reads.

Re-derivation of OverlapSam main (OverlapSam.cpp:559-1137): reads arrive in
coordinate-sorted SAM order, each is scored against only the NEXT 10 reads
(position sorting makes neighbors the overlap candidates), merged greedily
by positional consensus; winners accumulate depth, losers become "moved".
Output is the fastq/fastqd contig set with NODE naming that interpret
parses for strand-bias (`:F:R:`).
"""

from __future__ import annotations

from .core import (Contig, align3, colaps_contigs, compress_strand,
                   count_hashes, flip_strands, num_low_q, replace_low_q,
                   trim_n_ends)
from ..io.fastq import FastqdRecord
from ..ops import codec


def _strand_char(flag: int, hashes: int) -> str:
    if hashes > 0:
        if (flag & 0x1) == 0:
            return "."
        return "-" if flag & 0x10 else "+"
    return "."


def overlap_sam(records, hashlist_strs, node_stub: str,
                min_percent: float = 0.95, min_overlap: int = 20,
                min_coverage: int = 1, k: int | None = None):
    """records: iterable with .flag/.seq/.qual (SAM order). Returns
    (fastqd contig records, stats dict)."""
    if not hashlist_strs:
        raise ValueError("empty HashList")
    k = k or len(hashlist_strs[0])
    table = set()
    for s in hashlist_strs:
        table.add(s)
        table.add(codec.revcomp_str(s))

    seqs, quals, depths, strands = [], [], [], []
    un_seqs, un_quals, un_depths, un_strands = [], [], [], []
    rejects = 0
    for r in records:
        seq = replace_low_q(r.seq, r.qual, 10)
        read_size = len(r.qual)
        flag = r.flag
        lowq = num_low_q(r.qual, 20)
        if (flag & (0x100 | 0x800 | 0x400) or len(seq) < 50
                or lowq / len(r.qual) > 0.33):
            rejects += 1
            continue
        s2, q2 = trim_n_ends(seq, r.qual)
        hashes = count_hashes(s2, table, k)
        if len(s2) / read_size <= 0.6:
            rejects += 1
            continue
        sc = _strand_char(flag, hashes)
        if flag & 0x4:
            un_seqs.append(s2); un_quals.append(q2)
            un_strands.append(sc); un_depths.append([1] * len(s2))
        else:
            seqs.append(s2); quals.append(q2)
            strands.append(sc); depths.append([1] * len(s2))

    n = len(seqs)
    for i in range(n):
        A, Aq = seqs[i], quals[i]
        Ad, As = depths[i], strands[i]
        j_range = range(i + 1, min(i + 11, n))
        perfect = [False]
        score, kk, best = align3(seqs, quals, A, Aq, i, min_percent,
                                 min_overlap, j_range, perfect)
        if not perfect[0]:
            revA = codec.revcomp_str(A)
            revAq = Aq[::-1]
            rscore, rkk, rbest = align3(seqs, quals, revA, revAq, i,
                                        min_percent, min_overlap, j_range,
                                        perfect)
            if rscore > score:
                A, Aq = revA, revAq
                Ad = Ad[::-1]
                As = flip_strands(As)
                score, kk, best = rscore, rkk, rbest
        if score < min_overlap or best < 0:
            continue
        merged = colaps_contigs(Contig(A, Aq, Ad, As),
                                Contig(seqs[best], quals[best], depths[best],
                                       strands[best]), kk)
        seqs[best] = merged.seq
        quals[best] = merged.qual
        depths[best] = merged.depth
        strands[best] = merged.strand
        seqs[i] = "moved"

    out = []
    for i in range(n):
        if seqs[i] == "moved" or len(seqs[i]) < 95:
            continue
        max_dep = max(depths[i]) if depths[i] else -1
        if max_dep >= min_coverage:
            F, R = compress_strand(strands[i])
            name = f"NODE_{node_stub}_{i}_L={len(seqs[i])}_D={max_dep}:{F}:{R}:"
            out.append(FastqdRecord(name, seqs[i], quals[i], strands[i],
                                    list(depths[i])))
    if min_coverage <= 1:
        for i in range(len(un_seqs)):
            if len(un_seqs[i]) < 95:
                continue
            name = f"NODE_{node_stub}_{i}_L={len(un_seqs[i])}_D-1"
            out.append(FastqdRecord(name, un_seqs[i], un_quals[i],
                                    un_strands[i], list(un_depths[i])))
    return out, {"rejects": rejects, "aligned": n, "unaligned": len(un_seqs)}
