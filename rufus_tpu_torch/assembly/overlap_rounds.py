"""Assembly rounds 1-4: seed-indexed greedy merging + final all-vs-all.

Re-derivation of Overlap.cpp (rounds 1-3, Overlap.shorter.sh:141-165) and
OverlapRegion.cpp (round 4, :176). Output-visible quirks preserved:

* Overlap's Align3 phase 3 uses STRICT `percent > minPercent` (Overlap.cpp
  :332) while phases 1-2 and all of OverlapRegion use `>=`, and its best
  score starts at -1 (`Align3.OVERLAP`; OverlapRegion scores as OverlapSam);
* node names here are `NODE_<stub>_<i>_L<len>_D<dep>:F:R:` with NO '='
  (Overlap.cpp:1152) and stub = the SearchHash argv for rounds 1-3;
* candidate lists (seed-hash voting) are computed per 100*Threads buffer
  BEFORE merging that buffer, so they are stale w.r.t. in-buffer merges;
* merged contigs never gain seed-index entries (the `if (found = false)`
  assignment bug at Overlap.cpp:1090/1107 makes the update dead code);
* candidates are ordered by (count desc, read-index desc) — the multimap
  reverse-iteration order (Overlap.cpp:146-160);
* per-read candidate caps: 100k position increments, 1k candidates
  (Overlap.cpp:117-121, 151-158);
* fastqd records are kept only if len > SearchHash+1 (rounds 1-3) or
  len > 90 (round 4) after low-coverage end-trimming, which applies only
  when some base depth > 1.
"""

from __future__ import annotations

from .core import (Align3, Contig, colaps_contigs, compress_strand,
                   flip_strands, trim_low_coverage_ends)
from ..io.fastq import FastqdRecord
from ..ops import codec


def _load_fastqd(records, trim_cutoff: int, min_len: int):
    """Common fastqd ingest: depth-cap at 255 via unsigned char, trim when
    any depth > 1, keep if len > min_len."""
    contigs = []
    rejects = 0
    for r in records:
        depths = [d & 0xFF for d in r.depths]
        c = Contig(r.seq, r.qual, depths, r.strands)
        if any(d > 1 for d in depths):
            c = trim_low_coverage_ends(c, trim_cutoff)
        if len(c.seq) > min_len:
            contigs.append(c)
        else:
            rejects += 1
    return contigs, rejects


def _build_seed_index(seqs, search_hash: int):
    """RebuildHashTable: every seed window (both strands) -> read indices."""
    idx: dict[str, list[int]] = {}
    for i, s in enumerate(seqs):
        for j in range(0, len(s) - search_hash):
            w = s[j : j + search_hash]
            if "N" in w:
                continue
            idx.setdefault(w, []).append(i)
            idx.setdefault(codec.revcomp_str(w), []).append(i)
    return idx


def _prepare_search_list(A: str, ai: int, index, search_hash: int, act: int):
    """PrepairSearchList: vote positions by shared seeds, caps, ordering."""
    positions: dict[int, int] = {}
    added = 0
    for i in range(0, len(A) - search_hash):
        w = A[i : i + search_hash]
        if "N" in w:
            continue
        for holder in index.get(w, ()):
            if holder > ai:
                positions[holder] = positions.get(holder, 0) + 1
                added += 1
            if added > 100000:
                break
    # multimap<count, idx> reverse iteration: count desc, index desc
    cands = sorted(
        ((cnt, idx2) for idx2, cnt in positions.items() if cnt > act),
        key=lambda t: (-t[0], -t[1]),
    )
    out = []
    for cnt, idx2 in cands:
        out.append(idx2)
        if len(out) > 1000:
            break
    return out


def overlap_round(records, node_stub: str, min_percent: float = 0.98,
                  min_overlap: int = 100, min_coverage: int = 1,
                  search_hash: int = 20, act: int = 1, trim_cutoff: int = 0,
                  buffer_size: int = 4000):
    """One Overlap round over fastqd records -> (contig fastqd records,
    stats dict: rejects, and the Align3 calls and pairs scored)."""
    contigs, rejects = _load_fastqd(records, trim_cutoff, search_hash + 1)
    seqs = [c.seq for c in contigs]
    quals = [c.qual for c in contigs]
    depths = [c.depth for c in contigs]
    strands = [c.strand for c in contigs]
    index = _build_seed_index(seqs, search_hash)
    n = len(seqs)
    align3 = Align3(Align3.OVERLAP)
    for b in range(0, n, buffer_size):
        hi = min(b + buffer_size, n)
        fwd_lists = {}
        rev_lists = {}
        for i in range(b, hi):
            fwd_lists[i] = _prepare_search_list(seqs[i], i, index, search_hash, act)
            rev_lists[i] = _prepare_search_list(codec.revcomp_str(seqs[i]), i,
                                                index, search_hash, act)
        for i in range(b, hi):
            A, Aq = seqs[i], quals[i]
            Ad, As = depths[i], strands[i]
            perfect = [False]
            score, kk, best = align3(seqs, A, fwd_lists[i], min_percent,
                                     min_overlap, perfect)
            if not perfect[0]:
                revA = codec.revcomp_str(A)
                rscore, rkk, rbest = align3(seqs, revA, rev_lists[i],
                                            min_percent, min_overlap, perfect)
                if rscore > score:
                    A, Aq = revA, Aq[::-1]
                    Ad = Ad[::-1]
                    As = flip_strands(As)
                    score, kk, best = rscore, rkk, rbest
            if score < min_overlap or best < 0:
                continue
            merged = colaps_contigs(
                Contig(A, Aq, Ad, As),
                Contig(seqs[best], quals[best], depths[best], strands[best]), kk)
            seqs[best] = merged.seq
            quals[best] = merged.qual
            depths[best] = merged.depth
            strands[best] = merged.strand
            seqs[i] = "moved"
    return (_emit(seqs, quals, depths, strands, node_stub, min_coverage),
            _stats(rejects, align3))


def overlap_region(records, node_stub: str, min_percent: float = 0.98,
                   min_overlap: int = 50, min_coverage: int = 5,
                   trim_cutoff: int = 1):
    """OverlapRegion: final all-vs-all greedy pass (round 4); returns as
    overlap_round."""
    contigs, rejects = _load_fastqd(records, trim_cutoff, 90)
    seqs = [c.seq for c in contigs]
    quals = [c.qual for c in contigs]
    depths = [c.depth for c in contigs]
    strands = [c.strand for c in contigs]
    n = len(seqs)
    align3 = Align3(Align3.OVERLAP_SAM)
    for i in range(n):
        A, Aq = seqs[i], quals[i]
        Ad, As = depths[i], strands[i]
        perfect = [False]
        j_range = range(i + 1, n)
        score, kk, best = align3(seqs, A, j_range, min_percent, min_overlap,
                                 perfect)
        if not perfect[0]:
            revA = codec.revcomp_str(A)
            rscore, rkk, rbest = align3(seqs, revA, j_range, min_percent,
                                        min_overlap, perfect)
            if rscore > score:
                A, Aq = revA, Aq[::-1]
                Ad = Ad[::-1]
                As = flip_strands(As)
                score, kk, best = rscore, rkk, rbest
        if score < min_overlap or best < 0:
            continue
        merged = colaps_contigs(
            Contig(A, Aq, Ad, As),
            Contig(seqs[best], quals[best], depths[best], strands[best]), kk)
        seqs[best] = merged.seq
        quals[best] = merged.qual
        depths[best] = merged.depth
        strands[best] = merged.strand
        seqs[i] = "moved"
    return (_emit(seqs, quals, depths, strands, node_stub, min_coverage),
            _stats(rejects, align3))


def _stats(rejects: int, align3: Align3) -> dict:
    return {"rejects": rejects, "align3_queries": align3.queries,
            "align3_pairs": align3.pairs}


def _emit(seqs, quals, depths, strands, node_stub, min_coverage):
    out = []
    for i in range(len(seqs)):
        if seqs[i] == "moved" or len(seqs[i]) < 95:
            continue
        max_dep = max(depths[i]) if depths[i] else -1
        if max_dep >= min_coverage:
            F, R = compress_strand(strands[i])
            name = f"NODE_{node_stub}_{i}_L{len(seqs[i])}_D{max_dep}:{F}:{R}:"
            out.append(FastqdRecord(name, seqs[i], quals[i], strands[i],
                                    list(depths[i])))
    return out
