"""Assembly rounds 1-4: seed-indexed greedy merging + final all-vs-all.

Re-derivation of Overlap.cpp (rounds 1-3, Overlap.shorter.sh:141-165) and
OverlapRegion.cpp (round 4, :176). Output-visible quirks preserved:

* Overlap's Align3 phase 3 uses STRICT `percent > minPercent` (Overlap.cpp
  :332) while phases 1-2 and all of OverlapRegion use `>=`;
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

from .core import (Contig, align3, colaps_contigs, compress_strand,
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


def _align3_overlap(seqs, A: str, ai: int, min_percent: float,
                    min_overlap: int, indexes, perfect_box):
    """Overlap.cpp Align3 (169-357): candidate-list variant."""
    best_score = 0
    best_index = -1
    best_overlap = 0
    Alen = len(A)
    for j in indexes:
        B = seqs[j]
        Blen = len(B)
        if Blen > Alen:
            window, longest, a_is_long = Alen, Blen, False
        else:
            window, longest, a_is_long = Blen, Alen, True
        if window == 0:
            continue
        MM = window - (window * min_percent)
        local_best, local_idx, local_ov = -1, -1, 0
        a_off = b_off = 0
        for off in range(0, longest - window + 1):
            score = 0.0
            for kk in range(window):
                ca = A[kk + a_off]
                cb = B[kk + b_off]
                if ca == cb and ca != "N":
                    score += 1
                if (kk - score) > MM:
                    score = -1.0
                    break
            if a_is_long:
                a_off += 1
            else:
                b_off += 1
            percent = score / window
            if percent >= min_percent and local_best < score:
                local_best = score
                local_idx = j
                local_ov = -off if a_is_long else off
                if score == window:
                    perfect_box[0] = True
                    break
        if not perfect_box[0]:
            for ov in range(window - 1, min_overlap - 1, -1):
                score = 0.0
                kk = 0
                brk = False
                for kk in range(ov + 1):
                    if A[Alen - ov + kk - 1] == B[kk] and B[kk] != "N":
                        score += 1
                    if (kk - score) > MM:
                        score = -1.0
                        brk = True
                        break
                kdiv = kk if brk else ov + 1
                percent = score / kdiv if kdiv else -1
                if percent >= min_percent and local_best < score:
                    local_best = score
                    local_idx = j
                    local_ov = ov - Alen + 1
                    if score == ov:
                        break
            for ov in range(window - 1, min_overlap - 1, -1):
                score = 0.0
                kk = 0
                brk = False
                for kk in range(ov + 1):
                    if B[Blen - ov + kk - 1] == A[kk] and A[kk] != "N":
                        score += 1
                    if (kk - score) > MM:
                        score = -1.0
                        brk = True
                        break
                kdiv = kk if brk else ov + 1
                percent = score / kdiv if kdiv else -1
                # STRICT > in phase 3 (Overlap.cpp:332)
                if percent > min_percent and local_best < score:
                    local_best = score
                    local_idx = j
                    local_ov = Blen - ov - 1
                    if score == ov:
                        break
        if local_best > best_score:
            best_score = local_best
            best_index = local_idx
            best_overlap = local_ov
    return best_score, best_overlap, best_index


def overlap_round(records, node_stub: str, min_percent: float = 0.98,
                  min_overlap: int = 100, min_coverage: int = 1,
                  search_hash: int = 20, act: int = 1, trim_cutoff: int = 0,
                  buffer_size: int = 4000):
    """One Overlap round over fastqd records -> contig fastqd records."""
    contigs, rejects = _load_fastqd(records, trim_cutoff, search_hash + 1)
    seqs = [c.seq for c in contigs]
    quals = [c.qual for c in contigs]
    depths = [c.depth for c in contigs]
    strands = [c.strand for c in contigs]
    index = _build_seed_index(seqs, search_hash)
    n = len(seqs)
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
            score, kk, best = _align3_overlap(seqs, A, i, min_percent,
                                              min_overlap, fwd_lists[i], perfect)
            if not perfect[0]:
                revA = codec.revcomp_str(A)
                rscore, rkk, rbest = _align3_overlap(seqs, revA, i, min_percent,
                                                     min_overlap, rev_lists[i],
                                                     perfect)
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
    return _emit(seqs, quals, depths, strands, node_stub, min_coverage), rejects


def overlap_region(records, node_stub: str, min_percent: float = 0.98,
                   min_overlap: int = 50, min_coverage: int = 5,
                   trim_cutoff: int = 1):
    """OverlapRegion: final all-vs-all greedy pass (round 4)."""
    contigs, rejects = _load_fastqd(records, trim_cutoff, 90)
    seqs = [c.seq for c in contigs]
    quals = [c.qual for c in contigs]
    depths = [c.depth for c in contigs]
    strands = [c.strand for c in contigs]
    n = len(seqs)
    for i in range(n):
        A, Aq = seqs[i], quals[i]
        Ad, As = depths[i], strands[i]
        perfect = [False]
        j_range = range(i + 1, n)
        score, kk, best = align3(seqs, quals, A, Aq, i, min_percent,
                                 min_overlap, j_range, perfect)
        if not perfect[0]:
            revA = codec.revcomp_str(A)
            rscore, rkk, rbest = align3(seqs, quals, revA, Aq[::-1], i,
                                        min_percent, min_overlap, j_range,
                                        perfect)
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
    return _emit(seqs, quals, depths, strands, node_stub, min_coverage), rejects


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
