"""Paired-end alignment driver + SAM text emission + samtools-sort order.

Replaces `bwa mem ... | samblaster | samtools sort` (runRufus.sh:1000-1001)
for the mutant-read BAM that feeds assembly, and `bwa mem -Y` for contigs
(Overlap.shorter.sh:209). Only the record fields and ordering the
downstream stages consume are guaranteed: name/flag/pos/mapq/cigar/seq/qual
and (ref_id, pos) sort with unmapped-at-end.
"""

from __future__ import annotations

from dataclasses import replace

from .aligner import Aligner, Alignment

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_MATE1 = 0x40
FLAG_MATE2 = 0x80


def align_pairs(aligner: Aligner, pairs):
    """pairs: iterable of (name, seq1, qual1, seq2, qual2) -> Alignment list.

    Each mate aligned independently (bwa-mem does pairing rescue; our reads
    are pre-filtered mutant pairs where independent alignment suffices —
    revisit if pairing rescue shows up in parity gaps).
    """
    pairs = list(pairs)
    # both mates of every pair aligned in ONE batched device-DP pass
    # (bit-identical to per-read align_seq)
    items = []
    for name, s1, q1, s2, q2 in pairs:
        items.append((name, s1, q1))
        items.append((name, s2, q2))
    alns = aligner.align_seqs(items)
    out = []
    for i, (name, s1, q1, s2, q2) in enumerate(pairs):
        a1 = alns[2 * i][0]
        a2 = alns[2 * i + 1][0]
        f1 = a1.flag | FLAG_PAIRED | FLAG_MATE1
        f2 = a2.flag | FLAG_PAIRED | FLAG_MATE2
        if a2.is_unmapped:
            f1 |= FLAG_MATE_UNMAPPED
        elif a2.is_reverse:
            f1 |= FLAG_MATE_REVERSE
        if a1.is_unmapped:
            f2 |= FLAG_MATE_UNMAPPED
        elif a1.is_reverse:
            f2 |= FLAG_MATE_REVERSE
        if (not a1.is_unmapped and not a2.is_unmapped
                and a1.ref_id == a2.ref_id and abs(a1.pos - a2.pos) < 2000
                and a1.is_reverse != a2.is_reverse):
            f1 |= FLAG_PROPER
            f2 |= FLAG_PROPER
        # unmapped mate inherits partner's position (bwa/samtools convention)
        a1 = replace(a1, flag=f1)
        a2 = replace(a2, flag=f2)
        if a1.is_unmapped and not a2.is_unmapped:
            a1 = replace(a1, ref_name=a2.ref_name, ref_id=a2.ref_id, pos=a2.pos)
        if a2.is_unmapped and not a1.is_unmapped:
            a2 = replace(a2, ref_name=a1.ref_name, ref_id=a1.ref_id, pos=a1.pos)
        out.extend([a1, a2])
    return out


FLAG_DUP = 0x400


def _unclipped_sig(a):
    """(ref_id, unclipped 5' position, strand) signature of one mate.

    samblaster's read signature: the 5' sequencing end projected through
    clipping — forward reads anchor at pos minus leading soft/hard clips,
    reverse reads at the alignment end plus trailing clips, so duplicates
    collide regardless of how the aligner clipped them."""
    if a.is_unmapped:
        return None
    cig = a.cigar or []
    lead = 0
    for n, op in cig:
        if op in "SH":
            lead += n
        else:
            break
    trail = 0
    for n, op in reversed(cig):
        if op in "SH":
            trail += n
        else:
            break
    if a.is_reverse:
        span = sum(n for n, op in cig if op in "MDN=X")
        return (a.ref_id, a.pos + span + trail, 1)
    return (a.ref_id, a.pos - lead, 0)


def mark_duplicates(alns):
    """Flag duplicate read pairs (samblaster's role in the mutant-read
    alignment pipe, runRufus.sh:1000: `bwa mem | samblaster | samtools
    sort`).

    Pairs whose two mates share (ref, unclipped 5' pos, strand) signatures
    with an earlier pair get FLAG_DUP on both mates; the first pair seen
    wins. Orphan pairs (one mate unmapped) key on the mapped signature
    alone, separately from full pairs, like samblaster's orphan bucket.
    Dup-flagged reads are then rejected by assembly (OverlapSam.cpp:736-741
    semantics in assembly/overlap_sam.py), keeping contig depths clean of
    PCR duplicates. Returns (new list, n pairs marked)."""
    by_name: dict[str, list] = {}
    order: list[str] = []
    for a in alns:
        if a.qname not in by_name:
            order.append(a.qname)
        by_name.setdefault(a.qname, []).append(a)
    seen: set = set()
    marked = 0
    out_map: dict[int, object] = {}
    for name in order:
        group = by_name[name]
        sigs = sorted((s for a in group if (s := _unclipped_sig(a))),
                      key=lambda t: (t[0], t[1], t[2]))
        if not sigs:
            continue
        key = ("orphan" if len(sigs) < 2 else "pair", tuple(sigs))
        if key in seen:
            for a in group:
                out_map[id(a)] = replace(a, flag=a.flag | FLAG_DUP)
            marked += 1
        else:
            seen.add(key)
    if not out_map:
        return list(alns), 0
    return [out_map.get(id(a), a) for a in alns], marked


def sort_alignments(alns):
    """samtools-sort coordinate order: (ref_id, pos), unmapped last; stable."""
    mapped = [a for a in alns if not a.is_unmapped]
    unmapped = [a for a in alns if a.is_unmapped]
    mapped.sort(key=lambda a: (a.ref_id, a.pos))
    return mapped + unmapped


def to_sam_line(a: Alignment, rnext: str = "*", pnext: int = 0,
                tlen: int = 0, tags: str = "") -> str:
    rname = a.ref_name if not a.is_unmapped or a.ref_name != "*" else "*"
    pos1 = a.pos + 1 if a.pos >= 0 else 0
    cig = a.cigar_string() if not a.is_unmapped else "*"
    fields = [a.qname, str(a.flag), rname, str(pos1), str(a.mapq), cig,
              rnext, str(pnext), str(tlen), a.seq, a.qual]
    line = "\t".join(fields)
    if tags:
        line += "\t" + tags
    return line


def write_sam(path: str, alns, ref_index):
    """Write a coordinate-sorted SAM. RNEXT/PNEXT/TLEN follow samtools
    semantics for name-paired records (TLEN = rightmost end - leftmost
    start, sign by leftmost; the reference's veryfast assembly filters on
    it, Overlap.shorter.sh:98 `$9 > 150 || $9 < -150`)."""
    ends: dict[str, list] = {}
    for a in alns:
        if (a.flag & FLAG_PAIRED) and not a.is_unmapped \
                and not a.is_supplementary:
            ends.setdefault(a.qname, []).append(a)
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:coordinate\n")
        for n in ref_index.names:
            f.write(f"@SQ\tSN:{n}\tLN:{ref_index.lengths[n]}\n")
        for a in alns:
            rnext, pnext, tlen = "*", 0, 0
            mates = ends.get(a.qname, [])
            # the mate is the record with the OPPOSITE mate flag — "any
            # other object" would pair a supplementary with its own
            # primary segment
            mate = next((m for m in mates
                         if (m.flag & 0xC0) != (a.flag & 0xC0)), None)
            if mate is not None and not a.is_unmapped:
                rnext = "=" if mate.ref_id == a.ref_id else mate.ref_name
                pnext = mate.pos + 1
                if mate.ref_id == a.ref_id:
                    lo = min(a.pos, mate.pos)
                    hi = max(a.pos + a.ref_span(), mate.pos + mate.ref_span())
                    tlen = hi - lo
                    # leftmost segment gets +; on a tie samtools/bwa give
                    # + to the FIRST segment (mate1), - to mate2
                    if a.pos > mate.pos or (a.pos == mate.pos
                                            and bool(a.flag & FLAG_MATE2)):
                        tlen = -tlen
            f.write(to_sam_line(a, rnext=rnext, pnext=pnext, tlen=tlen,
                                tags=f"NM:i:{a.nm}\tAS:i:{a.score}") + "\n")


def write_bam(path: str, alns, ref_index):
    """Write a coordinate-sorted, indexed BAM (+ .bai) — the reference's
    user-facing artifact form (`bwa | samblaster | samtools sort` +
    `samtools index`, runRufus.sh:1000-1001, Overlap.shorter.sh:209-218).
    Mate fields follow write_sam's samtools semantics exactly."""
    from ..io import bam as iobam

    ends: dict[str, list] = {}
    for a in alns:
        if (a.flag & FLAG_PAIRED) and not a.is_unmapped \
                and not a.is_supplementary:
            ends.setdefault(a.qname, []).append(a)
    name_to_id = {n: i for i, n in enumerate(ref_index.names)}
    refs = [(n, ref_index.lengths[n]) for n in ref_index.names]

    def records():
        for a in alns:
            nrid, npos, tlen = -1, -1, 0
            mates = ends.get(a.qname, [])
            mate = next((m for m in mates
                         if (m.flag & 0xC0) != (a.flag & 0xC0)), None)
            if mate is not None and not a.is_unmapped:
                nrid = name_to_id.get(mate.ref_name, -1)
                npos = mate.pos
                if mate.ref_id == a.ref_id:
                    lo = min(a.pos, mate.pos)
                    hi = max(a.pos + a.ref_span(),
                             mate.pos + mate.ref_span())
                    tlen = hi - lo
                    if a.pos > mate.pos or (a.pos == mate.pos
                                            and bool(a.flag & FLAG_MATE2)):
                        tlen = -tlen
            rid = name_to_id.get(a.ref_name, -1) if not a.is_unmapped else -1
            yield iobam.BamRecord(
                a.qname, a.flag, rid, a.pos if rid >= 0 else -1, a.mapq,
                a.cigar if not a.is_unmapped else [], a.seq, a.qual,
                nrid, npos, tlen)

    header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs)
    tag_iter = iter(alns)

    def tags_for(rec):
        a = next(tag_iter)
        return iobam._enc_tags([f"NM:i:{a.nm}", f"AS:i:{a.score}"])

    return iobam.write_bam(path, refs, records(), header_text=header,
                           tags_for=tags_for)
