"""Multi-contig SV passes: MOB insertions and big DEL/DUP.

Re-derivation of RUFUS.interpret.cpp: the SV helper methods
(BreakPoint 1132-1150, sigBreakPoint 1249-1266, isPolyA 1267-1410,
filterSV 697-712, GetQualityHashes 773-821, CheckGenotypes 822-836,
SVCheckParentsForLowCov 837-931, createStructGenotype 932-1131,
GetUnalignedCenter 4692-4754, InterpretInsertSize/TargetSize 4644-4691,
BreakpointInUnalignedCenter 1151-1230, ShittyGenotyper 472-487) and the
two multi-contig passes (MOB <INS:ME:MOB> 5896-6089, DEL/DUP 6090-6327).
"""

from __future__ import annotations

import math

from ..ops import codec
from .betterway import flip_read
from .samread import SamRead


def _g(x) -> str:
    if isinstance(x, int):
        return str(x)
    x = float(x)
    if x != x:
        return "-nan" if math.copysign(1, x) < 0 else "nan"
    return f"{x:.6g}"


def shitty_genotyper(alt: int, ref: int) -> str:
    if alt == 0 and ref == 0:
        return "."
    if alt == 0 and ref > 1:
        return "0/0"
    if alt > 0 and ref == 0:
        return "1/1"
    frac = alt / (ref + alt)
    if frac > 0.85:
        return "1/1"
    if frac < 0.15:
        return "0/0"
    return "0/1"


def break_point(read: SamRead) -> int:
    cs = read.cigar_string
    aligned = "MXDI"
    for i in range(1, len(read.seq)):
        if cs[i - 1] in "HS" and cs[i] in aligned:
            return i
        if cs[i] in "HS" and cs[i - 1] in aligned:
            return i
    return -1


def sig_break_point(read: SamRead) -> int:
    cs = read.cigar_string
    aligned = "MXDI"
    pm = read.peak_map
    for i in range(1, len(read.seq)):
        if cs[i - 1] in "HS" and cs[i] in aligned:
            if pm[i - 1] or pm[i]:
                return i
        elif cs[i - 1] in aligned and cs[i] in "HS":
            if pm[i - 1] or pm[i]:
                return i
    return -1


def filter_sv(read: SamRead) -> str:
    f = ""
    if read.strand_bias >= 0 and (read.strand_bias > 0.99 or read.strand_bias < 0.01):
        f += "SB;"
    if (read.alignment_segments > read.ctx.seg_threshold
            or read.alignment_segments_cigar > read.ctx.seg_threshold_cigar):
        f += "PA;"
    return f


def get_quality_hashes(read: SamRead, spot: int):
    """-> (Mut, Pos); counts HashList hits / candidate kmers near spot."""
    ctx = read.ctx
    k = ctx.k
    start = max(0, spot - k + 1)
    mut = 0
    possible = 0
    last_hash = ""
    ex = ctx.exclude_hashes
    i = start
    while i <= spot and i < len(read.seq) - k:
        h = read.seq[i : i + k]
        r = read.ref_seq[i : i + k]
        if (h != r and ex.get(ctx.h2l(h), 0) < 1
                and ex.get(ctx.h2l(codec.revcomp_str(h)), 0) < 1
                and h != last_hash):
            if h in ctx.hash:
                mut += 1
            elif codec.revcomp_str(h) in ctx.hash:
                mut += 1
            possible += 1  # bare block in the reference (808-813): every
            # candidate counts toward possible, hits toward mut
        last_hash = h
        i += 1
    return mut, possible


def check_genotypes(genotypes: str) -> bool:
    # C++ Split("") yields zero tokens -> false (822-836)
    if genotypes == "":
        return False
    parts = genotypes.split("\t")
    for p in parts:
        if p.startswith("."):
            return False
    return True


def sv_check_parents_low_cov(read: SamRead, spot: int) -> int:
    ctx = read.ctx
    k = ctx.k
    min_par_cov = 1
    n_par = len(ctx.parent_hashes)
    spar = [[] for _ in range(n_par)]
    streak = [0] * n_par
    start = max(0, spot - k + 1)
    ex = ctx.exclude_hashes
    i = start
    while i < spot and spot < len(read.seq):
        h = read.seq[i : i + k]
        hv = ctx.h2l(h)
        if ex.get(hv, 0) < 1 and ex.get(ctx.h2l(codec.revcomp_str(h)), 0) < 1:
            numlow = 0
            for kk in range(n_par):
                c = ctx.parent_hashes[kk].get(hv)
                if c is not None and 0 < c <= ctx.par_low_cov_threshold:
                    numlow += 1
            if numlow == 1:
                for kk in range(n_par):
                    c = ctx.parent_hashes[kk].get(hv)
                    if c is not None and min_par_cov < c <= ctx.par_low_cov_threshold:
                        streak[kk] += 1
                        if streak[kk] >= 3:
                            spar[kk].append(c)
                    else:
                        streak[kk] = 0
            else:
                streak = [0] * n_par
        i += 1
    return sum(1 for s in spar if len(s) >= 1)


def create_struct_genotype(read: SamRead, spot: int) -> str:
    if spot <= 0:
        return ""
    ctx = read.ctx
    k = ctx.k
    n_par = len(ctx.parent_hashes)
    mut_alt, mut_ref = [], []
    spar_alt = [[] for _ in range(n_par)]
    spar_ref = [[] for _ in range(n_par)]
    start = max(0, spot - k)
    i = start
    while i < spot and i + k < len(read.seq):
        h = read.seq[i : i + k]
        hv = ctx.h2l(h)
        if h in ctx.hash:
            mut_alt.append(ctx.hash[h])
            for pi in range(n_par):
                if hv in ctx.parent_hashes[pi]:
                    spar_alt[pi].append(ctx.parent_hashes[pi][hv])
        elif codec.revcomp_str(h) in ctx.hash:
            mut_alt.append(ctx.hash[codec.revcomp_str(h)])
            for pi in range(n_par):
                if hv in ctx.parent_hashes[pi]:
                    spar_alt[pi].append(ctx.parent_hashes[pi][hv])
        i += 1
    # reference window pull
    try:
        arr = ctx.ref.contig_array(read.chr)
        s = read.pos + spot - k
        refs = arr[max(0, s) : max(0, s) + 2 * k].tobytes().decode()
    except KeyError:
        refs = ""
    for i in range(0, max(0, len(refs) - k)):
        h = refs[i : i + k]
        hv = ctx.h2l(h)
        if hv in ctx.mutant_hashes:
            mut_ref.append(ctx.mutant_hashes[hv])
        for pi in range(n_par):
            if hv in ctx.parent_hashes[pi]:
                spar_ref[pi].append(ctx.parent_hashes[pi][hv])
    mut_alt.sort()
    mut_ref.sort()
    for v in spar_alt:
        v.sort()
    for v in spar_ref:
        v.sort()
    m_alt = mut_alt[0] if mut_alt else 0
    m_ref = mut_ref[0] if mut_ref else 0
    out = [f"{shitty_genotyper(m_alt, m_ref)}:{m_alt + m_ref}:{m_ref}:{m_alt}"]
    for pi in range(n_par):
        pa = spar_alt[pi][0] if spar_alt[pi] else 0
        pr = spar_ref[pi][0] if spar_ref[pi] else 0
        out.append(f"{shitty_genotyper(pa, pr)}:{pa + pr}:{pr}:{pa}")
    return "\t".join(out)


def is_poly_a(read: SamRead, others: list[SamRead]) -> int:
    MIN = 10
    for r in others:
        if bool(read.flag & 0x10) != bool(r.flag & 0x10):
            flip_read(r)
    start = end = -1
    base = "f"
    clipped = atpeak = False
    del_fix = 0
    fix = [0] * len(others)
    seq, cs = read.seq, read.cigar_string
    check = False
    i = 0
    while i + del_fix < len(seq):
        while i + del_fix < len(seq) and seq[i + del_fix] == "-":
            del_fix += 1
        if i + del_fix >= len(seq):
            break
        for j, r in enumerate(others):
            while i + fix[j] < len(r.seq) and r.seq[i + fix[j]] == "-":
                fix[j] += 1
        check = False
        for j, r in enumerate(others):
            idx = i + fix[j]
            if r.map_qual > 0 and idx < len(r.cigar_string) and r.cigar_string[idx] not in "SH":
                check = True
        c = seq[i + del_fix]
        cg = cs[i + del_fix]
        if base == "f" and c in "TA" and cg in "HS" and not check:
            base = c
            start = i + del_fix
        elif base != "f" and c == base and cg in "HS" and not check:
            pass
        elif base != "f" and ((c != base or cg not in "HS") or check):
            end = i + del_fix
            if end - start > MIN:
                for j in range(start, min(end + 1, len(seq))):
                    if read.peak_map[j]:
                        atpeak = True
                    if cs[j] in "HS":
                        clipped = True
            if clipped and atpeak:
                if read.clip_pattern == "mc":
                    return start
                if read.clip_pattern == "cm":
                    return end
            clipped = atpeak = False
            base = "f"
            start = end = -1
        i += 1
    if base != "f" and seq and seq[-1] == base and not check:
        end = len(seq) - 1
        if end - start > MIN:
            for j in range(start, end + 1):
                if read.peak_map[j]:
                    atpeak = True
                if cs[j] in "HS":
                    clipped = True
        if clipped and atpeak:
            return start
    return -1


def breakpoint_in_unaligned_center(a: SamRead, b: SamRead) -> bool:
    import copy

    A, B = a, copy.copy(b)
    if bool(A.flag & 0x10) != bool(B.flag & 0x10):
        B = copy.deepcopy(b)
        flip_read(B)
    del_a = del_b = 0
    start_align = end_align = in_unalign = False
    center_peak = 0
    i = 0
    while i + del_a < len(A.seq) and i + del_b < len(B.seq):
        while i + del_a < len(A.seq) and A.seq[i + del_a] == "-":
            del_a += 1
        while i + del_b < len(B.seq) and B.seq[i + del_b] == "-":
            del_b += 1
        if i + del_a >= len(A.seq) or i + del_b >= len(B.seq):
            break
        ca = A.cigar_string[i + del_a]
        cb = B.cigar_string[i + del_b]
        if ca not in "HS" or cb not in "SH":
            if not start_align and not end_align and not in_unalign:
                start_align = True
            if start_align and not end_align and in_unalign:
                end_align = True
        elif ca in "HS" and cb in "SH":
            in_unalign = True
            if center_peak == 0:
                end_align = False
            pa = A.peak_map[i + del_a] if i + del_a < len(A.peak_map) else 0
            pb = B.peak_map[i + del_b] if i + del_b < len(B.peak_map) else 0
            if pa or pb:
                center_peak += 1
        i += 1
    return start_align and end_align and in_unalign and center_peak > 0


def get_unaligned_center(a: SamRead, b: SamRead) -> str:
    if len(a.seq) != len(b.seq):
        return ""
    a_first = b_first = False
    out = []
    i = 0
    for i in range(len(a.seq)):
        ca, cb = a.cigar_string[i], b.cigar_string[i]
        if ca not in "SH" and cb in "SH":
            a_first = True
            break
        if cb not in "SH" and ca in "SH":
            b_first = True
            break
    while i < len(a.seq):
        ca, cb = a.cigar_string[i], b.cigar_string[i]
        if a_first:
            if ca not in "SH" and cb in "SH":
                pass
            elif (ca == "S" or ca != "H") and cb in "SH":
                out.append(a.seq[i])
            else:
                return "".join(out)
        elif b_first:
            if cb not in "SH" and ca in "SH":
                pass
            elif (cb == "S" or cb != "H") and ca in "SH":
                out.append(a.seq[i])
            else:
                return "".join(out)
        else:
            return ""
        i += 1
    return ""


def interpret_target_size(size: int) -> str:
    if size == 1:
        return "I"
    if size == -1:
        return "Y"
    if size == 0:
        return ""
    if size == 2:
        return "YY"
    if size == -2:
        return "DD"
    if size > 2:
        return f"{abs(size)}Y"
    if size < -2:
        return f"{abs(size)}D"
    return "ERROR"


def interpret_insert_size(s: str) -> str:
    if len(s) == 0:
        return ""
    if len(s) == 1:
        return "I"
    if len(s) == 2:
        return "II"
    return f"{len(s)}I"


def _ref_base(ctx, chrom, idx0):
    try:
        arr = ctx.ref.contig_array(chrom)
    except KeyError:
        return "N"
    if 0 <= idx0 < len(arr):
        return chr(arr[idx0]).upper()
    return ""


def mob_insertion_pass(reads: list[SamRead], vcf_out, sv_state):
    """Pass 1: paired-contig MOB insertions (5896-6089)."""
    for i in range(len(reads) - 1):
        r = reads[i]
        if not (r.is_split_read > 0 and r.mob_aligned):
            continue
        found = False
        bp = sig_break_point(r)
        if bp > 0:
            ctx = r.ctx
            start = -2
            while start + i < 0:
                start += 1
            j = start
            while j <= 2 and 0 <= j + i < len(reads):
                o = reads[i + j]
                if j != 0 and r.chr == o.chr and abs(r.pos - o.pos) < 2000:
                    temp = [reads[a] for a in o.alignments
                            if a != i + j and reads[a].map_qual > 30]
                    poly_bp = is_poly_a(o, temp)
                    if poly_bp > -1 and abs((r.pos + bp) - (o.pos + poly_bp)) < 50:
                        if ((r.clip_pattern == "cm" and o.clip_pattern == "mc")
                                or (r.clip_pattern == "mc" and o.clip_pattern == "cm")):
                            if r.sv_event_id == 0:
                                sv_state["id"] += 1
                                gt = create_struct_genotype(r, sig_break_point(r))
                                if not check_genotypes(gt):
                                    gt = create_struct_genotype(o, sig_break_point(o))
                                if r.clip_pattern == "mc":
                                    targetsize = (r.pos + bp) - (o.pos + sig_break_point(o))
                                else:
                                    targetsize = (o.pos + sig_break_point(o)) - (r.pos + bp)
                                fmt = interpret_target_size(targetsize) + "MOB-"
                                fmt += (f"LCa-{sv_check_parents_low_cov(r, sig_break_point(r))}"
                                        f"-LCb-{sv_check_parents_low_cov(o, sig_break_point(o))}-")
                                fmt += str(r.mob_as)
                                ref_b = _ref_base(ctx, r.chr, r.pos + bp - 1)
                                ffa = filter_sv(r)
                                ffb = ""
                                gmap = (1 if r.map_qual > 30 else 0) + (1 if o.map_qual > 30 else 0)
                                if gmap <= 0:
                                    fmt += "-LowMapQual"
                                    info_filter, filt = "LowMapQual", "LMQ"
                                elif ffa == "" and ffb == "":
                                    found = True
                                    fmt += "-DeNovo"
                                    info_filter, filt = "Pass", "PASS"
                                    for a in r.alignments:
                                        reads[a].sv_event_id = sv_state["id"]
                                    for a in o.alignments:
                                        reads[a].sv_event_id = sv_state["id"]
                                else:
                                    fmt += f"-{ffa},{ffb}"
                                    info_filter, filt = ffa + ffb, "fail"
                                am, ap = get_quality_hashes(r, sig_break_point(r))
                                bm, bp2 = get_quality_hashes(o, sig_break_point(o))
                                qual = ((am + bm) / (ap + bp2) * 100.0) if (ap + bp2) > 0 else 0.0
                                phase = r.phase if r.phase != "none" else (
                                    o.phase if o.phase != "none" else "none")
                                info = (f"SVTYPE=INS;END={r.pos + bp - 1};"
                                        f"MT={r.mob_contig};PH={phase};"
                                        f"FEX={info_filter};FS={am + bm}/{ap + bp2};"
                                        f"RN={r.name}_and_{o.name};"
                                        f"MQ={r.map_qual}_and_{o.map_qual};"
                                        f"cigar={r.cigar}_and_{o.cigar};"
                                        f"SB={_g(r.strand_bias)}_and_{_g(o.strand_bias)};"
                                        f"AS={r.alignment_segments}-{r.alignment_segments_cigar}"
                                        f"_and_{o.alignment_segments}-{o.alignment_segments_cigar}")
                                vcf_out.write(
                                    f"{r.chr}\t{r.pos + bp - 1}\t{fmt}\t{ref_b}\t"
                                    f"<INS:ME:MOB>\t{_g(qual)}\t{filt}\t{info}\t"
                                    f"GT:DP:RO:AO\t{gt}\n")
                j += 1
        if found:
            continue


def del_dup_pass(reads: list[SamRead], vcf_out, sv_state):
    """Pass 2: big DEL/DUP from 2-alignment same-chr contigs (6090-6327)."""
    for i in range(len(reads) - 1):
        r = reads[i]
        if not (len(r.alignments) == 2 and r.sv_event_id == 0):
            continue
        o = reads[r.alignments[1]]
        if r.chr != o.chr:
            continue
        if not (sig_break_point(r) > 0 or sig_break_point(o) > 0
                or breakpoint_in_unaligned_center(r, o)):
            continue
        dist = (o.pos + break_point(o)) - (r.pos + break_point(r))
        if dist <= r.ctx.max_variant_size:
            continue
        if bool(r.flag & 0x10) != bool(o.flag & 0x10):
            continue
        ctx = r.ctx
        if r.clip_pattern == "mc" and o.clip_pattern == "cm":
            svtype, min_mq, gmap_req, ref_off = "DEL", 40, 1, 0
            targetsize = -dist
        elif r.clip_pattern == "cm" and o.clip_pattern == "mc":
            svtype, min_mq, gmap_req, ref_off = "DUP", 20, 2, -1
            targetsize = dist
        else:
            continue
        sv_state["id"] += 1
        gt = create_struct_genotype(r, sig_break_point(r))
        if not check_genotypes(gt):
            gt = create_struct_genotype(o, sig_break_point(o))
        insertseq = get_unaligned_center(r, o)
        fmt = interpret_insert_size(insertseq) + interpret_target_size(targetsize)
        ref_b = _ref_base(ctx, r.chr, r.pos + break_point(r) - 1 + ref_off)
        alt = insertseq + f"<{svtype}>"
        ffa = filter_sv(r)
        gmap = (1 if r.map_qual > min_mq else 0) + (1 if o.map_qual > min_mq else 0)
        if gmap < gmap_req:
            fmt += "-LowMapQual"
            info_filter, filt = "LowMapQual", "LMQ"
        elif ffa == "":
            fmt += "-DeNovo"
            info_filter, filt = "Pass", "PASS"
            r.sv_event_id = sv_state["id"]
            o.sv_event_id = sv_state["id"]
        else:
            fmt += f"-{ffa}"
            info_filter, filt = ffa, "fail"
        am, ap = get_quality_hashes(r, break_point(r))
        qual = (am / ap * 100.0) if ap > 0 else 0.0
        phase = r.phase if r.phase != "none" else "none"
        svlen = targetsize if svtype == "DUP" else targetsize * 1
        info = (f"SVTYPE={svtype};END={o.pos + break_point(o)};"
                f"SVLEN={svlen};PH={phase};FEX={info_filter};"
                f"FS={am}/{ap};RN={r.name};"
                f"MQ={r.map_qual}_and_{o.map_qual};"
                f"cigar={r.cigar}_and_{o.cigar};SB={_g(r.strand_bias)};"
                f"AS={r.alignment_segments}-{r.alignment_segments_cigar}"
                f"_and_{o.alignment_segments}-{o.alignment_segments_cigar}")
        vcf_out.write(
            f"{r.chr}\t{r.pos + break_point(r) - 1}\t{fmt}\t{ref_b}\t{alt}\t"
            f"{_g(qual)}\t{filt}\t{info}\tGT:DP:RO:AO\t{gt}\n")
