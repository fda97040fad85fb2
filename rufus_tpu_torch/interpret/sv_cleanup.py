"""Cleanup SV passes: BND translocations, copy-paste insertions, inversions,
triple-alignment insertions, large inserts, orphan MOB, LastDitch breakends.

Re-derivation of RUFUS.interpret.cpp 6416-7729 plus helpers
getClippedSequence (671-696), MobAligneBases (4853-4897),
FindFirstAndLast (4898-4962), LastDitch (4963-5116). The control flow
(including `i = i + j; continue` loop-variable jumps) is preserved with
explicit index management.
"""

from __future__ import annotations

import copy

from .betterway import flip_read
from .samread import SamRead
from .sv import (_g, _ref_base, break_point, breakpoint_in_unaligned_center,
                 check_genotypes, create_struct_genotype, filter_sv,
                 get_quality_hashes, get_unaligned_center,
                 interpret_insert_size, interpret_target_size, is_poly_a,
                 sig_break_point, sv_check_parents_low_cov)


def _orient(flag: int) -> bool:
    return bool(flag & 0x10)


def _ref_sub(ctx, chrom, start0, length):
    try:
        arr = ctx.ref.contig_array(chrom)
    except KeyError:
        return ""
    start0 = max(0, start0)
    return arr[start0 : start0 + length].tobytes().decode()


def get_clipped_sequence(read: SamRead, pos: int, kind: str) -> str:
    if kind == "mc":
        return read.seq[pos:]
    if kind == "cm":
        return read.seq[:pos]
    return ""


def mob_aligne_bases(mob, read: SamRead) -> int:
    r = copy.deepcopy(read)
    if _orient(read.flag) != _orient(mob.flag):
        flip_read(r)
    mob_cs = getattr(mob, "cigarString", None) or getattr(mob, "cigar_string", "")
    mob_seq = mob.seq
    mob_base = 0
    md = rd = 0
    i = 0
    while i + rd < len(r.seq) and i + md < len(mob_seq):
        while i + md < len(mob_seq) and mob_seq[i + md] == "-":
            md += 1
        while i + rd < len(r.seq) and r.seq[i + rd] == "-":
            rd += 1
        if i + rd >= len(r.seq) or i + md >= len(mob_seq):
            break
        rc = r.cigar_string[i + rd] if i + rd < len(r.cigar_string) else "?"
        mc = mob_cs[i + md] if i + md < len(mob_cs) else "?"
        if rc in "HS" and mc not in "HS":
            mob_base += 1
        i += 1
    return mob_base


def find_first_and_last(R: list[SamRead]):
    shortest = min((len(r.seq) for r in R), default=0)
    considering = []
    for j in range(len(R)):
        if _orient(R[0].flag) != _orient(R[j].flag):
            flip_read(R[j])
        considering.append(sig_break_point(R[j]) > 0)
    A = B = -1
    for i in range(shortest):
        for j in range(len(R)):
            if i < len(R[j].cigar_string) and R[j].cigar_string[i] not in "HS" and considering[j]:
                A = j
                break
        if A != -1:
            break
    for r in R:
        flip_read(r)
    for i in range(shortest):
        for j in range(len(R)):
            if i < len(R[j].cigar_string) and R[j].cigar_string[i] not in "HS" and considering[j]:
                B = j
                break
        if B != -1:
            break
    return A, B


def last_ditch(reads, i, A, B, sv_state, vcf_out):
    ra = reads[reads[i].alignments[A]]
    rb = reads[reads[i].alignments[B]]
    ctx = ra.ctx
    bp = break_point(ra)
    sbp = break_point(rb)
    sv_state["id"] += 1
    for k in ra.alignments:
        reads[k].sv_event_id = sv_state["id"]
    gt = create_struct_genotype(ra, bp)
    fmt = f"OrphanBND-LC={sv_check_parents_low_cov(ra, bp)}"
    ref = _ref_sub(ctx, ra.chr, ra.pos + bp - 1, 1)
    sv_state["bnd"] += 1
    ra.bnd_id = sv_state["bnd"]
    sv_state["bnd"] += 1
    rb.bnd_id = sv_state["bnd"]
    alt = ""
    svdes = ""
    if ra.clip_pattern == "mc":
        ref = _ref_sub(ctx, ra.chr, ra.pos + bp - 1, 1)
        altseq = _ref_sub(ctx, reads[i].chr, reads[i].pos + bp - 1 - 1, 1)
        if _orient(ra.flag) == _orient(rb.flag):
            insertseq = get_unaligned_center(ra, rb)
            alt = f"{altseq}{insertseq}[{rb.chr}:{rb.pos + sbp - 1}["
            fmt += f"bnd_{ra.bnd_id}"
            svdes = "Translocation"
        else:
            temp = copy.deepcopy(rb)
            flip_read(temp)
            insertseq = get_unaligned_center(ra, temp)
            alt = f"{altseq}{insertseq}]{rb.chr}:{rb.pos + sbp - 1}]"
            fmt += f"bnd_{ra.bnd_id}"
            svdes = "InvertedTranslocation"
    elif ra.clip_pattern == "cm":
        ref = _ref_sub(ctx, ra.chr, ra.pos + bp - 1, 1)
        altseq = _ref_sub(ctx, ra.chr, ra.pos + bp - 1, 1)
        if _orient(ra.flag) == _orient(rb.flag):
            alt = f"]{rb.chr}:{rb.pos + sbp}]{altseq}"
            fmt += f"bnd_{ra.bnd_id}"
            svdes = "Translocation"
        else:
            alt = f"[{rb.chr}:{rb.pos + sbp - 1}[{altseq}"
            fmt += f"bnd_{ra.bnd_id}"
            svdes = "InvertedTranslocation"
    else:
        ref = _ref_sub(ctx, ra.chr, ra.pos + bp - 1, 1)
        altseq = _ref_sub(ctx, ra.chr, ra.pos + bp - 1, 1)
        insertseq = get_unaligned_center(ra, rb)
        alt = f"{altseq}{insertseq}[{rb.chr}:{rb.pos + sbp - 1}["
        fmt += f"bnd_{ra.bnd_id}"
        svdes = "MessyTranslocations"
    ffa = filter_sv(ra)
    gmap = 1 if ra.map_qual > 30 else 0
    if sv_check_parents_low_cov(ra, sig_break_point(ra)) >= 1:
        fmt += "-Inherited"
        info_filter, filt = "Inherited", "LCH"
    elif gmap < 1:
        fmt += "-LowMapQual"
        info_filter, filt = "LowMapQual", "LMQ"
    elif ffa == "":
        fmt += "-DeNovo"
        info_filter, filt = "Pass", "PASS"
    else:
        fmt += f"-{ffa}"
        info_filter, filt = ffa, "fail"
    am, ap = get_quality_hashes(ra, bp)
    qual = (am / ap * 100.0) if ap > 0 else 0.0
    phase = ra.phase if ra.phase != "none" else "none"
    info = (f"SVTYPE=BND;MATEID=bnd_{rb.bnd_id};SVDES={svdes};PH={phase};"
            f"FEX={info_filter};FS={am}/{ap};RN={ra.name};"
            f"MQ={ra.map_qual}_and_{rb.map_qual};"
            f"cigar={ra.cigar}_and_{rb.cigar};SB={_g(ra.strand_bias)};"
            f"AS={ra.alignment_segments}-{ra.alignment_segments_cigar}_and_")
    vcf_out.write(f"{ra.chr}\t{ra.pos + bp - 1}\t{fmt}\t{ref}\t{alt}\t"
                  f"{_g(qual)}\t{filt}\t{info}\tGT:DP:RO:AO\t{gt}\n")


def _emit_bnd_record(ctx, vcf_out, r, mate, bp, sbp, ins_correct, del_correct,
                     bnd_label, sv_id, gmap_fail, ffa, ffb, qual_read):
    """Shared TRANS/InvTRANS breakend emission (one side)."""
    fmt_parts = []
    svdes = ""
    alt = ""
    ref = ""
    offset = bp
    if r.clip_pattern == "mc":
        offset = bp - 1 - ins_correct
        ref = _ref_sub(ctx, r.chr, r.pos + bp - 1 - 1 - ins_correct, 1 + abs(del_correct))
        altseq = _ref_sub(ctx, r.chr, r.pos + bp - 1 - 1 - ins_correct, 1 + ins_correct)
        if _orient(r.flag) == _orient(mate.flag):
            insertseq = get_unaligned_center(r, mate)
            alt = f"{altseq}{insertseq}[{mate.chr}:{mate.pos + sbp - 1}["
            fmt_parts.append(bnd_label.format(kind="TRANS"))
            svdes = "Translocation"
        else:
            temp = copy.deepcopy(mate)
            flip_read(temp)
            insertseq = get_unaligned_center(r, temp)
            alt = f"{altseq}{insertseq}]{mate.chr}:{mate.pos + sbp - 1}]"
            fmt_parts.append(bnd_label.format(kind="InvTRANS"))
            svdes = "InvertedTranslocation"
    elif r.clip_pattern == "cm":
        offset = bp - 1
        ref = _ref_sub(ctx, r.chr, r.pos + bp - 1, 1)
        altseq = _ref_sub(ctx, r.chr, r.pos + bp - 1, 1)
        if _orient(r.flag) == _orient(mate.flag):
            alt = f"]{mate.chr}:{mate.pos + sbp}]{altseq}"
            fmt_parts.append(bnd_label.format(kind="TRANS"))
            svdes = "Translocation"
        else:
            alt = f"[{mate.chr}:{mate.pos + sbp - 1}[{altseq}"
            fmt_parts.append(bnd_label.format(kind="InvTRANS"))
            svdes = "InvertedTranslocation"
    return "".join(fmt_parts), svdes, ref, alt, offset


def cleanup_pass(reads: list[SamRead], vcf_out, mobs, sv_state):
    """The full 6416-7729 loop."""
    n = len(reads)
    i = 0
    while i < n - 1:
        advanced = False
        r = reads[i]
        ctx = r.ctx
        # ---- translocation / copy-paste pairs ----
        if len(r.alignments) == 2:
            ra1 = reads[r.alignments[1]]
            if ((sig_break_point(r) > 0 or sig_break_point(ra1) > 0
                 or breakpoint_in_unaligned_center(r, ra1))
                    and len(r.clip_pattern) == 2 and len(ra1.clip_pattern) == 2):
                start = -2
                while start + i < 0:
                    start += 1
                j = start
                while j < 3 and i + j < n:
                    o = reads[i + j]
                    if (o.name != r.name and len(o.alignments) == 2
                            and len(o.clip_pattern) == 2
                            and len(reads[o.alignments[1]].clip_pattern) == 2
                            and abs(o.alignments[1] - r.alignments[1]) in (1, 2)):
                        ob1 = reads[o.alignments[1]]
                        if (sig_break_point(o) > 0 or sig_break_point(ob1) > 0
                                or breakpoint_in_unaligned_center(o, ob1)):
                            if o.chr == r.chr and ob1.chr == ra1.chr:
                                breaks = sum([
                                    sig_break_point(r) > 0,
                                    sig_break_point(ra1) > 0,
                                    sig_break_point(o) > 0,
                                    sig_break_point(ob1) > 0,
                                ])
                                gmap = sum([
                                    r.map_qual > 30, ra1.map_qual > 30,
                                    o.map_qual > 30, ob1.map_qual > 30,
                                ])
                                # (A || (B && breaks>=3)) per C++ precedence
                                if (sig_break_point(r) > 0
                                        or (sig_break_point(o) > 0 and breaks >= 3)):
                                    if r.chr != ra1.chr:
                                        if r.sv_event_id == o.sv_event_id:
                                            jumped = _emit_trans_pair(
                                                reads, i, j, vcf_out, sv_state, gmap)
                                            if jumped:
                                                if j >= 0:
                                                    i = i + j
                                                advanced = True
                                                break
                                    else:
                                        jumped = _emit_copy_paste(
                                            reads, i, j, vcf_out, sv_state, gmap)
                                        if jumped:
                                            if j >= 0:
                                                i = i + j
                                            advanced = True
                                            break
                    j += 1
        if advanced:
            i += 1
            continue
        r = reads[i]
        # ---- inversions ----
        if len(r.alignments) == 2 and r.sv_event_id == 0:
            ra1 = reads[r.alignments[1]]
            if (r.chr == ra1.chr and _orient(r.flag) != _orient(ra1.flag)
                    and sig_break_point(r) > 0):
                start = -2
                while start + i < 0:
                    start += 1
                j = start
                while j <= 1 and 0 <= j + i < n:
                    o = reads[i + j]
                    if (r.chr == o.chr and len(o.alignments) > 1 and j != 0):
                        ob1 = reads[o.alignments[1]]
                        if (o.chr == ob1.chr and _orient(o.flag) != _orient(ob1.flag)
                                and sig_break_point(o) > 0
                                and abs(o.alignments[1] - r.alignments[1]) == 1):
                            _emit_inversion(reads, i, j, vcf_out, sv_state)
                            if j >= 0:
                                i = i + j
                            advanced = True
                            break
                    j += 1
        if advanced:
            i += 1
            continue
        r = reads[i]
        # ---- triple-alignment insertion ----
        if len(r.alignments) == 3 and sig_break_point(r) > 0:
            _emit_triple(reads, i, vcf_out, sv_state)
        # ---- large insert ----
        r = reads[i]
        if (len(r.alignments) >= 1 and r.clip_pattern == "mc"
                and sig_break_point(r) > 0 and r.sv_event_id == 0):
            start = -5
            while start + i < 0:
                start += 1
            j = start
            while j <= 5 and 0 <= j + i < n:
                o = reads[i + j]
                if (len(o.alignments) == 1 and o.clip_pattern == "cm"
                        and sig_break_point(o) > 0 and r.chr == o.chr
                        and o.sv_event_id == 0):
                    pos_i = r.pos + sig_break_point(r)
                    pos_j = o.pos + sig_break_point(o)
                    if (abs(pos_i - pos_j) < 1000000 and r.sv_event_id == 0
                            and o.sv_event_id == 0 and r.map_qual > 0
                            and o.map_qual > 0):
                        _emit_large_insert(reads, i, i + j, vcf_out, sv_state)
                j += 1
        # ---- orphan single-contig MOB ----
        r = reads[i]
        if r.is_split_read > 0 and r.sv_event_id == 0:
            _emit_orphan_mob(reads, i, vcf_out, mobs, sv_state)
        # ---- last ditch ----
        r = reads[i]
        if r.is_split_read > 0 and r.sv_event_id == 0 and len(r.alignments) > 1:
            temp = [copy.deepcopy(reads[a]) for a in r.alignments]
            A, B = find_first_and_last(temp)
            if A >= 0 and B >= 0:
                last_ditch(reads, i, A, B, sv_state, vcf_out)
                ra = reads[reads[i].alignments[A]]
                rb = reads[reads[i].alignments[B]]
                if A != B and (sig_break_point(ra) > 0 or sig_break_point(rb) > 0
                               or breakpoint_in_unaligned_center(ra, rb)):
                    last_ditch(reads, i, B, A, sv_state, vcf_out)
        i += 1


def _emit_trans_pair(reads, i, j, vcf_out, sv_state, gmap):
    r = reads[i]
    o = reads[i + j]
    ra1 = reads[r.alignments[1]]
    ob1 = reads[o.alignments[1]]
    ctx = r.ctx
    if r.sv_event_id == 0:
        sv_state["id"] += 1
        for rr in (r, o, ra1, ob1):
            sv_state["bnd"] += 1
            rr.bnd_id = sv_state["bnd"]
    bp = break_point(r)
    bpj = break_point(o)
    sbp = break_point(ra1)
    sbpj = break_point(ob1)
    if r.clip_pattern == "mc":
        targetsize = (r.pos + bp) - (o.pos + bpj)
    else:
        targetsize = (o.pos + bpj) - (r.pos + bp)
    ins_c = max(0, targetsize)
    del_c = min(0, targetsize)
    ffa = filter_sv(r)
    ffb = filter_sv(o)
    mq_ok = ((r.map_qual > 0 or o.map_qual > 0)
             and (ra1.map_qual > 0 or ob1.map_qual > 0))

    def filters(fmt):
        if gmap < 1 or not mq_ok:
            return fmt + "-LowMapQual", "LowMapQual", "LMQ", False
        if ffa == "" and ffb == "":
            return fmt + "-DeNovo", "Pass", "PASS", True
        return fmt, ffa + ffb, "fail", False

    # side 1
    fmt = ""
    svdes = ""
    ref = alt = ""
    offset = bp
    if r.clip_pattern == "mc":
        offset = bp - 1 - ins_c
        ref = _ref_sub(ctx, r.chr, r.pos + bp - 1 - 1 - ins_c, 1 + abs(del_c))
        altseq = _ref_sub(ctx, r.chr, r.pos + bp - 1 - 1 - ins_c, 1 + ins_c)
        if _orient(r.flag) == _orient(ra1.flag):
            insertseq = get_unaligned_center(r, ra1)
            alt = f"{altseq}{insertseq}[{ra1.chr}:{ra1.pos + sbp - 1}["
            fmt = (interpret_insert_size(insertseq)
                   + interpret_target_size(targetsize) + "_"
                   + f"TRANS_{r.bnd_id}")
            svdes = "Translocation"
        else:
            temp = copy.deepcopy(ra1)
            flip_read(temp)
            insertseq = get_unaligned_center(r, temp)
            alt = f"{altseq}{insertseq}]{ra1.chr}:{ra1.pos + sbp - 1}]"
            fmt = (interpret_insert_size(insertseq)
                   + interpret_target_size(targetsize) + "_"
                   + f"InvTRANS_{r.bnd_id}")
            svdes = "InvertedTranslocation"
    elif r.clip_pattern == "cm":
        offset = bp - 1
        ref = _ref_sub(ctx, r.chr, r.pos + bp - 1, 1)
        altseq = ref
        if _orient(r.flag) == _orient(ra1.flag):
            alt = f"]{ra1.chr}:{ra1.pos + sbp}]{altseq}"
            fmt = f"TRANS_{r.bnd_id}"
            svdes = "Translocation"
        else:
            alt = f"[{ra1.chr}:{ra1.pos + sbp - 1}[{altseq}"
            fmt = f"InvTRANS_{r.bnd_id}"
            svdes = "InvertedTranslocation"
    fmt, info_filter, filt, passed = filters(fmt)
    if passed:
        for rr in (r, o, ra1, ob1):
            rr.sv_event_id = sv_state["id"]
    am, ap = get_quality_hashes(r, bp)
    qual = (am / ap * 100.0) if ap > 0 else 0.0
    phase = r.phase if r.phase != "none" else (o.phase if o.phase != "none" else "none")
    info = (f"SVTYPE=TRANS;MATEID=TRANS_{ra1.bnd_id};SVID={sv_state['id']};"
            + (f"SVDES={svdes};" if svdes else "")
            + f"PH={phase};FEX={info_filter};FS={am}/{ap};RN={r.name};"
            f"MQ={r.map_qual};cigar={r.cigar};SB={_g(r.strand_bias)};"
            f"AS={r.alignment_segments}-{r.alignment_segments_cigar}")
    gt_a = create_struct_genotype(r, bp)
    vcf_out.write(f"{r.chr}\t{r.pos + offset}\t{fmt}\t{ref}\t{alt}\t"
                  f"{_g(qual)}\t{filt}\t{info}\tGT:DP:RO:AO\t{gt_a}\n")
    # side 2
    fmt2 = ""
    svdes = ""
    ref2 = alt2 = ""
    offset2 = 0
    if o.clip_pattern == "mc":
        offset2 = bpj - 1 - ins_c
        ref2 = _ref_sub(ctx, o.chr, o.pos + bpj - 1 - 1 - ins_c, 1 + abs(del_c))
        altseq = _ref_sub(ctx, o.chr, o.pos + bpj - 1 - 1 - ins_c, 1 + ins_c)
        if _orient(o.flag) == _orient(ob1.flag):
            alt2 = f"{altseq}[{ob1.chr}:{ob1.pos + sbpj}["
            fmt2 = f"TRANS_{o.bnd_id}"
            svdes = "Translocation"
        else:
            alt2 = f"{altseq}]{ob1.chr}:{ob1.pos + sbpj}]"
            fmt2 = f"InvTRANS_{o.bnd_id}"
            svdes = "InvertedTranslocation"
    elif o.clip_pattern == "cm":
        offset2 = bpj
        ref2 = _ref_sub(ctx, o.chr, o.pos + bpj - 1, 1)
        altseq = _ref_sub(ctx, o.chr, o.pos + bpj - 1, 1)
        if _orient(o.flag) == _orient(ob1.flag):
            alt2 = f"]{ob1.chr}:{ob1.pos + sbpj}]{altseq}"
            fmt2 = f"TRANS_{o.bnd_id}"
            svdes = "Translocation"
        else:
            alt2 = f"[{ob1.chr}:{ob1.pos + sbpj}[{altseq}"
            fmt2 = f"InvTRANS_{o.bnd_id}"
            svdes = "InvertedTranslocation"
    am2, ap2 = get_quality_hashes(o, bpj)
    qual2 = (am2 / ap2 * 100.0) if ap2 > 0 else 0.0
    if gmap < 1 or not mq_ok:
        fmt2 += "-LowMapQual"
        info_filter2, filt2 = "LowMapQual", "LMQ"
    elif ffa == "" and ffb == "":
        info_filter2, filt2 = "Pass", "PASS"
    else:
        info_filter2, filt2 = ffa + ffb, "fail"
    phase2 = o.phase if o.phase != "none" else "none"
    info2 = (f"SVTYPE=BND;MATEID=TRANS_{ob1.bnd_id};SVID={sv_state['id']};"
             + (f"SVDES={svdes};" if svdes else "")
             + f"PH={phase2};FEX={info_filter2};FS={am2}/{ap2};RN={o.name};"
             f"MQ={o.map_qual};cigar={o.cigar};SB={_g(o.strand_bias)};"
             f"AS={o.alignment_segments}-{o.alignment_segments_cigar}")
    gt_b = create_struct_genotype(o, bpj)
    vcf_out.write(f"{o.chr}\t{o.pos + offset2}\t{fmt2}\t{ref2}\t{alt2}\t"
                  f"{_g(qual2)}\t{filt2}\t{info2}\tGT:DP:RO:AO\t{gt_b}\n")
    return True


def _emit_copy_paste(reads, i, j, vcf_out, sv_state, gmap):
    r = reads[i]
    o = reads[i + j]
    ra1 = reads[r.alignments[1]]
    ob1 = reads[o.alignments[1]]
    ctx = r.ctx
    if (r.clip_pattern == "mc" and ra1.clip_pattern == "cm"
            and o.clip_pattern == "cm" and ob1.clip_pattern == "mc"):
        enter_a, exit_b, exit_a, enter_b = i, r.alignments[1], i + j, o.alignments[1]
    elif (r.clip_pattern == "cm" and ra1.clip_pattern == "mc"
          and o.clip_pattern == "mc" and ob1.clip_pattern == "cm"):
        exit_a, enter_b, enter_a, exit_b = i, r.alignments[1], i + j, o.alignments[1]
    else:
        return False
    REA, RXA = reads[enter_a], reads[exit_a]
    REB, RXB = reads[enter_b], reads[exit_b]
    if REA.pos + break_point(REA) <= RXA.pos + break_point(RXA):
        event_pos = REA.pos + break_point(REA) - 1
        target = (RXA.pos + break_point(RXA)) - (REA.pos + break_point(REA))
    elif REB.pos + break_point(REB) <= RXB.pos + break_point(RXB):
        event_pos = REB.pos + break_point(REB) - 1
        target = (RXB.pos + break_point(RXB)) - (REB.pos + break_point(REB))
    else:
        target = -1
        event_pos = -1
    if not (0 <= target < 1000000):
        return False
    ref_seq = _ref_sub(ctx, REA.chr, event_pos - 1, 1 + target)
    alt_seq = _ref_sub(ctx, REA.chr, event_pos - 1, 1)
    if REB.pos + break_point(REB) > RXB.pos + break_point(RXB):
        ins_chr = REB.chr
        ins_start = RXB.pos + break_point(RXB)
        ins_end = REB.pos + break_point(REB)
        ins_size = ins_end - ins_start
        insert = _ref_sub(ctx, REA.chr, ins_start - 1, ins_size)
    elif REA.pos + break_point(REA) > RXA.pos + break_point(RXA):
        ins_chr = REA.chr
        ins_start = RXA.pos + break_point(RXA)
        ins_end = REA.pos + break_point(REA)
        ins_size = ins_end - ins_start
        insert = _ref_sub(ctx, REA.chr, ins_start - 1, ins_size)
    else:
        return False
    alt_seq += insert
    if ins_size <= 0:
        return False
    ffa = filter_sv(r)
    ffb = filter_sv(o)
    fmt = (interpret_target_size(target * -1) + str(len(insert))
           + f"-{ins_size}CopyPaste")
    mq_ok = ((r.map_qual > 0 or o.map_qual > 0)
             and (ra1.map_qual > 0 or ob1.map_qual > 0))
    if gmap < 1 or not mq_ok:
        fmt += "-LowMapQual"
        info_filter, filt = "LowMapQual", "LMQ"
    elif ffa == "" and ffb == "":
        info_filter, filt = "Pass", "PASS"
    else:
        info_filter, filt = ffa + ffb, "fail"
    if r.sv_event_id != 0:
        return False
    sv_state["id"] += 1
    for k in r.alignments:
        reads[k].sv_event_id = sv_state["id"]
    for k in o.alignments:
        reads[k].sv_event_id = sv_state["id"]
    am, ap = get_quality_hashes(r, sig_break_point(r))
    bm, bpq = get_quality_hashes(o, sig_break_point(o))
    qual = ((am + bm) / (ap + bpq) * 100.0) if (ap + bpq) > 0 else 0.0
    phase = o.phase if o.phase != "none" else "none"
    info = (f"SVTYPE=COPY:PASTE;;SOURCE={ins_chr}:{ins_start}-{ins_end};"
            f"SVID={o.sv_event_id};PH={phase};FEX={info_filter};"
            f"FS={am + bm}/{ap + bpq};RN={r.name}_and_{o.name};"
            f"MQ={r.map_qual}_and_{o.map_qual};"
            f"cigar={r.cigar}_and_{o.cigar};"
            f"SB={_g(r.strand_bias)}_and_{_g(o.strand_bias)};"
            f"AS={r.alignment_segments}-{r.alignment_segments_cigar}"
            f"_and_{o.alignment_segments}-{o.alignment_segments_cigar}")
    for cand in (r, o, ra1, ob1):
        gt = create_struct_genotype(cand, sig_break_point(cand))
        if check_genotypes(gt):
            break
    vcf_out.write(f"{r.chr}\t{event_pos}\t{fmt}\t{ref_seq}\t{alt_seq}\t"
                  f"{_g(qual)}\t{filt}\t{info}\tGT:DP:RO:AO\t{gt}\n")
    return True


def _emit_inversion(reads, i, j, vcf_out, sv_state):
    r = reads[i]
    o = reads[i + j]
    ra1 = reads[r.alignments[1]]
    ob1 = reads[o.alignments[1]]
    ctx = r.ctx
    pos_aa = r.pos + sig_break_point(r)
    pos_ba = o.pos + sig_break_point(o)
    pos_ab = ra1.pos + sig_break_point(ra1)
    pos_bb = ob1.pos + sig_break_point(ob1)
    if not (pos_aa < pos_ab and pos_ba < pos_bb and r.clip_pattern != o.clip_pattern):
        return False
    sv_state["id"] += 1
    pos = min(pos_aa, pos_ba)
    end = max(pos_ab, pos_bb)
    start_break = 0
    if r.clip_pattern == "mc" and o.clip_pattern == "cm":
        start_break = pos_aa - pos_ba
    elif r.clip_pattern == "cm" and o.clip_pattern == "mc":
        start_break = pos_ba - pos_aa
    end_break = 0
    if ra1.clip_pattern == "mc" and ob1.clip_pattern == "cm":
        end_break = pos_ab - pos_bb
    elif ra1.clip_pattern == "cm" and ob1.clip_pattern == "mc":
        start_break = pos_bb - pos_ab  # reference quirk: overwrites startBreak
    size = end - pos
    temp = copy.deepcopy(ra1)
    flip_read(temp)
    start_ins = get_unaligned_center(r, temp)
    temp = copy.deepcopy(ob1)
    flip_read(temp)
    end_ins = get_unaligned_center(o, temp)
    ref = _ref_sub(ctx, r.chr, pos - 1 - 1, 1)
    alt = f"{start_ins}<INV>{end_ins}"
    am, ap = get_quality_hashes(r, sig_break_point(r))
    bm, bpq = get_quality_hashes(o, sig_break_point(o))
    qual = ((am + bm) / (ap + bpq) * 100.0) if (ap + bpq) > 0 else 0.0
    phase = r.phase if r.phase != "none" else (o.phase if o.phase != "none" else "none")
    ffa = filter_sv(r)
    ffb = filter_sv(o)
    gmap = sum([r.map_qual > 30, ra1.map_qual > 30, o.map_qual > 30,
                ob1.map_qual > 30])
    fmt = ""
    if start_break > 0:
        fmt += f"{abs(start_break)}Y"
    elif start_break < 0:
        fmt += f"{abs(start_break)}D"
    fmt += interpret_insert_size(start_ins)
    fmt += f"{size - abs(start_break) - abs(end_break)}V"
    if end_break > 0:
        fmt += f"{abs(end_break)}Y"
    elif end_break < 0:
        fmt += f"{abs(end_break)}D"
    fmt += interpret_insert_size(end_ins)
    if gmap < 1:
        fmt += "-LowMapQual"
        info_filter, filt = "LowMapQual", "LMQ"
    elif ffa == "" and ffb == "":
        fmt += "-DeNovo"
        info_filter, filt = "Pass", "PASS"
        for k in r.alignments:
            reads[k].sv_event_id = sv_state["id"]
        for k in o.alignments:
            reads[k].sv_event_id = sv_state["id"]
    else:
        fmt += f"-{ffa},{ffb}"
        info_filter, filt = ffa + ffb, "fail"
    info = (f"SVTYPE=INV;END={end};PH={phase};FEX={info_filter};"
            f"FS={am + bm}/{ap + bpq};RN={r.name}_and_{o.name};"
            f"MQ={r.map_qual}_and_{o.map_qual};"
            f"cigar={r.cigar}_and_{o.cigar};"
            f"SB={_g(r.strand_bias)}_and_{_g(o.strand_bias)};"
            f"AS={r.alignment_segments}-{r.alignment_segments_cigar}"
            f"_and_{o.alignment_segments}-{o.alignment_segments_cigar}")
    for cand in (r, o, ra1, ob1):
        gt = create_struct_genotype(cand, sig_break_point(cand))
        if check_genotypes(gt):
            break
    vcf_out.write(f"{r.chr}\t{pos - 1}\t{fmt}\t{ref}\t{alt}\t{_g(qual)}\t"
                  f"{filt}\t{info}\tGT:DP:RO:AO\t{gt}\n")
    return True


def _emit_triple(reads, i, vcf_out, sv_state):
    r = reads[i]
    ctx = r.ctx

    def by_pattern(p):
        if r.clip_pattern == p:
            return i
        if reads[r.alignments[1]].clip_pattern == p:
            return r.alignments[1]
        if reads[r.alignments[2]].clip_pattern == p:
            return r.alignments[2]
        return -1

    start = by_pattern("mc")
    mid = by_pattern("cmc")
    exit_ = by_pattern("cm")
    if not (start > 1 and mid > 1 and exit_ > 1):
        return False
    rs, rm, rx = reads[start], reads[mid], reads[exit_]
    if not (rs.chr == rx.chr and (sig_break_point(rx) > 0 or sig_break_point(rs) > 0)
            and rx.map_qual > 0 and rs.map_qual > 0):
        return False
    target = ((rx.pos + sig_break_point(rx)) - (rs.pos + sig_break_point(rs))) * -1
    if rs.sv_event_id != 0:
        return False
    pos = rs.pos + break_point(rs) - 1
    sv_state["id"] += 1
    gt = create_struct_genotype(rs, break_point(rs))
    if not check_genotypes(gt):
        gt2 = create_struct_genotype(rx, break_point(rx))
        gt = gt2 if check_genotypes(gt2) else create_struct_genotype(rx, break_point(rm))
    fmt = interpret_target_size(target) + "trippleDUP"
    ref = _ref_sub(ctx, rs.chr, rs.pos + break_point(rs) - 1 - 1, 1)
    if target < 0:
        ref += _ref_sub(ctx, rs.chr, rs.pos + break_point(rs) - 1, -target)
    alt = _ref_sub(ctx, rs.chr, rs.pos + break_point(rs) - 1 - 1, 1)
    if target > 0:
        alt += _ref_sub(ctx, rs.chr, rs.pos + break_point(rs) - 1, target)
    alt += rm.seq[break_point(rs) : break_point(rx)]
    ffa, ffb, ffc = filter_sv(rs), filter_sv(rm), filter_sv(rx)
    gmap = sum([rs.map_qual > 30, rm.map_qual > 30, rx.map_qual > 30])
    if gmap < 1:
        fmt += "-LowMapQual"
        info_filter, filt = "LowMapQual", "LMQ"
    elif ffa == "" and ffb == "" and ffc == "":
        fmt += "-DeNovo"
        info_filter, filt = "Pass", "PASS"
        rs.sv_event_id = rm.sv_event_id = rx.sv_event_id = sv_state["id"]
    else:
        fmt += f"-{ffa},{ffb}"
        info_filter, filt = ffa + ffb, "fail"
    am, ap = get_quality_hashes(rs, break_point(rs))
    bm, bpq = get_quality_hashes(rx, break_point(rx))
    qual = ((am + bm) / (ap + bpq) * 100.0) if (ap + bpq) > 0 else 0.0

    def count_bases_aligned(read, s):
        c = 0
        for k in range(s, len(read.seq)):
            if read.cigar_string[k] in "MXDI":
                c += 1
            else:
                return c
        return c

    phase = rs.phase if rs.phase != "none" else (
        rx.phase if rx.phase != "none" else (rm.phase if rm.phase != "none" else "none"))
    info = (f"SVTYPE=INS;END={rs.pos + break_point(rs) - 1};"
            f"SOURCE={rm.chr}:{rm.pos + break_point(rm)}-"
            f"{rm.pos + break_point(rm) + count_bases_aligned(rm, break_point(rm))};"
            f"PH={phase};FEX={info_filter};FS={am + bm}/{ap + bpq};"
            f"RN={rs.name};MQ={rs.map_qual}_and_{rm.map_qual}_and_{rx.map_qual};"
            f"cigar={rs.cigar}_and_{rm.cigar}_and_{rx.cigar};"
            f"SB={_g(rs.strand_bias)};"
            f"AS={rs.alignment_segments}-{rs.alignment_segments_cigar}"
            f"_and_{rm.alignment_segments}-{rm.alignment_segments_cigar}"
            f"_and_{rx.alignment_segments}-{rx.alignment_segments_cigar}")
    vcf_out.write(f"{rs.chr}\t{pos}\t{fmt}\t{ref}\t{alt}\t{_g(qual)}\t{filt}\t"
                  f"{info}\tGT:DP:RO:AO\t{gt}\n")
    return True


def _emit_large_insert(reads, i, jdx, vcf_out, sv_state):
    r = reads[i]
    o = reads[jdx]
    ctx = r.ctx
    sb_i = sig_break_point(r)
    sb_j = sig_break_point(o)
    pos_i = r.pos + sb_i
    pos_j = o.pos + sb_j
    pos = min(pos_i, pos_j)
    end = max(pos_i, pos_j)
    start_break = pos_i - pos_j
    fmt = ""
    if start_break > 0:
        fmt += f"{abs(start_break)}Y"
    elif start_break < 0:
        fmt += f"{abs(start_break)}D"
    alt = "<INS>"
    ref = ""
    if start_break > 0:
        ref = _ref_sub(ctx, r.chr, pos - 1 - 1, 1)
        alt += _ref_sub(ctx, r.chr, pos - 1 - 1, 1 + abs(start_break))
    elif start_break < 0:
        ref = _ref_sub(ctx, r.chr, pos - 1 - 1, 1 + abs(start_break))
        alt += _ref_sub(ctx, r.chr, pos - 1 - 1, 1)
    alt += ("-" + get_clipped_sequence(r, sb_i, "mc") + "N" * 20
            + get_clipped_sequence(o, sb_j, "cm"))
    fmt += f"{len(alt)}+LargeInsert"
    am, ap = get_quality_hashes(r, sb_i)
    bm, bpq = get_quality_hashes(o, sb_j)
    qual = ((am + bm) / (ap + bpq) * 100.0) if (ap + bpq) > 0 else 0.0
    phase = r.phase if r.phase != "none" else (o.phase if o.phase != "none" else "none")
    sv_state["id"] += 1
    for k in r.alignments:
        reads[k].sv_event_id = sv_state["id"]
    for k in o.alignments:
        reads[k].sv_event_id = sv_state["id"]
    ffa = filter_sv(r)
    ffb = filter_sv(o)
    gmap = sum([r.map_qual > 30, o.map_qual > 30])
    if gmap < 1:
        fmt += "-LowMapQual"
        info_filter, filt = "LowMapQual", "LMQ"
    elif ffa == "" and ffb == "":
        fmt += "-DeNovo"
        info_filter, filt = "Pass", "PASS"
    else:
        fmt += f"-{ffa},{ffb}"
        info_filter, filt = ffa + ffb, "fail"
    info = (f"SVTYPE=INS;END={end};PH={phase};FEX={info_filter};"
            f"FS={am + bm}/{ap + bpq};RN={r.name}_and_{o.name};"
            f"MQ={r.map_qual}_and_{o.map_qual};"
            f"cigar={r.cigar}_and_{o.cigar};"
            f"SB={_g(r.strand_bias)}_and_{_g(o.strand_bias)};"
            f"AS={r.alignment_segments}-{r.alignment_segments_cigar}"
            f"_and_{o.alignment_segments}-{o.alignment_segments_cigar}")
    gt = create_struct_genotype(r, sb_i)
    if not check_genotypes(gt):
        gt = create_struct_genotype(o, sb_j)
    vcf_out.write(f"{r.chr}\t{pos - 1}\t{fmt}\t{ref}\t{alt}\t{_g(qual)}\t"
                  f"{filt}\t{info}\tGT:DP:RO:AO\t{gt}\n")
    return True


def _emit_orphan_mob(reads, i, vcf_out, mobs, sv_state):
    r = reads[i]
    ctx = r.ctx
    bp = sig_break_point(r)
    if bp <= 0:
        return False
    max_sup = 0
    for j in range(1, len(r.alignments)):
        if reads[r.alignments[j]].map_qual > max_sup:
            max_sup = reads[r.alignments[j]].map_qual
    if r.map_qual < max_sup:
        return False
    temp = [copy.deepcopy(reads[r.alignments[j]])
            for j in range(1, len(r.alignments))
            if reads[r.alignments[j]].map_qual > 30]
    poly_bp = is_poly_a(r, temp)
    mob = mobs.get(r.name)
    my_mob = mob_aligne_bases(mob, r) if mob is not None else 0
    second = []
    max_second = 0
    for j in range(1, len(r.alignments)):
        v = mob_aligne_bases(mob, reads[r.alignments[j]]) if mob is not None else 0
        second.append(v)
        max_second = max(max_second, v)
    check_distance = True
    for j in range(1, len(r.alignments)):
        oo = reads[r.alignments[j]]
        if r.chr == oo.chr and abs(r.pos - oo.pos) < 10000:
            check_distance = False
    if not ((poly_bp > -1 or (my_mob > max_second and my_mob > 10)) and check_distance):
        return False
    if r.sv_event_id != 0:
        return False
    sv_state["id"] += 1
    for k in r.alignments:
        reads[k].sv_event_id = sv_state["id"]
    gt = create_struct_genotype(r, sig_break_point(r))
    fmt = "OrphanBND"
    if poly_bp > -1:
        fmt += f"-PolyA{poly_bp}"
    if my_mob > 10:
        fmt += f"-MOB{my_mob}"
        for v in second:
            fmt += f"+{v}"
    fmt += f"-{r.mob_as}LC={sv_check_parents_low_cov(r, sig_break_point(r))}"
    ref = _ref_sub(ctx, r.chr, r.pos + bp - 1, 1)
    ffa = filter_sv(r)
    gmap = 1 if r.map_qual > 30 else 0
    if sv_check_parents_low_cov(r, sig_break_point(r)) >= 1:
        fmt += "-Inherited"
        info_filter, filt = "Inherited", "LCH"
    elif gmap < 1:
        fmt += "-LowMapQual"
        info_filter, filt = "LowMapQual", "LMQ"
    elif ffa == "":
        fmt += "-DeNovo"
        info_filter, filt = "Pass", "PASS"
    else:
        fmt += f"-{ffa}"
        info_filter, filt = ffa, "fail"
    am, ap = get_quality_hashes(r, bp)
    qual = (am / ap * 100.0) if ap > 0 else 0.0
    phase = r.phase if r.phase != "none" else "none"
    info = (f"SVTYPE=INS;END={r.pos + bp - 1};MT={r.mob_contig};PH={phase};"
            f"FEX={info_filter};FS={am}/{ap};RN={r.name};MQ={r.map_qual};"
            f"cigar={r.cigar};SB={_g(r.strand_bias)};"
            f"AS={r.alignment_segments}-{r.alignment_segments_cigar}_and_")
    vcf_out.write(f"{r.chr}\t{r.pos + bp - 1}\t{fmt}\t{ref}\t<INS:ME:MOB>\t"
                  f"{_g(qual)}\t{filt}\t{info}\tGT:DP:RO:AO\t{gt}\n")
    return True
