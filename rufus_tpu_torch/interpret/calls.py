"""parseMutations: scan a contig's expanded alignment for variants and
write VCF rows (RUFUS.interpret.cpp:2582-2953)."""

from __future__ import annotations

import math

from .samread import SamRead, compress_var, entropy_multi


def _g(x) -> str:
    """C++ ostream default double formatting."""
    if isinstance(x, (int,)):
        return str(x)
    x = float(x)
    if x != x:
        return "-nan" if math.copysign(1, x) < 0 else "nan"
    if x == float("inf"):
        return "inf"
    if x == float("-inf"):
        return "-inf"
    return f"{x:.6g}"


def parse_mutations(read: SamRead, vcf_out, bed_out, reads=None):
    ctx = read.ctx
    k = ctx.k
    read.build_up_hash_count_table()
    read.create_peak_map()
    cs = read.cigar_string
    seq = read.seq
    ref_seq = read.ref_seq
    qual = read.qual
    i = 25
    while i < len(cs) - 25:
        ch = cs[i]
        if ch in "XIDY" and ref_seq[i] != "N":
            size = -1
            start_pos = i
            any_over0 = qual[i] > "!"
            denovo = "DeNovo" if read.peak_map[i] == 1 else "inherited"
            for j in range(0, len(cs) - i):
                if cs[i + j] in "XDIY":
                    size = j
                    if qual[i + j] > "!":
                        any_over0 = True
                    if read.peak_map[i + j] == 1:
                        denovo = "DeNovo"
                else:
                    break
            if any_over0:
                reff = ""
                alt = ""
                var_type = ""
                if ch in "IDY":
                    kk = 1
                    while i - kk >= 0:
                        if read.chr_positions[i - kk] != "nope":
                            reff += ref_seq[i - kk]
                            alt += seq[i - kk]
                            start_pos = i - kk
                            break
                        kk += 1
                for j in range(0, size + 1):
                    if ref_seq[i + j] in "ACGT":
                        reff += ref_seq[i + j]
                    if seq[i + j] in "ACGT":
                        alt += seq[i + j]
                    var_type += cs[i + j]

                supporting = read.get_supporting_hash_count(i, alt, reff)
                cvt, struct_call = compress_var(var_type, read.positions[start_pos])
                if ctx.model.is_exome:
                    from .sv import shitty_genotyper

                    (mut_ref_mode, mut_alt_mode, par_ref_modes, par_alt_modes,
                     hash_counts, _og, possible) = read.get_modes_exome(i, alt, reff)
                    genotype = shitty_genotyper(mut_alt_mode, mut_ref_mode)
                    par_genotypes = [shitty_genotyper(pa, pr) for pa, pr
                                     in zip(par_alt_modes, par_ref_modes)]
                else:
                    par_genotypes = []
                    par_ref_modes = []
                    par_alt_modes = []
                    for pi in range(len(ctx.parent_hashes)):
                        _, _, g, rm, am = read.get_modes3(
                            i, alt, reff, read.par_ref_counts[pi],
                            read.par_alt_counts[pi])
                        par_genotypes.append(g)
                        par_ref_modes.append(rm)
                        par_alt_modes.append(am)
                    hash_counts, possible, genotype, mut_ref_mode, mut_alt_mode = \
                        read.get_modes3(i, alt, reff, read.mut_ref_counts,
                                        read.mut_alt_counts)

                # parent low-coverage window check (2717-2740)
                num_low_cov = 0
                low = max(0, i - k - 50)
                kk = low
                while kk <= i + 50 and kk < len(read.hashes):
                    for j in range(len(read.parent_counts)):
                        if read.hashes_ref[kk] == read.hashes[kk]:
                            s = read.parent_counts_ref[j][kk]
                        else:
                            s = read.parent_counts[j][kk] + read.parent_counts_ref[j][kk]
                        if (s <= ctx.par_low_cov_threshold
                                and read.parent_counts[j][kk] + read.parent_counts_ref[j][kk] > 2):
                            num_low_cov += 1
                    kk += 1

                # parent low-count alt-hash streak (2741-2795)
                low_count = 0
                streak = [0] * len(read.parent_counts)
                low = max(0, i - k)
                j2 = low
                ex = ctx.exclude_hashes
                while j2 <= i + size and j2 < len(read.hashes):
                    if read.hashes_ref[j2] != read.hashes[j2]:
                        h = read.hashes[j2]
                        from ..ops import codec
                        if (ex.get(ctx.h2l(h), 0) < 1
                                and ex.get(ctx.h2l(codec.revcomp_str(h)), 0) < 1):
                            for p in range(len(read.parent_counts)):
                                pc = read.parent_counts[p][j2]
                                pcr = read.parent_counts_ref[p][j2]
                                var_freq = 1.0
                                if pcr > 0:
                                    var_freq = pc / (pcr + pc)
                                if 1 <= pc <= ctx.par_low_cov_threshold and var_freq > 0.02:
                                    streak[p] += 1
                                    if streak[p] >= 1:
                                        low_count += 1
                                else:
                                    streak[p] = 0
                    j2 += 1

                # filter cascade (2798-2875)
                filt = "."
                info_filter = ""
                if "1" not in genotype:
                    denovo = "Mosaic"
                if (read.alignment_segments > ctx.seg_threshold
                        or read.alignment_segments_cigar > ctx.seg_threshold_cigar):
                    ss = f"{read.alignment_segments}-{read.alignment_segments_cigar}"
                    denovo = "PoorAlignment" + ss
                    if filt == ".":
                        filt = ""
                    filt += "PA;"
                    info_filter += "PA" + ss + ","
                if num_low_cov > 25:
                    denovo = "ParLowCovRegion"
                    if filt == ".":
                        filt = ""
                    filt += "PLC;"
                    info_filter += f"PLC{num_low_cov},"
                if low_count >= 2:
                    denovo = f"Inherited{low_count}"
                    if filt == ".":
                        filt = ""
                    filt += "LCH;"
                    info_filter += f"LCH{low_count},"
                if read.strand_bias >= 0:
                    if read.strand_bias > 0.99999 or read.strand_bias < 0.00001:
                        denovo = "StrandBias"
                        if filt == ".":
                            filt = ""
                        filt += "SB;"
                        info_filter += "SB" + _g(read.strand_bias) + ","
                if denovo == "DeNovo" and filt == ".":
                    filt = "PASS"
                if info_filter == "":
                    info_filter = "PASS"

                # a split contig whose variant is explained here is removed
                # from SV consideration (2877-2890)
                if reads is not None and read.is_split_read > 0:
                    if any(c in var_type for c in "DYI"):
                        for w in read.alignments:
                            reads[w].sv_event_id = -1

                # entropy context (2891-2903)
                estart = max(0, i - 25)
                eend = min(i + 25, len(seq) - 1)
                ref_context = ref_seq[estart : estart + (eend - estart)]
                ws = [entropy_multi(ref_context, w) for w in range(1, 6)]

                score = (supporting / possible) * 100.0 if possible else (
                    float("nan") if supporting == 0 else float("inf"))
                hd = "".join(f"{h}_" for h in hash_counts)
                vcf_out.write(
                    f"{read.chr_positions[start_pos]}\t{read.positions[start_pos]}\t"
                    f"{cvt}-{denovo}\t{reff}\t{alt}\t{_g(score)}\t{filt}\t"
                    f"PH={read.phase};CP={i}/{len(cs)};"
                    f"EN={_g(ws[0])},{_g(ws[1])},{_g(ws[2])},{_g(ws[3])},{_g(ws[4])},{ref_context};"
                    f"FEX={info_filter};FS={supporting}/{possible};RN={read.name};"
                    f"MQ={read.map_qual};cigar={read.cigar};SB={_g(read.strand_bias)};"
                    f"AS={read.alignment_segments}-{read.alignment_segments_cigar};"
                    f"CVT={cvt};HD={hd};AO={mut_alt_mode};VT={var_type}\t"
                    f"GT:DP:RO:AO\t{genotype}:{mut_ref_mode + mut_alt_mode}:"
                    f"{mut_ref_mode}:{mut_alt_mode}")
                for p in range(len(par_ref_modes)):
                    vcf_out.write(
                        f"\t{par_genotypes[p]}:{par_alt_modes[p] + par_ref_modes[p]}:"
                        f"{par_ref_modes[p]}:{par_alt_modes[p]}")
                vcf_out.write("\n")
                bed_out.write(
                    f"{read.chr}\t{read.pos + i}\t{read.pos + i + size}\t"
                    f"{read.chr}:{read.pos + i}:{len(reff) - len(alt)}:{supporting}\n")
                i += size
        i += 1
