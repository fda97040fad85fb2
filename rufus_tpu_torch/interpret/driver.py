"""Interpret driver: inputs -> VCF (RUFUS.interpret.cpp main, 5234-7737).

Implemented: model/hash loading, SAM ingest, split-read linking, the
single-contig SNV/indel path (parseMutations), and the multi-contig SV
passes — MOB insertions 5896-6089 and DEL/DUP 6090-6327 (`sv.py`),
BetterWay split merging 3404-4418 (`betterway.py`), and the BND /
inversion / LastDitch cleanup passes 6416-7725 (`sv_cleanup.py`).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time

import numpy as np

from ..ops import _build, codec
from .calls import parse_mutations
from .model import DepthModel
from .samread import Context, MobRead, SamRead


def _load_counts_file(path: str, into: dict):
    """A k-mer count pull ("<k-mer> <count>" lines) into `into`, each line's
    count under Context.h2l of its k-mer and then of the k-mer's reverse
    complement (codec.revcomp_str), line by line: lines split on " ", those
    of one field skipped, int() of the second field. Parsed and packed in
    the port's native host library (`count_pulls`); a k-mer whose packing
    needs more than 64 bits (bases past the 32nd) raises ValueError."""
    with open(path) as f:
        text = f.read()
    raw = text.encode()
    cap = text.count("\n") + 1
    keys = np.empty(2 * cap, np.uint64)
    vals = np.empty(cap, np.int64)
    err = np.zeros(3, np.int64)
    fn = _build.host_function("count_pulls", ctypes.c_longlong,
                              (ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p))
    n = fn(raw, len(raw), keys.ctypes.data, vals.ctypes.data, err.ctypes.data)
    if n < 0:
        line = raw[err[0]:err[1]].decode()
        if err[2]:
            int(line.split(" ")[1])  # int()'s own error, where it has one
            raise ValueError(f"{path}: a count outside int64 or not in "
                             f"ASCII digits: {line!r}")
        raise ValueError(f"{path}: a k-mer too long to pack in 64 bits: "
                         f"{line!r}")
    into.update(zip(keys[:2 * n].tolist(), np.repeat(vals[:n], 2).tolist()))


def load_hashlist(path: str):
    """HashList load with the reference's quirk (5614-5671): 2-col files
    insert the revcomp only for the FIRST line."""
    hash_map: dict[str, int] = {}
    k = 25
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if l.strip()]
    if not lines:
        return hash_map, k
    sep = "\t" if "\t" in lines[0] else " "
    first = lines[0].split(sep)
    if len(first) == 4:
        k = len(first[3])
        hash_map.setdefault(first[3], int(first[2]))
        for line in lines[1:]:
            t = line.split(sep)
            hash_map.setdefault(t[3], int(t[2]))
            hash_map.setdefault(codec.revcomp_str(t[3]), int(t[2]))
    elif len(first) == 2:
        k = len(first[0])
        hash_map.setdefault(first[0], int(first[1]))
        hash_map.setdefault(codec.revcomp_str(first[0]), int(first[1]))
        for line in lines[1:]:
            t = line.split(sep)
            hash_map.setdefault(t[0], int(t[1]))
    return hash_map, k


def _mob_all_a(seq: str) -> bool:
    return len(set(seq)) <= 1 if seq else True


def load_mob_sam(path: str):
    mobs: dict[str, MobRead] = {}
    try:
        f = open(path)
    except OSError:
        return mobs
    with f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.rstrip("\n").split("\t")
            if len(t) < 11:
                continue
            m = MobRead(name=t[0], flag=int(t[1]), chr=t[2], seq=t[9],
                        cigar=t[5]).process_cigar()
            for tag in t[11:]:
                p = tag.split(":")
                if p[0] == "AS":
                    m.AS = int(p[2])
            if m.chr != "*" and not _mob_all_a(m.seq):
                if m.name not in mobs or mobs[m.name].AS < m.AS:
                    mobs[m.name] = m
    return mobs


def _alignment_all_a(read: SamRead) -> float:
    all_a = True
    base = "Z"
    a = t = 0
    size = 0.0
    for i in range(len(read.seq)):
        if read.cigar_string[i] not in "HS":
            size += 1
            if base == "Z":
                base = read.seq[i]
            if base != read.seq[i]:
                all_a = False
            if read.seq[i] == "A":
                a += 1
            elif read.seq[i] == "T":
                t += 1
    if all_a:
        return 1.0
    if size == 0:
        return 0.0
    return (a if a > t else t) / size


VCF_HEADER_META = """##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##FORMAT=<ID=AK,Number=1,Type=Integer,Description="Alternte Kmer Count">
##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Total Kmer depth across the variant">
##FORMAT=<ID=RO,Number=1,Type=Integer,Description="Mode of reference kmer counts">
##FORMAT=<ID=AO,Number=1,Type=Integer,Description="Mode of alt kmer counts">
##INFO=<ID=PH,Number=1,Type=String,Description="If read backed phasing is possible, the name of the sample that the variant was inherited from">
##INFO=<ID=CP,Number=1,Type=String,Description="position of the call within the assembled contig">
##INFO=<ID=EN,Number=1,Type=String,Description="in development, something to do with entropy">
##INFO=<ID=FEX,Number=1,Type=String,Description="Filters failed and value">
##INFO=<ID=SB,Number=1,Type=Float,Description="Strand Bias of the aassembled contig">
##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of SV detected">
##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Length of SV detected">
##INFO=<ID=END,Number=1,Type=Integer,Description="END of SV detected">
##INFO=<ID=AO,Number=1,Type=Integer,Description="Alternate allele observations, with partial observations recorded fractionally">
##INFO=<ID=HD,Number=.,Type=String,Description="Hash counts for each k-mer overlapping the vareint, -1 indicates no info">
##INFO=<ID=RN,Number=1,Type=String,Description="Name of contig that produced the call">
##INFO=<ID=FS,Number=1,Type=String,Description="Full score, supporting kmers possible varient kmers based on sequence">
##INFO=<ID=MQ,Number=1,Type=Integer,Description="Mapping quality of the contig that created the call">
##INFO=<ID=cigar,Number=1,Type=String,Description="Cigar string for the contig that created the call">
##INFO=<ID=VT,Number=1,Type=String,Description="Varient Type">
##INFO=<ID=CVT,Number=1,Type=String,Description="Compressed Varient Type">
##INFO=<ID=NR,Number=1,Type=Integer,Description="Number of total reads in target region">
##INFO=<ID=NH,Number=1,Type=Integer,Description="Number of alu heads in target region">
##INFO=<ID=NT,Number=1,Type=Integer,Description="Number of polyA tails in target region">
##INFO=<ID=LT,Number=1,Type=Integer,Description="Longest polyA tail in target region">
##INFO=<ID=TB,Number=1,Type=Integer,Description="Is tail left bound, right bound, or double bound">
##INFO=<ID=AS,Number=1,Type=Integer,Description="Number of alignment segments in the contig">
##INFO=<ID=MT,Number=1,Type=String,Description="Mobil element sequence inserted">
##INFO=<ID=SVID,Number=1,Type=String,Description="Uniuqe ID given to an SV event with multiple brekends so it can be quicky identified">
##INFO=<ID=SOURCE,Number=1,Type=String,Description="Location in the genome where the inserted sequence came from">
##INFO=<ID=SVDES,Number=1,Type=String,Description="If available RUFUS will interpret the SV type for you">
##INFO=<ID=MATEID,Number=1,Type=String,Description="If available, the id of the call that is the mate of this one">
##FILTER=<ID=PA,Description="PoorAlignment">
##FILTER=<ID=PLC,Description="Parents are at low coverage in this region, cannt be sure of genotype">
##FILTER=<ID=LCH,Description="Parents have hashes showing variant at low coverage, likely inherited">
##FILTER=<ID=SB,Description="Contig fails string bias filter">
##ALT=<ID=INS:ME:ALU,Description="Insertion of ALU element">
##ALT=<ID=INS:ME:L1,Description="Insertion of L1 element">
##ALT=<ID=INS:ME:MOB,Description="Insertion of ALU or L1element">
"""


def run_interpret(sam_lines, ref, dist_path: str, hashlist_path: str,
                  out_stub: str, parent_alt_paths, parent_ref_paths,
                  subject_alt_path: str, subject_ref_path: str,
                  exclude_path: str | None = None, mob_sam_path: str | None = None,
                  min_map_qual: int = 10, max_variant_size: int = 1000,
                  file_date: int | None = None, seg_threshold: int | None = None,
                  span=None):
    """Full interpret run. sam_lines: iterable of headerless-or-not SAM
    text lines (the `samtools view | AddSA | grep -v chrUn` stream plus
    optional @ header lines for ##contig emission). `span(name)`, a
    context manager (the pipeline's StageTimer.span), times the depth
    model's load ("model") and the count pulls' ("pulls")."""
    span = span or (lambda name: contextlib.nullcontext())
    with span("model"):
        model = DepthModel.load(dist_path)
        if not model.is_exome:
            model.process_high_low()
    mobs = load_mob_sam(mob_sam_path) if mob_sam_path else {}

    hash_map, k = load_hashlist(hashlist_path)

    ctx = Context(ref=ref, model=model, hashlist=hash_map, parent_hashes=[],
                  mutant_hashes={}, exclude_hashes={}, par_names=[], k=k,
                  min_map_qual=min_map_qual, max_variant_size=max_variant_size)
    if seg_threshold is not None:
        # `-as` flag (RUFUS.interpret.cpp:5338-5343): one value sets both
        # the alignment-segment and cigar-segment thresholds; the long-read
        # path runs with 1000 (Overlap.pacbio.sh final interpret call).
        ctx.seg_threshold = seg_threshold
        ctx.seg_threshold_cigar = seg_threshold
    with span("pulls"):
        for alt_p, ref_p in zip(parent_alt_paths, parent_ref_paths):
            m: dict[int, int] = {}
            _load_counts_file(alt_p, m)
            _load_counts_file(ref_p, m)
            ctx.parent_hashes.append(m)
            start = alt_p.find("overlap.asembly.hash.fastq.")
            end = alt_p.find(".generator.Jhash")
            ctx.par_names.append(alt_p[start + 27 : end]
                                 if start >= 0 and end >= 0
                                 else f"Parent{len(ctx.par_names)}")
        _load_counts_file(subject_alt_path, ctx.mutant_hashes)
        _load_counts_file(subject_ref_path, ctx.mutant_hashes)
        if exclude_path:
            try:
                _load_counts_file(exclude_path, ctx.exclude_hashes)
            except (OSError, IndexError):
                pass

    vcf_path = out_stub + ".vcf"
    bed_path = out_stub + ".vcf.bed"
    vcf = open(vcf_path, "w")
    bed = open(bed_path, "w")
    vcf.write("##fileformat=VCFv4.1\n")
    vcf.write(f"##fileDate={file_date if file_date is not None else int(time.time())}\n")
    vcf.write(VCF_HEADER_META)

    contig_lines = []
    reads: list[SamRead] = []
    for line in sam_lines:
        if line.startswith("@"):
            t = line.rstrip("\n").split("\t")
            if t[0] == "@SQ":
                chrn = t[1].split(":")
                ln = t[2].split(":")
                contig_lines.append(f"##contig=<ID={chrn[1]},length={ln[1]}>")
            continue
        read = SamRead(ctx)
        read.parse(line)
        if not read.flag_bits[2]:
            read.parsed = True
            read.get_ref_seq()
            read.create_peak_map()
            read.check_mob(mobs)
            if _alignment_all_a(read) > 0.9:
                read.map_qual = 0
                read.all_a = True
            if read.check_bases_aligned() > 50 or read.check_ends_align():
                reads.append(read)
    for cl in contig_lines:
        vcf.write(cl + "\n")
    vcf.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t")
    samplename = out_stub[: out_stub.find(".generator")] if ".generator" in out_stub else out_stub
    vcf.write(samplename)
    for par in ctx.par_names:
        vcf.write("\t" + par)
    vcf.write("\n")

    if not reads:
        vcf.close()
        bed.close()
        return vcf_path

    # split-read linking (5856-5883) — the reference's O(N^2) all-pairs
    # name scan becomes a name->indices map walk with identical link
    # structure (the head contig links every later same-name index; later
    # ones link only back to the head; a zero-pos head links nothing and
    # leaves its partners to start their own groups)
    by_name: dict[str, list[int]] = {}
    for idx, r in enumerate(reads):
        by_name.setdefault(r.name, []).append(idx)
    for i in range(len(reads)):
        if len(reads[i].alignments) == 0:
            reads[i].alignments.append(i)
            if reads[i].pos:
                for j in by_name[reads[i].name]:
                    if j > i:
                        reads[i].alignments.append(j)
                        reads[j].alignments.append(j)
                        reads[j].alignments.append(i)
                        reads[j].first = False
    for r in reads:
        r.look_up_kmers()
        r.check_phase()
        r.clip_pattern = r.clip_pattern_str()

    from .betterway import AuxOutputs, better_way
    from .sv import del_dup_pass, mob_insertion_pass
    from .sv_cleanup import cleanup_pass

    inter_dir = os.path.dirname(out_stub) or "."
    inter = os.path.join(inter_dir, "Intermediates")
    os.makedirs(inter, exist_ok=True)
    base = os.path.basename(out_stub)
    aux = AuxOutputs(
        big=open(os.path.join(inter, base + ".vcf.Big.bed"), "w"),
        not_handled=open(os.path.join(inter, base + ".vcf.NotHandled.bed"), "w"),
        inversions=open(os.path.join(inter, base + ".vcf.invertions.bed"), "w"),
        translocations=open(os.path.join(inter, base + ".vcf.Translocations"), "w"),
        translocations_bed=open(os.path.join(inter, base + ".vcf.Translocations.bed"), "w"),
        unaligned=open(os.path.join(inter, base + "vcf.Unaligned"), "w"),
    )
    sv_state = {"id": 0, "bnd": 0, "aux": aux}

    mob_insertion_pass(reads, vcf, sv_state)
    del_dup_pass(reads, vcf, sv_state)

    import copy as _copy

    for i in range(len(reads)):
        read = reads[i]
        if read.chr == "*":
            continue
        if read.first and len(read.alignments) == 2:
            # pick the two best alignments by AS (x1.0001 tie bump, 6350-6360)
            scores = {}
            for j in range(len(read.alignments)):
                s = float(reads[read.alignments[j]].align_score)
                while s in scores:
                    s = s * 1.0001
                scores[s] = j
            good = [scores[s] for s in sorted(scores, reverse=True)]
            R = [
                _copy.deepcopy(reads[read.alignments[j]])
                for j in range(len(read.alignments))
                if j in (good[0], good[1] if len(good) > 1 else good[0])
            ]
            if (len(R) == 2 and R[0].map_qual > 0 and R[1].map_qual > 0
                    and R[0].sv_event_id == 0):
                read = better_way(R, aux, ctx.max_variant_size)
        elif read.first and len(read.alignments) > 2:
            aux.not_handled.write("too many alignments\n")
            aux.not_handled.write(
                f"{read.chr}\t{read.pos}\t{read.pos + len(read.seq)}\t"
                f"{read.name}\t{read.cigar}\n")
            continue
        if read.map_qual > ctx.min_map_qual and len(read.alignments) <= 2:
            parse_mutations(read, vcf, bed, reads)

    cleanup_pass(reads, vcf, mobs, sv_state)

    for f in (aux.big, aux.not_handled, aux.inversions, aux.translocations,
              aux.translocations_bed, aux.unaligned):
        try:
            f.close()
        except Exception:
            pass
    vcf.close()
    bed.close()
    return vcf_path
