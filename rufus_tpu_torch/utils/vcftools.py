"""VCF analysis / QC utilities — the reference's perl analysis scripts
re-done as Python functions over iterables of VCF lines.

Each function documents which reference script it replaces (all in the
reference's scripts/ directory); semantics are matched where
output-visible, and reference bugs that make a script non-functional are
fixed and noted. Host-only code, a copy of the JAX package's
utils/vcftools.py, held to it line for line by tests/test_torch_utils.py.
"""

from __future__ import annotations

from dataclasses import dataclass


def _records(vcf_lines):
    for line in vcf_lines:
        line = line.rstrip("\n")
        if not line:
            continue
        yield line, line.startswith("#"), line.split("\t")


def vcf_to_sv_bed(vcf_lines):
    """SV calls -> BED rows (VCFtoSVbed.pl:17-59).

    Symbolic alts (`<...>`) use INFO END; indels with |len(ref)-len(alt)|
    > 50 use pos-1 .. pos-1+len(ref), with start shifted back by len(alt)
    when the ID contains 'Y' (the reference's insertion-anchor rule).
    Yields tab-joined `chr start end id-qual` rows; 'chr' prefix stripped.
    """
    for line, is_hdr, t in _records(vcf_lines):
        # the perl checks substr(l,1,1) == "#", i.e. "##" lines only —
        # reproduce that so #CHROM passes through the else like the perl
        # (it then fails the numeric tests silently; we skip all headers,
        # which is the intended behavior and changes no data rows)
        if is_hdr:
            continue
        chrom = t[0][3:] if t[0].startswith("chr") else t[0]
        info = dict(kv.split("=", 1) for kv in t[7].split(";") if "=" in kv)
        if "<" in t[4]:
            end = int(info.get("END", -1))
            start = int(t[1]) - 1
            yield f"{chrom}\t{start}\t{end}\t{t[2]}-{t[5]}"
        elif abs(len(t[3]) - len(t[4])) > 50:
            start = int(t[1]) - 1
            if "Y" in t[2]:
                start -= len(t[4])
            end = int(t[1]) - 1 + len(t[3])
            yield f"{chrom}\t{start}\t{end}\t{t[2]}-{t[5]}"


def qual_dist(vcf_lines):
    """QUAL histogram as '+'-bar text lines (VCF.qual_dist.pl:21-62).

    Rows 0..39 always print; rows >= 30 with nonzero count print again
    after a `~~~~~~~~~` separator (the reference double-prints 30..39 —
    reproduced)."""
    scores: dict[int, int] = {}
    for line, is_hdr, t in _records(vcf_lines):
        if is_hdr:
            continue
        q = int(float(t[5]))
        scores[q] = scores.get(q, 0) + 1
    out = []
    for i in range(40):
        n = scores.get(i, 0)
        out.append(f"{i}; " + "+" * n + f"; {n} ")
    out.append("~~~~~~~~~")
    for i in range(30, 10000):
        n = scores.get(i, 0)
        if n > 0:
            out.append(f"{i}; " + "+" * n + f"; {n} ")
    return out


def remove_duplicate_calls(vcf_lines):
    """Drop consecutive rows identical in CHROM,POS,ID,REF,ALT
    (RemoveDuplicateCalls.pl:28-45; the streaming variant used by the
    driver lives in pipeline/polish.py — this is the standalone script)."""
    last = None
    for line, is_hdr, t in _records(vcf_lines):
        if is_hdr:
            yield line
            continue
        key = tuple(t[:5])
        if key != last:
            yield line
        last = key


def check_duplicate_calls_bed(bed_lines):
    """Mark duplicate rows of a sorted call BED
    (CheckForDuplicateCallsBed.pl:27-52): first occurrence of each
    (chr,pos,ref,alt) gets `\\tUNIUQE` appended (reference spelling kept);
    repeats from a *different* sample (col 7) get a `+++` prefix."""
    key = sample = None
    for line in bed_lines:
        line = line.rstrip("\n")
        if not line:
            continue
        t = line.split("\t")
        this = tuple(t[:4])
        if this == key:
            if len(t) > 6 and t[6] != sample:
                yield "+++" + line
        else:
            yield line + "\tUNIUQE"
            key, sample = this, (t[6] if len(t) > 6 else None)


def convert_vcf_to_r_format(vcf_lines):
    """VCF -> flat TSV for R (ConvertVCFtoRformat.pl).

    Adds SIZE/TYPE/COMPLEX columns derived from the alt/INFO (SVLEN for
    symbolic alts, ref/alt length difference for indels; COMPLEX=yes when
    a symbolic alt carries extra sequence) and expands every sample's
    FORMAT fields into `<sample>-<field>` columns."""
    samples: list[str] = []
    wrote_header = False
    for line, is_hdr, t in _records(vcf_lines):
        if is_hdr:
            if t[0] == "#CHROM":
                samples = t[9:]
            continue
        if not wrote_header:
            fields = t[8].split(":")
            hdr = ["CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
                   "INFO", "SIZE", "TYPE", "COMPLEX", "FORMAT"]
            for s in samples:
                hdr += [f"{s}-{f}" for f in fields]
            yield "\t".join(hdr)
            wrote_header = True
        size, typ, complex_ = 0, "none", "no"
        info = t[7]

        def svlen():
            i = info.find("SVLEN=")
            if i < 0:
                return 0
            rest = info[i + 6:]
            j = rest.find(";")
            return rest[:j] if j >= 0 else rest

        alt = t[4]
        if "<DEL>" in alt:
            size, typ = svlen(), "del"
            complex_ = "yes" if len(alt) > 5 else "no"
        elif "<INS>" in alt or "<INS:ME" in alt:
            size, typ = svlen(), "INS"
            complex_ = "yes" if len(alt) > 5 else "no"
        elif "<DUP>" in alt:
            size, typ = svlen(), "dup"
            complex_ = "yes" if len(alt) > 5 else "no"
        elif "[" in alt or "]" in alt:
            typ = "bnd"
        else:
            d = len(alt) - len(t[3])
            if d > 0:
                size, typ = d, "INS"
            elif d < 0:
                size, typ = -d, "del"
            else:
                typ = "snv" if len(t[3]) == 1 else "mnp"
        row = list(t[:8]) + [str(size), typ, complex_, t[8]]
        fields = t[8].split(":")
        for col in t[9:]:
            vals = col.split(":")
            vals += [""] * (len(fields) - len(vals))
            row += vals[: len(fields)]
        yield "\t".join(row)


def histo_base_qualities(sam_lines):
    """Per-base phred scores of a SAM stream, one int per line
    (HistoBaseQualities.pl:6-16; feed to a histogram tool)."""
    for line in sam_lines:
        t = line.rstrip("\n").split()
        if len(t) > 10 and t[10] != "*":
            for ch in t[10]:
                yield ord(ch) - 33


def mob_to_dist(dist_lines):
    """Aggregate a MOB per-position count table into a total + per-row sums.

    The reference MobToDist.pl is non-functional (indexes a flat perl array
    as 2-D and its accumulation line is commented out, MobToDist.pl:25-40);
    this implements its evident intent: after the 5 header lines, each row
    is whitespace-separated counts — return (per_row_totals, grand_total).
    """
    rows = []
    body = list(dist_lines)[5:]
    for line in body:
        parts = line.split()
        if parts:
            rows.append(sum(int(float(x)) for x in parts))
    return rows, sum(rows)


def pull_kmer_counts_from_sequence(seq: str, k: int, tables: dict,
                                   population=None):
    """Per-window k-mer counts of `seq` against named count tables
    (PullKmerCountsFromSequence.pl:14-44).

    `tables` maps column name -> KmerTable; `population` is an optional
    extra table queried fwd then revcomp (the perl's 1kg fallback — our
    tables are canonical so the fallback is a no-op kept for parity of
    the output columns). Returns (header_row, rows) of tab-separated text.
    """
    from ..ops import codec

    names = list(tables)
    header = "sequence\t" + "\t".join(names) + ("\t1kg" if population is not None else "")
    rows = []
    for i in range(len(seq) - k):
        w = seq[i : i + k].upper()
        if any(c not in "ACGT" for c in w):
            counts = [0] * len(names) + ([0] if population is not None else [])
            rows.append(w + "\t" + "\t".join(str(c) for c in counts))
            continue
        canon = codec.canonical_str(w)
        key = codec.str_to_kmer(canon)
        vals = [int(t.query([key])[0]) for t in tables.values()]
        if population is not None:
            vals.append(int(population.query([key])[0]))
        rows.append(w + "\t" + "\t".join(str(v) for v in vals))
    return header, rows


# ---------------------------------------------------------------------------
# SV-vs-annotation check (RunSVcheck.sh + processGFFintersect.sh) without
# bedtools: pure-python interval intersection of the SV bed vs a GFF3.
# ---------------------------------------------------------------------------

@dataclass
class GffFeature:
    chrom: str
    start: int  # 0-based half-open
    end: int
    ftype: str
    attrs: str

    def attr(self, key: str) -> str:
        for kv in self.attrs.split(";"):
            if kv.startswith(key + "="):
                return kv[len(key) + 1:]
        return ""


def read_gff3(lines):
    for line in lines:
        if line.startswith("#"):
            continue
        t = line.rstrip("\n").split("\t")
        if len(t) < 9:
            continue
        yield GffFeature(t[0], int(t[3]) - 1, int(t[4]), t[2], t[8])


def sv_gene_check(vcf_lines, gff_lines):
    """Genes hit by SV calls (RunSVcheck.sh:4-9 + processGFFintersect.sh):
    intersect the SV BED (vcf_to_sv_bed) with GFF3 gene features and
    return sorted unique gene names, bedtools-free."""
    beds = []
    for row in vcf_to_sv_bed(vcf_lines):
        c, s, e, name = row.split("\t")
        s, e = int(s), int(e)
        if e >= s >= 0:
            beds.append((c, s, e))
    genes = set()
    for feat in read_gff3(gff_lines):
        if feat.ftype != "gene":
            continue
        fc = feat.chrom[3:] if feat.chrom.startswith("chr") else feat.chrom
        for c, s, e in beds:
            if c == fc and s < feat.end and feat.start < e:
                name = feat.attr("Name") or feat.attr("ID")
                if name:
                    genes.add(name)
                break
    return sorted(genes)
