"""Final VCF polish: sort, autosome/PASS filter, duplicate collapse.

Transcribes runRufus.sh:1113-1125 (`sort -k1,1V -k2,2n`),
scripts/VilterAutosomeOnly{,.withoutMosaic} and
scripts/ColapsDuplicateCalls.stream.pl.
"""

from __future__ import annotations

import re

_MAIN_CHROM = re.compile(r"^(chr)?([1-9]|X|Y)")


def _version_key(s: str):
    """GNU `sort -V`-like key."""
    parts = re.split(r"(\d+)", s)
    return tuple(int(p) if p.isdigit() else p for p in parts)


def sort_vcf_lines(lines):
    header = [l for l in lines if l.startswith("#")]
    rows = [l for l in lines if not l.startswith("#")]
    rows.sort(key=lambda l: (_version_key(l.split("\t")[0]),
                             int(l.split("\t")[1])))
    return header + rows


def vilter_autosome_only(lines, with_mosaic: bool):
    """Keep header + main-chromosome rows that are PASS or (Mosaic|DeNovo)
    in the ID column depending on mode."""
    out = []
    for l in lines:
        if l.startswith("#"):
            out.append(l)
            continue
        f = l.split("\t")
        if not _MAIN_CHROM.match(f[0]):
            continue
        keyword = "Mosaic" if with_mosaic else "DeNovo"
        if "PASS" in f[6] or keyword in f[2]:
            out.append(l)
    return out


def colaps_duplicate_calls(lines):
    """Drop consecutive rows with identical chr/pos/ref/alt (numeric
    comparison like the perl `==`: non-numeric strings compare equal as 0,
    so REF/ALT letters never differ numerically — reproduced)."""
    out = []
    chrom = pos = ref = alt = "nope"

    def num(x):
        m = re.match(r"^[+-]?\d+(\.\d+)?", x)
        return float(m.group(0)) if m else 0.0

    for l in lines:
        if l.startswith("#"):
            out.append(l)
            continue
        f = l.rstrip("\n").split("\t")
        if (num(f[0]) == num(chrom) and num(f[1]) == num(pos)
                and num(f[3]) == num(ref) and num(f[4]) == num(alt)):
            continue
        out.append(l)
        chrom, pos, ref, alt = f[0], f[1], f[3], f[4]
    return out


def polish_vcf(in_path: str, out_path: str, with_mosaic: bool):
    lines = [l for l in open(in_path)]
    lines = sort_vcf_lines(lines)
    lines = vilter_autosome_only(lines, with_mosaic)
    lines = colaps_duplicate_calls(lines)
    with open(out_path, "w") as f:
        f.writelines(lines)
    return out_path
