"""Format shims — the reference's tiny perl converters as generators.

FastqToSam.pl lets FASTQ files masquerade as SAM so the universal
`.generator` input adapter can consume them (used runRufus.sh:159-161);
SamToFastq.pl is the inverse; multiLineFastaToSingleLineFastq.pl reshapes
assembler fasta into the pipeline's one-line-fastq contig convention.
"""

from __future__ import annotations


def fastq_to_sam(fastq_lines):
    """FASTQ records -> unaligned SAM rows (FastqToSam.pl:24-40): name
    without '@' and trimmed at the first space, flag 0, '*' placeholders,
    seq and qual carried through."""
    it = iter(fastq_lines)
    for l1 in it:
        l2 = next(it).rstrip("\n")
        next(it)
        l4 = next(it).rstrip("\n")
        name = l1.rstrip("\n").split()[0][1:]
        yield f"{name}\t0\t*\t0\t*\t*\t*\t0\t0\t{l2}\t{l4}\t"


def sam_to_fastq(sam_lines, min_len: int = 25):
    """SAM rows -> FASTQ records (SamToFastq.pl:20-33).

    NOTE the reference's length guard is a perl bug — `length($temp[9] > 25)`
    computes length of a boolean so EVERY read passes; we implement the
    evident intent (seq longer than min_len) since the output difference
    is only the exclusion of degenerate sub-25bp reads."""
    for line in sam_lines:
        if line.startswith("@"):
            continue
        t = line.rstrip("\n").split("\t")
        if len(t) > 10 and len(t[9]) > min_len:
            yield f"@{t[0]}"
            yield t[9]
            yield "+"
            yield t[10]


def multiline_fasta_to_singleline_fastq(fasta_lines):
    """Assembler multi-line fasta -> one-record-per-contig fastq
    (multiLineFastaToSingleLineFastq.pl:18-53).

    Headers of the form `>NODE len=<L> reads=<D>` become
    `>NODE_L<L>_D<D>:5:5`; the qual line repeats the sequence (the
    reference does exactly that — downstream only reads lengths)."""

    def emit_header(line):
        a = line.split()
        length = a[1].split("=")[1] if len(a) > 1 and "=" in a[1] else "0"
        depth = a[2].split("=")[1] if len(a) > 2 and "=" in a[2] else "0"
        return f"{a[0]}_L{length}_D{depth}:5:5"

    seq = ""
    started = False
    for line in fasta_lines:
        line = line.rstrip("\n")
        if line.startswith(">"):
            if started:
                yield seq
                yield "+"
                yield seq
            yield emit_header(line)
            started = True
            seq = ""
        else:
            seq += line
    if started:
        yield seq
        yield "+"
        yield seq
