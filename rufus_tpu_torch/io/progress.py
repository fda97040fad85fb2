"""Stream-progress files (PassThroughSamCheck.cpp:30-158 role).

A count stream writes `<stub>.Jelly.chr` and a BAM/CRAM filter stream
`<stub>.filter.chr`; the last line is the completion sentinel only after
a clean end of stream, which the resume logic checks like
RunRUFUS.Trio.sh:77's `tail -n 1 $gen.filter.chr = "booya"`.

Which of the two forms a stream writes follows the JAX package's routes:
the native decoders (a single BAM, FASTQ) write "notachr" and the
sentinel (`write_complete`); the record-by-record routes (CRAM, and BAM
in a comma-separated list) log the chromosome transitions
(`progress_records`).
"""

from __future__ import annotations

STREAM_SENTINEL = "booya"


def write_complete(progress_path: str):
    """Mark a stream with no chromosome log as read to its end."""
    with open(progress_path, "w") as pf:
        pf.write("notachr\n" + STREAM_SENTINEL + "\n")


def progress_records(records, refs, progress_path: str):
    """Chromosome-progress side channel: each chromosome transition logs
    the PREVIOUS chromosome (starting from "notachr"); a clean end of
    stream logs the final chromosome and the completion sentinel. An
    abandoned or crashed stream leaves the file without the sentinel,
    which `stream_complete` detects on resume. `records` need a `ref_id`;
    `refs` is a list of (name, length)."""
    current = "notachr"
    with open(progress_path, "w", buffering=1) as pf:
        for r in records:
            chrom = (refs[r.ref_id][0] if 0 <= r.ref_id < len(refs) else "*")
            if chrom != current:
                pf.write(current + "\n")
                current = chrom
            yield r
        pf.write(current + "\n")
        pf.write(STREAM_SENTINEL + "\n")


def stream_complete(progress_path: str) -> bool:
    """True iff the progress file ends with the completion sentinel."""
    try:
        with open(progress_path) as f:
            lines = [l for l in f.read().split("\n") if l]
    except OSError:
        return False
    return bool(lines) and lines[-1] == STREAM_SENTINEL
