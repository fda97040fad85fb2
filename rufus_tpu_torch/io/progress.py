"""Stream-progress files (PassThroughSamCheck.cpp:30-158 role).

A count stream writes `<stub>.Jelly.chr`; its last line is the completion
sentinel only after a clean end of stream, which the resume logic checks
like RunRUFUS.Trio.sh:77's `tail -n 1 $gen.filter.chr = "booya"`. FASTQ
input has no chromosomes, so its file is "notachr" and the sentinel.
"""

from __future__ import annotations

STREAM_SENTINEL = "booya"


def write_complete(progress_path: str):
    """Mark a FASTQ stream as read to its end."""
    with open(progress_path, "w") as pf:
        pf.write("notachr\n" + STREAM_SENTINEL + "\n")


def stream_complete(progress_path: str) -> bool:
    """True iff the progress file ends with the completion sentinel."""
    try:
        with open(progress_path) as f:
            lines = [l for l in f.read().split("\n") if l]
    except OSError:
        return False
    return bool(lines) and lines[-1] == STREAM_SENTINEL
