"""FASTA reference access (fastahack-equivalent random subsequence pulls).

Replaces the vendored fastahack `FastaReference::getSubSequence`
(reference: RUFUS.interpret.cpp:25,46,3067). Whole contigs are held in
memory as numpy uint8; fine for human-scale references (~3GB) on the
125GB dev hosts, and the interpret stage only touches small windows.
"""

from __future__ import annotations

import gzip

import numpy as np


class FastaReference:
    def __init__(self, path: str):
        self.path = path
        self.names: list[str] = []
        self.seqs: dict[str, np.ndarray] = {}
        op = gzip.open if path.endswith(".gz") else open
        cur = None
        parts: list[bytes] = []
        with op(path, "rb") as f:
            for line in f:
                line = line.rstrip(b"\n").rstrip(b"\r")
                if line.startswith(b">"):
                    if cur is not None:
                        self.seqs[cur] = np.frombuffer(b"".join(parts).upper(), np.uint8).copy()
                    cur = line[1:].split()[0].decode()
                    self.names.append(cur)
                    parts = []
                else:
                    parts.append(line)
            if cur is not None:
                self.seqs[cur] = np.frombuffer(b"".join(parts).upper(), np.uint8).copy()

    def length(self, name: str) -> int:
        return len(self.seqs[name])

    def get(self, name: str, start: int, length: int) -> str:
        """0-based subsequence; out-of-range clamped like fastahack."""
        arr = self.seqs[name]
        start = max(0, start)
        return arr[start : start + length].tobytes().decode()

    def contig_array(self, name: str) -> np.ndarray:
        return self.seqs[name]
