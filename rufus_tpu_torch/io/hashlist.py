"""HashList text format: the inter-stage k-mer set contract.

Two-column `kmer<TAB>count` (merge/query output) and four-column
`longhash<TAB>parentDepth<TAB>subjCount<TAB>kmer` (RUFUS.Build.cpp:267-269).
Consumers sniff both (reference: RUFUS.Filter.cpp:121-143,
RUFUS.interpret.cpp:5643-5671).
"""

from __future__ import annotations

import numpy as np

from ..ops import codec


def write_hashlist(path: str, kmers: np.ndarray, counts: np.ndarray, k: int):
    """2-col kmer<TAB>count, matching CheckJellyHashList.sh query output."""
    with open(path, "w") as f:
        for s, c in zip(codec.kmers_to_strs(kmers, k), counts):
            f.write(f"{s} {int(c)}\n")


def read_hashlist(path: str):
    """Sniff 2-col / 4-col / bare formats -> (list of kmer strings, counts).

    Mirrors the RUFUS.Filter.cpp loader: space-split, 2 tokens -> col 0;
    4 tokens -> col 3; single token -> tab-split col 0.
    """
    kmers, counts = [], []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(" ")
            if len(parts) == 2:
                kmers.append(parts[0])
                counts.append(int(parts[1]))
            elif len(parts) == 4:
                kmers.append(parts[3])
                counts.append(int(parts[2]))
            else:
                parts = line.split("\t")
                kmers.append(parts[0])
                counts.append(int(parts[1]) if len(parts) > 1 else 0)
    return kmers, counts


def hashlist_keys(path: str, k: int, canonical: bool = True) -> np.ndarray:
    """Load a HashList into sorted canonical uint64 keys for device lookup."""
    strs, _ = read_hashlist(path)
    if not strs:
        return np.empty(0, np.uint64)
    if canonical:
        strs = [codec.canonical_str(s.upper()) for s in strs]
    return np.sort(codec.strs_to_kmers(strs, k))
