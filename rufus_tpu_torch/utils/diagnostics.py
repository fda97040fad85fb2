"""Diagnostics — per-read mutant-k-mer count tables.

Replaces the reference's DumpSamReadKmerCount tool
(src/DumpSamReadKmerCount.cpp:502-522: per read, slide a k-window and
count how many windows are present in the mutant-hash set) with one
host table query over all windows. A copy of the JAX package's
utils/diagnostics.py.
"""

from __future__ import annotations

import numpy as np

from ..ops import codec


def per_read_kmer_hits(seqs, table, k: int):
    """For each sequence, (n_windows, n_hits) against `table` (KmerTable).

    Windows containing non-ACGT bases never hit (HashToLong rejects them
    in the reference). Vectorized per batch via one table query over all
    windows.
    """
    spans = []
    keys = []
    for s in seqs:
        su = s.upper()
        wins = []
        for i in range(max(0, len(su) - k + 1)):
            w = su[i : i + k]
            if any(c not in "ACGT" for c in w):
                wins.append(None)
            else:
                wins.append(codec.str_to_kmer(codec.canonical_str(w)))
        spans.append(wins)
        keys.extend(v for v in wins if v is not None)
    counts = table.query(np.asarray(keys, dtype=np.uint64)) if keys else np.empty(0, np.int64)
    out = []
    pos = 0
    for wins in spans:
        hits = 0
        for v in wins:
            if v is not None:
                if counts[pos] > 0:
                    hits += 1
                pos += 1
        out.append((len(wins), hits))
    return out


def dump_sam_read_kmer_count(sam_lines, table, k: int):
    """Text diagnostic rows `name\\tn_windows\\tn_mutant_hits` for a SAM
    stream (the reference prints a per-read count table)."""
    names, seqs = [], []
    for line in sam_lines:
        if line.startswith("@"):
            continue
        t = line.rstrip("\n").split("\t")
        if len(t) > 9 and t[9] != "*":
            names.append(t[0])
            seqs.append(t[9])
    for name, (nw, nh) in zip(names, per_read_kmer_hits(seqs, table, k)):
        yield f"{name}\t{nw}\t{nh}"
