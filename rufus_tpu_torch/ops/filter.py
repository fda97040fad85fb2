"""Mutant-read filter: per-window HashList membership with the qual-streak
rule (RUFUS.Filter.cpp:196-277).

* a base is bad iff qual-33 < MinQ or it is not ACGT;
* a window of k consecutive good bases ending at position i is looked up
  iff i <= len-2 (the reference's loop runs `i < length()-1`);
* lookup is orientation-insensitive: the window is canonicalized against a
  canonical table;
* a read pair is kept iff mate1's hit count >= threshold, else mate2's.

``window_hits`` is the kernel wrapper of ``ops/cuda_filter.py``; the port
has this one exact path for any HashList size. A caller that filters many
batches against one HashList builds its ``hashlist_index`` once and passes
it as ``index``.
"""

from __future__ import annotations

import numpy as np

from . import codec
from .cuda_filter import window_hits


def filter_pairs(m1_reads, m1_quals, m1_lens, m2_reads, m2_quals, m2_lens,
                 table_keys, k: int, min_q: int, threshold: int, index=None):
    """Paired-end keep mask: mate1 hits >= T, OR (else) mate2 hits >= T.
    `index` is the table's ``hashlist_index``, when the caller keeps one."""
    h1 = window_hits(m1_reads, m1_quals, m1_lens, table_keys, k, min_q, index)
    h2 = window_hits(m2_reads, m2_quals, m2_lens, table_keys, k, min_q, index)
    return (h1 >= threshold) | (h2 >= threshold), h1, h2


def filter_single(reads, quals, lens, table_keys, k: int, min_q: int,
                  threshold: int, index=None):
    """Single-end keep mask (RUFUS.Filter.ss.cpp path)."""
    h = window_hits(reads, quals, lens, table_keys, k, min_q, index)
    return h >= threshold, h


def exact_hits_host(seq: str, qual: str, sorted_keys: np.ndarray, k: int,
                    min_q: int) -> int:
    """Host replication of the RUFUS.Filter window scan for one read
    (uint64 canonical keys; uppercase ACGT only, as the reference)."""
    hits = 0
    streak = 0
    n = len(seq)
    for i in range(0, n - 1):
        if ord(qual[i]) - 33 < min_q or seq[i] not in "ACGT":
            streak = 0
        else:
            streak += 1
        if streak >= k:
            w = seq[i - k + 1 : i + 1]
            v = np.uint64(codec.str_to_kmer(codec.canonical_str(w)))
            j = int(np.searchsorted(sorted_keys, v))
            if j < len(sorted_keys) and sorted_keys[j] == v:
                hits += 1
    return hits
