"""Genotype pulls: each sample's count of each query k-mer, 0 when absent.

The port of the JAX package's routed multi-table query
(``rufus_tpu/parallel/sharded.py:_sharded_query_multi``, driven by
``RufusPipeline._routed_query_multi``), which routes the queries to the
shard owning each key, bisects there and routes the answers back, with a
padded query capacity and an overflow retry. On one card the tables are
whole and sorted, so a query is one ``torch.searchsorted`` a table and a
gather of the counts behind a match check: no routing, padding or retry.
"""

from __future__ import annotations

import numpy as np
import torch

from . import codec


def query_counts(tables: list, kmers_u64: np.ndarray) -> np.ndarray:
    """Counts of `kmers_u64` (canonical uint64 keys, the host layout) in
    every `DeviceKmerTable` of `tables`, as a (len(tables), len(kmers))
    int64 host array."""
    out = np.zeros((len(tables), len(kmers_u64)), np.int64)
    if not len(kmers_u64) or not tables:
        return out
    q = torch.from_numpy(codec.keys_u64_to_i64(kmers_u64)).to(
        tables[0].device)
    for t, table in enumerate(tables):
        table.flush()
        keys = table.keys
        if keys.numel() == 0:
            continue
        idx = torch.clamp(torch.searchsorted(keys, q), max=keys.numel() - 1)
        hit = keys[idx] == q
        cnt = torch.where(hit, table.counts[idx], torch.zeros_like(q))
        out[t] = cnt.cpu().numpy()
    return out
