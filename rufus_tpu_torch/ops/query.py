"""Genotype pulls: each sample's count of each query k-mer, 0 when absent.

The port of the JAX package's routed multi-table query
(``rufus_tpu/parallel/sharded.py:_sharded_query_multi``, driven by
``RufusPipeline._routed_query_multi``), which routes the queries to the
shard owning each key, bisects there and routes the answers back, with a
padded query capacity and an overflow retry. On one shard the tables are
whole and sorted, so a query is one ``torch.searchsorted`` a table and a
gather of the counts behind a match check: no routing, padding or retry.
Tables sharded over a mesh take the routed form,
``parallel/sharded.py:sharded_query_multi``, with the same lookup. A table
spilled to a flat memmap is bisected on the host instead, as the JAX
package's host pull does (driver.py:1344-1350 there).
"""

from __future__ import annotations

import numpy as np
import torch

from . import codec, count


def query_counts(tables: list, kmers_u64: np.ndarray) -> np.ndarray:
    """Counts of `kmers_u64` (canonical uint64 keys, the host layout) in
    every table of `tables`, as a (len(tables), len(kmers)) int64 host
    array. A `DeviceKmerTable` is searched on its device; a host
    `KmerTable` (a memmapped flat table) is bisected on the host, so only
    the pages its searches touch are read."""
    out = np.zeros((len(tables), len(kmers_u64)), np.int64)
    if not len(kmers_u64):
        return out
    q = None
    for t, table in enumerate(tables):
        if isinstance(table, count.KmerTable):
            out[t] = table.query(kmers_u64)
            continue
        if q is None:
            q = torch.from_numpy(codec.keys_u64_to_i64(kmers_u64)).to(
                table.device)
        table.flush()
        out[t] = lookup(table.keys, table.counts, q).cpu().numpy()
    return out


def lookup(keys: torch.Tensor, counts: torch.Tensor,
           q: torch.Tensor) -> torch.Tensor:
    """Counts of int64 queries `q` in sorted unique `keys` (0 when absent),
    on their device: one ``torch.searchsorted`` and a gather behind a match
    check."""
    if keys.numel() == 0:
        return torch.zeros_like(q)
    idx = torch.clamp(torch.searchsorted(keys, q), max=keys.numel() - 1)
    return torch.where(keys[idx] == q, counts[idx], torch.zeros_like(q))
