"""K-mer counting as sort + run-length compaction, and the host table.

The reference's Jellyfish hash (large_hash_array.hpp) becomes, as in the
JAX package: pack -> canonicalize -> sort -> compact runs, folded LSM
fashion into a sorted unique (key, count) table. Device functions take
int64 keys with the INT64_MAX sentinel and return compacted results
(unique keys, counts) sized exactly; the JAX package's versions return
sentinel-padded arrays instead. ``KmerTable`` is the host form, in the
reference's uint64 layout, and the ``.npz`` file format.
"""

from __future__ import annotations

import numpy as np
import torch

from . import codec
from .cuda_fold import compact_runs


def count_batch(keys: torch.Tensor):
    """Raw count-1 keys (any shape; sentinels allowed) -> sorted unique
    keys and their counts."""
    return compact_runs(torch.sort(keys.reshape(-1)).values)


def merge_sorted(a_keys, a_counts, b_keys, b_counts):
    """Merge two (keys, counts) runs -> sorted unique keys, summed counts."""
    keys = torch.cat([a_keys, b_keys])
    cnts = torch.cat([a_counts, b_counts])
    s, order = torch.sort(keys, stable=True)
    return compact_runs(s, cnts[order])


class KmerTable:
    """A sample's k-mer count table on the host: sorted unique uint64 keys
    and int64 counts (the role of a `.Jhash`). Serialized as npz; text
    dump `kmer count`, lexicographic order."""

    def __init__(self, k: int, keys: np.ndarray, counts: np.ndarray):
        self.k = int(k)
        self.keys = np.asarray(keys, dtype=np.uint64)
        self.counts = np.asarray(counts, dtype=np.int64)

    def __len__(self):
        return len(self.keys)

    @classmethod
    def from_rle_chunks(cls, k: int, chunks, lower_count: int = 0):
        """Fold per-batch (keys uint64, counts) host chunks into one table;
        sentinel (all-ones) keys are ignored. `lower_count` mirrors
        jellyfish `count -L`: k-mers with final count < L are dropped."""
        keys_list, cnt_list = [], []
        for keys, counts in chunks:
            keys = np.asarray(keys, dtype=np.uint64)
            counts = np.asarray(counts, dtype=np.int64)
            mask = keys != codec.SENTINEL_U64
            keys_list.append(keys[mask])
            cnt_list.append(counts[mask])
        if not keys_list:
            return cls(k, np.empty(0, np.uint64), np.empty(0, np.int64))
        keys = np.concatenate(keys_list)
        cnts = np.concatenate(cnt_list)
        order = np.argsort(keys, kind="stable")
        keys, cnts = keys[order], cnts[order]
        head = np.ones(len(keys), dtype=bool)
        head[1:] = keys[1:] != keys[:-1]
        starts = np.flatnonzero(head)
        sums = np.add.reduceat(cnts, starts) if len(cnts) else cnts
        ukeys = keys[starts]
        if lower_count > 1:
            keep = sums >= lower_count
            ukeys, sums = ukeys[keep], sums[keep]
        return cls(k, ukeys, sums)

    def query(self, kmers: np.ndarray) -> np.ndarray:
        """Batched point lookup of canonical uint64 k-mers -> counts (0 when
        absent); replaces `jellyfish query`."""
        kmers = np.asarray(kmers, dtype=np.uint64)
        if len(self.keys) == 0:
            return np.zeros(len(kmers), dtype=np.int64)
        idx = np.minimum(np.searchsorted(self.keys, kmers), len(self.keys) - 1)
        hit = self.keys[idx] == kmers
        return np.where(hit, self.counts[idx], 0)

    def histo(self, max_count: int = 10001) -> np.ndarray:
        """Count histogram; bin i = #kmers with count i, the last bin holds
        the tail (`jellyfish histo` defaults)."""
        c = np.minimum(self.counts, max_count)
        return np.bincount(c, minlength=max_count + 1).astype(np.int64)

    def save(self, path: str):
        np.savez(path, k=self.k, keys=self.keys, counts=self.counts)

    @classmethod
    def load(cls, path: str):
        z = np.load(path)
        return cls(int(z["k"]), z["keys"], z["counts"])

    def dump_text(self, path: str):
        with open(path, "w") as f:
            for s, c in zip(codec.kmers_to_strs(self.keys, self.k), self.counts):
                f.write(f"{s} {c}\n")


def subtract_unique(tables: list[KmerTable], merge_min: int = 5) -> np.ndarray:
    """Host reference of the modified merge (merge_files.cc:147-153): k-mers
    present in EXACTLY ONE table with that table's count >= merge_min,
    sorted uint64."""
    if not tables:
        return np.empty(0, np.uint64)
    keys = np.concatenate([t.keys for t in tables])
    cnts = np.concatenate([t.counts for t in tables])
    order = np.argsort(keys, kind="stable")
    keys, cnts = keys[order], cnts[order]
    head = np.ones(len(keys), dtype=bool)
    tail = np.ones(len(keys), dtype=bool)
    if len(keys) > 1:
        head[1:] = keys[1:] != keys[:-1]
        tail[:-1] = keys[1:] != keys[:-1]
    keep = head & tail & (cnts >= merge_min)
    return keys[keep]
