"""K-mer counting as sort + run-length compaction, and the host table.

The reference's Jellyfish hash (large_hash_array.hpp) becomes, as in the
JAX package: pack -> canonicalize -> sort -> compact runs, folded LSM
fashion into a sorted unique (key, count) table. Device functions take
int64 keys with the INT64_MAX sentinel and return compacted results
(unique keys, counts) sized exactly; the JAX package's versions return
sentinel-padded arrays instead. ``KmerTable`` is the host form, in the
reference's uint64 layout, and its two file formats: ``.npz`` and the
flat memmap layout of spilled tables (``.table.flat``), which the JAX
package reads and writes byte for byte alike.

The streams over flat tables (``merge_flat_runs``, ``concat_flat``,
``subtract_unique_stream``) hold O(chunk) on the host and the device: each
chunk's merge-sum or membership test runs on the pipeline's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import codec
from .cuda_fold import compact_runs


def count_batch(keys: torch.Tensor):
    """Raw count-1 keys (any shape; sentinels allowed) -> sorted unique
    keys and their counts."""
    return compact_runs(torch.sort(keys.reshape(-1)).values)


def merge_sum(key_parts: list, count_parts: list):
    """The merge-sum of (keys, counts) parts on their device: the sorted
    unique keys and each one's summed count, by a stable sort and the
    counted route of `compact_runs`. It empties both lists and drops each
    step's input as soon as the next step has it, so a caller that keeps
    no other reference to the parts holds at most one sort's worth."""
    keys = torch.cat(key_parts)
    key_parts.clear()
    counts = torch.cat(count_parts)
    count_parts.clear()
    s, order = torch.sort(keys, stable=True)
    del keys
    counts = counts[order]
    del order
    return compact_runs(s, counts)


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

    @classmethod
    def from_strings(cls, k: int, seqs):
        """Count the k-mers of host strings as read, not canonicalized
        (uppercased; windows with a non-ACGT base skipped): the contig and
        reference-context tabs of contig alignment."""
        counts: dict[int, int] = {}
        for s in seqs:
            su = s.upper()
            for i in range(len(su) - k + 1):
                w = su[i : i + k]
                if any(c not in "ACGT" for c in w):
                    continue
                v = codec.str_to_kmer(w)
                counts[v] = counts.get(v, 0) + 1
        items = sorted(counts.items())
        keys = np.array([kv[0] for kv in items], dtype=np.uint64)
        cnts = np.array([kv[1] for kv in items], dtype=np.int64)
        return cls(k, keys, cnts)

    def query(self, kmers: np.ndarray) -> np.ndarray:
        """Batched point lookup of canonical uint64 k-mers -> counts (0 when
        absent); replaces `jellyfish query`."""
        kmers = np.asarray(kmers, dtype=np.uint64)
        if len(self.keys) == 0:
            return np.zeros(len(kmers), dtype=np.int64)
        idx = np.minimum(np.searchsorted(self.keys, kmers), len(self.keys) - 1)
        hit = self.keys[idx] == kmers
        return np.where(hit, self.counts[idx], 0)

    def query_strs(self, seqs) -> np.ndarray:
        """Counts of k-mer strings, each canonicalized first."""
        canon = [codec.canonical_str(s.upper()) for s in seqs]
        return self.query(codec.strs_to_kmers(canon, self.k))

    def histo(self, max_count: int = 10001,
              chunk: int = 1 << 26) -> np.ndarray:
        """Count histogram; bin i = #kmers with count i, the last bin holds
        the tail (`jellyfish histo` defaults). Chunked, so a memmapped
        table histograms in O(chunk) memory."""
        out = np.zeros(max_count + 1, np.int64)
        for off in range(0, len(self.counts), chunk):
            c = np.minimum(np.asarray(self.counts[off:off + chunk]),
                           max_count)
            out += np.bincount(c, minlength=max_count + 1)
        return out

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

    # flat layout (the JAX package's): 4-byte magic and 4 pad bytes, which
    # 8-align the planes for the memmap's searchsorted, <u8 k and n, then
    # n <u8 keys and n <i8 counts
    FLAT_MAGIC = b"RTK2"
    FLAT_HEAD = 8 + 16

    def save_flat(self, path: str):
        """Write the flat layout, through a temporary file."""
        with atomic_write(path) as f:
            write_flat_header(f, self.k, len(self.keys))
            self.keys.astype("<u8").tofile(f)
            self.counts.astype("<i8").tofile(f)

    @classmethod
    def load_flat(cls, path: str):
        """Open a flat table as a memmap: the planes are demand-paged
        (`query` and `histo` work on them unchanged)."""
        k, n = read_flat_header(path)
        off = cls.FLAT_HEAD
        keys = np.memmap(path, dtype="<u8", mode="r", offset=off, shape=(n,))
        counts = np.memmap(path, dtype="<i8", mode="r", offset=off + 8 * n,
                           shape=(n,))
        t = cls.__new__(cls)
        t.k, t.keys, t.counts = k, keys.view(np.uint64), counts.view(np.int64)
        return t

    @property
    def mapped(self) -> bool:
        """Whether the planes are a memmap of a flat file."""
        return isinstance(self.keys, np.memmap)


def write_flat_header(f, k: int, n: int):
    f.write(KmerTable.FLAT_MAGIC + b"\0\0\0\0")
    np.array([k, n], dtype="<u8").tofile(f)


def read_flat_header(path: str):
    """(k, n) of a flat table; ValueError for any other file."""
    with open(path, "rb") as f:
        if f.read(4) != KmerTable.FLAT_MAGIC:
            raise ValueError(f"{path}: not a flat k-mer table")
        f.read(4)
        head = np.fromfile(f, dtype="<u8", count=2)
    if len(head) != 2:
        raise ValueError(f"{path}: truncated flat k-mer table")
    return int(head[0]), int(head[1])


class atomic_write:
    """Open `path + ".tmp"` for writing; on a clean exit it replaces
    `path`, on an exception it is removed, so `path` never holds a partial
    file."""

    def __init__(self, path: str):
        self.path, self.tmp = path, path + ".tmp"

    def __enter__(self):
        self.f = open(self.tmp, "wb")
        return self.f

    def __exit__(self, exc_type, *_):
        self.f.close()
        if exc_type is None:
            os.replace(self.tmp, self.path)
        else:
            os.remove(self.tmp)
        return False


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host chunk of uint64 keys (< 2**62) or int64 counts -> int64
    tensor on device."""
    return torch.from_numpy(np.array(a, dtype=np.int64)).to(device)


def merge_flat_runs(run_paths: list[str], out_path: str,
                    lower_count: int = 0, chunk: int = 1 << 24,
                    device="cpu") -> KmerTable:
    """Streaming k-way merge-sum of sorted unique flat runs into one flat
    table, with the `-L` floor on the final counts (jellyfish --disk's
    sorted runs, count_main.cc:318-338). The runs overlap in key space.
    Each step takes at most `chunk` keys of every run, cut at the least of
    the runs' last keys in it (side "right"), so every key of the step is
    final and the floor applies to it. The step's `merge_sum` runs on
    `device`. The output is written through a temporary file, so an
    interrupted merge leaves no `out_path`."""
    tabs = [KmerTable.load_flat(p) for p in run_paths]
    k = tabs[0].k
    cursors = [0] * len(tabs)
    n_out = 0
    counts_tmp = out_path + ".counts.tmp"
    with atomic_write(out_path) as f:
        try:
            with open(counts_tmp, "wb") as cf:
                write_flat_header(f, k, 0)
                while True:
                    bounds = [t.keys[min(c + chunk, len(t.keys)) - 1]
                              for t, c in zip(tabs, cursors)
                              if c < len(t.keys)]
                    if not bounds:
                        break
                    bound = min(bounds)
                    parts_k, parts_c = [], []
                    for i, t in enumerate(tabs):
                        c = cursors[i]
                        if c >= len(t.keys):
                            continue
                        win = np.asarray(t.keys[c:c + chunk])
                        e = c + int(np.searchsorted(win, bound, side="right"))
                        if e > c:
                            parts_k.append(win[: e - c])
                            parts_c.append(np.asarray(t.counts[c:e]))
                            cursors[i] = e
                    uk, sums = merge_sum(
                        [_to_device(a, device) for a in parts_k],
                        [_to_device(a, device) for a in parts_c])
                    del parts_k, parts_c
                    if lower_count > 1:
                        keep = sums >= lower_count
                        uk, sums = uk[keep], sums[keep]
                    uk.cpu().numpy().astype("<u8").tofile(f)
                    sums.cpu().numpy().astype("<i8").tofile(cf)
                    n_out += uk.numel()
            with open(counts_tmp, "rb") as src:
                while True:
                    buf = src.read(1 << 24)
                    if not buf:
                        break
                    f.write(buf)
            f.seek(0)
            write_flat_header(f, k, n_out)
        finally:
            if os.path.exists(counts_tmp):
                os.remove(counts_tmp)
    return KmerTable.load_flat(out_path)


def concat_flat(part_paths: list[str], out_path: str,
                chunk: int = 1 << 24) -> KmerTable:
    """Splice flat tables of disjoint ascending key ranges into one flat
    table (the multipass count's passes): their key sections in order,
    then their count sections, under a summed header; O(chunk) memory,
    written through a temporary file."""
    heads = [read_flat_header(p) for p in part_paths]
    k = heads[0][0]

    def copy_section(dst, src_path, src_off, nbytes):
        with open(src_path, "rb") as src:
            src.seek(src_off)
            left = nbytes
            while left > 0:
                buf = src.read(min(chunk, left))
                dst.write(buf)
                left -= len(buf)

    with atomic_write(out_path) as f:
        write_flat_header(f, k, sum(n for _, n in heads))
        for p, (_, n) in zip(part_paths, heads):
            copy_section(f, p, KmerTable.FLAT_HEAD, 8 * n)
        for p, (_, n) in zip(part_paths, heads):
            copy_section(f, p, KmerTable.FLAT_HEAD + 8 * n, 8 * n)
    return KmerTable.load_flat(out_path)


def build_hashlist_4col(subject: KmerTable, parents: list[KmerTable],
                        min_cov_subject: int, max_cov_control: int,
                        max_coverage: int = 1200):
    """The legacy RUFUS.Build path (RUFUS.Build.cpp:224-283) as host table
    queries: (keys, summed parent count, subject count) of the subject
    k-mers with count in [min_cov_subject, max_coverage] whose summed
    parent count is <= max_cov_control, the rows of the 4-column HashList
    `longhash \\t parentDepth \\t subjCount \\t kmer`."""
    keep = (subject.counts >= min_cov_subject) & (subject.counts <= max_coverage)
    keys = subject.keys[keep]
    scnt = subject.counts[keep]
    total_par = np.zeros(len(keys), dtype=np.int64)
    for p in parents:
        total_par += p.query(keys)
    keep2 = total_par <= max_cov_control
    return keys[keep2], total_par[keep2], scnt[keep2]


def population_filter(mutant: KmerTable, population: KmerTable,
                      max_pop_depth: int) -> KmerTable:
    """The RUFUS.1kg.filter role: drop the mutant k-mers whose count in a
    population table (1000 Genomes common k-mers, say) passes
    max_pop_depth."""
    pop = population.query(mutant.keys)
    keep = pop <= max_pop_depth
    return KmerTable(mutant.k, mutant.keys[keep], mutant.counts[keep])


def absent_from(keys: torch.Tensor, control: torch.Tensor) -> torch.Tensor:
    """Mask of `keys` not in the sorted `control` keys (a binary search a
    key): the modified merge's membership test."""
    if control.numel() == 0:
        return torch.ones_like(keys, dtype=torch.bool)
    idx = torch.clamp(torch.searchsorted(control, keys), max=control.numel() - 1)
    return control[idx] != keys


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


def subtract_unique_stream(tables: list[KmerTable], merge_min: int,
                           min_cov: int, max_depth: int,
                           chunk: int = 1 << 24, device="cpu"):
    """The modified merge fused with the subject count-range pull, for
    tables that are not on the device (memmapped flat tables, or tables
    resumed from disk): SUBJECT keys absent from every control, with
    subject count in [max(merge_min, min_cov), max_depth]. Streams the
    subject in chunks of `chunk` keys; each goes to `device` with the slice
    of each control that covers its key range (two bisections of the
    control), where a binary search tests membership. Returns the sorted
    (uint64 keys, int64 subject counts), as the JAX function does."""
    subj = tables[0]
    lo = max(merge_min, min_cov)
    out_k, out_c = [], []
    for off in range(0, len(subj.keys), chunk):
        ks = np.asarray(subj.keys[off:off + chunk])
        cs = np.asarray(subj.counts[off:off + chunk])
        keep = (cs >= lo) & (cs <= max_depth)
        ks, cs = ks[keep], cs[keep]
        if len(ks):
            sk = _to_device(ks, device)
            mask = torch.ones_like(sk, dtype=torch.bool)
            for t in tables[1:]:
                a = int(np.searchsorted(t.keys, ks[0], side="left"))
                b = int(np.searchsorted(t.keys, ks[-1], side="right"))
                if b > a:
                    mask &= absent_from(sk, _to_device(t.keys[a:b], device))
            mask = mask.cpu().numpy()
            ks, cs = ks[mask], cs[mask]
        out_k.append(ks)
        out_c.append(cs)
    if not out_k:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    return np.concatenate(out_k), np.concatenate(out_c)
