"""Kernel 3, window_hits: per-read count of mutant k-mer windows.

Replaces the Pallas kernel ``rufus_tpu/ops/pallas_filter.py:pallas_window_hits``
(RUFUS.Filter's inner loop: encode, streak rule, canonical k-mer, table
membership). The TPU kernel tested membership with a loop unrolled over
every table entry, so the JAX package switched tables above 1024 keys to a
Bloom filter plus host verification; this kernel looks every window up in
the sorted int64 HashList and is exact for any table size, so the port has
one filter path.

On the H100 the work is bound by bytes: the reads and quals (2*B*L) are
read once. The CUDA kernel (``csrc/window_hits.cu``) packs a few reads at a
time into 2-bit codes in shared memory, rolls each window's canonical key,
and finds it through a prefix index of the table (``hashlist_index``, built
once per HashList): two shared-memory loads give the key's range of the
table, usually empty or one key long.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, codec

MAX_INDEX_BITS = 15  # the index, 2**15 + 1 int32, always fits shared memory
_WARPS = 16  # a block's warps (csrc/window_hits.cu, kThreads / 32)
_SMEM_LIMIT = 232448  # an H100 block's shared memory (227 KB)


class HashListIndex(NamedTuple):
    """Prefix index of a sorted table of canonical keys: offsets[p] is the
    first position whose key's top `bits` bits (of 2k) are >= p, for p in
    [0, 2**bits]; the keys with prefix p are table[offsets[p]:offsets[p+1]].
    """
    offsets: torch.Tensor  # (2**bits + 1,) int32, on the table's device
    bits: int
    k: int
    size: int  # the table's length


def index_bits(T: int, k: int) -> int:
    """ceil(log2 T) + 1 prefix bits (about one key in two buckets), at most
    MAX_INDEX_BITS and 2k."""
    return min(max(1, (T - 1).bit_length() + 1), MAX_INDEX_BITS, 2 * k)


def hashlist_index(table_keys: torch.Tensor, k: int) -> HashListIndex:
    """The prefix index of a sorted unique int64 table of canonical k-mer
    keys: ``searchsorted`` of its 2**bits + 1 bucket edges, once per
    HashList, on the table's device."""
    codec.check_k(k)
    if table_keys.dim() != 1 or table_keys.dtype != torch.int64:
        raise TypeError("table_keys must be a 1-D int64 tensor")
    T = table_keys.numel()
    if T >= 1 << 31:
        raise ValueError(f"a table of {T} keys does not fit int32 offsets")
    bits = index_bits(T, k)
    edges = torch.arange((1 << bits) + 1, dtype=torch.int64,
                         device=table_keys.device) << (2 * k - bits)
    offsets = torch.searchsorted(table_keys, edges).to(torch.int32)
    return HashListIndex(offsets.contiguous(), bits, k, T)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_plan(L: int, T: int, bits: int):
    """(rw, keys_smem): reads a warp takes a step (4, 2 or 1, so that a
    step's raw bytes stay near 1 KB), and whether the table's keys fit a
    block's shared memory beside the index and the warps' buffers, as
    ``block_bytes`` in csrc/window_hits.cu lays it out: the index, the
    keys, then each warp's two raw buffers and packed step."""
    rw = 4 if L <= 256 else 2 if L <= 512 else 1
    words = (L + 31) // 32 + 1
    rb = _align16(rw * L + 32)
    buf = 2 * rb + _align16(4 * rw)
    warp = 2 * buf + _align16(rw * words * 12 + 16)
    index = _align16(4 * ((1 << bits) + 1))
    return rw, index + _align16(8 * T) + _WARPS * warp <= _SMEM_LIMIT


def window_hits_torch(reads, quals, lens, table_keys, k: int, min_q: int):
    """Plain PyTorch version: the cumsum streak of the reference's XLA
    filter plus ``torch.searchsorted``."""
    B, L = reads.shape
    if table_keys.numel() == 0:
        return torch.zeros(B, dtype=torch.int32, device=reads.device)
    codes = codec.encode_bases(reads)
    pos = torch.arange(L, device=reads.device)
    good = ((codes != codec.INVALID) & (quals.to(torch.int32) - 33 >= min_q)
            & (pos[None, :] < lens[:, None]))
    kmers, _ = codec.pack_kmers(codes, k)
    canon = codec.canonical_kmers(kmers, k)
    run = torch.cumsum(good.to(torch.int32), dim=1)
    run0 = torch.nn.functional.pad(run, (1, 0))
    run_k = run[:, k - 1:] - run0[:, : L - k + 1]
    end_pos = pos[k - 1:]
    scanned = (run_k == k) & (end_pos[None, :] <= lens[:, None] - 2)
    idx = torch.searchsorted(table_keys, canon)
    idx = torch.clamp(idx, max=table_keys.numel() - 1)
    member = table_keys[idx] == canon
    return (scanned & member).sum(dim=1).to(torch.int32)


def _window_hits_cuda(reads, quals, lens, table_keys, k: int, min_q: int,
                      index: HashListIndex):
    B, L = reads.shape
    T = table_keys.numel()
    rw, keys_smem = smem_plan(L, T, index.bits)
    out = torch.empty(B, dtype=torch.int32, device=reads.device)
    P, I64, I32 = _build.P, _build.I64, _build.I32
    fn = _build.function("window_hits", "rt_window_hits",
                         [P, P, P, I64, I32, P, I32, P, I32, I32, I32, I32,
                          I32, P, P])
    _build.check(fn(_build.ptr(reads), _build.ptr(quals), _build.ptr(lens), B,
                    L, _build.ptr(table_keys), T, _build.ptr(index.offsets),
                    index.bits, k, min_q, rw, int(keys_smem),
                    _build.ptr(out), _build.stream_ptr(reads.device)),
                 "window_hits")
    window_hits.launches += 1
    return out


def _check_index(index: HashListIndex, table_keys, k: int):
    off = index.offsets
    if (index.k != k or index.size != table_keys.numel()
            or off.shape != ((1 << index.bits) + 1,) or off.dtype != torch.int32
            or off.device != table_keys.device or not off.is_contiguous()
            or not 1 <= index.bits <= min(MAX_INDEX_BITS, 2 * k)):
        raise ValueError("index is not hashlist_index(table_keys, k)")


def window_hits(reads, quals, lens, table_keys, k: int, min_q: int,
                index: HashListIndex | None = None):
    """(B, L) uint8 reads and quals, (B,) int32 lengths, sorted unique (T,)
    int64 canonical table -> (B,) int32 hit counts.

    `index` is ``hashlist_index(table_keys, k)`` when the caller keeps one
    for its HashList; else the CUDA route builds it. A CUDA tensor goes
    through the CUDA kernel; a CPU tensor through ``window_hits_torch``."""
    codec.check_k(k)
    if reads.dim() != 2 or reads.dtype != torch.uint8:
        raise TypeError("reads must be a (B, L) uint8 tensor")
    if quals.shape != reads.shape or quals.dtype != torch.uint8:
        raise TypeError("quals must be a uint8 tensor shaped like reads")
    if lens.shape != (reads.shape[0],) or lens.dtype != torch.int32:
        raise TypeError("lens must be a (B,) int32 tensor")
    if table_keys.dim() != 1 or table_keys.dtype != torch.int64:
        raise TypeError("table_keys must be a 1-D int64 tensor")
    if reads.shape[1] < k:
        raise ValueError(f"read width {reads.shape[1]} < k={k}")
    devs = {t.device for t in (reads, quals, lens, table_keys)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if index is not None:
        _check_index(index, table_keys, k)
    if reads.device.type == "cpu":
        return window_hits_torch(reads, quals, lens, table_keys, k, min_q)
    if reads.device.type != "cuda":
        raise ValueError(f"unsupported device {reads.device}")
    if not all(t.is_contiguous() for t in (reads, quals, lens, table_keys)):
        raise ValueError("inputs must be contiguous")
    if index is None:
        index = hashlist_index(table_keys, k)
    return _window_hits_cuda(reads, quals, lens, table_keys, k, min_q, index)


window_hits.launches = 0
