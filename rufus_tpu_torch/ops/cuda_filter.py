"""Kernel 3, window_hits: per-read count of mutant k-mer windows.

Replaces the Pallas kernel ``rufus_tpu/ops/pallas_filter.py:pallas_window_hits``
(RUFUS.Filter's inner loop: encode, streak rule, canonical k-mer, table
membership). The TPU kernel tested membership with a loop unrolled over
every table entry, so the JAX package switched tables above 1024 keys to a
Bloom filter plus host verification; this kernel binary-searches the
sorted int64 HashList and is exact for any table size, so the port has one
filter path.

On the H100 the work is bound by bytes: the reads and quals (2*B*L) are
read once. The CUDA kernel (``csrc/window_hits.cu``) stages a block's reads
as good-base codes in shared memory, keeps the table there too when it
fits (else it reads it through the read-only cache), and rolls the
canonical key over runs of windows.
"""

from __future__ import annotations

import torch

from . import _build, codec

_STAGE_BYTES = 16384  # shared-memory bytes of staged reads per block
_SMEM_LIMIT = 232448  # an H100 block's shared memory (227 KB)


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


def _window_hits_cuda(reads, quals, lens, table_keys, k: int, min_q: int):
    B, L = reads.shape
    T = table_keys.numel()
    rows = max(1, min(64, _STAGE_BYTES // L))
    smem_table = T * 8 + rows * (L + 4) <= _SMEM_LIMIT
    out = torch.empty(B, dtype=torch.int32, device=reads.device)
    P, I64, I32 = _build.P, _build.I64, _build.I32
    fn = _build.function("window_hits", "rt_window_hits",
                         [P, P, P, I64, I32, P, I64, I32, I32, I32, I32, P, P])
    _build.check(fn(_build.ptr(reads), _build.ptr(quals), _build.ptr(lens), B,
                    L, _build.ptr(table_keys), T, k, min_q, rows,
                    int(smem_table), _build.ptr(out),
                    _build.stream_ptr(reads.device)), "window_hits")
    window_hits.launches += 1
    return out


def window_hits(reads, quals, lens, table_keys, k: int, min_q: int):
    """(B, L) uint8 reads and quals, (B,) int32 lengths, sorted unique (T,)
    int64 canonical table -> (B,) int32 hit counts.

    A CUDA tensor goes through the CUDA kernel; a CPU tensor through
    ``window_hits_torch``."""
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
    if reads.device.type == "cpu":
        return window_hits_torch(reads, quals, lens, table_keys, k, min_q)
    if reads.device.type != "cuda":
        raise ValueError(f"unsupported device {reads.device}")
    if not all(t.is_contiguous() for t in (reads, quals, lens, table_keys)):
        raise ValueError("inputs must be contiguous")
    return _window_hits_cuda(reads, quals, lens, table_keys, k, min_q)


window_hits.launches = 0
