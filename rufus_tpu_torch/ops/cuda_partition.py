"""Kernel 4, partition: MSD radix partition of int64 keys into 16 buckets.

Replaces the Pallas kernel ``tools/radixbench.py:partition``, which the JAX
package's measurement tool used to ask whether the fold should partition
its pending keys by their leading bits and sort the buckets apart instead
of sorting them all at once. The fold itself keeps its one global sort
(``ops/table.py``); only ``rufus_tpu_torch.tools.radixbench`` runs this.

Every 8192-key block is sorted on its own; then each block's run of each
bucket goes to that bucket's region, blocks in order. A key's bucket is its
first two bases, ``clamp(key >> (2k - 4), 0, 15)``, so the INT64_MAX
sentinel closes bucket 15. The TPU kernel copied row-aligned runs because
it had no scatter; the CUDA kernel (``csrc/partition.cu``) writes every key
once, to its exact slot, so the output holds each key exactly once.

On the H100 the work is bound by bytes: the keys are read once and written
once. The run metadata (per-(block, bucket) counts and each run's cursor in
the output) takes two more kernels on the card, a count pass over the keys
and a scan of the counts; on the CPU it is the ``torch.bincount`` form.
"""

from __future__ import annotations

import torch

from . import _build, codec

BLOCK = 8192   # keys per sorted block (csrc/partition.cu)
BUCKETS = 16   # MSD radix digits: the first two bases


def _shift(k: int) -> int:
    codec.check_k(k)
    if k < 2:
        raise ValueError(f"k={k}: the bucket is the first two bases, so k >= 2")
    return 2 * k - 4


def bucket_of(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Each key's bucket: its first two bases, clamped to [0, 15]."""
    return torch.clamp(keys >> _shift(k), 0, BUCKETS - 1)


def run_metadata_torch(keys: torch.Tensor, k: int):
    """Plain PyTorch version of ``run_metadata``: ``torch.bincount`` onto
    16 bins a block, then a bucket-major exclusive scan."""
    n = keys.numel()
    nblk = -(-n // BLOCK)
    idx = bucket_of(keys, k)
    idx += torch.arange(n, device=keys.device) // BLOCK * BUCKETS
    runlen = torch.bincount(idx, minlength=nblk * BUCKETS).reshape(nblk,
                                                                    BUCKETS)
    offsets = torch.zeros(BUCKETS + 1, dtype=torch.int64, device=keys.device)
    offsets[1:] = torch.cumsum(runlen.sum(0), 0)
    cursors = torch.cumsum(runlen, 0) - runlen + offsets[:-1]
    return runlen, cursors, offsets


_META_GROUPS = 1024  # the most runs of blocks the count kernel is given


def _run_metadata_cuda(keys: torch.Tensor, k: int):
    n = keys.numel()
    nblk = -(-n // BLOCK)
    runlen = torch.empty((nblk, BUCKETS), dtype=torch.int64,
                         device=keys.device)
    cursors = torch.empty_like(runlen)
    offsets = torch.empty(BUCKETS + 1, dtype=torch.int64, device=keys.device)
    groups = max(1, min(nblk, _META_GROUPS))
    totals = torch.empty((groups, BUCKETS), dtype=torch.int64,
                         device=keys.device)
    P, I64, I32 = _build.P, _build.I64, _build.I32
    fn = _build.function("partition", "rt_partition_meta",
                         [P, I64, I32, P, P, P, P, I32, P])
    _build.check(fn(_build.ptr(keys), n, _shift(k), _build.ptr(runlen),
                    _build.ptr(cursors), _build.ptr(offsets),
                    _build.ptr(totals), groups,
                    _build.stream_ptr(keys.device)), "partition metadata")
    run_metadata.launches += 1
    return runlen, cursors, offsets


def run_metadata(keys: torch.Tensor, k: int):
    """(runlen, cursors, offsets) of `keys`: runlen (nblocks, 16) counts the
    keys of each bucket in each 8192-key block; cursors (nblocks, 16) is
    where that run starts in the output (a bucket-major exclusive scan of
    runlen); offsets (17,) bounds each bucket's region. All int64.

    A CUDA tensor goes through the count and scan kernels; a CPU tensor
    through ``run_metadata_torch``."""
    if keys.dim() != 1 or keys.dtype != torch.int64:
        raise TypeError(f"keys must be a 1-D int64 tensor, got "
                        f"{tuple(keys.shape)} {keys.dtype}")
    _shift(k)
    if keys.device.type == "cpu":
        return run_metadata_torch(keys, k)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    return _run_metadata_cuda(keys, k)


run_metadata.launches = 0


def block_sort_torch(keys: torch.Tensor) -> torch.Tensor:
    """Each 8192-key block of `keys` sorted ascending; a partial last block
    is padded with the sentinel for the sort, and the padding cut off."""
    n = keys.numel()
    nblk = -(-n // BLOCK)
    pad = torch.full((nblk * BLOCK - n,), codec.SENTINEL, dtype=torch.int64,
                     device=keys.device)
    s = torch.sort(torch.cat([keys, pad]).view(nblk, BLOCK), dim=1).values
    return s.reshape(-1)[:n]


def partition_torch(keys: torch.Tensor, k: int):
    """Plain PyTorch version: a sort per block, then a stable sort by
    bucket. Returns (out (n,) int64, offsets (17,) int64)."""
    s = block_sort_torch(keys)
    b = bucket_of(s, k)
    out = s[torch.sort(b, stable=True).indices]
    offsets = torch.zeros(BUCKETS + 1, dtype=torch.int64, device=keys.device)
    offsets[1:] = torch.cumsum(torch.bincount(b, minlength=BUCKETS), 0)
    return out, offsets


def _partition_cuda(keys: torch.Tensor, k: int, runlen: torch.Tensor,
                    cursors: torch.Tensor):
    out = torch.empty_like(keys)
    n = keys.numel()
    if n:
        P, I64, I32 = _build.P, _build.I64, _build.I32
        fn = _build.function("partition", "rt_partition",
                             [P, I64, I32, P, P, P, P])
        _build.check(fn(_build.ptr(keys), n, _shift(k), _build.ptr(runlen),
                        _build.ptr(cursors), _build.ptr(out),
                        _build.stream_ptr(keys.device)), "partition")
        partition.launches += 1
    return out


def partition(keys: torch.Tensor, k: int, meta=None):
    """(n,) int64 keys -> (out (n,) int64, offsets (17,) int64): bucket b
    is out[offsets[b]:offsets[b + 1]], its blocks' runs in block order,
    each ascending.

    `meta` is ``run_metadata(keys, k)`` when the caller has it already (the
    radix tool times the kernel apart from it). A CUDA tensor goes through
    the CUDA kernel; a CPU tensor through ``partition_torch``."""
    if keys.dim() != 1 or keys.dtype != torch.int64:
        raise TypeError(f"keys must be a 1-D int64 tensor, got "
                        f"{tuple(keys.shape)} {keys.dtype}")
    _shift(k)
    if keys.device.type == "cpu":
        return partition_torch(keys, k)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    runlen, cursors, offsets = run_metadata(keys, k) if meta is None else meta
    nblk = -(-keys.numel() // BLOCK)
    for t in (runlen, cursors):
        if (t.shape != (nblk, BUCKETS) or t.dtype != torch.int64
                or t.device != keys.device or not t.is_contiguous()):
            raise ValueError("meta does not belong to these keys")
    return _partition_cuda(keys, k, runlen, cursors), offsets


partition.launches = 0
