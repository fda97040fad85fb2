"""Kernel 1, encode_canon: ASCII read batch -> canonical int64 k-mer keys.

Replaces the Pallas kernel ``rufus_tpu/ops/pallas_count.py:encode_canon_hilo``
(fused base encode + k-mer pack + canonicalize, emitting (hi, lo) u32
planes). Here the output is one flat-ready (B, W) int64 tensor with the
INT64_MAX sentinel on windows that hold any non-ACGT base, which is what
``torch.sort`` takes next on the count path.

On the H100 the work is bound by bytes: it reads B*L bytes and writes
8*B*W. The CUDA kernel (``csrc/encode_canon.cu``) packs a block's reads
into 2-bit codes in shared memory (forward and reverse-complement copies
and a bad-base mask), cuts each window's two keys out of them as bit
fields, so a window costs a fixed few operations whatever k is, and
writes the block's contiguous output span with 16-byte stores.
"""

from __future__ import annotations

import torch

from . import _build, codec

_STAGE_BASES = 16384  # bases a block packs into shared memory, at most


def encode_canon_torch(reads: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: (B, L) uint8 -> (B, L-k+1) int64 keys."""
    codes = codec.encode_bases(reads)
    kmers, valid = codec.pack_kmers(codes, k)
    canon = codec.canonical_kmers(kmers, k)
    return torch.where(valid, canon, torch.full_like(canon, codec.SENTINEL))


@_build.on_card
def _encode_canon_cuda(reads: torch.Tensor, k: int) -> torch.Tensor:
    B, L = reads.shape
    rows = max(1, min(64, _STAGE_BASES // L))
    out = torch.empty((B, L - k + 1), dtype=torch.int64, device=reads.device)
    fn = _build.function("encode_canon", "rt_encode_canon",
                         [_build.P, _build.I64, _build.I32, _build.I32,
                          _build.I32, _build.P, _build.P])
    _build.check(fn(
        _build.ptr(reads), B, L, k, rows, _build.ptr(out),
        _build.stream_ptr(reads.device)), "encode_canon")
    encode_canon.launches += 1
    return out


def encode_canon(reads: torch.Tensor, k: int) -> torch.Tensor:
    """(B, L) uint8 ASCII reads -> (B, W) int64 canonical keys, W = L-k+1.

    A CUDA tensor goes through the CUDA kernel; a CPU tensor through
    ``encode_canon_torch``."""
    codec.check_k(k)
    if reads.dim() != 2 or reads.dtype != torch.uint8:
        raise TypeError(f"reads must be a (B, L) uint8 tensor, got "
                        f"{tuple(reads.shape)} {reads.dtype}")
    if reads.shape[1] < k:
        raise ValueError(f"read width {reads.shape[1]} < k={k}")
    if reads.device.type == "cpu":
        return encode_canon_torch(reads, k)
    if reads.device.type != "cuda":
        raise ValueError(f"unsupported device {reads.device}")
    if not reads.is_contiguous():
        raise ValueError("reads must be contiguous")
    return _encode_canon_cuda(reads, k)


encode_canon.launches = 0
