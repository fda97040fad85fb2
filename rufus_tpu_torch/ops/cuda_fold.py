"""Kernel 2, compact_runs: run-length compaction of a sorted key run.

Replaces the Pallas kernel ``rufus_tpu/ops/pallas_fold.py:compact_sorted_hilo``
together with the run-head detection and prefix-coded run sums of
``rufus_tpu/parallel/sharded.py:_rle_compact_hilo`` that surround it. Input
is a sorted int64 key tensor whose invalid entries are the INT64_MAX
sentinel (they sort last), with optional per-key counts; output is the
unique non-sentinel keys in order and their run sums (int64), sized
exactly.

On the H100 the work is bound by bytes: it reads the keys (and counts) and
writes 16 bytes per unique key. The TPU kernel's in-VMEM bitonic network,
carry row and DMA tricks existed because the TPU has no fast scatter and
runs its grid in order; the CUDA kernel (``csrc/compact.cu``) is a
scan-then-scatter over tiles instead. The sort in front of it stays
``torch.sort``, as the JAX package left it to ``lax.sort``.
"""

from __future__ import annotations

import torch

from . import _build, codec

_TILE = 2048  # elements per block in csrc/compact.cu
_KIND = {None: 0, torch.int32: 1, torch.int64: 2}


def compact_runs_torch(keys: torch.Tensor, counts: torch.Tensor | None = None):
    """Plain PyTorch version: head mask, cumsum, index select."""
    valid = keys != codec.SENTINEL
    head = valid.clone()
    head[1:] &= keys[1:] != keys[:-1]
    c = (torch.ones_like(keys) if counts is None else counts.to(torch.int64))
    c = torch.where(valid, c, torch.zeros_like(c))
    incl = torch.cumsum(c, 0)
    idx = torch.nonzero(head).squeeze(1)
    start = incl[idx] - c[idx]
    total = incl[-1:] if keys.numel() else incl
    nxt = torch.cat([start[1:], total])[: idx.numel()]
    return keys[idx], nxt - start


def _compact_runs_cuda(keys: torch.Tensor, counts: torch.Tensor | None):
    dev = keys.device
    n = keys.numel()
    kind = _KIND[None if counts is None else counts.dtype]
    cptr = _build.P(None) if counts is None else _build.ptr(counts)
    nb = max(1, -(-n // _TILE))
    block_heads = torch.empty(nb, dtype=torch.int64, device=dev)
    block_sums = torch.empty(nb, dtype=torch.int64, device=dev)
    totals = torch.empty(2, dtype=torch.int64, device=dev)
    P, I64, I32 = _build.P, _build.I64, _build.I32
    stream = _build.stream_ptr(dev)
    stats = _build.function("compact", "rt_compact_stats",
                            [P, P, I32, I64, P, P, P, P])
    _build.check(stats(_build.ptr(keys), cptr, kind, n, _build.ptr(block_heads),
                       _build.ptr(block_sums), _build.ptr(totals), stream),
                 "compact_runs (stats)")
    m = int(totals[0].item())  # sizes the output exactly
    out_keys = torch.empty(m, dtype=torch.int64, device=dev)
    out_sums = torch.empty(m, dtype=torch.int64, device=dev)
    pref = torch.empty(m, dtype=torch.int64, device=dev)
    scatter = _build.function("compact", "rt_compact_scatter",
                              [P, P, I32, I64, P, P, P, I64, P, P, P, P])
    _build.check(scatter(_build.ptr(keys), cptr, kind, n,
                         _build.ptr(block_heads), _build.ptr(block_sums),
                         _build.ptr(totals), m, _build.ptr(out_keys),
                         _build.ptr(pref), _build.ptr(out_sums), stream),
                 "compact_runs (scatter)")
    compact_runs.launches += 1
    return out_keys, out_sums


def compact_runs(keys: torch.Tensor, counts: torch.Tensor | None = None):
    """Sorted (n,) int64 keys (+ optional (n,) int32/int64 counts; None
    means each key counts 1) -> (unique keys, run sums int64).

    A CUDA tensor goes through the CUDA kernel; a CPU tensor through
    ``compact_runs_torch``."""
    if keys.dim() != 1 or keys.dtype != torch.int64:
        raise TypeError(f"keys must be a 1-D int64 tensor, got "
                        f"{tuple(keys.shape)} {keys.dtype}")
    if counts is not None:
        if counts.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"counts must be int32 or int64, got {counts.dtype}")
        if counts.shape != keys.shape or counts.device != keys.device:
            raise ValueError("counts must match keys in shape and device")
    if keys.device.type == "cpu":
        return compact_runs_torch(keys, counts)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not keys.is_contiguous() or (counts is not None
                                    and not counts.is_contiguous()):
        raise ValueError("keys and counts must be contiguous")
    return _compact_runs_cuda(keys, counts)


compact_runs.launches = 0
