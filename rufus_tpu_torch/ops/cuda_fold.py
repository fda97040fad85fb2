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
runs its grid in order. The CUDA kernels (``csrc/compact.cu``) work in
tiles of 4096 keys that need nothing of each other. Raw keys go through one
pass into a stage of n slots, each tile's unique keys and run sums in the
tile's own place, and after the host's read of the unique count m a gather
moves them to their slots. Keys with counts go through a count pass over
the keys, which gives every tile its first output slot and m, and one main
pass that reads keys and counts once and writes straight to the slots.
Either way the host reads m once, so the tensors returned own exactly m
elements. The sort in front stays ``torch.sort``, as the JAX
package left it to ``lax.sort``.
"""

from __future__ import annotations

import functools

import torch

from . import _build, codec

_TILE = 4096  # elements per tile in csrc/compact.cu
_KIND = {torch.int32: 1, torch.int64: 2}  # raw keys are kind 0 in the source


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


def _scratch_words(n: int) -> int:
    """int64 words the kernels share for n keys: the unique count, then
    per tile its first output slot and its lead, per 32 tiles their first
    slot, and per tile, as int32 padded to 16 bytes, its heads. The raw
    route's stage comes on top: 12 bytes a key, rounded up to whole tiles."""
    nt = -(-n // _TILE)
    words = 2 + 2 * nt + -(-nt // 32)
    return words + (words & 1) + 2 * -(-nt // 4)


@functools.lru_cache(maxsize=None)
def _entry_points():
    """The four C entry points (looked up once: the lookups cost as much
    as a gap between the kernels)."""
    P, I64, I32 = _build.P, _build.I64, _build.I32
    count = _build.function("compact", "rt_compact_count", [P, I64, P, P])
    run = _build.function("compact", "rt_compact_runs",
                          [P, P, I32, I64, P, P, P, P])
    stage = _build.function("compact", "rt_compact_stage",
                            [P, I64, P, P, P, P])
    gather = _build.function("compact", "rt_compact_gather",
                             [P, I64, P, P, P, P, P, P])
    return count, run, stage, gather


@_build.on_card
def _compact_runs_cuda(keys: torch.Tensor, counts: torch.Tensor | None):
    dev = keys.device
    n = keys.numel()
    ptr, check = _build.ptr, _build.check
    scratch = torch.empty(_scratch_words(n), dtype=torch.int64, device=dev)
    count, run, stage, gather = _entry_points()
    stream = _build.stream_ptr(dev)
    if counts is None:
        slots = -(-n // _TILE) * _TILE
        stage_keys = torch.empty(slots, dtype=torch.int64, device=dev)
        stage_sums = torch.empty(slots, dtype=torch.int32, device=dev)
        check(stage(ptr(keys), n, ptr(scratch), ptr(stage_keys),
                    ptr(stage_sums), stream), "compact_runs (stage)")
    else:
        check(count(ptr(keys), n, ptr(scratch), stream),
              "compact_runs (count)")
    m = int(scratch[0].item())  # sizes the output exactly
    out_keys = torch.empty(m, dtype=torch.int64, device=dev)
    out_sums = torch.empty(m, dtype=torch.int64, device=dev)
    if counts is None:
        check(gather(ptr(keys), n, ptr(scratch), ptr(stage_keys),
                     ptr(stage_sums), ptr(out_keys), ptr(out_sums), stream),
              "compact_runs (gather)")
    else:
        check(run(ptr(keys), ptr(counts), _KIND[counts.dtype], n, ptr(scratch),
                  ptr(out_keys), ptr(out_sums), stream), "compact_runs")
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
