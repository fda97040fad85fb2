"""merge_runs: the union of two sorted unique (key, count) runs, the counts
of a key in both summed.

Replaces no TPU kernel: the JAX package merges a fold's pending run into its
table by sorting table || pending (``rufus_tpu/parallel/sharded.py``,
``sharded_fold_step``, step 3), and the port did so with a stable
``torch.sort`` (``ops/count.py:merge_sum``, 64 device bytes a key). The
count's fold (``ops/table.py``) merges a sorted unique table with the
sorted unique run of the keys just folded, and two such runs merge in one
linear pass.

On the H100 the work is bound by bytes: 16 bytes a key of each run read,
16 a key of the union written. The CUDA kernels (``csrc/merge.cu``) cut the
merged sequence into tiles of 4096 positions by merge-path co-ranks, never
between the two copies of a shared key, count each tile's union keys, and
after the host's read of the union's size write each tile's union from
shared memory. The outputs own exactly m elements; at the peak the device
holds both runs and the union, at most 32 bytes a key of the runs.
"""

from __future__ import annotations

import functools

import torch

from . import _build

_TILE = 4096  # merged positions a tile in csrc/merge.cu


def merge_runs_torch(a_keys: torch.Tensor, a_counts: torch.Tensor,
                     b_keys: torch.Tensor, b_counts: torch.Tensor):
    """Plain PyTorch version: b's keys found in a add their counts there;
    every other key of each run goes to its index plus its rank in the
    other run's keys."""
    if a_keys.numel():
        idx = torch.searchsorted(a_keys, b_keys)
        hit = a_keys[idx.clamp(max=a_keys.numel() - 1)] == b_keys
    else:
        idx = torch.zeros_like(b_keys)
        hit = torch.zeros_like(b_keys, dtype=torch.bool)
    a_counts = a_counts.index_add(0, idx[hit], b_counts[hit])
    new_k, new_c = b_keys[~hit], b_counts[~hit]
    m = a_keys.numel() + new_k.numel()
    out_k, out_c = a_keys.new_empty(m), a_counts.new_empty(m)
    pa = (torch.arange(a_keys.numel(), device=a_keys.device)
          + torch.searchsorted(new_k, a_keys))
    pb = (torch.arange(new_k.numel(), device=a_keys.device)
          + torch.searchsorted(a_keys, new_k))
    out_k[pa], out_c[pa] = a_keys, a_counts
    out_k[pb], out_c[pb] = new_k, new_c
    return out_k, out_c


def _scratch_words(n: int) -> int:
    """int64 words the kernels share for n merged positions: the union's
    size and a spare word, per tile boundary its two co-ranks, per tile its
    first output slot and, as int32, its key count."""
    nt = -(-n // _TILE)
    return 2 + 2 * (nt + 1) + nt + -(-nt // 2)


@functools.lru_cache(maxsize=None)
def _entry_points():
    P, I64 = _build.P, _build.I64
    count = _build.function("merge", "rt_merge_count", [P, I64, P, I64, P, P])
    write = _build.function("merge", "rt_merge_write",
                            [P, P, I64, P, P, I64, P, P, P, P])
    return count, write


@_build.on_card
def _merge_runs_cuda(a_keys, a_counts, b_keys, b_counts):
    dev = a_keys.device
    na, nb = a_keys.numel(), b_keys.numel()
    ptr, check = _build.ptr, _build.check
    scratch = torch.empty(_scratch_words(na + nb), dtype=torch.int64,
                          device=dev)
    count, write = _entry_points()
    stream = _build.stream_ptr(dev)
    check(count(ptr(a_keys), na, ptr(b_keys), nb, ptr(scratch), stream),
          "merge_runs (count)")
    m = int(scratch[0].item())  # sizes the output exactly
    out_k = torch.empty(m, dtype=torch.int64, device=dev)
    out_c = torch.empty(m, dtype=torch.int64, device=dev)
    check(write(ptr(a_keys), ptr(a_counts), na, ptr(b_keys), ptr(b_counts),
                nb, ptr(scratch), ptr(out_k), ptr(out_c), stream),
          "merge_runs")
    merge_runs.launches += 1
    return out_k, out_c


def merge_runs(a_keys: torch.Tensor, a_counts: torch.Tensor,
               b_keys: torch.Tensor, b_counts: torch.Tensor):
    """Two sorted runs of unique int64 keys (no sentinels), each with its
    int64 counts -> (the union's keys in order, their counts summed).

    CUDA tensors go through the CUDA kernels; CPU tensors through
    ``merge_runs_torch``."""
    ts = (a_keys, a_counts, b_keys, b_counts)
    if any(t.dim() != 1 or t.dtype != torch.int64 for t in ts):
        raise TypeError("merge_runs takes 1-D int64 keys and counts, got "
                        + ", ".join(f"{tuple(t.shape)} {t.dtype}" for t in ts))
    if a_counts.shape != a_keys.shape or b_counts.shape != b_keys.shape:
        raise ValueError("counts must match their keys in shape")
    if any(t.device != a_keys.device for t in ts):
        raise ValueError("the runs must be on one device")
    if a_keys.device.type == "cpu":
        return merge_runs_torch(*ts)
    if a_keys.device.type != "cuda":
        raise ValueError(f"unsupported device {a_keys.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("keys and counts must be contiguous")
    return _merge_runs_cuda(*ts)


merge_runs.launches = 0
