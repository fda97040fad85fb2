"""Kernel 5, sw_batch: batched local affine-gap Smith-Waterman DP.

Replaces the JAX device program ``rufus_tpu/align/sw_device.py:_sw_batch``
(a jitted ``lax.scan`` over query rows), the O(n*m) loop of read and contig
alignment. Inputs are (B, n) query and (B, m) window base codes, uint8,
0-3 with 255 for N or padding (never a match); outputs are H (B, n+1, m+1)
int32, the best score and the first best cell (i, j) of the row-major H,
all int32, bit-identical to the JAX program for any scoring.

On the H100 the work is bound by bytes: H is 4(n+1)(m+1) bytes a pair and
the host traceback reads all of it. The CUDA kernel (``csrc/sw_batch.cu``)
runs one block a pair, threads over contiguous column chunks, the rows and
F in shared memory, and the horizontal-gap term as a block-wide exclusive
max-scan, two barriers a row.
"""

from __future__ import annotations

import torch

from . import _build

NEG = -(10 ** 6)
_MAX_THREADS = 1024
_SMEM_COLUMNS = 17066  # 12 bytes a column of shared memory, up to 200 KiB


def launch_shape(m: int) -> tuple[int, int]:
    """(threads, chunk) of the kernel for windows of m codes: the fewest
    columns a thread such that at most 1024 threads cover the m+1 columns,
    and the threads rounded up to whole warps."""
    M = m + 1
    chunk = -(-M // _MAX_THREADS)
    warps = -(-M // (32 * chunk))
    return 32 * warps, chunk


def sw_batch_torch(q: torch.Tensor, r: torch.Tensor, match: int,
                   mismatch: int, gap_open: int, gap_ext: int):
    """Plain PyTorch version: the JAX program's row loop, with
    ``torch.cummax`` for the horizontal-gap term. Returns (H, score, bi, bj)
    on q's device."""
    B, n = q.shape
    m = r.shape[1]
    dev = q.device
    qi32 = q.to(torch.int32)
    r32 = r.to(torch.int32)
    r_ok = r32 != 255
    j_idx = torch.arange(m + 1, dtype=torch.int32, device=dev) * gap_ext
    H = torch.zeros((B, n + 1, m + 1), dtype=torch.int32, device=dev)
    prev = H[:, 0]
    F = torch.full((B, m + 1), NEG, dtype=torch.int32, device=dev)
    for i in range(n):
        qi = qi32[:, i : i + 1]
        sub = torch.where((qi == r32) & (qi != 255) & r_ok,
                          match, mismatch).to(torch.int32)
        F = torch.maximum(F - gap_ext, prev - (gap_open + gap_ext))
        cand = torch.clamp_min(torch.maximum(prev[:, :-1] + sub, F[:, 1:]), 0)
        row = H[:, i + 1]
        row[:, 1:] = cand
        s = row + j_idx
        if m:
            pref = torch.cummax(s[:, :-1], dim=1).values
            E = pref - (gap_open + gap_ext) - j_idx[:-1]
            row[:, 1:] = torch.maximum(row[:, 1:], E)
        prev = row
    flat = H.reshape(B, -1)
    best = torch.argmax(flat, dim=1)  # the first maximum
    score = torch.gather(flat, 1, best[:, None])[:, 0]
    bi = (best // (m + 1)).to(torch.int32)
    bj = (best % (m + 1)).to(torch.int32)
    return H, score, bi, bj


def _sw_batch_cuda(q, r, match, mismatch, gap_open, gap_ext):
    B, n = q.shape
    m = r.shape[1]
    dev = q.device
    H = torch.empty((B, n + 1, m + 1), dtype=torch.int32, device=dev)
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    ws = None
    if m + 1 > _SMEM_COLUMNS:
        ws = torch.empty(B * 3 * (m + 1), dtype=torch.int32, device=dev)
    threads, chunk = launch_shape(m)
    fn = _build.function("sw_batch", "rt_sw_batch",
                         [_build.P, _build.P, _build.I64, _build.I32,
                          _build.I32, _build.I32, _build.I32, _build.I32,
                          _build.I32, _build.I32, _build.I32, _build.P,
                          _build.P, _build.P, _build.P, _build.P, _build.P])
    _build.check(fn(
        _build.ptr(q), _build.ptr(r), B, n, m, match, mismatch, gap_open,
        gap_ext, threads, chunk, _build.ptr(H), _build.ptr(out[0]),
        _build.ptr(out[1]), _build.ptr(out[2]),
        _build.ptr(ws) if ws is not None else None,
        _build.stream_ptr(dev)), "sw_batch")
    sw_batch.launches += 1
    return H, out[0], out[1], out[2]


def sw_batch(q: torch.Tensor, r: torch.Tensor, match: int, mismatch: int,
             gap_open: int, gap_ext: int):
    """(B, n) x (B, m) uint8 codes -> (H (B, n+1, m+1), score (B,),
    bi (B,), bj (B,)), all int32, on q's device.

    A CUDA tensor goes through the CUDA kernel; a CPU tensor through
    ``sw_batch_torch``."""
    for name, t in (("q", q), ("r", r)):
        if t.dim() != 2 or t.dtype != torch.uint8:
            raise TypeError(f"{name} must be a 2-D uint8 tensor, got "
                            f"{tuple(t.shape)} {t.dtype}")
    if q.shape[0] != r.shape[0] or q.device != r.device:
        raise ValueError("q and r must hold the same number of pairs on "
                         "one device")
    args = tuple(int(v) for v in (match, mismatch, gap_open, gap_ext))
    if q.device.type == "cpu":
        return sw_batch_torch(q, r, *args)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _sw_batch_cuda(q.contiguous(), r.contiguous(), *args)


sw_batch.launches = 0
