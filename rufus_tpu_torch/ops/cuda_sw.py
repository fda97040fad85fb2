"""Kernel 5, sw_batch: batched local affine-gap Smith-Waterman DP with its
traceback.

Replaces the JAX device program ``rufus_tpu/align/sw_device.py:_sw_batch``
(a jitted ``lax.scan`` over query rows), the O(n*m) loop of read and contig
alignment, and the host traceback ``rufus_tpu/align/aligner.py:_traceback``
that walks back through its H. Codes are uint8, 0-3 with 255 for N or
padding (never a match).

- ``sw_ragged`` (the main path): a ragged batch of (query, window) pairs
  packed into one code buffer, one launch; each pair's H stays on the
  card, and what comes back is a few bytes a pair: (score, bi, bj, qi, rj,
  nm, number of ops) and the ops (0 = M, 1 = D, 2 = I) in walk order, equal
  to ``_traceback``'s walk from the first best cell.
- ``sw_batch`` (the tests' view of H): (B, n) x (B, m) -> H (B, n+1, m+1),
  the best score and the first best cell, bit-identical to the JAX program.

The CUDA kernel (``csrc/sw_batch.cu``) runs one warp a pair, each lane on
a contiguous chunk of columns, the horizontal gap as a warp max-scan, and
the traceback in the same warp after the DP; it is bound by integer
operations. Plain PyTorch versions: ``sw_batch_torch``, ``traceback_torch``
and ``sw_ragged_torch``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

NEG = -(10 ** 6)
OUT_FIELDS = 7  # score, bi, bj, qi, rj, nm, number of ops
OP_M, OP_D, OP_I = 0, 1, 2
CHUNKS = (4, 8, 12, 16)  # columns a lane; a tile is 32 of them
_PLAIN_BATCH = 256  # pairs a plain DP call: bounds the plain version's H


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


def traceback_torch(q, r, H, bi, bj, match: int, mismatch: int,
                    gap_open: int, gap_ext: int, gap_max: int):
    """Plain PyTorch version of ``aligner._traceback`` over a batch: one
    step a loop for every live pair (a diagonal step, else the smallest
    horizontal gap, else the smallest vertical one, each search a gather
    over g masked at min(j, gap_max) or min(i, gap_max)). q (B, n), r
    (B, m), H (B, n+1, m+1), bi and bj (B,). Returns (qi, rj, nm, nops)
    int32 (B,) and the ops (B, n+m) uint8 in walk order (the first nops of
    each row)."""
    B, n1, m1 = H.shape
    dev = H.device
    ar = torch.arange(B, device=dev)
    i, j = bi.to(torch.int64), bj.to(torch.int64)
    nm = torch.zeros(B, dtype=torch.int64, device=dev)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    ops = torch.zeros((B, n1 + m1 - 2), dtype=torch.uint8, device=dev)
    pos = torch.arange(n1 + m1 - 2, device=dev)
    gs = torch.arange(1, max(1, min(gap_max, max(n1, m1))) + 1, device=dev)
    q64, r64 = q.to(torch.int64), r.to(torch.int64)

    def live_at(i, j):
        return (i > 0) & (j > 0) & (H[ar, i, j] > 0)

    live = live_at(i, j)
    while bool(live.any()):
        h = H[ar, i, j]
        im1, jm1 = (i - 1).clamp_min(0), (j - 1).clamp_min(0)
        qc, rc = q64[ar, im1], r64[ar, jm1]
        is_mm = ~((qc == rc) & (qc != 255) & (rc != 255))
        sub = torch.where(is_mm, mismatch, match)
        diag = live & (h == H[ar, im1, jm1] + sub)
        pen = gap_open + gap_ext * gs
        vals = H[ar[:, None], i[:, None], (j[:, None] - gs).clamp_min(0)]
        hit = (gs <= torch.clamp(j, max=gap_max)[:, None]) & \
            (h[:, None] == vals - pen)
        horiz = live & ~diag & hit.any(1)
        vals = H[ar[:, None], (i[:, None] - gs).clamp_min(0), j[:, None]]
        hitv = (gs <= torch.clamp(i, max=gap_max)[:, None]) & \
            (h[:, None] == vals - pen)
        vert = live & ~diag & ~horiz & hitv.any(1)
        g = torch.where(diag, 1, torch.where(
            horiz, hit.int().argmax(1) + 1,
            torch.where(vert, hitv.int().argmax(1) + 1, 0)))
        code = torch.where(diag, OP_M, torch.where(horiz, OP_D, OP_I))
        fill = (pos[None] >= k[:, None]) & (pos[None] < (k + g)[:, None])
        ops = torch.where(fill, code[:, None].to(torch.uint8), ops)
        nm += torch.where(diag, is_mm.to(torch.int64), g)
        k += g
        i = i - torch.where(diag | vert, g, 0)
        j = j - torch.where(diag | horiz, g, 0)
        live = (diag | horiz | vert) & live_at(i, j)
    return (i.to(torch.int32), j.to(torch.int32), nm.to(torch.int32),
            k.to(torch.int32), ops)


def offsets(x) -> np.ndarray:
    """The exclusive prefix sum of x, int64: where each of a run of
    packed pieces of lengths x starts."""
    x = np.asarray(x, np.int64)
    out = np.zeros(len(x), np.int64)
    np.cumsum(x[:-1], out=out[1:])
    return out


def ops_offsets(n, m) -> np.ndarray:
    """Each pair's offset into the ops region of ``sw_ragged``'s output:
    n+m bytes a pair, in order."""
    return offsets(np.asarray(n, np.int64) + np.asarray(m, np.int64))


def unpack(out, B: int):
    """(results (B, 7) int32, ops) views of ``sw_ragged``'s output buffer
    (a torch tensor or a numpy array)."""
    if isinstance(out, np.ndarray):
        return out[: 28 * B].view(np.int32).reshape(B, OUT_FIELDS), \
            out[28 * B:]
    return out[: 28 * B].view(torch.int32).view(B, OUT_FIELDS), out[28 * B:]


def _shapes(qoff, n, roff, m):
    arrs = [np.ascontiguousarray(a, np.int64).reshape(-1)
            for a in (qoff, n, roff, m)]
    if len({len(a) for a in arrs}) != 1:
        raise ValueError("qoff, n, roff and m must have one entry a pair")
    if len(arrs[1]) and (arrs[1].min() < 0 or arrs[3].min() < 0):
        raise ValueError("negative length")
    return arrs


def sw_ragged_torch(codes: torch.Tensor, qoff, n, roff, m, match: int,
                    mismatch: int, gap_open: int, gap_ext: int,
                    gap_max: int) -> torch.Tensor:
    """Plain PyTorch version of ``sw_ragged``: pairs in buckets of
    32-rounded shapes padded with 255 (which never matches, so the true
    region of H and its first best cell are exact), at most 256 pairs a
    call of ``sw_batch_torch`` and ``traceback_torch``."""
    qoff, n, roff, m = _shapes(qoff, n, roff, m)
    B = len(n)
    dev = codes.device
    ooff = ops_offsets(n, m)
    out = torch.zeros(28 * B + int((n + m).sum()), dtype=torch.uint8,
                      device=dev)
    res, ops_out = unpack(out, B)
    rnd = lambda x: -(-x // 32) * 32  # noqa: E731
    buckets: dict = {}
    for p in range(B):
        buckets.setdefault((rnd(int(n[p])), rnd(int(m[p]))), []).append(p)
    for (qn, wn), members in buckets.items():
        for b0 in range(0, len(members), _PLAIN_BATCH):
            idx = np.asarray(members[b0:b0 + _PLAIN_BATCH])
            qb = torch.full((len(idx), qn), 255, dtype=torch.uint8, device=dev)
            wb = torch.full((len(idx), wn), 255, dtype=torch.uint8, device=dev)
            for row, p in enumerate(idx):
                qb[row, : n[p]] = codes[qoff[p] : qoff[p] + n[p]]
                wb[row, : m[p]] = codes[roff[p] : roff[p] + m[p]]
            H, s, bi, bj = sw_batch_torch(qb, wb, match, mismatch, gap_open,
                                          gap_ext)
            qi, rj, nm, k, ops = traceback_torch(
                qb, wb, H, bi, bj, match, mismatch, gap_open, gap_ext,
                gap_max)
            t = torch.as_tensor(idx, device=dev)
            res[t] = torch.stack([s, bi, bj, qi, rj, nm, k], 1)
            cols = torch.arange(ops.shape[1], device=dev)
            keep = cols[None] < k[:, None].to(torch.int64)
            dst = torch.as_tensor(ooff[idx], device=dev)[:, None] + cols[None]
            ops_out[dst[keep]] = ops[keep]
    return out


def launch_chunk(max_m: int) -> int:
    """Columns a lane for a launch whose widest window has max_m codes: the
    fewest in CHUNKS whose tile of 32 lanes holds the m+1 columns, else the
    widest (the kernel then sweeps the row in tiles)."""
    for c in CHUNKS:
        if max_m + 1 <= 32 * c:
            return c
    return CHUNKS[-1]


_SMEM_BYTES = 232448  # a block's shared memory on the H100


@_build.on_card
def _sw_ragged_cuda(codes, qoff, n, roff, m, match, mismatch, gap_open,
                    gap_ext, gap_max):
    """One launch of the kernel; returns (out, H workspace)."""
    dev = codes.device
    B = len(n)
    chunk = launch_chunk(int(m.max()) if B else 0)
    S = (m + 4) // 4 * 4  # row stride: m+1 rounded up to 4 columns
    hsz = (n + 1) * S
    multi = m + 1 > 32 * chunk  # pairs that sweep their rows in tiles
    smem_cols = -(-int(S[multi].max()) // 8) * 8 if multi.any() else 0
    if 128 * chunk + 10 * smem_cols > _SMEM_BYTES:
        smem_cols = 0  # the row state goes to the global workspace
    wsz = np.where(multi & (smem_cols == 0), 2 * S, 0)
    meta = np.stack([qoff, roff, n, m, offsets(hsz), offsets(wsz),
                     ops_offsets(n, m)], 1)
    meta = torch.from_numpy(np.ascontiguousarray(meta)).to(dev)
    H = torch.empty(max(1, int(hsz.sum())), dtype=torch.int32, device=dev)
    ws = torch.empty(max(1, int(wsz.sum())), dtype=torch.int32, device=dev)
    out = torch.zeros(28 * B + int((n + m).sum()), dtype=torch.uint8,
                      device=dev)
    res, ops = unpack(out, B)
    fn = _build.function("sw_batch", "rt_sw_ragged",
                         [_build.P, _build.P, _build.I64, _build.I32,
                          _build.I32, _build.I32, _build.I32, _build.I32,
                          _build.I32, _build.I32, _build.P, _build.P,
                          _build.P, _build.P, _build.P])
    _build.check(fn(
        _build.ptr(codes), _build.ptr(meta), B, match, mismatch, gap_open,
        gap_ext, gap_max, chunk, smem_cols, _build.ptr(H), _build.ptr(ws),
        _build.ptr(res), _build.ptr(ops), _build.stream_ptr(dev)),
        "sw_batch")
    return out, H


def _check_scalars(match, mismatch, gap_open, gap_ext):
    return tuple(int(v) for v in (match, mismatch, gap_open, gap_ext))


def sw_ragged(codes: torch.Tensor, qoff, n, roff, m, match: int,
              mismatch: int, gap_open: int, gap_ext: int,
              gap_max: int) -> torch.Tensor:
    """A ragged batch of pairs: pair p is the query
    codes[qoff[p] : qoff[p] + n[p]] against the window
    codes[roff[p] : roff[p] + m[p]] (codes a 1-D uint8 tensor; the
    offsets and lengths host integer arrays). Returns one uint8 tensor on
    codes' device: B rows of (score, bi, bj, qi, rj, nm, number of ops)
    int32, then each pair's ops in walk order at ``ops_offsets(n, m)``
    (``unpack`` splits it). gap_max bounds the traceback's gap search,
    ``max(128, 2 * pad)`` in the aligner.

    A CUDA tensor goes through the CUDA kernel (pairs in the order given:
    the caller sorts them, largest first); a CPU tensor through
    ``sw_ragged_torch``."""
    if codes.dim() != 1 or codes.dtype != torch.uint8:
        raise TypeError(f"codes must be a 1-D uint8 tensor, got "
                        f"{tuple(codes.shape)} {codes.dtype}")
    qoff, n, roff, m = _shapes(qoff, n, roff, m)
    if len(n) and (max((qoff + n).max(), (roff + m).max()) > codes.numel()
                   or min(qoff.min(), roff.min()) < 0):
        raise ValueError("a pair reaches outside codes")
    args = _check_scalars(match, mismatch, gap_open, gap_ext)
    if codes.device.type == "cpu":
        return sw_ragged_torch(codes, qoff, n, roff, m, *args, int(gap_max))
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    out = _sw_ragged_cuda(codes.contiguous(), qoff, n, roff, m, *args,
                          int(gap_max))[0]
    sw_ragged.launches += 1
    return out


sw_ragged.launches = 0


def sw_batch(q: torch.Tensor, r: torch.Tensor, match: int, mismatch: int,
             gap_open: int, gap_ext: int):
    """(B, n) x (B, m) uint8 codes -> (H (B, n+1, m+1), score (B,),
    bi (B,), bj (B,)), all int32, on q's device.

    A CUDA tensor goes through the CUDA kernel (H is a view of its
    workspace, rows padded to 4 columns); a CPU tensor through
    ``sw_batch_torch``."""
    for name, t in (("q", q), ("r", r)):
        if t.dim() != 2 or t.dtype != torch.uint8:
            raise TypeError(f"{name} must be a 2-D uint8 tensor, got "
                            f"{tuple(t.shape)} {t.dtype}")
    if q.shape[0] != r.shape[0] or q.device != r.device:
        raise ValueError("q and r must hold the same number of pairs on "
                         "one device")
    args = _check_scalars(match, mismatch, gap_open, gap_ext)
    if q.device.type == "cpu":
        return sw_batch_torch(q, r, *args)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, n = q.shape
    m = r.shape[1]
    codes = torch.cat([q.reshape(-1), r.reshape(-1)])
    ar = np.arange(B, dtype=np.int64)
    out, H = _sw_ragged_cuda(codes, ar * n, np.full(B, n, np.int64),
                                B * n + ar * m, np.full(B, m, np.int64),
                                *args, 128)
    sw_batch.launches += 1
    S = (m + 4) // 4 * 4
    res = unpack(out, B)[0]
    H = H[: B * (n + 1) * S].view(B, n + 1, S)[:, :, : m + 1]
    return H, res[:, 0], res[:, 1], res[:, 2]


sw_batch.launches = 0
