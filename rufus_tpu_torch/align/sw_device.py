"""Batched Smith-Waterman on the device: the aligner's candidate DPs.

The port of ``rufus_tpu/align/sw_device.py``'s ``sw_batch`` for the
aligner, ``sw_align``: every candidate of a group in one ragged call of
``ops.cuda_sw.sw_ragged`` (the CUDA kernel ``csrc/sw_batch.cu`` on a card,
its plain PyTorch version on the CPU), which runs the DP and the
traceback together. H stays on the device; the per-pair results and ops
cross to the host in one copy. They equal the host ``sw_kernel`` and
``aligner._traceback``, so clip extension, MAPQ and SAM that follow are
unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_sw

_OPS = np.frombuffer(b"MDI", np.uint8)  # cuda_sw.OP_M, OP_D, OP_I


def sw_align(pairs, scoring, device="cuda"):
    """Local alignment of (query codes, window codes) pairs, one launch:
    a list, in the order of `pairs`, of (score, bi, bj, qi, rj, nm, ops),
    the DP's best score and first best cell and ``aligner._traceback``'s
    (qi, rj, ops, nm) from it, ops a list of "M"/"D"/"I" in query order.
    `scoring` is an aligner.Scoring; the traceback's gap search is bounded
    by max(128, 2 * scoring.pad). Pairs run largest (n*m) first."""
    params = (scoring.match, scoring.mismatch, scoring.gap_open,
              scoring.gap_ext)
    B = len(pairs)
    n = np.array([len(q) for q, _ in pairs], np.int64)
    m = np.array([len(r) for _, r in pairs], np.int64)
    order = np.argsort(-(n * m), kind="stable")
    n, m = n[order], m[order]
    codes = np.concatenate(
        [pairs[p][0] for p in order] + [pairs[p][1] for p in order]
        + [np.empty(0, np.uint8)]).astype(np.uint8, copy=False)
    qoff = cuda_sw.offsets(n)
    roff = int(n.sum()) + cuda_sw.offsets(m)
    out = cuda_sw.sw_ragged(torch.from_numpy(codes).to(device), qoff, n,
                            roff, m, *params, max(128, 2 * scoring.pad))
    res, ops = cuda_sw.unpack(out.cpu().numpy(), B)
    ooff = cuda_sw.ops_offsets(n, m)
    results = [None] * B
    for slot, p in enumerate(order):
        score, bi, bj, qi, rj, nm, k = (int(v) for v in res[slot])
        walk = ops[ooff[slot] : ooff[slot] + k][::-1]
        results[p] = (score, bi, bj, qi, rj, nm,
                      list(_OPS[walk].tobytes().decode()))
    return results
