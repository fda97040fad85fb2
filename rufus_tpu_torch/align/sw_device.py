"""Batched Smith-Waterman on the device: the aligner's candidate DPs.

The port of ``rufus_tpu/align/sw_device.py``'s ``sw_batch``: the same
numpy-in, numpy-out contract, with the DP run by ``ops.cuda_sw.sw_batch``
(the CUDA kernel ``csrc/sw_batch.cu`` on a card, its plain PyTorch version
on the CPU). H, the best score and the first best cell are bit-identical
to the JAX program and to the host ``aligner.sw_kernel``, so the host
traceback, clip extension and MAPQ that follow are unchanged.

H for a batch is (B, n+1, m+1) int32 and crosses to the host whole, since
the traceback reads it there; callers bound B (``Aligner.align_seqs``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_sw

MATCH, MISMATCH = 1, -4
GAP_OPEN, GAP_EXT = 6, 1


def sw_batch(q_codes: np.ndarray, r_codes: np.ndarray, scoring=None,
             device="cuda"):
    """Batched DP: (B, n) x (B, m) uint8 codes (255 = N/pad) -> (H, score,
    bi, bj) as int32 numpy arrays, run on `device`. (bi, bj) is the first
    maximum of the row-major H: the lexicographically smallest best cell,
    the one the host sw_kernel reports."""
    if scoring is None:
        params = (MATCH, MISMATCH, GAP_OPEN, GAP_EXT)
    else:
        params = (scoring.match, scoring.mismatch, scoring.gap_open,
                  scoring.gap_ext)
    dev = torch.device(device)
    q = torch.from_numpy(np.ascontiguousarray(q_codes, np.uint8)).to(dev)
    r = torch.from_numpy(np.ascontiguousarray(r_codes, np.uint8)).to(dev)
    H, s, bi, bj = cuda_sw.sw_batch(q, r, *params)
    return (H.cpu().numpy(), s.cpu().numpy(), bi.cpu().numpy(),
            bj.cpu().numpy())
