"""The plain reference of the trio front end, in plain PyTorch on any
device: canonical k-mer counting (jellyfish ``count -C -L``), its
histogram (``jellyfish histo``), the subtract (RUFUS's modified ``merge``
fused with the HashList's count range) and the pair filter
(``RUFUS.Filter``), worked out from the generator's reads alone.

It imports nothing of the program. Keys are 2-bit packed, MSB first, with
A0 C1 G2 T3, so numeric order is lexicographic order, and a canonical key
is the smaller of a window's key and its reverse complement's.

Every function takes `ident`, the identity of a key (None: the key
itself). The control passes a 32-bit fingerprint there: the k-mer
analogue of a lower precision, under which distinct k-mers can merge.
"""

from __future__ import annotations

import numpy as np
import torch

HISTO_ROWS = 10002  # jellyfish histo: rows 0..10001, the last holds the tail
ROWS = 1 << 16  # reads a block

_CODE = torch.full((256,), -1, dtype=torch.int64)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


def window_keys(seq: torch.Tensor, k: int):
    """(n, L) uint8 ASCII reads -> (canonical keys, valid), each
    (n, L-k+1); a window is valid when all its bases are A, C, G or T."""
    codes = _CODE.to(seq.device)[seq.long()]
    bad = codes < 0
    codes = codes.clamp(min=0)
    W = seq.shape[1] - k + 1
    fwd = torch.zeros(seq.shape[0], W, dtype=torch.int64, device=seq.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[:, j:j + W]
        fwd = fwd * 4 + c
        rc = rc + (3 - c) * (4 ** j)
    nbad = torch.cumsum(torch.nn.functional.pad(bad.to(torch.int32), (1, 0)),
                        dim=1)
    valid = (nbad[:, k:] - nbad[:, :W]) == 0
    return torch.minimum(fwd, rc), valid


def _fold(keys: torch.Tensor, counts: torch.Tensor):
    """Sorted unique keys and their summed counts."""
    u, inv = torch.unique(keys, sorted=True, return_inverse=True)
    return u, torch.zeros_like(u).index_add_(0, inv, counts)


def _group(keys, counts, ident):
    """Merge keys of one identity: the smallest key stands for its group,
    with the group's summed count (sorted by key)."""
    if ident is None:
        return keys, counts
    fp = ident(keys)
    u, inv = torch.unique(fp, return_inverse=True)
    rep = torch.full_like(u, torch.iinfo(torch.int64).max)
    rep.scatter_reduce_(0, inv, keys, reduce="amin")
    tot = torch.zeros_like(u).index_add_(0, inv, counts)
    order = torch.argsort(rep)
    return rep[order], tot[order]


def count_table(reads: list, k: int, lower: int, ident=None):
    """Every canonical k-mer of every read in `reads` (a list of (n, L)
    uint8 tensors) with its count, k-mers counted fewer than `lower` times
    dropped. -> (sorted int64 keys, int64 counts)."""
    keys, counts = [], []
    for r in reads:
        for lo in range(0, r.shape[0], ROWS):
            canon, valid = window_keys(r[lo:lo + ROWS], k)
            u, c = torch.unique(canon[valid], sorted=True, return_counts=True)
            keys.append(u)
            counts.append(c.to(torch.int64))
            if len(keys) >= 8:
                u, c = _fold(torch.cat(keys), torch.cat(counts))
                keys, counts = [u], [c]
    u, c = _fold(torch.cat(keys), torch.cat(counts))
    u, c = _group(u, c, ident)
    keep = c >= lower
    return u[keep], c[keep]


def histo(counts: torch.Tensor) -> np.ndarray:
    """Row i: the k-mers counted i times; the last row holds the tail."""
    c = counts.clamp(max=HISTO_ROWS - 1).cpu().numpy()
    return np.bincount(c, minlength=HISTO_ROWS).astype(np.int64)


def _member(keys: torch.Tensor, table: torch.Tensor, ident) -> torch.Tensor:
    if table.numel() == 0:
        return torch.zeros_like(keys, dtype=torch.bool)
    if ident is not None:
        keys, table = ident(keys), torch.sort(ident(table)).values
    return torch.isin(keys, table)


def hashlist(subject, controls: list, merge_min: int, min_cov: int,
             max_depth: int, ident=None):
    """The subject's k-mers found in no control table, with a subject count
    of at least merge_min and min_cov and at most max_depth. Tables are
    (keys, counts) as count_table gives them. -> (keys, counts)."""
    sk, sc = subject
    keep = (sc >= max(merge_min, min_cov)) & (sc <= max_depth)
    for ck, _ in controls:
        keep &= ~_member(sk, ck, ident)
    return sk[keep], sc[keep]


def hits(seq: torch.Tensor, qual: torch.Tensor, hl_keys: torch.Tensor,
         k: int, min_q: int, ident=None) -> torch.Tensor:
    """Each read's windows found in the HashList. A window counts when its
    k bases are all A, C, G or T with base quality >= min_q, and it ends
    before the read's last base (RUFUS.Filter scans positions 0..n-2).
    Reads are unpadded: every row is a whole read."""
    out = []
    for lo in range(0, seq.shape[0], ROWS):
        s, q = seq[lo:lo + ROWS], qual[lo:lo + ROWS]
        canon, valid = window_keys(s, k)
        good = (q.to(torch.int32) - 33 >= min_q)
        ngood = torch.cumsum(torch.nn.functional.pad(
            (~good).to(torch.int32), (1, 0)), dim=1)
        W = canon.shape[1]
        valid &= (ngood[:, k:] - ngood[:, :W]) == 0
        valid[:, W - 1] = False  # the window ending at the last base
        out.append((valid & _member(canon, hl_keys, ident)).sum(dim=1))
    return torch.cat(out)


def filter_pairs(seq1, qual1, seq2, qual2, hl_keys, k: int, min_q: int,
                 threshold: int, ident=None) -> torch.Tensor:
    """Mask of the pairs either of whose mates has at least `threshold`
    HashList windows."""
    return ((hits(seq1, qual1, hl_keys, k, min_q, ident) >= threshold)
            | (hits(seq2, qual2, hl_keys, k, min_q, ident) >= threshold))


def fingerprint(keys: torch.Tensor) -> torch.Tensor:
    """A 32-bit multiplicative hash of int64 keys: the control's identity."""
    return ((keys * -7046029254386353131) >> 32) & 0xFFFFFFFF


def key_strings(keys: torch.Tensor, k: int) -> list:
    """Packed keys -> k-mer strings."""
    a = keys.cpu().numpy().astype(np.int64)
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.int64)
    codes = (a[:, None] >> shifts[None, :]) & 3
    chars = np.frombuffer(b"ACGT", np.uint8)[codes]
    return [row.tobytes().decode() for row in chars]
