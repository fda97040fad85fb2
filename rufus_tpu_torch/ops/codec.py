"""2-bit k-mer codec on int64 tensors, plus the host text round trip.

Same packing as the reference codec (MSB-first, A0 C1 G2 T3, so numeric
order on the packed key is lexicographic order on the string), held in
int64 instead of uint64: for k <= 31 a key uses at most 62 bits, so it is
never negative, and INT64_MAX is free to mark an invalid window. PyTorch
has no shifts on unsigned 64-bit tensors, which is why the port does not
keep the reference's uint64 layout on the device.

The tensor functions are plain PyTorch and run on any device; the fused
CUDA kernel that replaces them on the count path is ``ops/cuda_count.py``.
"""

from __future__ import annotations

import numpy as np
import torch

# Base codes. 255 marks invalid (N or any non-ACGT byte).
BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3
INVALID = 255

# Invalid-window sentinel: sorts after every valid key (k <= 31).
SENTINEL = torch.iinfo(torch.int64).max
MAX_K = 31

_LUT = np.full(256, INVALID, dtype=np.uint8)
for _b, _c in zip(b"ACGT", (BASE_A, BASE_C, BASE_G, BASE_T)):
    _LUT[_b] = _c
for _b, _c in zip(b"acgt", (BASE_A, BASE_C, BASE_G, BASE_T)):
    _LUT[_b] = _c

_CODE2CHAR = np.array([ord("A"), ord("C"), ord("G"), ord("T")], dtype=np.uint8)


def check_k(k: int) -> int:
    """Reject k the int64 layout cannot hold (k = 32 would need bit 63)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} is out of range: the port supports "
                         f"1 <= k <= {MAX_K}")
    return k


def encode_bases(ascii_bytes: torch.Tensor) -> torch.Tensor:
    """ASCII uint8 tensor -> uint8 2-bit codes, INVALID for non-ACGT.

    (c >> 1) & 3 maps A->0 C->1 G->3 T->2; flipping the low bit of codes
    >= 2 restores lexicographic order A0 C1 G2 T3. Lowercase is accepted.
    """
    u = ascii_bytes & 0xDF  # uppercase
    code = (u >> 1) & 3
    code = torch.where(code >= 2, code ^ 1, code)
    valid = (u == 65) | (u == 67) | (u == 71) | (u == 84)
    return torch.where(valid, code, torch.full_like(code, INVALID))


def pack_kmers(codes: torch.Tensor, k: int):
    """All k-windows of a (..., L) code tensor, packed MSB-first.

    Returns (kmers int64 (..., W), valid bool (..., W)), W = L - k + 1;
    valid is False where any base of the window was INVALID.
    """
    check_k(k)
    L = codes.shape[-1]
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"sequence length {L} < k={k}")
    c64 = codes.to(torch.int64)
    bad = codes == INVALID
    c64 = torch.where(bad, torch.zeros_like(c64), c64)
    acc = torch.zeros(codes.shape[:-1] + (W,), dtype=torch.int64,
                      device=codes.device)
    anybad = torch.zeros(acc.shape, dtype=torch.bool, device=codes.device)
    for j in range(k):
        acc = (acc << 2) | c64[..., j : j + W]
        anybad = anybad | bad[..., j : j + W]
    return acc, ~anybad


def revcomp_kmers(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse-complement packed int64 k-mers: the j-th base from the
    right becomes the j-th from the left, complemented (code -> 3 - code)."""
    check_k(k)
    out = torch.zeros_like(kmers)
    for j in range(k):
        c = (kmers >> (2 * j)) & 3
        out = (out << 2) | (3 - c)
    return out


def canonical_kmers(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical form min(fwd, revcomp): jellyfish `count -C` semantics."""
    return torch.minimum(kmers, revcomp_kmers(kmers, k))


# ---------------------------------------------------------------------------
# Host-side text round trip (numpy uint64, the reference's host layout).
# ---------------------------------------------------------------------------


# The reference's host sentinel (all ones, uint64). Device keys never use it.
SENTINEL_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_I64_MAX = np.int64(SENTINEL)


def keys_u64_to_i64(keys_u64: np.ndarray) -> np.ndarray:
    """uint64 keys (all-ones sentinel) -> int64 keys (INT64_MAX sentinel)."""
    keys = np.asarray(keys_u64, dtype=np.uint64)
    sent = keys == SENTINEL_U64
    if (keys[~sent] >= np.uint64(1 << 62)).any():
        raise ValueError("key above 2**62: not a k <= 31 k-mer")
    return np.where(sent, _I64_MAX, keys.view(np.int64))


def keys_i64_to_u64(keys_i64: np.ndarray) -> np.ndarray:
    """int64 keys (INT64_MAX sentinel) -> uint64 keys (all-ones sentinel)."""
    keys = np.asarray(keys_i64, dtype=np.int64)
    return np.where(keys == _I64_MAX, SENTINEL_U64, keys.view(np.uint64))


def str_to_kmer(s: str) -> int:
    v = 0
    for ch in s:
        c = _LUT[ord(ch)]
        if c == INVALID:
            raise ValueError(f"invalid base {ch!r} in k-mer {s!r}")
        v = (v << 2) | int(c)
    return v


def kmer_to_str(v: int, k: int) -> str:
    out = []
    for i in range(k - 1, -1, -1):
        out.append("ACGT"[(v >> (2 * i)) & 3])
    return "".join(out)


def strs_to_kmers(seqs, k: int) -> np.ndarray:
    """Vectorized parse of equal-length k-mer strings -> uint64 array."""
    buf = np.frombuffer("".join(seqs).encode(), dtype=np.uint8).reshape(-1, k)
    codes = _LUT[buf].astype(np.uint64)
    if (codes == INVALID).any():
        raise ValueError("invalid base in k-mer list")
    shifts = np.arange(k - 1, -1, -1, dtype=np.uint64) * np.uint64(2)
    return (codes << shifts).sum(axis=1, dtype=np.uint64)


def kmers_to_strs(kmers: np.ndarray, k: int) -> list[str]:
    kmers = np.asarray(kmers, dtype=np.uint64)
    shifts = np.arange(k - 1, -1, -1, dtype=np.uint64) * np.uint64(2)
    codes = (kmers[:, None] >> shifts) & np.uint64(3)
    chars = _CODE2CHAR[codes.astype(np.int64)]
    flat = chars.tobytes().decode()
    return [flat[i * k : (i + 1) * k] for i in range(len(kmers))]


def revcomp_str(s: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
            "a": "t", "c": "g", "g": "c", "t": "a", "n": "n"}
    return "".join(comp.get(c, "N") for c in reversed(s))


def canonical_str(s: str) -> str:
    r = revcomp_str(s)
    return s if s <= r else r
