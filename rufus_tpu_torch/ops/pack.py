"""Packed transport: 2-bit base codes plus an N bitmask, and a 1-bit qual plane.

Reads cross to the device as ASCII uint8, 8 bits a base, but carry about
2 bits a base. The JAX package packs them on the host into 2-bit codes
plus a 1-bit invalid (non-ACGT) mask, 3.56x fewer bytes, and quals into
one bit a base of "qual >= min_q" (the filter compares every qual with
min_q and nothing else, RUFUS.Filter.cpp:204-210), and unpacks them on the
device. Unpacking rebuilds a two-level qual plane ('I' pass, '#' fail) that
thresholds exactly as the original at that min_q.

The host half (``pack_reads``, ``pack_qual_ok``) is the JAX package's numpy
code; its outputs are byte-equal to the JAX functions'. The device half is
the ``unpack`` kernel (``ops/cuda_pack.py``, ``csrc/unpack.cu``):
``unpack_reads`` and ``unpack_qual`` are the JAX package's
``unpack_reads_device`` and ``unpack_qual_device``, and ``unpack`` gives
both planes from one launch. ``packed_feed`` is the packed feed of
the JAX package's count (``driver._device_prefetch``): each batch's planes
copied to the card on a side stream one batch ahead, then unpacked.

The port's pipeline keeps its pinned ASCII feed: on the H100 the count is
bound by host decoding, and packing is one more host pass over every byte.
``tools/bench.py`` and ``chip_smoke.py`` measure both feeds.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_pack import FAIL_Q, PASS_Q, unpack  # noqa: F401

# ASCII -> 2-bit code (A=0 C=1 G=2 T=3, either case); anything else sets
# the invalid bit and unpacks as 'N'
_CODE = np.zeros(256, np.uint8)
_VALID = np.zeros(256, bool)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _CODE[_b + 32] = _i
    _VALID[_b] = _VALID[_b + 32] = True


def pack_reads(reads: np.ndarray):
    """(B, L) ASCII uint8 -> (packed (B, ceil(L/4)) uint8, invalid bitmask
    (B, ceil(L/8)) uint8)."""
    B, L = reads.shape
    codes = _CODE[reads]
    bad = ~_VALID[reads]
    Lp = -(-L // 4) * 4
    if Lp != L:
        codes = np.concatenate(
            [codes, np.zeros((B, Lp - L), np.uint8)], axis=1)
    c = codes.reshape(B, Lp // 4, 4)
    packed = (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
              | (c[:, :, 3] << 6))
    nmask = np.packbits(bad, axis=1, bitorder="little")
    return packed, nmask


def pack_qual_ok(quals: np.ndarray, min_q: int):
    """(B, L) ASCII quals -> one bit a base of "qual >= min_q", (B,
    ceil(L/8)) uint8 (the threshold applied on the host)."""
    ok = quals >= np.uint8(33 + min_q)
    return np.packbits(ok, axis=1, bitorder="little")


def unpack_reads(packed: torch.Tensor, nmask: torch.Tensor,
                 L: int) -> torch.Tensor:
    """The inverse of pack_reads on the tensors' device -> (B, L) uint8
    ASCII, 'N' at invalid bases (lowercase comes back uppercase)."""
    return unpack(packed, nmask, None, L)[0]


def unpack_qual(okmask: torch.Tensor, L: int) -> torch.Tensor:
    """The qual plane on the tensor's device: 'I' where the host threshold
    passed, '#' where it failed."""
    return unpack(None, None, okmask, L)[1]


def pack_batch(reads: np.ndarray, quals: np.ndarray | None = None,
               min_q: int | None = None, pin: bool = False):
    """A host batch -> (L, [packed, nmask] + [okmask] when min_q is given)
    as host tensors, pinned with `pin` (the form ``packed_feed`` takes)."""
    planes = list(pack_reads(reads))
    if min_q is not None:
        planes.append(pack_qual_ok(quals, min_q))
    ts = [torch.from_numpy(np.ascontiguousarray(p)) for p in planes]
    return reads.shape[1], [t.pin_memory() if pin else t for t in ts]


def packed_feed(host_batches, device):
    """(L, planes) host batches (``pack_batch``'s form) -> (reads, quals or
    None) on `device`. On a card each batch's planes are copied on a side
    stream one batch ahead of the batch being unpacked, so the copy hides
    under the caller's work on the batch before it."""
    device = torch.device(device)
    if device.type != "cuda":
        for L, planes in host_batches:
            yield unpack(*(planes + [None] * (3 - len(planes))), L)
        return
    side = torch.cuda.Stream(device)

    def upload(item):
        L, planes = item
        with torch.cuda.stream(side):
            dev = [t.to(device, non_blocking=True) for t in planes]
            done = torch.cuda.Event()
            done.record(side)
        return L, dev, done

    def unpacked(item):
        L, dev, done = item
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        for t in dev:  # allocated on the side stream, read on this one
            t.record_stream(cur)
        return unpack(*(dev + [None] * (3 - len(dev))), L)

    ahead = None
    for item in host_batches:
        cur, ahead = ahead, upload(item)
        if cur is not None:
            yield unpacked(cur)
    if ahead is not None:
        yield unpacked(ahead)
