"""FASTQ text I/O and read batches for the device.

``read_fastq``, ``write_fastq`` and ``batch_reads`` are the reference's
per-record helpers. ``fastq_batches`` / ``fastq_pair_batches`` are the
port's feed: they parse whole byte chunks with numpy (newline search and
one gather per field), so no per-read Python object is made, and yield
fixed-size batches of 'N'-padded uint8 rows.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np


def _open(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fastq(path: str):
    """Yield (name, seq, qual); name excludes '@'."""
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            seq = f.readline().rstrip("\n")
            f.readline()
            qual = f.readline().rstrip("\n")
            yield h.rstrip("\n")[1:], seq, qual


def write_fastq(path: str, records):
    with _open(path, "wt") as f:
        for name, seq, qual in records:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")


def batch_reads(seqs, quals=None, pad_to: int | None = None, bucket: int = 32):
    """Pad a list of reads to a (B, L) uint8 batch; pad base 'N', pad qual
    '!'. Returns (reads_u8, quals_u8, lengths_i32)."""
    B = len(seqs)
    maxlen = max((len(s) for s in seqs), default=1)
    L = pad_to or ((maxlen + bucket - 1) // bucket) * bucket
    r = np.full((B, L), ord("N"), np.uint8)
    q = np.full((B, L), ord("!"), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        b = s.encode()[:L]
        r[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
        if quals is not None:
            qb = quals[i].encode()[:L]
            q[i, : len(qb)] = np.frombuffer(qb, np.uint8)
    return r, q, lens


@dataclass
class ReadBatch:
    """B reads as padded rows. `seq`/`qual` are (B, W) uint8 ('N' / '!'
    padded), `lens` (B,) int32 true lengths clamped to W; `names` (B, H)
    uint8 header bytes up to the first space, `name_lens` (B,) int32 (both
    None when names were not asked for)."""

    seq: np.ndarray
    qual: np.ndarray | None
    lens: np.ndarray
    names: np.ndarray | None = None
    name_lens: np.ndarray | None = None

    def __len__(self):
        return len(self.lens)

    def name(self, i: int) -> str:
        return self.names[i, : self.name_lens[i]].tobytes().decode()

    def text(self, i: int) -> tuple[str, str]:
        n = int(self.lens[i])
        return (self.seq[i, :n].tobytes().decode(),
                self.qual[i, :n].tobytes().decode())


def _gather(buf, start, length, width: int, fill: int) -> np.ndarray:
    """Rows buf[start : start + width], bytes past `length` set to `fill`.
    `buf` must extend at least `width` bytes past every start."""
    rows = np.lib.stride_tricks.sliding_window_view(buf, width)[start]
    if (length < width).any():
        np.copyto(rows, np.uint8(fill),
                  where=np.arange(width)[None, :] >= length[:, None])
    return rows


def _parse(buf: np.ndarray, width: int, max_width: int, text: bool):
    """Complete records of a byte chunk -> (ReadBatch, bytes consumed)."""
    nl = np.flatnonzero(buf == 10)
    n = len(nl) // 4
    if n == 0:
        return None, 0
    ends = nl[: 4 * n]
    starts = np.concatenate([[0], ends[:-1] + 1])
    ends = ends - (buf[np.maximum(ends - 1, 0)] == 13)  # CRLF
    starts, ends = starts.reshape(n, 4), ends.reshape(n, 4)
    if (buf[starts[:, 0]] != 64).any() or (buf[starts[:, 2]] != 43).any():
        raise IOError("malformed FASTQ record")
    seq_len = ends[:, 1] - starts[:, 1]
    buf = np.concatenate([buf, np.zeros(max(width, max_width), np.uint8)])
    if not text:
        w = width
    else:
        w = width if seq_len.max() <= width else max(width, max_width)
    lens = np.minimum(seq_len, w).astype(np.int32)
    seq = _gather(buf, starts[:, 1], lens, w, ord("N"))
    qual = names = name_lens = None
    if text:
        qual = _gather(buf, starts[:, 3], lens, w, ord("!"))
        hs = starts[:, 0] + 1
        hl = ends[:, 0] - hs
        hw = max(1, int(hl.max()))
        buf = np.concatenate([buf, np.zeros(hw, np.uint8)])
        head = _gather(buf, hs, hl, hw, 32)
        is_sp = head == 32
        name_lens = np.where(is_sp.any(1), is_sp.argmax(1), hl).astype(np.int32)
        names = head
    return ReadBatch(seq, qual, lens, names, name_lens), int(nl[4 * n - 1]) + 1


def _cat(parts: list[ReadBatch]) -> ReadBatch:
    if len(parts) == 1:
        return parts[0]
    w = max(p.seq.shape[1] for p in parts)

    def widen(a, fill, width):
        if a.shape[1] == width:
            return a
        out = np.full((a.shape[0], width), fill, np.uint8)
        out[:, : a.shape[1]] = a
        return out

    seq = np.concatenate([widen(p.seq, ord("N"), w) for p in parts])
    lens = np.concatenate([p.lens for p in parts])
    if parts[0].qual is None:
        return ReadBatch(seq, None, lens)
    qual = np.concatenate([widen(p.qual, ord("!"), w) for p in parts])
    hw = max(p.names.shape[1] for p in parts)
    names = np.concatenate([widen(p.names, 32, hw) for p in parts])
    name_lens = np.concatenate([p.name_lens for p in parts])
    return ReadBatch(seq, qual, lens, names, name_lens)


def _slice(b: ReadBatch, lo: int, hi: int) -> ReadBatch:
    return ReadBatch(b.seq[lo:hi], None if b.qual is None else b.qual[lo:hi],
                     b.lens[lo:hi],
                     None if b.names is None else b.names[lo:hi],
                     None if b.name_lens is None else b.name_lens[lo:hi])


def fastq_batches(path: str, batch_size: int, width: int, *,
                  text: bool = False, max_width: int | None = None,
                  chunk_bytes: int = 32 << 20):
    """Yield ReadBatch-es of exactly `batch_size` reads (the last may be
    shorter) from a plain or gzip FASTQ.

    text=False (counting): only `seq`, rows `width` wide; longer reads are
    cut at `width`. text=True (filtering): also quals and names; a batch
    whose reads do not all fit `width` is `max_width` wide instead, so
    real reads are not cut below it."""
    max_width = max_width or width
    pending: list[ReadBatch] = []
    have = 0
    tail = np.empty(0, np.uint8)
    with _open(path, "rb") as f:
        while True:
            raw = f.read(chunk_bytes)
            buf = np.concatenate([tail, np.frombuffer(raw, np.uint8)])
            if not raw:
                if len(buf) and buf[-1] != 10:
                    buf = np.concatenate([buf, np.array([10], np.uint8)])
            rb, used = _parse(buf, width, max_width, text)
            tail = buf[used:]
            if rb is not None:
                pending.append(rb)
                have += len(rb)
            while have >= batch_size:
                allb = _cat(pending)
                yield _slice(allb, 0, batch_size)
                rest = _slice(allb, batch_size, have)
                pending, have = ([rest], len(rest)) if len(rest) else ([], 0)
            if not raw:
                break
    if len(tail) and (tail != 10).any():
        raise IOError(f"{path}: truncated FASTQ record at end of file")
    if have:
        yield _cat(pending)


def fastq_pair_batches(path1: str, path2: str, batch_size: int, width: int,
                       max_width: int):
    """Lockstep (mate1, mate2) ReadBatch pairs with quals and names."""
    b2s = fastq_batches(path2, batch_size, width, text=True,
                        max_width=max_width)
    for b1 in fastq_batches(path1, batch_size, width, text=True,
                            max_width=max_width):
        b2 = next(b2s, None)
        if b2 is None or len(b2) != len(b1):
            raise IOError(f"{path1} and {path2} hold different read counts")
        yield b1, b2
    if next(b2s, None) is not None:
        raise IOError(f"{path1} and {path2} hold different read counts")
