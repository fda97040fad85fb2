"""Minimal BAM reader: BGZF + BAM record decoding, no external deps.

Replaces `samtools view -F 3328 <bam>` generator streams (reference:
runRufus.sh:595-658) without samtools or pysam. The pipeline decodes BAM
with the C++ decoder (``io/native.py``); this pure-Python reader is its
plain version, which the tests hold the decoder to, and the writer of the
BAMs the tests and the synthetic trio make. The stream-progress side
channel lives in ``io/progress.py``.

BAM spec: https://samtools.github.io/hts-specs/SAMv1.pdf section 4.2.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .progress import (STREAM_SENTINEL, stream_complete,  # noqa: F401
                       progress_records as _progress_records)

# 4-bit seq codes -> base (SAMv1 4.2.3)
SEQ_CODES = "=ACMGRSVTWYHKDBN"

# CIGAR op codes (SAMv1 4.2.2): MIDNSHP=X
CIGAR_OPS = "MIDNSHP=X"

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_MATE1 = 0x40
FLAG_MATE2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800
# samtools view -F 3328 == skip secondary|dup|supplementary
DEFAULT_EXCLUDE = FLAG_SECONDARY | FLAG_DUP | FLAG_SUPPLEMENTARY

_COMP = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def revcomp_bytes(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


@dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int  # 0-based
    mapq: int
    cigar: list[tuple[int, str]]  # (length, op)
    seq: str
    qual: str  # ASCII phred+33
    next_ref_id: int = -1
    next_pos: int = -1
    tlen: int = 0

    @property
    def is_reverse(self):
        return bool(self.flag & FLAG_REVERSE)

    def cigar_string(self) -> str:
        if not self.cigar:
            return "*"
        return "".join(f"{n}{op}" for n, op in self.cigar)


def bgzf_decompress(path: str) -> bytes:
    """Decompress a BGZF file (concatenated gzip members)."""
    with open(path, "rb") as f:
        data = f.read()
    # gzip.decompress handles multi-member streams
    return gzip.decompress(data)


def read_bam(path: str):
    """Parse a BAM file -> (references, records iterator materialized).

    references: list of (name, length).
    """
    raw = bgzf_decompress(path)
    if raw[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    off = 4
    (l_text,) = struct.unpack_from("<i", raw, off)
    off += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, off)
        off += 4
        name = raw[off : off + l_name - 1].decode()
        off += l_name
        (l_ref,) = struct.unpack_from("<i", raw, off)
        off += 4
        refs.append((name, l_ref))
    return refs, _parse_records(raw, off)


def _parse_records(raw: bytes, off: int) -> Iterator[BamRecord]:
    n = len(raw)
    while off < n:
        (block_size,) = struct.unpack_from("<i", raw, off)
        off += 4
        end = off + block_size
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         next_ref_id, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", raw, off)
        p = off + 32
        name = raw[p : p + l_read_name - 1].decode()
        p += l_read_name
        cigar = []
        for i in range(n_cigar):
            (c,) = struct.unpack_from("<I", raw, p)
            p += 4
            cigar.append((c >> 4, CIGAR_OPS[c & 0xF]))
        nybbles = raw[p : p + (l_seq + 1) // 2]
        p += (l_seq + 1) // 2
        seq_chars = []
        for i in range(l_seq):
            b = nybbles[i // 2]
            code = (b >> 4) if i % 2 == 0 else (b & 0xF)
            seq_chars.append(SEQ_CODES[code])
        seq = "".join(seq_chars)
        qual_raw = raw[p : p + l_seq]
        p += l_seq
        if l_seq and qual_raw[0] == 0xFF:
            qual = "*"
        else:
            qual = bytes(q + 33 for q in qual_raw).decode("latin1")
        # tags ignored for now (p..end)
        off = end
        yield BamRecord(name, flag, ref_id, pos, mapq, cigar, seq, qual,
                        next_ref_id, next_pos, tlen)


def bam_to_fastq(path: str, exclude_flags: int = DEFAULT_EXCLUDE,
                 progress_path: str | None = None):
    """Unpaired pass-through: BAM -> (name, seq, qual) stream, as-is.

    Matches `samtools view -F 3328 | PassThroughSamCheck` feeding jellyfish
    (reference: RunJellyForRUFUS.sh:28; PassThroughSamCheck.cpp:147-153 —
    no strand fix; canonical counting is orientation-free). progress_path
    writes the chromosome-progress file (<gen>.Jelly.chr role).
    """
    refs, records = read_bam(path)
    if progress_path:
        records = _progress_records(records, refs, progress_path)
    for r in records:
        if r.flag & exclude_flags:
            continue
        yield r.name, r.seq, r.qual


def bam_to_paired_fastq(path: str, exclude_flags: int = DEFAULT_EXCLUDE,
                        progress_path: str | None = None):
    """Stranded pair-matching pass-through: BAM -> (name, m1, q1, m2, q2).

    Matches PassThroughSamCheck.stranded.cpp:192-279: reads are paired by
    name hashmap; flag-0x10 records are reverse-complemented back to
    sequencing orientation; the SECOND record seen for a name becomes
    mate1, the stashed first becomes mate2. progress_path writes the
    <gen>.filter.chr chromosome-progress file (runRufus.sh:966).
    """
    pending: dict[str, tuple[str, str]] = {}
    refs, records = read_bam(path)
    if progress_path:
        records = _progress_records(records, refs, progress_path)
    for r in records:
        if r.flag & exclude_flags:
            continue
        seq, qual = r.seq, r.qual
        if r.flag & FLAG_REVERSE:
            seq = revcomp_bytes(seq.encode()).decode()
            qual = qual[::-1]
        if r.name in pending:
            m2s, m2q = pending.pop(r.name)
            yield r.name, seq, qual, m2s, m2q
        else:
            pending[r.name] = (seq, qual)


def bam_to_single_fastq(path: str, exclude_flags: int = DEFAULT_EXCLUDE,
                        progress_path: str | None = None):
    """Single-end stranded pass-through (PassThroughSamCheck.stranded.se)."""
    refs, records = read_bam(path)
    if progress_path:
        records = _progress_records(records, refs, progress_path)
    for r in records:
        if r.flag & exclude_flags:
            continue
        seq, qual = r.seq, r.qual
        if r.flag & FLAG_REVERSE:
            seq = revcomp_bytes(seq.encode()).decode()
            qual = qual[::-1]
        yield r.name, seq, qual


# ---------------------------------------------------------------------------
# BAM writer + BAI index (the inverse of _parse_records)
# ---------------------------------------------------------------------------
# The reference's user-facing artifacts are coordinate-sorted, indexed BAMs
# (runRufus.sh:1000-1001; Overlap.shorter.sh:209-218 `samtools sort/index`).
# Encoded through the existing BGZF writer (io/bgzf.py); BAI per SAMv1 §5.2.

_SEQ_CODE = {b: i for i, b in enumerate(SEQ_CODES)}
_CIG_CODE = {op: i for i, op in enumerate(CIGAR_OPS)}


def _enc_tags(tags) -> bytes:
    """Encode simple SAM text tags ('NM:i:3', 'AS:i:40', 'SA:Z:...')."""
    out = bytearray()
    for t in tags or ():
        tag, typ, val = t.split(":", 2)
        out += tag.encode()
        if typ == "i":
            out += b"i" + struct.pack("<i", int(val))
        elif typ == "Z":
            out += b"Z" + val.encode() + b"\x00"
        elif typ == "A":
            out += b"A" + val[:1].encode()
        elif typ == "f":
            out += b"f" + struct.pack("<f", float(val))
        else:
            raise ValueError(f"unsupported tag type {typ}")
    return bytes(out)


def encode_record(rec, tags: bytes = b"") -> bytes:
    """One alignment block (without the leading block_size i32).

    rec: BamRecord-like (name, flag, ref_id, pos, mapq, cigar, seq, qual,
    next_ref_id, next_pos, tlen)."""
    from .bgzf import _reg2bin

    name_b = rec.name.encode() + b"\x00"
    cigar = rec.cigar or []
    ref_span = sum(n for n, op in cigar if op in "MDN=X")
    if rec.ref_id >= 0 and rec.pos >= 0:
        rbin = _reg2bin(rec.pos, rec.pos + max(1, ref_span))
    else:
        rbin = 4680  # reg2bin(-1, 0) convention for unplaced reads
    seq = rec.seq if rec.seq != "*" else ""
    l_seq = len(seq)
    body = bytearray()
    body += struct.pack("<iiBBHHHiiii", rec.ref_id, rec.pos, len(name_b),
                        rec.mapq, rbin, len(cigar), rec.flag, l_seq,
                        getattr(rec, "next_ref_id", -1),
                        getattr(rec, "next_pos", -1),
                        getattr(rec, "tlen", 0))
    body += name_b
    for n, op in cigar:
        body += struct.pack("<I", (n << 4) | _CIG_CODE[op])
    nyb = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(seq):
        code = _SEQ_CODE.get(ch.upper(), 15)
        if i % 2 == 0:
            nyb[i // 2] = code << 4
        else:
            nyb[i // 2] |= code
    body += nyb
    if rec.qual == "*" or not rec.qual:
        body += b"\xff" * l_seq
    else:
        body += bytes((ord(q) - 33) & 0xFF for q in rec.qual[:l_seq])
    body += tags
    return bytes(body)


def write_bam(path: str, refs, records, header_text: str | None = None,
              tags_for=None, index: bool = True):
    """Write a BAM (+ .bai when index=True and input is coordinate-sorted).

    refs: list of (name, length). records: iterable of BamRecord-likes in
    coordinate order (mapped first, unplaced ref_id=-1 last). tags_for:
    optional callable rec -> tag bytes (use _enc_tags)."""
    from .bgzf import BgzfWriter, _reg2bin

    if header_text is None:
        header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs)
    w = BgzfWriter(path)
    text = header_text.encode()
    w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
    w.write(struct.pack("<i", len(refs)))
    for n, l in refs:
        nb = n.encode() + b"\x00"
        w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", l))

    # BAI accumulators
    n_ref = len(refs)
    bins = [dict() for _ in range(n_ref)]      # bin -> [[beg, end], ...]
    intv = [dict() for _ in range(n_ref)]      # window -> min voffset
    n_unplaced = 0
    for rec in records:
        tags = tags_for(rec) if tags_for else b""
        block = encode_record(rec, tags)
        v0 = w.tell_virtual()
        w.write(struct.pack("<i", len(block)) + block)
        v1 = w.tell_virtual()
        if rec.ref_id < 0:
            n_unplaced += 1
            continue
        span = sum(n for n, op in (rec.cigar or []) if op in "MDN=X")
        end = rec.pos + max(1, span)
        b = _reg2bin(rec.pos, end)
        chunks = bins[rec.ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == v0:
            chunks[-1][1] = v1  # merge adjacent chunks
        else:
            chunks.append([v0, v1])
        for win in range(rec.pos >> 14, ((end - 1) >> 14) + 1):
            cur = intv[rec.ref_id].get(win)
            if cur is None or v0 < cur:
                intv[rec.ref_id][win] = v0
    w.close()

    if index:
        with open(path + ".bai", "wb") as f:
            f.write(b"BAI\x01" + struct.pack("<i", n_ref))
            for r in range(n_ref):
                f.write(struct.pack("<i", len(bins[r])))
                for b in sorted(bins[r]):
                    ch = bins[r][b]
                    f.write(struct.pack("<Ii", b, len(ch)))
                    for beg, endv in ch:
                        f.write(struct.pack("<QQ", beg, endv))
                if intv[r]:
                    n_intv = max(intv[r]) + 1
                    f.write(struct.pack("<i", n_intv))
                    last = 0
                    for win in range(n_intv):
                        v = intv[r].get(win)
                        if v is not None:
                            last = v
                        f.write(struct.pack("<Q", last))
                else:
                    f.write(struct.pack("<i", 0))
            f.write(struct.pack("<Q", n_unplaced))
    return path
