"""CRAM 3.0 reader/writer (spec subset) — the third input modality.

The reference accepts BAM/CRAM/FASTQ interchangeably because its
generators are `samtools view` one-liners (runRufus.sh:218-240); this
module gives the pipeline the same reach without htslib. Implemented
from the CRAM 3.0 specification (no CRAM tooling exists in this
environment, so fixtures come from the writer below; the format
structures — itf8/ltf8 varints, container/block framing with CRC32,
compression-header maps, slice headers, feature-coded sequence
reconstruction against the reference — follow the spec so
htslib-written files using the same core subset decode too).

Subset supported by the READER:
* containers with raw (0), gzip (1), bzip2 (2) or rANS-4x8 (4) blocks —
  method 4 being htslib's CRAM 3.0 default (io/rans.py);
* encodings: EXTERNAL(1), HUFFMAN(3) in its common degenerate
  zero-bit single-symbol form, BYTE_ARRAY_STOP(5), BYTE_ARRAY_LEN(4)
  with nested EXTERNAL lengths/values;
* data series BF CF RI RL AP RG RN MF NS NP TS NF TL FN FC FP BS IN SC
  DL BA QS MQ (the set needed for name/flag/seq/qual recovery);
* mapped-read sequences rebuilt from the reference + substitution
  matrix/features; unmapped reads from the BA series.

The WRITER emits single-slice containers, all-EXTERNAL encodings and
explicit preservation/substitution maps — well-formed CRAM 3.0 that any
spec reader handles. Round-trip plus BAM-parity tests: tests/test_cram.py.
"""

from __future__ import annotations

import io
import struct
import zlib
from dataclasses import dataclass

import numpy as np

CRAM_MAGIC = b"CRAM\x03\x00"

# block content types
CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4

# encoding codec ids
E_EXTERNAL = 1
E_HUFFMAN = 3
E_BYTE_ARRAY_LEN = 4
E_BYTE_ARRAY_STOP = 5

_SUB_BASES = "ACGTN"


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def read_itf8(buf: io.BytesIO) -> int:
    b0 = buf.read(1)[0]
    if b0 < 0x80:
        return b0
    if b0 < 0xC0:
        return ((b0 & 0x7F) << 8) | buf.read(1)[0]
    if b0 < 0xE0:
        b = buf.read(2)
        return ((b0 & 0x3F) << 16) | (b[0] << 8) | b[1]
    if b0 < 0xF0:
        b = buf.read(3)
        return ((b0 & 0x1F) << 24) | (b[0] << 16) | (b[1] << 8) | b[2]
    b = buf.read(4)
    return (((b0 & 0x0F) << 28) | (b[0] << 20) | (b[1] << 12)
            | (b[2] << 4) | (b[3] & 0x0F))


def write_ltf8(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    n = v.bit_length()
    for i, bits in enumerate((14, 21, 28, 35, 42, 49, 56)):
        if n <= bits:
            nb = i + 2
            lead = (0xFF << (9 - nb)) & 0xFF
            body = v.to_bytes(nb, "big")
            return bytes([lead | body[0]]) + body[1:]
    return b"\xFF" + v.to_bytes(8, "big")


def read_ltf8(buf: io.BytesIO) -> int:
    b0 = buf.read(1)[0]
    if b0 < 0x80:
        return b0
    n = 0
    while b0 & (0x80 >> n):
        n += 1
        if n == 8:
            break
    if n == 8:
        return int.from_bytes(buf.read(8), "big")
    rest = buf.read(n)
    lead = b0 & (0xFF >> (n + 1))
    return int.from_bytes(bytes([lead]) + rest, "big")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _write_block(out, content_type: int, content_id: int, data: bytes,
                 gz: bool = False, method: int | None = None):
    raw_size = len(data)
    if method is None:
        method = 1 if gz else 0
    if method == 1:
        data = zlib.compress(data, 6)
    elif method == 3:
        import lzma

        data = lzma.compress(data)
    elif method != 0:
        raise ValueError(f"unsupported write method {method}")
    body = (bytes([method]) + write_itf8(content_type)
            + write_itf8(content_id) + write_itf8(len(data))
            + write_itf8(raw_size) + data)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    out.write(body + struct.pack("<I", crc))


def _read_block(buf: io.BytesIO):
    start = buf.tell()
    method = buf.read(1)[0]
    ctype = read_itf8(buf)
    cid = read_itf8(buf)
    comp_size = read_itf8(buf)
    raw_size = read_itf8(buf)
    data = buf.read(comp_size)
    end = buf.tell()
    buf.seek(start)
    body = buf.read(end - start)
    (crc,) = struct.unpack("<I", buf.read(4))
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ValueError("CRAM block CRC mismatch")
    if method == 1:
        data = zlib.decompress(data)
    elif method == 2:  # bzip2
        import bz2

        data = bz2.decompress(data)
    elif method == 3:  # lzma (htslib --output-fmt-option use_lzma)
        import lzma

        data = lzma.decompress(data)
    elif method == 4:  # rANS 4x8, htslib's CRAM 3.0 default
        from . import rans

        data = rans.uncompress(data)
    elif method != 0:
        raise NotImplementedError(f"CRAM compression method {method}")
    if len(data) != raw_size:
        raise ValueError("CRAM block size mismatch")
    return ctype, cid, data


# ---------------------------------------------------------------------------
# encodings (reader side)
# ---------------------------------------------------------------------------


def _parse_encoding(buf: io.BytesIO):
    codec = read_itf8(buf)
    n = read_itf8(buf)
    params = buf.read(n)
    return codec, params


class _CoreBits:
    """MSB-first bit cursor over a slice's core block. CRAM core-encoded
    series interleave per record in ONE bitstream (spec 8.3), so every
    decoder of a slice shares a single _CoreBits instance."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read_bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1


class _Decoder:
    """One data series' decoder bound to its blocks."""

    def __init__(self, codec, params, ext_blocks, core):
        self.codec = codec
        self.core = core
        p = io.BytesIO(params)
        if codec == E_EXTERNAL:
            # a series may have no block when the slice never used it
            self.buf = io.BytesIO(ext_blocks.get(read_itf8(p), b""))
        elif codec == E_HUFFMAN:
            nsym = read_itf8(p)
            self.symbols = [read_itf8(p) for _ in range(nsym)]
            nlen = read_itf8(p)
            self.lengths = [read_itf8(p) for _ in range(nlen)]
            if any(l != 0 for l in self.lengths):
                # general canonical Huffman (spec 13.4 / htslib
                # cram_codecs.c): symbols sorted by (code length, symbol
                # value); codes assigned incrementally, left-shifted at
                # each length increase. Decode walks the shared core
                # bitstream one bit at a time against per-length
                # first-code windows.
                order = sorted(range(nsym),
                               key=lambda i: (self.lengths[i],
                                              self.symbols[i]))
                self._sym_sorted = [self.symbols[i] for i in order]
                self._first_code = {}   # length -> first canonical code
                self._offset = {}       # length -> index into _sym_sorted
                self._count = {}
                code, prev_len = 0, self.lengths[order[0]]
                for rank, i in enumerate(order):
                    ln = self.lengths[i]
                    code <<= (ln - prev_len)
                    prev_len = ln
                    if ln not in self._first_code:
                        self._first_code[ln] = code
                        self._offset[ln] = rank
                        self._count[ln] = 0
                    self._count[ln] += 1
                    code += 1
                self._max_len = max(self.lengths)
        elif codec == E_BYTE_ARRAY_STOP:
            self.stop = p.read(1)[0]
            self.buf = io.BytesIO(ext_blocks.get(read_itf8(p), b""))
        elif codec == E_BYTE_ARRAY_LEN:
            lc, lp = _parse_encoding(p)
            vc, vp = _parse_encoding(p)
            self.len_dec = _Decoder(lc, lp, ext_blocks, core)
            self.val_dec = _Decoder(vc, vp, ext_blocks, core)
        else:
            raise NotImplementedError(f"CRAM encoding codec {codec}")

    def _read_huffman(self) -> int:
        if not any(self.lengths):
            return self.symbols[0]  # zero-bit degenerate form
        bits = self.core
        code, ln = 0, 0
        while ln < self._max_len:
            code = (code << 1) | bits.read_bit()
            ln += 1
            first = self._first_code.get(ln)
            if first is not None and 0 <= code - first < self._count[ln]:
                return self._sym_sorted[self._offset[ln] + code - first]
        raise ValueError("corrupt HUFFMAN core stream")

    def read_int(self) -> int:
        if self.codec == E_EXTERNAL:
            return read_itf8(self.buf)
        if self.codec == E_HUFFMAN:
            return self._read_huffman()
        raise NotImplementedError

    def read_byte(self) -> int:
        if self.codec == E_EXTERNAL:
            return self.buf.read(1)[0]
        if self.codec == E_HUFFMAN:
            return self._read_huffman()
        raise NotImplementedError

    def read_bytes(self, n: int | None = None) -> bytes:
        if self.codec == E_BYTE_ARRAY_STOP:
            out = bytearray()
            while True:
                b = self.buf.read(1)
                if not b or b[0] == self.stop:
                    break
                out.append(b[0])
            return bytes(out)
        if self.codec == E_BYTE_ARRAY_LEN:
            ln = self.len_dec.read_int()
            return bytes(self.val_dec.read_byte() for _ in range(ln))
        if self.codec == E_EXTERNAL:
            return self.buf.read(n)
        raise NotImplementedError


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


@dataclass
class CramRecord:
    name: str
    flag: int
    ref_id: int
    pos: int  # 1-based leftmost, 0 when unmapped/unplaced
    mapq: int
    seq: str
    qual: str


def _s32(v: int) -> int:
    """itf8 values are unsigned on the wire; ref ids are signed i32."""
    return v - (1 << 32) if v >= (1 << 31) else v


def _read_container_header(f):
    hdr = f.read(4)
    if len(hdr) < 4:
        return None
    (length,) = struct.unpack("<i", hdr)
    pos0 = f.tell()
    rest = io.BytesIO(f.read(1024))  # may be short near EOF
    ref_id = _s32(read_itf8(rest))
    start = read_itf8(rest)
    span = read_itf8(rest)
    n_rec = read_itf8(rest)
    counter = read_ltf8(rest)
    bases = read_ltf8(rest)
    n_blocks = read_itf8(rest)
    n_land = read_itf8(rest)
    for _ in range(n_land):
        read_itf8(rest)
    rest.read(4)  # container CRC
    f.seek(pos0 + rest.tell())  # absolute: a relative seek against the
    # requested (not actual) read size breaks on short reads near EOF
    return dict(length=length, ref_id=ref_id, start=start, span=span,
                n_rec=n_rec, counter=counter, bases=bases, n_blocks=n_blocks)


def read_cram(path: str, contigs: dict[str, np.ndarray]):
    """Yield (ref_names, iterator of CramRecord) like bam.read_bam."""
    f = open(path, "rb")
    magic = f.read(6)
    if magic != CRAM_MAGIC:
        raise ValueError(f"{path}: not a CRAM 3.0 file")
    f.read(20)  # file id
    hdr = _read_container_header(f)
    payload = io.BytesIO(f.read(hdr["length"]))
    ctype, _, sam_header = _read_block(payload)
    # the SAM header block is prefixed with its i32 length (spec 8.1)
    if len(sam_header) >= 4:
        (hl,) = struct.unpack("<i", sam_header[:4])
        if 0 <= hl <= len(sam_header) - 4:
            sam_header = sam_header[4 : 4 + hl]
    ref_names = []
    for line in sam_header.decode(errors="replace").splitlines():
        if line.startswith("@SQ"):
            for fld in line.split("\t"):
                if fld.startswith("SN:"):
                    ref_names.append(fld[3:])

    def records():
        while True:
            chdr = _read_container_header(f)
            if chdr is None or (chdr["ref_id"] == -1 and chdr["n_rec"] == 0):
                break  # EOF container
            payload = io.BytesIO(f.read(chdr["length"]))
            if chdr["n_rec"] == 0:
                continue
            yield from _decode_container(payload, chdr, ref_names, contigs)
        f.close()

    return ref_names, records()


def _decode_container(payload, chdr, ref_names, contigs):
    ctype, _, comp = _read_block(payload)
    assert ctype == CT_COMPRESSION_HEADER, ctype
    pres, enc_map = _parse_compression_header(comp)
    while payload.tell() < len(payload.getbuffer()):
        ctype, _, sl = _read_block(payload)
        if ctype != CT_SLICE_HEADER:
            break
        s = io.BytesIO(sl)
        s_ref = _s32(read_itf8(s))
        s_start = read_itf8(s)
        read_itf8(s)  # span
        s_nrec = read_itf8(s)
        read_ltf8(s)  # counter
        s_nblocks = read_itf8(s)
        ids = [read_itf8(s) for _ in range(read_itf8(s))]
        read_itf8(s)  # embedded ref block id
        s.read(16)  # md5
        core = b""
        ext = {}
        for _ in range(s_nblocks):
            bt, bid, data = _read_block(payload)
            if bt == CT_EXTERNAL:
                ext[bid] = data
            else:
                core = data
        yield from _decode_slice(pres, enc_map, ext, core, s_ref, s_start,
                                 s_nrec, ref_names, contigs)


def _parse_compression_header(data: bytes):
    buf = io.BytesIO(data)
    pres = {"RN": True, "AP": True, "RR": True,
            "SM": b"\x1b\x1b\x1b\x1b\x1b", "TD": [b""]}
    n = read_itf8(buf)  # preservation map byte size
    sub = io.BytesIO(buf.read(n))
    for _ in range(read_itf8(sub)):
        key = sub.read(2).decode()
        if key in ("RN", "AP", "RR"):
            pres[key] = bool(sub.read(1)[0])
        elif key == "SM":
            pres["SM"] = sub.read(5)
        elif key == "TD":
            ln = read_itf8(sub)
            pres["TD"] = sub.read(ln).split(b"\x00")
        else:
            raise NotImplementedError(f"preservation key {key}")
    enc_map = {}
    n = read_itf8(buf)  # encoding map byte size
    sub = io.BytesIO(buf.read(n))
    for _ in range(read_itf8(sub)):
        key = sub.read(2).decode()
        enc_map[key] = _parse_encoding(sub)
    # tag encoding map: parse + skip
    n = read_itf8(buf)
    sub = io.BytesIO(buf.read(n))
    tag_enc = {}
    for _ in range(read_itf8(sub)):
        key = read_itf8(sub)
        tag_enc[key] = _parse_encoding(sub)
    pres["_tags"] = tag_enc
    return pres, enc_map


def _decode_slice(pres, enc_map, ext, core, s_ref, s_start, s_nrec,
                  ref_names, contigs):
    corebits = _CoreBits(core)  # ONE cursor shared by every decoder
    dec = {}
    for key, (codec, params) in enc_map.items():
        try:
            dec[key] = _Decoder(codec, params, ext, corebits)
        except NotImplementedError:
            dec[key] = None
    tag_dec = {k: _Decoder(c, p, ext, corebits)
               for k, (c, p) in pres["_tags"].items()}

    def iread(key, default=0):
        d = dec.get(key)
        return d.read_int() if d else default

    sm = pres["SM"]
    sub_table = {}
    for ri, rb in enumerate(_SUB_BASES):
        byte = sm[ri]
        alts = [b for b in _SUB_BASES if b != rb]
        # 2-bit code per alternate packed high-to-low
        for j, alt in enumerate(alts):
            code = (byte >> (6 - 2 * j)) & 3
            sub_table[(rb, code)] = alt

    last_pos = s_start
    for _ in range(s_nrec):
        bf = iread("BF")
        cf = iread("CF")
        rid = _s32(iread("RI")) if s_ref == -2 else s_ref
        rl = iread("RL")
        ap = iread("AP")
        if pres["AP"]:
            last_pos += ap
            pos = last_pos
        else:
            pos = ap
        iread("RG")
        name = ""
        if pres["RN"] and dec.get("RN"):
            name = dec["RN"].read_bytes().decode()
        if cf & 2:  # detached mate
            mf = iread("MF")
            # htslib does not store mate flags in BF: fold MF back in
            # (MF 0x1 -> mate reverse 0x20, MF 0x2 -> mate unmapped 0x8)
            if mf & 1:
                bf |= 0x20
            if mf & 2:
                bf |= 0x8
            iread("NS")
            iread("NP")
            iread("TS")
        elif cf & 4:
            iread("NF")
        tl = iread("TL")
        td_line = pres["TD"][tl] if tl < len(pres["TD"]) else b""
        for t in range(0, len(td_line), 3):
            tid = (td_line[t] << 16) | (td_line[t + 1] << 8) | td_line[t + 2]
            tag_dec[tid].read_bytes()
        seq = qual = ""
        if not (bf & 0x4):
            fn = iread("FN")
            feats = []
            fpos = 0
            for _ in range(fn):
                fc = chr(dec["FC"].read_byte())
                fpos += iread("FP")
                if fc == "B":
                    feats.append((fpos, "B", dec["BA"].read_byte(),
                                  dec["QS"].read_byte()))
                elif fc == "X":
                    feats.append((fpos, "X", iread("BS")))
                elif fc == "S":
                    feats.append((fpos, "S", dec["SC"].read_bytes()))
                elif fc == "I":
                    feats.append((fpos, "I", dec["IN"].read_bytes()))
                elif fc == "i":
                    feats.append((fpos, "I", bytes([dec["BA"].read_byte()])))
                elif fc == "D":
                    feats.append((fpos, "D", iread("DL")))
                elif fc == "N":
                    feats.append((fpos, "D", iread("RS")))
                elif fc == "H":
                    iread("HC")
                elif fc == "P":
                    iread("PD")
                elif fc == "Q":
                    dec["QS"].read_byte()
                else:
                    raise NotImplementedError(f"feature code {fc}")
            mq = iread("MQ")
            seq = _rebuild_seq(rl, pos, feats, ref_names, contigs, rid,
                              sub_table)
        else:
            mq = 0
            ba = dec.get("BA")
            seq = ba.read_bytes(rl).decode() if ba else "N" * rl
            fn = 0
        if cf & 1:  # quality scores stored
            q = dec["QS"].read_bytes(rl)
            qual = "".join(chr(c + 33) for c in q)
        else:
            qual = "I" * rl
        yield CramRecord(name, bf, rid, pos, mq, seq, qual)


def _rebuild_seq(rl, pos, feats, ref_names, contigs, rid, sub_table):
    ref = contigs.get(ref_names[rid]) if 0 <= rid < len(ref_names) else None
    out = []
    rpos = pos - 1  # 0-based ref cursor
    qpos = 1        # 1-based query cursor

    def take_ref(n):
        nonlocal rpos
        if ref is None:
            s = "N" * n
        else:
            s = ref[rpos : rpos + n].tobytes().decode()
        rpos += n
        return s

    for feat in sorted(feats, key=lambda x: x[0]):
        fpos = feat[0]
        gap = fpos - qpos
        if gap > 0:
            out.append(take_ref(gap))
            qpos += gap
        kind = feat[1]
        if kind == "X":
            rb = take_ref(1).upper()
            out.append(sub_table.get((rb if rb in _SUB_BASES else "N",
                                      feat[2]), "N"))
            qpos += 1
        elif kind == "S":
            s = feat[2].decode()
            out.append(s)
            qpos += len(s)
        elif kind == "I":
            s = feat[2].decode()
            out.append(s)
            qpos += len(s)
        elif kind == "D":
            rpos += feat[2]
        elif kind == "B":
            take_ref(1)
            out.append(chr(feat[2]))
            qpos += 1
    tail = rl - (qpos - 1)
    if tail > 0:
        out.append(take_ref(tail))
    return "".join(out)[:rl]


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _encode_ext(content_id: int) -> bytes:
    p = write_itf8(content_id)
    return write_itf8(E_EXTERNAL) + write_itf8(len(p)) + p


def _encode_stop(stop: int, content_id: int) -> bytes:
    p = bytes([stop]) + write_itf8(content_id)
    return write_itf8(E_BYTE_ARRAY_STOP) + write_itf8(len(p)) + p


def _encode_bal(len_cid: int, val_cid: int) -> bytes:
    inner_len = _encode_ext(len_cid)
    inner_val = _encode_ext(val_cid)
    p = inner_len + inner_val
    return write_itf8(E_BYTE_ARRAY_LEN) + write_itf8(len(p)) + p


class _BitWriter:
    """MSB-first bit emitter for the slice core block (writer twin of
    _CoreBits)."""

    def __init__(self):
        self._bits: list[int] = []

    def write(self, code: int, length: int):
        for i in range(length - 1, -1, -1):
            self._bits.append((code >> i) & 1)

    def bytes(self) -> bytes:
        out = bytearray((len(self._bits) + 7) // 8)
        for i, b in enumerate(self._bits):
            out[i >> 3] |= b << (7 - (i & 7))
        return bytes(out)


def _huffman_code_lengths(freqs: dict[int, int]) -> dict[int, int]:
    """Code length per symbol from a frequency map (plain Huffman tree;
    one symbol => the zero-bit degenerate form the spec allows)."""
    import heapq
    import itertools

    if len(freqs) == 1:
        return {next(iter(freqs)): 0}
    tick = itertools.count()
    heap = [(f, next(tick), {s: 0}) for s, f in freqs.items()]
    heapq.heapify(heap)
    while len(heap) > 1:
        fa, _, da = heapq.heappop(heap)
        fb, _, db = heapq.heappop(heap)
        merged = {s: l + 1 for s, l in da.items()}
        merged.update({s: l + 1 for s, l in db.items()})
        heapq.heappush(heap, (fa + fb, next(tick), merged))
    return heap[0][2]


def _canonical_codes(lengths: dict[int, int]) -> dict[int, tuple[int, int]]:
    """symbol -> (code, length), canonical assignment sorted by (length,
    symbol) — the exact rule _Decoder's Huffman reader inverts."""
    order = sorted(lengths, key=lambda s: (lengths[s], s))
    codes = {}
    code, prev = 0, lengths[order[0]]
    for s in order:
        code <<= lengths[s] - prev
        prev = lengths[s]
        codes[s] = (code, lengths[s])
        code += 1
    return codes


def _encode_huffman(codes: dict[int, tuple[int, int]]) -> bytes:
    syms = sorted(codes)
    p = write_itf8(len(syms)) + b"".join(write_itf8(s) for s in syms)
    p += write_itf8(len(syms)) + b"".join(write_itf8(codes[s][1])
                                          for s in syms)
    return write_itf8(E_HUFFMAN) + write_itf8(len(p)) + p


_WSM = bytes([0x1B] * 5)  # identity-ish substitution matrix (codes 00 01 10 11)


def _sub_code(ref_base: str, alt: str) -> int:
    alts = [b for b in _SUB_BASES if b != ref_base]
    j = alts.index(alt if alt in alts else alts[-1])
    return (_WSM[_SUB_BASES.index(ref_base)] >> (6 - 2 * j)) & 3


def write_cram(path: str, ref_names: list[str],
               contigs: dict[str, np.ndarray], records,
               slices_per_container: int = 1, method: int = 1,
               huffman_series: tuple = ()):
    """records: iterable of CramRecord-likes (name, flag, ref_id, pos,
    mapq, seq, qual) with cigar-free semantics: mapped reads are stored
    as full-length matches + substitution features vs the reference
    (soft structure like clips comes through as mismatch runs), unmapped
    reads verbatim. `slices_per_container` > 1 packs that many slices
    under one compression header (htslib's default layout); `method`
    selects block compression (1=gzip, 3=lzma). `huffman_series` names
    integer series (e.g. ("MQ", "BF")) to canonical-Huffman-code into
    the core bitstream, the spec 13.4 form htslib emits for
    low-cardinality series."""
    recs = list(records)
    out = open(path, "wb")
    out.write(CRAM_MAGIC)
    out.write(b"rufus_tpu_cram_0001\x00")
    # headers may name contigs absent from the loaded reference (e.g. a
    # slice reference vs a full BAM header): LN 0 and verbatim bases then
    sam = "@HD\tVN:1.6\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{len(contigs[n]) if n in contigs else 0}\n"
        for n in ref_names)
    _write_file_header_container(out, sam.encode())
    step = 4096 * max(1, slices_per_container)
    for c0 in range(0, len(recs), step):
        _write_data_container(out, ref_names, contigs, recs[c0 : c0 + step],
                              slices=slices_per_container, method=method,
                              huffman_series=huffman_series)
    # EOF container (spec-fixed content: empty compression header)
    _write_eof(out)
    out.close()


def _container(out, blocks_payload: bytes, ref_id, start, span, n_rec,
               n_blocks, landmarks=(0,)):
    hdr = (write_itf8(ref_id & 0xFFFFFFFF) + write_itf8(start)
           + write_itf8(span) + write_itf8(n_rec) + write_ltf8(0)
           + write_ltf8(0) + write_itf8(n_blocks)
           + write_itf8(len(landmarks)))
    for l in landmarks:
        hdr += write_itf8(l)
    hdr += struct.pack("<I", zlib.crc32(hdr) & 0xFFFFFFFF)
    out.write(struct.pack("<i", len(blocks_payload)))
    out.write(hdr)
    out.write(blocks_payload)


def _write_file_header_container(out, sam: bytes):
    body = struct.pack("<i", len(sam)) + sam
    buf = io.BytesIO()
    _write_block(buf, CT_FILE_HEADER, 0, body, gz=False)
    _container(out, buf.getvalue(), 0, 0, 0, 0, 1)


def _write_eof(out):
    buf = io.BytesIO()
    _write_block(buf, CT_COMPRESSION_HEADER, 0,
                 write_itf8(1) + write_itf8(0)  # empty pres map
                 + write_itf8(1) + write_itf8(0)
                 + write_itf8(1) + write_itf8(0), gz=False)
    _container(out, buf.getvalue(), -1, 4542278, 0, 0, 1)


_SERIES_IDS = {"BF": 1, "CF": 2, "RI": 3, "RL": 4, "AP": 5, "RG": 6,
               "RN": 7, "MF": 8, "NS": 9, "NP": 10, "TS": 11, "NF": 12,
               "TL": 13, "FN": 14, "FC": 15, "FP": 16, "BS": 17,
               "IN": 18, "SC": 19, "DL": 20, "BA": 21, "QS": 22, "MQ": 23}


def _slice_extent(recs):
    """(ref_id, start, span) for a record subset."""
    s_ref = recs[0].ref_id if recs else 0
    if any(r.ref_id != s_ref for r in recs):
        s_ref = -2
    mapped_pos = [r.pos for r in recs if not (r.flag & 0x4) and r.pos > 0]
    s_start = min(mapped_pos) if mapped_pos and s_ref >= 0 else 0
    s_span = (max(mapped_pos) - s_start + 1) if mapped_pos and s_ref >= 0 else 0
    return s_ref, s_start, s_span


def _slice_streams(ref_names, contigs, recs, s_ref, huff_codes=None,
                   collect=None):
    """Build the slice's per-series byte streams. Integer series named in
    `huff_codes` ({key: {symbol: (code, len)}}) are bit-packed into the
    shared core block instead (returned as the second element). With
    `collect` (a dict key -> list), integer values are also recorded —
    the writer's first pass gathers Huffman frequencies this way so both
    passes share one code path."""
    streams = {k: bytearray() for k in _SERIES_IDS}
    corebits = _BitWriter()

    def put(key, v):
        if collect is not None and key in collect:
            collect[key].append(v)
        if huff_codes and key in huff_codes:
            corebits.write(*huff_codes[key][v])
        else:
            streams[key] += write_itf8(v)

    for r in recs:
        put("BF", r.flag)
        put("CF", 3)  # quals stored | detached mate
        if s_ref == -2:
            put("RI", r.ref_id & 0xFFFFFFFF)
        rl = len(r.seq)
        put("RL", rl)
        put("AP", r.pos)  # AP-delta OFF (pres map)
        put("RG", 0xFFFFFFFF)
        streams["RN"] += r.name.encode() + b"\t"
        put("MF", 0)
        put("NS", 0xFFFFFFFF)
        put("NP", 0)
        put("TS", 0)
        put("TL", 0)
        if not (r.flag & 0x4):
            ref = contigs.get(ref_names[r.ref_id])
            seg = ("" if ref is None
                   else ref[r.pos - 1 : r.pos - 1 + rl].tobytes().decode())
            feats = []
            for i, (qb, rb) in enumerate(zip(r.seq, seg.ljust(rl, "N"))):
                qb, rb = qb.upper(), rb.upper()
                if qb != rb:
                    feats.append((i + 1, rb if rb in _SUB_BASES else "N", qb))
            put("FN", len(feats))
            last = 0
            for fpos, rb, qb in feats:
                if qb in _SUB_BASES and rb in _SUB_BASES and qb != "N":
                    streams["FC"] += b"X"
                    put("FP", fpos - last)
                    put("BS", _sub_code(rb, qb))
                else:
                    streams["FC"] += b"B"
                    put("FP", fpos - last)
                    streams["BA"] += qb.encode()
                    streams["QS"] += bytes([ord(r.qual[fpos - 1]) - 33])
                last = fpos
            put("MQ", r.mapq)
        else:
            streams["BA"] += r.seq.encode()
        streams["QS"] += bytes(ord(c) - 33 for c in r.qual)
    return streams, corebits.bytes()


def _write_data_container(out, ref_names, contigs, recs, slices=1, method=1,
                          huffman_series=()):
    # split records into per-slice chunks sharing one compression header
    slices = max(1, slices)
    per = -(-len(recs) // slices) if recs else 1
    chunks = [recs[i : i + per] for i in range(0, len(recs), per)] or [recs]
    c_ref, c_start, c_span = _slice_extent(recs)

    # Huffman-coded series (spec 13.4): first pass collects each named
    # series' symbol frequencies over the WHOLE container (codes live in
    # the compression header, shared by its slices), second pass below
    # bit-packs the values into each slice's core block
    huff_codes = None
    if huffman_series:
        coll = {k: [] for k in huffman_series}
        for chunk in chunks:
            s_ref, _, _ = _slice_extent(chunk)
            _slice_streams(ref_names, contigs, chunk, s_ref, collect=coll)
        huff_codes = {}
        for key, vals in coll.items():
            if not vals:
                continue
            freqs: dict[int, int] = {}
            for v in vals:
                freqs[v] = freqs.get(v, 0) + 1
            huff_codes[key] = _canonical_codes(_huffman_code_lengths(freqs))

    # compression header
    pres = bytearray()
    entries = [(b"RN", b"\x01"), (b"AP", b"\x00"), (b"RR", b"\x01"),
               (b"SM", _WSM), (b"TD", write_itf8(1) + b"\x00")]
    pm = write_itf8(len(entries)) + b"".join(k + v for k, v in entries)
    pres += write_itf8(len(pm)) + pm
    encs = []
    for key, cid in _SERIES_IDS.items():
        if huff_codes and key in huff_codes:
            encs.append((key.encode(), _encode_huffman(huff_codes[key])))
        elif key == "RN":
            encs.append((key.encode(), _encode_stop(ord("\t"), cid)))
        elif key in ("IN", "SC"):
            encs.append((key.encode(), _encode_stop(0, cid)))
        else:
            encs.append((key.encode(), _encode_ext(cid)))
    em = write_itf8(len(encs)) + b"".join(k + v for k, v in encs)
    pres += write_itf8(len(em)) + em
    tm = write_itf8(0)
    pres += write_itf8(len(tm)) + tm

    buf = io.BytesIO()
    _write_block(buf, CT_COMPRESSION_HEADER, 0, bytes(pres), gz=False)
    n_blocks = 1
    for chunk in chunks:
        s_ref, s_start, s_span = _slice_extent(chunk)
        streams, core = _slice_streams(ref_names, contigs, chunk, s_ref,
                                       huff_codes=huff_codes)
        used = [cid for key, cid in _SERIES_IDS.items() if streams[key]]
        sl = (write_itf8(s_ref & 0xFFFFFFFF) + write_itf8(s_start)
              + write_itf8(s_span) + write_itf8(len(chunk)) + write_ltf8(0)
              + write_itf8(1 + len(used)) + write_itf8(len(used)))
        for cid in used:
            sl += write_itf8(cid)
        sl += write_itf8(0xFFFFFFFF)  # no embedded reference
        sl += b"\x00" * 16
        _write_block(buf, CT_SLICE_HEADER, 0, sl, gz=False)
        _write_block(buf, 5, 0, core, gz=False)  # core bitstream block
        for key, cid in _SERIES_IDS.items():
            if streams[key]:
                _write_block(buf, CT_EXTERNAL, cid, bytes(streams[key]),
                             method=method)
        n_blocks += 2 + len(used)
    _container(out, buf.getvalue(), c_ref, c_start, c_span, len(recs),
               n_blocks)


# ---------------------------------------------------------------------------
# pipeline adapters (mirror io/bam.py)
# ---------------------------------------------------------------------------


def cram_records(path: str, contigs: dict[str, np.ndarray]):
    return read_cram(path, contigs)


def cram_to_fastq(path: str, contigs, exclude_flags: int | None = None,
                  progress_path: str | None = None):
    """Unpaired pass-through: CRAM -> (name, seq, qual), the
    bam.bam_to_fastq contract (samtools view -F 3328 | PassThroughSamCheck
    role) for .cram generators (runRufus.sh:218-240)."""
    from . import bam

    if exclude_flags is None:
        exclude_flags = bam.DEFAULT_EXCLUDE
    names, records = read_cram(path, contigs)
    if progress_path:
        records = bam._progress_records(
            records, [(n, 0) for n in names], progress_path)
    for r in records:
        if r.flag & exclude_flags:
            continue
        yield r.name, r.seq, r.qual


def cram_to_paired_fastq(path: str, contigs, exclude_flags: int | None = None,
                         progress_path: str | None = None):
    """Stranded pair-matching pass-through (PassThroughSamCheck.stranded
    role) for CRAM input."""
    from . import bam

    if exclude_flags is None:
        exclude_flags = bam.DEFAULT_EXCLUDE
    names, records = read_cram(path, contigs)
    if progress_path:
        records = bam._progress_records(
            records, [(n, 0) for n in names], progress_path)
    pending: dict[str, tuple[str, str]] = {}
    for r in records:
        if r.flag & exclude_flags:
            continue
        seq, qual = r.seq, r.qual
        if r.flag & 0x10:
            seq = bam.revcomp_bytes(seq.encode()).decode()
            qual = qual[::-1]
        if r.name in pending:
            m2s, m2q = pending.pop(r.name)
            yield r.name, seq, qual, m2s, m2q
        else:
            pending[r.name] = (seq, qual)


def cram_to_single_fastq(path: str, contigs, exclude_flags: int | None = None,
                         progress_path: str | None = None):
    """Single-end stranded pass-through for CRAM input."""
    from . import bam

    if exclude_flags is None:
        exclude_flags = bam.DEFAULT_EXCLUDE
    names, records = read_cram(path, contigs)
    if progress_path:
        records = bam._progress_records(
            records, [(n, 0) for n in names], progress_path)
    for r in records:
        if r.flag & exclude_flags:
            continue
        seq, qual = r.seq, r.qual
        if r.flag & 0x10:
            seq = bam.revcomp_bytes(seq.encode()).decode()
            qual = qual[::-1]
        yield r.name, seq, qual
