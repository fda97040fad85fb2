"""The port's host I/O modules against the JAX package's, byte for byte:
BGZF and tabix, the BAM writer, reader, streams and progress files, rANS,
CRAM, FASTA and the BWA .pac reference. Inputs are made with numpy from a
seed, on a small synthetic reference kept here; tolerance: exact equality.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest

from rufus_tpu.io import bam as jbam
from rufus_tpu.io import bgzf as jbgzf
from rufus_tpu.io import bwaindex as jbwa
from rufus_tpu.io import cram as jcram
from rufus_tpu.io import fasta as jfasta
from rufus_tpu.io import rans as jrans
from rufus_tpu_torch.io import bam, bgzf, bwaindex, cram, fasta, progress, rans

RNG_SEED = 20261017
_BASES = np.frombuffer(b"ACGT", np.uint8)


def _contigs(seed=5):
    rng = np.random.default_rng(seed)
    return {"c1": _BASES[rng.integers(0, 4, 5000)].copy(),
            "c2": _BASES[rng.integers(0, 4, 3000)].copy()}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# -- BGZF and tabix ---------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 1000, bgzf.MAX_BLOCK, 200_000])
def test_bgzf_blocks_and_writer_match(tmp_path, n):
    rng = np.random.default_rng(RNG_SEED + n)
    data = bytes(rng.integers(0, 4, n).astype(np.uint8) + 65)
    if n <= bgzf.MAX_BLOCK:
        assert bgzf._bgzf_block(data) == jbgzf._bgzf_block(data)
    offsets = []
    for mod, name in ((bgzf, "p"), (jbgzf, "j")):
        w = mod.BgzfWriter(str(tmp_path / f"{name}.gz"))
        got = []
        for lo in range(0, n, 7777):
            got.append(w.tell_virtual())
            w.write(data[lo:lo + 7777])
        got.append(w.tell_virtual())
        w.close()
        offsets.append(got)
        mod.bgzf_compress_file(str(tmp_path / f"{name}.gz"),
                               str(tmp_path / f"{name}.gz.gz"))
    assert offsets[0] == offsets[1]
    assert _bytes(tmp_path / "p.gz") == _bytes(tmp_path / "j.gz")
    assert _bytes(tmp_path / "p.gz.gz") == _bytes(tmp_path / "j.gz.gz")
    import gzip

    assert gzip.decompress(_bytes(tmp_path / "p.gz")) == data


def test_reg2bin_matches():
    rng = np.random.default_rng(RNG_SEED)
    beg = rng.integers(0, 1 << 29, 2000)
    span = rng.integers(1, 1 << rng.integers(1, 28, 2000))
    for b, s in zip(beg.tolist(), span.tolist()):
        assert bgzf._reg2bin(b, b + s) == jbgzf._reg2bin(b, b + s)


def _vcf(path, rng):
    lines = ["##fileformat=VCFv4.2", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
             "\tINFO\tFORMAT\tS"]
    for chrom in ("1", "5:177630000", "X"):
        for pos in np.sort(rng.choice(np.arange(1, 300_000), 700,
                                      replace=False)):
            ref = "".join("ACGT"[i] for i in rng.integers(0, 4,
                                                          rng.integers(1, 5)))
            lines.append(f"{chrom}\t{pos}\t.\t{ref}\tA\t50\tPASS\tDP=9\t"
                         "GT\t0/1")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_bgzip_tabix_vcf_and_query_match(tmp_path):
    rng = np.random.default_rng(RNG_SEED)
    for name in ("p", "j"):
        os.makedirs(tmp_path / name)
    _vcf(str(tmp_path / "p" / "FINAL.vcf"), rng)
    _vcf(str(tmp_path / "j" / "FINAL.vcf"),
         np.random.default_rng(RNG_SEED))
    bgzf.bgzip_tabix_vcf(str(tmp_path / "p" / "FINAL.vcf"))
    jbgzf.bgzip_tabix_vcf(str(tmp_path / "j" / "FINAL.vcf"))
    for ext in (".gz", ".gz.tbi"):
        assert (_bytes(tmp_path / "p" / ("FINAL.vcf" + ext))
                == _bytes(tmp_path / "j" / ("FINAL.vcf" + ext)))
    p, j = (str(tmp_path / n / "FINAL.vcf.gz") for n in ("p", "j"))
    hits = 0
    for chrom, beg, end in (("1", 0, 300_000), ("5:177630000", 1000, 90_000),
                            ("X", 150_000, 150_100), ("2", 0, 10)):
        got = list(bgzf.tabix_query(p, chrom, beg, end))
        assert got == list(jbgzf.tabix_query(j, chrom, beg, end))
        hits += len(got)
    assert hits > 700
    with open(tmp_path / "p" / "FINAL.vcf.gz", "rb") as f:
        assert bgzf.bgzf_read_block(f, 0) == jbgzf.bgzf_read_block(
            open(tmp_path / "j" / "FINAL.vcf.gz", "rb"), 0)


# -- BAM --------------------------------------------------------------------


def _bam_records(mod, contigs, n=300, seed=RNG_SEED):
    """Coordinate-sorted records over two contigs: forward and reverse,
    odd lengths, N, an insertion, a missing qual, then unplaced reads."""
    rng = np.random.default_rng(seed)
    names = list(contigs)
    recs = []
    for rid, name in enumerate(names):
        for pos in np.sort(rng.integers(0, len(contigs[name]) - 200, n)):
            L = int(rng.integers(20, 151))
            seq = contigs[name][pos:pos + L].tobytes().decode()
            if rng.random() < 0.1:
                seq = seq[:5] + "N" + seq[6:]
            qual = "".join(chr(33 + q) for q in rng.integers(2, 41, L))
            if rng.random() < 0.05:
                qual = "*"
            cigar = [(L, "M")]
            if rng.random() < 0.1:
                cigar = [(3, "M"), (1, "I"), (L - 4, "M")]
            flag = int(rng.choice([99, 147, 83, 163, 0, 16, 0x100, 0x400]))
            recs.append(mod.BamRecord(f"r{len(recs)}", flag, rid, int(pos),
                                      int(rng.integers(0, 61)), cigar, seq,
                                      qual, rid, int(pos) + 100,
                                      int(rng.integers(-500, 500))))
    for i in range(7):
        recs.append(mod.BamRecord(f"u{i}", 77 if i % 2 == 0 else 141, -1, -1,
                                  0, [], "ACGTNACGTA"[: 5 + i], "I" * (5 + i)))
    return recs


def _rec_tuple(r):
    return (r.name, r.flag, r.ref_id, r.pos, r.mapq, r.cigar, r.seq, r.qual,
            r.next_ref_id, r.next_pos, r.tlen)


def test_write_bam_and_bai_match(tmp_path):
    contigs = _contigs()
    refs = [(n, len(s)) for n, s in contigs.items()]
    tags = ["NM:i:2", "XX:Z:hi", "XA:A:q", "XF:f:0.5"]
    bam.write_bam(str(tmp_path / "p.bam"), refs, _bam_records(bam, contigs),
                  tags_for=lambda r: bam._enc_tags(tags))
    jbam.write_bam(str(tmp_path / "j.bam"), refs, _bam_records(jbam, contigs),
                   tags_for=lambda r: jbam._enc_tags(tags))
    for ext in (".bam", ".bam.bai"):
        assert _bytes(tmp_path / ("p" + ext)) == _bytes(tmp_path / ("j" + ext))
    rec = _bam_records(bam, contigs)[3]
    assert bam.encode_record(rec) == jbam.encode_record(rec)
    prefs, precs = bam.read_bam(str(tmp_path / "p.bam"))
    jrefs, jrecs = jbam.read_bam(str(tmp_path / "j.bam"))
    assert prefs == jrefs == refs
    got = [_rec_tuple(r) for r in precs]
    assert got == [_rec_tuple(r) for r in jrecs]
    assert len(got) == 607


@pytest.mark.parametrize("stream", ["bam_to_fastq", "bam_to_paired_fastq",
                                    "bam_to_single_fastq"])
def test_bam_streams_and_progress_match(tmp_path, stream):
    contigs = _contigs()
    refs = [(n, len(s)) for n, s in contigs.items()]
    recs = _bam_records(bam, contigs)
    # pairs: every mapped record gets a mate named alike further on
    for i, r in enumerate(list(recs[:200])):
        recs.append(bam.BamRecord(r.name, r.flag ^ 0x10, r.ref_id, r.pos,
                                  r.mapq, r.cigar, r.seq[::-1], r.qual))
    path = str(tmp_path / "s.bam")
    bam.write_bam(path, refs, recs, index=False)
    got = list(getattr(bam, stream)(path, progress_path=str(tmp_path / "p")))
    want = list(getattr(jbam, stream)(path,
                                      progress_path=str(tmp_path / "j")))
    assert got == want and len(got) > 100
    assert _bytes(tmp_path / "p") == _bytes(tmp_path / "j")
    assert progress.stream_complete(str(tmp_path / "p"))
    assert jbam.stream_complete(str(tmp_path / "p"))


def test_progress_sentinel_matches(tmp_path):
    progress.write_complete(str(tmp_path / "done"))
    assert _bytes(tmp_path / "done") == (
        "notachr\n" + jbam.STREAM_SENTINEL + "\n").encode()
    assert bam.STREAM_SENTINEL == jbam.STREAM_SENTINEL
    (tmp_path / "cut").write_text("notachr\nc1\n")
    for p in ("done", "cut", "missing"):
        assert (progress.stream_complete(str(tmp_path / p))
                == jbam.stream_complete(str(tmp_path / p)))


# -- rANS ---------------------------------------------------------------------

_RNG = np.random.default_rng(20260821)
RANS_CASES = [
    b"A",
    b"IIIIIIIIIIIIIIIIIIIIIIII",
    bytes(_RNG.integers(33, 74, 5000).astype(np.uint8)),
    bytes(_RNG.choice(list(b"ACGTN"), 10001)),
    b"read1\tread2\tread3\t" * 200,
    bytes(_RNG.integers(0, 256, 3000).astype(np.uint8)),
    bytes([0, 1, 2, 3] * 1000),
    bytes(_RNG.integers(33, 74, 4099).astype(np.uint8)),
]


@pytest.mark.parametrize("i", range(len(RANS_CASES)))
def test_rans_matches(i):
    data = RANS_CASES[i]
    for comp, jcomp in ((rans.compress_o0, jrans.compress_o0),
                        (rans.compress_o1, jrans.compress_o1)):
        if comp is rans.compress_o1 and len(data) < 4:
            continue
        enc = comp(data)
        assert enc == jcomp(data)
        assert rans.uncompress(enc) == data == jrans.uncompress(enc)


# -- CRAM ---------------------------------------------------------------------


def _cram_records(mod, contigs, n=200, seed=6, unmapped_every=11):
    names = list(contigs)
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        rid = i % 2
        pos = int(rng.integers(1, len(contigs[names[rid]]) - 160))
        seq = contigs[names[rid]][pos - 1:pos - 1 + 100].tobytes().decode()
        if i % 3 == 0:
            j = int(rng.integers(0, 100))
            seq = seq[:j] + "ACGT"[("ACGT".index(seq[j]) + 1) % 4] + seq[j + 1:]
        if i % 7 == 0:
            seq = seq[:50] + "N" + seq[51:]
        qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 40, 100))
        flag = int(rng.choice([99, 147, 83, 163, 0x100 | 99]))
        if i % unmapped_every == 0:
            flag, pos = 77, 0
        recs.append(mod.CramRecord(f"read{i}", flag,
                                   rid if flag != 77 else -1, pos,
                                   int(rng.integers(0, 61)), seq, qual))
    return recs


@pytest.mark.parametrize("layout", [
    dict(), dict(method=0), dict(method=3, slices_per_container=2),
    dict(huffman_series=("MQ", "BF", "FN")), dict(n=4097),
    dict(n=2, unmapped_every=1)])
def test_cram_write_and_read_match(tmp_path, layout):
    contigs = _contigs()
    names = list(contigs)
    layout = dict(layout)
    n = layout.pop("n", 200)
    unmapped_every = layout.pop("unmapped_every", 11)
    p, j = str(tmp_path / "p.cram"), str(tmp_path / "j.cram")
    cram.write_cram(p, names, contigs,
                    _cram_records(cram, contigs, n, 6, unmapped_every),
                    **layout)
    jcram.write_cram(j, names, contigs,
                     _cram_records(jcram, contigs, n, 6, unmapped_every),
                     **layout)
    assert _bytes(p) == _bytes(j)
    got_names, it = cram.read_cram(p, contigs)
    got = [(r.name, r.flag, r.ref_id, r.pos, r.mapq, r.seq, r.qual)
           for r in it]
    jnames, jit = jcram.read_cram(p, contigs)
    assert got_names == jnames == names
    assert got == [(r.name, r.flag, r.ref_id, r.pos, r.mapq, r.seq, r.qual)
                   for r in jit]
    want = _cram_records(cram, contigs, n, 6, unmapped_every)
    assert [(g[0], g[1], g[5], g[6]) for g in got] == [
        (r.name, r.flag, r.seq, r.qual) for r in want]
    prog = [str(tmp_path / x) for x in ("pp", "jp")]
    for fn in ("cram_to_fastq", "cram_to_paired_fastq",
               "cram_to_single_fastq"):
        assert (list(getattr(cram, fn)(p, contigs, progress_path=prog[0]))
                == list(getattr(jcram, fn)(p, contigs,
                                           progress_path=prog[1])))
        assert _bytes(prog[0]) == _bytes(prog[1])


@pytest.mark.parametrize("method", [2, 4])
def test_cram_block_methods_decode(method):
    """bzip2 (2) and rANS (4) blocks, which the writer does not make,
    decode through both readers' _read_block."""
    import bz2

    payload = bytes(np.random.default_rng(method).integers(
        33, 74, 4096).astype(np.uint8))
    enc = bz2.compress(payload) if method == 2 else rans.compress_o1(payload)
    body = (bytes([method]) + cram.write_itf8(cram.CT_EXTERNAL)
            + cram.write_itf8(7) + cram.write_itf8(len(enc))
            + cram.write_itf8(len(payload)) + enc)
    blk = body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)
    assert cram._read_block(io.BytesIO(blk)) == (cram.CT_EXTERNAL, 7,
                                                 payload)
    assert jcram._read_block(io.BytesIO(blk)) == (cram.CT_EXTERNAL, 7,
                                                  payload)


def test_itf8_ltf8_match():
    for v in (0, 1, 127, 128, 300, 16383, 16384, 2**21 - 1, 2**28 - 1,
              2**28, 2**32 - 1):
        assert cram.write_itf8(v) == jcram.write_itf8(v)
        assert cram.read_itf8(io.BytesIO(cram.write_itf8(v))) == v
    for v in (0, 127, 128, 2**14, 2**21, 2**35, 2**56 - 1, 2**60):
        assert cram.write_ltf8(v) == jcram.write_ltf8(v)
        assert cram.read_ltf8(io.BytesIO(cram.write_ltf8(v))) == v


# -- FASTA and the BWA .pac reference -----------------------------------------


def _write_pac(prefix, contigs, holes):
    """A BWA index's .ann/.amb/.pac for `contigs` (ACGT), with N runs
    `holes` [(offset, length)] in the concatenation."""
    seq = np.concatenate(list(contigs.values()))
    codes = np.searchsorted(_BASES, seq).astype(np.uint8)
    pad = (-len(codes)) % 4
    c = np.concatenate([codes, np.zeros(pad, np.uint8)]).reshape(-1, 4)
    pac = (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
    np.concatenate([pac, [len(codes) % 4]]).astype(np.uint8).tofile(
        prefix + ".pac")
    with open(prefix + ".ann", "w") as f:
        f.write(f"{len(seq)} {len(contigs)} 11\n")
        off = 0
        for name, s in contigs.items():
            f.write(f"0 {name} (null)\n{off} {len(s)} 0\n")
            off += len(s)
    with open(prefix + ".amb", "w") as f:
        f.write(f"{len(seq)} {len(contigs)} {len(holes)}\n")
        for o, n in holes:
            f.write(f"{o} {n} N\n")


def test_fasta_and_pac_references_match(tmp_path):
    contigs = _contigs()
    fa = str(tmp_path / "ref.fa")
    bwaindex.write_fasta(fa, contigs, width=70)
    jbwaindex_fa = str(tmp_path / "jref.fa")
    jbwa.write_fasta(jbwaindex_fa, contigs, width=70)
    assert _bytes(fa) == _bytes(jbwaindex_fa)
    pr, jr = fasta.FastaReference(fa), jfasta.FastaReference(fa)
    assert pr.names == jr.names == list(contigs)
    for n in contigs:
        np.testing.assert_array_equal(pr.seqs[n], jr.seqs[n])
        np.testing.assert_array_equal(pr.seqs[n], contigs[n])
        assert pr.get(n, 4990, 30) == jr.get(n, 4990, 30)
        assert pr.length(n) == jr.length(n)
    prefix = str(tmp_path / "idx.fa")
    _write_pac(prefix, contigs, [(100, 7), (5003, 2)])
    got = bwaindex.load_pac_reference(prefix)
    want = jbwa.load_pac_reference(prefix)
    assert list(got) == list(want) == list(contigs)
    for n in contigs:
        np.testing.assert_array_equal(got[n], want[n])
    assert got["c1"][100:107].tobytes() == b"N" * 7
    assert got["c2"][3:5].tobytes() == b"NN"
    np.testing.assert_array_equal(got["c1"][:100], contigs["c1"][:100])
