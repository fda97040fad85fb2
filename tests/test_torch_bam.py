"""BAM, CRAM and FASTQ input of the port: the native decoders against the
port's Python readers and the JAX package's decoder, the synthetic BAM
writer, and the trio pipeline through the filter from BAM, CRAM and mixed
inputs against the JAX pipeline's, every output file byte for byte.

The trio is tests/test_torch_pipeline.py's 20 kbp one, written as aligned
BAMs by ``synthetic.write_trio_bams`` (with its unmapped pairs and its
secondary, duplicate and supplementary records), the child's with a few
250 bp pairs added. The streaming BAM decoder is read a block, a few blocks
and the whole file a window, on that BAM, on it rewritten in small BGZF
blocks and on it with mates far apart. Pipelines run with exome=True and
-m 5 (no ModelDist fit), the JAX one with sharded="off". Tolerance: exact
equality.
"""

import gzip
import json
import os

import numpy as np
import pytest

from rufus_tpu.io import bam as jbam
from rufus_tpu.io import native as jnative
from rufus_tpu.pipeline import RufusConfig as JaxConfig
from rufus_tpu.pipeline import RufusPipeline as JaxPipeline
from rufus_tpu_torch import synthetic
from rufus_tpu_torch.io import bam, bgzf, cram, fastq, native
from rufus_tpu_torch.ops import _build
from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline

K = 25
LONG = 250  # length of the extra reads of the child's BAM


def _long_pairs(data, rng):
    """Six 250 bp pairs: four are child pairs that span a spiked site with
    100 random bases after each mate, two are random."""
    names = {}
    for m, path in enumerate(data["child"]):
        for n, s, q in fastq.read_fastq(path):
            names.setdefault(n.split()[0], [None, None])[m] = (s, q)
    spanning = []
    for n, mates in names.items():
        _, _, start, frag = n.split("_")
        lo, hi = int(start), int(start) + int(frag)
        if ((data["sites"] >= lo) & (data["sites"] < hi)).any():
            spanning.append((int(start), mates))
    out = []
    for i, (start, mates) in enumerate(spanning[:: len(spanning) // 4][:4]):
        tail = ["".join("ACGT"[b] for b in rng.integers(0, 4, LONG - 150))
                for _ in range(2)]
        out.append((f"long{i}", start, [(s + t, q + "I" * len(t))
                                        for (s, q), t in zip(mates, tail)]))
    for i in range(2):
        out.append((f"rand{i}", int(rng.integers(0, 19_000)), [
            ("".join("ACGT"[b] for b in rng.integers(0, 4, LONG)), "I" * LONG)
            for _ in range(2)]))
    return out


def _add_long_reads(path, pairs):
    """Rewrite a coordinate-sorted BAM with `pairs` inserted at their
    positions, forward mates 0x40 then 0x80."""
    refs, records = bam.read_bam(path)
    recs = list(records)
    for name, pos, mates in pairs:
        for m, (s, q) in enumerate(mates):
            recs.append(bam.BamRecord(name, 0x1 | 0x2 | (0x40, 0x80)[m], 0,
                                      pos + 50 * m, 60, [(len(s), "M")], s, q,
                                      0, pos + 50 * (1 - m), 0))
    placed = [r for r in recs if r.ref_id >= 0]
    placed.sort(key=lambda r: r.pos)  # stable: inserted after their peers
    bam.write_bam(path, refs, placed + [r for r in recs if r.ref_id < 0],
                  index=False)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    d = tmp_path_factory.mktemp("bamtrio")
    data = synthetic.write_trio(str(d / "fastq"), genome_bp=20_000,
                                coverage=30, n_denovo=4, seed=3)
    bams = synthetic.write_trio_bams(data, str(d / "bam"), seed=3)
    _add_long_reads(bams["child"],
                    _long_pairs(data, np.random.default_rng(3)))
    ref = str(d / "ref.fa")
    with open(ref, "w") as f:
        f.write(f">{synthetic.REF_NAME}\n"
                + data["genome"].tobytes().decode() + "\n")
    return d, data, bams, ref


def _kwargs(workdir, subject, controls, **over):
    kw = dict(subject=subject, controls=controls, k=K, workdir=str(workdir),
              exome=True, min_cov=5, stop_after="filter")
    kw.update(over)
    return kw


def _outputs(wd):
    return sorted(n for n in os.listdir(wd)
                  if os.path.isfile(os.path.join(wd, n)))


def _run_both(tmp_path, **kw):
    """The slice on the JAX pipeline and on the port (CPU); returns both
    workdirs after checking every output file is byte-equal."""
    jwd, pwd = tmp_path / "jax", tmp_path / "port"
    JaxPipeline(JaxConfig(**_kwargs(jwd, sharded="off", table_cap0=1 << 17,
                                    **kw))).run()
    RufusPipeline(RufusConfig(**_kwargs(pwd, device="cpu", **kw))).run()
    names = _outputs(pwd)
    assert names == _outputs(jwd)
    assert len([n for n in names if n.endswith(".table.npz")]) == 3
    for n in names:
        a, b = pwd / n, jwd / n
        if n.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for key in za.files:
                assert za[key].dtype == zb[key].dtype, (n, key)
                np.testing.assert_array_equal(za[key], zb[key])
        else:
            assert a.read_bytes() == b.read_bytes(), n
    return jwd, pwd


def _fastq_records(path):
    with open(path) as f:
        lines = f.read().split("\n")
    return [tuple(lines[i:i + 4]) for i in range(0, len(lines) - 1, 4)]


# -- the synthetic BAM writer ---------------------------------------------------


def test_synthetic_bams_hold_the_fastq_reads(trio, tmp_path):
    d, data, bams, _ = trio
    refs, records = bam.read_bam(bams["mother"])
    recs = list(records)
    # the vectorized writer writes what bam.write_bam writes
    bam.write_bam(str(tmp_path / "m.bam"), refs, recs, index=False)
    assert (tmp_path / "m.bam").read_bytes() == open(bams["mother"],
                                                     "rb").read()
    assert refs == [(synthetic.REF_NAME, 20_000)]
    placed = [r.pos for r in recs if r.ref_id >= 0]
    assert placed == sorted(placed)
    assert all(r.ref_id < 0 for r in recs[len(placed):])
    flags = np.array([r.flag for r in recs])
    assert (flags & bam.DEFAULT_EXCLUDE != 0).sum() >= 1
    assert ((flags & 0xC) == 0xC).sum() >= 2
    # the stranded stream gives back each FASTQ pair, mates in any order
    fq = {}
    for m, path in enumerate(data["mother"]):
        for n, s, q in fastq.read_fastq(path):
            fq.setdefault(n.split()[0], []).append((s, q))
    pairs = list(bam.bam_to_paired_fastq(bams["mother"]))
    assert len(pairs) == data["pairs"]
    for name, s1, q1, s2, q2 in pairs:
        assert sorted([(s1, q1), (s2, q2)]) == sorted(fq[name])


# -- the native decoders ----------------------------------------------------------


def _rows(seq, qual, lens):
    return [(seq[i, :n].tobytes(), qual[i, :n].tobytes())
            for i, n in enumerate(lens.tolist())]


@pytest.mark.parametrize("pad", [160, 100, 1024])
def test_native_bam_read_batch_matches(trio, pad):
    d, data, bams, _ = trio
    path = bams["child"]
    want = [(s.encode()[:pad], q.encode()[:pad])
            for _, s, q in bam.bam_to_fastq(path)]
    got = []
    with native.NativeBam(path, threads=3) as nb:
        jb = jnative.NativeBam(path, threads=3)
        assert len(nb) == len(jb)
        while True:
            s, q, l = nb.read_batch(333, pad)
            js, jq, jl = jb.read_batch(333, pad)
            np.testing.assert_array_equal(s, js)
            np.testing.assert_array_equal(q, jq)
            np.testing.assert_array_equal(l, jl)
            if not len(l):
                break
            got += _rows(s, q, l)
        jb.close()
    assert got == want
    assert any(len(s) > 150 for s, _ in got) == (pad > 150)


def test_native_bam_pair_and_single_streams_match(trio):
    d, data, bams, _ = trio
    path = bams["child"]
    want = [(n, s1, q1, s2, q2) for n, s1, q1, s2, q2
            in bam.bam_to_paired_fastq(path)]
    got = []
    with native.NativeBam(path) as nb:
        jb = jnative.NativeBam(path)
        assert nb.max_read_len() == LONG
        while True:
            names, s1, q1, l1, s2, q2, l2 = nb.read_pair_batch(500, 1024)
            jn, *jarrs = jb.read_pair_batch(500, 1024)
            assert list(names) == jn
            for a, b in zip((s1, q1, l1, s2, q2, l2), jarrs):
                np.testing.assert_array_equal(a, b)
            if not len(names):
                break
            got += [(n, a[0].decode(), a[1].decode(), b[0].decode(),
                     b[1].decode()) for n, a, b in
                    zip(names, _rows(s1, q1, l1), _rows(s2, q2, l2))]
        jb.close()
        assert got == want
        refs, records = bam.read_bam(path)
        assert nb.refs() == [(n, 0) for n, _ in refs]
        np.testing.assert_array_equal(nb.ref_ids(),
                                      [r.ref_id for r in records])
        # the single-end stream shares read_batch's cursor
        nb.reset()
        single = []
        while True:
            names, s, q, l = nb.read_se_batch(700, 1024)
            if not len(names):
                break
            single += [(n, a.decode(), b.decode())
                       for n, (a, b) in zip(names, _rows(s, q, l))]
        assert single == list(bam.bam_to_single_fastq(path))


def test_native_bam_out_arrays_are_filled_in_place(trio):
    d, data, bams, _ = trio
    out = [np.zeros((64, 160), np.uint8), np.zeros((64, 160), np.uint8),
           np.zeros(64, np.int32)]
    with native.NativeBam(bams["father"]) as nb:
        s, q, l = nb.read_batch(64, 160, out=out)
        want_s, want_q, want_l = native.NativeBam(bams["father"]).read_batch(
            64, 160)
    assert np.shares_memory(s, out[0]) and np.shares_memory(l, out[2])
    np.testing.assert_array_equal(s, want_s)
    np.testing.assert_array_equal(q, want_q)
    np.testing.assert_array_equal(l, want_l)
    with pytest.raises(ValueError):
        native.NativeBam(bams["father"]).read_batch(
            64, 100, out=out)
    with pytest.raises(IOError):
        native.NativeBam(data["father"][0])  # a FASTQ is not a BAM


def _bgzf_blocks(path):
    """(compressed, inflated) bytes of each BGZF block of `path` (the BC
    subfield first, as every writer here puts it)."""
    raw = open(path, "rb").read()
    out, off = [], 0
    while off < len(raw):
        size = int.from_bytes(raw[off + 16:off + 18], "little") + 1
        out.append((size, int.from_bytes(raw[off + size - 4:off + size],
                                         "little")))
        off += size
    return out


def _windows(path, window):
    """(compressed, inflated) bytes of each window the decoder reads: the
    first block alone, then the whole blocks that start within `window`
    bytes."""
    wins, comp, infl = [], 0, 0
    for i, (c, n) in enumerate(_bgzf_blocks(path)):
        comp, infl = comp + c, infl + n
        if i == 0 or comp >= window:
            wins.append((comp, infl))
            comp = infl = 0
    return wins + ([(comp, infl)] if comp else [])


def _held_bound(path, window, peak_pending, longest=LONG):
    """The most the decoder may hold for `path`: its four windows' buffers
    (the compressed one reserved 128 KiB past each block, each grown at
    most twofold), a carried record and the pending mates' arena (compacted
    once its holes outweigh its live entries) and table."""
    win = max(2 * (c + (2 << 16)) + 2 * n for c, n in _windows(path, window))
    entry = 11 + 255 + longest * 3 // 2 + 1
    pending = (2 * (2 * peak_pending * entry + (1 << 16) + entry)
               + 16 * max(1024, 4 * peak_pending))
    return 4 * win + 2 * (entry + 64) + pending


def _write_bgzf(data: bytes, path, block: int):
    """`data` as BGZF blocks of `block` bytes and the EOF block."""
    with open(path, "wb") as f:
        for i in range(0, len(data), block):
            f.write(bgzf._bgzf_block(data[i:i + block]))
        f.write(bgzf.BGZF_EOF)


@pytest.fixture(scope="module")
def bam_cases(trio, tmp_path_factory):
    """The child's BAM as written (blocks of 0xFF00 bytes); rewritten in
    blocks of 300 bytes, so that every record straddles blocks; and with
    the second record of every other name moved past the unmapped pairs at
    the end of the file, so that about a thousand mates wait far apart."""
    d = tmp_path_factory.mktemp("bamcases")
    child = trio[2]["child"]
    small = str(d / "small.bam")
    _write_bgzf(gzip.decompress(open(child, "rb").read()), small, 300)
    refs, records = bam.read_bam(child)
    order, near, far = {}, [], []
    for r in records:
        seen = r.name in order
        order.setdefault(r.name, len(order))
        (far if seen and order[r.name] % 2 == 0 else near).append(r)
    spread = str(d / "far.bam")
    bam.write_bam(spread, refs, near + far, index=False)
    return {"child": child, "small_blocks": small, "far_mates": spread}


def _drain(read):
    """Batches of `read()` until an empty one."""
    out = []
    while True:
        b = read()
        if not len(b[0]):
            return out
        out.append(b)


@pytest.mark.parametrize("window", [1, 20_000, 1 << 40],
                         ids=["block", "blocks", "file"])
@pytest.mark.parametrize("stream", ["records", "single", "pairs"])
@pytest.mark.parametrize("case", ["child", "small_blocks", "far_mates"])
def test_streaming_decoder_matches_the_reference(bam_cases, case, stream,
                                                 window):
    """Each stream, a window at a time, equals the JAX package's decoder
    (records and pairs, read_pad 160 with the cut reads widened to 1024)
    and io/bam.py (single-end), byte for byte; its counters add up to the
    file, and it holds two windows and the pending mates, not the file."""
    path = bam_cases[case]
    jb = jnative.NativeBam(path, threads=3)
    n_records = len(jb)
    with native.NativeBam(path, threads=3, window=window) as nb:
        if stream == "records":
            got = _drain(lambda: nb.read_batch(333, 160))
            want = _drain(lambda: jb.read_batch(333, 160))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
            seq = np.empty((333, 160), np.uint8)
            lens = np.zeros(333, np.int32)
            with native.NativeBam(path, window=window) as bare:
                for w in want:  # no qualities asked, none decoded
                    s, q, l = bare.read_batch(333, 160, out=(seq, None, lens))
                    assert q is None
                    np.testing.assert_array_equal(s, w[0])
                    np.testing.assert_array_equal(l, w[2])
        elif stream == "pairs":
            wide_ref = jnative.NativeBam(path)
            widened = 0
            while True:  # batch by batch: widen reads the last batch
                names, *arrs = nb.read_pair_batch(333, 160)
                jn, *jarrs = jb.read_pair_batch(333, 160)
                if not len(names):
                    break
                assert list(names) == jn
                for a, b in zip(arrs, jarrs):
                    np.testing.assert_array_equal(a, b)
                wn, *warrs = wide_ref.read_pair_batch(333, 1024)
                assert list(names) == wn
                if nb.longest > 160:
                    widened += 1
                    n = len(names)
                    arrs = nb.widen(arrs, [np.empty((n, 1024), np.uint8)
                                           if a.ndim == 2 else a
                                           for a in arrs])
                    for a, b in zip(arrs, warrs):
                        np.testing.assert_array_equal(a, b)
                assert _rows(*arrs[:3]) == _rows(*warrs[:3])
                assert _rows(*arrs[3:]) == _rows(*warrs[3:])
            assert len(jn) == 0 and widened >= 1
            wide_ref.close()
        else:
            got = [(n, a.decode(), b.decode())
                   for names, s, q, l in _drain(
                       lambda: nb.read_se_batch(700, 1024))
                   for n, (a, b) in zip(names, _rows(s, q, l))]
            assert got == list(jbam.bam_to_single_fastq(path))
        st = nb.stats()
    jb.close()
    blocks = _bgzf_blocks(path)
    assert st["records"] == n_records
    assert st["compressed_bytes"] == os.path.getsize(path)
    assert st["inflated_bytes"] == sum(n for _, n in blocks)
    assert st["windows"] == len(_windows(path, window))
    assert (st["peak_pending"] > 0) == (stream == "pairs")
    assert st["peak_held_bytes"] <= _held_bound(path, window,
                                                st["peak_pending"])
    if window == 1 and case != "far_mates":
        assert st["peak_held_bytes"] < st["inflated_bytes"] / 2


@pytest.mark.parametrize("fault", ["cut_record", "cut_block",
                                   "corrupt_block", "corrupt_crc"])
def test_streaming_decoder_raises_on_a_bad_file(trio, tmp_path, fault):
    """A BAM cut off inside a record (good BGZF blocks), one cut off inside
    a block, one with corrupt deflate data and one with a block's CRC
    wrong raise IOError from every stream and from a pass of its own, at
    every window; none ends short without a word."""
    src = trio[2]["child"]
    raw = open(src, "rb").read()
    blocks = _bgzf_blocks(src)
    mid = sum(c for c, _ in blocks[:len(blocks) // 2])
    path = str(tmp_path / "bad.bam")
    bad = bytearray(raw)
    if fault == "cut_record":
        _write_bgzf(gzip.decompress(raw)[:-100], path, 0xFF00)
    elif fault == "cut_block":
        open(path, "wb").write(raw[:mid + 100])
    elif fault == "corrupt_block":
        bad[mid + 40] ^= 0xFF  # inside the middle block's deflate data
        open(path, "wb").write(bytes(bad))
    else:
        bad[mid + blocks[len(blocks) // 2][0] - 8] ^= 0xFF
        open(path, "wb").write(bytes(bad))
    reads = (lambda nb: nb.read_batch(500, 160),
             lambda nb: nb.read_pair_batch(500, 160),
             lambda nb: nb.read_se_batch(500, 160),
             lambda nb: (range(len(nb)),))
    for window in (1, 20_000, 1 << 40):
        for read in reads:
            with native.NativeBam(path, window=window) as nb:
                with pytest.raises(IOError):
                    _drain(lambda: read(nb))


def test_streaming_decoder_under_many_threads(bam_cases):
    """More inflate threads than cores on windows of a few hundred small
    blocks, and handles closed mid-stream while their pool works: every
    stream still equals the JAX package's decoder."""
    path = bam_cases["small_blocks"]
    jb = jnative.NativeBam(path)
    want = _drain(lambda: jb.read_pair_batch(200, 160))
    jb.close()
    threads = 4 * (os.cpu_count() or 1)
    for _ in range(3):
        with native.NativeBam(path, threads=threads, window=2_000) as nb:
            got = _drain(lambda: nb.read_pair_batch(200, 160))
        assert len(got) == len(want)
        for (gn, *g), (wn, *w) in zip(got, want):
            assert list(gn) == wn
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    for _ in range(20):
        with native.NativeBam(path, threads=threads, window=2_000) as nb:
            assert len(nb.read_pair_batch(200, 160)[0]) == 200


def test_native_bam_serves_one_stream_until_reset(trio):
    with native.NativeBam(trio[2]["father"]) as nb:
        assert len(nb.read_batch(10, 160)[0]) == 10
        for read in (nb.read_pair_batch, nb.read_se_batch):
            with pytest.raises(ValueError):
                read(10, 160)
        assert len(nb) > 10  # a pass of its own leaves the stream alone
        assert len(nb.read_batch(10, 160)[0]) == 10
        nb.reset()
        names, s1, *_ = nb.read_pair_batch(10, 160)
        jb = jnative.NativeBam(trio[2]["father"])
        jn, js1, *_ = jb.read_pair_batch(10, 160)
        jb.close()
        assert list(names) == jn
        np.testing.assert_array_equal(s1, js1)


@pytest.mark.parametrize("pad", [160, 120])
def test_native_fastq_matches_fastq_batches(trio, pad):
    d, data, bams, _ = trio
    path = data["child"][1]
    want = list(fastq.fastq_batches(path, 700, pad))
    with native.NativeFastq(path) as nf:
        for b in want:
            seq, lens = nf.read_batch(700, pad)
            np.testing.assert_array_equal(seq, b.seq)
            np.testing.assert_array_equal(lens, b.lens)
        assert len(nf.read_batch(700, pad)[0]) == 0
    jf = jnative.NativeFastq(path)
    got = jf.read_batch(5000, pad)
    jf.close()
    np.testing.assert_array_equal(got[0], np.concatenate([b.seq
                                                          for b in want]))


def test_native_fastq_pairs_match_fastq_pair_batches(trio):
    d, data, bams, _ = trio
    r1, r2 = data["mother"]
    want = list(fastq.fastq_pair_batches(r1, r2, 600, 160, 1024))
    with native.NativeFastqPairs(r1, r2) as fp:
        for b1, b2 in want:
            names, s1, q1, l1, s2, q2, l2 = fp.read_pair_batch(600, 160)
            assert list(names) == [b1.name(i) for i in range(len(b1))]
            for got, b in (((s1, q1, l1), b1), ((s2, q2, l2), b2)):
                np.testing.assert_array_equal(got[2], b.lens)
                assert _rows(*got) == _rows(b.seq, b.qual, b.lens)
        assert len(fp.read_pair_batch(600, 160)[0]) == 0


def test_native_fastq_pair_names_overflow_lossless(tmp_path):
    """A batch whose R1 names overflow the name buffer comes back short and
    loses no record; R1 and R2 stay in step (tests/test_io.py's case)."""
    r1, r2 = str(tmp_path / "ov.R1.fastq"), str(tmp_path / "ov.R2.fastq")
    recs = [(f"read{i:05d}_" + "x" * 600, "ACGT" * 10, "I" * 40)
            for i in range(4500)]
    for path, flip in ((r1, False), (r2, True)):
        with open(path, "w") as f:
            for n, s, q in recs:
                f.write(f"@{n} comment\n{s[::-1] if flip else s}\n+\n{q}\n")
    names, seqs2, short = [], [], 0
    with native.NativeFastqPairs(r1, r2) as fp:
        while True:
            nm, s1, q1, l1, s2, q2, l2 = fp.read_pair_batch(4096, 64)
            if not len(nm):
                break
            short += len(nm) < 4096
            names += list(nm)
            seqs2 += [s2[i, :l2[i]].tobytes().decode() for i in range(len(nm))]
    assert names == [n for n, _, _ in recs]
    assert seqs2 == [s[::-1] for _, s, _ in recs]
    assert short >= 2


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent fallback: a failed build raises with the compiler's
    output, and the pipeline does not fall back to the Python reader."""
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "g++")
    monkeypatch.setattr(_build, "HOST_FLAGS",
                        _build.HOST_FLAGS + ["-DRUFUS_NO_SUCH", "-include",
                                             "no_such_header.h"])
    with pytest.raises(RuntimeError, match="no_such_header"):
        _build.build_native()


def test_pipeline_raises_when_the_decoder_cannot_load(trio, tmp_path,
                                                      monkeypatch):
    d, data, bams, _ = trio

    def broken():
        raise RuntimeError("building librufus_torch_io.so failed")

    monkeypatch.setattr(native, "_lib", broken)
    cfg = RufusConfig(**_kwargs(tmp_path, bams["child"],
                                [bams["mother"], bams["father"]],
                                device="cpu", stop_after="jhash"))
    with pytest.raises(RuntimeError, match="librufus_torch_io"):
        RufusPipeline(cfg).run()


# -- the pipeline against the JAX package's ----------------------------------------


def test_bam_trio_matches_jax_pipeline(trio, tmp_path):
    d, data, bams, _ = trio
    jwd, pwd = _run_both(tmp_path, subject=bams["child"],
                         controls=[bams["mother"], bams["father"]])
    m1 = _fastq_records(pwd / "child.bam.generator.Mutations.Mate1.fastq")
    m2 = _fastq_records(pwd / "child.bam.generator.Mutations.Mate2.fastq")
    assert any(len(r[1]) == LONG for r in m1 + m2)
    # kept pairs are FASTQ pairs (mates in either order) or long pairs
    fq = {}
    for path in data["child"]:
        for n, s, q in fastq.read_fastq(path):
            fq.setdefault(n.split()[0], []).append((s, q))
    for a, b in zip(m1, m2):
        name = a[0][1:]
        assert a[0] == b[0]
        if not name.startswith("long"):
            assert sorted([(a[1], a[3]), (b[1], b[3])]) == sorted(fq[name])
    assert (pwd / "child.bam.generator.filter.chr").read_text() == \
        "notachr\nbooya\n"


def test_bam_single_end_matches_jax_pipeline(trio, tmp_path):
    d, data, bams, _ = trio
    jwd, pwd = _run_both(tmp_path, subject=bams["child"],
                         controls=[bams["mother"], bams["father"]],
                         single_end=True)
    kept = _fastq_records(pwd / "child.bam.generator.Mutations.fastq")
    assert kept and not (pwd / "child.bam.generator.filter.chr").exists()


def test_cram_subject_matches_jax_pipeline(trio, tmp_path):
    d, data, bams, ref = trio
    refs, records = bam.read_bam(bams["child"])
    path = str(tmp_path / "child.cram")
    cram.write_cram(path, [n for n, _ in refs],
                    {synthetic.REF_NAME: data["genome"]},
                    [cram.CramRecord(r.name, r.flag, r.ref_id, r.pos + 1,
                                     r.mapq, r.seq, r.qual) for r in records])
    jwd, pwd = _run_both(tmp_path, subject=path,
                         controls=[bams["mother"], bams["father"]], ref=ref)
    log = (pwd / "child.cram.generator.Jelly.chr").read_text()
    assert log == f"notachr\n{synthetic.REF_NAME}\n*\nbooya\n"
    assert (pwd / "child.cram.generator.filter.chr").read_text() == log


def test_mixed_inputs_match_jax_pipeline(trio, tmp_path):
    """FASTQ and BAM parts in one comma-separated list (the BAM last: the
    JAX package cannot read a BAM before a FASTQ part), FASTQ-only and
    single-BAM samples, and the filter from -q1/-q2."""
    d, data, bams, _ = trio
    c = data["child"]
    jwd, pwd = _run_both(tmp_path, subject=f"{c[1]},{bams['child']}",
                         controls=[",".join(data["mother"]), bams["father"]],
                         fastq_a=c[0], fastq_b=c[1])
    stub = os.path.basename(c[1]) + ".generator"
    assert (pwd / f"{stub}.Jelly.chr").read_text() == \
        f"notachr\n{synthetic.REF_NAME}\n*\nbooya\n"


def test_part_order_does_not_change_the_counts(trio, tmp_path):
    """The port reads a BAM before a FASTQ part too, with the same table
    and chromosome log as the other order."""
    d, data, bams, _ = trio
    outs = []
    for parts in ((data["child"][1], bams["child"]),
                  (bams["child"], data["child"][1])):
        wd = tmp_path / str(len(outs))
        RufusPipeline(RufusConfig(**_kwargs(
            wd, ",".join(parts), [bams["mother"]], device="cpu",
            stop_after="jhash"))).run()
        stub = os.path.basename(parts[0]) + ".generator"
        outs.append(((wd / f"{stub}.Jhash.histo").read_bytes(),
                     (wd / f"{stub}.Jelly.chr").read_bytes(),
                     np.load(wd / f"{stub}.table.npz")["keys"]))
    assert outs[0][:2] == outs[1][:2]
    np.testing.assert_array_equal(outs[0][2], outs[1][2])


def test_filter_does_not_cut_long_reads(trio, tmp_path):
    """A pair whose only mutant windows lie past read_pad is kept from a
    BAM, as the JAX package's -q1/-q2 route keeps it: the batch widens to
    the read (up to 1024 bases) instead of cutting it."""
    d, data, bams, _ = trio
    wd = tmp_path / "run"
    m1 = RufusPipeline(RufusConfig(**_kwargs(
        wd, bams["child"], [bams["mother"], bams["father"]],
        device="cpu"))).run()
    hl = str(next(wd.glob("*.HashList")))
    seq = next(r[1] for r in _fastq_records(m1) if len(r[1]) == 150)
    rng = np.random.default_rng(11)
    rand = lambda n: "".join("ACGT"[b] for b in rng.integers(0, 4, n))  # noqa
    s = rand(300) + seq  # the mutant bases sit past base 300
    mate = rand(150)
    # the long read is the second record seen: mate 1 of the stranded rule
    sub = str(tmp_path / "long.bam")
    bam.write_bam(sub, [(synthetic.REF_NAME, 20_000)], [
        bam.BamRecord("deep", 0x1 | 0x2 | flag, 0, pos, 60, [(len(x), "M")],
                      x, "I" * len(x), 0, 201 - pos, 0)
        for flag, pos, x in ((0x80, 100, mate), (0x40, 101, s))],
        index=False)
    r1, r2 = str(tmp_path / "deep.R1.fastq"), str(tmp_path / "deep.R2.fastq")
    fastq.write_fastq(r1, [("deep", s, "I" * len(s))])
    fastq.write_fastq(r2, [("deep", mate, "I" * 150)])
    outs = []
    for tag, over in (("bam", {}), ("fq", dict(fastq_a=r1, fastq_b=r2))):
        cfg = RufusConfig(**_kwargs(tmp_path / tag, sub, [], device="cpu",
                                    **over))
        outs.append(RufusPipeline(cfg).stage_filter(hl))
    jcfg = JaxConfig(**_kwargs(tmp_path / "jax", sub, [], sharded="off",
                               fastq_a=r1, fastq_b=r2))
    outs.append(JaxPipeline(jcfg).stage_filter(hl))
    texts = [[open(p).read() for p in paths] for paths in outs]
    assert texts[0] == texts[1] == texts[2]
    assert texts[0][0] == f"@deep\n{s}\n+\n{'I' * len(s)}\n"


@pytest.fixture(scope="module")
def bam_run(trio, tmp_path_factory):
    """The port's slice from the trio's BAMs: its workdir and HashList."""
    d, data, bams, _ = trio
    wd = tmp_path_factory.mktemp("bamrun")
    RufusPipeline(RufusConfig(**_kwargs(
        wd, bams["child"], [bams["mother"], bams["father"]],
        device="cpu"))).run()
    return wd, str(next(wd.glob("*.HashList")))


@pytest.mark.parametrize("batch", [97, 2048])
def test_bam_filter_widens_batch_by_batch(trio, bam_run, tmp_path, batch):
    """The BAM pair stream takes its width batch by batch: read_pad where
    every read of the batch fits, MAX_READ where one of the child's LONG
    reads falls; the kept pairs are the JAX package's, byte for byte."""
    d, data, bams, _ = trio
    _, hl = bam_run
    cfg = RufusConfig(**_kwargs(tmp_path / "port", bams["child"],
                                [bams["mother"], bams["father"]],
                                device="cpu", batch_size=batch))
    pipe = RufusPipeline(cfg)
    widths = []
    keep_mask = pipe._keep_mask

    def recording(tensors, table):
        widths.append(tensors[0].shape[1])
        return keep_mask(tensors, table)

    pipe._keep_mask = recording
    port = pipe.stage_filter(hl)
    jax = JaxPipeline(JaxConfig(**_kwargs(
        tmp_path / "jax", bams["child"], [bams["mother"], bams["father"]],
        sharded="off"))).stage_filter(hl)
    texts = [[open(p).read() for p in paths] for paths in (port, jax)]
    assert texts[0] == texts[1]
    assert any(len(r[1]) == LONG for r in _fastq_records(port[0]))
    assert 1024 in widths
    assert (160 in widths) == (batch == 97)


def test_bam_stage_records_carry_the_decoder_counter(trio, bam_run):
    """Each BAM stream of the count and the filter leaves its decoder's
    counters in the stage's record: the whole file inflated and parsed, a
    window at a time, holding two windows and the pending mates."""
    d, data, bams, _ = trio
    wd, _ = bam_run
    with open(wd / "Intermediates" / "trace.jsonl") as f:
        recs = {r["stage"]: r for r in map(json.loads, f)}
    paths = {os.path.basename(p): p for p in bams.values()}
    for stage, files in (("count", ["child.bam", "father.bam",
                                    "mother.bam"]),
                         ("filter", ["child.bam"])):
        entries = recs[stage]["bam"]
        assert sorted(e["file"] for e in entries) == files
        for e in entries:
            path = paths[e["file"]]
            assert set(e) == {"file", *native.NativeBam.STATS}
            assert e["compressed_bytes"] == os.path.getsize(path)
            assert e["inflated_bytes"] == sum(n for _, n in
                                              _bgzf_blocks(path))
            assert e["records"] == len(list(bam.read_bam(path)[1]))
            assert e["windows"] == len(_windows(path, native.BAM_WINDOW))
            assert (e["peak_pending"] > 0) == (stage == "filter")
            assert e["peak_held_bytes"] <= _held_bound(
                path, native.BAM_WINDOW, e["peak_pending"])


def test_cli_reads_cram_with_its_reference(trio, tmp_path, monkeypatch):
    """-r is accepted when an input is a CRAM (and refused otherwise, see
    tests/test_torch_pipeline.py); -t sets the BAM inflate threads."""
    import sys

    from rufus_tpu_torch.pipeline.__main__ import main

    d, data, bams, ref = trio
    refs, records = bam.read_bam(bams["mother"])
    path = str(tmp_path / "mother.cram")
    cram.write_cram(path, [n for n, _ in refs],
                    {synthetic.REF_NAME: data["genome"]},
                    [cram.CramRecord(r.name, r.flag, r.ref_id, r.pos + 1,
                                     r.mapq, r.seq, r.qual) for r in records])
    wd = tmp_path / "cli"
    monkeypatch.setattr(sys, "argv", [
        "rufus_tpu_torch", "-s", bams["mother"], "-c", path, "-r", ref,
        "-t", "3", "-k", str(K), "-m", "5", "--exome", "--stop-after",
        "jhash", "--workdir", str(wd), "--device", "cpu"])
    main()
    np.testing.assert_array_equal(
        np.load(wd / "mother.bam.generator.table.npz")["keys"],
        np.load(wd / "mother.cram.generator.table.npz")["keys"])
