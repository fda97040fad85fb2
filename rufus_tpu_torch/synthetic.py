"""A synthetic trio as paired FASTQ, made from a seed, and the same reads
as coordinate-sorted BAMs.

A random genome; the child carries de novo SNVs on one haplotype (VAF
0.5), the parents carry the genome alone. Each sample gets `coverage`x of
read pairs from fragments of random length, read from both strands, with
substitution errors, low-quality bases and a few N. Records have fixed
widths and are written with numpy in chunks.

Read names carry where a pair came from, `p<pair>_<hap>_<start>_<frag>`
(hap 1 holds the de novo SNVs), so a caller can tell which spiked sites a
set of kept pairs spans (`sites_spanned`).

`write_trio_bams` writes each sample's reads as an aligned BAM, each read
at its true position, as an aligner would leave them: reverse-strand reads
stored reverse-complemented with 0x10, a few pairs unmapped at the end of
the file, and a few extra secondary, duplicate and supplementary records
that every input stream must drop.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .io import bgzf

_BASES = np.frombuffer(b"ACGT", np.uint8)
_NAME_W = (9, 1, 10, 4)  # digits of pair index, haplotype, start, fragment


def _digits(x: np.ndarray, width: int) -> np.ndarray:
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((x[:, None] // p[None, :]) % 10 + 48).astype(np.uint8)


def _names(idx, hap, start, frag) -> np.ndarray:
    cols = [np.full((len(idx), 1), ord("p"), np.uint8)]
    for i, (v, w) in enumerate(zip((idx, hap, start, frag), _NAME_W)):
        if i:
            cols.append(np.full((len(idx), 1), ord("_"), np.uint8))
        cols.append(_digits(np.asarray(v, np.int64), w))
    return np.concatenate(cols, axis=1)


def _records(names, mate: int, seq, qual) -> np.ndarray:
    n = len(names)

    def col(s):
        return np.broadcast_to(np.frombuffer(s, np.uint8), (n, len(s)))

    return np.concatenate([col(b"@"), names, col(b" %d\n" % mate), seq,
                           col(b"\n+\n"), qual, col(b"\n")], axis=1)


def _sample(f1, f2, rng, haps, n_pairs, read_len, frag_mean, frag_sd,
            sub_rate, lowq_rate, n_rate, chunk=1 << 18):
    """Write one sample's pairs; returns, per pair, whether mate 1 read the
    reverse strand."""
    G = len(haps[0])
    comp = np.array([3, 2, 1, 0], np.uint8)
    flips = []
    for lo in range(0, n_pairs, chunk):
        m = min(chunk, n_pairs - lo)
        hap = rng.integers(0, len(haps), m)
        frag = np.clip(np.rint(rng.normal(frag_mean, frag_sd, m)),
                       read_len, 2 * frag_mean).astype(np.int64)
        start = (rng.random(m) * (G - frag + 1)).astype(np.int64)
        cols = np.arange(read_len)[None, :]
        fwd = np.empty((m, read_len), np.uint8)
        rev = np.empty((m, read_len), np.uint8)
        for h, g in enumerate(haps):
            sel = hap == h
            fwd[sel] = g[start[sel, None] + cols]
            end = (start + frag)[sel, None]
            rev[sel] = comp[g[end - 1 - cols]]
        flip = rng.random(m) < 0.5  # which strand mate 1 reads
        flips.append(flip)
        r1 = np.where(flip[:, None], rev, fwd)
        r2 = np.where(flip[:, None], fwd, rev)
        names = _names(np.arange(lo, lo + m), hap, start, frag)
        for f, r, mate in ((f1, r1, 1), (f2, r2, 2)):
            err = rng.random(r.shape) < sub_rate
            r = np.where(err, (r + rng.integers(1, 4, r.shape)) % 4, r)
            seq = _BASES[r]
            seq[rng.random(r.shape) < n_rate] = ord("N")
            qual = np.where(rng.random(r.shape) < lowq_rate,
                            np.uint8(ord("#")), np.uint8(ord("I")))
            _records(names, mate, seq, qual).tofile(f)
    return np.concatenate(flips) if flips else np.zeros(0, bool)


def write_trio(out_dir: str, *, genome_bp: int, coverage: float = 30.0,
               read_len: int = 150, frag_mean: int = 400, frag_sd: int = 40,
               n_denovo: int = 100, sub_rate: float = 0.002,
               lowq_rate: float = 0.02, n_rate: float = 0.0005,
               seed: int = 0) -> dict:
    """Write child/mother/father R1 + R2 FASTQ into out_dir.

    Returns {"child": (r1, r2), "mother": ..., "father": ..., "sites":
    sorted de novo positions, "pairs": pairs per sample, "genome" (the
    parents' genome, uint8 ASCII), "genome_bp", "read_len",
    "mate1_reverse": {sample: (pairs,) bool}}."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_bp).astype(np.uint8)
    # de novo sites: at least 2 fragment lengths from the ends, 100 bp apart
    grid = np.arange(2 * frag_mean, genome_bp - 2 * frag_mean, 100)
    sites = np.sort(rng.choice(grid, n_denovo, replace=False))
    mutant = genome.copy()
    mutant[sites] = (genome[sites] + rng.integers(1, 4, n_denovo)) % 4
    n_pairs = int(genome_bp * coverage / (2 * read_len))
    out = {"sites": sites, "pairs": n_pairs, "genome": _BASES[genome],
           "genome_bp": genome_bp,
           "read_len": read_len, "mate1_reverse": {}}
    for name, haps in (("child", (genome, mutant)), ("mother", (genome,)),
                       ("father", (genome,))):
        paths = tuple(os.path.join(out_dir, f"{name}.R{m}.fastq")
                      for m in (1, 2))
        with open(paths[0], "wb") as f1, open(paths[1], "wb") as f2:
            out["mate1_reverse"][name] = _sample(
                f1, f2, rng, haps, n_pairs, read_len, frag_mean, frag_sd,
                sub_rate, lowq_rate, n_rate)
        out[name] = paths
    return out


REF_NAME = "syn"
_SEQ_CODE = np.full(256, 15, np.uint8)  # SAMv1 4.2.3 nibbles, "=ACMGRSVTWYHKDBN"
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _SEQ_CODE[_c] = _SEQ_CODE[ord(chr(_c).lower())] = _i
_COMP = np.arange(256, dtype=np.uint8)
_COMP[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN", np.uint8)


def _fastq_fields(path: str, read_len: int):
    """(names, seqs, quals) (n, width) uint8 of a fixed-width FASTQ that
    write_trio wrote; a name stops before its first space."""
    raw = np.fromfile(path, np.uint8)
    first = raw[: 4 * (read_len + 64) + 64].tobytes().split(b"\n")
    width = sum(len(line) + 1 for line in first[:4])
    recs = raw.reshape(-1, width)
    name_w = first[0].index(b" ") - 1
    seq_at = len(first[0]) + 1
    return (recs[:, 1:1 + name_w], recs[:, seq_at:seq_at + read_len],
            recs[:, seq_at + read_len + 3:seq_at + 2 * read_len + 3])


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """bgzf._reg2bin over arrays."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    for shift, first in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        same = (beg >> shift) == (end >> shift)
        out = np.where(same, first + (beg >> shift), out)
    return out


def _encode(ref_id, pos, flag, names, seq, qual, next_pos, tlen, mapped):
    """BAM alignment blocks (block_size first) of reads of one length and
    one name width, as ``bam.encode_record`` writes them: mapped reads with
    one `<L>M` CIGAR, unmapped ones unplaced with none. -> (n, width)."""
    n, L = seq.shape
    dt = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                   ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                   ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                   ("next_ref_id", "<i4"), ("next_pos", "<i4"),
                   ("tlen", "<i4"), ("name", "u1", (names.shape[1] + 1,)),
                   ("cigar", "<u4", (int(mapped),)),
                   ("seq", "u1", ((L + 1) // 2,)), ("qual", "u1", (L,))])
    r = np.zeros(n, dt)
    r["block_size"] = dt.itemsize - 4
    r["ref_id"] = ref_id
    r["pos"] = pos
    r["l_read_name"] = names.shape[1] + 1
    r["l_seq"] = L
    r["flag"] = flag
    r["name"][:, :-1] = names
    if mapped:
        r["mapq"] = 60
        r["bin"] = _reg2bin(pos, pos + L)
        r["n_cigar"] = 1
        r["cigar"][:, 0] = L << 4  # op 0, M
        r["next_ref_id"] = ref_id
        r["next_pos"] = next_pos
        r["tlen"] = tlen
    else:
        r["bin"] = 4680  # reg2bin(-1, 0), unplaced
        r["next_ref_id"] = -1
        r["next_pos"] = -1
    code = _SEQ_CODE[seq]
    if L % 2:
        code = np.concatenate([code, np.zeros((n, 1), np.uint8)], axis=1)
    r["seq"] = (code[:, 0::2] << 4) | code[:, 1::2]
    r["qual"] = qual - 33
    return r.view(np.uint8).reshape(n, dt.itemsize)


def _write_bgzf(path: str, data: np.ndarray, threads: int):
    """`data` as BGZF blocks of MAX_BLOCK bytes (BgzfWriter's cut),
    compressed in parallel, then the EOF block."""
    view = memoryview(data)
    chunks = [view[i:i + bgzf.MAX_BLOCK]
              for i in range(0, len(data), bgzf.MAX_BLOCK)]
    with ThreadPoolExecutor(threads) as pool, open(path, "wb") as f:
        for block in pool.map(bgzf._bgzf_block, chunks):
            f.write(block)
        f.write(bgzf.BGZF_EOF)


UNMAPPED_RATE = 0.005  # pairs left unmapped by write_trio_bams
EXTRA_RATE = 0.001  # extra secondary/duplicate/supplementary records


def write_trio_bams(data: dict, out_dir: str, *, seed: int = 0,
                    threads: int | None = None) -> dict:
    """Write each sample of a write_trio result as `<sample>.bam`: the same
    reads as its FASTQ files, coordinate-sorted on one reference of the
    genome's length, each read at its true position with a `<L>M` CIGAR.

    Flags are 0x1|0x2|0x40/0x80, 0x10 on the reverse-strand read (stored
    reverse-complemented with reversed quals) and 0x20 on its mate. About
    UNMAPPED_RATE of the pairs are unmapped (0x4|0x8, ref_id -1, stored as
    read) at the end of the file; about EXTRA_RATE extra records repeat
    mapped reads flagged secondary (0x100), duplicate (0x400) or
    supplementary (0x800). The extras and the unplaced pairs come from
    `seed`; `threads` (default: every core) compress the BGZF blocks.
    Returns {sample: path}."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    L, G = data["read_len"], data["genome_bp"]
    text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{REF_NAME}\tLN:{G}\n"
    name_b = REF_NAME.encode() + b"\0"
    header = np.frombuffer(
        b"BAM\1" + np.int32(len(text)).tobytes() + text.encode()
        + np.int32(1).tobytes() + np.int32(len(name_b)).tobytes() + name_b
        + np.int32(G).tobytes(), np.uint8)
    paths = {}
    for sample in ("child", "mother", "father"):
        fields = [_fastq_fields(p, L) for p in data[sample]]
        names = fields[0][0]
        digits = (names.astype(np.int64) - 48)
        start = digits[:, 13:23] @ 10 ** np.arange(9, -1, -1)
        frag = digits[:, 24:28] @ 10 ** np.arange(3, -1, -1)
        rev1 = data["mate1_reverse"][sample]
        n = len(names)
        unmapped = rng.random(n) < UNMAPPED_RATE
        # per mate: reverse strand, position, flag, stored seq and qual
        mates = []
        for m, (_, seq, qual) in enumerate(fields):
            rev = rev1 if m == 0 else ~rev1
            pos = np.where(rev, start + frag - L, start)
            flag = (0x1 | 0x2 | (0x40 if m == 0 else 0x80)
                    | np.where(rev, 0x10, 0x20))
            seq = np.where(rev[:, None], _COMP[seq[:, ::-1]], seq)
            qual = np.where(rev[:, None], qual[:, ::-1], qual)
            tlen = np.where(rev, -frag, frag)
            mates.append((pos, flag, seq, qual, tlen))
        # mapped records, both mates, with their mates' positions
        keep = ~unmapped
        pos = np.concatenate([mates[0][0][keep], mates[1][0][keep]])
        next_pos = np.concatenate([mates[1][0][keep], mates[0][0][keep]])
        flag = np.concatenate([mates[0][1][keep], mates[1][1][keep]])
        seq = np.concatenate([mates[0][2][keep], mates[1][2][keep]])
        qual = np.concatenate([mates[0][3][keep], mates[1][3][keep]])
        tlen = np.concatenate([mates[0][4][keep], mates[1][4][keep]])
        rnames = np.concatenate([names[keep], names[keep]])
        extra = np.flatnonzero(rng.random(len(pos)) < EXTRA_RATE)
        extra_flag = flag[extra] | rng.choice([0x100, 0x400, 0x800],
                                              len(extra))
        pos, next_pos, seq, qual, tlen, rnames = (
            np.concatenate([a, a[extra]])
            for a in (pos, next_pos, seq, qual, tlen, rnames))
        flag = np.concatenate([flag, extra_flag])
        order = np.lexsort((np.arange(len(pos)), pos))
        mapped = _encode(0, pos[order], flag[order], rnames[order],
                         seq[order], qual[order], next_pos[order],
                         tlen[order], True)
        # unmapped pairs: mate 1 then mate 2, as sequenced
        un = np.flatnonzero(unmapped)
        useq = np.stack([fields[0][1][un], fields[1][1][un]], 1)
        uqual = np.stack([fields[0][2][un], fields[1][2][un]], 1)
        uflag = np.tile([0x1 | 0x4 | 0x8 | 0x40, 0x1 | 0x4 | 0x8 | 0x80],
                        len(un))
        unm = _encode(-1, -1, uflag, np.repeat(names[un], 2, axis=0),
                      useq.reshape(-1, L), uqual.reshape(-1, L), -1, 0, False)
        path = os.path.join(out_dir, f"{sample}.bam")
        _write_bgzf(path, np.concatenate([header, mapped.reshape(-1),
                                          unm.reshape(-1)]),
                    threads or os.cpu_count() or 1)
        paths[sample] = path
    return paths


def sites_spanned(mate1_fastq: str, sites: np.ndarray, read_len: int = 150):
    """The spiked sites that a read of a kept pair covers, from the pair
    names of a Mutations.Mate1.fastq."""
    covered = np.zeros(len(sites), bool)
    with open(mate1_fastq) as f:
        for i, line in enumerate(f):
            if i % 4:
                continue
            _, _, start, frag = line[1:].split()[0].split("_")
            s, fr = int(start), int(frag)
            for lo in (s, s + fr - read_len):
                covered |= (sites >= lo) & (sites < lo + read_len)
    return sites[covered]
