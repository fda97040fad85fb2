"""The benchmark's trio generator: a frozen copy of the port's
``rufus_tpu_torch/synthetic.py`` (its read model and its FASTQ and BAM
layouts), drawing its arrays with torch on the run's device so that set-up
stays short. It imports nothing of the port, so a change to the port's
generator cannot move the yardstick.

A random genome; the child carries de novo SNVs on one haplotype (VAF
0.5), the parents carry the genome alone. Each sample gets `coverage`x of
read pairs from fragments of random length, read from both strands, with
substitution errors, low-quality bases and a few N. Read names carry where
a pair came from, ``p<pair>_<hap>_<start>_<frag>``. As in the port's
generator, each pair's haplotype, fragment length and start are drawn
independently, so coverage along the genome varies as in a sequencing run.

`make_trio` draws everything from one seed; `write_fastq` writes a sample's
pairs as two FASTQ files of fixed-width records; `write_bam` writes them as
one aligned, coordinate-sorted BAM, each read at its true position, as an
aligner leaves them: reverse-strand reads stored reverse-complemented with
0x10, a few pairs unmapped at the end of the file, and a few extra
secondary, duplicate and supplementary records that every input stream
drops.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

SAMPLES = ("child", "mother", "father")
BASES = b"ACGT"
NAME_W = (9, 1, 10, 4)  # digits of pair index, haplotype, start, fragment
NAME_LEN = 1 + sum(NAME_W) + len(NAME_W) - 1  # 'p' and three '_'
CHUNK = 1 << 18  # pairs drawn at a time

UNMAPPED_RATE = 0.005  # pairs left unmapped in a BAM
EXTRA_RATE = 0.001  # extra secondary/duplicate/supplementary records
BGZF_THREADS = 4  # a BAM's compressing threads, the same on every host


@dataclass
class Sample:
    """One sample's pairs on the host: names (n, NAME_LEN) and, for each
    mate, seq and qual (n, read_len) uint8 ASCII; where each pair came
    from (hap, start, frag) and whether mate 1 read the reverse strand."""

    names: np.ndarray
    seq1: np.ndarray
    qual1: np.ndarray
    seq2: np.ndarray
    qual2: np.ndarray
    start: np.ndarray
    frag: np.ndarray
    mate1_reverse: np.ndarray

    @property
    def pairs(self) -> int:
        return len(self.names)


@dataclass
class Trio:
    genome: np.ndarray  # (G,) uint8 ASCII, the parents' genome
    sites: np.ndarray  # sorted 0-based de novo positions
    alt: np.ndarray  # the child's base at each site, uint8 ASCII
    samples: dict  # name -> Sample
    read_len: int
    ref_name: str = "1"  # the reference FASTA's contig


def _digits(x: torch.Tensor, width: int) -> torch.Tensor:
    p = 10 ** torch.arange(width - 1, -1, -1, dtype=torch.int64,
                           device=x.device)
    return ((x[:, None] // p[None, :]) % 10 + 48).to(torch.uint8)


def _names(idx, hap, start, frag) -> torch.Tensor:
    n = idx.numel()
    cols = [torch.full((n, 1), ord("p"), dtype=torch.uint8, device=idx.device)]
    for i, (v, w) in enumerate(zip((idx, hap, start, frag), NAME_W)):
        if i:
            cols.append(torch.full((n, 1), ord("_"), dtype=torch.uint8,
                                   device=idx.device))
        cols.append(_digits(v.to(torch.int64), w))
    return torch.cat(cols, dim=1)


def _sample(g, haps, n_pairs, read_len, frag_mean, frag_sd, sub_rate,
            lowq_rate, n_rate) -> Sample:
    """One sample's pairs: each pair's haplotype, fragment length, start,
    strand and errors drawn independently, as the port's generator does."""
    dev = haps.device
    G = haps.shape[1]
    flat = haps.reshape(-1)
    lut = torch.tensor(list(BASES), dtype=torch.uint8, device=dev)
    cols = torch.arange(read_len, device=dev)
    hap_all = torch.randint(0, haps.shape[0], (n_pairs,), generator=g,
                            device=dev)
    frag_all = torch.clamp(torch.round(
        torch.randn(n_pairs, generator=g, device=dev, dtype=torch.float64)
        * frag_sd + frag_mean), read_len, 2 * frag_mean).to(torch.int64)
    start_all = (torch.rand(n_pairs, generator=g, device=dev,
                            dtype=torch.float64)
                 * (G - frag_all + 1)).to(torch.int64)
    parts = []
    for lo in range(0, n_pairs, CHUNK):
        hi = min(n_pairs, lo + CHUNK)
        hap, frag, start = hap_all[lo:hi], frag_all[lo:hi], start_all[lo:hi]
        base = hap * G
        fwd = flat[(base + start)[:, None] + cols]
        rev = 3 - flat[(base + start + frag - 1)[:, None] - cols]
        flip = torch.rand(hi - lo, generator=g, device=dev) < 0.5
        mates = []
        for r in (torch.where(flip[:, None], rev, fwd),
                  torch.where(flip[:, None], fwd, rev)):
            err = torch.rand(r.shape, generator=g, device=dev) < sub_rate
            shift = torch.randint(1, 4, r.shape, generator=g, device=dev,
                                  dtype=torch.uint8)
            r = torch.where(err, (r + shift) % 4, r)
            seq = lut[r.long()]
            nmask = torch.rand(r.shape, generator=g, device=dev) < n_rate
            seq = torch.where(nmask, torch.full_like(seq, ord("N")), seq)
            lowq = torch.rand(r.shape, generator=g, device=dev) < lowq_rate
            qual = torch.where(lowq, torch.full_like(seq, ord("#")),
                               torch.full_like(seq, ord("I")))
            mates += [seq, qual]
        idx = torch.arange(lo, hi, device=dev)
        parts.append([_names(idx, hap, start, frag), *mates, start, frag,
                      flip])
    host = [torch.cat([p[i] for p in parts]).cpu().numpy()
            for i in range(len(parts[0]))]
    return Sample(*host)


def make_trio(genome_bp: int, *, coverage: float = 30.0, read_len: int = 150,
              frag_mean: int = 400, frag_sd: int = 40, n_denovo: int = 100,
              sub_rate: float = 0.002, lowq_rate: float = 0.02,
              n_rate: float = 0.0005, seed: int = 0,
              device="cpu") -> Trio:
    """Draw a trio from `seed` with torch on `device`; the arrays come back
    on the host. The same seed and device give the same trio."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    genome = torch.randint(0, 4, (genome_bp,), generator=g, device=device,
                           dtype=torch.uint8)
    # de novo sites: at least 2 fragment lengths from the ends, 100 bp apart
    grid = torch.arange(2 * frag_mean, genome_bp - 2 * frag_mean, 100,
                        device=device)
    pick = torch.randperm(grid.numel(), generator=g, device=device)[:n_denovo]
    sites = torch.sort(grid[pick]).values
    mutant = genome.clone()
    mutant[sites] = (genome[sites] + torch.randint(
        1, 4, (n_denovo,), generator=g, device=device,
        dtype=torch.uint8)) % 4
    n_pairs = int(genome_bp * coverage / (2 * read_len))
    samples = {}
    for name, haps in (("child", (genome, mutant)), ("mother", (genome,)),
                       ("father", (genome,))):
        samples[name] = _sample(g, torch.stack(haps), n_pairs, read_len,
                                frag_mean, frag_sd, sub_rate, lowq_rate,
                                n_rate)
    lut = np.frombuffer(BASES, np.uint8)
    return Trio(genome=lut[genome.cpu().numpy()],
                sites=sites.cpu().numpy().astype(np.int64),
                alt=lut[mutant[sites].cpu().numpy()],
                samples=samples, read_len=read_len)


def fastq_records(names, mate: int, seq, qual) -> np.ndarray:
    """(n, width) uint8 FASTQ records: `@name mate`, seq, `+`, qual."""
    n = len(names)

    def col(s):
        return np.broadcast_to(np.frombuffer(s, np.uint8), (n, len(s)))

    return np.concatenate([col(b"@"), names, col(b" %d\n" % mate), seq,
                           col(b"\n+\n"), qual, col(b"\n")], axis=1)


def write_fastq(s: Sample, prefix: str) -> tuple:
    """`<prefix>.R1.fastq` and `<prefix>.R2.fastq`; returns their paths."""
    paths = (prefix + ".R1.fastq", prefix + ".R2.fastq")
    for path, mate, seq, qual in ((paths[0], 1, s.seq1, s.qual1),
                                  (paths[1], 2, s.seq2, s.qual2)):
        with open(path, "wb") as f:
            for lo in range(0, s.pairs, CHUNK):
                fastq_records(s.names[lo:lo + CHUNK], mate, seq[lo:lo + CHUNK],
                              qual[lo:lo + CHUNK]).tofile(f)
    return paths


# -- BAM ---------------------------------------------------------------------

REF_NAME = "1"  # polish keeps rows on (chr)?[1-9XY] contigs only
_SEQ_CODE = np.full(256, 15, np.uint8)  # SAMv1 4.2.3: "=ACMGRSVTWYHKDBN"
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _SEQ_CODE[_c] = _i
_COMP = np.arange(256, dtype=np.uint8)
_COMP[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN", np.uint8)

MAX_BLOCK = 0xFF00  # uncompressed bytes a BGZF block (htslib's cut)
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000"
                         "000000")


def _bgzf_block(data: bytes) -> bytes:
    """One BGZF block (SAMv1 4.1): a gzip member at level 6 whose BC extra
    subfield holds the block's size minus one."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    header = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                         66, 67, 2, len(comp) + 25)
    return header + comp + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                                       len(data) & 0xFFFFFFFF)


def _write_bgzf(path: str, data: np.ndarray, threads: int):
    view = memoryview(data)
    chunks = [view[i:i + MAX_BLOCK] for i in range(0, len(data), MAX_BLOCK)]
    with ThreadPoolExecutor(threads) as pool, open(path, "wb") as f:
        for block in pool.map(_bgzf_block, chunks):
            f.write(block)
        f.write(BGZF_EOF)


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    for shift, first in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        same = (beg >> shift) == (end >> shift)
        out = np.where(same, first + (beg >> shift), out)
    return out


def _encode(ref_id, pos, flag, names, seq, qual, next_pos, tlen, mapped):
    """BAM alignment blocks (block_size first) of reads of one length and
    one name width: mapped reads with one `<L>M` CIGAR, unmapped ones
    unplaced with none. -> (n, width) uint8."""
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


def write_bam(s: Sample, path: str, genome_bp: int, *, seed: int,
              threads: int = BGZF_THREADS) -> str:
    """The sample's pairs as a coordinate-sorted BAM on one reference
    ("1", the genome's length), each read at its true position with a
    `<L>M` CIGAR. Flags 0x1|0x2|0x40/0x80, 0x10 on the reverse-strand read
    (stored reverse-complemented with reversed quals) and 0x20 on its mate.
    About UNMAPPED_RATE of the pairs are unmapped (0x4|0x8, stored as read)
    at the end of the file; about EXTRA_RATE extra records repeat mapped
    reads flagged secondary, duplicate or supplementary. Those two draws
    come from `seed`."""
    rng = np.random.default_rng(seed)
    L, n = s.seq1.shape[1], s.pairs
    text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{REF_NAME}\tLN:{genome_bp}\n"
    name_b = REF_NAME.encode() + b"\0"
    header = np.frombuffer(
        b"BAM\1" + np.int32(len(text)).tobytes() + text.encode()
        + np.int32(1).tobytes() + np.int32(len(name_b)).tobytes() + name_b
        + np.int32(genome_bp).tobytes(), np.uint8)
    unmapped = rng.random(n) < UNMAPPED_RATE
    mates = []
    for m, (seq, qual) in enumerate(((s.seq1, s.qual1), (s.seq2, s.qual2))):
        rev = s.mate1_reverse if m == 0 else ~s.mate1_reverse
        pos = np.where(rev, s.start + s.frag - L, s.start)
        flag = (0x1 | 0x2 | (0x40 if m == 0 else 0x80)
                | np.where(rev, 0x10, 0x20))
        seq = np.where(rev[:, None], _COMP[seq[:, ::-1]], seq)
        qual = np.where(rev[:, None], qual[:, ::-1], qual)
        tlen = np.where(rev, -s.frag, s.frag)
        mates.append((pos, flag, seq, qual, tlen))
    keep = ~unmapped
    pos, flag, seq, qual, tlen = (
        np.concatenate([mates[0][i][keep], mates[1][i][keep]])
        for i in range(5))
    next_pos = np.concatenate([mates[1][0][keep], mates[0][0][keep]])
    rnames = np.concatenate([s.names[keep], s.names[keep]])
    extra = np.flatnonzero(rng.random(len(pos)) < EXTRA_RATE)
    extra_flag = flag[extra] | rng.choice([0x100, 0x400, 0x800], len(extra))
    pos, next_pos, seq, qual, tlen, rnames = (
        np.concatenate([a, a[extra]])
        for a in (pos, next_pos, seq, qual, tlen, rnames))
    flag = np.concatenate([flag, extra_flag])
    order = np.lexsort((np.arange(len(pos)), pos))
    mapped = _encode(0, pos[order], flag[order], rnames[order], seq[order],
                     qual[order], next_pos[order], tlen[order], True)
    # unmapped pairs: mate 1 then mate 2, as sequenced
    un = np.flatnonzero(unmapped)
    useq = np.stack([s.seq1[un], s.seq2[un]], 1).reshape(-1, L)
    uqual = np.stack([s.qual1[un], s.qual2[un]], 1).reshape(-1, L)
    uflag = np.tile([0x1 | 0x4 | 0x8 | 0x40, 0x1 | 0x4 | 0x8 | 0x80], len(un))
    unm = _encode(-1, -1, uflag, np.repeat(s.names[un], 2, axis=0), useq,
                  uqual, -1, 0, False)
    _write_bgzf(path, np.concatenate([header, mapped.reshape(-1),
                                      unm.reshape(-1)]),
                threads)
    return path


def write_fasta(genome: np.ndarray, path: str) -> str:
    """The reference FASTA: one contig, REF_NAME, on one line."""
    with open(path, "wb") as f:
        f.write(b">" + REF_NAME.encode() + b"\n" + genome.tobytes() + b"\n")
    return path
