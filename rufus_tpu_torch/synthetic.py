"""A synthetic trio as paired FASTQ, made from a seed.

A random genome; the child carries de novo SNVs on one haplotype (VAF
0.5), the parents carry the genome alone. Each sample gets `coverage`x of
read pairs from fragments of random length, read from both strands, with
substitution errors, low-quality bases and a few N. Records have fixed
widths and are written with numpy in chunks.

Read names carry where a pair came from, `p<pair>_<hap>_<start>_<frag>`
(hap 1 holds the de novo SNVs), so a caller can tell which spiked sites a
set of kept pairs spans (`sites_spanned`).
"""

from __future__ import annotations

import os

import numpy as np

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
    G = len(haps[0])
    comp = np.array([3, 2, 1, 0], np.uint8)
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


def write_trio(out_dir: str, *, genome_bp: int, coverage: float = 30.0,
               read_len: int = 150, frag_mean: int = 400, frag_sd: int = 40,
               n_denovo: int = 100, sub_rate: float = 0.002,
               lowq_rate: float = 0.02, n_rate: float = 0.0005,
               seed: int = 0) -> dict:
    """Write child/mother/father R1 + R2 FASTQ into out_dir.

    Returns {"child": (r1, r2), "mother": ..., "father": ..., "sites":
    sorted de novo positions, "pairs": pairs per sample}."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_bp).astype(np.uint8)
    # de novo sites: at least 2 fragment lengths from the ends, 100 bp apart
    grid = np.arange(2 * frag_mean, genome_bp - 2 * frag_mean, 100)
    sites = np.sort(rng.choice(grid, n_denovo, replace=False))
    mutant = genome.copy()
    mutant[sites] = (genome[sites] + rng.integers(1, 4, n_denovo)) % 4
    n_pairs = int(genome_bp * coverage / (2 * read_len))
    out = {"sites": sites, "pairs": n_pairs}
    for name, haps in (("child", (genome, mutant)), ("mother", (genome,)),
                       ("father", (genome,))):
        paths = tuple(os.path.join(out_dir, f"{name}.R{m}.fastq")
                      for m in (1, 2))
        with open(paths[0], "wb") as f1, open(paths[1], "wb") as f2:
            _sample(f1, f2, rng, haps, n_pairs, read_len, frag_mean, frag_sd,
                    sub_rate, lowq_rate, n_rate)
        out[name] = paths
    return out


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
