"""The comparison that decides `correct`: what a job wrote against what the
plain reference works out from the same reads.

A job's outputs are read from its workdir under the program's file names
(RUFUS's own: ``<stub>.Jhash.histo``, the sample's table, the HashList
and ``Mutations.Mate1/2.fastq``). A sample's table is ``<stub>.table.flat``
where the job spilled its tables to the host (the flat layout, read by
``read_flat``), and ``<stub>.table.npz`` otherwise; a job that wrote both
for one sample, or a flat file that is malformed or cut short, reads as an
empty table. Each compared number counts what differs, so a sound job
reads 0 on the exact ones:

- ``tables_off``: over the three samples, keys in one table and not the
  other, and shared keys whose counts differ;
- ``histo_off``: histogram rows that differ;
- ``hashlist_off``: HashList lines in one and not the other, and 1 more
  if the same lines come in another order;
- ``pairs_off``: kept pairs in one and not the other (a pair is its name
  and both mates' bases and qualities), and 1 more if the same pairs come
  in another order where the order is fixed (FASTQ input; a BAM's pair
  stream has its own order and mate assignment, so there a pair's mates
  are compared as a set and the pairs as a set).

A job that runs past the filter also writes the back end's input and its
calls, compared where the traffic's limits name them:

- ``aligned_reads_off``: the read alignment's SAM
  (``<stub>.Mutations.fastq.sam``, what assembly reads) against the kept
  pairs: each primary record as (name, bases and qualities as sequenced),
  records in one and not the other, every kept mate once (as a set, so
  that it holds for a BAM's pair stream too);
- ``vcf_wrong_rows``: rows of RUFUS's calls (``<stub>.V2.overlap.
  hashcount.fastq.bam.FINAL.vcf``) that are not a spiked de novo site
  (1-based) with the child's base, and each repeat of one that is;
- ``vcf_missed_sites``: truth sites that no row calls so;
- ``vcf_wrong_genotypes``: rows that call a truth site but not as the
  truth holds it: the child heterozygous (its GT holds both alleles 0 and
  1, at any copy number) and each parent homozygous reference (only 0).

``same`` tells whether two jobs' outputs are equal, so that the harness
keeps one copy of each distinct set and compares it once.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch

from . import kmers

SAMPLES = ("child", "mother", "father")
ALIGNED_SAM = ".Mutations.fastq.sam"
FINAL_VCF = ".V2.overlap.hashcount.fastq.bam.FINAL.vcf"
_COMPLEMENT = str.maketrans("ACGTN", "TGCAN")
FLAT_MAGIC = b"RTK2"
FLAT_HEAD = 8 + 16  # the magic, 4 pad bytes, <u8 k and n


def _empty_table() -> tuple:
    return np.empty(0, np.uint64), np.empty(0, np.int64)


def stubs(inputs: dict) -> dict:
    """sample -> the program's file stub: the first input file's name and
    ".generator" (RufusConfig.subject_stub)."""
    return {s: os.path.basename(inputs[s][0]) + ".generator" for s in SAMPLES}


def _pairs(names, s1, q1, s2, q2, idx) -> list:
    return [(names[i].tobytes().decode(), s1[i].tobytes().decode(),
             q1[i].tobytes().decode(), s2[i].tobytes().decode(),
             q2[i].tobytes().decode()) for i in idx]


class Expected:
    """The reference's outputs for one trio under one configuration
    (`rufus`: the RufusConfig settings; `route`: min_cov and the HashList's
    upper depth), computed on `device` in blocks of rows. `ident` is the
    key identity (kmers.fingerprint for the control)."""

    def __init__(self, trio, rufus: dict, route: dict, device, ident=None):
        k = rufus["k"]
        dev = torch.device(device)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        self.tables = {}
        for s in SAMPLES:
            smp = trio.samples[s]
            lower = rufus["subject_low_k" if s == "child" else "par_low_k"]
            self.tables[s] = kmers.count_table([t(smp.seq1), t(smp.seq2)], k,
                                               lower, ident)
        hk, hc = kmers.hashlist(self.tables["child"],
                                [self.tables["mother"], self.tables["father"]],
                                rufus["merge_min"], route["min_cov"],
                                route["max_hash_depth"], ident)
        c = trio.samples["child"]
        keep = kmers.filter_pairs(t(c.seq1), t(c.qual1), t(c.seq2), t(c.qual2),
                                  hk, k, rufus["filter_min_q"],
                                  rufus["filter_k_threshold"], ident)
        self.hashlist = [f"{s} {int(n)}" for s, n in
                         zip(kmers.key_strings(hk, k), hc.cpu().tolist())]
        self.hashlist_keys = int(hk.numel())
        self.kept = np.flatnonzero(keep.cpu().numpy())
        self.truth = truth(trio)
        self.outputs = {
            "tables": {s: (u.cpu().numpy().astype(np.uint64),
                           n.cpu().numpy()) for s, (u, n) in
                       self.tables.items()},
            "histos": {s: kmers.histo(n) for s, (_, n) in self.tables.items()},
            "hashlist": self.hashlist,
            "pairs": _pairs(c.names, c.seq1, c.qual1, c.seq2, c.qual2,
                            self.kept)}


def truth(trio) -> list:
    """The spiked de novo sites as VCF rows: (contig, 1-based position,
    the parents' base, the child's base)."""
    return [(trio.ref_name, int(p) + 1, chr(trio.genome[p]), chr(a))
            for p, a in zip(trio.sites, trio.alt)]


def read_vcf(path: str) -> list:
    """A plain VCF's rows as (contig, position, REF, ALT, the samples' GT
    fields), in file order; a missing file reads as no rows."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    return [(f[0], int(f[1]), f[3], f[4],
             tuple(g.split(":")[0] for g in f[9:]))
            for f in (line.split("\t") for line in lines
                      if line and line[0] != "#")]


def _denovo_gt(gts: tuple) -> bool:
    """Whether the GTs (child, then the parents) are a de novo's: the
    child holds both alleles 0 and 1, each parent 0 alone."""
    alleles = [set(g.replace("|", "/").split("/")) for g in gts]
    return (len(alleles) == 3 and {"0", "1"} <= alleles[0]
            and all(a == {"0"} for a in alleles[1:]))


def call_numbers(rows: list, sites: list) -> dict:
    """vcf_wrong_rows, vcf_missed_sites and vcf_wrong_genotypes of VCF
    `rows` (as read_vcf gives them) against the truth `sites` (contig,
    position, REF, ALT)."""
    want = set(sites)
    seen = collections.Counter(r[:4] for r in rows)
    wrong = sum(n if r not in want else n - 1 for r, n in seen.items())
    return {"vcf_wrong_rows": wrong,
            "vcf_missed_sites": sum(1 for t in want if not seen[t]),
            "vcf_wrong_genotypes": sum(1 for r in rows if r[:4] in want
                                       and not _denovo_gt(r[4]))}


def read_sam(path: str) -> list:
    """A SAM's primary records (neither secondary nor supplementary) as
    (name, bases, qualities), the bases and qualities turned back to the
    read's own strand; a missing file reads as no records."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    out = []
    for line in lines:
        if not line or line[0] == "@":
            continue
        f = line.split("\t")
        flag, seq, qual = int(f[1]), f[9], f[10]
        if flag & 0x900:
            continue
        if flag & 0x10:
            seq, qual = seq.translate(_COMPLEMENT)[::-1], qual[::-1]
        out.append((f[0], seq, qual))
    return out


def _fastq_records(path: str) -> list:
    with open(path) as f:
        lines = f.read().split("\n")
    return [(lines[i][1:], lines[i + 1], lines[i + 3])
            for i in range(0, len(lines) - 3, 4)]


def read_flat(path: str) -> tuple:
    """A table in the program's flat layout as (keys uint64, counts int64),
    read into memory: the 4-byte magic ``RTK2`` and 4 pad bytes, ``<u8`` k
    and n, then n ``<u8`` keys and n ``<i8`` counts. A wrong magic, a short
    header or planes shorter than n read as an empty table."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < FLAT_HEAD or buf[:4] != FLAT_MAGIC:
        return _empty_table()
    n = int(np.frombuffer(buf, "<u8", 1, 16)[0])
    if len(buf) < FLAT_HEAD + 16 * n:
        return _empty_table()
    return (np.frombuffer(buf, "<u8", n, FLAT_HEAD).astype(np.uint64),
            np.frombuffer(buf, "<i8", n, FLAT_HEAD + 8 * n).astype(np.int64))


def read_table(wd: str, stub: str) -> tuple:
    """A sample's table from its workdir: ``<stub>.table.flat`` where the
    job wrote one, else ``<stub>.table.npz``; both at once, or neither,
    read as an empty table."""
    flat = os.path.join(wd, stub + ".table.flat")
    npz = os.path.join(wd, stub + ".table.npz")
    if os.path.exists(flat):
        return _empty_table() if os.path.exists(npz) else read_flat(flat)
    try:
        with np.load(npz) as z:
            return z["keys"].astype(np.uint64), z["counts"]
    except OSError:
        return _empty_table()


def read_outputs(wd: str, inputs: dict, k: int, min_cov: int) -> dict:
    """A job's outputs from its workdir, in Expected.outputs' form; a file
    that is missing reads as empty."""
    st = stubs(inputs)
    p = lambda name: os.path.join(wd, name)  # noqa: E731
    out = {"tables": {}, "histos": {}, "hashlist": [], "pairs": [],
           "aligned": read_sam(p(st["child"] + ALIGNED_SAM)),
           "vcf": read_vcf(p(st["child"] + FINAL_VCF))}
    for s in SAMPLES:
        out["tables"][s] = read_table(wd, st[s])
        try:
            rows = np.loadtxt(p(st[s] + ".Jhash.histo"), dtype=np.int64,
                              ndmin=2)
            out["histos"][s] = rows[:, 1] if rows.size else np.empty(0)
        except OSError:
            out["histos"][s] = np.empty(0, np.int64)
    hl = p(f"{st['child']}.k{k}_c{min_cov}.HashList")
    if os.path.exists(hl):
        with open(hl) as f:
            out["hashlist"] = f.read().splitlines()
    m1 = p(st["child"] + ".Mutations.Mate1.fastq")
    m2 = p(st["child"] + ".Mutations.Mate2.fastq")
    if os.path.exists(m1) and os.path.exists(m2):
        out["pairs"] = [(a[0], a[1], a[2], b[1], b[2]) for a, b in
                        zip(_fastq_records(m1), _fastq_records(m2))]
    return out


def _multiset_off(got: list, want: list, ordered: bool) -> int:
    a, b = collections.Counter(got), collections.Counter(want)
    off = sum(((a - b) + (b - a)).values())
    return off + int(ordered and off == 0 and got != want)


def _table_off(got, want) -> int:
    gk, gc = got
    wk, wc = want
    if len(gk) == len(wk) and np.array_equal(gk, wk) and np.array_equal(gc,
                                                                         wc):
        return 0
    common, gi, wi = np.intersect1d(gk, wk, assume_unique=True,
                                    return_indices=True)
    return (len(gk) + len(wk) - 2 * len(common)
            + int(np.count_nonzero(gc[gi] != wc[wi])))


def _histo_off(got, want) -> int:
    n = max(len(got), len(want))
    g = np.zeros(n, np.int64)
    w = np.zeros(n, np.int64)
    g[:len(got)] = got
    w[:len(want)] = want
    return int(np.count_nonzero(g != w)) + abs(len(got) - len(want))


def numbers(got: dict, exp: Expected, ordered_pairs: bool) -> dict:
    """The compared numbers of one set of outputs against the reference:
    the back end's too where `got` holds them (read_outputs' form; the
    control makes none). The caller keeps those its limits name."""
    want = exp.outputs
    out = {
        "tables_off": sum(_table_off(got["tables"][s], want["tables"][s])
                          for s in SAMPLES),
        "histo_off": sum(_histo_off(got["histos"][s], want["histos"][s])
                         for s in SAMPLES),
        "hashlist_off": _multiset_off(got["hashlist"], want["hashlist"], True),
    }
    if ordered_pairs:
        out["pairs_off"] = _multiset_off(got["pairs"], want["pairs"], True)
    else:
        norm = lambda ps: [(p[0], *sorted([p[1:3], p[3:5]]))  # noqa: E731
                           for p in ps]
        out["pairs_off"] = _multiset_off(norm(got["pairs"]),
                                         norm(want["pairs"]), False)
    if "vcf" in got:
        mates = [m for n, s1, q1, s2, q2 in want["pairs"]
                 for m in ((n, s1, q1), (n, s2, q2))]
        out["aligned_reads_off"] = _multiset_off(got["aligned"], mates,
                                                 False)
        out.update(call_numbers(got["vcf"], exp.truth))
    return out


def same(a: dict, b: dict) -> bool:
    """Whether two sets of outputs (read_outputs' form) are equal."""
    def eq(x, y):
        if isinstance(x, np.ndarray):
            return x.dtype == y.dtype and np.array_equal(x, y)
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(eq(x[n], y[n]) for n in x)
        if isinstance(x, tuple):
            return len(x) == len(y) and all(map(eq, x, y))
        return x == y
    return eq(a, b)
