"""Interpret, polish and the shims of the port against the JAX package's,
module by module. Tolerance: none; every case feeds the same inputs (made
from a seed with numpy, or crafted) to both packages and compares the
outputs exactly, the floats by repr.

run_interpret runs on the SV scenarios of tests/sv_scenarios.py (their
inputs are made with the JAX package's aligner): the eight cleanup kinds
must also equal tests/golden/sv_<kind>.call, the rows the reference
RUFUS.interpret printed on the same inputs; "del" and "dup" have no golden
that fits the synthetic reference (sv_{del,dup}.call come from the v37
test reference), so they are held to the JAX package alone.
"""

import gzip
import os
import shutil

import numpy as np
import pytest

from rufus_tpu.interpret import driver as jdriver
from rufus_tpu.interpret import model as jmodel
from rufus_tpu.interpret import samread as jsamread
from rufus_tpu.pipeline import polish as jpolish
from rufus_tpu.utils import shims as jshims
from rufus_tpu_torch.interpret import driver as pdriver
from rufus_tpu_torch.interpret import model as pmodel
from rufus_tpu_torch.interpret import samread as psamread
from rufus_tpu_torch.pipeline import polish as ppolish
from rufus_tpu_torch.utils import shims as pshims
from sv_scenarios import build_scenario

GOLD = os.path.join(os.path.dirname(__file__), "golden")
CLEANUP_KINDS = ["trans", "inv", "mob", "lastditch", "copypaste",
                 "largeins", "orphanmob", "mobglocal"]


def _seq(rng, n, alphabet="ACGTN-"):
    p = np.array([0.22, 0.22, 0.22, 0.22, 0.06, 0.06])[:len(alphabet)]
    return "".join(rng.choice(list(alphabet), n, p=p / p.sum()))


# -- samread ----------------------------------------------------------------

@pytest.mark.parametrize("seed,k", [(0, 7), (1, 25), (2, 31), (3, 5)])
def test_hash_columns_and_get_hash_match_jax(seed, k):
    """hash_columns and get_hash on random sequences with N and gap
    columns, the tails shorter than k included; Context.h2l alike."""
    rng = np.random.default_rng(seed)
    for n in (0, 1, k - 1, k, 3 * k + 5, 200):
        seq = _seq(rng, n)
        ps, pk, pok = psamread.hash_columns(seq, k)
        js, jk, jok = jsamread.hash_columns(seq, k)
        assert ps == js
        np.testing.assert_array_equal(pk, jk)
        np.testing.assert_array_equal(pok, jok)
        for j in range(n + 2):
            assert psamread.get_hash(seq, j, k) == jsamread.get_hash(seq, j, k)
        pctx = psamread.Context.__new__(psamread.Context)
        jctx = jsamread.Context.__new__(jsamread.Context)
        for s in ps:
            assert pctx.h2l(s) == jctx.h2l(s)


@pytest.mark.parametrize("seed", [0, 1])
def test_pull_table_matches_jax(seed):
    """PullTable.get_many on random packed keys (half present, the largest
    uint64 and zero among them), and on an empty table."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 62, 500, dtype=np.uint64).tolist()
    d = {k: int(v) for k, v in zip(keys + [0, (1 << 64) - 1],
                                   rng.integers(-5, 1000, 502))}
    q = np.array(keys[::2] + rng.integers(0, 1 << 62, 250, dtype=np.uint64)
                 .tolist() + [0, (1 << 64) - 1], dtype=np.uint64)
    for table in (d, {}):
        pc, pf = psamread.PullTable(table).get_many(q)
        jc, jf = jsamread.PullTable(table).get_many(q)
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pf, jf)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entropy_and_compress_var_match_jax(seed):
    """entropy_multi and compress_var on random strings of the expanded
    cigar alphabet (runs of 1-6 letters, so repeats fold)."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        line = "".join(c * int(n) for c, n in zip(
            rng.choice(list("MXIDSYR"), 12), rng.integers(1, 7, 12)))
        start = int(rng.integers(0, 100_000))
        assert psamread.compress_var(line, start) == \
            jsamread.compress_var(line, start)
        s = _seq(rng, int(rng.integers(0, 60)), "ACGT")
        for size in (1, 2, 3, 4):
            assert repr(psamread.entropy_multi(s, size)) == \
                repr(jsamread.entropy_multi(s, size))


# -- model --------------------------------------------------------------------

def _dist(tmp_path, kind):
    path = str(tmp_path / f"{kind}.dist")
    if kind == "dist":
        with gzip.open(os.path.join(GOLD, "Child.Jhash.histo.7.7.dist.gz"),
                       "rb") as f, open(path, "wb") as o:
            shutil.copyfileobj(f, o)
    elif kind == "exome":
        with open(path, "w") as f:
            f.write("exome\n")
    return path  # "missing": no file, as an exome run leaves it


@pytest.mark.parametrize("kind", ["dist", "exome", "missing"])
def test_depth_model_and_genotyper_match_jax(tmp_path, kind):
    """DepthModel.load (and process_high_low where the run calls it) on the
    golden .dist, an exome marker and a missing file: every field; then
    baysean_genotyper and parse_genotype on a seeded grid of k-mer counts
    and alleles."""
    path = _dist(tmp_path, kind)
    pm, jm = pmodel.DepthModel.load(path), jmodel.DepthModel.load(path)
    assert repr(vars(pm)) == repr(vars(jm))
    if kind == "dist":
        assert pm.dist and not pm.is_exome
        pm.process_high_low()
        jm.process_high_low()
        assert repr(vars(pm)) == repr(vars(jm))
    rng = np.random.default_rng(7)
    for _ in range(200):
        n = int(rng.integers(0, 12))
        top = int(rng.choice([5, 60, 400, 5000]))
        counts = rng.integers(0, top, n).tolist()
        var = str(rng.choice(["1", "2", "A", "1/0"]))
        assert pmodel.baysean_genotyper(pm, counts, var) == \
            jmodel.baysean_genotyper(jm, counts, var)
        alt, ref = (_seq(rng, int(rng.integers(0, 4)), "ACGT")
                    for _ in range(2))
        assert pmodel.parse_genotype(alt, ref) == \
            jmodel.parse_genotype(alt, ref)


# -- driver loaders -----------------------------------------------------------

@pytest.mark.parametrize("layout", ["2col_tab", "2col_space", "4col_tab",
                                    "4col_space", "empty"])
def test_load_hashlist_matches_jax(tmp_path, layout):
    """load_hashlist on 2- and 4-column files, tab- or space-separated
    (the 2-column form adds the reverse complement of the first line
    alone), in insertion order; and _load_counts_file on the same k-mers."""
    rng = np.random.default_rng(11)
    kmers = [_seq(rng, 25, "ACGT") for _ in range(40)]
    kmers += kmers[:3]  # repeats: setdefault keeps the first count
    counts = rng.integers(1, 200, len(kmers)).tolist()
    sep = "\t" if layout.endswith("tab") else " "
    path = tmp_path / "t.HashList"
    with open(path, "w") as f:
        for s, c in zip(kmers, counts):
            if layout.startswith("2col"):
                f.write(f"{s}{sep}{c}\n")
            elif layout.startswith("4col"):
                f.write(f"x{sep}0{sep}{c}{sep}{s}\n")
    pm, pk = pdriver.load_hashlist(str(path))
    jm, jk = jdriver.load_hashlist(str(path))
    assert pk == jk and list(pm.items()) == list(jm.items())
    tab = tmp_path / "tab"
    tab.write_text("".join(f"{s} {c}\n" for s, c in zip(kmers, counts))
                   + "short\n")
    h2l = psamread.Context.__new__(psamread.Context).h2l
    got, want = {}, {}
    pdriver._load_counts_file(str(tab), got, h2l)
    jdriver._load_counts_file(str(tab), want, h2l)
    assert list(got.items()) == list(want.items())


def test_load_mob_sam_matches_jax(tmp_path):
    """load_mob_sam keeps each contig's best-AS record on an element, not
    unmapped and not a single repeated base; a missing file is empty."""
    sam = tmp_path / "MOB.sam"
    rows = [("c1", 0, "L1HS", "10M5S", "ACGTACGTACGTAAA", 30),
            ("c1", 16, "L1HS", "15M", "ACGTACGTACGTAAC", 44),
            ("c2", 4, "*", "*", "ACGT", 0),
            ("c3", 0, "ALU", "8M", "AAAAAAAA", 50),
            ("c4", 0, "ALU", "4S4M", "ACGTTGCA", 12)]
    with open(sam, "w") as f:
        f.write("@HD\tVN:1.6\n@SQ\tSN:L1HS\tLN:6000\n")
        for n, fl, ch, cig, seq, AS in rows:
            f.write(f"{n}\t{fl}\t{ch}\t1\t60\t{cig}\t*\t0\t0\t{seq}\t"
                    f"{'I' * len(seq)}\tAS:i:{AS}\tNM:i:0\n")
        f.write("short\tline\n")
    for path in (str(sam), str(tmp_path / "none.sam")):
        got, want = pdriver.load_mob_sam(path), jdriver.load_mob_sam(path)
        assert list(got) == list(want)
        assert [vars(m) for m in got.values()] == \
            [vars(m) for m in want.values()]


# -- run_interpret on the SV scenarios ------------------------------------------

def _interpret(run, tmp_path, kind, scenario, dist, name):
    """One package's run_interpret on a scenario, its outputs (the .vcf,
    .vcf.bed and the side files in Intermediates/) moved to `name`."""
    contigs, lines, w, par_alt, par_ref = scenario

    class RefWrap:
        def __init__(self, c):
            self.seqs = c

        def contig_array(self, n):
            return self.seqs[n]

    out = tmp_path / "out"
    out.mkdir()
    vcf = run(lines, RefWrap(contigs), dist, w("t.HashList"),
              str(out / "ours.generator.V2.bam"), par_alt, par_ref,
              w("sample.tab"), w("ref.sample.tab"), w("RepRefHash"),
              w("MOB.sam"), file_date=1700000000)
    assert os.path.dirname(vcf) == str(out)
    os.rename(out, tmp_path / name)
    return tmp_path / name


@pytest.mark.parametrize("kind", CLEANUP_KINDS + ["del", "dup"])
def test_run_interpret_matches_jax_and_goldens(tmp_path, kind):
    dist = _dist(tmp_path, "dist")
    scenario = build_scenario(tmp_path, kind)
    port = _interpret(pdriver.run_interpret, tmp_path, kind, scenario, dist,
                      "port")
    jax = _interpret(jdriver.run_interpret, tmp_path, kind, scenario, dist,
                     "jax")
    names = sorted(os.path.relpath(os.path.join(r, n), port)
                   for r, _, ns in os.walk(port) for n in ns)
    assert names == sorted(os.path.relpath(os.path.join(r, n), jax)
                           for r, _, ns in os.walk(jax) for n in ns)
    assert len(names) == 8  # .vcf, .vcf.bed and six side files
    for n in names:
        assert (port / n).read_bytes() == (jax / n).read_bytes(), n
    with open(port / "ours.generator.V2.bam.vcf") as f:
        rows = [line for line in f if not line.startswith("#")]
    assert rows
    if kind in CLEANUP_KINDS:
        with open(os.path.join(GOLD, f"sv_{kind}.call")) as f:
            assert rows == list(f)


# -- polish and shims ---------------------------------------------------------

_CHROMS = ["1", "2", "10", "22", "chr1", "chr2", "chr10", "X", "chrX", "Y",
           "chrY", "MT", "chrM", "GL000192.1", "syn", "chrUn_gl000220",
           "0", "11_random"]


def _vcf_lines(seed, n=300):
    """A VCF of crafted rows: main and other contigs, chr prefixes, IDs
    with DeNovo, Mosaic or neither, PASS or other filters, and runs of rows
    at one position whose REF/ALT letters differ (equal under perl's
    numeric ==, so collapsed)."""
    rng = np.random.default_rng(seed)
    out = ["##fileformat=VCFv4.1\n", "##fileDate=1700000000\n",
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tchild\n"]
    for i in range(n):
        chrom = str(rng.choice(_CHROMS))
        pos = int(rng.integers(1, 3000))
        ident = str(rng.choice(["X-DeNovo", "X-Mosaic", "X-Inherited",
                                "1D-DeNovo", "MOB-3-44-DeNovo", "."]))
        filt = str(rng.choice(["PASS", ".", "PLC", "PASS;SB", "LCH"]))
        for _ in range(int(rng.choice([1, 1, 1, 2, 3]))):
            ref, alt = (str(rng.choice(list("ACGT"))) for _ in range(2))
            out.append(f"{chrom}\t{pos}\t{ident}\t{ref}\t{alt}\t100\t{filt}"
                       f"\tRN=c{i}\tGT\t0/1\n")
    out.insert(int(rng.integers(3, len(out))), "1\t5\tX-DeNovo\t12\t7\t1\t"
               "PASS\t.\tGT\t0/1\n")  # numeric REF/ALT
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polish_matches_jax(tmp_path, seed):
    """sort (-k1,1V -k2,2n), vilter_autosome_only in both modes,
    colaps_duplicate_calls, and polish_vcf on a file."""
    lines = _vcf_lines(seed)
    srt = ppolish.sort_vcf_lines(list(lines))
    assert srt == jpolish.sort_vcf_lines(list(lines))
    for mosaic in (False, True):
        kept = ppolish.vilter_autosome_only(srt, mosaic)
        assert kept == jpolish.vilter_autosome_only(srt, mosaic)
        assert 3 < len(kept) < len(srt)
        col = ppolish.colaps_duplicate_calls(kept)
        assert col == jpolish.colaps_duplicate_calls(kept)
        assert len(col) < len(kept)
        src = tmp_path / "in.vcf"
        src.write_text("".join(lines))
        a, b = tmp_path / "port.vcf", tmp_path / "jax.vcf"
        ppolish.polish_vcf(str(src), str(a), with_mosaic=mosaic)
        jpolish.polish_vcf(str(src), str(b), with_mosaic=mosaic)
        assert a.read_bytes() == b.read_bytes() == "".join(col).encode()


def test_shims_match_jax():
    """fastq_to_sam, sam_to_fastq (its length guard) and the multi-line
    FASTA -> one-line FASTQ shim, headers with and without len=/reads=."""
    rng = np.random.default_rng(5)
    fq = []
    for i in range(20):
        s = _seq(rng, int(rng.integers(10, 60)), "ACGTN")
        fq += [f"@r{i} extra words\n", s + "\n", "+\n", "I" * len(s) + "\n"]
    assert list(pshims.fastq_to_sam(fq)) == list(jshims.fastq_to_sam(fq))
    sam = ["@HD\tVN:1.6\n"] + [l + "\n" for l in jshims.fastq_to_sam(fq)]
    sam.append("short\t0\n")
    for min_len in (0, 25, 40):
        assert list(pshims.sam_to_fastq(sam, min_len)) == \
            list(jshims.sam_to_fastq(sam, min_len))
    fasta = []
    for i in range(6):
        head = [f">tig{i} len={i * 10} reads={i}", f">tig{i}",
                f">tig{i} len={i}", f">tig{i} cov=3 reads"][i % 4]
        fasta.append(head + "\n")
        s = _seq(rng, int(rng.integers(0, 150)), "ACGT")
        fasta += [s[j:j + 60] + "\n" for j in range(0, len(s), 60)]
    for src in (fasta, [], fasta[:1]):
        assert list(pshims.multiline_fasta_to_singleline_fastq(src)) == \
            list(jshims.multiline_fasta_to_singleline_fastq(src))
