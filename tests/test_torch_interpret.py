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


def _write_dist(path, rows, head=("3", "4", "17053", "25", "1\t2\t3", "27.0"),
                newline="\n"):
    """A .dist: ModelDist's six header lines, then the rows as given."""
    with open(path, "w", newline="") as f:
        f.write(newline.join(list(head) + list(rows)))


def _same_load(path):
    """DepthModel.load then, unless exome, process_high_low in both
    packages: every field equal, or the same exception."""
    out = []
    for mod in (pmodel, jmodel):
        try:
            m = mod.DepthModel.load(path)
            if m.dist and not m.is_exome:
                m.process_high_low()
            out.append(repr(vars(m)))
        except (ValueError, IndexError) as e:
            out.append(f"{type(e).__name__}: {e}")
    if out[0] != out[1]:  # shown where they part, not as a diff of 90 MB
        at = next((i for i, (a, b) in enumerate(zip(*out)) if a != b),
                  min(map(len, out)))
        pytest.fail(f"port {out[0][max(at - 60, 0):at + 60]!r}\n"
                    f"jax  {out[1][max(at - 60, 0):at + 60]!r}")
    return out[0]


def test_depth_model_full_size_matches_jax(tmp_path):
    """A .dist of the full traffic's size (10,001 rows of 448 columns, most
    fields "0", the rest in ModelDist's %g and other float spellings, each
    row tab-ended) and its trailing tab-led row: load and high/low."""
    rng = np.random.default_rng(3)
    vals = rng.random((10001, 448)) ** 8
    vals[rng.random(vals.shape) < 0.9] = 0.0
    fmt = rng.integers(0, 3, vals.shape)
    rows = []
    for i in range(10001):
        cells = ["0" if v == 0 else (f"{v:g}", repr(v), f"{v:.3e}")[f]
                 for v, f in zip(vals[i].tolist(), fmt[i].tolist())]
        rows.append(f"{i}\t" + "\t".join(cells) + "\t")
    rows.append("\t" + rows[0].split("\t", 1)[1])
    path = str(tmp_path / "full.dist")
    _write_dist(path, rows + [""])
    got = _same_load(path)
    assert got.startswith("{'dist': [[") and "'limits': [(" in got
    # 448 columns of values and the empty field after each row's last tab
    assert len(pmodel.DepthModel.load(path).dist) == 449


_SPECIAL = ["inf", "-Infinity", "NaN", "+nan", "1_000.5", " 2.5 ", "1e400",
            "4.9e-324", "2.2250738585072014e-308", "1.7976931348623157e308",
            "0.1", "3.14159265358979323846264338327950288419716939937510",
            ".5", "5.", "-0", "+0.0e-0", "7E+2", "1e1_0", "9007199254740993",
            "123456789012345678901234567890e-40", "0.30000000000000004",
            "1e23", "8.98846567431158e307", "\x0b3\x0c", "00012.50"]


@pytest.mark.parametrize("kind", [
    "empty_fields", "tab_led_rows", "special_floats", "crlf", "one_column",
    "no_columns", "ignored_beyond", "bad_first_row", "bad_later_row",
    "bad_spelling", "short_file"])
def test_depth_model_quirks_match_jax(tmp_path, kind):
    """DepthModel.load and process_high_low on crafted .dist files: empty
    fields and rows of other lengths, tab-led rows, float() spellings,
    CRLF line ends, one or no column, fields past the columns (never
    parsed, so never an error), bad fields in the first and a later row,
    and a file too short to hold a data row: the same fields or the same
    error in both packages."""
    rng = np.random.default_rng(len(kind))
    pick = lambda n: [str(v) for v in rng.random(n).round(4)]  # noqa: E731
    rows = ["0\t" + "\t".join(pick(6)) + "\t"]
    rows += [f"{i}\t" + "\t".join(pick(6)) + "\t" for i in range(1, 40)]
    newline = "\n"
    if kind == "empty_fields":
        rows[3] = "3\t\t\t0.5\t\t"
        rows[5] = "5\t0.25"
        rows[7] = ""
        rows[9] = "9\t1\t2\t3\t4\t5\t6\t7\t8\t9\t10"
    elif kind == "tab_led_rows":
        rows += ["\t" + rows[0].split("\t", 1)[1]] * 2
    elif kind == "special_floats":
        for i, v in enumerate(_SPECIAL):
            rows[1 + i] = f"{i}\t{v}\t{v}\t0\t{v}\t1\t{v}\t"
    elif kind == "crlf":
        newline = "\r\n"
    elif kind == "one_column":
        rows = [r.split("\t")[0] + "\t" + r.split("\t")[1] for r in rows]
    elif kind == "no_columns":
        rows = [str(i) for i in range(40)]
    elif kind == "ignored_beyond":
        rows[4] += "\tnot-a-number\t\tx"
    elif kind == "bad_first_row":
        rows[0] = "0\t0.5\t\t1\t"
    elif kind == "bad_later_row":
        rows[6] = "6\t0.5\t1.2.3\t1\t"
    elif kind == "bad_spelling":
        rows[6] = "6\t0x1p3\t1\t"  # strtod reads hex; float() does not
    elif kind == "short_file":
        rows = []
    path = str(tmp_path / "q.dist")
    _write_dist(path, rows, newline=newline)
    got = _same_load(path)
    bad = kind.startswith("bad_") or kind == "short_file"
    assert got.startswith(("ValueError", "IndexError")) == bad


@pytest.mark.parametrize("kind", ["compensated", "ties_and_zeros",
                                  "nonfinite"])
def test_high_low_matches_jax(kind):
    """process_high_low on columns set directly. "compensated": the mass
    of a hundred 1e-14 values that a plain float sum loses and Python's
    sum() keeps decides where the 0.997 bound falls (a plain sum gives
    (0, 0) and (101, 101)); ties for the maximum (the first wins), zero
    sums, single and empty columns; infinities and NaN."""
    col = [997.0] + [1e-14] * 100 + [3.0]
    plain = 0.0
    for v in col:
        plain += v
    assert sum(col) != plain
    dist = {"compensated": [col, col[::-1], [0.0] * 5, col],
            "ties_and_zeros": [[0.0] * 7, [2.0, 5.0, 5.0, 1.0], [3.0], [],
                               [0.0, 1.0, 0.0, 1.0, 0.0], [1e-300] * 9],
            "nonfinite": [[1.0, float("inf"), 2.0], [float("nan"), 1.0, 3.0],
                          [1.0, float("nan"), 0.5, 4.0],
                          [float("-inf"), 1.0], [2.0, 1.0, 1.0, 1.0]]}[kind]
    pm, jm = pmodel.DepthModel(), jmodel.DepthModel()
    pm.dist, jm.dist = [list(d) for d in dist], [list(d) for d in dist]
    pm.process_high_low()
    jm.process_high_low()
    assert repr(vars(pm)) == repr(vars(jm))
    if kind == "compensated":
        assert pm.limits[:2] == [(0, 101), (0, 102)]


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
    h2l = jsamread.Context.__new__(jsamread.Context).h2l
    got, want = {}, {}
    pdriver._load_counts_file(str(tab), got)
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


_PULL_LINES = {
    "n_keys": ["ACGTNACGTACGTACGTACGTACGT 4", "acgtACGTnnACGT 7",
               "AC-GT.AC?GT 2", "NNNNNNNNNNNNNNNNNNNNNNNNN 9", "ACéGTü 3",
               "TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTT 1", " 5"],
    "short_lines": ["ACGTACGT 3", "", "ACGTACGT", "TTTT\t5", "GGCC 8",
                    "CCCA 1"],
    "repeats": ["ACGT 3", "ACGT 5", "AACC 4", "GGTT 6", "ACGT 7", "A 1",
                "T 2"],
    "values": ["ACGA +5", "ACGC -7", "ACGG 1_000", "ACGT 007",
               "AAAC 5 extra fields", "AAAG \t12\t", "AAAT 0",
               "AACA 9223372036854775807", "AACC -9223372036854775808"],
    "crlf": ["ACGTAC 3\r", "GGGA 4\r", "CCTA 5\r", "TTAG 6\r"],
    "bad_count": ["ACGT 4", "ACGA 4x"],
    "empty_count": ["ACGT 4", "ACGA  4"],
}


@pytest.mark.parametrize("kind", list(_PULL_LINES) + ["random"])
def test_load_counts_file_matches_jax(tmp_path, kind):
    """_load_counts_file on crafted pulls: keys with N, lowercase and other
    characters (each takes a position and adds no bits), one-field and
    empty lines, repeated keys and reverse-complement twins, count
    spellings int() reads, CRLF line ends, a last line with no newline;
    a bad count raises int()'s own error in both. The dicts are equal,
    their order included."""
    h2l = jsamread.Context.__new__(jsamread.Context).h2l
    if kind == "random":
        rng = np.random.default_rng(9)
        kmers = ["".join(rng.choice(list("ACGTNacgt"), int(n)))
                 for n in rng.integers(0, 32, 2000)]
        lines = [f"{s} {int(c)}" for s, c in zip(
            kmers, rng.integers(-50, 5000, len(kmers)))]
    else:
        lines = _PULL_LINES[kind]
    path = tmp_path / "pull.tab"
    with open(path, "w", newline="") as f:
        f.write("\n".join(lines))
    out = []
    for load in (lambda d: pdriver._load_counts_file(str(path), d),
                 lambda d: jdriver._load_counts_file(str(path), d, h2l)):
        d = {"seed": 1}
        try:
            load(d)
            out.append(list(d.items()))
        except ValueError as e:
            out.append(f"ValueError: {e}")
    assert out[0] == out[1]
    assert isinstance(out[0], str) == kind.startswith(("bad", "empty"))


def test_load_counts_file_refuses_wide_keys(tmp_path):
    """A k-mer whose packing needs more than 64 bits (a base other than A
    past the 32nd, or other than T in the reverse complement) raises: the
    port's keys are k-mers of k <= 31. At 32 bases both packings fit."""
    path = tmp_path / "pull.tab"
    path.write_text("T" * 32 + " 1\n" + "A" * 33 + "C 2\n")
    with pytest.raises(ValueError, match="64 bits"):
        pdriver._load_counts_file(str(path), {})
    path.write_text("T" * 32 + " 1\nA" + "C" * 31 + " 2\n")
    got, want = {}, {}
    pdriver._load_counts_file(str(path), got)
    jdriver._load_counts_file(str(path), want,
                              jsamread.Context.__new__(jsamread.Context).h2l)
    assert list(got.items()) == list(want.items())
    assert max(got) == (1 << 64) - 1
