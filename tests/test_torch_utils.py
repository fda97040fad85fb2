"""The port's host utilities (utils/vcftools.py, diagnostics.py, plots.py
and trace.py's vm_mb and MemSampler) against the JAX package's on the same
inputs: the cases of tests/test_utils.py, each output compared whole."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from rufus_tpu.ops.count import KmerTable as JaxTable
from rufus_tpu.utils import diagnostics as jdiag, trace as jtrace
from rufus_tpu.utils import vcftools as jvcf
from rufus_tpu_torch.ops.count import KmerTable
from rufus_tpu_torch.utils import diagnostics, trace, vcftools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VCF = [
    "##fileformat=VCFv4.1",
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2",
    "1\t100\tX\tT\tG\t25\tPASS\tAO=19\tGT:DP\t0/1:39\t0/0:23",
    "1\t100\tX\tT\tG\t25\tPASS\tAO=19\tGT:DP\t0/1:39\t0/0:23",
    "chr2\t500\tD\t" + "A" * 80 + "\tA\t12\tPASS\tRN=1\tGT:DP\t0/1:10\t0/0:9",
    "3\t900\tS\tN\t<DEL>\t30\tPASS\tEND=1500;SVLEN=-600\tGT:DP\t0/1:8\t0/0:7",
    "4\t1000\tYI\tC\t" + "C" * 70 + "\t33\tPASS\tAO=3\tGT:DP\t0/1:5\t0/0:6",
    "5\t77\tB\tA\tA[5:300[\t40\tPASS\tSVTYPE=BND\tGT\t0/1\t0/0",
    "5\t90\tI\tN\t<INS:ME:ALU>\t31.7\tPASS\tSVLEN=300\tGT:DP\t0/1\t0/0:4",
    "6\t10\tM\tAC\tGT\t18\tPASS\t.\tGT:DP\t0/1:12\t0/0:12",
    "6\t20\tU\tN\t<DUP>N\t35\tPASS\tSVLEN=90;END=110\tGT:DP\t0/1:2\t0/0:3",
]

BED = [
    "1\t100\tT\tG\t.\t.\tS1",
    "1\t100\tT\tG\t.\t.\tS2",
    "1\t100\tT\tG\t.\t.\tS2",
    "2\t200\tA\tC\t.\t.\tS1",
    "2\t200\tA\tC",
]

SAM = ["@HD\tVN:1.6",
       "r1\t0\t*\t0\t0\t*\t*\t0\t0\tAAAAACC\tIIIIIII",
       "r2\t0\t*\t0\t0\t*\t*\t0\t0\tGGGGGGG\t#####++",
       "r3\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*",
       "r4\t0\t*\t0\t0\t*\t*\t0\t0\tACNGTAAAAACCCCCTT\tIIIIIIIIIIIIIIIII"]

GFF = [
    "##gff-version 3",
    "2\tsrc\tgene\t450\t650\t.\t+\t.\tID=gene:G1;Name=MYGENE",
    "2\tsrc\tgene\t9000\t9500\t.\t+\t.\tID=gene:G2;Name=OTHER",
    "chr3\tsrc\tgene\t1400\t1600\t.\t+\t.\tID=gene:G3",
    "3\tsrc\texon\t1000\t1100\t.\t+\t.\tName=EXON",
    "short\tline",
]

# (function, its arguments): each of vcftools' line functions
VCF_CASES = {
    "vcf_to_sv_bed": ("vcf_to_sv_bed", (VCF,)),
    "qual_dist": ("qual_dist", (VCF,)),
    "remove_duplicate_calls": ("remove_duplicate_calls", (VCF,)),
    "check_duplicate_calls_bed": ("check_duplicate_calls_bed", (BED,)),
    "convert_vcf_to_r_format": ("convert_vcf_to_r_format", (VCF,)),
    "histo_base_qualities": ("histo_base_qualities", (SAM[1:],)),
    "mob_to_dist": ("mob_to_dist",
                    (["h1", "h2", "h3", "h4", "h5", "1 2 3", "4 5", "",
                      "7.9 1"],)),
    "sv_gene_check": ("sv_gene_check", (VCF, GFF)),
}


def _materialize(out):
    return out if isinstance(out, (tuple, str)) else list(out)


@pytest.mark.parametrize("case", sorted(VCF_CASES))
def test_vcftools_equal_jax(case):
    name, args = VCF_CASES[case]
    got = _materialize(getattr(vcftools, name)(*args))
    want = _materialize(getattr(jvcf, name)(*args))
    assert got == want
    assert got  # every case yields something


def test_the_cases_hold_what_test_utils_checks():
    """The checks of tests/test_utils.py, on the port's output."""
    assert list(vcftools.vcf_to_sv_bed(VCF[:6])) == [
        "2\t499\t579\tD-12", "3\t899\t1500\tS-30"]
    out = vcftools.qual_dist(VCF)
    assert out[25].startswith("25; ++; 2") and "~~~~~~~~~" in out
    body = [l for l in vcftools.remove_duplicate_calls(VCF)
            if not l.startswith("#")]
    assert len(body) == len(VCF) - 3
    bed = list(vcftools.check_duplicate_calls_bed(BED[:4]))
    assert bed[0].endswith("UNIUQE") and bed[1].startswith("+++")
    assert bed[2].startswith("+++") and bed[3].endswith("UNIUQE")
    assert vcftools.mob_to_dist(["h"] * 5 + ["1 2 3", "4 5"]) == ([6, 9], 15)
    assert vcftools.sv_gene_check(VCF, GFF[:3]) == ["MYGENE"]


def _tables(seqs, k):
    """A canonical JAX table and the port's table of the same arrays."""
    jt = JaxTable.from_strings(k, seqs)
    return jt, KmerTable(k, jt.keys.copy(), jt.counts.copy())


@pytest.mark.parametrize("population", [False, True])
def test_pull_kmer_counts_from_sequence_equals_jax(population):
    jt, pt = _tables(["ACGTACGTACGTTTGACCA", "GGGTTTACGTAC"], 5)
    jp, pp = _tables(["ACGTACGTAAAA"], 5)
    seq = "ACGTACGNTTGACCAGGT"
    got = vcftools.pull_kmer_counts_from_sequence(
        seq, 5, {"subj": pt, "again": pt}, pp if population else None)
    want = jvcf.pull_kmer_counts_from_sequence(
        seq, 5, {"subj": jt, "again": jt}, jp if population else None)
    assert got == want
    assert int(got[1][0].split("\t")[1]) > 0


def test_gff_reader_equals_jax():
    got = list(vcftools.read_gff3(GFF))
    want = list(jvcf.read_gff3(GFF))
    assert [vars(g) for g in got] == [vars(w) for w in want]
    assert [g.attr("Name") for g in got] == [w.attr("Name") for w in want]
    assert got[0].attr("ID") == "gene:G1" and got[2].attr("Name") == ""


@pytest.mark.parametrize("k", [5, 7])
def test_diagnostics_equal_jax(k):
    rng = np.random.default_rng(k)
    seqs = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(20)]
    jt, pt = _tables(["AAAAACCCCC"] + seqs[:5], k)
    probe = seqs + ["ACGNTACGTA", "AC", "acgtacgtacgt", ""]
    assert (diagnostics.per_read_kmer_hits(probe, pt, k)
            == jdiag.per_read_kmer_hits(probe, jt, k))
    got = list(diagnostics.dump_sam_read_kmer_count(SAM, pt, k))
    assert got == list(jdiag.dump_sam_read_kmer_count(SAM, jt, k))
    assert len(got) == 3  # the unmapped '*' read is skipped


def _model_file(path):
    """A minimal .model file shaped like modeldist.write_outputs."""
    with open(path, "w") as f:
        f.write("3\n7\n12345\n30\n")
        f.write("0.5\t0.5\t\n")
        f.write("K\tRawCount\tErrorModel\tContSubtract\tModelSum\t1x\t2x\t3x"
                "\t4x\t5x\t6x\t7x\t8x\t9x\n")
        for k in range(1, 60):
            f.write(f"{k}\t{1000//k}\t{500//k}\t0\t{800//k}" + "\t0.1" * 8
                    + ("\tnan?\n" if k == 3 else "\t0.1\n"))


def test_read_model_table_equals_jax(tmp_path):
    from rufus_tpu.utils import plots as jplots
    from rufus_tpu_torch.utils import plots

    p = str(tmp_path / "x.histo.7.7.model")
    _model_file(p)
    meta, cols = plots.read_model_table(p)
    jmeta, jcols = jplots.read_model_table(p)
    assert meta == jmeta and cols.keys() == jcols.keys()
    for name in cols:
        np.testing.assert_array_equal(cols[name], jcols[name])


def test_plot_model(tmp_path):
    pytest.importorskip("matplotlib")
    from rufus_tpu_torch.utils import plots

    p = str(tmp_path / "x.histo.7.7.model")
    _model_file(p)
    out = plots.plot_model(p, str(tmp_path / "m.pdf"))
    assert out == str(tmp_path / "m.pdf") and os.path.getsize(out) > 500
    assert plots.plot_model(p) == p + ".pdf" and os.path.getsize(p + ".pdf")


def test_vm_mb_reads_the_process():
    got, want = trace.vm_mb(), jtrace.vm_mb()
    assert got > trace.rss_mb() > 10
    assert abs(got - want) < 0.05 * want  # one process, read twice


def test_stage_timer_names_the_live_stage(tmp_path):
    t = trace.StageTimer(log_path=str(tmp_path / "trace.jsonl"))
    assert t.current == ""
    with t.stage("count"):
        assert t.current == "count"
    with t.stage("filter"):
        assert t.current == "filter"


def test_mem_sampler_per_stage_peaks(tmp_path):
    """Samples tagged with the live stage, peaks by stage, one JSON line a
    sample, the same fields as the JAX sampler's plus none of JAX's."""
    t = trace.StageTimer()
    path = str(tmp_path / "mem.jsonl")
    s = trace.MemSampler(t, path=path, interval=0.02).start()
    time.sleep(0.1)
    with t.stage("count"):
        hold = np.ones(64 << 20, np.uint8)  # 64 MB more RSS inside it
        time.sleep(0.2)
        del hold
    with t.stage("filter"):
        time.sleep(0.1)
    s.stop()
    peaks = s.per_stage_peaks()
    assert {"(pre)", "count", "filter"} <= set(peaks)
    assert peaks["count"]["rss_mb"] > peaks["(pre)"]["rss_mb"] + 32
    with open(path) as f:
        assert sum(1 for _ in f) == len(s.samples)
    jt = jtrace.StageTimer()
    js = jtrace.MemSampler(jt, interval=0.02).start()
    time.sleep(0.1)
    js.stop()
    jkeys = set(js.samples[0]) - {"jax_live_mb"}
    assert jkeys == set(s.samples[0])  # no card here: host figures only
    assert s.device is None


_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["matplotlib"] = None   # the card's machine has none
import torch
assert not torch.cuda.is_available()
import rufus_tpu_torch
for m in ["rufus_tpu_torch.utils.plots", "rufus_tpu_torch.ops.cuda_pack",
          "rufus_tpu_torch.ops.pack", "rufus_tpu_torch.utils.vcftools",
          "rufus_tpu_torch.utils.diagnostics", "rufus_tpu_torch.tools.bench",
          "rufus_tpu_torch.tools.sortbench", "rufus_tpu_torch.tools.alignbench",
          "rufus_tpu_torch.tools.scale_run"]:
    importlib.import_module(m)
print("ok")
"""


def test_new_modules_import_without_matplotlib_or_a_card():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
