"""The check of the calls and the WGS route: the truth comparison on
hand-made VCF rows, the depth model written from the traffic's numbers as
the program reads it, and the exome route of the front cells unchanged."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.lib import depthmodel, harness
from benchmark.lib.registry import Registry
from benchmark.reference import compare

SITES = [("1", 1001, "A", "G"), ("1", 2001, "C", "T"), ("1", 3001, "T", "A")]
DENOVO = ("0/1", "0/0", "0/0")  # the child heterozygous, the parents not


def _rows(*rows, gts=DENOVO):
    return [(*r, gts) for r in rows]


def _numbers(wrong, missed, genotypes=0):
    return {"vcf_wrong_rows": wrong, "vcf_missed_sites": missed,
            "vcf_wrong_genotypes": genotypes}


def test_exact_calls_read_zero():
    assert compare.call_numbers(_rows(*SITES), SITES) == _numbers(0, 0)


def test_a_wrong_base_is_a_wrong_row_and_a_missed_site():
    rows = _rows(SITES[0], ("1", 2001, "C", "G"), SITES[2])
    assert compare.call_numbers(rows, SITES) == _numbers(1, 1)


def test_a_two_base_call_over_one_site_does_not_call_it():
    rows = _rows(SITES[0], ("1", 2001, "CA", "TG"), SITES[2])
    assert compare.call_numbers(rows, SITES) == _numbers(1, 1)


def test_a_missing_site_and_a_repeated_row():
    assert compare.call_numbers(_rows(*SITES[:2]), SITES) == _numbers(0, 1)
    assert compare.call_numbers(_rows(*SITES, SITES[0]), SITES) == \
        _numbers(1, 0)


@pytest.mark.parametrize("gts, wrong", [
    (("0/1", "0/0", "0/0"), 0), (("0|1", "0", "0/0/0"), 0),
    (("0/0/1", "0/0", "0/0"), 0), (("1/1", "0/0", "0/0"), 1),
    (("1", "0/0", "0/0"), 1), (("0/0", "0/0", "0/0"), 1),
    (("0/1", "0/1", "0/0"), 1), (("0/1", "0/0", "."), 1),
    (("0/1", "0/0"), 1)])
def test_genotypes_against_the_truth(gts, wrong):
    rows = _rows(*SITES[:2]) + _rows(SITES[2], gts=gts)
    assert compare.call_numbers(rows, SITES) == _numbers(0, 0, wrong)


def test_a_wrong_genotype_off_the_truth_is_a_wrong_row_alone():
    rows = _rows(*SITES) + _rows(("1", 5001, "G", "C"), gts=("1/1", "0/1"))
    assert compare.call_numbers(rows, SITES) == _numbers(1, 0)


def test_read_vcf_rows_and_a_missing_file(tmp_path):
    path = tmp_path / "FINAL.vcf"
    path.write_text("##fileformat=VCFv4.1\n#CHROM\tPOS\tID\tREF\tALT\n"
                    "1\t1001\t.\tA\tG\t30\tPASS\t.\tGT:DP\t0/1:20\t0/0:21"
                    "\t0/0:19\n"
                    "1\t2001\t.\tCA\tTG\t30\tPASS\t.\tGT\t0/0/1\t0\t0/0\n")
    assert compare.read_vcf(str(path)) == [
        ("1", 1001, "A", "G", ("0/1", "0/0", "0/0")),
        ("1", 2001, "CA", "TG", ("0/0/1", "0", "0/0"))]
    assert compare.read_vcf(str(tmp_path / "none.vcf")) == []


def test_read_sam_turns_reverse_reads_back(tmp_path):
    path = tmp_path / "Mutations.fastq.sam"
    path.write_text("@HD\tVN:1.6\n"
                    "p1\t99\t1\t5\t60\t4M\t=\t9\t8\tACGN\tIIJ#\n"
                    "p1\t147\t1\t9\t60\t4M\t=\t5\t-8\tAACG\tABCD\n"
                    "p1\t2147\t1\t9\t60\t2S2M\t=\t5\t0\tCG\tCD\n"
                    "p2\t77\t*\t0\t0\t*\t*\t0\t0\tTTGA\tIIII\n")
    assert compare.read_sam(str(path)) == [
        ("p1", "ACGN", "IIJ#"), ("p1", "CGTT", "DCBA"), ("p2", "TTGA", "IIII")]
    assert compare.read_sam(str(tmp_path / "none.sam")) == []


def test_aligned_reads_against_the_kept_pairs():
    pairs = [("p1", "ACGN", "IIJ#", "CGTT", "DCBA"),
             ("p2", "TTGA", "IIII", "GGCC", "IIII")]
    exp = SimpleNamespace(outputs={
        "tables": {s: (np.empty(0, np.uint64), np.empty(0, np.int64))
                   for s in compare.SAMPLES},
        "histos": {s: np.empty(0, np.int64) for s in compare.SAMPLES},
        "hashlist": [], "pairs": pairs}, truth=SITES)
    got = {**exp.outputs, "vcf": _rows(*SITES),
           "aligned": [("p2", "GGCC", "IIII"), ("p1", "ACGN", "IIJ#"),
                       ("p1", "CGTT", "DCBA"), ("p2", "TTGA", "IIII")]}
    assert compare.numbers(got, exp, True)["aligned_reads_off"] == 0
    got["aligned"] = got["aligned"][:2]
    assert compare.numbers(got, exp, True)["aligned_reads_off"] == 2
    # the control makes no back-end outputs and gets no back-end numbers
    assert set(compare.numbers(exp.outputs, exp, True)) == {
        "tables_off", "histo_off", "hashlist_off", "pairs_off"}


def test_truth_rows_of_a_trio():
    trio = SimpleNamespace(ref_name="1", genome=np.frombuffer(b"ACGTACGT",
                                                              np.uint8),
                           sites=np.array([1, 6]), alt=np.frombuffer(b"TA",
                                                                     np.uint8))
    assert compare.truth(trio) == [("1", 2, "C", "T"), ("1", 7, "G", "A")]


def _full():
    return Registry().cell("fastq.full")


def test_the_written_model_is_what_the_program_reads(tmp_path):
    from rufus_tpu_torch.interpret.model import DepthModel, baysean_genotyper
    from rufus_tpu_torch.pipeline import RufusConfig
    from rufus_tpu_torch.pipeline.driver import RufusPipeline

    cell = _full()
    m = cell["traffic"]["model"]
    cfg = RufusConfig(subject="child.R1.fastq", workdir=str(tmp_path),
                      exome=False, min_cov=0)
    histo = cfg.wpath(cfg.subject_stub + ".Jhash.histo")
    src = tmp_path / "src"
    src.mkdir()
    depthmodel.place(depthmodel.write(m, str(src / "x.Jhash.histo")), histo)
    # the model's cutoff and 5 x its raw peak, with no fit (driver.py
    # stage_model), and the harness's reference takes the same range
    got = RufusPipeline.stage_model(SimpleNamespace(cfg=cfg))
    assert got == (m["cutoff"], 5 * m["raw_peak"])
    assert harness.route(cell) == {"min_cov": got[0],
                                   "max_hash_depth": got[1]}
    model = DepthModel.load(histo + ".7.7.dist")
    model.process_high_low()
    assert model.sc_global == m["raw_peak"] and not model.is_exome
    assert len(model.dist) == depthmodel.tables(m)[1].shape[1] + 1
    assert all(len(d) >= m["size"] for d in model.dist[2:])
    # a heterozygous de novo allele's k-mers, at half the peak, genotype as
    # one copy of the alternate: the row a PASS call needs
    half = int(m["peak"] / 2)
    assert baysean_genotyper(model, [half] * 20, "1")[0] == "1"


def test_the_construction_is_modeldists_final_table():
    from rufus_tpu_torch.models import modeldist

    m = _full()["traffic"]["model"]
    err, dist = depthmodel.tables(m)
    want, n_j = modeldist._build_dist_cols(
        np.arange(m["size"]), m["size"], m["peak"], m["stdev"], m["factor"],
        0.0, 1.0)
    for c in range(1, n_j + 1):
        want[:, c] = want[:, c] / want[:, c].sum()
    assert np.array_equal(dist, want)
    assert err[0] == 0 and err[1] == m["error_first"]


def test_the_model_files_are_written_once(tmp_path, monkeypatch):
    m = _full()["traffic"]["model"]
    first = depthmodel.cached(m, str(tmp_path), "c.Jhash.histo")
    with open(first[1]) as f:
        dist = f.read()

    def no_write(*a):
        raise AssertionError("written again")

    monkeypatch.setattr(depthmodel, "write", no_write)
    assert depthmodel.cached(m, str(tmp_path), "c.Jhash.histo") == first
    src = tmp_path / "src"
    src.mkdir()
    monkeypatch.undo()
    plain = depthmodel.write(m, str(src / "c.Jhash.histo"))
    with open(plain[1]) as f:
        assert f.read() == dist


def test_the_front_route_is_unchanged():
    for name in ("fastq.front", "bam.front"):
        cell = Registry().cell(name)
        assert harness.route(cell) == {"min_cov": 2,
                                       "max_hash_depth": 100_000_000}
        cfg = harness.job_config(cell, {s: ("x.R1.fastq", "x.R2.fastq")
                                        for s in compare.SAMPLES},
                                 "ref.fa", os.devnull, "cpu")
        assert cfg.exome is True and cfg.min_cov == 2
        assert cfg.stop_after == "filter"
