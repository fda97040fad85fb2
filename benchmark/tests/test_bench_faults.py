"""A run with the timed path broken underneath comes out not correct: the
harness's run on the CPU (its look for a card skipped) at a tiny slice,
once for each fault a cell can have (``benchmark/faults.py``): the VCF's
faults only where the jobs run to FINAL.vcf."""

import contextlib
import copy
import sys
import time

import pytest

from benchmark import faults
from benchmark.lib import harness
from benchmark.lib.registry import Registry


def _run(cell, fault):
    cell = copy.deepcopy(cell)
    # several batches a sample, as at the cell's size
    cell["config"]["rufus"]["batch_size"] = 1024
    with faults.FAULTS[fault](), contextlib.redirect_stdout(sys.stderr):
        return harness.measure(cell, 5, 1e-3, False, "cpu",
                               time.perf_counter(), 20_000)


@pytest.mark.parametrize("cell", ["fastq.front", "bam.front"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "pair_altered", "half_kept"])
def test_front_faults_are_caught(cell, fault):
    r = _run(Registry().cell(cell), fault)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_full_faults_are_caught(fault):
    """Each fault fails at least one of fastq.full's numbers; the back
    end's own faults fail the number that watches where they are planted."""
    r = _run(Registry().cell("fastq.full"), fault)
    assert r["correct"] is False
    bad = {n for n, c in r["checks"].items() if c["value"] > c["limit"]}
    assert bad
    if fault == "rows_altered":
        assert bad == {"vcf_wrong_rows", "vcf_missed_sites"}
    if fault == "half_aligned":
        assert "aligned_reads_off" in bad
    if fault == "ref_allele_dropped":
        assert bad == {"vcf_wrong_genotypes"}


@pytest.mark.parametrize("cell", ["fastq.front", "fastq.full"])
def test_a_sound_run_is_correct(cell):
    with contextlib.redirect_stdout(sys.stderr):
        r = harness.measure(Registry().cell(cell), 5, 1e-3, False, "cpu",
                            time.perf_counter(), 20_000)
    assert r["correct"] is True
    assert all(c["value"] == 0 for c in r["checks"].values())


# a spilled copy's trio: tens of sorted runs a sample at 128 reads a batch
SPILL_BP = {"fastq.front": 40_000, "fastq.full": 20_000}


def _spilled_run(spilled, name):
    with contextlib.redirect_stdout(sys.stderr):
        return harness.measure(spilled(name, 128), 5, 1e-3, False, "cpu",
                               time.perf_counter(), SPILL_BP[name])


@pytest.mark.parametrize("cell", ["fastq.front", "fastq.full"],
                         ids=["front", "full"])
def test_a_spilled_run_is_correct(cell, spilled, stage_records,
                                  assert_spilled):
    """A job whose tables spill to ``.table.flat`` reads correct, every
    check 0, and took the out-of-core path."""
    r = _spilled_run(spilled, cell)
    assert r["correct"] is True, r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values()), r["checks"]
    assert len(stage_records) == 2  # the warm-up job and one timed job
    assert_spilled(stage_records)


@pytest.mark.parametrize("fault", sorted(faults.SPILL_FAULTS))
def test_spill_faults_are_caught(fault, spilled, stage_records,
                                 assert_spilled):
    with faults.SPILL_FAULTS[fault]():
        r = _spilled_run(spilled, "fastq.front")
    assert r["correct"] is False
    bad = {n for n, c in r["checks"].items() if c["value"] > c["limit"]}
    assert "tables_off" in bad, r["checks"]
    assert_spilled(stage_records)
