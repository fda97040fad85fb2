"""A run with the timed path broken underneath comes out not correct: the
harness's run on the CPU (its look for a card skipped) at a tiny slice,
once for each fault a cell can have (``benchmark/faults.py``)."""

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
                                   "pair_altered"])
def test_front_faults_are_caught(cell, fault):
    r = _run(Registry().cell(cell), fault)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_a_sound_run_is_correct():
    cell = Registry().cell("fastq.front")
    with contextlib.redirect_stdout(sys.stderr):
        r = harness.measure(cell, 5, 1e-3, False, "cpu", time.perf_counter(),
                            20_000)
    assert r["correct"] is True
    assert all(c["value"] == 0 for c in r["checks"].values())
