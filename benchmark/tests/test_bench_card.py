"""On the card, at the cells' own sizes: the control fails the comparison
on three seeds, and a sound run passes it, also where the count spills its
tables to ``.table.flat``. ``python -m pytest benchmark/tests -q -m gpu``
on the card's machine."""

import contextlib
import sys
import time

import pytest

from benchmark.control import control_numbers
from benchmark.lib import harness
from benchmark.lib.registry import Registry


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["fastq.front", "bam.front", "fastq.full"])
def test_the_control_fails(card, cell):
    c = Registry().cell(cell)
    limits = c["traffic"]["limits"]
    for seed in (11, 12, 13):
        nums = control_numbers(c, seed, card)
        assert any(v > limits[n] for n, v in nums.items()), (seed, nums)


@pytest.mark.gpu
def test_a_sound_run_passes(card):
    c = Registry().cell("fastq.front")
    with contextlib.redirect_stdout(sys.stderr):
        r = harness.measure(c, 21, 1e-3, False, card, time.perf_counter())
    assert r["correct"] is True, r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [65536, 16384])
def test_a_spilled_run_passes_and_the_control_fails(card, spilled,
                                                    stage_records,
                                                    assert_spilled, batch):
    """fastq.front at its own 4 Mbp with spilled tables, under the least
    budget that holds one batch (plus 5%): the tables are flat, the
    subtract streams them, and the job reads correct; the control fails.
    At the cell's own batch of 65,536 reads a sample's whole table fits
    the budget, so no run is spilled; at 16,384 the count spills sorted
    runs and merges them on the card."""
    c = spilled("fastq.front", batch)
    with contextlib.redirect_stdout(sys.stderr):
        r = harness.measure(c, 31, 1e-3, False, card, time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert all(v["value"] == 0 for v in r["checks"].values()), r["checks"]
    assert_spilled(stage_records, runs=batch < 65536)
    limits = c["traffic"]["limits"]
    nums = control_numbers(c, 31, card)
    assert any(v > limits[n] for n, v in nums.items()), nums
