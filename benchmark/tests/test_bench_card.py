"""On the card, at the cells' own sizes: the control fails the comparison
on three seeds, and a sound run passes it. ``python -m pytest
benchmark/tests -q -m gpu`` on the card's machine."""

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
