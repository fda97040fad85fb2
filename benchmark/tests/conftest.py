"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the checkout's root. Tests marked ``gpu`` need a card and skip without
one (on the card: ``python -m pytest benchmark/tests -q -m gpu``)."""

import os
import sys

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def spilled():
    """make(name, batch_size=None): a deep copy of cell `name` whose tables
    spill to the host (``spill_tables`` "on"), at `batch_size` reads a
    batch (the cell's own by default), under the least budget whose
    pending buffer holds one batch's keys, plus 5% (``chip_smoke.py``'s
    memory phase sizes it so): a count whose table outgrows that budget
    spills sorted runs. The copy runs under a name of its own."""
    import copy

    from benchmark.lib.registry import Registry
    from rufus_tpu_torch.ops import table

    def make(name: str, batch_size: int | None = None) -> dict:
        cell = copy.deepcopy(Registry().cell(name))
        rufus = cell["config"]["rufus"]
        batch = batch_size or rufus["batch_size"]
        per_key = max(table.PENDING_BYTES + table.TABLE_BYTES,
                      2 * table.MERGE_BYTES)
        keys = batch * (rufus["read_pad"] - rufus["k"] + 1)
        rufus.update(batch_size=batch, spill_tables="on",
                     hbm_budget_gb=1.05 * per_key * keys / 2**30)
        cell["name"] = name + ".spill"
        return cell

    return make


@pytest.fixture
def stage_records(monkeypatch):
    """Every job's stage records (by stage name) that the harness reads,
    in the order it reads them, warm-up job first."""
    from benchmark.lib import harness

    seen = []

    def read(workdir):
        seen.append(plain(workdir))
        return seen[-1]

    plain = harness._stage_records
    monkeypatch.setattr(harness, "_stage_records", read)
    return seen


@pytest.fixture
def assert_spilled():
    """check(jobs, runs=True): each job's count left its tables flat, with
    `runs` two sorted runs or more a sample, and its subtract streamed the
    flat tables through the device (`jobs`: stage records as
    ``stage_records`` holds them)."""
    def check(jobs: list, runs: bool = True):
        assert jobs
        for recs in jobs:
            assert recs["count"]["flat"] is True
            if runs:
                n = recs["count"]["lsm_runs"]
                assert len(n) == 3 and min(n.values()) >= 2, n
            assert recs["hashlist"]["path"] == "host-stream"

    return check
