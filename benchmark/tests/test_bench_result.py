"""The result line's shape, from a rehearsal on the CPU."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.lib.registry import CHECKOUT, Registry

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the metrics a CPU line holds: no device metric, so no device peak
END_TO_END = {"fastq.front": {"setup_s"},
              "bam.front": {"setup_s"},
              "fastq.full": {"setup_s"}}
CELLS = ["fastq.front", "bam.front", "fastq.full"]


def _per_layer(cell):
    """(the per-layer metrics a CPU line must hold, those it may hold):
    every metric the host reads (spans and the host clock) must be there;
    a counter may be, and the profiler's trace of a card never is."""
    layer = Registry().cell(cell)["per_layer"]
    must = {m["name"] for m in layer
            if m["source"] in ("program_span", "host_clock")}
    may = {m["name"] for m in layer if m["source"] == "program_counter"}
    return must, must | may


def _rehearse(cell, *args):
    p = subprocess.run([sys.executable,
                        os.path.join(CHECKOUT, "benchmark", "rehearse.py"),
                        "--workload", cell, "--genome-bp", "20000",
                        "--seconds", "0.1", *args], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_end_to_end_line(cell):
    line, err = _rehearse(cell, "--seed", "2")
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == END_TO_END[cell]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["memory_peak_bytes"] is None
    checks = line["checks"]
    assert set(checks) == set(Registry().cell(cell)["traffic"]["limits"])
    assert all(set(c) == {"value", "limit"} for c in checks.values())
    tail = err.strip().splitlines()[-len(checks):]
    assert tail == [f"check {n}: {c['value']} (limit {c['limit']})"
                    for n, c in checks.items()]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line_has_no_device_metric_on_the_cpu(cell):
    line, _ = _rehearse(cell, "--seed", "3", "--trace", "1")
    must, may = _per_layer(cell)
    assert must <= set(line["metrics"]) <= may
    assert "breakdown" not in line and "busy_s" not in line["device"]
