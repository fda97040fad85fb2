"""The span readers (``lib/spans.py``) on a hand-made record of a traced
window, and on a rehearsal's traced line."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark.lib import spans
from benchmark.lib.registry import CHECKOUT, Registry

NEW = ("count_feed_wait_s", "count_table_out_s", "filter_feed_wait_s",
       "filter_write_s", "run_outside_stages_s")


def _job(feed, out, ffeed, write, init, outside):
    return {"count": {"wall_s": 1.0, "spans": {
                "feed_wait": {"s": feed, "n": 40},
                "step": {"s": 0.1, "n": 39},
                "table_out": {"s": out, "n": 3},
                "decode": {"s": 2.0, "n": 42, "thread": "reader"}}},
            "filter": {"wall_s": 0.5, "spans": {
                "feed_wait": {"s": ffeed, "n": 8},
                "write": {"s": write, "n": 7}}},
            "run": {"stage": "run", "init_s": init,
                    "outside_stages_s": outside, "wall_s": 1.6}}


def _ctx(jobs):
    return SimpleNamespace(jobs=jobs)


def test_each_reader_is_the_mean_a_job():
    ctx = _ctx([_job(0.25, 0.5, 0.375, 0.125, 0.001, 0.002),
                _job(0.75, 1.0, 0.625, 0.375, 0.003, 0.004)])
    assert spans.count_feed_wait_s(ctx) == 0.5
    assert spans.count_table_out_s(ctx) == 0.75
    assert spans.filter_feed_wait_s(ctx) == 0.5
    assert spans.filter_write_s(ctx) == 0.25
    assert spans.run_outside_stages_s(ctx) == pytest.approx(0.005)


def test_a_program_without_spans_reads_nothing():
    """The parent's records: stages without ``spans`` and no ``run``
    record, or a job that lacks one span: no reading, and no error."""
    bare = {"count": {"wall_s": 1.0}, "filter": {"wall_s": 0.5}}
    for jobs in ([bare], [], [_job(0.1, 0.2, 0.3, 0.4, 0.0, 0.0), bare]):
        ctx = _ctx(jobs)
        for name in NEW:
            assert getattr(spans, name)(ctx) is None, (name, jobs)


def test_each_cell_binds_the_five_readers():
    reg = Registry()
    for cell in ("fastq.front", "bam.front"):
        suffix = cell.split(".")[0]
        names = {m["name"] for m in reg.cell(cell)["per_layer"]}
        for q in NEW:
            assert f"{q}.{suffix}" in names
            assert reg.reader(f"{q}.{suffix}") is getattr(spans, q)


@pytest.mark.parametrize("cell", ["fastq.front", "bam.front"])
def test_traced_rehearsal_reads_every_span_metric(cell):
    p = subprocess.run([sys.executable,
                        os.path.join(CHECKOUT, "benchmark", "rehearse.py"),
                        "--workload", cell, "--genome-bp", "20000",
                        "--seconds", "0.1", "--seed", "2400000007",
                        "--trace", "1"], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    suffix = cell.split(".")[0]
    for q in NEW:
        m = line["metrics"][f"{q}.{suffix}"]
        assert m["unit"] == "s" and m["value"] >= 0, q
    got = line["metrics"]
    assert got[f"count_feed_wait_s.{suffix}"]["value"] + \
        got[f"count_table_out_s.{suffix}"]["value"] <= \
        got[f"count_s.{suffix}"]["value"]
