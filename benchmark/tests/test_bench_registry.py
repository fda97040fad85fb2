"""Every configuration, traffic mix and metric is found by name, and a new
one is found from new files and entries alone."""

import json
import os
import shutil
from types import SimpleNamespace

from benchmark.lib.registry import CHECKOUT, Registry


def test_every_cell_and_metric_is_found():
    reg = Registry()
    spec = reg.spec
    for c in spec["configs"]:
        assert reg.config(c["name"])["input"] in ("fastq", "bam")
    for w in spec["workloads"]:
        cell = reg.cell(w["name"])
        assert cell["traffic"]["name"] == w["traffic"]
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
    for m in spec["per_layer"]:
        assert callable(reg.reader(m["name"]))


def test_each_layer_metric_moves_a_metric_its_cells_report():
    reg = Registry()
    for m in reg.spec["per_layer"]:
        for cell in m["workloads"]:
            e2e = {e["name"] for e in reg.cell(cell)["end_to_end"]}
            assert m["moves"] in e2e, (m["name"], cell)


def test_a_new_cell_and_metric_need_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(CHECKOUT, "benchmark"), root / "benchmark")
    spec = json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))
    cfg = json.load(open(root / "benchmark/configs/trio30x_fastq.json"))
    cfg["sample"]["coverage"] = 60.0
    (root / "benchmark/configs/trio60x_fastq.json").write_text(
        json.dumps(cfg))
    tr = json.load(open(root / "benchmark/traffic/front.json"))
    tr["genome_bp"] = 1_000_000
    (root / "benchmark/traffic/small.json").write_text(json.dumps(tr))
    (root / "benchmark/metrics/hashlist_s.front.py").write_text(
        "def read(ctx):\n    return ctx.stage_mean('hashlist')\n")
    spec["configs"].append({**spec["configs"][0], "name": "trio60x_fastq",
                            "file": "benchmark/configs/trio60x_fastq.json"})
    spec["workloads"].append({"name": "fastq60.small", "config":
                              "trio60x_fastq", "traffic": "small",
                              "chips": 1, "why": "a new cell"})
    spec["per_layer"].append({"name": "hashlist_s.front", "unit": "s",
                              "better": "lower", "source": "program_span",
                              "layer": "subtract", "moves":
                              "front_reads_per_s",
                              "workloads": ["fastq60.small"]})
    spec["end_to_end"].append({"name": "front_reads_per_s",
                               "unit": "reads/s", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["fastq60.small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Registry(str(root)).cell("fastq60.small")
    assert cell["config"]["sample"]["coverage"] == 60.0
    assert cell["traffic"]["genome_bp"] == 1_000_000
    assert [m["name"] for m in cell["per_layer"]] == ["hashlist_s.front"]
    assert "front_reads_per_s" in {m["name"] for m in cell["end_to_end"]}
    read = Registry(str(root)).reader("hashlist_s.front")
    ctx = SimpleNamespace(stage_mean=lambda name: {"hashlist": 0.25}[name])
    assert read(ctx) == 0.25
    # the original cells are untouched
    assert Registry(str(root)).cell("fastq.front")["traffic"]["genome_bp"] \
        == 4_000_000
