"""The port's tools (tools/bench.py, sortbench.py, alignbench.py,
scale_run.py, scaling.py) on the CPU at tiny sizes, and scale_run's truth
generator against the JAX tool's bytes from the same seed."""

import gzip
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from rufus_tpu_torch.parallel import make_mesh
from rufus_tpu_torch.tools import (alignbench, bench, scale_run, scaling,
                                   sortbench)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_makes_the_jax_tools_reads():
    jax_bench = _load(os.path.join(REPO, "bench.py"), "jax_bench")
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    genome = a.choice(np.frombuffer(b"ACGT", np.uint8), size=jax_bench.GENOME)
    assert np.array_equal(genome, b.choice(np.frombuffer(b"ACGT", np.uint8),
                                           size=bench.GENOME))
    for _ in range(2):
        for x, y in zip(jax_bench.make_reads(a, genome, 50),
                        bench.make_reads(b, genome, 50)):
            np.testing.assert_array_equal(x, y)
    assert (bench.B, bench.L, bench.K, bench.ITERS, bench.HASHLIST) == (
        jax_bench.B, jax_bench.L, jax_bench.K, jax_bench.ITERS,
        jax_bench.HASHLIST)


def test_bench_on_the_cpu(tmp_path, capsys):
    out = bench.main(["--device", "cpu", "--batch", "64", "--iters", "2",
                      "--out", str(tmp_path / "b.json")])
    assert _last_json(capsys) == json.loads(open(tmp_path / "b.json").read())
    assert {"metric", "value", "unit", "vs_baseline", "detail"} <= set(out)
    d = out["detail"]
    for key in ("count_reads_per_s", "filter_reads_per_s",
                "count_ms_per_batch", "filter_ms_per_batch",
                "fused_with_h2d_reads_per_s", "count_with_h2d_reads_per_s",
                "filter_with_h2d_reads_per_s", "h2d_transport", "roofline"):
        assert key in d, key
    assert d["device"] == "cpu" and d["kept_reads"] >= 16
    assert d["table_unique_kmers"] > 0 and out["value"] > 0
    assert d["roofline"]["flush_keys"] == 2 * 64 * (152 - 25 + 1)


def test_sortbench_on_the_cpu(tmp_path, capsys):
    out = sortbench.main(["--device", "cpu", "--batch-keys", "4096",
                          "--pending-keys", "8192", "--out",
                          str(tmp_path / "s.json")])
    assert _last_json(capsys) == out
    assert [r["n"] for r in out["sort"]] == [4096, 8192]
    assert {"resort_runs_ms", "stable_sort_runs_ms",
            "sort_unsorted_ms"} <= set(out["merge"])
    assert 0 < out["compaction"]["runs"] < 4096
    assert out["payload"]["stable_sort_gather_ms"] > 0
    fm = out["fold_merge"]
    assert fm["table_keys"] == 5120 and fm["run_keys"] == 2048
    assert fm["union_keys"] == fm["table_keys"] + fm["run_keys"] - 2048 // 3
    assert fm["launches"] == 0 and fm["merge_runs_ms"] > 0
    assert fm["bytes"] == 16 * (fm["table_keys"] + fm["run_keys"]
                                + fm["union_keys"])
    assert out["fold_bytes"] is None
    assert out["device"] == "cpu"


def test_alignbench_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(alignbench, "BUILD_DIR", str(tmp_path))
    out = alignbench.main(["--device", "cpu", "--mbp", "1", "--reads", "30",
                           "--out", str(tmp_path / "a.json")])
    assert _last_json(capsys) == out
    assert out["mapped"] == out["reads"] == 30
    assert out["alignments_per_s"] > 0 and out["index_file_mb"] > 0
    assert out["device"] == "cpu"
    assert not os.path.exists(tmp_path / "alignbench.1mbp.flatidx")


def _scale_modules(monkeypatch, tmp_path, genome=100_000, cov=10, nvar=8):
    """The JAX tool and the port's, both set to the same tiny knobs, each
    with its own working directory."""
    jax_tool = _load(os.path.join(REPO, "tools", "scale_run.py"),
                     "jax_scale_run")
    pairs = int(genome * cov / (2 * 150))
    for mod, work in ((jax_tool, tmp_path / "jax"),
                      (scale_run, tmp_path / "port")):
        os.makedirs(work, exist_ok=True)
        for name, v in (("GENOME", genome), ("COV", cov), ("NVAR", nvar),
                        ("PAIRS", pairs), ("WORK", str(work)),
                        ("PASSES", 1)):
            monkeypatch.setattr(mod, name, v)
    return jax_tool


def test_scale_run_truth_equals_the_jax_tools(monkeypatch, tmp_path):
    jax_tool = _scale_modules(monkeypatch, tmp_path, genome=200_000, nvar=40)
    genome = np.random.default_rng(scale_run.SEED).choice(
        scale_run.BASES, size=scale_run.GENOME)
    got = scale_run.build_variants(genome, np.random.default_rng(5))
    want = jax_tool.build_variants(genome, np.random.default_rng(5))
    assert got == want
    truth, edits = got
    assert {t["kind"] for t in truth} == {
        "snv", "mosaic", "ins", "del", "sv_del", "sv_ins", "dup", "inv"}
    haps = []
    for sel in (lambda e: e[3] == "denovo", lambda e: True):
        h = scale_run.apply_edits(genome, [e for e in edits if sel(e)])
        np.testing.assert_array_equal(
            h, jax_tool.apply_edits(genome, [e for e in edits if sel(e)]))
        haps.append(h)
    paths = []
    for mod in (scale_run, jax_tool):
        paths.append(mod.gen_sample("child", [genome] + haps,
                                    [0.5, 0.25, 0.25],
                                    np.random.default_rng(7)))
    for mine, theirs in zip(*paths):
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
    with gzip.open(paths[0][0], "rt") as f:
        assert sum(1 for _ in f) == 4 * scale_run.PAIRS
    rows = [f"21\t{t['pos'] + 1}\t.\tA\t{t.get('alt', 'AC')}\t30\tPASS\t.\n"
            for t in truth[::3]]
    assert scale_run.match_truth(truth, rows) == jax_tool.match_truth(
        truth, rows)


def test_scale_run_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The whole tool at a 100 kbp genome and 10x: the fit is left out by
    a ModelDist model already in the run's directory (the JAX package's
    golden Child model), with SCALE_MIN_COV's fixed cutoff, as a rerun
    over an earlier fit does."""
    _scale_modules(monkeypatch, tmp_path)
    monkeypatch.setenv("SCALE_MIN_COV", "5")
    run = tmp_path / "port" / "run"
    os.makedirs(run)
    stub = "child.R1.fastq.gz.generator.Jhash.histo.7.7"
    for ext in ("model", "dist"):
        with gzip.open(os.path.join(GOLDEN, f"Child.Jhash.histo.7.7.{ext}.gz"),
                       "rb") as src, open(run / f"{stub}.{ext}", "wb") as dst:
            shutil.copyfileobj(src, dst)
    out = scale_run.main(["t", "--device", "cpu", "--out",
                          str(tmp_path / "scale.json")])
    line = _last_json(capsys)
    assert line["genome_bp"] == 100_000 and line["device"] == "cpu"
    for key in ("recovered_by_kind", "vcf_rows", "pipeline_wall_s",
                "peak_rss_mb", "stage_wall_s", "count_passes"):
        assert key in line, key
    assert set(out["mem_stage_peaks"]) <= {"(pre)"} | set(out["stage_wall_s"])
    assert len(out["recovered"]) == out["spiked_total"] > 0
    assert [m["pos"] for m in out["mosaic_evidence"]] == [
        t["pos"] for t in out["recovered"] if t["kind"] == "mosaic"]
    assert os.path.exists(run / "child.R1.fastq.gz.generator.table.flat")


def test_scaling_tool_runs():
    """tools/scaling.py's measurements at a tiny size on CPU shards (its
    control flow; its times are measured only on cards): the two-shard
    table equals the one-shard table (the tool checks it), the phases
    time one flush of the buffered partials, the pairs cross only between
    shards, and the CLI refuses to run without a card."""
    results = [scaling.bench_mesh(make_mesh(n, "cpu"), per_shard=16,
                                  iters=2, reps=1) for n in (1, 2)]
    scaling.efficiencies(results)
    one, two = results
    assert one["unique_keys"] > 0 and two["reads"] == 2 * one["reads"]
    assert one["exchanged_pairs"] == 0 < two["exchanged_pairs"]
    assert one["count_scaling_eff"] == one["filter_scaling_eff"] == 1.0
    assert len(two["phase_ms"]) == 4
    assert two["shard_keys_mean"] * 2 == two["unique_keys"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scaling.main(["--out", "/dev/null"])
