"""Finds a cell's pieces by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix. A configuration is its file
(``configs[].file``), a traffic mix is ``benchmark/traffic/<traffic>.json``
and a per-layer metric is the reader ``benchmark/metrics/<metric>.py``, so a
later change adds a configuration, a mix or a metric with new files and
new entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH_DIR)


class Registry:
    """BENCHMARK.json at `root` and the files it names under `root`."""

    def __init__(self, root: str = CHECKOUT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.bench_dir = os.path.join(root, "benchmark")

    def _one(self, key: str, name: str) -> dict:
        hits = [e for e in self.spec[key] if e["name"] == name]
        if len(hits) != 1:
            raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")
        return hits[0]

    def config(self, name: str) -> dict:
        entry = self._one("configs", name)
        with open(os.path.join(self.root, entry["file"])) as f:
            return {**json.load(f), "name": name}

    def traffic(self, name: str) -> dict:
        path = os.path.join(self.bench_dir, "traffic", name + ".json")
        with open(path) as f:
            return {**json.load(f), "name": name}

    def metrics(self, kind: str, cell: str) -> list:
        """The `end_to_end` or `per_layer` entries that cell reports."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The `read(ctx)` function of ``benchmark/metrics/<metric>.py``."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def cell(self, name: str) -> dict:
        """Everything a run of cell `name` needs: its entry, configuration,
        traffic mix and metrics."""
        w = self._one("workloads", name)
        return {"name": name, "chips": w["chips"],
                "config": self.config(w["config"]),
                "traffic": self.traffic(w["traffic"]),
                "end_to_end": self.metrics("end_to_end", name),
                "per_layer": self.metrics("per_layer", name)}
