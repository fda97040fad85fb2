"""No run loads JAX or the JAX package, compared by whole top-level
names; the reference imports nothing of the program; without a card the
measurement exits with no result."""

import os
import subprocess
import sys
import types

from benchmark.lib import harness
from benchmark.lib.registry import CHECKOUT


def _python(code: str):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=CHECKOUT)


def test_banned_names_are_whole_top_level_names(monkeypatch):
    for name in ("rufus_tpu_torch", "rufus_tpu_torch.ops", "jaxtyping",
                 "rufus_tpux"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "rufus_tpu.ops",
                        types.ModuleType("rufus_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.banned_modules() == ["jax", "rufus_tpu"]


def test_a_run_loads_no_banned_module():
    p = _python(
        "import sys, time; sys.path.insert(0, '.')\n"
        "from benchmark.lib import harness\n"
        "from benchmark.lib.registry import Registry\n"
        "cell = Registry().cell('fastq.front')\n"
        "r = harness.measure(cell, 4, 0.1, False, 'cpu', time.perf_counter(),"
        " 20000)\n"
        "assert r['correct'], r\n"
        "print(harness.banned_modules())\n")
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    p = _python(
        "import sys; sys.path.insert(0, '.')\n"
        "for n in ('rufus_tpu_torch', 'rufus_tpu', 'jax', 'jaxlib'):\n"
        "    sys.modules[n] = None\n"
        "from benchmark.gen import trio\n"
        "from benchmark.reference import compare, kmers\n"
        "t = trio.make_trio(20000, n_denovo=5, seed=1)\n"
        "e = compare.Expected(t, dict(k=25, subject_low_k=2, par_low_k=2,"
        " merge_min=5, filter_min_q=15, filter_k_threshold=1),"
        " dict(min_cov=2, max_hash_depth=100000000), 'cpu')\n"
        "print(len(e.hashlist) > 0, len(e.kept) > 0)\n")
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.split() == ["True", "True"]


def test_the_measurement_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        return  # the card's machine: the measurement runs there
    p = subprocess.run([sys.executable,
                        os.path.join(CHECKOUT, "benchmark", "run.py"),
                        "--workload", "fastq.front", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    assert "no CUDA device" in p.stderr
