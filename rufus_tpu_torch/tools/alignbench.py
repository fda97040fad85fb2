"""Read alignment at scale: a memmapped seed index and the batched DP.

    python -m rufus_tpu_torch.tools.alignbench [--mbp 64] [--reads 2000]
        [--device cuda] [--keep] [--out PATH]

The port of the JAX package's ``tools/alignbench.py``, which stays as the
reference. It builds a flat (memmapped) seed index
(``align.aligner.build_flat_index``, seed length 19) over a random genome
of --mbp Mi bases from ``numpy.random.default_rng(0)``, then aligns
--reads reads of 150 bases sampled from it (one substitution each, every
third one reverse-complemented: the JAX tool's reads) through the port's
``Aligner.align_seqs``, whose candidate DPs and tracebacks run as ragged
``sw_batch`` launches on --device. A first call on 64 reads warms up. It
reports alignments/s, the reads mapped, the index's file size and build
seconds, and the process's peak RSS (after the build and at the end), the
figure that shows the index is demand-paged rather than held in memory.

The index goes to ``build/alignbench.<mbp>mbp.flatidx`` beside the package
(reused if there, deleted at the end unless --keep). It runs on the card
unless ``--device cpu`` is given, raises when no card is there, prints one
JSON line and writes it to --out (by default ``build/alignbench.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import time

import numpy as np
import torch

from ..align.aligner import Aligner, build_flat_index, open_flat_index
from ..ops import _build, cuda_sw
from ..pipeline.driver import resolve_device
from .radixbench import card_name_and_power_limit

BUILD_DIR = os.path.dirname(_build.BUILD_ROOT)
DEFAULT_OUT = os.path.join(BUILD_DIR, "alignbench.json")


def rss_mb() -> float:
    """The process's peak resident set size so far, MB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def make_reads(genome: np.ndarray, n: int, rng):
    """The JAX tool's reads: 150 bases at random starts, the base at
    30 + t % 90 substituted, every third one reverse-complemented."""
    items = []
    G = len(genome)
    for t in range(n):
        start = int(rng.integers(0, G - 200))
        read = genome[start : start + 150].tobytes().decode()
        i = 30 + t % 90
        read = read[:i] + "ACGT"[("ACGT".index(read[i]) + 1) % 4] + read[i + 1:]
        if t % 3 == 0:
            read = read.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        items.append((f"r{t}", read, "I" * len(read)))
    return items


def run(dev: torch.device, mbp: int = 64, reads: int = 2000,
        keep: bool = False) -> dict:
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    G = mbp << 20
    genome = rng.choice(bases, size=G).astype(np.uint8)
    path = os.path.join(BUILD_DIR, f"alignbench.{mbp}mbp.flatidx")
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    if not os.path.exists(path):
        build_flat_index({"chr1": genome}, path, seed_len=19)
    build_s = time.perf_counter() - t0
    rss_after_build = rss_mb()
    try:
        al = Aligner(open_flat_index(path), device=dev)
        items = make_reads(genome, reads, rng)
        del genome
        al.align_seqs(items[:64])  # warm-up
        cuda_sw.sw_ragged.launches = 0
        t0 = time.perf_counter()
        out = al.align_seqs(items)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        index_mb = os.path.getsize(path) / 1e6
    finally:
        if not keep and os.path.exists(path):
            os.unlink(path)
    cuda = dev.type == "cuda"
    return {
        "genome_mbp": mbp,
        "index_file_mb": index_mb,
        "index_build_s": build_s,
        "reads": reads,
        "mapped": sum(1 for g in out if not g[0].is_unmapped),
        "alignments_per_s": reads / dt,
        "sw_launches": cuda_sw.sw_ragged.launches,
        "rss_mb_peak": rss_mb(),
        "rss_mb_after_index_build": rss_after_build,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "nvidia_smi": card_name_and_power_limit() if cuda else None,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=int, default=64)
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    out = run(resolve_device(args.device), args.mbp, args.reads, args.keep)
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
