#!/usr/bin/env python3
"""Smoke run of rufus_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--genome-mbp 10]

Phases, each printing one JSON line; any failure exits non-zero:

1. device  - the card's name and count (fails without a CUDA device);
2. build   - compiles the CUDA kernels from rufus_tpu_torch/csrc/ (one
             nvcc per source, in parallel) and prints ptxas's register and
             shared-memory figures;
3. data    - writes a synthetic trio from --seed as paired FASTQ: a random
             genome of --genome-mbp Mbp, 30x of 150 bp pairs per sample
             (0.2% substitution errors, 2% low-quality bases), the child
             with 100 de novo SNVs at VAF 0.5;
4. slice   - runs the port's pipeline (RufusPipeline, batch_size 65536,
             read_pad 160, k 25, the default ModelDist fit) through the
             filter with every kernel launch count set to 0 first; prints
             per-stage seconds (the model fit on its own line), unique
             k-mers, HashList size, kept pairs, peak device memory and the
             launches; checks every kernel launched and that kept pairs
             span >= 95 of the 100 spiked sites;
5. kernels - each CUDA kernel against its plain PyTorch version on the card
             at the main path's shapes, exact equality: encode_canon on a
             65536-read batch; compact_runs in both of its main-path modes,
             raw on one real 96 Mi-key pending buffer and counted on the
             merge of that buffer's table with the next buffer's unique
             keys; window_hits on the run's HashList. Times each (CUDA
             events, warmed up), the plain version and, for raw
             compact_runs, torch.unique_consecutive as the library
             yardstick. bound_ms is the bytes each must move (inputs read
             once, outputs written once) over 3.35 TB/s, the H100 SXM
             data-sheet HBM rate. The work is integer arithmetic, for which
             the data sheet gives no non-tensor peak, so no operation term
             is counted.

Then the kernels line, the nvidia-smi name/power-limit line, and last the
{"ok": true, "device": ...} line.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
K, BATCH, READ_PAD, PENDING = 25, 65536, 160, 96 << 20


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build():
    from rufus_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    ptxas = {name: [l.split("ptxas info    : ")[-1] for l in
                    b["ptxas"].splitlines() if "Used" in l]
             for name, b in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})


def phase_data(out_dir, genome_mbp, seed):
    from rufus_tpu_torch import synthetic

    t0 = time.perf_counter()
    data = synthetic.write_trio(out_dir, genome_bp=int(genome_mbp * 1e6),
                                coverage=30, n_denovo=100, seed=seed)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "genome_bp": int(genome_mbp * 1e6), "pairs_per_sample":
          data["pairs"], "fastq_bytes": sum(
              os.path.getsize(p) for s in ("child", "mother", "father")
              for p in data[s])})
    return data


def _kernels():
    from rufus_tpu_torch.ops import cuda_count, cuda_filter, cuda_fold

    return {"encode_canon": cuda_count.encode_canon,
            "compact_runs": cuda_fold.compact_runs,
            "window_hits": cuda_filter.window_hits}


def phase_slice(data, workdir):
    from rufus_tpu_torch import synthetic
    from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline

    c, m, f = data["child"], data["mother"], data["father"]
    cfg = RufusConfig(subject=",".join(c), controls=[",".join(m), ",".join(f)],
                      k=K, batch_size=BATCH, read_pad=READ_PAD,
                      workdir=workdir, stop_after="filter", fastq_a=c[0],
                      fastq_b=c[1], device="cuda")
    pipe = RufusPipeline(cfg)
    kernels = _kernels()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    m1 = pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    stages = {s["stage"]: s for s in pipe.trace.stages}
    emit({"phase": "model", "seconds": stages["model"]["wall_s"]})
    with open(m1) as fh:
        kept = sum(1 for _ in fh) // 4
    spanned = synthetic.sites_spanned(m1, data["sites"])
    hl = [n for n in os.listdir(workdir) if n.endswith(".HashList")][0]
    info = {"phase": "slice", "wall_s": wall,
            "stage_wall_s": {n: s["wall_s"] for n, s in stages.items()},
            "unique_kmers": {stub: t.keys.numel()
                             for stub, t in pipe._dev_tables.items()},
            "n_mutant": stages["hashlist"]["n_mutant"], "kept_pairs": kept,
            "sites_spanned": int(len(spanned)),
            "sites": int(len(data["sites"])),
            "device_peak_bytes": {n: s.get("device_peak_bytes")
                                  for n, s in stages.items()},
            "max_memory_allocated": max(s.get("device_peak_bytes", 0)
                                        for s in stages.values()),
            "launches": launches}
    emit(info)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if min(info["unique_kmers"].values()) <= 0 or info["n_mutant"] <= 0 \
            or kept <= 0 or info["max_memory_allocated"] <= 0:
        raise AssertionError("the slice produced an empty table, HashList "
                             "or filter output, or used no device memory")
    if len(spanned) < 95:
        raise AssertionError(f"kept pairs span {len(spanned)} of 100 spiked "
                             "sites (< 95)")
    return info, os.path.join(workdir, hl)


def phase_kernels(data, hl_path, launches):
    from rufus_tpu_torch.convert import hashlist_keys_to_int64
    from rufus_tpu_torch.io import fastq, hashlist as hio
    from rufus_tpu_torch.ops import cuda_count, cuda_filter, cuda_fold

    dev = torch.device("cuda")
    rows = []

    # encode_canon: one count batch of the subject
    b = next(fastq.fastq_batches(data["child"][0], BATCH, READ_PAD))
    reads = torch.from_numpy(b.seq).to(dev)
    B, L = reads.shape
    W = L - K + 1
    got = cuda_count.encode_canon(reads, K)
    want = cuda_count.encode_canon_torch(reads, K)
    err = max_abs_err(got, want)
    rows.append({
        "name": "encode_canon", "route": "cuda",
        "source": "rufus_tpu_torch/csrc/encode_canon.cu",
        "replaces": "rufus_tpu/ops/pallas_count.py:89",
        "launches": launches["encode_canon"], "max_abs_err": err,
        "ms": time_ms(lambda: cuda_count.encode_canon(reads, K), 50),
        "plain_ms": time_ms(lambda: cuda_count.encode_canon_torch(reads, K), 5),
        "bound_ms": bound_ms(B * L + 8 * B * W), "bound_by": "bytes",
        "library_ms": None,
        "shape": [B, L], "bytes": B * L + 8 * B * W})

    # compact_runs, raw: one real pending buffer (the subject's first fold
    # input); counted: what the second fold merges (merge_sorted's input),
    # the first buffer's table with the next buffer's unique keys
    batches = (torch.from_numpy(bb.seq).to(dev) for mate in data["child"]
               for bb in fastq.fastq_batches(mate, BATCH, READ_PAD))

    def pending_buffer():
        parts, n = [], 0
        for bb in batches:
            parts.append(cuda_count.encode_canon(bb, K).reshape(-1))
            n += parts[-1].numel()
            if n >= PENDING:
                break
        return torch.sort(torch.cat(parts)).values

    s = pending_buffer()
    gk, gs = cuda_fold.compact_runs(s)
    wk, ws = cuda_fold.compact_runs_torch(s)
    err = max(max_abs_err(gk, wk), max_abs_err(gs, ws))
    nbytes = 8 * s.numel() + 16 * gk.numel()
    row = {
        "name": "compact_runs", "route": "cuda",
        "source": "rufus_tpu_torch/csrc/compact.cu",
        "replaces": "rufus_tpu/ops/pallas_fold.py:282",
        "launches": launches["compact_runs"],
        "ms": time_ms(lambda: cuda_fold.compact_runs(s), 10),
        "plain_ms": time_ms(lambda: cuda_fold.compact_runs_torch(s), 3),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": time_ms(
            lambda: torch.unique_consecutive(s, return_counts=True), 3),
        "shape": [s.numel()], "n_unique": gk.numel(), "bytes": nbytes}
    del s, wk, ws
    s2 = pending_buffer()
    k2, c2 = cuda_fold.compact_runs(s2)
    del s2
    mk, order = torch.sort(torch.cat([gk, k2]), stable=True)
    mc = torch.cat([gs, c2])[order]
    del gk, gs, k2, c2, order
    gk, gs = cuda_fold.compact_runs(mk, mc)
    wk, ws = cuda_fold.compact_runs_torch(mk, mc)
    cerr = max(max_abs_err(gk, wk), max_abs_err(gs, ws))
    nbytes = 16 * mk.numel() + 16 * gk.numel()
    row["counted"] = {
        "max_abs_err": cerr,
        "ms": time_ms(lambda: cuda_fold.compact_runs(mk, mc), 10),
        "plain_ms": time_ms(lambda: cuda_fold.compact_runs_torch(mk, mc), 3),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None, "shape": [mk.numel()], "n_unique": gk.numel(),
        "bytes": nbytes}
    row["max_abs_err"] = max(err, cerr)
    rows.append(row)
    del mk, mc, gk, gs, wk, ws

    # window_hits: the run's HashList against a subject mate-1 batch
    table = hashlist_keys_to_int64(hio.hashlist_keys(hl_path, K), dev)
    T = table.numel()
    fb = next(fastq.fastq_batches(data["child"][0], BATCH, READ_PAD,
                                  text=True, max_width=1024))
    r, q, l = (torch.from_numpy(a).to(dev) for a in (fb.seq, fb.qual, fb.lens))
    B, L = r.shape
    got = cuda_filter.window_hits(r, q, l, table, K, 15)
    want = cuda_filter.window_hits_torch(r, q, l, table, K, 15)
    err = max_abs_err(got, want)
    if int(got.sum()) <= 0:
        raise AssertionError("window_hits found no mutant window in a batch")
    nbytes = 2 * B * L + 4 * B + 8 * T + 4 * B
    rows.append({
        "name": "window_hits", "route": "cuda",
        "source": "rufus_tpu_torch/csrc/window_hits.cu",
        "replaces": "rufus_tpu/ops/pallas_filter.py:144",
        "launches": launches["window_hits"], "max_abs_err": err,
        "ms": time_ms(lambda: cuda_filter.window_hits(r, q, l, table, K, 15),
                      50),
        "plain_ms": time_ms(
            lambda: cuda_filter.window_hits_torch(r, q, l, table, K, 15), 5),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None, "shape": [B, L], "table": T, "bytes": nbytes})
    for row in rows:
        emit({"phase": "kernel", **row})
        if row["max_abs_err"] != 0:
            raise AssertionError(f"{row['name']} disagrees with its plain "
                                 f"version (max_abs_err {row['max_abs_err']})")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genome-mbp", type=float, default=10.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, REPO)
    import rufus_tpu_torch  # noqa: F401  (fails outside a checkout)

    info = phase_device()
    phase_build()
    work = os.path.join(REPO, "build", f"chip_smoke_{os.getpid()}")
    try:
        data = phase_data(os.path.join(work, "fastq"), args.genome_mbp,
                          args.seed)
        sl, hl_path = phase_slice(data, os.path.join(work, "run"))
        rows = phase_kernels(data, hl_path, sl["launches"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
