#!/usr/bin/env python3
"""Smoke run of rufus_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--genome-mbp 10]

Phases, each printing one JSON line; any failure exits non-zero:

1. device  - the card's name and count (fails without a CUDA device);
2. build   - compiles the CUDA kernels from rufus_tpu_torch/csrc/ (one
             nvcc per source, in parallel) and, beside them, the host
             decoders from rufus_tpu_torch/native/ (g++); prints the
             seconds of each and ptxas's register and shared-memory
             figures;
3. data    - writes a synthetic trio from --seed as paired FASTQ: a random
             genome of --genome-mbp Mbp, 30x of 150 bp pairs per sample
             (0.2% substitution errors, 2% low-quality bases), the child
             with 100 de novo SNVs at VAF 0.5; and the genome as the
             reference FASTA;
4. slice   - runs the port's pipeline from the FASTQ files (the native
             decoders; RufusPipeline, batch_size 65536,
             read_pad 160, k 25, the default ModelDist fit) through
             contig alignment (stop_after "contig_align": read alignment,
             assembly, contig alignment and the genotype pulls) with every
             kernel launch count set to 0 first; prints per-stage seconds
             (the model fit on its own line), unique k-mers, HashList
             size, kept pairs, peak device memory and the launches, then
             one line for each of align_reads, assemble and contig_align
             (wall s, device peak, reads aligned and mapped, duplicate
             pairs, contigs, contig alignments and splits, k-mers pulled
             from each sample's table, and each sw launch's pairs, DP
             cells, largest pair and bytes copied to the host) and one
             with how many spiked sites lie inside a mapped contig's
             primary alignment (recall, not a gate);
             checks every kernel launched, that no call returned H (the
             dense cuda_sw.sw_batch, the tests' view, launched 0 times),
             that kept pairs span >= 95 of the 100 spiked sites, and that
             contigs were aligned;
5. bam     - the same trio as coordinate-sorted aligned BAMs
             (synthetic.write_trio_bams: the FASTQ reads at their true
             positions, 0.5% of pairs unmapped, 0.1% extra secondary,
             duplicate and supplementary records), then the port's pipeline
             from the three BAMs with the launch counts set to 0: to the
             count tables (stop_after "jhash"), whose histograms must equal
             the FASTQ run's; then, with that run's ModelDist outputs
             copied in (the fit is a function of the histogram), resumed
             through the filter with no -q1/-q2 (the stranded pair stream of
             the child BAM). Checks tables, histograms, the HashList and the
             kept pair names against the FASTQ run, each kept pair's mates
             against its FASTQ mates (as an unordered pair), every pipeline
             kernel launched, >= 95 sites spanned; then single_end on the
             child BAM, whose kept (name, read) multiset must equal the
             FASTQ reads that filter_single keeps on the card. Prints each
             stage's wall seconds beside the FASTQ run's, decode rates,
             device peaks and the host's peak RSS;
6. kernels - each CUDA kernel against its plain PyTorch version on the card
             at the main path's shapes, exact equality: encode_canon on a
             65536-read batch; compact_runs in both of its main-path modes,
             raw on one real 96 Mi-key pending buffer and counted on the
             merge of that buffer's table with the next buffer's unique
             keys; window_hits on a mate-1 batch against the run's
             HashList and against a HashList of 65,536 keys (the run's,
             4,096 canonical windows of the batch, random 50-bit keys from
             --seed: most windows miss, and the keys no longer fit shared
             memory), with its prebuilt hashlist_index (index_ms times the
             build, once per HashList). Times each (CUDA
             events, warmed up), the plain version and, for raw
             compact_runs, torch.unique_consecutive as the library
             yardstick. bound_ms is the bytes each must move (inputs read
             once, outputs written once) over 3.35 TB/s, the H100 SXM
             data-sheet HBM rate. The work is integer arithmetic, for which
             the data sheet gives no non-tensor peak, so no operation term
             is counted. Every row carries share_of_bound = bound_ms / ms;
             a share above 1.05 fails the run (a kernel faster than the
             memory allows has skipped work). device_us gives, beside ms,
             each of a call's kernels' device time from torch.profiler, for
             compact_runs, window_hits and partition: compact_runs reads
             the unique count on the host in the middle of a call, so its
             ms includes the host's gaps (library_device_us is the same for
             torch.unique_consecutive). sw_batch (the fused DP and
             traceback, cuda_sw.sw_ragged) runs at the old read shape
             (256 pairs of n 160, m 288), at the contig stage's largest
             pair and on the slice's own read-alignment launch (its
             recorded (n, m), replayed), on random codes from --seed with
             2% N, every other window holding its query, both scorings
             held to the plain version; its rows give ms, device_us, the
             plain ms, out_copy_ms (the per-pair results and ops that
             cross to the host) and the bound: 15 integer operations a DP
             cell over 64 INT32 lanes x 132 SMs x nvidia-smi's
             clocks.max.sm, or the codes and results over 3.35 TB/s if
             larger. Before it a pulls line
             times the contig stage's genotype pulls (every k-mer of its
             two tabs against the three sample tables on the card, one
             torch.searchsorted a table) beside the host numpy query they
             must equal. The fold's two sorts
             are timed too: torch.sort of the pending buffer and the stable
             sort of a merge. A slice_busy line then reckons the card's busy
             time in the count and filter stages, launches x ms of the
             kernels and sorts, and in align_reads and contig_align, every
             sw launch the trace recorded replayed and timed with the copy
             of its results, beside each stage's wall time.
7. radix   - the radix tool's path (python -m rufus_tpu_torch.tools.radixbench
             at its default n, 25,993,216 random k 25 keys, with the
             partition and run-metadata counts set to 0 first), which prints
             its own JSON line; then the
             tool's timings on the subject's first pending buffer (the
             fold's real input, 106,954,752 keys with sentinels: its global
             torch.sort time is the fold's sort). The partition kernel is
             held to partition_torch exactly at both shapes, its output to
             the sorted input, and timed beside the plain version. No single
             PyTorch call gives block-sorted runs in bucket order, so it
             has no library yardstick.

Then the kernels line, the nvidia-smi name/power-limit line, and last the
{"ok": true, "device": ...} line.
"""

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
K, BATCH, READ_PAD, PENDING = 25, 65536, 160, 96 << 20
RADIX_N = 26_000_000  # the radix tool's default n (cut to 25,993,216)
LARGE_T, LARGE_HITS = 65536, 4096  # window_hits' second HashList


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


def device_us(fn, iters: int = 5) -> dict:
    """Mean device microseconds per call of fn, by kernel name, as
    torch.profiler saw them: the card's own work, without the host's gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / iters
            for e in prof.key_averages() if e.device_time_total > 0}


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def share_of_bound(row: dict) -> dict:
    """Adds share_of_bound = bound_ms / ms to a kernel row and to its nested
    rows; fails if the kernel beat its bound."""
    for r in [row] + [v for v in row.values()
                      if isinstance(v, dict) and "bound_ms" in v]:
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        if r["share_of_bound"] > 1.05:
            raise AssertionError(
                f"{row['name']} ran at {r['share_of_bound']:.2f} of its byte "
                "bound: faster than the memory allows, it skipped work")
    return row


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
    from concurrent.futures import ThreadPoolExecutor

    from rufus_tpu_torch.ops import _build

    def timed(fn):
        t = time.perf_counter()
        return fn(), time.perf_counter() - t

    # the kernels' nvcc processes and the host decoders' g++ at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        native = pool.submit(timed, _build.build_native)
        built, _ = timed(_build.build_all)
        so, native_s = native.result()
    ptxas = {name: [l.split("ptxas info    : ")[-1] for l in
                    b["ptxas"].splitlines() if "Used" in l]
             for name, b in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "native_seconds": native_s, "native_library": so, "ptxas": ptxas})


def phase_data(out_dir, genome_mbp, seed):
    from rufus_tpu_torch import synthetic

    t0 = time.perf_counter()
    data = synthetic.write_trio(out_dir, genome_bp=int(genome_mbp * 1e6),
                                coverage=30, n_denovo=100, seed=seed)
    data["ref"] = os.path.join(out_dir, "ref.fa")
    with open(data["ref"], "wb") as fh:
        fh.write(b">" + synthetic.REF_NAME.encode() + b"\n"
                 + data["genome"].tobytes() + b"\n")
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "genome_bp": int(genome_mbp * 1e6), "pairs_per_sample":
          data["pairs"], "fastq_bytes": sum(
              os.path.getsize(p) for s in ("child", "mother", "father")
              for p in data[s])})
    return data


def _kernels():
    """The kernels of the path through the filter."""
    from rufus_tpu_torch.ops import cuda_count, cuda_filter, cuda_fold

    return {"encode_canon": cuda_count.encode_canon,
            "compact_runs": cuda_fold.compact_runs,
            "window_hits": cuda_filter.window_hits}


def _sam_intervals(path):
    """[start, end) reference intervals (0-based) of a SAM's mapped
    primary records."""
    import re

    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fl = line.split("\t")
            if int(fl[1]) & 0x904:
                continue
            span = sum(int(n) for n, op in re.findall(r"(\d+)([MDN=X])",
                                                      fl[5]))
            out.append((int(fl[3]) - 1, int(fl[3]) - 1 + span))
    return out


def phase_slice(data, workdir):
    from rufus_tpu_torch import synthetic
    from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline

    from rufus_tpu_torch.ops import cuda_sw

    c, m, f = data["child"], data["mother"], data["father"]
    cfg = RufusConfig(subject=",".join(c), controls=[",".join(m), ",".join(f)],
                      k=K, batch_size=BATCH, read_pad=READ_PAD,
                      workdir=workdir, stop_after="contig_align",
                      fastq_a=c[0], fastq_b=c[1], ref=data["ref"],
                      device="cuda")
    pipe = RufusPipeline(cfg)
    kernels = dict(_kernels(), sw_batch=cuda_sw.sw_ragged)
    for fn in (*kernels.values(), cuda_sw.sw_batch):
        fn.launches = 0
    t0 = time.perf_counter()
    inputs = pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    stages = {s["stage"]: s for s in pipe.trace.stages}
    emit({"phase": "model", "seconds": stages["model"]["wall_s"]})
    keys = ("wall_s", "device_peak_bytes", "reads", "mapped",
            "duplicate_pairs", "contigs", "alignments", "splits", "pulled",
            "found", "dp")
    for name in ("align_reads", "assemble", "contig_align"):
        emit({"phase": name, **{k: stages[name][k] for k in keys
                                if k in stages[name]}})
    m1 = cfg.wpath(cfg.subject_stub + ".Mutations.Mate1.fastq")
    contig_sam = cfg.wpath(cfg.name_stub + ".overlap.hashcount.fastq.sam")
    spans = _sam_intervals(contig_sam)
    in_contig = sum(any(a <= s < b for a, b in spans) for s in data["sites"])
    emit({"phase": "contig_recall", "sites_in_contigs": int(in_contig),
          "sites": int(len(data["sites"])),
          "primary_alignments": len(spans),
          "sam_lines": len(inputs["stdin_lines"])})
    count_reads = sum(stages["count"]["reads"].values())
    with open(m1) as fh:
        kept = sum(1 for _ in fh) // 4
    spanned = synthetic.sites_spanned(m1, data["sites"])
    hl = [n for n in os.listdir(workdir) if n.endswith(".HashList")][0]
    info = {"phase": "slice", "wall_s": wall,
            "stage_wall_s": {n: s["wall_s"] for n, s in stages.items()},
            "unique_kmers": stages["count"]["unique_kmers"],
            "n_mutant": stages["hashlist"]["n_mutant"], "kept_pairs": kept,
            "sites_spanned": int(len(spanned)),
            "sites": int(len(data["sites"])),
            "device_peak_bytes": {n: s.get("device_peak_bytes")
                                  for n, s in stages.items()},
            "max_memory_allocated": max(s.get("device_peak_bytes", 0)
                                        for s in stages.values()),
            "launches": launches,
            "contigs": stages["assemble"]["contigs"],
            "contig_dp_largest": stages["contig_align"]["dp"]["largest"],
            "dp_launches": {n: stages[n]["dp"]["launches"]
                            for n in ("align_reads", "contig_align")},
            "folds": stages["count"]["folds"],
            "count_reads_per_s": count_reads / stages["count"]["wall_s"],
            "filter_pairs_per_s": (stages["filter"]["reads"]
                                   / stages["filter"]["wall_s"]),
            "host_peak_rss_bytes": peak_rss()}
    emit(info)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if cuda_sw.sw_batch.launches:
        raise AssertionError("the slice called the dense sw_batch, whose H "
                             "is the tests' view")
    if min(info["unique_kmers"].values()) <= 0 or info["n_mutant"] <= 0 \
            or kept <= 0 or info["max_memory_allocated"] <= 0:
        raise AssertionError("the slice produced an empty table, HashList "
                             "or filter output, or used no device memory")
    if len(spanned) < 95:
        raise AssertionError(f"kept pairs span {len(spanned)} of 100 spiked "
                             "sites (< 95)")
    if not spans or not inputs["stdin_lines"]:
        raise AssertionError("no contig was aligned")
    return info, os.path.join(workdir, hl)


def peak_rss() -> int:
    """The process's peak resident set so far, in bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _fastq_pairs(paths):
    """{name: sorted [(mate seq, qual)]} of a FASTQ pair."""
    from rufus_tpu_torch.io import fastq

    out = {}
    for p in paths:
        for name, seq, qual in fastq.read_fastq(p):
            out.setdefault(name.split(" ")[0], []).append((seq, qual))
    return {n: sorted(v) for n, v in out.items()}


def _fastq_records(path):
    with open(path) as f:
        lines = f.read().split("\n")
    return [tuple(lines[i:i + 4]) for i in range(0, len(lines) - 1, 4)]


def phase_bam(data, work, fastq_wd, fastq_info, seed):
    """The trio from BAMs through the filter, paired and single-end, held
    to the FASTQ run in fastq_wd (see the module's docstring)."""
    import collections

    import numpy as np

    from rufus_tpu_torch import synthetic
    from rufus_tpu_torch.convert import hashlist_keys_to_int64
    from rufus_tpu_torch.io import fastq, hashlist as hio
    from rufus_tpu_torch.ops.cuda_filter import hashlist_index
    from rufus_tpu_torch.ops.filter import filter_single
    from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline

    t0 = time.perf_counter()
    bams = synthetic.write_trio_bams(data, os.path.join(work, "bam"),
                                     seed=seed)
    emit({"phase": "bam_data", "seconds": time.perf_counter() - t0,
          "bam_bytes": {s: os.path.getsize(p) for s, p in bams.items()}})
    wd = os.path.join(work, "bam_run")
    fq_stub = {s: os.path.basename(data[s][0]) + ".generator"
               for s in ("child", "mother", "father")}
    bam_stub = {s: os.path.basename(p) + ".generator" for s, p in bams.items()}

    def cfg(workdir, **over):
        return RufusConfig(subject=bams["child"],
                           controls=[bams["mother"], bams["father"]], k=K,
                           batch_size=BATCH, read_pad=READ_PAD,
                           workdir=workdir, device="cuda", **over)

    kernels = _kernels()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    count_pipe = RufusPipeline(cfg(wd, stop_after="jhash"))
    count_pipe.run()
    torch.cuda.synchronize()
    read = lambda p: open(p, "rb").read()  # noqa: E731
    for s in bams:
        a = os.path.join(wd, bam_stub[s] + ".Jhash.histo")
        b = os.path.join(fastq_wd, fq_stub[s] + ".Jhash.histo")
        if read(a) != read(b):
            raise AssertionError(f"{s}: the BAM run's histogram differs "
                                 "from the FASTQ run's")
    for ext in (".Jhash.histo.7.7.model", ".Jhash.histo.7.7.dist"):
        shutil.copy(os.path.join(fastq_wd, fq_stub["child"] + ext),
                    os.path.join(wd, bam_stub["child"] + ext))
    pipe = RufusPipeline(cfg(wd, stop_after="filter"))
    m1 = pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    stages = {s["stage"]: s for s in count_pipe.trace.stages}
    stages.update({s["stage"]: s for s in pipe.trace.stages
                   if s["stage"] != "count"})

    # tables and histograms (above), HashList, kept pairs
    for s in bams:
        za = np.load(os.path.join(wd, bam_stub[s] + ".table.npz"))
        zb = np.load(os.path.join(fastq_wd, fq_stub[s] + ".table.npz"))
        if sorted(za.files) != sorted(zb.files) or not all(
                np.array_equal(za[k], zb[k]) for k in zb.files):
            raise AssertionError(f"{s}: the BAM run's table differs")
    hl = [n for n in os.listdir(wd) if n.endswith(".HashList")][0]
    fq_hl = [n for n in os.listdir(fastq_wd) if n.endswith(".HashList")][0]
    if read(os.path.join(wd, hl)) != read(os.path.join(fastq_wd, fq_hl)):
        raise AssertionError("the BAM run's HashList differs")
    fq_pairs = _fastq_pairs(data["child"])
    want = {r[0] for r in _fastq_records(os.path.join(
        fastq_wd, fq_stub["child"] + ".Mutations.Mate1.fastq"))}
    kept = list(zip(_fastq_records(m1), _fastq_records(
        m1.replace("Mate1", "Mate2"))))
    if {a[0] for a, _ in kept} != want:
        raise AssertionError("the BAM run kept other pairs than the FASTQ "
                             "run")
    for a, b in kept:
        if sorted([(a[1], a[3]), (b[1], b[3])]) != fq_pairs[a[0][1:]]:
            raise AssertionError(f"kept pair {a[0]} is not its FASTQ pair")
    spanned = synthetic.sites_spanned(m1, data["sites"])
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the BAM path never launched: "
                             f"{launches}")
    if len(spanned) < 95:
        raise AssertionError(f"kept pairs span {len(spanned)} of 100 sites")

    # single-end from the child BAM: its tables and HashList carried over,
    # so the run resumes at the filter
    se_wd = os.path.join(work, "bam_se")
    os.makedirs(se_wd)
    for n in os.listdir(wd):
        if n.endswith((".table.npz", ".Jhash.histo", ".Jelly.chr", ".model",
                       ".dist", ".HashList")):
            shutil.copy(os.path.join(wd, n), se_wd)
    t1 = time.perf_counter()
    se_pipe = RufusPipeline(cfg(se_wd, stop_after="filter", single_end=True))
    se_out = se_pipe.run()
    torch.cuda.synchronize()
    se_wall = time.perf_counter() - t1
    se_filter = [s for s in se_pipe.trace.stages if s["stage"] == "filter"][0]
    got = collections.Counter((r[0][1:], r[1]) for r in _fastq_records(se_out))
    table = hashlist_keys_to_int64(hio.hashlist_keys(os.path.join(wd, hl), K),
                                   "cuda")
    index = hashlist_index(table, K)
    expect = collections.Counter()
    for path in data["child"]:
        for b in fastq.fastq_batches(path, BATCH, READ_PAD, text=True,
                                     max_width=1024):
            r, q, l = (torch.from_numpy(a).cuda()
                       for a in (b.seq, b.qual, b.lens))
            keep, _ = filter_single(r, q, l, table, K, se_pipe.cfg.filter_min_q,
                                    se_pipe.cfg.filter_k_threshold, index)
            for i in np.flatnonzero(keep.cpu().numpy()):
                expect[(b.name(i), b.text(i)[0])] += 1
    if got != expect:
        raise AssertionError(f"single-end kept {sum(got.values())} reads, "
                             f"the card's reckoning {sum(expect.values())}")

    count_reads = sum(stages["count"]["reads"].values())
    info = {"phase": "bam", "wall_s": wall,
            "stage_wall_s": {n: s["wall_s"] for n, s in stages.items()},
            "fastq_stage_wall_s": fastq_info["stage_wall_s"],
            "unique_kmers": stages["count"]["unique_kmers"],
            "n_mutant": stages["hashlist"]["n_mutant"],
            "kept_pairs": len(kept), "sites_spanned": int(len(spanned)),
            "launches": launches,
            "count_reads_per_s": count_reads / stages["count"]["wall_s"],
            "fastq_count_reads_per_s": fastq_info["count_reads_per_s"],
            "filter_pairs_per_s": (stages["filter"]["reads"]
                                   / stages["filter"]["wall_s"]),
            "fastq_filter_pairs_per_s": fastq_info["filter_pairs_per_s"],
            "device_peak_bytes": {n: s.get("device_peak_bytes")
                                  for n, s in stages.items()},
            "single_end": {"wall_s": se_wall,
                           "filter_wall_s": se_filter["wall_s"],
                           "reads_per_s": (se_filter["reads"]
                                           / se_filter["wall_s"]),
                           "kept_reads": sum(got.values()),
                           "device_peak_bytes": se_filter.get(
                               "device_peak_bytes")},
            "host_peak_rss_bytes": peak_rss()}
    emit(info)
    return info


def pending_buffers(data):
    """The subject's pending buffers as the count stage fills them, unsorted:
    the raw window keys of consecutive batches, at least PENDING each."""
    from rufus_tpu_torch.io import fastq
    from rufus_tpu_torch.ops import cuda_count

    parts, n = [], 0
    for mate in data["child"]:
        for bb in fastq.fastq_batches(mate, BATCH, READ_PAD):
            reads = torch.from_numpy(bb.seq).to("cuda")
            parts.append(cuda_count.encode_canon(reads, K).reshape(-1))
            n += parts[-1].numel()
            if n >= PENDING:
                buf = torch.cat(parts)
                parts, n = [], 0
                yield buf


def large_hashlist(table, reads, seed):
    """A HashList of LARGE_T keys, sorted and unique, from `seed`: the run's
    keys, LARGE_HITS distinct canonical keys of windows of `reads`, and
    random 50-bit keys for the rest (so most windows miss, as they do
    against a real HashList)."""
    from rufus_tpu_torch.ops import codec, cuda_count

    g = torch.Generator(device="cpu").manual_seed(seed)
    wins = torch.unique(cuda_count.encode_canon(reads, K)).cpu()
    wins = wins[wins != codec.SENTINEL]
    picked = wins[torch.randperm(wins.numel(), generator=g)[:LARGE_HITS]]
    base = torch.unique(torch.cat([table.cpu(), picked]))
    pool = torch.unique(torch.randint(0, 1 << 50, (2 * LARGE_T,), generator=g))
    pool = pool[~torch.isin(pool, base)]
    pool = pool[torch.randperm(pool.numel(), generator=g)]
    out = torch.sort(torch.cat([base, pool[:LARGE_T - base.numel()]])).values
    assert out.numel() == LARGE_T and bool((out[1:] > out[:-1]).all())
    return out.to(reads.device)


def window_hits_row(r, q, l, table):
    """window_hits on one batch and table: error against the plain version,
    times, bound and each kernel's device time."""
    from rufus_tpu_torch.ops import cuda_filter

    B, L = r.shape
    T = table.numel()
    # the filter stage builds the index once per HashList
    index = cuda_filter.hashlist_index(table, K)
    call = lambda: cuda_filter.window_hits(  # noqa: E731
        r, q, l, table, K, 15, index)
    got = call()
    want = cuda_filter.window_hits_torch(r, q, l, table, K, 15)
    nbytes = 2 * B * L + 4 * B + 8 * T + 4 * B
    return {
        "name": "window_hits", "route": "cuda",
        "source": "rufus_tpu_torch/csrc/window_hits.cu",
        "replaces": "rufus_tpu/ops/pallas_filter.py:144",
        "max_abs_err": max_abs_err(got, want), "ms": time_ms(call, 50),
        "plain_ms": time_ms(
            lambda: cuda_filter.window_hits_torch(r, q, l, table, K, 15), 5),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None, "shape": [B, L], "table": T, "bytes": nbytes,
        "hits": int(got.sum()), "device_us": device_us(call),
        "index_bits": index.bits, "index_ms": time_ms(
            lambda: cuda_filter.hashlist_index(table, K), 10)}


INT32_LANES_PER_SM, SMS = 64, 132  # H100 SXM, Hopper white paper
SW_OPS_PER_CELL = 15  # csrc/sw_batch.cu's recurrence, counted in its note


def int32_ops_per_s() -> float:
    """The card's INT32 rate: 64 lanes an SM x 132 SMs x the SM clock that
    nvidia-smi reports as clocks.max.sm."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    return INT32_LANES_PER_SM * SMS * mhz * 1e6


def ragged_batch(shapes, seed):
    """A ragged sw batch on the card, packed as sw_device.sw_align packs it
    (largest n*m first): random codes from `seed` with 2% N, every other
    window holding its query. shapes: (n, m) a pair. Returns (codes, qoff,
    n, roff, m)."""
    import numpy as np

    from rufus_tpu_torch.ops import cuda_sw

    g = np.random.default_rng(seed)
    shapes = sorted(shapes, key=lambda s: -s[0] * s[1])
    qs, rs = [], []
    for p, (n, m) in enumerate(shapes):
        q = g.integers(0, 4, n).astype(np.uint8)
        r = g.integers(0, 4, m).astype(np.uint8)
        q[g.random(n) < 0.02] = 255
        r[g.random(m) < 0.02] = 255
        if p % 2 == 0 and m >= n:
            at = int(g.integers(0, m - n + 1))
            r[at:at + n] = q
        qs.append(q)
        rs.append(r)
    n = np.array([s[0] for s in shapes], np.int64)
    m = np.array([s[1] for s in shapes], np.int64)
    codes = torch.from_numpy(np.concatenate(qs + rs)).to("cuda")
    return (codes, cuda_sw.offsets(n), n, int(n.sum()) + cuda_sw.offsets(m),
            m)


def sw_row(shapes, seed, int_rate, plain_iters=1):
    """The fused DP and traceback (sw_ragged) on one ragged batch: both
    scorings held to the plain version (every result field and op); the
    call's ms, its kernel's device time, the plain version's ms, the copy
    of what crosses to the host (out_copy_ms) and the bound: the larger of
    15 integer operations a DP cell over the card's INT32 rate and the
    codes read and results written over 3.35 TB/s (the traceback, O(n+m)
    a pair, is left out)."""
    from rufus_tpu_torch.ops import cuda_sw

    codes, qoff, n, roff, m = ragged_batch(shapes, seed)
    err = 0
    for sc, gmax in (((1, -4, 6, 1), 128), ((1, -4, 6, 0), 1000)):
        got = cuda_sw.sw_ragged(codes, qoff, n, roff, m, *sc, gmax)
        want = cuda_sw.sw_ragged_torch(codes, qoff, n, roff, m, *sc, gmax)
        err = max(err, max_abs_err(got, want))
    args = (codes, qoff, n, roff, m, 1, -4, 6, 1, 128)
    call = lambda: cuda_sw.sw_ragged(*args)  # noqa: E731
    out = call()
    res = cuda_sw.unpack(out, len(n))[0]
    cells = int((n * m).sum())
    nbytes = int((n + m).sum()) + out.numel()
    op_ms = SW_OPS_PER_CELL * cells / int_rate * 1e3
    return {"max_abs_err": err, "ms": time_ms(call, 20),
            "plain_ms": time_ms(lambda: cuda_sw.sw_ragged_torch(*args),
                                plain_iters),
            "bound_ms": max(op_ms, bound_ms(nbytes)),
            "bound_by": "operations" if op_ms >= bound_ms(nbytes) else "bytes",
            "library_ms": None, "pairs": len(n), "cells": cells,
            "largest": [int(n[0]), int(m[0])], "bytes": nbytes,
            "ops_per_cell": SW_OPS_PER_CELL, "int32_ops_per_s": int_rate,
            "op_bound_ms": op_ms, "out_copy_ms": time_ms(lambda: out.cpu(), 5),
            "best_score_max": int(res[:, 0].max()),
            "ops_max": int(res[:, 6].max()), "device_us": device_us(call)}


def phase_pulls(workdir):
    """The genotype pulls of the slice's contig stage (ops/query.py, one
    torch.searchsorted a table) on its own tab k-mers against the three
    sample tables reloaded to the card: held to the host KmerTable.query
    and timed beside it."""
    import numpy as np

    from rufus_tpu_torch.convert import table_from_numpy
    from rufus_tpu_torch.ops import codec, count
    from rufus_tpu_torch.ops.query import query_counts

    names = sorted(os.listdir(workdir))
    hosts = [count.KmerTable.load(os.path.join(workdir, n))
             for n in names if n.endswith(".table.npz")]
    inter = os.path.join(workdir, "Intermediates")
    strs = []
    for n in sorted(os.listdir(inter)):
        if n.endswith(".Jhash.tab"):
            with open(os.path.join(inter, n)) as fh:
                strs += [line.split()[0] for line in fh]
    km = codec.strs_to_kmers([codec.canonical_str(s) for s in strs], K)
    devs = [table_from_numpy(t.keys, t.counts, "cuda", k=K) for t in hosts]
    got = query_counts(devs, km)
    want = np.stack([t.query(km) for t in hosts])
    t0 = time.perf_counter()
    for t in hosts:
        t.query(km)
    host_ms = (time.perf_counter() - t0) * 1e3
    info = {"phase": "pulls", "kmers": len(km), "tables": len(hosts),
            "table_keys": [len(t) for t in hosts],
            "max_abs_err": int(np.abs(got - want).max()),
            "found": [int(np.count_nonzero(c)) for c in got],
            "ms": time_ms(lambda: query_counts(devs, km), 10),
            "host_numpy_ms": host_ms}
    emit(info)
    if info["max_abs_err"] != 0:
        raise AssertionError("the device pulls disagree with the host query")
    return info


def phase_kernels(data, hl_path, launches, seed, contig_pair,
                  read_shapes):
    from rufus_tpu_torch.convert import hashlist_keys_to_int64
    from rufus_tpu_torch.io import fastq, hashlist as hio
    from rufus_tpu_torch.ops import cuda_count, cuda_fold

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
    buffers = pending_buffers(data)
    raw = next(buffers)
    pending_sort_ms = time_ms(lambda: torch.sort(raw), 3)
    s = torch.sort(raw).values
    del raw
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
        "shape": [s.numel()], "n_unique": gk.numel(), "bytes": nbytes,
        "pending_sort_ms": pending_sort_ms,
        "device_us": device_us(lambda: cuda_fold.compact_runs(s)),
        "library_device_us": device_us(
            lambda: torch.unique_consecutive(s, return_counts=True))}
    del s, wk, ws
    s2 = torch.sort(next(buffers)).values
    del buffers
    k2, c2 = cuda_fold.compact_runs(s2)
    del s2
    both = torch.cat([gk, k2])
    merge_sort_ms = time_ms(lambda: torch.sort(both, stable=True), 3)
    mk, order = torch.sort(both, stable=True)
    mc = torch.cat([gs, c2])[order]
    del gk, gs, k2, c2, order, both
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
        "bytes": nbytes, "merge_sort_ms": merge_sort_ms,
        "device_us": device_us(lambda: cuda_fold.compact_runs(mk, mc))}
    row["max_abs_err"] = max(err, cerr)
    rows.append(row)
    del mk, mc, gk, gs, wk, ws

    # window_hits: the run's HashList against a subject mate-1 batch, then
    # the same batch against a HashList of LARGE_T keys
    table = hashlist_keys_to_int64(hio.hashlist_keys(hl_path, K), dev)
    fb = next(fastq.fastq_batches(data["child"][0], BATCH, READ_PAD,
                                  text=True, max_width=1024))
    r, q, l = (torch.from_numpy(a).to(dev) for a in (fb.seq, fb.qual, fb.lens))
    row = window_hits_row(r, q, l, table)
    row["launches"] = launches["window_hits"]
    if row["hits"] <= 0:
        raise AssertionError("window_hits found no mutant window in a batch")
    big = window_hits_row(r, q, l, large_hashlist(table, r, seed))
    row["large_table"] = big
    row["max_abs_err"] = max(row["max_abs_err"], big["max_abs_err"])
    rows.append(row)
    del r, q, l, table, fb

    # sw_batch: the old read shape, the contig stage's largest pair and
    # the slice's own read-alignment launch, replayed
    rate = int32_ops_per_s()
    row = {"name": "sw_batch", "route": "cuda",
           "source": "rufus_tpu_torch/csrc/sw_batch.cu",
           "replaces": "rufus_tpu/align/sw_device.py:37",
           "launches": launches["sw_batch"],
           **sw_row([(160, 288)] * 256, seed, rate, 2)}
    row["contig"] = sw_row([tuple(contig_pair)], seed + 1, rate, 2)
    row["slice_launch"] = sw_row(read_shapes, seed + 2, rate)
    row["max_abs_err"] = max(row["max_abs_err"], row["contig"]["max_abs_err"],
                             row["slice_launch"]["max_abs_err"])
    rows.append(row)
    for row in rows:
        emit({"phase": "kernel", **share_of_bound(row)})
        if row["max_abs_err"] != 0:
            raise AssertionError(f"{row['name']} disagrees with its plain "
                                 f"version (max_abs_err {row['max_abs_err']})")
    return rows


def sw_busy(launches) -> dict:
    """sw_batch's kernel ms and the ms of what crosses to the host, summed
    over a stage's launches: each launch the trace recorded (its pairs'
    (n, m)) is replayed on random codes (the DP fills every cell whatever
    the codes; the walk's length follows them) and timed."""
    from rufus_tpu_torch.ops import cuda_sw

    kernel = copy = 0.0
    for launch in launches:
        shapes = [(n, m) for n, m, c in launch["shapes"] for _ in range(c)]
        args = (*ragged_batch(shapes, len(shapes)), 1, -4, 6, 1, 128)
        call = lambda: cuda_sw.sw_ragged(*args)  # noqa: E731
        out = call()
        kernel += time_ms(call, 3)
        copy += time_ms(lambda: out.cpu(), 3)
    return {"launches": len(launches), "sw_batch_ms": kernel,
            "out_copy_ms": copy}


def phase_slice_busy(sl, rows):
    """The card's busy time in the count and filter stages, reckoned as
    launches x ms of the kernels and of the fold's sorts as phase_kernels
    timed them (every fold sorts one pending buffer and compacts it raw;
    every later fold also merge-sorts and compacts with counts), and in
    the two alignment stages as their DP calls replayed (sw_busy), beside
    each stage's wall time."""
    by = {r["name"]: r for r in rows}
    enc, comp, win = by["encode_canon"], by["compact_runs"], by["window_hits"]
    folds = sl["folds"]
    merges = comp["launches"] - folds
    count_ms = (enc["launches"] * enc["ms"]
                + folds * (comp["pending_sort_ms"] + comp["ms"])
                + merges * (comp["counted"]["merge_sort_ms"]
                            + comp["counted"]["ms"]))
    filter_ms = win["launches"] * win["ms"]
    emit({"phase": "slice_busy", "folds": folds, "merges": merges,
          "count": {"busy_ms": count_ms,
                    "wall_s": sl["stage_wall_s"]["count"]},
          "filter": {"busy_ms": filter_ms,
                     "wall_s": sl["stage_wall_s"]["filter"]},
          **{name: {**sw_busy(launches), "wall_s": sl["stage_wall_s"][name]}
             for name, launches in sl["dp_launches"].items()}})


def phase_radix(data, work, seed):
    from rufus_tpu_torch.ops import cuda_partition as cp
    from rufus_tpu_torch.tools import radixbench

    cp.partition.launches = cp.run_metadata.launches = 0
    tool = radixbench.main(["--n", str(RADIX_N), "--k", str(K), "--seed",
                            str(seed), "--out",
                            os.path.join(work, "radixbench.json")])
    launches = cp.partition.launches
    meta_launches = cp.run_metadata.launches

    def check(keys):
        n = keys.numel()
        got, got_off = cp.partition(keys, K)
        want, want_off = cp.partition_torch(keys, K)
        err = max(max_abs_err(got, want), max_abs_err(got_off, want_off))
        if int(got_off[-1]) != n or not torch.equal(
                torch.sort(got).values, torch.sort(keys).values):
            raise AssertionError("partition's output is not its input "
                                 "reordered")
        del got, want
        meta = cp.run_metadata(keys, K)
        nbytes = 16 * n + 8 * meta[1].numel() + 8 * (cp.BUCKETS + 1)
        return {"max_abs_err": err,
                "ms": time_ms(lambda: cp.partition(keys, K), 10),
                "kernel_ms": time_ms(lambda: cp.partition(keys, K, meta), 10),
                "device_us": device_us(lambda: cp.partition(keys, K)),
                "plain_ms": time_ms(lambda: cp.partition_torch(keys, K), 3),
                "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                "library_ms": None, "shape": [n],
                "bucket_sizes": torch.diff(got_off).tolist(), "bytes": nbytes}

    keys = radixbench.random_keys(tool["n_keys"], K, seed, "cuda")
    row = {"name": "partition", "route": "cuda",
           "source": "rufus_tpu_torch/csrc/partition.cu",
           "replaces": "tools/radixbench.py:159", "launches": launches,
           "metadata_launches": meta_launches, **check(keys)}
    del keys
    raw = next(pending_buffers(data))
    fold = check(raw)
    emit({"phase": "radix", "on": "fold_buffer", **radixbench.measure(raw, K)})
    del raw
    row["fold_buffer"] = fold
    row["max_abs_err"] = max(row["max_abs_err"], fold["max_abs_err"])
    emit({"phase": "kernel", **share_of_bound(row)})
    if launches <= 0 or meta_launches <= 0:
        raise AssertionError("the radix tool's path never launched partition "
                             f"({launches}) or its metadata ({meta_launches})")
    if row["max_abs_err"] != 0:
        raise AssertionError(f"partition disagrees with its plain version "
                             f"(max_abs_err {row['max_abs_err']})")
    return row


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
        phase_bam(data, work, os.path.join(work, "run"), sl, args.seed)
        phase_pulls(os.path.join(work, "run"))
        reads = max(sl["dp_launches"]["align_reads"],
                    key=lambda x: x["pairs"])
        rows = phase_kernels(data, hl_path, sl["launches"], args.seed,
                             sl["contig_dp_largest"],
                             [(n, m) for n, m, c in reads["shapes"]
                              for _ in range(c)])
        phase_slice_busy(sl, rows)
        rows.append(phase_radix(data, work, args.seed))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "share_of_bound")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
