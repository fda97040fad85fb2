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
             reference FASTA, its contig named "1" (polish keeps only rows
             on contigs named (chr)?[1-9XY]);
4. slice   - runs the port's pipeline from the FASTQ files (the native
             decoders; RufusPipeline, batch_size 65536,
             read_pad 160, k 25, the default ModelDist fit) to
             FINAL.vcf.gz (the full run: read alignment, assembly, contig
             alignment and the genotype pulls, interpret, polish) with
             every kernel launch count set to 0 first; prints per-stage
             seconds (the model fit on its own line), unique k-mers,
             HashList size, kept pairs, peak device memory and the
             launches, then one line for each of align_reads, assemble and
             contig_align (wall s, device peak, reads aligned and mapped,
             duplicate pairs, contigs, contig alignments and splits, k-mers
             pulled from each sample's table, and each sw launch's pairs,
             DP cells, largest pair and bytes copied to the host), one with
             how many spiked sites lie inside a mapped contig's primary
             alignment (recall, not a gate), an interpret line (wall s,
             rows, rows by ID label and by FILTER), a polish line (wall s,
             FINAL.vcf rows, and the rows polish keeps with mosaic on the
             same interpret VCF) and a vcf_sites line (the spiked sites
             with a row at ("1", site+1) in each VCF; reported, not a
             gate); checks every kernel launched, that no call returned H
             (the dense cuda_sw.sw_batch, the tests' view, launched 0
             times), that kept pairs span >= 95 of the 100 spiked sites,
             that contigs were aligned, that interpret wrote rows, and that
             FINAL.vcf.gz and its .tbi exist and the tabix query over the
             whole contig returns FINAL.vcf's rows;
   sharded - the sharded chain on one card: a fresh pipeline on a mesh of
             four shards on cuda:0 (parallel.make_mesh(4, "cuda:0")) runs
             the trio from the FASTQ files to FINAL.vcf.gz with the launch
             counts set to 0, the FASTQ run's ModelDist outputs copied in
             and interpret's ##fileDate pinned to the FASTQ run's; it runs
             under the FASTQ run's workdir path, that run moved aside while
             it runs, since the VCF header names the workdir. Each sample's
             histogram and table, the HashList, the kept pairs, the contig
             stage's pull files and FINAL.vcf, its .gz and .tbi must equal the
             1-shard run's bytes, and every kernel of the path must launch. Prints the
             shards, each sample's flushes, exchanged (key, count) pairs
             and largest and mean unique keys a shard, each stage's wall
             time beside the 1-shard run's, the count stage's device peak,
             the launches, and which other files of the workdir differ (not
             a gate). Four shards on one card show placement and exactness,
             not scaling across cards;
   multiproc - tools.multiproc_smoke on the visible cards (an NCCL rank a
             card, two shards each), then the trio on a process mesh: one
             NCCL rank a visible card, spawned, four shards in all (one
             card: one rank of four shards), each rank decoding the FASTQ
             files and counting its rows of every batch (the range route),
             subtracting, filtering its rows of the subject's pairs and
             pulling its share of the contig stage's k-mers. Every rank's
             tables, HashList and pulls must equal the 1-shard run's, the
             ranks' kept pairs its Mutations.Mate1 names, and each rank's
             own encode_canon, compact_runs, merge_runs and window_hits
             must launch.
             Prints each rank's launches and seconds;
   regenotype - a fresh RufusPipeline on the slice's workdir re-genotypes
             its contigs against the parents' saved tables (.table.npz):
             its FINAL.vcf must equal the run's in every line but
             ##fileDate, and its FINAL.vcf.gz must inflate to it;
   memory  - the memory model: first the device bytes a key of a fold
             (fold_bytes line: a batch folded into an empty table, then a
             slice of the next merged into that table, and merge_sum of
             the same two runs, by torch.cuda.max_memory_allocated), then,
             with the FASTQ run's ModelDist outputs copied in and the
             launch counts set to 0,
             (a) the trio through the filter with spill_tables "on" and a
             budget 5% above the least that holds one batch, so that every
             sample spills LSM runs that merge-sum on the card: each
             .table.flat must hold the resident run's table, and the
             histograms, HashList and kept pairs must equal its bytes,
             every sample must spill >= 3 runs and the count stage's
             device peak stay within the budget; (b) count_passes 4
             through the count, the same tables and histograms; (c) a
             fresh pipeline on the FASTQ run's workdir regenotypes with
             the flat tables (the subject through _load_table, the
             parents by load_flat; the pulls bisect the memmaps): its
             FINAL.vcf must equal the run's but for ##fileDate. Prints
             each sample's runs, the device peaks against the budget, the
             count, merge, subtract and regenotype seconds, and the host
             peak RSS; fails if a fold's measured bytes a key pass the
             constants of ops/table.py;
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
             65536-read batch; compact_runs raw on the subject's last full
             batch of raw keys, as its fold sorts it; merge_runs of that
             batch's unique run into the table of every other batch of the
             subject (the count's last merge; bound 16 bytes a key of both
             runs and the union); compact_runs counted on the stable sort
             of the same two runs (merge_sum's route: counted parts and
             the flat runs' merge); window_hits on a mate-1 batch against
             the run's HashList and against a HashList of 65,536 keys
             (the run's, 4,096 canonical windows of the batch, random
             50-bit keys from --seed: most windows miss, and the keys no
             longer fit shared memory), with its prebuilt hashlist_index
             (index_ms times the build, once per HashList). Times each
             (CUDA events, warmed up), the plain version and, for raw
             compact_runs, torch.unique_consecutive as the library
             yardstick. bound_ms is the bytes each must move (inputs read
             once, outputs written once) over 3.35 TB/s, the H100 SXM
             data-sheet HBM rate. The work is integer arithmetic, for which
             the data sheet gives no non-tensor peak, so no operation term
             is counted. Every row carries share_of_bound = bound_ms / ms;
             a share above 1.05 fails the run (a kernel faster than the
             memory allows has skipped work). device_us gives, beside ms,
             each of a call's kernels' device time from torch.profiler, for
             compact_runs, merge_runs, window_hits and partition:
             compact_runs and merge_runs read the output's size on the
             host in the middle of a call, so their ms includes the
             host's gaps (library_device_us is the same for
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
             must equal. The fold's sort is timed too: torch.sort of the
             batch. A slice_busy line then reckons the card's busy time in
             the count and filter stages, launches x ms of the kernels and
             the sort, and in align_reads and contig_align, every
             sw launch the trace recorded replayed and timed with the copy
             of its results, beside each stage's wall time.
7. radix   - the radix tool's path (python -m rufus_tpu_torch.tools.radixbench
             at its default n, 25,993,216 random k 25 keys, with the
             partition and run-metadata counts set to 0 first), which prints
             its own JSON line; then the
             tool's timings on a buffer of the subject's first 12
             batches' raw keys, 106,954,752 with sentinels (the JAX
             package's flush size: its global torch.sort time is that
             package's fold sort). The partition kernel is
             held to partition_torch exactly at both shapes, its output to
             the sorted input, and timed beside the plain version. No single
             PyTorch call gives block-sorted runs in bucket order, so it
             has no library yardstick.

8. pack    - packed transport (ops/pack.py): with the unpack launch count
             set to 0, the subject's mate-1 FASTQ in batches of 65536 x 160
             is packed on the host (2-bit codes, N mask, a min_q 15 plane),
             copied on a side stream a batch ahead and unpacked on the card
             (pack.packed_feed), then counted into a DeviceKmerTable and
             filtered against the run's HashList; the table and hits must
             equal the same batches fed as ASCII, and unpack must launch
             once a batch. Then the unpack kernel against its plain
             versions (both planes, exactly) on the first batch and at
             tools/bench.py's shape (65536 x 152), its ms, device_us and
             bytes over 3.35 TB/s (no single PyTorch call unpacks bits
             through a table: no library yardstick), and for the feed
             decision each feed's costs a batch: the host's pack_reads and
             pack_qual_ok, and the pinned copies of the packed planes
             against the ASCII reads (count) and reads and quals (filter);
9. tools   - python -m rufus_tpu_torch.tools.bench, .sortbench and
             .alignbench --mbp 16, each its own process printing its own
             JSON line (relayed); a tools line sums them up and checks that
             the bench's path launched every kernel, unpack included, and
             that alignbench mapped >= 90% of its reads;
10. scaling - the scaling tool (python -m rufus_tpu_torch.tools.scaling)
             on a shard a visible card, or with one card on 1, 2 and 4
             shards of cuda:0: it prints its own JSON line (count, filter
             and pull rates and the count's phases), then
             a scaling line sums it up.

The slice's pipeline runs under a MemSampler (utils/trace.py, a sample a
second): a mem_stages line gives each stage's highest host RSS sample
with the card's allocated and reserved MB.

Then the kernels line, the nvidia-smi name/power-limit line, and last the
{"ok": true, "device": ...} line.
"""

import argparse
import gc
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
REF_CONTIG = "1"  # polish keeps rows on contigs named (chr)?[1-9XY] only
MEM_INTERVAL_S = 1.0  # the slice's MemSampler
ALIGNBENCH_MBP = 16  # the alignment tool's genome in the tools phase


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
        fh.write(b">" + REF_CONTIG.encode() + b"\n"
                 + data["genome"].tobytes() + b"\n")
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "genome_bp": int(genome_mbp * 1e6), "pairs_per_sample":
          data["pairs"], "fastq_bytes": sum(
              os.path.getsize(p) for s in ("child", "mother", "father")
              for p in data[s])})
    return data


def _kernels():
    """The kernels of the path through the filter."""
    from rufus_tpu_torch.ops import (cuda_count, cuda_filter, cuda_fold,
                                     cuda_merge)

    return {"encode_canon": cuda_count.encode_canon,
            "compact_runs": cuda_fold.compact_runs,
            "merge_runs": cuda_merge.merge_runs,
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


def slice_config(data, workdir):
    """The slice's configuration: the full run from the FASTQ files, on
    one shard of cuda:0 however many cards there are."""
    from rufus_tpu_torch.pipeline import RufusConfig

    c, m, f = data["child"], data["mother"], data["father"]
    return RufusConfig(subject=",".join(c), controls=[",".join(m), ",".join(f)],
                       k=K, batch_size=BATCH, read_pad=READ_PAD,
                       workdir=workdir, fastq_a=c[0], fastq_b=c[1],
                       ref=data["ref"], device="cuda", sharded="off")


def vcf_rows(path):
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh
                if not line.startswith("#")]


def phase_vcf(data, cfg, stages, final):
    """The interpret and polish lines, the spiked sites in the two VCFs,
    and the gates on FINAL.vcf: its .gz and .tbi exist, the tabix query
    over the whole contig returns its rows, and the interpret VCF has
    rows."""
    import tempfile

    from rufus_tpu_torch.io import bgzf
    from rufus_tpu_torch.pipeline.polish import polish_vcf

    vcf = final[: -len(".FINAL.vcf")] + ".vcf"
    rows, final_rows = vcf_rows(vcf), vcf_rows(final)
    label = lambda r: ("DeNovo" if "DeNovo" in r[2] else  # noqa: E731
                       "Mosaic" if "Mosaic" in r[2] else "other")
    by_id = {k: sum(label(r) == k for r in rows)
             for k in ("DeNovo", "Mosaic", "other")}
    emit({"phase": "interpret", "wall_s": stages["interpret"]["wall_s"],
          "rows": len(rows), "by_id": by_id,
          "by_filter": {"PASS": sum(r[6] == "PASS" for r in rows),
                        "other": sum(r[6] != "PASS" for r in rows)}})
    with tempfile.TemporaryDirectory(dir=cfg.workdir) as tmp:
        mosaic = vcf_rows(polish_vcf(vcf, os.path.join(tmp, "m.vcf"),
                                     with_mosaic=True))
    emit({"phase": "polish", "wall_s": stages["polish"]["wall_s"],
          "final_rows": len(final_rows), "with_mosaic_rows": len(mosaic)})
    sites = {int(s) + 1 for s in data["sites"]}
    at = lambda rs: len(sites & {int(r[1]) for r in rs  # noqa: E731
                                 if r[0] == REF_CONTIG})
    emit({"phase": "vcf_sites", "sites": len(sites), "in_vcf": at(rows),
          "in_final": at(final_rows)})
    for ext in (".gz", ".gz.tbi"):
        if not os.path.exists(final + ext):
            raise AssertionError(f"the full run wrote no FINAL.vcf{ext}")
    got = bgzf.tabix_query(final + ".gz", REF_CONTIG, 0,
                           len(data["genome"]))
    if got != sorted({"\t".join(r) for r in final_rows}):
        raise AssertionError("the tabix query over the contig does not "
                             "return FINAL.vcf's rows")
    if not rows:
        raise AssertionError("interpret wrote no row")


def phase_mem_stages(sampler, stages):
    """Each stage's sample with the highest host RSS (MemSampler, every
    MEM_INTERVAL_S seconds), with the card's allocated and reserved MB
    at that moment; every stage of two intervals or more must have a
    sample."""
    peaks = sampler.per_stage_peaks()
    keys = ("rss_mb", "cuda_allocated_mb", "cuda_reserved_mb",
            "heap_in_use_mb", "heap_retained_mb")
    emit({"phase": "mem_stages", "interval_s": sampler.interval,
          "samples": len(sampler.samples),
          "stages": {st: {k: p.get(k) for k in keys}
                     for st, p in peaks.items()}})
    missing = [s["stage"] for s in stages
               if s["wall_s"] >= 2 * sampler.interval
               and s["stage"] not in peaks]
    if missing:
        raise AssertionError(f"MemSampler took no sample in {missing}")


def phase_slice(data, workdir):
    from rufus_tpu_torch import synthetic
    from rufus_tpu_torch.pipeline import RufusPipeline
    from rufus_tpu_torch.utils.trace import MemSampler

    from rufus_tpu_torch.ops import cuda_sw

    cfg = slice_config(data, workdir)
    pipe = RufusPipeline(cfg)
    kernels = dict(_kernels(), sw_batch=cuda_sw.sw_ragged)
    for fn in (*kernels.values(), cuda_sw.sw_batch):
        fn.launches = 0
    sampler = MemSampler(pipe.trace, interval=MEM_INTERVAL_S).start()
    t0 = time.perf_counter()
    try:
        final = pipe.run()
        torch.cuda.synchronize()
    finally:
        sampler.stop()
    wall = time.perf_counter() - t0
    phase_mem_stages(sampler, pipe.trace.stages)
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
    sam_lines = stages["contig_align"]["sam_lines"]
    emit({"phase": "contig_recall", "sites_in_contigs": int(in_contig),
          "sites": int(len(data["sites"])),
          "primary_alignments": len(spans), "sam_lines": sam_lines})
    phase_vcf(data, cfg, stages, final)
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
    if not spans or not sam_lines:
        raise AssertionError("no contig was aligned")
    return info, os.path.join(workdir, hl)


def phase_regenotype(data, workdir):
    """--regenotype on the card: a fresh pipeline on the slice's workdir,
    the parents' saved tables; its FINAL.vcf must equal the run's in every
    line but ##fileDate."""
    from rufus_tpu_torch.ops import count
    from rufus_tpu_torch.pipeline import RufusPipeline

    cfg = slice_config(data, workdir)
    pipe = RufusPipeline(cfg)
    undated = lambda p: [line for line in open(p)  # noqa: E731
                         if not line.startswith("##fileDate=")]
    before = undated(pipe.final_path())
    tables = [count.KmerTable.load(cfg.wpath(cfg.control_stub(c)
                                             + ".table.npz"))
              for c in cfg.controls]
    t0 = time.perf_counter()
    final = pipe.regenotype(tables)
    torch.cuda.synchronize()
    after = undated(final)
    import gzip

    with gzip.open(final + ".gz", "rb") as f, open(final, "rb") as g:
        gz_equal = f.read() == g.read()
    emit({"phase": "regenotype", "wall_s": time.perf_counter() - t0,
          "final_rows": sum(not line.startswith("#") for line in after),
          "equal": after == before, "gz_equal": gz_equal})
    if after != before:
        raise AssertionError("regenotype's FINAL.vcf differs from the run's")
    if not gz_equal or not os.path.exists(final + ".gz.tbi"):
        raise AssertionError("regenotype left a FINAL.vcf.gz that does not "
                             "inflate to its FINAL.vcf, or no .tbi")





def fold_bytes() -> dict:
    """Device bytes a key costs at the peak of each step of a fold
    (tools/sortbench.py's fold_bytes at a count batch's raw keys): a batch
    folded into an empty table, then a slice of another folded into that
    table by merge_runs, the table's own bytes included, and merge_sum of
    the same two runs (the counted parts' and the flat runs' merge). The
    budget's constants (ops/table.py) must not be below them."""
    from rufus_tpu_torch.ops import table
    from rufus_tpu_torch.tools import sortbench

    info = {"phase": "fold_bytes", **sortbench.fold_bytes(
        BATCH * (READ_PAD - K + 1), 0, torch.device("cuda")),
            "constants": {"PENDING_BYTES": table.PENDING_BYTES,
                          "RUN_MERGE_BYTES": table.RUN_MERGE_BYTES,
                          "MERGE_BYTES": table.MERGE_BYTES}}
    emit(info)
    return info


def phase_memory(data, work, fastq_wd, fastq_info):
    """The memory model on the card (see the module's docstring): (a) the
    trio through the filter with spilled tables under a budget that makes
    every sample spill LSM runs, (b) a four-pass count, (c) a regenotype on
    flat tables; every output held to the resident FASTQ run's."""
    import numpy as np

    from rufus_tpu_torch.ops import count, cuda_sw, table
    from rufus_tpu_torch.pipeline import RufusPipeline

    # earlier phases' pipelines may linger in reference cycles, their
    # tables still on the card: collect them, so the budget's gate reads
    # the count's own bytes
    gc.collect()
    base = torch.cuda.memory_allocated()
    consts = fold_bytes()
    stub = {s: os.path.basename(data[s][0]) + ".generator"
            for s in ("child", "mother", "father")}
    # the least budget whose pending cap holds one batch, and 5% more
    budget = int(1.05 * table.CAP_BYTES * BATCH * (READ_PAD - K + 1))
    read = lambda p: open(p, "rb").read()  # noqa: E731

    def same_tables(wd, what):
        for s, st in stub.items():
            flat = count.KmerTable.load_flat(os.path.join(wd,
                                                          st + ".table.flat"))
            z = np.load(os.path.join(fastq_wd, st + ".table.npz"))
            if not (np.array_equal(flat.keys, z["keys"])
                    and np.array_equal(flat.counts, z["counts"])):
                raise AssertionError(f"{what}: {s}'s flat table differs from "
                                     "the resident run's")
            if read(os.path.join(wd, st + ".Jhash.histo")) != read(
                    os.path.join(fastq_wd, st + ".Jhash.histo")):
                raise AssertionError(f"{what}: {s}'s histogram differs")

    def stages_of(pipe):
        return {s["stage"]: s for s in pipe.trace.stages}

    # (a) LSM runs and spilled tables, through the filter
    wd = os.path.join(work, "mem_lsm")
    os.makedirs(wd)
    for ext in (".Jhash.histo.7.7.model", ".Jhash.histo.7.7.dist"):
        shutil.copy(os.path.join(fastq_wd, stub["child"] + ext), wd)
    kernels = _kernels()
    for fn in kernels.values():
        fn.launches = 0
    cfg = slice_config(data, wd)
    cfg.stop_after, cfg.spill_tables = "filter", "on"
    cfg.hbm_budget_gb = budget / 2**30
    pipe = RufusPipeline(cfg)
    t0 = time.perf_counter()
    m1 = pipe.run()
    torch.cuda.synchronize()
    lsm_wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    st = stages_of(pipe)
    lsm = {"wall_s": lsm_wall, "budget_bytes": budget,
           "device_allocated_before_bytes": base,
           "lsm_runs": st["count"]["lsm_runs"],
           "count_device_peak_bytes": st["count"]["device_peak_bytes"],
           "count_wall_s": st["count"]["wall_s"],
           "merge_s": st["count"]["merge_s"],
           "folds": st["count"]["folds"],
           "subtract_wall_s": st["hashlist"]["wall_s"],
           "subtract_path": st["hashlist"]["path"],
           "subtract_device_peak_bytes": st["hashlist"]["device_peak_bytes"],
           "filter_wall_s": st["filter"]["wall_s"],
           "unique_kmers": st["count"]["unique_kmers"],
           "count_mem": st["count"]["mem"], "launches": launches,
           "resident_count_wall_s": fastq_info["stage_wall_s"]["count"],
           "resident_count_device_peak_bytes":
               fastq_info["device_peak_bytes"]["count"]}
    emit({"phase": "memory_lsm", **lsm})
    same_tables(wd, "LSM run")
    hl = [n for n in os.listdir(fastq_wd) if n.endswith(".HashList")][0]
    if read(os.path.join(wd, hl)) != read(os.path.join(fastq_wd, hl)):
        raise AssertionError("the spilled run's HashList differs")
    for mate in (m1, m1.replace("Mate1", "Mate2")):
        if read(mate) != read(os.path.join(fastq_wd,
                                           os.path.basename(mate))):
            raise AssertionError(f"the spilled run's {os.path.basename(mate)}"
                                 " differs")
    if min(lsm["lsm_runs"].get(s, 0) for s in stub.values()) < 3:
        raise AssertionError(f"a sample spilled fewer than 3 LSM runs: "
                             f"{lsm['lsm_runs']}")
    if lsm["count_device_peak_bytes"] - base > budget:
        raise AssertionError("the count stage passed its device budget")
    if lsm["subtract_path"] != "host-stream" or min(launches.values()) <= 0:
        raise AssertionError(f"the spilled run took the resident path or "
                             f"left a kernel unlaunched: {launches}")

    # (b) four passes
    wd_p = os.path.join(work, "mem_passes")
    cfg = slice_config(data, wd_p)
    cfg.stop_after, cfg.count_passes = "jhash", 4
    pipe = RufusPipeline(cfg)
    pipe.run()
    torch.cuda.synchronize()
    st = stages_of(pipe)
    passes = {"count_wall_s": st["count"]["wall_s"],
              "count_device_peak_bytes": st["count"]["device_peak_bytes"],
              "folds": st["count"]["folds"],
              "unique_kmers": st["count"]["unique_kmers"]}
    emit({"phase": "memory_passes", "passes": 4, **passes})
    same_tables(wd_p, "4-pass count")

    # (c) regenotype on flat tables, in the FASTQ run's workdir (the VCF
    # names it): the subject through _load_table, the parents by load_flat
    flats = [os.path.join(fastq_wd, s + ".table.flat") for s in stub.values()]
    for s in stub.values():
        shutil.copy(os.path.join(wd, s + ".table.flat"), fastq_wd)
    try:
        regen = RufusPipeline(slice_config(data, fastq_wd))
        undated = lambda p: [line for line in open(p)  # noqa: E731
                             if not line.startswith("##fileDate=")]
        before = undated(regen.final_path())
        parents = [count.KmerTable.load_flat(os.path.join(
            fastq_wd, stub[s] + ".table.flat")) for s in ("mother", "father")]
        if not regen._load_table(stub["child"]).mapped:
            raise AssertionError("the subject's table did not open flat")
        cuda_sw.sw_ragged.launches = 0
        t0 = time.perf_counter()
        final = regen.regenotype(parents)
        torch.cuda.synchronize()
        regen_wall = time.perf_counter() - t0
        after = undated(final)
    finally:
        for f in flats:
            if os.path.exists(f):
                os.remove(f)
    info = {"phase": "memory", "budget_bytes": budget,
            "fold_bytes": {k: consts[k] for k in (
                "pending_bytes_per_key", "run_merge_bytes_per_key",
                "merge_sum_bytes_per_key")},
            "lsm_runs": lsm["lsm_runs"],
            "count_device_peak_bytes": lsm["count_device_peak_bytes"],
            "count_wall_s": lsm["count_wall_s"], "merge_s": lsm["merge_s"],
            "subtract_wall_s": lsm["subtract_wall_s"],
            "passes_count_wall_s": passes["count_wall_s"],
            "passes_count_device_peak_bytes":
                passes["count_device_peak_bytes"],
            "regenotype_wall_s": regen_wall,
            "regenotype_sw_launches": cuda_sw.sw_ragged.launches,
            "regenotype_equal": after == before,
            "host_peak_rss_bytes": peak_rss()}
    emit(info)
    if (consts["pending_bytes_per_key"] > table.PENDING_BYTES
            or consts["run_merge_bytes_per_key"] > table.RUN_MERGE_BYTES
            or consts["merge_sum_bytes_per_key"] > table.MERGE_BYTES):
        raise AssertionError("a fold takes more device bytes a key than the "
                             "budget's constants in ops/table.py reckon")
    if after != before:
        raise AssertionError("the regenotype on flat tables gave another "
                             "FINAL.vcf than the run's")
    if cuda_sw.sw_ragged.launches <= 0:
        raise AssertionError("the regenotype on flat tables launched no "
                             "sw_batch")
    return info


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


def phase_sharded(data, work, fastq_wd, fastq_info):
    """The trio to FINAL.vcf.gz on four shards of cuda:0, held to the
    1-shard FASTQ run in fastq_wd (see the module's docstring)."""
    import types

    import numpy as np

    import rufus_tpu_torch.interpret.driver as interpret_driver
    from rufus_tpu_torch.ops import cuda_sw
    from rufus_tpu_torch.parallel import make_mesh
    from rufus_tpu_torch.pipeline import RufusPipeline

    gc.collect()
    one = os.path.join(work, "run_one_shard")
    os.rename(fastq_wd, one)
    try:
        os.makedirs(fastq_wd)
        cfg = slice_config(data, fastq_wd)
        cfg.sharded = "on"
        for ext in (".7.7.model", ".7.7.dist", ".7.7.prob"):
            shutil.copy(os.path.join(one, cfg.subject_stub + ".Jhash.histo"
                                     + ext), fastq_wd)
        vcf = os.path.join(one, cfg.name_stub
                           + ".overlap.hashcount.fastq.bam.vcf")
        date = next(int(line.split("=", 1)[1]) for line in open(vcf)
                    if line.startswith("##fileDate="))
        kernels = dict(_kernels(), sw_batch=cuda_sw.sw_ragged)
        for fn in kernels.values():
            fn.launches = 0
        clock = interpret_driver.time
        interpret_driver.time = types.SimpleNamespace(time=lambda: date)
        try:
            pipe = RufusPipeline(cfg, mesh=make_mesh(4, "cuda:0"))
            t0 = time.perf_counter()
            final = pipe.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            interpret_driver.time = clock
        launches = {name: fn.launches for name, fn in kernels.items()}
        stages = {s["stage"]: s for s in pipe.trace.stages}

        def read(*p):
            with open(os.path.join(*p), "rb") as f:
                return f.read()

        stubs = [cfg.subject_stub] + [cfg.control_stub(c)
                                      for c in cfg.controls]
        gated = [st + ".Jhash.histo" for st in stubs]
        gated += [n for n in os.listdir(one) if n.endswith(".HashList")
                  or ".Mutations.Mate" in n]
        gated += [os.path.join("Intermediates", n)
                  for n in os.listdir(os.path.join(one, "Intermediates"))
                  if n.endswith((".sample", ".Jhash", ".RepRefHash"))]
        gated += [os.path.basename(final) + ext for ext in ("", ".gz",
                                                             ".gz.tbi")]
        differ = [n for n in gated if not os.path.exists(
            os.path.join(fastq_wd, n)) or read(fastq_wd, n) != read(one, n)]
        for st in stubs:
            za = np.load(os.path.join(fastq_wd, st + ".table.npz"))
            zb = np.load(os.path.join(one, st + ".table.npz"))
            if sorted(za.files) != sorted(zb.files) or not all(
                    np.array_equal(za[k], zb[k]) for k in zb.files):
                differ.append(st + ".table.npz")
        others = []
        for root, _, names in os.walk(one):
            for n in names:
                rel = os.path.relpath(os.path.join(root, n), one)
                if (rel not in gated and not rel.endswith(".table.npz")
                        and n != "trace.jsonl"
                        and (not os.path.exists(os.path.join(fastq_wd, rel))
                             or read(fastq_wd, rel) != read(one, rel))):
                    others.append(rel)
        hl = [n for n in gated if n.endswith(".HashList")][0]
        with open(os.path.join(fastq_wd, hl)) as f:
            n_mutant = sum(1 for _ in f)
        m1 = [n for n in gated if n.endswith(".Mate1.fastq")][0]
        with open(os.path.join(fastq_wd, m1)) as f:
            kept = sum(1 for _ in f) // 4
        count = stages["count"]
        info = {"phase": "sharded", "shards": pipe.mesh.n,
                "devices": [str(d) for d in pipe.mesh.devices],
                "wall_s": wall, "flushes": count["flushes"],
                "exchanged_keys": count["exchanged_keys"],
                "shard_keys_max": count["shard_keys_max"],
                "shard_keys_mean": count["shard_keys_mean"],
                "unique_kmers": count["unique_kmers"],
                "stage_wall_s": {n: [s["wall_s"],
                                     fastq_info["stage_wall_s"].get(n)]
                                 for n, s in stages.items()},
                "count_device_peak_bytes": count.get("device_peak_bytes"),
                "one_shard_count_device_peak_bytes":
                    fastq_info["device_peak_bytes"]["count"],
                "launches": launches, "hashlist_lines": n_mutant,
                "kept_pairs": kept, "compared_files": len(gated) + len(stubs),
                "differ": differ, "other_files_differ": others}
        emit(info)
    finally:
        os.rename(fastq_wd, os.path.join(work, "run_sharded"))
        os.rename(one, fastq_wd)
    if differ:
        raise AssertionError(f"the 4-shard run differs from the 1-shard run "
                             f"in {differ}")
    if min(launches.values()) <= 0 or info["shards"] != 4:
        raise AssertionError(f"a kernel of the sharded path never launched: "
                             f"{launches}")
    return info


def fastq_batches(paths):
    """A sample's count batches, as the count stage reads them: each FASTQ
    file in turn, (BATCH, READ_PAD) uint8 host tensors."""
    import numpy as np

    from rufus_tpu_torch.io import native

    lens = np.zeros(BATCH, np.int32)
    for path in paths:
        with native.NativeFastq(path) as nf:
            while True:
                seq = torch.empty((BATCH, READ_PAD), dtype=torch.uint8)
                n = len(nf.read_batch(BATCH, READ_PAD,
                                      out=(seq.numpy(), lens))[0])
                if n == 0:
                    break
                yield seq[:n]


def trio_params(data, workdir):
    """The slice's stubs, floors and subtract parameters (its ModelDist
    cutoff and depth, read as stage_model reads them) and its HashList's
    keys."""
    from rufus_tpu_torch.io import hashlist as hio

    cfg = slice_config(data, workdir)
    with open(cfg.wpath(cfg.subject_stub + ".Jhash.histo.7.7.model")) as f:
        lines = f.read().split("\n")
    hl = [n for n in os.listdir(workdir) if n.endswith(".HashList")][0]
    return {"stubs": [cfg.subject_stub] + [cfg.control_stub(c)
                                           for c in cfg.controls],
            "lows": [cfg.subject_low_k, cfg.par_low_k, cfg.par_low_k],
            "subtract": (cfg.merge_min, int(lines[1]), int(lines[3]) * 5),
            "hashlist": hio.hashlist_keys(os.path.join(workdir, hl), K)}


def multiproc_rank(mesh, data, workdir):
    """One NCCL rank of the multiproc phase: the trio from the FASTQ files
    (its rows of every batch) through the count (the range route, the
    pipeline's), the subtract, the filter of the subject's pairs and the
    pulls of its share of the contig stage's k-mers, each held to the
    1-shard run in workdir. Returns what it checked and its launches."""
    import numpy as np

    from rufus_tpu_torch.io import native
    from rufus_tpu_torch.ops import codec, count
    from rufus_tpu_torch.parallel import (ShardedKmerTable, local_count_step,
                                          local_rows, replicate_hashlist,
                                          sharded_filter_step,
                                          sharded_query_multi,
                                          sharded_subtract_step)

    kernels = _kernels()
    for fn in kernels.values():
        fn.launches = 0
    p = trio_params(data, workdir)
    cfg = slice_config(data, workdir)
    seconds = {}
    t0 = time.perf_counter()
    tables, splitters = [], None
    for s, low in zip(("child", "mother", "father"), p["lows"]):
        t = ShardedKmerTable(mesh, K, splitters=splitters)
        for b in fastq_batches(data[s]):
            t.fold_batch(local_count_step(mesh, local_rows(mesh, b), K))
        t.flush()
        splitters = t.splitters
        t.apply_lower_count(low)
        tables.append(t)
    torch.cuda.synchronize()
    seconds["count"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mk, _ = sharded_subtract_step(tables[0], tables[1:], *p["subtract"])
    seconds["subtract"] = time.perf_counter() - t0
    hl = replicate_hashlist(mesh, mk, K)
    kept = []
    t0 = time.perf_counter()
    scratch = [np.empty((BATCH, 1024), np.uint8) if i % 3 < 2
               else np.empty(BATCH, np.int32) for i in range(6)]
    with native.NativeFastqPairs(cfg.fastq_a, cfg.fastq_b) as fp:
        while True:
            names, *arrays = fp.read_pair_batch(BATCH, 1024, out=scratch)
            if len(names) == 0:
                break
            mine = local_rows(mesh, np.arange(len(names)))
            mates = [[torch.from_numpy(np.ascontiguousarray(
                a[mine][:, :READ_PAD] if a.ndim == 2 else a[mine]))
                for a in arrays[m:m + 3]] for m in (0, 3)]
            keep = sharded_filter_step(mesh, mates, hl, K, cfg.filter_min_q,
                                       cfg.filter_k_threshold).numpy()
            kept += [names[int(i)] for i in mine[keep]]
    seconds["filter"] = time.perf_counter() - t0
    km = tab_kmers(workdir)
    t0 = time.perf_counter()
    pulls = sharded_query_multi(tables, local_rows(mesh, km))
    seconds["pulls"] = time.perf_counter() - t0
    differ = []
    hosts = []
    for stub, t in zip(p["stubs"], tables):
        want = count.KmerTable.load(os.path.join(workdir, stub + ".table.npz"))
        got = t.to_host()
        hosts.append(want)
        if not (np.array_equal(got.keys, want.keys)
                and np.array_equal(got.counts, want.counts)):
            differ.append(stub + ".table.npz")
    if not np.array_equal(codec.keys_i64_to_u64(mk.cpu().numpy()),
                          p["hashlist"]):
        differ.append("HashList")
    if not np.array_equal(pulls, np.stack([h.query(local_rows(mesh, km))
                                           for h in hosts])):
        differ.append("pulls")
    return {"differ": np.array(differ, dtype=str),
            "kept": np.array(kept, dtype=str),
            "launches": np.array([fn.launches for fn in kernels.values()]),
            "seconds": np.array([seconds[k] for k in
                                 ("count", "subtract", "filter", "pulls")]),
            "shards": np.array([mesh.first, mesh.local])}


def phase_multiproc(data, workdir):
    """tools.multiproc_smoke on the visible cards, then the trio on a
    process mesh: one NCCL rank a visible card, four shards in all (one
    card: one rank of four shards), held to the 1-shard run in workdir
    (see the module's docstring)."""
    import numpy as np

    from rufus_tpu_torch.tools import multiproc_smoke

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    multiproc_smoke.main([])
    smoke_s = time.perf_counter() - t0
    world = torch.cuda.device_count()
    local = max(1, 4 // world)
    t0 = time.perf_counter()
    ranks = multiproc_smoke.spawn_ranks(multiproc_rank, world, "cuda", local,
                                        (data, workdir), timeout=600)
    wall = time.perf_counter() - t0
    m1 = [n for n in os.listdir(workdir) if n.endswith(".Mutations.Mate1"
                                                       ".fastq")][0]
    with open(os.path.join(workdir, m1)) as f:
        want = sorted(line[1:].rstrip("\n")
                      for i, line in enumerate(f) if i % 4 == 0)
    got = sorted(str(n) for r in ranks for n in r["kept"])
    names = list(_kernels())
    info = {"phase": "multiproc", "smoke_s": smoke_s, "ranks": world,
            "shards": world * local, "wall_s": wall,
            "per_rank": [{"first_shard": int(r["shards"][0]),
                          "local_shards": int(r["shards"][1]),
                          "launches": dict(zip(names,
                                               r["launches"].tolist())),
                          "seconds": dict(zip(
                              ("count", "subtract", "filter", "pulls"),
                              r["seconds"].tolist())),
                          "kept_pairs": len(r["kept"]),
                          "differ": r["differ"].tolist()} for r in ranks],
            "kept_pairs": len(got), "kept_equal": got == want}
    emit(info)
    if not info["kept_equal"] or any(len(r["differ"]) for r in ranks):
        raise AssertionError("the process mesh's trio differs from the "
                             "1-shard run")
    if any(int(min(r["launches"])) <= 0 for r in ranks):
        raise AssertionError("a kernel of the path never launched on a rank")
    return info


def phase_scaling(work):
    """The scaling tool on the visible cards, or on 1, 2 and 4 shards of
    cuda:0 with one card; it prints its own line."""
    from rufus_tpu_torch.tools import scaling

    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--out", os.path.join(work, "scaling.json")]
    if torch.cuda.device_count() < 2:
        argv += ["--shards-on", "cuda:0"]
    t0 = time.perf_counter()
    out = scaling.main(argv)
    emit({"phase": "scaling", "seconds": time.perf_counter() - t0,
          "layout": out["layout"],
          "count_reads_per_s": {r["shards"]: r["count_reads_per_s"]
                                for r in out["results"]}})
    return out


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
                           workdir=workdir, device="cuda", sharded="off",
                           **over)

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
    """Buffers of the subject's raw window keys, unsorted: consecutive
    batches, at least PENDING keys each (the JAX package's flush size)."""
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


def last_fold(data):
    """The subject's last full fold as the count stage makes it from its
    FASTQ mates: a DeviceKmerTable of every other batch (no floor) and the
    raw keys of the last full batch, not yet folded."""
    from rufus_tpu_torch.io import fastq
    from rufus_tpu_torch.ops import cuda_count, table

    t = table.DeviceKmerTable(K, torch.device("cuda"))
    last = None
    for mate in data["child"]:
        for bb in fastq.fastq_batches(mate, BATCH, READ_PAD):
            keys = cuda_count.encode_canon(
                torch.from_numpy(bb.seq).to("cuda"), K).reshape(-1)
            if bb.seq.shape[0] < BATCH:
                t.fold_batch(keys)
                continue
            if last is not None:
                t.fold_batch(last)
            last = keys
    t.flush()
    return t, last


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


def tab_kmers(workdir):
    """The canonical k-mers of the contig stage's tabs (uint64), the
    genotype pulls' queries."""
    from rufus_tpu_torch.ops import codec

    inter = os.path.join(workdir, "Intermediates")
    strs = []
    for n in sorted(os.listdir(inter)):
        if n.endswith(".Jhash.tab"):
            with open(os.path.join(inter, n)) as fh:
                strs += [line.split()[0] for line in fh]
    return codec.strs_to_kmers([codec.canonical_str(s) for s in strs], K)


def phase_pulls(workdir):
    """The genotype pulls of the slice's contig stage (ops/query.py, one
    torch.searchsorted a table) on its own tab k-mers against the three
    sample tables reloaded to the card: held to the host KmerTable.query
    and timed beside it."""
    import numpy as np

    from rufus_tpu_torch.convert import table_from_numpy
    from rufus_tpu_torch.ops import count
    from rufus_tpu_torch.ops.query import query_counts

    names = sorted(os.listdir(workdir))
    hosts = [count.KmerTable.load(os.path.join(workdir, n))
             for n in names if n.endswith(".table.npz")]
    km = tab_kmers(workdir)
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
    from rufus_tpu_torch.ops import cuda_count, cuda_fold, cuda_merge

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

    # compact_runs, raw: the subject's last full batch, as its fold sorts
    # and compacts it; merge_runs: that batch's unique run into the table
    # of every earlier batch, the count's last merge; compact_runs,
    # counted: merge_sum's route on the same two runs
    t, raw = last_fold(data)
    pending_sort_ms = time_ms(lambda: torch.sort(raw), 10)
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
    runs = (t.keys, t.counts, gk, gs)
    uk, uc = cuda_merge.merge_runs(*runs)
    wk, ws = cuda_merge.merge_runs_torch(*runs)
    nbytes = 16 * (t.n_keys + gk.numel() + uk.numel())
    merge = {
        "name": "merge_runs", "route": "cuda",
        "source": "rufus_tpu_torch/csrc/merge.cu",
        "replaces": "none (rufus_tpu/parallel/sharded.py:684-686 sorts)",
        "launches": launches["merge_runs"],
        "max_abs_err": max(max_abs_err(uk, wk), max_abs_err(uc, ws)),
        "ms": time_ms(lambda: cuda_merge.merge_runs(*runs), 10),
        "plain_ms": time_ms(lambda: cuda_merge.merge_runs_torch(*runs), 3),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None, "shape": [t.n_keys, gk.numel()],
        "n_union": uk.numel(), "bytes": nbytes,
        "device_us": device_us(lambda: cuda_merge.merge_runs(*runs))}
    del runs, uk, uc, wk, ws
    both = torch.cat([t.keys, gk])
    mk, order = torch.sort(both, stable=True)
    mc = torch.cat([t.counts, gs])[order]
    t.release()
    del gk, gs, order, both
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
        "bytes": nbytes,
        "device_us": device_us(lambda: cuda_fold.compact_runs(mk, mc))}
    row["max_abs_err"] = max(err, cerr)
    rows += [row, merge]
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
    launches x ms of the kernels and of the fold's sort as phase_kernels
    timed them (every fold sorts one batch and compacts it raw, and merges
    its unique run into the table unless the table is empty; a counted
    compaction, merge_sum's, is on no route of one shard), and in the two
    alignment stages as their DP calls replayed (sw_busy), beside each
    stage's wall time."""
    by = {r["name"]: r for r in rows}
    enc, comp, win = by["encode_canon"], by["compact_runs"], by["window_hits"]
    merge = by["merge_runs"]
    folds = sl["folds"]
    counted = comp["launches"] - folds
    count_ms = (enc["launches"] * enc["ms"]
                + folds * (comp["pending_sort_ms"] + comp["ms"])
                + merge["launches"] * merge["ms"]
                + counted * comp["counted"]["ms"])
    filter_ms = win["launches"] * win["ms"]
    emit({"phase": "slice_busy", "folds": folds,
          "merges": merge["launches"], "counted_compactions": counted,
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


def best_host_ms(fn, reps: int = 3) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def unpack_row(pk, nm, ok, L):
    """The unpack kernel on one batch's planes: both planes against the
    plain versions, times, bound and device time."""
    from rufus_tpu_torch.ops import cuda_pack

    B = pk.shape[0]
    call = lambda: cuda_pack.unpack(pk, nm, ok, L)  # noqa: E731
    r, q = call()
    err = max(max_abs_err(r, cuda_pack.unpack_reads_torch(pk, nm, L)),
              max_abs_err(q, cuda_pack.unpack_qual_torch(ok, L)))
    nbytes = pk.numel() + nm.numel() + ok.numel() + 2 * B * L
    return {"max_abs_err": err, "ms": time_ms(call, 50),
            "plain_ms": time_ms(lambda: (
                cuda_pack.unpack_reads_torch(pk, nm, L),
                cuda_pack.unpack_qual_torch(ok, L)), 5),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": None, "shape": [B, L], "bytes": nbytes,
            "device_us": device_us(call)}


def feed_costs(seq, qual):
    """What each feed costs a batch: the host's pack_* of the numpy batch
    and the pinned copies of the packed planes against the ASCII batch
    (reads alone for the count, reads and quals for the filter)."""
    from rufus_tpu_torch.ops import pack

    dev = torch.device("cuda")
    _, (pk, nm, ok) = pack.pack_batch(seq, qual, 15, pin=True)
    s, q = (torch.from_numpy(a).pin_memory() for a in (seq, qual))
    copy = lambda *ts: lambda: [t.to(dev, non_blocking=True)  # noqa: E731
                                for t in ts]
    return {"pack_reads_ms": best_host_ms(lambda: pack.pack_reads(seq)),
            "pack_qual_ok_ms": best_host_ms(
                lambda: pack.pack_qual_ok(qual, 15)),
            "h2d_packed_count_ms": time_ms(copy(pk, nm), 20),
            "h2d_ascii_count_ms": time_ms(copy(s), 20),
            "h2d_packed_filter_ms": time_ms(copy(pk, nm, ok), 20),
            "h2d_ascii_filter_ms": time_ms(copy(s, q), 20),
            "packed_bytes_count": pk.numel() + nm.numel(),
            "ascii_bytes_count": s.numel(),
            "packed_bytes_filter": pk.numel() + nm.numel() + ok.numel(),
            "ascii_bytes_filter": s.numel() + q.numel()}


def phase_pack(data, hl_path):
    """Packed transport on the card. The path, with the unpack launch
    count set to 0 just before it and read just after: the subject's
    mate-1 FASTQ in batches of BATCH x READ_PAD, each packed on the host
    (pack_batch, min_q 15), copied on a side stream a batch ahead and
    unpacked by the kernel (pack.packed_feed), then counted into a
    DeviceKmerTable and filtered by window_hits against the run's
    HashList; the table and the hits must equal those of the same
    batches fed as ASCII. Then the kernel against its plain versions on
    the first such batch and at tools/bench.py's shape (L 152), both
    planes exactly, timed beside its byte bound; and each feed's host
    and copy costs a batch."""
    from rufus_tpu_torch.convert import hashlist_keys_to_int64
    from rufus_tpu_torch.io import fastq, hashlist as hio
    from rufus_tpu_torch.ops import cuda_filter, pack
    from rufus_tpu_torch.ops.table import DeviceKmerTable, count_step
    from rufus_tpu_torch.pipeline import RufusPipeline
    from rufus_tpu_torch.tools import bench

    dev = torch.device("cuda")
    fbs = list(fastq.fastq_batches(data["child"][0], BATCH, READ_PAD,
                                   text=True))
    batches = [(b.seq, b.qual) for b in fbs]
    lens = [torch.from_numpy(b.lens).to(dev) for b in fbs]
    table = hashlist_keys_to_int64(hio.hashlist_keys(hl_path, K), dev)
    index = cuda_filter.hashlist_index(table, K)

    def count_and_filter(feed):
        t = DeviceKmerTable(K, dev)
        hits = []
        for (r, q), n in zip(feed, lens):
            t.fold_batch(count_step(r, K))
            hits.append(cuda_filter.window_hits(r, q, n, table, K, 15,
                                                index))
        t.flush()
        return t, torch.cat(hits)

    ascii_t, ascii_hits = count_and_filter(
        (torch.from_numpy(s).to(dev), torch.from_numpy(q).to(dev))
        for s, q in batches)
    pack.unpack.launches = 0
    t0 = time.perf_counter()
    packed_t, packed_hits = count_and_filter(pack.packed_feed(
        RufusPipeline._prefetch((pack.pack_batch(s, q, 15, pin=True)
                                 for s, q in batches), depth=2), dev))
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = pack.unpack.launches
    equal = (torch.equal(ascii_t.keys, packed_t.keys)
             and torch.equal(ascii_t.counts, packed_t.counts)
             and torch.equal(ascii_hits, packed_hits))
    reads = sum(len(s) for s, _ in batches)
    del ascii_t, packed_t

    def planes(seq, qual):
        _, ts = pack.pack_batch(seq, qual, 15)
        return [t.to(dev) for t in ts]

    seq, qual = batches[0]
    row = {"name": "unpack", "route": "cuda",
           "source": "rufus_tpu_torch/csrc/unpack.cu",
           "replaces": "rufus_tpu/ops/pack.py:66", "launches": launches,
           **unpack_row(*planes(seq, qual), READ_PAD)}
    bseq, bqual = bench.make_inputs(BATCH, 1)[0][0]
    row["bench_shape"] = unpack_row(*planes(bseq, bqual), bench.L)
    row["max_abs_err"] = max(row["max_abs_err"],
                             row["bench_shape"]["max_abs_err"])
    share_of_bound(row)
    emit({"phase": "pack", "batches": len(batches), "reads": reads,
          "path_s": path_s, "launches": launches, "equal": equal,
          "kept_reads": int((packed_hits >= 1).sum()),
          "feed": feed_costs(seq, qual),
          "feed_bench_shape": feed_costs(bseq, bqual)})
    emit({"phase": "kernel", **row})
    if not equal:
        raise AssertionError("the packed feed's table or hits differ from "
                             "the ASCII feed's")
    if launches != len(batches):
        raise AssertionError(f"the packed feed launched unpack {launches} "
                             f"times for {len(batches)} batches")
    if row["max_abs_err"] != 0:
        raise AssertionError(f"unpack disagrees with its plain versions "
                             f"(max_abs_err {row['max_abs_err']})")
    return row


TOOLS = (
    ("bench", [], 600),
    ("sortbench", [], 300),
    ("alignbench", ["--mbp", str(ALIGNBENCH_MBP)], 600),
)


def phase_tools(work):
    """The bench, sort and alignment tools, each as its own process
    (python -m rufus_tpu_torch.tools.<name>); each prints its own JSON
    line, relayed here, and the tools line sums them up."""
    gc.collect()
    torch.cuda.empty_cache()
    summary, outs = {}, {}
    for name, argv, limit in TOOLS:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", f"rufus_tpu_torch.tools.{name}", *argv,
             "--out", os.path.join(work, f"{name}.json")], cwd=REPO,
            capture_output=True, text=True, timeout=limit)
        seconds = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"tools.{name} failed ({p.returncode}):\n"
                                 f"{p.stdout[-4000:]}{p.stderr[-4000:]}")
        line = p.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        outs[name] = out = json.loads(line)
        summary[name] = {"seconds": seconds, "device": (
            out.get("detail", out)["device"])}
    bench, align = outs["bench"], outs["alignbench"]
    d = bench["detail"]
    summary["bench"].update(
        value=bench["value"], vs_baseline=bench["vs_baseline"],
        count_reads_per_s=d["count_reads_per_s"],
        filter_reads_per_s=d["filter_reads_per_s"],
        count_with_h2d_reads_per_s=d["count_with_h2d_reads_per_s"],
        filter_with_h2d_reads_per_s=d["filter_with_h2d_reads_per_s"],
        launches=d["launches"])
    summary["alignbench"].update(
        genome_mbp=align["genome_mbp"], mapped=align["mapped"],
        reads=align["reads"], alignments_per_s=align["alignments_per_s"])
    emit({"phase": "tools", **summary})
    if min(d["launches"].values()) <= 0:
        raise AssertionError(f"the bench tool's path left a kernel "
                             f"unlaunched: {d['launches']}")
    if align["mapped"] < 0.9 * align["reads"]:
        raise AssertionError(f"alignbench mapped {align['mapped']} of "
                             f"{align['reads']} reads")
    if any(v["device"] == "cpu" for v in summary.values()):
        raise AssertionError("a tool ran on the CPU")


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
        phase_sharded(data, work, os.path.join(work, "run"), sl)
        phase_multiproc(data, os.path.join(work, "run"))
        phase_regenotype(data, os.path.join(work, "run"))
        phase_memory(data, work, os.path.join(work, "run"), sl)
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
        rows.append(phase_pack(data, hl_path))
        phase_tools(work)
        phase_scaling(work)
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
