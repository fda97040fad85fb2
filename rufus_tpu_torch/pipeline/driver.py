"""The RUFUS trio pipeline on CUDA devices: count -> model -> subtract
-> filter -> align reads -> assemble -> align contigs and pull genotype
counts -> interpret -> polish (runRufus.sh and Overlap.shorter.sh), from
BAM, CRAM or FASTQ to <name>.FINAL.vcf, its bgzipped .vcf.gz and .tbi.

Every stage writes its outputs into the workdir under the reference's file
names and is skipped when they already exist (runRufus.sh:844-951 resume
semantics). Inputs are BAM, CRAM or FASTQ, a comma-separated list of them
streamed in sequence; the decoder is chosen by each part's extension.
BAM and FASTQ go through the native C++ decoders (``io/native.py``)
straight into pinned host memory, CRAM through the pure-Python reader.
Counting and filtering run those batches from a reader thread through the
CUDA kernels of ``ops/``; the sample tables stay on the device from
counting to the subtract. The filter takes pairs from -q1/-q2 FASTQ or
from the subject BAM/CRAM (the stranded pair stream), or single-end reads
from the subject.

The memory model (the JAX package's, driver.py:278-551 there) lets a run
count past what the device holds: under ``hbm_budget_gb`` a sample's
count spills its committed table as sorted flat runs and merge-sums them
at the end; ``count_passes`` counts disjoint key ranges one pass each; and
``spill_tables`` sends finished tables to ``.table.flat`` memmaps, which
the subtract streams through the device chunk by chunk and the genotype
pulls bisect on the host.

Read and contig alignment run the seed-and-extend aligner (``align/``)
with every batched candidate DP and its traceback on the device (the
``sw_batch`` CUDA kernel, one launch a group); assembly is host Python
(``assembly/``); the genotype pulls search the resident sample tables on
the device (``ops/query.py``). Interpret (``interpret/``) and polish
(``polish.py``) are host Python, as in the JAX package. Besides ``run``
(stopping after cfg.stop_after, or the full run), the entry points are
``run_longread`` (the PacBio path) and ``regenotype`` (new control tables
against the contigs in the workdir).

The count, subtract, filter and pulls run on a mesh of shards
(``parallel/sharded.py``): every visible card with sharded "auto" or "on",
or the mesh a caller passes, such as several shards on one card. On more
than one shard each sample's table is range-partitioned over the shards
(one set of splitters for every sample of the run), the subtract is local
to each shard, the filter cuts each batch over the shards with the
HashList replicated, and the pulls are routed to the owner shards; one
shard keeps the single-table path. Alignment, assembly, interpret and
polish run on the first shard's device, as the JAX package's aligner runs
on the default device.
"""

from __future__ import annotations

import collections
import gc
import os
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .config import RufusConfig
from .polish import polish_vcf
from ..align import Aligner, RefIndex
from ..align import sam as rsam
from ..align.aligner import MOB_SCORING, build_flat_index, open_flat_index
from ..assembly import annotate
from ..assembly.overlap_rounds import overlap_region, overlap_round
from ..assembly.overlap_sam import overlap_sam
from ..convert import hashlist_keys_to_int64, table_from_numpy
from ..interpret import run_interpret
from ..io import (bgzf, bwaindex, cram, fasta, fastq, hashlist as hio,
                  native, progress)
from ..models import modeldist
from ..ops import codec, count
from ..ops.cuda_filter import hashlist_index
from ..ops.filter import filter_pairs, filter_single
from ..ops.table import (MERGE_BYTES, DeviceKmerTable, count_step,
                         PENDING_KEYS, make_splitters, select_range,
                         subtract_step)
from ..parallel import sharded
from ..utils import shims
from ..utils.trace import StageTimer, malloc_trim, memory_attribution

FASTQ_EXT = (".fastq", ".fq", ".fastq.gz", ".fq.gz")
STOP_STAGES = ("", "jhash", "hashlist", "filter", "contig_align")  # "": all
MAX_READ = 1024  # the filter cuts reads only beyond this length

_RefId = collections.namedtuple("_RefId", "ref_id")


class _RefWrap:
    """The reference as interpret reads it: contig_array(name)."""

    def __init__(self, contigs):
        self.seqs = contigs

    def contig_array(self, name):
        return self.seqs[name]


@dataclass
class SamLikeRec:
    """The fields of a mutant-read SAM record that assembly reads."""

    flag: int
    seq: str
    qual: str
    tlen: int = 0


def _dp_summary(launches) -> dict:
    """The trace's record of an aligner's batched DP launches (each a list
    of its pairs' (n, m)): how many, their pairs and DP cells, the (n, m)
    of the largest pair, and for each launch its pairs, cells, largest pair,
    the bytes its results take to the host (28 a pair and n+m of ops) and
    every (n, m) with its number of pairs."""
    def one(pairs):
        return {"pairs": len(pairs), "cells": sum(n * m for n, m in pairs),
                "host_bytes": sum(28 + n + m for n, m in pairs),
                "largest": list(max(pairs, key=lambda x: (x[0] * x[1], x))),
                "shapes": [[*shape, c] for shape, c in
                           sorted(collections.Counter(pairs).items())]}

    each = [one(pairs) for pairs in launches]
    return {"calls": len(each), "pairs": sum(e["pairs"] for e in each),
            "cells": sum(e["cells"] for e in each),
            "host_bytes": sum(e["host_bytes"] for e in each),
            "largest": max((e["largest"] for e in each),
                           key=lambda x: (x[0] * x[1], x), default=None),
            "launches": each}


def input_kind(path: str) -> str:
    """"fastq", "cram" or "bam" (any other extension), by extension."""
    if path.endswith(FASTQ_EXT):
        return "fastq"
    return "cram" if path.endswith(".cram") else "bam"


def resolve_device(name: str) -> torch.device:
    """The torch device a run uses; "cuda" without a CUDA device raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA device "
                           "is available (pass device='cpu' to run the "
                           "plain PyTorch versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


class RufusPipeline:
    def __init__(self, cfg: RufusConfig,
                 mesh: sharded.ShardMesh | None = None):
        """`mesh`: the shards of the count, subtract, filter and pulls;
        None builds it from cfg.device (every visible card on "cuda", one
        shard on "cuda:i" or "cpu"), one shard with sharded "off"."""
        t0 = time.perf_counter()
        self.cfg = cfg
        if mesh is None:
            mesh = sharded.make_mesh(1 if cfg.sharded == "off" else None,
                                     resolve_device(cfg.device))
        elif cfg.sharded == "off" and mesh.n > 1:
            raise ValueError(f"sharded='off' with a mesh of {mesh.n} shards")
        elif mesh.world > 1:
            raise ValueError("the pipeline runs in one process; a process "
                             "mesh drives the library steps of parallel/")
        self.mesh = mesh
        self.device = mesh.devices[0]
        os.makedirs(cfg.workdir, exist_ok=True)
        os.makedirs(cfg.wpath("Intermediates"), exist_ok=True)
        os.makedirs(cfg.wpath("TempOverlap"), exist_ok=True)
        self._log = print
        self.trace = StageTimer(log_path=cfg.wpath("Intermediates",
                                                   "trace.jsonl"),
                                devices=mesh.cards, shards=mesh.n)
        self._dev_tables: dict = {}  # stub -> DeviceKmerTable, or
        # ShardedKmerTable on more than one shard (resident)
        self._splitters = None  # the run's partition, from its first count
        self._shard_stats: dict = {}  # stub -> its sharded count's stats
        self._reads: dict = {}  # stub -> reads counted
        self._folds: dict = {}  # stub -> folds of its count
        self._fold_keys_max: dict = {}  # stub -> most keys one fold took
        self._runs: dict = {}  # stub -> LSM runs its count spilled
        self._merge_s: dict = {}  # stub -> seconds merging those runs
        self._spill = None  # tables to flat memmaps: decided once
        self._pass_bounds = None  # multipass key ranges, from the first batch
        self._filter_reads = 0  # reads (pairs) the filter stage read
        self._ref_contigs = None
        self._ref_index = None
        self._init_s = time.perf_counter() - t0  # for run()'s record

    def check_supported(self, entry: str = "run"):
        """Raise NotImplementedError for multipass counting on more than one
        shard (as the JAX package does), and ValueError for an unknown stop
        stage or spill_tables, a run that aligns without a reference FASTA,
        or a filter that has no reads to read. `entry` is "run",
        "filter_single" (run_longread with no contigs FASTA) or "align"
        (run_longread with one, and regenotype)."""
        cfg = self.cfg
        codec.check_k(cfg.k)
        if cfg.stop_after not in STOP_STAGES:
            raise ValueError(f"unknown stop_after {cfg.stop_after!r}: one of "
                             f"{STOP_STAGES}")
        if cfg.spill_tables not in ("auto", "on", "off"):
            raise ValueError(f"unknown spill_tables {cfg.spill_tables!r}: "
                             "'auto', 'on' or 'off'")
        if cfg.count_passes > 1 and self.mesh.n > 1:
            raise NotImplementedError(
                "count_passes>1 is single-device (a multi-chip mesh already "
                "range-partitions the table across chips)")
        aligns = entry != "run" or cfg.stop_after in ("contig_align", "")
        if aligns and not cfg.ref:
            raise ValueError("read and contig alignment need a reference "
                             "FASTA (ref, -r)")
        single = entry == "filter_single" or cfg.single_end or not (
            cfg.fastq_a and cfg.fastq_b)
        filters = entry == "filter_single" or (
            entry == "run" and cfg.stop_after not in ("jhash", "hashlist"))
        if filters and single and (
                "," in cfg.subject or input_kind(cfg.subject) == "fastq"):
            raise ValueError(
                "the filter reads its reads from -q1/-q2 FASTQ (paired) or "
                "from one BAM/CRAM subject (paired or single_end); subject "
                f"{cfg.subject!r} is neither")

    # -- reference handling -------------------------------------------------

    def ref_contigs(self):
        """{contig: uint8 ASCII} of cfg.ref, a FASTA or a BWA index prefix
        (its .pac); CRAM decoding needs it."""
        if self._ref_contigs is None:
            path = self.cfg.ref
            if os.path.exists(path):
                fr = fasta.FastaReference(path)
                self._ref_contigs = {n: fr.seqs[n] for n in fr.names}
            elif os.path.exists(path + ".pac"):
                self._ref_contigs = bwaindex.load_pac_reference(path)
            else:
                raise FileNotFoundError(f"reference not found: {path}")
        return self._ref_contigs

    def ref_index(self):
        """The aligner's seed index of cfg.ref: in memory, or the memmapped
        flat index at cfg.flat_index, built there on first use."""
        if self._ref_index is None:
            path = self.cfg.flat_index
            if path:
                if not os.path.exists(path):
                    self._log(f"building flat seed index {path} (one-time)")
                    build_flat_index(self.ref_contigs(), path)
                self._ref_index = open_flat_index(path)
            else:
                self._ref_index = RefIndex(self.ref_contigs())
        return self._ref_index

    def _stubs(self) -> list:
        cfg = self.cfg
        return [cfg.subject_stub] + [cfg.control_stub(c)
                                     for c in cfg.controls]

    def _pull_tables(self, tables) -> list:
        """Every sample's table for the genotype pulls, subject first: the
        resident table under its stub (sharded on more than one shard),
        which wins over the table handed in (as in the JAX package); else
        a memmapped flat table as it is, bisected on the host and never
        uploaded whole; else the host table uploaded for the caller alone,
        freed when its stage drops it."""
        hosts = [tables["subject"]] + list(tables["controls"])
        return [self._dev_tables[s] if s in self._dev_tables
                else t if t.mapped
                else table_from_numpy(t.keys, t.counts, self.device,
                                      k=self.cfg.k)
                for s, t in zip(self._stubs(), hosts)]

    def _budget(self) -> int:
        """hbm_budget_gb in bytes."""
        return int(self.cfg.hbm_budget_gb * (1 << 30))

    def _chunk(self, tables: int) -> int:
        """Keys a stream over flat tables takes from each of `tables` at a
        time: what the budget holds at MERGE_BYTES a key, at most 2**24
        (the JAX package's chunk)."""
        return max(1, min(1 << 24, self._budget() // (MERGE_BYTES * tables)))

    # -- feeding ------------------------------------------------------------

    @staticmethod
    def _prefetch(gen, depth: int = 3, trace: StageTimer | None = None):
        """Run a generator in a thread that starts now, so host decoding of
        one sample overlaps device work on another; errors re-raise in the
        consumer. With `trace`, the live stage records the reader's
        `decode` (each step of `gen`, its opening included) and `put_wait`
        (a full queue) spans and the consumer's `feed_wait` (an empty
        one): which of the two sets the pace."""
        span = (trace or StageTimer()).span
        q: queue.Queue = queue.Queue(maxsize=depth)
        done = object()

        def worker():
            try:
                it = iter(gen)
                while True:
                    with span("decode"):
                        item = next(it, done)
                    if item is done:
                        break
                    with span("put_wait"):
                        q.put(item)
                q.put(done)
            except BaseException as e:
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()

        def consume():
            while True:
                with span("feed_wait"):
                    item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item

        return consume()

    def _host_empty(self, *shape, dtype=torch.uint8) -> torch.Tensor:
        """A host tensor for a decoder to fill, pinned when it will go to
        the card."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _host_tensor(self, a: np.ndarray) -> torch.Tensor:
        """numpy batch -> host tensor, pinned when it will go to the card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True)

    def _batch_stream(self, path: str, progress_path: str):
        """(batch_size, read_pad) uint8 host read batches of one sample, its
        comma-separated parts in sequence; reads are cut at read_pad. The
        progress file is the JAX package's: a single BAM or FASTQ-only
        input (its native routes) writes the completion sentinel alone;
        a CRAM or a list holding BAM/CRAM (its record-by-record route)
        writes the chromosome log of the first BAM/CRAM part."""
        cfg = self.cfg
        B, W = cfg.batch_size, cfg.read_pad
        parts = path.split(",")
        logged = [i for i, p in enumerate(parts) if input_kind(p) != "fastq"]
        log_part = logged[0] if logged and (
            len(parts) > 1 or input_kind(parts[0]) == "cram") else None
        lens = np.zeros(B, np.int32)
        for i, part in enumerate(parts):
            log = progress_path if i == log_part else None
            kind = input_kind(part)
            if kind == "fastq":
                with native.NativeFastq(part) as nf:
                    while True:
                        seq = self._host_empty(B, W)
                        n = len(nf.read_batch(B, W, out=(seq.numpy(),
                                                         lens))[0])
                        if n == 0:
                            break
                        yield seq[:n]
            elif kind == "bam":
                with native.NativeBam(part, threads=cfg.threads) as nb:
                    while True:
                        seq = self._host_empty(B, W)
                        n = len(nb.read_batch(B, W, out=(seq.numpy(), None,
                                                         lens))[0])
                        if n == 0:
                            break
                        yield seq[:n]
                    self._note_bam(nb, part)
                    if log:
                        for _ in progress.progress_records(
                                map(_RefId, nb.ref_ids().tolist()),
                                nb.refs(), log):
                            pass
            else:
                seqs = []
                for _, s, _ in cram.cram_to_fastq(part, self.ref_contigs(),
                                                  progress_path=log):
                    seqs.append(s)
                    if len(seqs) == B:
                        yield self._host_tensor(
                            fastq.batch_reads(seqs, pad_to=W)[0])
                        seqs = []
                if seqs:
                    yield self._host_tensor(fastq.batch_reads(seqs,
                                                              pad_to=W)[0])
        if log_part is None and progress_path:
            progress.write_complete(progress_path)

    # -- stage 1: count -----------------------------------------------------

    def count_sample(self, path: str, stub: str, lower: int, stream=None):
        """Count one sample's canonical k-mers (jellyfish `count -C -L
        lower`) into a device-resident table, or a flat memmap when tables
        spill. Outputs are reused only when the previous run's progress
        file carries the completion sentinel.

        On more than one shard the table is a ShardedKmerTable: each batch
        is cut over the shards, and the splitters its first count freezes
        serve every later sample of the run.

        With the LSM guard (spill_tables "on", or "auto" on cuda) a fold
        that would pass hbm_budget_gb first spills the committed table to a
        sorted flat run; the runs are merge-summed at the end, the floor
        applied to the final counts (jellyfish --disk,
        count_main.cc:318-338)."""
        cfg = self.cfg
        table_path = cfg.wpath(stub + ".table.npz")
        flat_path = cfg.wpath(stub + ".table.flat")
        histo_path = cfg.wpath(stub + ".Jhash.histo")
        progress_path = cfg.wpath(stub + ".Jelly.chr")
        if ((os.path.exists(table_path) or os.path.exists(flat_path))
                and os.path.exists(histo_path)):
            if (not os.path.exists(progress_path)
                    or progress.stream_complete(progress_path)):
                self._log(f"skipping count for {stub}")
                if os.path.exists(flat_path):
                    return count.KmerTable.load_flat(flat_path)
                return count.KmerTable.load(table_path)
            self._log(f"count for {stub}: outputs exist but the stream "
                      "never completed; recounting")
        if cfg.count_passes > 1:
            if stream is not None:
                raise ValueError("multipass counting re-streams the input; "
                                 "pass stream=None")
            return self._count_sample_multipass(path, stub, lower, flat_path,
                                                histo_path, progress_path)
        span = self.trace.span
        if stream is None:
            stream = self._prefetch(self._batch_stream(path, progress_path),
                                    trace=self.trace)
        runs: list[str] = []

        def spill_run(t):
            rp = flat_path + f".run{len(runs)}"
            t.to_flat(rp)
            t.reset()
            runs.append(rp)
            self._log(f"count[{stub}]: device budget reached, spilled run "
                      f"{len(runs)}")

        guard = cfg.spill_tables == "on" or (cfg.spill_tables == "auto"
                                             and self.device.type == "cuda")
        spill = spill_run if guard else None
        n_reads = 0
        loop_s = time.perf_counter()  # its steps and feed waits
        if self.mesh.n > 1:
            dev = sharded.ShardedKmerTable(self.mesh, cfg.k,
                                           splitters=self._splitters,
                                           budget=self._budget(), spill=spill)
            for reads in stream:
                with span("step"):
                    dev.fold_batch(sharded.local_count_step(self.mesh, reads,
                                                            cfg.k))
                n_reads += reads.shape[0]
        else:
            dev = DeviceKmerTable(cfg.k, self.device, budget=self._budget(),
                                  spill=spill)
            for reads in stream:
                with span("step"):
                    dev.fold_batch(count_step(self._to_device(reads), cfg.k))
                n_reads += reads.shape[0]
        loop_s = time.perf_counter() - loop_s
        with span("table_out"):
            # the last fold may spill too: its run must be in `runs` before
            # they are counted
            dev.flush()
            if self.mesh.n > 1 and self._splitters is None:
                self._splitters = dev.splitters
            if not progress.stream_complete(progress_path):
                raise RuntimeError(f"count stream for {path} ended without "
                                   f"the completion sentinel "
                                   f"({progress_path})")
            self._reads[stub] = n_reads
            if runs:
                # the last table joins the runs; their merge-sum applies the
                # floor to final counts (a per-run floor would drop split
                # counts)
                runs.append(flat_path + f".run{len(runs)}")
                dev.to_flat(runs[-1])
                self._note_folds(stub, dev)
                dev.release()
                self._runs[stub] = len(runs)
                t0 = time.perf_counter()
                table = count.merge_flat_runs(runs, flat_path,
                                              lower_count=lower,
                                              chunk=self._chunk(len(runs)),
                                              device=self.device)
                self._merge_s[stub] = time.perf_counter() - t0
                for rp in runs:
                    os.remove(rp)
                self._spill = True
            else:
                dev.apply_lower_count(lower)
                self._note_folds(stub, dev)
                if self._spill is None:
                    # decided once, from the first finished table: the
                    # samples' tables resident at once against the budget
                    per = 16 * dev.n_keys
                    n_samples = 1 + len(cfg.controls)
                    self._spill = (cfg.spill_tables == "on" or (
                        cfg.spill_tables == "auto"
                        and self.device.type == "cuda"
                        and per * n_samples > self._budget()))
                    if self._spill:
                        self._log(f"spilling count tables to host memmaps "
                                  f"({per / 2**30:.1f} GiB x {n_samples} "
                                  f"samples > {cfg.hbm_budget_gb} GiB)")
                if self._spill:
                    table = dev.to_flat(flat_path)
                    dev.release()
                else:
                    table = dev.to_host()
                    self._dev_tables[stub] = dev
                    table.save(table_path)
            if len(table) == 0:
                raise RuntimeError(f"counting produced no kmers for {path}")
            modeldist.write_histo(histo_path, table.histo())
            self._log(f"count[{stub}]: {len(table)} unique kmers"
                      + (f" ({len(runs)} spilled runs merged)" if runs else "")
                      + f", {n_reads / loop_s:.0f} reads/s")
            if self._spill:
                gc.collect()
                malloc_trim()
        return table

    def _note_folds(self, stub: str, dev):
        """A count's folds and the most keys one took, and a sharded
        count's flushes, (key, count) pairs exchanged, spills and shard
        balance (its shards' unique keys), for the trace."""
        self._folds[stub] = dev.folds
        self._fold_keys_max[stub] = dev.fold_keys_max
        if isinstance(dev, sharded.ShardedKmerTable):
            sizes = dev.shard_keys()
            self._shard_stats[stub] = {**dev.stats,
                                       "shard_keys_max": max(sizes),
                                       "shard_keys_mean": sum(sizes)
                                       / len(sizes)}

    def _count_sample_multipass(self, path, stub, lower, flat_path,
                                histo_path, progress_path):
        """count_passes passes over the input: pass p folds only the keys
        of the p-th ascending key range (bounds: quantiles of the first
        batch, selected on the device) and writes a flat run; the table is
        the runs' concatenation. The device holds about 1/count_passes of
        the table, and the pending buffer is cut to 1/count_passes of its
        keys, so each fold's transient shrinks with the pass too
        (jellyfish --disk's role)."""
        cfg = self.cfg
        passes = cfg.count_passes
        part_paths = []
        folds = fold_keys_max = 0
        span = self.trace.span
        for p in range(passes):
            stream = self._prefetch(self._batch_stream(
                path, progress_path if p == 0 else None), trace=self.trace)
            dev = DeviceKmerTable(cfg.k, self.device,
                                  pending_budget=PENDING_KEYS // passes)
            n_reads = 0
            loop_s = time.perf_counter()  # its steps and feed waits
            for reads in stream:
                with span("step"):
                    keys = count_step(self._to_device(reads), cfg.k)
                    if self._pass_bounds is None:
                        self._pass_bounds = [0, *make_splitters(keys, passes)
                                             .tolist(), codec.SENTINEL]
                        self._log(f"count multipass: {passes} key ranges, "
                                  "bounds from the first batch")
                    dev.fold_batch(select_range(keys, self._pass_bounds[p],
                                                self._pass_bounds[p + 1]))
                n_reads += reads.shape[0]
            loop_s = time.perf_counter() - loop_s
            if p == 0:
                if not progress.stream_complete(progress_path):
                    raise RuntimeError(
                        f"count stream for {path} ended without the "
                        f"completion sentinel ({progress_path})")
                self._reads[stub] = n_reads
            dev.apply_lower_count(lower)
            pp = flat_path + f".pass{p}"
            dev.to_flat(pp)
            folds += dev.folds
            fold_keys_max = max(fold_keys_max, dev.fold_keys_max)
            dev.release()
            part_paths.append(pp)
            self._log(f"count[{stub}] pass {p}: "
                      f"{n_reads / loop_s:.0f} reads/s")
        table = count.concat_flat(part_paths, flat_path)
        for pp in part_paths:
            os.remove(pp)
        self._folds[stub] = folds
        self._fold_keys_max[stub] = fold_keys_max
        self._spill = True  # downstream: the streamed subtract, host pulls
        gc.collect()
        malloc_trim()
        if len(table) == 0:
            raise RuntimeError(f"counting produced no kmers for {path}")
        modeldist.write_histo(histo_path, table.histo())
        self._log(f"count[{stub}]: {len(table)} unique kmers "
                  f"({passes} passes)")
        return table

    def stage_count(self):
        """Count all samples; every sample's reader thread starts at once, so
        sample N+1's parsing overlaps sample N's folds (the reference's -pj
        per-sample jellyfish jobs, runRufus.sh:766-797). Multipass counting
        streams each sample once a pass, when its turn comes."""
        cfg = self.cfg
        jobs = [(cfg.subject, cfg.subject_stub, cfg.subject_low_k)] + [
            (c, cfg.control_stub(c), cfg.par_low_k) for c in cfg.controls]
        with self.trace.stage("count", samples=len(jobs),
                              device=str(self.device)) as rec:
            streams = {}
            for path, stub, _ in jobs:
                if cfg.count_passes == 1 and not any(
                        os.path.exists(cfg.wpath(stub + ext))
                        for ext in (".table.npz", ".table.flat")):
                    streams[stub] = self._prefetch(self._batch_stream(
                        path, cfg.wpath(stub + ".Jelly.chr")),
                        trace=self.trace)
            done = [self.count_sample(path, stub, low,
                                      stream=streams.get(stub))
                    for path, stub, low in jobs]
            rec["unique_kmers"] = {stub: len(t) for (_, stub, _), t
                                   in zip(jobs, done)}
            rec["reads"] = {stub: self._reads[stub] for _, stub, _ in jobs
                            if stub in self._reads}
            rec["folds"] = sum(self._folds.get(stub, 0) for _, stub, _ in jobs)
            rec["fold_keys_max"] = {stub: self._fold_keys_max[stub]
                                    for _, stub, _ in jobs
                                    if stub in self._fold_keys_max}
            rec["flat"] = bool(self._spill)
            rec["lsm_runs"] = {stub: self._runs[stub] for _, stub, _ in jobs
                               if stub in self._runs}
            rec["merge_s"] = {stub: self._merge_s[stub] for _, stub, _ in jobs
                              if stub in self._merge_s}
            rec["budget_bytes"] = self._budget()
            if self.mesh.n > 1:
                for key in ("flushes", "exchanged_keys", "shard_keys_max",
                            "shard_keys_mean"):
                    rec[key] = {stub: st[key] for stub, st
                                in self._shard_stats.items()}
            rec["mem"] = memory_attribution(self.device)
        return {"subject": done[0], "controls": done[1:]}

    # -- stage 2: model -----------------------------------------------------

    def stage_model(self):
        cfg = self.cfg
        histo_path = cfg.wpath(cfg.subject_stub + ".Jhash.histo")
        model_path = histo_path + ".7.7.model"
        if cfg.exome:
            # synthetic model, no fit (runRufus.sh:878-893); no .dist exists
            if not cfg.min_cov:
                raise RuntimeError("min coverage (-m) required for exome runs")
            with open(model_path, "w") as f:
                f.write(f"3\n{cfg.min_cov}\n3.1392e+09\n1000000\n")
            return cfg.min_cov, 100000000
        if not os.path.exists(model_path):
            fit = modeldist.fit_model(histo_path, cfg.k, 150,
                                      haploid=cfg.haploid)
            modeldist.write_outputs(fit, histo_path, haploid=cfg.haploid)
        if cfg.min_cov:
            # the fit still runs (interpret needs the .dist) but -m
            # overrides the cutoff (runRufus.sh:873-876, :27)
            return cfg.min_cov, cfg.max_hash_depth_seed
        with open(model_path) as f:
            lines = f.read().split("\n")
        kcutoff = int(lines[1])
        raw_sc = int(lines[3])
        if kcutoff < 2:
            raise RuntimeError(
                f"model couldn't pick a sensible lower cutoff ({kcutoff})")
        return kcutoff, raw_sc * 5

    # -- stage 3: subtract --------------------------------------------------

    def stage_hashlist(self, tables, mutant_min_cov: int, max_hash_depth: int):
        cfg = self.cfg
        hl_path = cfg.wpath(
            f"{cfg.subject_stub}.k{cfg.k}_c{mutant_min_cov}.HashList")
        if os.path.exists(hl_path):
            self._log("skipping hashlist")
            return hl_path
        with self.trace.stage("hashlist", device=str(self.device)) as rec:
            stubs = self._stubs()
            if all(s in self._dev_tables for s in stubs):
                devs = [self._dev_tables[s] for s in stubs]
                step = (sharded.sharded_subtract_step if self.mesh.n > 1
                        else subtract_step)
                mut_d, subj_d = step(devs[0], devs[1:], cfg.merge_min,
                                     mutant_min_cov, max_hash_depth)
                mut = codec.keys_i64_to_u64(mut_d.cpu().numpy())
                subj = subj_d.cpu().numpy()
                rec["path"] = "sharded" if self.mesh.n > 1 else "device"
            else:
                # flat memmaps or tables resumed from disk: the subject
                # streamed through the device a chunk at a time
                host = [tables["subject"]] + list(tables["controls"])
                mut, subj = count.subtract_unique_stream(
                    host, cfg.merge_min, mutant_min_cov, max_hash_depth,
                    chunk=self._chunk(len(host)), device=self.device)
                rec["path"] = "host-stream"
            if cfg.exclude_hash and os.path.exists(cfg.exclude_hash):
                keep = count.KmerTable.load(cfg.exclude_hash).query(mut) == 0
                mut, subj = mut[keep], subj[keep]
            hio.write_hashlist(hl_path, mut, subj, cfg.k)
            rec["n_mutant"] = int(len(mut))
        if len(mut) == 0:
            raise RuntimeError("empty HashList: no subject-unique kmers")
        return hl_path

    # -- stage 4: filter ----------------------------------------------------

    def _text_batches(self, records):
        """(names, host tensors) batches of a stream of (name, seq, qual) or
        (name, seq1, qual1, seq2, qual2) tuples: [seq, qual, lens] a mate.
        A batch is read_pad wide, or MAX_READ when a read is longer."""
        cfg = self.cfg

        def batch(chunk):
            mates = [([c[1 + 2 * m] for c in chunk], [c[2 + 2 * m]
                                                       for c in chunk])
                     for m in range((len(chunk[0]) - 1) // 2)]
            longest = max(len(x) for seqs, _ in mates for x in seqs)
            W = cfg.read_pad if longest <= cfg.read_pad else MAX_READ
            tensors = [self._host_tensor(a) for seqs, quals in mates
                       for a in fastq.batch_reads(seqs, quals, pad_to=W)]
            return [c[0] for c in chunk], tensors

        chunk = []
        for rec in records:
            chunk.append(rec)
            if len(chunk) == cfg.batch_size:
                yield batch(chunk)
                chunk = []
        if chunk:
            yield batch(chunk)

    def _note_bam(self, nb, path: str):
        """A finished BAM stream's counters into the live stage's record
        (its `bam` list): what the streaming decoder inflated and parsed,
        and the most it held at once."""
        self.trace.note("bam", {"file": os.path.basename(path),
                                **nb.stats()})

    def _bam_batches(self, single: bool):
        """(Names, host tensors) batches of the subject BAM's stranded pair
        (or single-end) stream, decoded into pinned memory: read_pad wide
        when every read of the batch fits, else MAX_READ wide (the reads
        the decode cut at read_pad written whole into the wider rows)."""
        cfg = self.cfg
        B, W = cfg.batch_size, cfg.read_pad
        with native.NativeBam(cfg.subject, threads=max(cfg.threads, 2)) as nb:
            read = nb.read_se_batch if single else nb.read_pair_batch
            mate = lambda: [  # noqa: E731
                self._host_empty(B, W), self._host_empty(B, W),
                self._host_empty(B, dtype=torch.int32)]
            while True:
                out = mate() if single else mate() + mate()
                names = read(B, W, out=[t.numpy() for t in out])[0]
                n = len(names)
                if n == 0:
                    break
                out = [t[:n] for t in out]
                if nb.longest > W:
                    wide = [self._host_empty(n, MAX_READ) if t.dim() == 2
                            else t for t in out]
                    nb.widen([t.numpy() for t in out],
                             [t.numpy() for t in wide])
                    out = wide
                yield names, out
            self._note_bam(nb, cfg.subject)

    def _fastq_pair_batches(self):
        """(Names, host tensors) batches of -q1/-q2: decoded MAX_READ wide
        into scratch, copied to host tensors read_pad wide when every read
        of the batch fits."""
        cfg = self.cfg
        B = cfg.batch_size
        scratch = [np.empty((B, MAX_READ), np.uint8) if i % 3 < 2
                   else np.empty(B, np.int32) for i in range(6)]
        with native.NativeFastqPairs(cfg.fastq_a, cfg.fastq_b) as fp:
            while True:
                names, *arrays = fp.read_pair_batch(B, MAX_READ, out=scratch)
                if len(names) == 0:
                    return
                longest = max(int(arrays[2].max()), int(arrays[5].max()))
                W = cfg.read_pad if longest <= cfg.read_pad else MAX_READ
                tensors = []
                for a in arrays:
                    if a.ndim == 2:
                        t = self._host_empty(len(names), W)
                        t.numpy()[:] = a[:, :W]
                    else:
                        t = self._host_empty(len(names), dtype=torch.int32)
                        t.numpy()[:] = a
                    tensors.append(t)
                yield names, tensors

    def _pair_batches(self, progress_path: str):
        """The subject's pairs in stream order, as (names, [s1, q1, l1, s2,
        q2, l2] host tensors); a BAM/CRAM stream writes `progress_path`."""
        cfg = self.cfg
        if cfg.fastq_a:
            yield from self._fastq_pair_batches()
        elif input_kind(cfg.subject) == "cram":
            yield from self._text_batches(cram.cram_to_paired_fastq(
                cfg.subject, self.ref_contigs(), progress_path=progress_path))
        else:
            yield from self._bam_batches(single=False)
            progress.write_complete(progress_path)

    def _hashlist_table(self, hl_path: str):
        """The HashList on the device and its hashlist_index; on more than
        one shard, a (table, index) for each shard (replicate_hashlist)."""
        table = hashlist_keys_to_int64(hio.hashlist_keys(hl_path, self.cfg.k),
                                       self.device)
        if self.mesh.n > 1:
            return sharded.replicate_hashlist(self.mesh, table, self.cfg.k)
        return table, hashlist_index(table, self.cfg.k)

    def _keep_mask(self, tensors, hl) -> np.ndarray:
        """The filter's keep mask of a batch, on the host: `tensors` are its
        host tensors, [seq, qual, lens] a mate (one mate or a pair), `hl`
        is _hashlist_table's. On more than one shard the batch is cut over
        the shards (sharded_filter_step)."""
        cfg = self.cfg
        args = (cfg.k, cfg.filter_min_q, cfg.filter_k_threshold)
        if self.mesh.n > 1:
            mates = [tensors[i:i + 3] for i in range(0, len(tensors), 3)]
            return sharded.sharded_filter_step(self.mesh, mates, hl,
                                               *args).numpy()
        table, index = hl
        dev = [self._to_device(t) for t in tensors]
        if len(dev) == 6:
            keep = filter_pairs(*dev, table, *args, index)[0]
        else:
            keep = filter_single(*dev, table, *args, index)[0]
        return keep.cpu().numpy()

    @staticmethod
    def _write_kept(f, names, i: int, seq, qual, lens):
        n = int(lens[i])
        f.write(f"@{names[i]}\n{seq[i, :n].tobytes().decode()}\n+\n"
                f"{qual[i, :n].tobytes().decode()}\n")

    def stage_filter(self, hl_path: str):
        """Write the subject pairs whose mate1 or mate2 holds at least
        filter_k_threshold mutant windows, in stream order. Pairs come from
        -q1/-q2, else from the subject BAM/CRAM by the stranded rule (the
        second record seen under a name is mate1), which also writes
        `<subject>.filter.chr`."""
        cfg = self.cfg
        m1_path = cfg.wpath(cfg.subject_stub + ".Mutations.Mate1.fastq")
        m2_path = cfg.wpath(cfg.subject_stub + ".Mutations.Mate2.fastq")
        if os.path.exists(m1_path):
            self._log("skipping filter")
            return m1_path, m2_path
        progress_path = cfg.wpath(cfg.subject_stub + ".filter.chr")
        hl = self._hashlist_table(hl_path)
        kept = reads = 0
        span = self.trace.span
        # tmp + rename: a crash mid-stage must not leave partial outputs
        # that the skip-resume logic would trust on the next run
        with open(m1_path + ".tmp", "w") as f1, \
                open(m2_path + ".tmp", "w") as f2:
            for names, tensors in self._prefetch(
                    self._pair_batches(progress_path), depth=2,
                    trace=self.trace):
                with span("keep"):
                    keep = self._keep_mask(tensors, hl)
                with span("write"):
                    host = [t.numpy() for t in tensors]
                    for i in np.flatnonzero(keep):
                        self._write_kept(f1, names, i, *host[:3])
                        self._write_kept(f2, names, i, *host[3:])
                        kept += 1
                reads += len(names)
        os.rename(m1_path + ".tmp", m1_path)
        os.rename(m2_path + ".tmp", m2_path)
        self._filter_reads = reads
        if not cfg.fastq_a and not progress.stream_complete(progress_path):
            raise RuntimeError("filter stream ended without the completion "
                               f"sentinel ({progress_path})")
        if kept == 0:
            raise RuntimeError("filter kept no reads")
        self._log(f"filter kept {kept} pairs")
        return m1_path, m2_path

    def stage_filter_single(self, hl_path: str):
        """Single-end filter (PassThroughSamCheck.stranded.se +
        RUFUS.Filter.single, runRufus.sh:1016-1041): every subject read,
        in sequencing orientation, with at least filter_k_threshold mutant
        windows, in stream order."""
        cfg = self.cfg
        out_path = cfg.wpath(cfg.subject_stub + ".Mutations.fastq")
        if os.path.exists(out_path):
            self._log("skipping filter (se)")
            return out_path
        if input_kind(cfg.subject) == "cram":
            batches = self._text_batches(cram.cram_to_single_fastq(
                cfg.subject, self.ref_contigs()))
        else:
            batches = self._bam_batches(single=True)
        hl = self._hashlist_table(hl_path)
        kept = reads = 0
        span = self.trace.span
        with open(out_path + ".tmp", "w") as out:
            for names, tensors in self._prefetch(batches, depth=2,
                                                 trace=self.trace):
                with span("keep"):
                    keep = self._keep_mask(tensors, hl)
                with span("write"):
                    host = [t.numpy() for t in tensors]
                    for i in np.flatnonzero(keep):
                        self._write_kept(out, names, i, *host)
                        kept += 1
                reads += len(names)
        os.rename(out_path + ".tmp", out_path)  # crash-safe skip-resume
        self._filter_reads = reads
        if kept == 0:
            raise RuntimeError("filter kept no reads")
        self._log(f"filter kept {kept} reads (single-end)")
        return out_path

    # -- stage 5: align mutant reads ---------------------------------------

    def stage_align_reads(self, m1_path: str, m2_path: str | None,
                          rec: dict | None = None):
        """Align the kept reads (bwa mem | samblaster | samtools sort,
        runRufus.sh:1000-1001): pairs through align_pairs and
        mark_duplicates, single-end reads through align_seqs, every
        candidate DP batched on the device. Writes the coordinate-sorted
        Mutations.fastq.sam and the indexed .bam; with saliva, the full set
        as .FULL.sam and only reads whose own and mate mapping exist in the
        others (runRufus.sh:1062-1076). `rec` gathers counts for the trace."""
        cfg = self.cfg
        rec = {} if rec is None else rec
        sam_path = cfg.wpath(cfg.subject_stub + ".Mutations.fastq.sam")
        if os.path.exists(sam_path):
            self._log("skipping read alignment")
            return sam_path
        al = Aligner(self.ref_index(), device=self.device)
        if m2_path is None:  # single-end, batched device DP
            alns = [g[0]
                    for g in al.align_seqs(list(fastq.read_fastq(m1_path)))]
        else:
            pairs = [(n1, s1, qq1, s2, qq2)
                     for (n1, s1, qq1), (_, s2, qq2)
                     in zip(fastq.read_fastq(m1_path),
                            fastq.read_fastq(m2_path))]
            alns = rsam.align_pairs(al, pairs)
            # samblaster's slot in the pipe: mark PCR duplicate pairs so
            # assembly's duplicate rejection can fire
            alns, n_dup = rsam.mark_duplicates(alns)
            rec["duplicate_pairs"] = n_dup
            if n_dup:
                self._log(f"marked {n_dup} duplicate pairs")
        alns = rsam.sort_alignments(alns)
        rec["reads"] = len(alns)
        rec["mapped"] = sum(not a.is_unmapped for a in alns)
        rec["dp"] = _dp_summary(al.dp_batches)
        if cfg.saliva:
            # keep the full set, then drop records with the read or its
            # mate unmapped (`samtools view -F 12`)
            rsam.write_sam(sam_path[: -len(".sam")] + ".FULL.sam", alns,
                           self.ref_index())
            alns = [a for a in alns if not (a.flag & 0xC)]
            if not alns:
                raise RuntimeError("saliva filter removed every read")
        rsam.write_sam(sam_path, alns, self.ref_index())
        rsam.write_bam(cfg.wpath(cfg.subject_stub + ".Mutations.fastq.bam"),
                       alns, self.ref_index())
        return sam_path

    # -- stage 6: assembly --------------------------------------------------

    def stage_assemble(self, sam_path: str, hl_path: str,
                       rec: dict | None = None):
        """Greedy overlap assembly of the aligned mutant reads
        (Overlap.shorter.sh:90-196): OverlapSam, three Overlap rounds and
        OverlapRegion (or, with assembly_speed "veryfast", OverlapSam and
        one round on the pairs with |TLEN| > 150), then the depth, FASTQ and
        HashList-count annotations. Host code; the rounds' buffer is
        100 * threads reads, as in the reference. Spans time OverlapSam
        ("overlap_sam"), the rounds ("rounds") and OverlapRegion ("region");
        `rec` gets the native Align3 scorer's calls and query-candidate
        pairs (`align3_queries`, `align3_pairs`)."""
        cfg = self.cfg
        rec = {} if rec is None else rec
        ns = cfg.name_stub
        out_path = cfg.wpath(ns + ".overlap.hashcount.fastq")
        if os.path.exists(out_path):
            self._log("skipping assembly")
            return out_path
        records = []
        for line in open(sam_path):
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            records.append(SamLikeRec(int(f[1]), f[9], f[10], int(f[8])))
        strs, cnts = hio.read_hashlist(hl_path)
        threads = max(cfg.threads, 1)
        span = self.trace.span
        stats = []
        if cfg.assembly_speed == "veryfast":
            # long-insert pairs only (Overlap.shorter.sh:98, awk on $9);
            # single-end records all carry TLEN 0 and are all kept
            if any(r.flag & 0x1 for r in records):
                records = [r for r in records if abs(r.tlen) > 150]
            with span("overlap_sam"):
                r0, st = overlap_sam(records, strs, ns, 0.99, 25, 3, cfg.k)
            stats.append(st)
            with span("rounds"):
                r4, st = overlap_round(r0, ns, 0.99, 75, 5, 15, 1, 1,
                                       buffer_size=100 * threads)
            stats.append(st)
        else:
            with span("overlap_sam"):
                r, st = overlap_sam(records, strs, ns, 0.95, 20, 1, cfg.k)
            stats.append(st)
            with span("rounds"):
                for min_overlap, min_cov, trim in ((100, 1, 0), (75, 2, 1),
                                                   (50, 2, 1)):
                    r, st = overlap_round(r, "20", 0.98, min_overlap,
                                          min_cov, 20, 1, trim,
                                          buffer_size=100 * threads)
                    stats.append(st)
            with span("region"):
                r4, st = overlap_region(r, ns, 0.98, 50, 5, 1)
            stats.append(st)
        rec["align3_queries"] = sum(st["align3_queries"] for st in stats)
        rec["align3_pairs"] = sum(st["align3_pairs"] for st in stats)
        if not r4:
            raise RuntimeError("assembly produced no contigs")
        rec["contigs"] = len(r4)
        rq = annotate.replace_qual_with_depth(r4)
        fastq.write_fastqd(cfg.wpath(ns + ".overlap.fastqd"), rq)
        fq = annotate.fastqd_to_fastq(rq)
        with open(cfg.wpath(ns + ".overlap.fastq"), "w") as f:
            for n, s, q in fq:
                f.write(f"@{n}\n{s}\n+\n{q}\n")
        ann, side = annotate.annotate_overlap(list(zip(strs, cnts)), fq, cfg.k)
        with open(out_path, "w") as f:
            for n, s, q in ann:
                f.write(f"@{n}\n{s}\n+\n{q}\n")
        with open(cfg.wpath("TempOverlap",
                            ns + ".overlap.asembly.hash.fastq"), "w") as f:
            for line in side:
                f.write(line + "\n")
        return out_path

    # -- stage 7: contig alignment + genotype pulls ----------------------

    def stage_contig_align(self, contigs_path: str, tables,
                           rec: dict | None = None):
        """Align the contigs with splits (bwa mem -Y's role,
        Overlap.shorter.sh:209-303), write the contig SAM and the sorted,
        indexed BAM, the MOB alignments (with cfg.mob_fasta), the +-100 bp
        reference context, the contigs' and the context's k-mer tabs, and
        each sample's counts of those k-mers (pulled from the device
        tables) and the repeat-hash pull. Returns the inputs of interpret:
        the SA-annotated SAM lines and the paths of the pulls."""
        cfg = self.cfg
        rec = {} if rec is None else rec
        ns = cfg.name_stub
        inter = lambda *p: cfg.wpath("Intermediates", *p)  # noqa: E731
        al = Aligner(self.ref_index(), device=self.device)
        recs = list(fastq.read_fastq(contigs_path))

        # contig alignments with splits, candidate DPs batched on the device
        alns = []
        for group in al.align_seqs(recs, splits=True):
            alns.extend(group)
        alns = rsam.sort_alignments(alns)
        rec["contigs"] = len(recs)
        rec["alignments"] = len(alns)
        rec["splits"] = sum(a.is_supplementary for a in alns)
        rec["dp"] = _dp_summary(al.dp_batches)
        stdin_lines = []
        by_name: dict[str, list] = {}
        for a in alns:
            by_name.setdefault(a.qname, []).append(a)
        for a in alns:
            if "chrUn" in a.ref_name:
                continue
            others = [x for x in by_name[a.qname]
                      if x is not a and not x.is_unmapped]
            sa_tag = ""
            if others and not a.is_unmapped:
                entries = "".join(
                    f"{o.ref_name},{o.pos + 1},{'-' if o.is_reverse else '+'},"
                    f"{o.cigar_string()},{o.mapq},{o.nm};"
                    for o in others)
                sa_tag = f"\tSA:Z:{entries}"
            n_sa = len(others) if sa_tag else 0
            line = rsam.to_sam_line(
                a, tags=f"NM:i:{a.nm}\tAS:i:{a.score}" + sa_tag)
            f = line.split("\t")
            f[0] = f"{f[0]}:SA={n_sa}"
            stdin_lines.append("\t".join(f))
        rec["sam_lines"] = len(stdin_lines)
        sam_out = cfg.wpath(ns + ".overlap.hashcount.fastq.sam")
        rsam.write_sam(sam_out, alns, self.ref_index())
        rsam.write_bam(cfg.wpath(ns + ".overlap.hashcount.fastq.bam"),
                       alns, self.ref_index())

        # MOB alignment: bwa mem -E 0,0 -O 6,6 -d 500 -w 500 -L 0,0
        # (Overlap.shorter.sh:225), per contig on the host DP as in the
        # JAX package
        mob_sam = inter(ns + ".overlap.hashcount.fastq.MOB.sam")
        with open(mob_sam, "w") as f:
            f.write("@HD\tVN:1.6\tSO:coordinate\n")
            if cfg.mob_fasta and os.path.exists(cfg.mob_fasta):
                mob_ref = fasta.FastaReference(cfg.mob_fasta)
                mob_idx = RefIndex({n: mob_ref.seqs[n]
                                    for n in mob_ref.names})
                mob_al = Aligner(mob_idx, scoring=MOB_SCORING,
                                 device=self.device)
                for n in mob_idx.names:
                    f.write(f"@SQ\tSN:{n}\tLN:{mob_idx.lengths[n]}\n")
                for n, s, q in recs:
                    a = mob_al.align_seq(n, s, q)[0]
                    f.write(rsam.to_sam_line(a, tags=f"AS:i:{a.score}")
                            + "\n")

        # reference context fasta (bamtobed +-100 -> getfasta)
        contigs_ref = self.ref_contigs()
        ref_ctx_path = inter(ns + ".overlap.asembly.hash.fastq.ref.fastq")
        ref_seqs = []
        with open(ref_ctx_path, "w") as f:
            for a in alns:
                if a.is_unmapped:
                    continue
                s = max(0, a.pos - 100)
                e = a.pos + a.ref_span() + 100
                seq = contigs_ref[a.ref_name][s:e].tobytes().decode()
                f.write(f">{a.ref_name}:{s}-{e}\n{seq}\n")
                ref_seqs.append(seq)

        # k-mer tabs (non-canonical forward counts)
        tab_alt = inter(ns + ".overlap.hashcount.fastq.Jhash.tab")
        tab_ref = inter(ns + ".overlap.asembly.hash.fastq.ref.fastq.Jhash.tab")
        t_alt = count.KmerTable.from_strings(cfg.k, [s for _, s, _ in recs])
        t_ref = count.KmerTable.from_strings(cfg.k, ref_seqs)
        for t, path in ((t_alt, tab_alt), (t_ref, tab_ref)):
            with open(path, "w") as f:
                for s, c in zip(codec.kmers_to_strs(t.keys, cfg.k), t.counts):
                    f.write(f"{s} {c}\n")

        # genotype pulls: each tab's k-mers canonicalized once and searched
        # in every sample's device table, routed to the owner shards on
        # more than one (the reference backgrounds one `jellyfish query` a
        # sample, Overlap.shorter.sh:265-303)
        devs = self._pull_tables(tables)
        rec["pulled"] = 0  # k-mers looked up in every sample's table
        rec["found"] = [0] * len(devs)  # of them, present in each sample

        def write_pull(out, strs, cnts):
            with open(out, "w") as f:
                for s, c in zip(strs, cnts):
                    if 0 <= c <= cfg.genotype_max_cov:
                        f.write(f"{s} {c}\n")

        def pull_all(tab_path, out_paths):
            strs = [line.split()[0] for line in open(tab_path)]
            km = codec.strs_to_kmers([codec.canonical_str(s) for s in strs],
                                     cfg.k) if strs else []
            cnts_all = sharded.query_counts(devs, km)
            rec["pulled"] += len(strs)
            for t, (out, cnts) in enumerate(zip(out_paths, cnts_all)):
                rec["found"][t] += int(np.count_nonzero(cnts))
                write_pull(out, strs, cnts)

        subj_alt = inter(ns + ".overlap.asembly.hash.fastq.sample")
        subj_ref = inter(ns + ".overlap.asembly.hash.fastq.Ref.sample")
        par_alt_paths, par_ref_paths = [], []
        for c in cfg.controls:
            stub = cfg.control_stub(c)
            par_alt_paths.append(
                inter(f"{ns}.overlap.asembly.hash.fastq.{stub}.Jhash"))
            par_ref_paths.append(
                inter(f"{ns}.overlap.asembly.hash.fastq.Ref.{stub}.Jhash"))
        pull_all(tab_alt, [subj_alt] + par_alt_paths)
        pull_all(tab_ref, [subj_ref] + par_ref_paths)

        # exclude / repeat reference hash: a host-table point pull
        rep_ref = inter(ns + ".ref.RepRefHash")
        if cfg.ref_hash and os.path.exists(cfg.ref_hash):
            ex = count.KmerTable.load(cfg.ref_hash)
            strs = [line.split()[0] for line in open(tab_alt)]
            cnts = ex.query(codec.strs_to_kmers(
                [codec.canonical_str(s) for s in strs], cfg.k)) if strs else []
            write_pull(rep_ref, strs, cnts)
        else:
            open(rep_ref, "w").close()

        return {
            "stdin_lines": stdin_lines,
            "mob_sam": mob_sam,
            "subj_alt": subj_alt,
            "subj_ref": subj_ref,
            "par_alt": par_alt_paths,
            "par_ref": par_ref_paths,
            "rep_ref": rep_ref,
        }

    # -- stage 8: interpret -------------------------------------------------

    def _interpret(self, inputs, hl_path: str, **kw) -> str:
        """RUFUS.interpret on stage_contig_align's outputs: writes the
        .vcf, its .vcf.bed and the SV side files in Intermediates/; returns
        the .vcf path."""
        cfg = self.cfg
        return run_interpret(
            inputs["stdin_lines"], _RefWrap(self.ref_contigs()),
            cfg.wpath(cfg.subject_stub + ".Jhash.histo.7.7.dist"), hl_path,
            cfg.wpath(cfg.name_stub + ".overlap.hashcount.fastq.bam"),
            inputs["par_alt"], inputs["par_ref"], inputs["subj_alt"],
            inputs["subj_ref"], inputs["rep_ref"], inputs["mob_sam"],
            max_variant_size=cfg.max_allele_size, span=self.trace.span, **kw)

    def stage_interpret(self, inputs) -> str:
        """Interpret with the short-read settings (-mQ 10), on the first
        `<subject>.k<k>_c*.HashList` of the workdir."""
        cfg = self.cfg
        hl = [p for p in os.listdir(cfg.workdir)
              if p.startswith(cfg.subject_stub + f".k{cfg.k}_c")
              and p.endswith(".HashList")]
        return self._interpret(inputs, cfg.wpath(sorted(hl)[0]),
                               min_map_qual=10)

    # -- stage 9: polish ----------------------------------------------------

    def final_path(self) -> str:
        return self.cfg.wpath(self.cfg.name_stub
                              + ".overlap.hashcount.fastq.bam.FINAL.vcf")

    def stage_polish(self, vcf_path: str) -> str:
        """Sort, keep the main chromosomes' PASS (or, with cfg.mosaic,
        Mosaic) rows, collapse duplicates (runRufus.sh:1113-1125) into
        FINAL.vcf; returns its path."""
        return polish_vcf(vcf_path, self.final_path(),
                          with_mosaic=self.cfg.mosaic)

    # -- long-read (PacBio HiFi) path ---------------------------------------

    def stage_assemble_longread(self, contigs_fasta: str, hl_path: str):
        """Long-read contigs -> the annotated hashcount FASTQ
        (Overlap.pacbio.sh:75-90): no Overlap rounds; the contigs of an
        external assembler (a FASTA through the multi-line FASTA shim, or
        a .fq/.fastq read directly), or the accurate HiFi reads themselves,
        go straight to AnnotateOverlap."""
        cfg = self.cfg
        ns = cfg.name_stub
        out_path = cfg.wpath(ns + ".overlap.hashcount.fastq")
        if os.path.exists(out_path):
            self._log("skipping long-read annotate")
            return out_path
        if contigs_fasta.endswith((".fq", ".fastq")):
            fq = list(fastq.read_fastq(contigs_fasta))
        else:
            with open(contigs_fasta) as fh:
                fq_lines = list(shims.multiline_fasta_to_singleline_fastq(fh))
            fq = [(fq_lines[i][1:], fq_lines[i + 1], fq_lines[i + 3])
                  for i in range(0, len(fq_lines), 4)]
        strs, cnts = hio.read_hashlist(hl_path)
        ann, side = annotate.annotate_overlap(list(zip(strs, cnts)), fq, cfg.k)
        if not ann:
            raise RuntimeError("long-read assembly produced no contigs")
        with open(out_path, "w") as f:
            for n, s, q in ann:
                f.write(f"@{n}\n{s}\n+\n{q}\n")
        with open(cfg.wpath("TempOverlap", ns + ".overlap.asembly.hash.fastq"),
                  "w") as f:
            for line in side:
                f.write(line + "\n")
        return out_path

    def run_longread(self, contigs_fasta: str | None = None) -> str:
        """The long-read pipeline: count, model and subtract as usual, then
        the PacBio assembly and interpret (-mQ 1 -as 1000,
        Overlap.pacbio.sh:243-256) and polish. With no contigs FASTA the
        single-end filter's reads of the BAM/CRAM subject are the contigs.
        stop_after and single_end are not read. Returns the FINAL.vcf
        path."""
        self.check_supported("filter_single" if contigs_fasta is None
                             else "align")
        tables = self.stage_count()
        mutant_min_cov, max_hash_depth = self.stage_model()
        hl_path = self.stage_hashlist(tables, mutant_min_cov, max_hash_depth)
        if contigs_fasta is None:
            contigs_fasta = self.stage_filter_single(hl_path)
        contigs_path = self.stage_assemble_longread(contigs_fasta, hl_path)
        inputs = self.stage_contig_align(contigs_path, tables)
        vcf_path = self._interpret(inputs, hl_path, min_map_qual=1,
                                   seg_threshold=1000)
        return self.stage_polish(vcf_path)

    # -- regenotype ---------------------------------------------------------

    def _load_table(self, stub: str):
        """A sample's saved count table: its flat memmap (a spilled run) or
        its .table.npz."""
        flat = self.cfg.wpath(stub + ".table.flat")
        if os.path.exists(flat):
            return count.KmerTable.load_flat(flat)
        return count.KmerTable.load(self.cfg.wpath(stub + ".table.npz"))

    def regenotype(self, control_tables: list) -> str:
        """Re-genotype the contigs already in the workdir against new
        control tables (scripts/Genotype.sh): contig alignment and the
        pulls, interpret and polish. A sample whose table is resident on
        the device (counted by this pipeline) is pulled from it rather
        than from the table handed in, as in the JAX package. Returns the
        FINAL.vcf path, beside which it writes FINAL.vcf.gz and its .tbi
        anew (the JAX package leaves run()'s stale ones)."""
        self.check_supported("align")
        cfg = self.cfg
        contigs_path = cfg.wpath(cfg.name_stub + ".overlap.hashcount.fastq")
        if not os.path.exists(contigs_path):
            raise FileNotFoundError("no assembled contigs to regenotype; "
                                    "run the pipeline first")
        tables = {"subject": self._load_table(cfg.subject_stub),
                  "controls": control_tables}
        inputs = self.stage_contig_align(contigs_path, tables)
        final = self.stage_polish(self.stage_interpret(inputs))
        # run()'s bgzip + tabix: the new genotypes replace the .gz's too
        bgzf.bgzip_tabix_vcf(final, keep_plain=True)
        return final

    # -- the full run -------------------------------------------------------

    def run(self):
        """count -> model -> subtract -> filter -> align_reads -> assemble
        -> contig_align -> interpret -> polish, stopping after
        cfg.stop_after. Returns "" (jhash), the HashList path (hashlist),
        the Mate1 (single_end: Mutations.fastq) path (filter), interpret's
        inputs, the dict of stage_contig_align (contig_align), or, for the
        full run (""), the FINAL.vcf path, beside which it writes
        FINAL.vcf.gz and its .tbi. When it returns, the trace gets a `run`
        record: the wall of __init__ (`init_s`), run()'s own wall and CPU
        seconds, its wall outside the stages and the resident set size."""
        with self.trace.run(init_s=round(self._init_s, 6)):
            return self._run()

    def _run(self):
        cfg = self.cfg
        self.check_supported()
        t = self.trace
        tables = self.stage_count()
        if cfg.stop_after == "jhash":
            return ""
        with t.stage("model"):
            mutant_min_cov, max_hash_depth = self.stage_model()
        self._log(f"MutantMinCov={mutant_min_cov} "
                  f"MaxHashDepth={max_hash_depth}")
        hl_path = self.stage_hashlist(tables, mutant_min_cov, max_hash_depth)
        if cfg.stop_after == "hashlist":
            return hl_path
        with t.stage("filter", device=str(self.device)) as rec:
            if cfg.single_end:
                m1, m2 = self.stage_filter_single(hl_path), None
            else:
                m1, m2 = self.stage_filter(hl_path)
            rec["reads"] = self._filter_reads
        if cfg.stop_after == "filter":
            self._log(t.summary())
            return m1
        with t.stage("align_reads", device=str(self.device)) as rec:
            sam_path = self.stage_align_reads(m1, m2, rec)
        with t.stage("assemble") as rec:
            contigs_path = self.stage_assemble(sam_path, hl_path, rec)
        with t.stage("contig_align", device=str(self.device)) as rec:
            inputs = self.stage_contig_align(contigs_path, tables, rec)
        if cfg.stop_after == "contig_align":
            self._log(t.summary())
            return inputs
        with t.stage("interpret"):
            vcf_path = self.stage_interpret(inputs)
        with t.stage("polish"):
            final = self.stage_polish(vcf_path)
            # bgzip + tabix (runRufus.sh:1127-1128); the plain file stays
            bgzf.bgzip_tabix_vcf(final, keep_plain=True)
        if cfg.clean:
            self.clean()
        self._log(f"FINAL VCF: {final}")
        self._log(t.summary())
        return final

    def clean(self) -> int:
        """-CLEAN: remove the run's intermediates (runRufus.sh:351-356's rm
        list under the pipeline's file names). The FINAL VCFs, the trace
        and the model stay. Returns how many files went."""
        import glob

        patterns = [
            "*.generator.table.npz", "*.generator.table.flat",
            "*.generator.Jhash.histo",
            "*.generator.Jhash.histo.7.7.prob", "*.generator.Jelly.chr",
            "*.generator.filter.chr", "*.generator.k*_c*.HashList",
            "*.generator.Mutations.Mate1.fastq",
            "*.generator.Mutations.Mate2.fastq",
            "*.generator.Mutations.fastq",
            "*.generator.Mutations.fastq.sam",
            "*.generator.Mutations.fastq.FULL.sam",
            "*.generator.V2.overlap.fastq", "*.generator.V2.overlap.fastqd",
            "*.generator.V2.overlap.hashcount.fastq",
            "*.generator.V2.overlap.hashcount.fastq.sam",
            "*.generator.V2.overlap.hashcount.fastq.bam.vcf",
            "*.generator.V2.overlap.hashcount.fastq.bam.vcf.bed",
        ]
        removed = 0
        for pat in patterns:
            for p in glob.glob(self.cfg.wpath(pat)):
                os.remove(p)
                removed += 1
        self._log(f"clean: removed {removed} intermediates")
        return removed
