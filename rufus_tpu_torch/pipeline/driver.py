"""The RUFUS trio pipeline on one CUDA device, through contig alignment:
count -> model -> subtract -> filter -> align reads -> assemble -> align
contigs and pull genotype counts (runRufus.sh and Overlap.shorter.sh up to
RUFUS.interpret's inputs).

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

Read and contig alignment run the seed-and-extend aligner (``align/``)
with every batched candidate DP and its traceback on the device (the
``sw_batch`` CUDA kernel, one launch a group); assembly is host Python
(``assembly/``); the genotype pulls search the resident sample tables on
the device (``ops/query.py``). Interpret and
polish, the memory model and multi-GPU are not ported yet: ``run`` refuses
them and names the ROADMAP.md entry that will bring each.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .config import RufusConfig
from ..align import Aligner, RefIndex
from ..align import sam as rsam
from ..align.aligner import MOB_SCORING, build_flat_index, open_flat_index
from ..assembly import annotate
from ..assembly.overlap_rounds import overlap_region, overlap_round
from ..assembly.overlap_sam import overlap_sam
from ..convert import hashlist_keys_to_int64, table_from_numpy
from ..io import (bwaindex, cram, fasta, fastq, hashlist as hio, native,
                  progress)
from ..models import modeldist
from ..ops import codec, count
from ..ops.cuda_filter import hashlist_index
from ..ops.filter import filter_pairs, filter_single
from ..ops.query import query_counts
from ..ops.table import DeviceKmerTable, count_step, subtract_step
from ..utils.trace import StageTimer, Throughput

FASTQ_EXT = (".fastq", ".fq", ".fastq.gz", ".fq.gz")
STOP_STAGES = ("jhash", "hashlist", "filter", "contig_align")
MAX_READ = 1024  # the filter cuts reads only beyond this length

_RefId = collections.namedtuple("_RefId", "ref_id")


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


def _not_ported(what: str, entry: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                              f"'Queue A': {entry})")


class RufusPipeline:
    def __init__(self, cfg: RufusConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        os.makedirs(cfg.workdir, exist_ok=True)
        os.makedirs(cfg.wpath("Intermediates"), exist_ok=True)
        os.makedirs(cfg.wpath("TempOverlap"), exist_ok=True)
        self._log = print
        self.trace = StageTimer(log_path=cfg.wpath("Intermediates",
                                                   "trace.jsonl"),
                                device=self.device)
        self._dev_tables: dict = {}  # stub -> DeviceKmerTable (resident)
        self._reads: dict = {}  # stub -> reads counted
        self._filter_reads = 0  # reads (pairs) the filter stage read
        self._ref_contigs = None
        self._ref_index = None

    def check_supported(self):
        """Raise NotImplementedError for what this slice does not run, and
        ValueError for a filter that has no pairs to read."""
        cfg = self.cfg
        codec.check_k(cfg.k)
        if cfg.stop_after not in STOP_STAGES:
            _not_ported(f"stop_after={cfg.stop_after!r} (the stages after "
                        "contig alignment)", "interpret, polish")
        if cfg.count_passes > 1 or cfg.spill_tables == "on":
            _not_ported("count_passes > 1 / spill_tables='on'",
                        "memory model")
        if cfg.sharded == "on":
            _not_ported("sharded='on'", "multi-GPU")
        if cfg.stop_after == "contig_align" and not cfg.ref:
            raise ValueError("read and contig alignment need a reference "
                             "FASTA (ref, -r)")
        if cfg.stop_after in ("filter", "contig_align") and (
                cfg.single_end or not (cfg.fastq_a and cfg.fastq_b)) and (
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

    def _device_tables(self, tables) -> list:
        """Every sample's DeviceKmerTable, subject first: the resident ones,
        and tables resumed from disk uploaded for the caller alone, so
        they are freed when its stage drops them."""
        cfg = self.cfg
        stubs = [cfg.subject_stub] + [cfg.control_stub(c)
                                      for c in cfg.controls]
        hosts = [tables["subject"]] + list(tables["controls"])
        return [self._dev_tables[s] if s in self._dev_tables
                else table_from_numpy(t.keys, t.counts, self.device, k=cfg.k)
                for s, t in zip(stubs, hosts)]

    # -- feeding ------------------------------------------------------------

    @staticmethod
    def _prefetch(gen, depth: int = 3):
        """Run a generator in a thread that starts now, so host decoding of
        one sample overlaps device work on another; errors re-raise in the
        consumer."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        done = object()

        def worker():
            try:
                for item in gen:
                    q.put(item)
                q.put(done)
            except BaseException as e:
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()

        def consume():
            while True:
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
                qual = np.empty((B, W), np.uint8)
                with native.NativeBam(part, threads=cfg.threads) as nb:
                    while True:
                        seq = self._host_empty(B, W)
                        n = len(nb.read_batch(B, W, out=(seq.numpy(), qual,
                                                         lens))[0])
                        if n == 0:
                            break
                        yield seq[:n]
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
        if log_part is None:
            progress.write_complete(progress_path)

    # -- stage 1: count -----------------------------------------------------

    def count_sample(self, path: str, stub: str, lower: int, stream=None):
        """Count one sample's canonical k-mers into a device-resident table
        (jellyfish `count -C -L lower`). Outputs are reused only when the
        previous run's progress file carries the completion sentinel."""
        cfg = self.cfg
        table_path = cfg.wpath(stub + ".table.npz")
        histo_path = cfg.wpath(stub + ".Jhash.histo")
        progress_path = cfg.wpath(stub + ".Jelly.chr")
        if os.path.exists(table_path) and os.path.exists(histo_path):
            if (not os.path.exists(progress_path)
                    or progress.stream_complete(progress_path)):
                self._log(f"skipping count for {stub}")
                return count.KmerTable.load(table_path)
            self._log(f"count for {stub}: outputs exist but the stream "
                      "never completed; recounting")
        meter = Throughput(name=f"count[{stub}] reads")
        if stream is None:
            stream = self._prefetch(self._batch_stream(path, progress_path))
        dev = DeviceKmerTable(cfg.k, self.device)
        for reads in stream:
            dev.fold_batch(count_step(self._to_device(reads), cfg.k))
            meter.add(reads.shape[0])
        if not progress.stream_complete(progress_path):
            raise RuntimeError(f"count stream for {path} ended without the "
                               f"completion sentinel ({progress_path})")
        dev.apply_lower_count(lower)
        table = dev.to_host()
        self._dev_tables[stub] = dev
        self._reads[stub] = meter.n
        table.save(table_path)
        if len(table) == 0:
            raise RuntimeError(f"counting produced no kmers for {path}")
        modeldist.write_histo(histo_path, table.histo())
        self._log(f"count[{stub}]: {len(table)} unique kmers, "
                  f"{meter.rate():.0f} reads/s")
        return table

    def stage_count(self):
        """Count all samples; every sample's reader thread starts at once, so
        sample N+1's parsing overlaps sample N's folds (the reference's -pj
        per-sample jellyfish jobs, runRufus.sh:766-797)."""
        cfg = self.cfg
        jobs = [(cfg.subject, cfg.subject_stub, cfg.subject_low_k)] + [
            (c, cfg.control_stub(c), cfg.par_low_k) for c in cfg.controls]
        with self.trace.stage("count", samples=len(jobs),
                              device=str(self.device)) as rec:
            streams = {}
            for path, stub, _ in jobs:
                if not os.path.exists(cfg.wpath(stub + ".table.npz")):
                    streams[stub] = self._prefetch(self._batch_stream(
                        path, cfg.wpath(stub + ".Jelly.chr")))
            done = [self.count_sample(path, stub, low,
                                      stream=streams.get(stub))
                    for path, stub, low in jobs]
            rec["unique_kmers"] = {stub: len(t) for (_, stub, _), t
                                   in zip(jobs, done)}
            rec["reads"] = {stub: self._reads[stub] for _, stub, _ in jobs
                            if stub in self._reads}
            rec["folds"] = sum(self._dev_tables[stub].folds
                               for _, stub, _ in jobs
                               if stub in self._dev_tables)
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
            devs = self._device_tables(tables)
            mut_d, subj_d = subtract_step(devs[0], devs[1:], cfg.merge_min,
                                          mutant_min_cov, max_hash_depth)
            mut = codec.keys_i64_to_u64(mut_d.cpu().numpy())
            subj = subj_d.cpu().numpy()
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

    def _bam_batches(self, single: bool):
        """(Names, host tensors) batches of the subject BAM's stranded pair
        (or single-end) stream, decoded into pinned memory: read_pad wide,
        or as wide as the file's longest read up to MAX_READ."""
        cfg = self.cfg
        B = cfg.batch_size
        with native.NativeBam(cfg.subject, threads=max(cfg.threads, 2)) as nb:
            W = max(cfg.read_pad, min(nb.max_read_len(), MAX_READ))
            while True:
                mate = [self._host_empty(B, W), self._host_empty(B, W),
                        self._host_empty(B, dtype=torch.int32)]
                if single:
                    out = mate
                    names = nb.read_se_batch(B, W, out=[t.numpy()
                                                        for t in out])[0]
                else:
                    out = mate + [self._host_empty(B, W),
                                  self._host_empty(B, W),
                                  self._host_empty(B, dtype=torch.int32)]
                    names = nb.read_pair_batch(B, W, out=[t.numpy()
                                                          for t in out])[0]
                if len(names) == 0:
                    return
                yield names, [t[:len(names)] for t in out]

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
        table = hashlist_keys_to_int64(hio.hashlist_keys(hl_path, self.cfg.k),
                                       self.device)
        return table, hashlist_index(table, self.cfg.k)

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
        table, index = self._hashlist_table(hl_path)
        kept = reads = 0
        # tmp + rename: a crash mid-stage must not leave partial outputs
        # that the skip-resume logic would trust on the next run
        with open(m1_path + ".tmp", "w") as f1, \
                open(m2_path + ".tmp", "w") as f2:
            for names, tensors in self._prefetch(
                    self._pair_batches(progress_path), depth=2):
                r1, q1, l1, r2, q2, l2 = (self._to_device(t) for t in tensors)
                keep, _, _ = filter_pairs(r1, q1, l1, r2, q2, l2, table,
                                          cfg.k, cfg.filter_min_q,
                                          cfg.filter_k_threshold, index)
                host = [t.numpy() for t in tensors]
                for i in np.flatnonzero(keep.cpu().numpy()):
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
        table, index = self._hashlist_table(hl_path)
        kept = reads = 0
        with open(out_path + ".tmp", "w") as out:
            for names, tensors in self._prefetch(batches, depth=2):
                r, q, l = (self._to_device(t) for t in tensors)
                keep, _ = filter_single(r, q, l, table, cfg.k,
                                        cfg.filter_min_q,
                                        cfg.filter_k_threshold, index)
                host = [t.numpy() for t in tensors]
                for i in np.flatnonzero(keep.cpu().numpy()):
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
        100 * threads reads, as in the reference."""
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
        if cfg.assembly_speed == "veryfast":
            # long-insert pairs only (Overlap.shorter.sh:98, awk on $9);
            # single-end records all carry TLEN 0 and are all kept
            if any(r.flag & 0x1 for r in records):
                records = [r for r in records if abs(r.tlen) > 150]
            r0, _ = overlap_sam(records, strs, ns, 0.99, 25, 3, cfg.k)
            r4, _ = overlap_round(r0, ns, 0.99, 75, 5, 15, 1, 1,
                                  buffer_size=100 * threads)
        else:
            r0, _ = overlap_sam(records, strs, ns, 0.95, 20, 1, cfg.k)
            r1, _ = overlap_round(r0, "20", 0.98, 100, 1, 20, 1, 0,
                                  buffer_size=100 * threads)
            r2, _ = overlap_round(r1, "20", 0.98, 75, 2, 20, 1, 1,
                                  buffer_size=100 * threads)
            r3, _ = overlap_round(r2, "20", 0.98, 50, 2, 20, 1, 1,
                                  buffer_size=100 * threads)
            r4, _ = overlap_region(r3, ns, 0.98, 50, 5, 1)
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
        # in every sample's device table (the reference backgrounds one
        # `jellyfish query` a sample, Overlap.shorter.sh:265-303)
        devs = self._device_tables(tables)
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
            cnts_all = query_counts(devs, km)
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

    # -- the slice ----------------------------------------------------------

    def run(self):
        """count -> model -> subtract -> filter -> align_reads -> assemble
        -> contig_align, stopping after cfg.stop_after. Returns "" (jhash),
        the HashList path (hashlist), the Mate1 (single_end:
        Mutations.fastq) path (filter) or interpret's inputs, the dict of
        stage_contig_align (contig_align)."""
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
        self._log(t.summary())
        return inputs
