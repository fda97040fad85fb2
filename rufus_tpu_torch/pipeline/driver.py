"""The RUFUS trio pipeline on one CUDA device, through the filter stage:
count -> model -> subtract -> filter (runRufus.sh's front half).

Every stage writes its outputs into the workdir under the reference's file
names and is skipped when they already exist (runRufus.sh:844-951 resume
semantics). Counting and filtering stream FASTQ batches from a reader
thread, through pinned host memory, to the CUDA kernels of ``ops/``; the
sample tables stay on the device from counting to the subtract.

Stages after the filter (align, assemble, interpret, polish), BAM/CRAM
input and the memory-model options are not ported yet: ``run`` refuses
them and names the ROADMAP.md entry that will bring each.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from .config import RufusConfig
from ..convert import hashlist_keys_to_int64, table_from_numpy
from ..io import fastq, hashlist as hio, progress
from ..models import modeldist
from ..ops import codec, count
from ..ops.filter import filter_pairs
from ..ops.table import DeviceKmerTable, count_step, subtract_step
from ..utils.trace import StageTimer, Throughput

FASTQ_EXT = (".fastq", ".fq", ".fastq.gz", ".fq.gz")
STOP_STAGES = ("jhash", "hashlist", "filter")


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
                              f"'Still to port': {entry})")


class RufusPipeline:
    def __init__(self, cfg: RufusConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        os.makedirs(cfg.workdir, exist_ok=True)
        os.makedirs(cfg.wpath("Intermediates"), exist_ok=True)
        self._log = print
        self.trace = StageTimer(log_path=cfg.wpath("Intermediates",
                                                   "trace.jsonl"),
                                device=self.device)
        self._dev_tables: dict = {}  # stub -> DeviceKmerTable (resident)

    def check_supported(self):
        """Raise NotImplementedError for what this slice does not run."""
        cfg = self.cfg
        codec.check_k(cfg.k)
        if cfg.stop_after not in STOP_STAGES:
            _not_ported(f"stop_after={cfg.stop_after!r} (the stages after "
                        "the filter)", "align, assemble, interpret, polish")
        for path in [cfg.subject] + list(cfg.controls):
            for part in path.split(","):
                if not part.endswith(FASTQ_EXT):
                    _not_ported(f"input {part!r} (BAM/CRAM)",
                                "BAM/BGZF/CRAM input")
        if cfg.stop_after == "filter" and not (cfg.fastq_a and cfg.fastq_b):
            _not_ported("the filter without fastq_a/fastq_b (pairs from a "
                        "BAM subject)", "BAM/BGZF/CRAM input")
        if cfg.single_end:
            _not_ported("single_end", "BAM/BGZF/CRAM input")
        if cfg.count_passes > 1 or cfg.spill_tables == "on":
            _not_ported("count_passes > 1 / spill_tables='on'",
                        "memory model")
        if cfg.sharded == "on":
            _not_ported("sharded='on'", "multi-GPU")

    # -- feeding ------------------------------------------------------------

    @staticmethod
    def _prefetch(gen, depth: int = 3):
        """Run a generator in a thread that starts now, so host parsing of
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

    def _host_tensor(self, a: np.ndarray) -> torch.Tensor:
        """numpy batch -> host tensor, pinned when it will go to the card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True)

    def _batch_stream(self, path: str, progress_path: str):
        """Pinned (batch_size, read_pad) uint8 read batches of one sample
        (comma-separated FASTQ files in sequence); reads are cut at
        read_pad. Writes the completion sentinel after a clean end."""
        cfg = self.cfg
        for part in path.split(","):
            for b in fastq.fastq_batches(part, cfg.batch_size, cfg.read_pad):
                yield self._host_tensor(b.seq)
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
                              device=str(self.device)):
            streams = {}
            for path, stub, _ in jobs:
                if not os.path.exists(cfg.wpath(stub + ".table.npz")):
                    streams[stub] = self._prefetch(self._batch_stream(
                        path, cfg.wpath(stub + ".Jelly.chr")))
            done = [self.count_sample(path, stub, low,
                                      stream=streams.get(stub))
                    for path, stub, low in jobs]
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
        stubs = [cfg.subject_stub] + [cfg.control_stub(c)
                                      for c in cfg.controls]
        hosts = [tables["subject"]] + tables["controls"]
        with self.trace.stage("hashlist", device=str(self.device)) as rec:
            # tables resumed from disk go back to the device
            devs = [self._dev_tables[s] if s in self._dev_tables
                    else table_from_numpy(t.keys, t.counts, self.device,
                                          k=cfg.k)
                    for s, t in zip(stubs, hosts)]
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

    def _pair_batches(self):
        """(mate1, mate2) ReadBatch pairs with pinned tensors of each, in
        input order. Reads longer than read_pad widen their batch to 1024
        columns so they are not cut below that."""
        cfg = self.cfg
        for b1, b2 in fastq.fastq_pair_batches(
                cfg.fastq_a, cfg.fastq_b, cfg.batch_size, cfg.read_pad,
                max(cfg.read_pad, 1024)):
            tensors = [self._host_tensor(a) for a in
                       (b1.seq, b1.qual, b1.lens, b2.seq, b2.qual, b2.lens)]
            yield b1, b2, tensors

    def stage_filter(self, hl_path: str):
        """Write the subject pairs whose mate1 or mate2 holds at least
        filter_k_threshold mutant windows, in input order."""
        cfg = self.cfg
        m1_path = cfg.wpath(cfg.subject_stub + ".Mutations.Mate1.fastq")
        m2_path = cfg.wpath(cfg.subject_stub + ".Mutations.Mate2.fastq")
        if os.path.exists(m1_path):
            self._log("skipping filter")
            return m1_path, m2_path
        table = hashlist_keys_to_int64(hio.hashlist_keys(hl_path, cfg.k),
                                       self.device)
        kept = 0
        # tmp + rename: a crash mid-stage must not leave partial outputs
        # that the skip-resume logic would trust on the next run
        with open(m1_path + ".tmp", "w") as f1, \
                open(m2_path + ".tmp", "w") as f2:
            for b1, b2, tensors in self._prefetch(self._pair_batches(),
                                                  depth=2):
                r1, q1, l1, r2, q2, l2 = (self._to_device(t) for t in tensors)
                keep, _, _ = filter_pairs(r1, q1, l1, r2, q2, l2, table,
                                          cfg.k, cfg.filter_min_q,
                                          cfg.filter_k_threshold)
                for i in np.flatnonzero(keep.cpu().numpy()):
                    name = b1.name(i)
                    s1, sq1 = b1.text(i)
                    s2, sq2 = b2.text(i)
                    f1.write(f"@{name}\n{s1}\n+\n{sq1}\n")
                    f2.write(f"@{name}\n{s2}\n+\n{sq2}\n")
                    kept += 1
        os.rename(m1_path + ".tmp", m1_path)
        os.rename(m2_path + ".tmp", m2_path)
        if kept == 0:
            raise RuntimeError("filter kept no reads")
        self._log(f"filter kept {kept} pairs")
        return m1_path, m2_path

    # -- the slice ----------------------------------------------------------

    def run(self) -> str:
        """count -> model -> subtract -> filter, stopping after
        cfg.stop_after. Returns "" (jhash), the HashList path (hashlist) or
        the Mate1 path (filter)."""
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
        with t.stage("filter", device=str(self.device)):
            m1, _m2 = self.stage_filter(hl_path)
        self._log(t.summary())
        return m1
