"""The RUFUS trio pipeline on one CUDA device, through the filter stage:
count -> model -> subtract -> filter (runRufus.sh's front half).

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

Stages after the filter (align, assemble, interpret, polish), the memory
model and multi-GPU are not ported yet: ``run`` refuses them and names the
ROADMAP.md entry that will bring each.
"""

from __future__ import annotations

import collections
import os
import queue
import threading

import numpy as np
import torch

from .config import RufusConfig
from ..convert import hashlist_keys_to_int64, table_from_numpy
from ..io import (bwaindex, cram, fasta, fastq, hashlist as hio, native,
                  progress)
from ..models import modeldist
from ..ops import codec, count
from ..ops.cuda_filter import hashlist_index
from ..ops.filter import filter_pairs, filter_single
from ..ops.table import DeviceKmerTable, count_step, subtract_step
from ..utils.trace import StageTimer, Throughput

FASTQ_EXT = (".fastq", ".fq", ".fastq.gz", ".fq.gz")
STOP_STAGES = ("jhash", "hashlist", "filter")
MAX_READ = 1024  # the filter cuts reads only beyond this length

_RefId = collections.namedtuple("_RefId", "ref_id")


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
        self._reads: dict = {}  # stub -> reads counted
        self._filter_reads = 0  # reads (pairs) the filter stage read
        self._ref_contigs = None

    def check_supported(self):
        """Raise NotImplementedError for what this slice does not run, and
        ValueError for a filter that has no pairs to read."""
        cfg = self.cfg
        codec.check_k(cfg.k)
        if cfg.stop_after not in STOP_STAGES:
            _not_ported(f"stop_after={cfg.stop_after!r} (the stages after "
                        "the filter)", "align, assemble, interpret, polish")
        if cfg.count_passes > 1 or cfg.spill_tables == "on":
            _not_ported("count_passes > 1 / spill_tables='on'",
                        "memory model")
        if cfg.sharded == "on":
            _not_ported("sharded='on'", "multi-GPU")
        if cfg.stop_after == "filter" and (
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

    # -- the slice ----------------------------------------------------------

    def run(self) -> str:
        """count -> model -> subtract -> filter, stopping after
        cfg.stop_after. Returns "" (jhash), the HashList path (hashlist) or
        the Mate1 (single_end: Mutations.fastq) path (filter)."""
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
                m1 = self.stage_filter_single(hl_path)
            else:
                m1, _m2 = self.stage_filter(hl_path)
            rec["reads"] = self._filter_reads
        self._log(t.summary())
        return m1
