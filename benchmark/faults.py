"""Faults planted under the timed path, to show that the comparison that
decides `correct` catches them. Each is a context manager that patches the
program in this process and restores it on exit. The benchmark's own runs
plant none; ``control.py`` and ``tests/test_faults.py`` do.

- ``state_unchanged``: a sample table's fold keeps the state it had after
  its first batch (a step that returns its state unchanged);
- ``half_batch``: each count batch loses its second half of reads;
- ``pair_altered``: the first kept pair's first base is altered as it is
  written;
- ``half_kept``: the filter drops every second pair its kernel keeps, so
  half of the kept pairs reach the back end;
- ``rows_altered``: each row of FINAL.vcf gets another alternate base as
  polish writes it;
- ``half_aligned``: the read alignment takes every second kept pair only,
  so half of the back end's input is left out;
- ``ref_allele_dropped``: interpret's genotyper never calls the reference
  allele, so a call's genotypes come out wrong;
- ``spilled_run_dropped``: the merge of a spilled count's sorted runs is
  handed every run but the last, so the keys of the sample's last batches
  are left out (``SPILL_FAULTS``: only a job whose count spills, with
  ``spill_tables`` "on" and a budget below its table, can have it).

A cell on one card has no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patch(obj, name, make):
    saved = vars(obj)[name]  # as stored: a staticmethod stays one
    setattr(obj, name, make(getattr(obj, name)))
    try:
        yield
    finally:
        setattr(obj, name, saved)


def state_unchanged():
    from rufus_tpu_torch.ops.table import DeviceKmerTable

    def make(plain):
        def fold_batch(self, *a, **kw):
            if getattr(self, "_fault_folded", False):
                return None
            self._fault_folded = True
            return plain(self, *a, **kw)
        return fold_batch

    return _patch(DeviceKmerTable, "fold_batch", make)


def half_batch():
    from rufus_tpu_torch.pipeline import driver

    def make(plain):
        return lambda reads, k: plain(reads[: (reads.shape[0] + 1) // 2], k)

    return _patch(driver, "count_step", make)


def pair_altered():
    from rufus_tpu_torch.pipeline.driver import RufusPipeline

    def make(plain):
        def write_kept(f, names, i, seq, qual, lens):
            if f.tell() == 0:
                seq = seq.copy()
                seq[i, 0] = ord("A") if seq[i, 0] != ord("A") else ord("C")
            return plain(f, names, i, seq, qual, lens)
        return staticmethod(write_kept)

    return _patch(RufusPipeline, "_write_kept", make)


def half_kept():
    from rufus_tpu_torch.pipeline.driver import RufusPipeline

    def make(plain):
        def _keep_mask(self, tensors, hl):
            keep = plain(self, tensors, hl)
            keep[np.flatnonzero(keep)[1::2]] = False
            return keep
        return _keep_mask

    return _patch(RufusPipeline, "_keep_mask", make)


def rows_altered():
    from rufus_tpu_torch.pipeline.driver import RufusPipeline

    other = {"A": "C", "C": "G", "G": "T", "T": "A"}

    def make(plain):
        def stage_polish(self, vcf_path):
            final = plain(self, vcf_path)
            with open(final) as f:
                lines = f.read().splitlines(keepends=True)
            with open(final, "w") as f:
                for line in lines:
                    if not line.startswith("#"):
                        c = line.split("\t")
                        c[4] = other.get(c[4][0], "A") + c[4][1:]
                        line = "\t".join(c)
                    f.write(line)
            return final
        return stage_polish

    return _patch(RufusPipeline, "stage_polish", make)


def half_aligned():
    from rufus_tpu_torch.pipeline.driver import RufusPipeline

    def make(plain):
        def stage_align_reads(self, m1_path, m2_path, rec=None):
            halves = []
            for path in (m1_path, m2_path):
                with open(path) as f:
                    lines = f.read().splitlines(keepends=True)
                half = path + ".half"
                with open(half, "w") as f:
                    f.writelines(line for i, line in enumerate(lines)
                                 if i // 4 % 2 == 0)
                halves.append(half)
            return plain(self, *halves, rec)
        return stage_align_reads

    return _patch(RufusPipeline, "stage_align_reads", make)


def ref_allele_dropped():
    from rufus_tpu_torch.interpret import samread

    def make(plain):
        def baysean_genotyper(model, counts, var_num):
            g, count = plain(model, counts, var_num)
            return ("" if var_num == "0" else g), count
        return baysean_genotyper

    return _patch(samread, "baysean_genotyper", make)


def spilled_run_dropped():
    from rufus_tpu_torch.ops import count

    def make(plain):
        def merge_flat_runs(run_paths, *a, **kw):
            return plain(run_paths[:-1], *a, **kw)
        return merge_flat_runs

    return _patch(count, "merge_flat_runs", make)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "pair_altered": pair_altered, "half_kept": half_kept,
          "rows_altered": rows_altered, "half_aligned": half_aligned,
          "ref_allele_dropped": ref_allele_dropped}
SPILL_FAULTS = {"spilled_run_dropped": spilled_run_dropped}
