"""Faults planted under the timed path, to show that the comparison that
decides `correct` catches them. Each is a context manager that patches the
program in this process and restores it on exit. The benchmark's own runs
plant none; ``control.py`` and ``tests/test_faults.py`` do.

- ``state_unchanged``: a sample table's fold keeps the state it had after
  its first batch (a step that returns its state unchanged);
- ``half_batch``: each count batch loses its second half of reads;
- ``pair_altered``: the first kept pair's first base is altered as it is
  written.

A cell on one card has no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib


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


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "pair_altered": pair_altered}
