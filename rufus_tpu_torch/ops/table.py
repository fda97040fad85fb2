"""A sample's k-mer count table on one device, and the steps that build and
subtract it.

The single-device counterpart of ``rufus_tpu/parallel/sharded.py``'s
``ShardedKmerTable``, ``sharded_count_step``, ``sharded_fold_step`` and
``sharded_subtract_step``. The device table holds exactly its sorted unique
keys and counts: each fold sizes the new table from the compaction
kernel's unique count, so there is no capacity, no growth and no retry.
The contents do not depend on that choice, so the outputs equal the JAX
package's.
"""

from __future__ import annotations

import torch

from . import codec, count
from .cuda_count import encode_canon


def count_step(reads: torch.Tensor, k: int) -> torch.Tensor:
    """A read batch (B, L) uint8 -> its raw count-1 window keys, flat int64
    (sentinels included). Reduction is left to the fold, which sorts its
    pending buffer anyway."""
    return encode_canon(reads, k).reshape(-1)


class DeviceKmerTable:
    """Sorted unique int64 keys and int64 counts on one device.

    Batches are buffered until `pending_budget` keys are pending, then
    folded at once: sort + compact the pending keys, merge the result with
    the table, compact again."""

    def __init__(self, k: int, device, pending_budget: int = 96 << 20):
        self.k = codec.check_k(k)
        self.device = torch.device(device)
        self.keys = torch.empty(0, dtype=torch.int64, device=self.device)
        self.counts = torch.empty(0, dtype=torch.int64, device=self.device)
        self._pending: list = []
        self._pending_els = 0
        self.pending_budget = pending_budget
        self.folds = 0

    def fold_batch(self, batch_keys: torch.Tensor, batch_counts=None):
        """Queue raw count-1 keys (batch_counts=None) or (keys, counts);
        fold when the pending buffer reaches its budget."""
        self._pending.append((batch_keys.reshape(-1), batch_counts))
        self._pending_els += batch_keys.numel()
        if self._pending_els >= self.pending_budget:
            self.flush()

    def flush(self):
        """Fold every pending batch into the table."""
        if not self._pending:
            return
        keys = torch.cat([k for k, _ in self._pending])
        if all(c is None for _, c in self._pending):
            pk, pc = count.count_batch(keys)
        else:
            cnts = torch.cat([torch.ones_like(k) if c is None
                              else c.reshape(-1).to(torch.int64)
                              for k, c in self._pending])
            s, order = torch.sort(keys, stable=True)
            pk, pc = count.compact_runs(s, cnts[order])
        self._pending = []
        self._pending_els = 0
        del keys
        if self.keys.numel():
            pk, pc = count.merge_sorted(self.keys, self.counts, pk, pc)
        self.keys, self.counts = pk, pc
        self.folds += 1

    def apply_lower_count(self, lower: int):
        """jellyfish `count -L` floor: drop k-mers with final count < lower."""
        self.flush()
        if lower <= 1:
            return
        keep = self.counts >= lower
        self.keys, self.counts = self.keys[keep], self.counts[keep]

    def to_host(self) -> count.KmerTable:
        """Copy to a host KmerTable (uint64 keys)."""
        self.flush()
        return count.KmerTable(self.k,
                               codec.keys_i64_to_u64(self.keys.cpu().numpy()),
                               self.counts.cpu().numpy())

    def release(self):
        """Drop the device tensors."""
        self._pending = []
        self._pending_els = 0
        self.keys = self.counts = None


def subtract_step(subject: DeviceKmerTable, controls: list, merge_min: int,
                  min_cov: int, max_depth: int):
    """The modified merge (merge_files.cc:147-153) fused with the subject
    count-range pull (CheckJellyHashList.sh:12), for min_cov >= 1: SUBJECT
    keys absent from every control, with subject count in
    [max(merge_min, min_cov), max_depth]. Returns the sorted mutant keys and
    their subject counts.

    Control membership is a binary search in each control's sorted keys;
    the JAX package's tagged sort-merge existed because TPU gathers are
    slow."""
    sk, sc = subject.keys, subject.counts
    keep = (sc > 0) & (sc >= merge_min) & (sc >= min_cov) & (sc <= max_depth)
    for ctl in controls:
        ck = ctl.keys
        if ck.numel() == 0:
            continue
        idx = torch.clamp(torch.searchsorted(ck, sk), max=ck.numel() - 1)
        keep &= ck[idx] != sk
    return sk[keep], sc[keep]
