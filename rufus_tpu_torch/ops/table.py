"""A sample's k-mer count table on one device, and the steps that build and
subtract it.

The single-device counterpart of ``rufus_tpu/parallel/sharded.py``'s
``ShardedKmerTable``, ``sharded_count_step``, ``sharded_fold_step`` and
``sharded_subtract_step``, and each shard of the port's sharded table
(``parallel/sharded.py``). The device table holds exactly its sorted unique
keys and counts: each fold sizes the new table from the compaction
kernel's unique count, so there is no capacity, no growth and no retry.

The JAX package buffers 96 M raw keys before a fold, to amortise the sort
of table || pending that merges them. Here the sorted unique run of the
folded keys merges into the table in one linear pass (``merge_runs``), so
a fold waits only until the pending keys reach a quarter of the table:
the pending sort then stays under the merge's bytes, and a merge's pass
over the table is paid for by a quarter of its keys in new keys (a file's
last, short batch aside, which folds alone rather than swell the next
batch's sort). The contents do not depend on the fold cadence, so the
outputs equal the JAX package's.

Under a device memory budget (the JAX package's ``max_capacity`` and
``overflow_spill``) the table reckons the bytes each fold allocates, with
per-key constants measured on the H100, and hands its committed table to a
spill callback (a sorted flat run on the host) before a fold would pass
the budget; counting then goes on from an empty table.
"""

from __future__ import annotations

import numpy as np
import torch

from . import codec, count
from .cuda_count import encode_canon
from .cuda_merge import merge_runs

# Device bytes a key costs at the peak of a fold, from
# torch.cuda.max_memory_allocated around folds on the H100 (chip_smoke.py's
# memory phase, tools/sortbench.py's fold_bytes; PERF.md), the caching
# allocator's block rounding included: TABLE_BYTES a committed key (key
# and count);
# PENDING_BYTES a pending raw key while its buffer is sorted and compacted
# (the buffered batches, their concatenation, torch.sort's values, indices
# and scratch, compact_runs' 12-byte stage); RUN_MERGE_BYTES a key of the
# table plus the folded keys' unique run while merge_runs merges the two
# (both runs and the union); MERGE_BYTES a key of ``count.merge_sum``'s
# parts (the concatenated keys and counts, the stable sort's values,
# indices and scratch, the gathered counts and compact_runs' output), which
# merges unsorted parts: counted pending parts here, the flat runs' chunks
# in ``count.merge_flat_runs``.
TABLE_BYTES, PENDING_BYTES, RUN_MERGE_BYTES, MERGE_BYTES = 16, 52, 34, 64
# Bytes the budget reserves a key of the pending cap: one pending buffer
# must fit beside a table of its own size, and two of its unique runs must
# merge within the budget.
CAP_BYTES = max(PENDING_BYTES + TABLE_BYTES, 2 * RUN_MERGE_BYTES)
# Raw keys the pending buffer takes at most before a fold, without a
# budget.
PENDING_KEYS = 96 << 20


def count_step(reads: torch.Tensor, k: int) -> torch.Tensor:
    """A read batch (B, L) uint8 -> its raw count-1 window keys, flat int64
    (sentinels included). Reduction is left to the fold, which sorts its
    pending buffer anyway."""
    return encode_canon(reads, k).reshape(-1)


class DeviceKmerTable:
    """Sorted unique int64 keys and int64 counts on one device.

    Batches are buffered until the pending keys reach the least of
    `pending_budget` and a quarter of the table (never fewer than the
    batch at hand), then folded at once: sort + compact the pending keys,
    and merge the sorted unique result into the table (``merge_runs``).
    `folds` counts the folds and `fold_keys_max` the most pending keys one
    took.

    With `budget` (bytes) and `spill` (a callback that writes the committed
    table out and calls `reset`), a fold never allocates more than the
    budget by the per-key constants above: the pending buffer is capped at
    `pending_cap` keys, and the committed table is spilled before a fold
    whose sort or merge would pass the budget. A batch larger than the cap
    raises."""

    def __init__(self, k: int, device, pending_budget: int = PENDING_KEYS,
                 budget: int | None = None, spill=None):
        self.k = codec.check_k(k)
        self.device = torch.device(device)
        self.keys = torch.empty(0, dtype=torch.int64, device=self.device)
        self.counts = torch.empty(0, dtype=torch.int64, device=self.device)
        self._pending: list = []
        self._pending_els = 0
        self.pending_budget = pending_budget
        self.folds = self.fold_keys_max = 0
        self.budget, self.spill, self.pending_cap = budget, spill, None
        self.spills = 0
        if spill is not None:
            self.pending_cap = budget // CAP_BYTES
            self.pending_budget = min(pending_budget, self.pending_cap)

    @property
    def n_keys(self) -> int:
        """Committed unique keys."""
        return self.keys.numel()

    def _fold_at(self) -> int:
        """Pending keys that start a fold."""
        return min(self.pending_budget, self.keys.numel() // 4)

    def fold_batch(self, batch_keys: torch.Tensor, batch_counts=None):
        """Queue raw count-1 keys (batch_counts=None) or (keys, counts);
        fold when the pending keys reach the least of `pending_budget` and
        a quarter of the table. A batch that reaches it alone folds alone:
        what is pending (a file's last, short batch) folds first."""
        n = batch_keys.numel()
        if self.pending_cap is not None:
            if n > self.pending_cap:
                raise RuntimeError(
                    f"a batch of {n} keys passes the device budget of "
                    f"{self.budget} bytes alone (at most {self.pending_cap} "
                    "pending keys); lower batch_size or raise hbm_budget_gb")
            if self._pending_els + n > self.pending_cap:
                self.flush()
        if self._pending and n >= self._fold_at():
            self.flush()
        self._pending.append((batch_keys.reshape(-1), batch_counts))
        self._pending_els += n
        del batch_keys, batch_counts  # the fold frees them after its sort
        if self._pending_els >= self._fold_at():
            self.flush()

    def _over_budget(self, nbytes: int) -> bool:
        """Whether a fold step of `nbytes` would pass the budget with a
        committed table to spill."""
        return (self.spill is not None and self.keys.numel() > 0
                and nbytes > self.budget)

    def _spill(self):
        """Hand the committed table to the spill callback, the pending
        batches held aside so that its flush finds none."""
        pending, n = self._pending, self._pending_els
        self._pending, self._pending_els = [], 0
        self.spill(self)
        self._pending, self._pending_els = pending, n
        self.spills += 1

    def flush(self):
        """Fold every pending batch into the table. Each step drops its
        inputs as soon as it is done with them: the budget's constants
        count what stays."""
        if not self._pending:
            return
        if self._over_budget(TABLE_BYTES * self.keys.numel()
                             + PENDING_BYTES * self._pending_els):
            self._spill()
        self.fold_keys_max = max(self.fold_keys_max, self._pending_els)
        pending, self._pending, self._pending_els = self._pending, [], 0
        parts_k = [k for k, _ in pending]
        if all(c is None for _, c in pending):
            del pending
            keys = parts_k[0] if len(parts_k) == 1 else torch.cat(parts_k)
            del parts_k
            pk, pc = count.count_batch(keys)
            del keys
        else:
            parts_c = [torch.ones_like(k) if c is None
                       else c.reshape(-1).to(torch.int64) for k, c in pending]
            del pending
            pk, pc = count.merge_sum(parts_k, parts_c)
        if self._over_budget(RUN_MERGE_BYTES
                             * (self.keys.numel() + pk.numel())):
            self._spill()
        if self.keys.numel():
            table_k, table_c = self.keys, self.counts
            self.keys = self.counts = None
            pk, pc = merge_runs(table_k, table_c, pk, pc)
            del table_k, table_c
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

    def to_flat(self, path: str, chunk: int = 1 << 25) -> count.KmerTable:
        """Write the table in the flat layout (``KmerTable.save_flat``'s)
        through chunked device-to-host slices, O(chunk) host memory; returns
        the memmapped KmerTable."""
        self.flush()
        n = self.keys.numel()
        with count.atomic_write(path) as f:
            count.write_flat_header(f, self.k, n)
            for plane, dtype in ((self.keys, "<u8"), (self.counts, "<i8")):
                for off in range(0, n, chunk):
                    plane[off:off + chunk].cpu().numpy().astype(dtype).tofile(f)
        return count.KmerTable.load_flat(path)

    def reset(self):
        """Empty the committed table (after a run spill); pending batches
        stay."""
        self.keys = self.keys.new_empty(0)
        self.counts = self.counts.new_empty(0)

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
        keep &= count.absent_from(sk, ctl.keys)
    return sk[keep], sc[keep]


def make_splitters(keys, n_parts: int, sample: int = 1 << 16) -> np.ndarray:
    """Range boundaries that split the key distribution of `keys` (a key
    tensor or array, or a list of them) into n_parts parts of about equal
    size: (n_parts - 1,) int64 quantiles of a systematic sample, sentinels
    left out. A copy of ``rufus_tpu/parallel/sharded.py:make_splitters`` on
    the port's int64 keys; the parts change where keys are counted, never
    the table. An item of the list may also be a list of rows (a batch's
    keys, a tensor a shard, on their devices), sampled as the rows of one
    2-D array: JAX's sharded (n, W) batch."""
    arrs = list(keys) if isinstance(keys, (list, tuple)) else [keys]
    per = max(1, sample // max(1, len(arrs)))
    pools = []
    for a in arrs:
        rows = a if isinstance(a, (list, tuple)) else [a]
        stride = max(1, rows[0].shape[-1] // max(1, per))
        pools += [r[..., ::stride] for r in rows]
    return splitters_of_sample(pools, n_parts, sample)


def splitters_of_sample(pools: list, n_parts: int,
                        sample: int = 1 << 16) -> np.ndarray:
    """make_splitters' quantiles of its strided samples, `pools` (key
    tensors or arrays, in batch and row order)."""
    pools = [(r.cpu().numpy() if isinstance(r, torch.Tensor)
              else np.asarray(r)).ravel() for r in pools]
    ks = (np.concatenate(pools) if pools
          else np.empty(0)).astype(np.int64)
    ks = ks[ks != codec.SENTINEL]
    if len(ks) == 0:
        return np.linspace(0, float(codec.SENTINEL), n_parts + 1,
                           dtype=np.float64)[1:-1].astype(np.int64)
    m = min(sample, len(ks))
    idx = (np.arange(m, dtype=np.int64) * len(ks)) // m
    pool = np.sort(ks[idx])
    q = (np.arange(1, n_parts, dtype=np.int64) * len(pool)) // n_parts
    return pool[q]


def select_range(keys: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The keys in [lo, hi) (a multipass count's pass; hi <= the sentinel,
    so sentinels drop too). The JAX package turns the others into
    sentinels instead, which fill the pending buffer without being
    counted."""
    return keys[(keys >= lo) & (keys < hi)]
