"""The sharded chain: a sample's k-mer table range-partitioned over a mesh
of shards, and the count, subtract, filter and pull steps that run on it.

The port of the path that ``rufus_tpu/parallel/sharded.py`` runs for the
JAX pipeline on more than one device, its local-aggregate count:

  count:    each shard encodes its contiguous slice of every read batch
            and buffers the raw keys (no exchange a batch);
  flush:    each shard sorts and compacts its buffer into sorted unique
            (key, count) partials, cuts them at range splitters (quantiles
            of a sample of the first batches; the partials are sorted, so
            each shard's part is one slice) and sends each slice to its
            owner, which folds what it receives into its table;
  subtract: every sample's table shares the splitters, so the modified
            merge is local to each shard, and the shards in order are the
            sorted HashList;
  filter:   the batch in contiguous slices over the shards, the HashList
            replicated;
  pulls:    queries routed to their owner shard, bisected there in every
            table, the answers routed back.

One controller drives the mesh, as in the JAX package. A ``ShardMesh`` is
an ordered list of torch devices, one a shard: every visible card
(``make_mesh()`` on "cuda"), or several shards on one device
(``make_mesh(4, "cuda:0")``, ``make_mesh(4, "cpu")``), the counterpart of
the JAX tests' virtual devices. The collectives are tensor moves between
shard devices issued in shard order (``all_to_all``, ``all_gather``,
``replicate``): no-ops between shards of one device, peer copies between
cards. Every shard's table is a ``DeviceKmerTable`` on its device, so each
shard runs the same kernels as the single-device path.

What differs from the JAX package changes no table: segments are sized
exactly, so there is no route capacity, overflow count or retry; splitters
are int64 (keys stay below 2**62, where the int64 and uint64 orders agree);
and the shards concatenate sorted, since the partition is by range.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import codec, count
from ..ops import query as _query
from ..ops.cuda_filter import hashlist_index, window_hits
from ..ops.table import (PENDING_KEYS, DeviceKmerTable, count_step,
                         make_splitters, subtract_step)

SPLIT_BATCHES = 16  # batches whose keys sample the splitters, at most


@dataclass(frozen=True)
class ShardMesh:
    """The shards' devices, in shard order; a device may hold several."""

    devices: tuple

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def cards(self) -> list:
        """The distinct devices, in shard order."""
        return list(dict.fromkeys(self.devices))


def make_mesh(n: int | None = None, device="cuda") -> ShardMesh:
    """A mesh of `n` shards. On "cuda" (no index) a shard a card,
    cuda:0..n-1, by default every visible card; on "cuda:i" or "cpu", `n`
    shards (default 1) on that one device. Asking for more cards than are
    visible raises ValueError, and "cuda" with no CUDA device
    RuntimeError: the mesh is never smaller than asked, nor moved to the
    CPU."""
    dev = torch.device(device)
    if n is not None and n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    if dev.type == "cuda":
        if n is None and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but no CUDA "
                               "device is available")
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.index is None:
            n = visible if n is None else n
            if n > visible:
                raise ValueError(f"mesh wants {n} CUDA devices but "
                                 f"{visible} are visible")
            return ShardMesh(tuple(torch.device("cuda", i) for i in range(n)))
        if dev.index >= visible:
            raise ValueError(f"mesh wants {dev} but {visible} CUDA devices "
                             "are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return ShardMesh((dev,) * (n or 1))


# -- collectives: tensor moves between shard devices, in shard order -------


def all_to_all(mesh: ShardMesh, segments: list) -> list:
    """segments[src][dst] on devices[src] -> received[dst]: the segments
    for dst moved to devices[dst], in source order (JAX's all_to_all
    concatenates in that order)."""
    return [[segments[src][dst].to(d, non_blocking=True)
             for src in range(mesh.n)] for dst, d in enumerate(mesh.devices)]


def all_gather(values: list) -> list:
    """Each shard's small tensor read on the host, in shard order."""
    return [v.tolist() for v in values]


def replicate(mesh: ShardMesh, t: torch.Tensor) -> list:
    """A copy of `t` for each shard: one a device, shared by its shards."""
    copies: dict = {}
    for d in mesh.cards:
        copies[d] = t.to(d)
    return [copies[d] for d in mesh.devices]


# -- placement and routing --------------------------------------------------


def splitters_on(splitters, device) -> torch.Tensor:
    """The (n-1,) int64 splitters as a tensor on `device`."""
    return torch.as_tensor(np.asarray(splitters, np.int64), device=device)


def owners_by_splitters(keys: torch.Tensor, splitters: torch.Tensor):
    """Owner shard of int64 keys under the range partition: the number of
    splitters <= the key (side "right"), so a key equal to splitters[i-1]
    belongs to shard i; sentinel keys get owner n (routed nowhere)."""
    owner = torch.searchsorted(splitters, keys, right=True)
    return torch.where(keys == codec.SENTINEL,
                       torch.full_like(owner, splitters.numel() + 1), owner)


def segment_bounds(keys: torch.Tensor, splitters: torch.Tensor):
    """The n+1 bounds that cut a sorted unique partial (no sentinels) into
    its owners' slices: 0, the first position >= each splitter (side
    "left", the counterpart of the owner's side "right": a key equal to a
    splitter starts the next slice), its length."""
    ends = torch.searchsorted(keys, splitters)
    return torch.cat([ends.new_zeros(1), ends,
                      ends.new_full((1,), keys.numel())])


def local_count_step(mesh: ShardMesh, reads: torch.Tensor, k: int) -> list:
    """A (B, L) uint8 read batch (on the host or a device) -> each shard's
    raw count-1 keys on its device: the batch cut into n contiguous slices
    of rows (JAX's local_count_step gives each device B/n rows), each
    moved to its shard and encoded there. An empty slice gives no keys."""
    out = []
    for part, d in zip(reads.tensor_split(mesh.n), mesh.devices):
        if part.shape[0] == 0:
            out.append(torch.empty(0, dtype=torch.int64, device=d))
        else:
            out.append(count_step(part.to(d, non_blocking=True), k))
    return out


class ShardedKmerTable:
    """A sample's count table over a mesh: shard s holds, as a
    DeviceKmerTable on devices[s], the sorted unique keys in
    [splitters[s-1], splitters[s]) and their counts. The shards in order
    are the whole sorted table.

    Batches (one raw key tensor a shard, ``local_count_step``) are
    buffered a shard until a shard's buffer reaches `pending_budget` keys,
    then flushed: partials, exchange, owners' folds. `splitters` is the
    run's partition; None freezes it at the first flush, or after
    SPLIT_BATCHES batches, from those batches' keys.

    With `budget` (bytes) and `spill`, each shard's DeviceKmerTable guards
    budget // n; when any shard's fold would pass its share, `spill(self)`
    writes the whole table as one sorted run and calls `reset` (a run must
    hold every shard's range). `stats` counts flushes, the (key, count)
    pairs that crossed between shards, and spills."""

    def __init__(self, mesh: ShardMesh, k: int, splitters=None,
                 pending_budget: int = PENDING_KEYS,
                 budget: int | None = None, spill=None):
        self.mesh = mesh
        self.k = codec.check_k(k)
        self.splitters = (None if splitters is None
                          else np.asarray(splitters, np.int64))
        if self.splitters is not None and len(self.splitters) != mesh.n - 1:
            raise ValueError(f"{len(self.splitters)} splitters for "
                             f"{mesh.n} shards")
        self.spill = spill
        share = None if budget is None else budget // mesh.n
        self.shards = [DeviceKmerTable(k, d, budget=share,
                                       spill=None if spill is None
                                       else self._spill_all)
                       for d in mesh.devices]
        self.pending_cap = self.shards[0].pending_cap
        self.pending_budget = (pending_budget if self.pending_cap is None
                               else min(pending_budget, self.pending_cap))
        self._pending: list = [[] for _ in mesh.devices]
        self._pending_els = [0] * mesh.n
        self.stats = {"flushes": 0, "exchanged_keys": 0, "spills": 0}

    @property
    def folds(self) -> int:
        return sum(s.folds for s in self.shards)

    @property
    def n_keys(self) -> int:
        return sum(s.n_keys for s in self.shards)

    def shard_keys(self) -> list:
        """Each shard's unique keys (the splitters' balance)."""
        return [s.n_keys for s in self.shards]

    def fold_batch(self, parts: list):
        """Queue one batch: raw count-1 keys, a tensor a shard on its
        device. Flushes when a shard's buffer reaches the budget (first,
        under a device budget, when the batch would pass a shard's cap)."""
        if len(parts) != self.mesh.n:
            raise ValueError(f"{len(parts)} parts for {self.mesh.n} shards")
        sizes = [p.numel() for p in parts]
        if self.pending_cap is not None:
            if max(sizes) > self.pending_cap:
                raise RuntimeError(
                    f"a batch slice of {max(sizes)} keys passes a shard's "
                    f"device budget alone (at most {self.pending_cap} "
                    "pending keys); lower batch_size or raise hbm_budget_gb")
            if any(e + s > self.pending_cap
                   for e, s in zip(self._pending_els, sizes)):
                self.flush()
        for i, p in enumerate(parts):
            self._pending[i].append(p.reshape(-1))
            self._pending_els[i] += sizes[i]
        if (self.splitters is None
                and len(self._pending[0]) >= SPLIT_BATCHES):
            self._freeze()
        if max(self._pending_els) >= self.pending_budget:
            self.flush()

    def _freeze(self):
        """Splitters from the buffered batches, the first SPLIT_BATCHES
        (none has been flushed yet): spaced batches, since one batch of a
        coordinate-sorted BAM is one locality of the genome."""
        batches = [[self._pending[s][i] for s in range(self.mesh.n)]
                   for i in range(min(SPLIT_BATCHES, len(self._pending[0])))]
        self.splitters = make_splitters(batches, self.mesh.n)

    def _spill_all(self, _shard=None):
        self.spill(self)
        self.stats["spills"] += 1

    def flush(self):
        """Fold every buffered batch: each shard's buffer sorted and
        compacted into a partial, the partials cut at the splitters and
        exchanged, each owner folding what it receives (the counted route
        of compact_runs). Each shard's segment bounds are read on the host
        to size the exchange exactly."""
        if not any(self._pending):
            return
        if self.splitters is None:
            self._freeze()
        n = self.mesh.n
        self.stats["flushes"] += 1
        # Under a budget a partial's sort needs no guard of its own: it
        # sorts at most pending_cap raw keys beside a table that the
        # owners' merge guard keeps under 2 x pending_cap keys, 84 bytes a
        # pending_cap key in all, within the shard's 128.
        pending, self._pending = self._pending, [[] for _ in range(n)]
        self._pending_els = [0] * n
        partials, bounds = [], []
        for parts, d in zip(pending, self.mesh.devices):
            keys = torch.cat(parts)
            parts.clear()
            if keys.numel():
                pk, pc = count.count_batch(keys)
            else:
                pk, pc = keys, keys.clone()
            del keys
            partials.append((pk, pc))
            bounds.append(segment_bounds(pk, splitters_on(self.splitters, d)))
        del pending
        segments = []
        for (pk, pc), b in zip(partials, all_gather(bounds)):
            lens = np.diff(b).tolist()
            segments.append(list(zip(pk.split(lens), pc.split(lens))))
        del partials
        self.stats["exchanged_keys"] += sum(
            segments[s][d][0].numel() for s in range(n) for d in range(n)
            if s != d)
        keys_in = all_to_all(self.mesh, [[kc[0] for kc in row]
                                         for row in segments])
        counts_in = all_to_all(self.mesh, [[kc[1] for kc in row]
                                           for row in segments])
        del segments
        for dst, shard in enumerate(self.shards):
            for k_, c_ in zip(keys_in[dst], counts_in[dst]):
                if k_.numel():
                    shard.fold_batch(k_, c_)
            keys_in[dst] = counts_in[dst] = None
            shard.flush()

    def apply_lower_count(self, lower: int):
        """jellyfish `count -L` floor, on each shard."""
        self.flush()
        for shard in self.shards:
            shard.apply_lower_count(lower)

    def to_host(self) -> count.KmerTable:
        """The shards concatenated into a host KmerTable (uint64 keys)."""
        self.flush()
        keys = np.concatenate([s.keys.cpu().numpy() for s in self.shards])
        counts = np.concatenate([s.counts.cpu().numpy() for s in self.shards])
        return count.KmerTable(self.k, codec.keys_i64_to_u64(keys), counts)

    def to_flat(self, path: str, chunk: int = 1 << 25) -> count.KmerTable:
        """The flat layout of the concatenated shards, through chunked
        device-to-host slices and a temporary file; returns the memmapped
        KmerTable."""
        self.flush()
        with count.atomic_write(path) as f:
            count.write_flat_header(f, self.k, self.n_keys)
            for plane, dtype in (("keys", "<u8"), ("counts", "<i8")):
                for shard in self.shards:
                    t = getattr(shard, plane)
                    for off in range(0, t.numel(), chunk):
                        t[off:off + chunk].cpu().numpy().astype(
                            dtype).tofile(f)
        return count.KmerTable.load_flat(path)

    def reset(self):
        """Empty every shard's committed table (after a run spill);
        buffered batches stay."""
        for shard in self.shards:
            shard.reset()

    def release(self):
        """Drop the device tensors."""
        self._pending = [[] for _ in self.mesh.devices]
        self._pending_els = [0] * self.mesh.n
        for shard in self.shards:
            shard.release()


def _partition_of(tables: list) -> np.ndarray:
    """The splitters the tables share; ValueError if their meshes or
    partitions differ (their shards would not hold the same key ranges)."""
    first = tables[0]
    for t in tables[1:]:
        if (t.mesh != first.mesh or t.splitters is None
                or first.splitters is None
                or not np.array_equal(t.splitters, first.splitters)):
            raise ValueError("sharded tables of different partitions: every "
                             "table of a run must share its splitters")
    return first.splitters


# -- the stage steps ----------------------------------------------------------


def sharded_subtract_step(subject: ShardedKmerTable, controls: list,
                          merge_min: int, min_cov: int, max_depth: int):
    """``ops.table.subtract_step`` on each shard's subject and controls
    (SUBJECT keys absent from every control, subject count in
    [max(merge_min, min_cov), max_depth]); the tables share the partition,
    so no key crosses shards. Returns the sorted mutant keys and their
    subject counts on the first shard's device."""
    tables = [subject, *controls]
    for t in tables:
        t.flush()
    if controls:
        _partition_of(tables)
    dev0 = subject.mesh.devices[0]
    keys, counts = [], []
    for s in range(subject.mesh.n):
        mk, mc = subtract_step(subject.shards[s],
                               [c.shards[s] for c in controls], merge_min,
                               min_cov, max_depth)
        keys.append(mk.to(dev0))
        counts.append(mc.to(dev0))
    return torch.cat(keys), torch.cat(counts)


def replicate_hashlist(mesh: ShardMesh, table: torch.Tensor, k: int) -> list:
    """The HashList and its ``hashlist_index`` for each shard (one copy a
    device)."""
    by_dev = {}
    for t in replicate(mesh, table):
        if t.device not in by_dev:
            by_dev[t.device] = (t, hashlist_index(t, k))
    return [by_dev[d] for d in mesh.devices]


def sharded_filter_step(mesh: ShardMesh, mates: list, hashlist: list, k: int,
                        min_q: int, threshold: int) -> torch.Tensor:
    """The filter's keep mask of a batch of B reads or pairs: `mates` is
    [(reads, quals, lens)] for one mate or two (host or device tensors of B
    rows), `hashlist` is ``replicate_hashlist``'s. The rows are cut into n
    contiguous slices (tensor_split; the JAX driver pads B to a multiple of
    n instead), each filtered on its shard with ``window_hits``; a row is
    kept when a mate has at least `threshold` mutant windows. Returns the
    (B,) bool mask on the host."""
    slices = [[t.tensor_split(mesh.n) for t in mate] for mate in mates]
    keep = []
    for s, (d, (table, index)) in enumerate(zip(mesh.devices, hashlist)):
        rows = slices[0][0][s].shape[0]
        if rows == 0:
            keep.append(torch.zeros(0, dtype=torch.bool))
            continue
        hit = None
        for mate in slices:
            r, q, l = (p[s].to(d, non_blocking=True) for p in mate)
            h = window_hits(r, q, l, table, k, min_q, index) >= threshold
            hit = h if hit is None else hit | h
        keep.append(hit.cpu())
    return torch.cat(keep)


def sharded_query_multi(tables: list, kmers_u64: np.ndarray) -> np.ndarray:
    """Counts of canonical uint64 `kmers_u64` in every table of `tables`
    (ShardedKmerTables of one partition), 0 when absent, as a
    (len(tables), len(kmers)) int64 host array: the queries routed to
    their owner shard, one ``torch.searchsorted`` a table there, the
    answers routed back and put in query order."""
    out = np.zeros((len(tables), len(kmers_u64)), np.int64)
    if not len(kmers_u64) or not tables:
        return out
    for t in tables:
        t.flush()
    splitters = _partition_of(tables)
    mesh = tables[0].mesh
    q = torch.from_numpy(codec.keys_u64_to_i64(kmers_u64))
    owner = owners_by_splitters(q, splitters_on(splitters, "cpu"))
    order = torch.argsort(owner, stable=True)
    sizes = torch.bincount(owner, minlength=mesh.n + 1)[:mesh.n].tolist()
    routed = q[order].split(sizes + [len(q) - sum(sizes)])[:mesh.n]
    answers = [[] for _ in tables]
    for s, (seg, d) in enumerate(zip(routed, mesh.devices)):
        seg = seg.to(d, non_blocking=True)
        for t, table in enumerate(tables):
            shard = table.shards[s]
            answers[t].append(_query.lookup(shard.keys, shard.counts,
                                            seg).cpu())
    idx = order[: sum(sizes)].numpy()
    for t in range(len(tables)):
        out[t, idx] = torch.cat(answers[t]).numpy()
    return out


def query_counts(tables: list, kmers_u64: np.ndarray) -> np.ndarray:
    """``ops.query.query_counts`` for a list that may hold
    ShardedKmerTables: those answer through one routed dispatch
    (``sharded_query_multi``), the others as ops.query answers them."""
    out = np.zeros((len(tables), len(kmers_u64)), np.int64)
    sharded = [i for i, t in enumerate(tables)
               if isinstance(t, ShardedKmerTable)]
    other = [i for i in range(len(tables)) if i not in sharded]
    if sharded:
        out[sharded] = sharded_query_multi([tables[i] for i in sharded],
                                           kmers_u64)
    if other:
        out[other] = _query.query_counts([tables[i] for i in other],
                                         kmers_u64)
    return out

