"""The sharded chain: a sample's k-mer table partitioned over a mesh of
shards, and the count, subtract, filter and pull steps that run on it.

The port of ``rufus_tpu/parallel/sharded.py``, range-partitioned (the
JAX pipeline's local-aggregate count):

  count:    each shard encodes its contiguous slice of every read batch
            and buffers the raw keys (no exchange a batch); a flush sorts
            and compacts each shard's buffer into sorted unique (key,
            count) partials, cuts them at range splitters (quantiles of a
            sample of the first batches; the partials are sorted, so each
            shard's part is one slice) and sends each slice to its owner,
            which folds what it receives into its table. The shards in
            order are the sorted table.
  subtract: every sample's table shares the splitters, so the modified
            merge is local to each shard; the mutant keys of the shards,
            gathered in order, are the HashList;
  filter:   the batch in contiguous slices over the shards, the HashList
            replicated;
  pulls:    queries routed to their owner shard by the splitters, searched
            there in every table, the answers routed back.

A ``ShardMesh`` is the shards one process holds, in shard order, and its
place among the processes of a ``torch.distributed`` group. On one
process (``make_mesh``) the mesh is every shard: every visible card
(``make_mesh()`` on "cuda"), or several shards on one device
(``make_mesh(4, "cuda:0")``, ``make_mesh(4, "cpu")``, the counterpart of
the JAX tests' virtual devices), and its collectives are tensor moves
between shard devices issued in shard order. On a process mesh
(``parallel/process.py``) each rank holds its own contiguous run of shards
on its device, and the collectives go through the group: segment sizes
first, then the segments, with ``all_to_all_single``. Every step takes the
rank's own rows (``local_rows``), and every rank enters every collective,
with an empty slice if it has nothing. Each shard's table is a
``DeviceKmerTable`` on its device, so each shard runs the same kernels as
the single-device path.

What differs from the JAX package changes no table: segments are sized
exactly, so there is no route capacity, overflow count or retry; keys and
splitters are int64 (keys stay below 2**62, where the int64 and uint64
orders agree).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops import codec, count
from ..ops import query as _query
from ..ops.cuda_filter import hashlist_index, window_hits
from ..ops.table import (PENDING_BYTES, PENDING_KEYS, TABLE_BYTES,
                         DeviceKmerTable, count_step, make_splitters,
                         splitters_of_sample, subtract_step)

SPLIT_BATCHES = 16  # batches whose keys sample the splitters, at most
SPLIT_SAMPLE = 1 << 16  # keys the splitters are the quantiles of, at most


@dataclass(frozen=True)
class ShardMesh:
    """The shards this process holds, their devices in shard order (a
    device may hold several); on a process mesh, also its `rank` among the
    `world` processes of `group`. Rank r holds shards [r*local, (r+1)*local)
    of world*local."""

    devices: tuple
    rank: int = 0
    world: int = 1
    group: object = None

    @property
    def local(self) -> int:
        """The shards this process holds."""
        return len(self.devices)

    @property
    def n(self) -> int:
        """The shards of the whole mesh."""
        return self.world * len(self.devices)

    @property
    def first(self) -> int:
        """The shard number of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def cards(self) -> list:
        """The distinct devices of this process, in shard order."""
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


def local_rows(mesh: ShardMesh, batch):
    """This process's rows of a global batch (a tensor, array or list):
    those of its shards when the batch is cut over every shard as
    ``tensor_split`` cuts it, so that every shard gets the rows it gets on
    a single-process mesh. A single-process mesh holds them all."""
    if mesh.world == 1:
        return batch
    base, extra = divmod(len(batch), mesh.n)

    def start(i):
        return i * base + min(i, extra)

    return batch[start(mesh.first):start(mesh.first + mesh.local)]


# -- collectives: moves between shard devices, or through the group -------


def all_to_all(mesh: ShardMesh, segments: list) -> list:
    """segments[s][dst]: this process's shard s -> shard dst of the mesh,
    tensors split along their first dimension. Returns, for each of this
    process's shards, the segments sent to it, one a source shard in shard
    order (JAX's all_to_all concatenates in that order), on its device.

    On one process the segments are moved between devices. Between ranks
    the segment sizes are exchanged first (one ``all_to_all_single`` of
    int64 sizes: the host learns what it will receive), then the segments,
    ``all_to_all_single`` with those split sizes."""
    if mesh.world == 1:
        return [[segments[src][dst].to(d, non_blocking=True)
                 for src in range(mesh.n)]
                for dst, d in enumerate(mesh.devices)]
    loc, dev = mesh.local, mesh.devices[0]
    # (rank q, source s, destination d) order: rank q's block, in the
    # order it unpacks
    send = [segments[s][q * loc + d] for q in range(mesh.world)
            for s in range(loc) for d in range(loc)]
    sizes = torch.tensor([t.shape[0] for t in send], dtype=torch.int64,
                         device=dev)
    got_sizes = torch.empty_like(sizes)
    dist.all_to_all_single(got_sizes, sizes, group=mesh.group)
    got = got_sizes.tolist()
    flat = torch.cat(send)
    out = flat.new_empty((sum(got), *flat.shape[1:]))
    dist.all_to_all_single(
        out, flat, output_split_sizes=got_sizes.view(mesh.world, -1)
        .sum(1).tolist(), input_split_sizes=sizes.view(mesh.world, -1)
        .sum(1).tolist(), group=mesh.group)
    parts = out.split(got)
    return [[parts[(p * loc + s) * loc + d] for p in range(mesh.world)
             for s in range(loc)] for d in range(loc)]


def all_gather(mesh: ShardMesh, values: list) -> list:
    """One 1-D tensor a shard of this process -> every shard's, in shard
    order. On one process that is `values`; between ranks the sizes are
    gathered first, then the values, padded to the largest rank's, on this
    process's device."""
    if mesh.world == 1:
        return list(values)
    loc, dev = mesh.local, mesh.devices[0]
    sizes = torch.tensor([v.numel() for v in values], dtype=torch.int64,
                         device=dev)
    all_sizes = [torch.empty_like(sizes) for _ in range(mesh.world)]
    dist.all_gather(all_sizes, sizes, group=mesh.group)
    sz = torch.cat(all_sizes).tolist()
    per_rank = [sum(sz[r * loc:(r + 1) * loc]) for r in range(mesh.world)]
    flat = torch.cat([v.reshape(-1).to(dev) for v in values])
    padded = flat.new_zeros(max(per_rank))
    padded[:flat.numel()] = flat
    outs = [torch.empty_like(padded) for _ in range(mesh.world)]
    dist.all_gather(outs, padded, group=mesh.group)
    return [t for r, o in enumerate(outs)
            for t in o[:per_rank[r]].split(sz[r * loc:(r + 1) * loc])]


def all_max(mesh: ShardMesh, values: list) -> list:
    """The elementwise max of small ints over the ranks: what every rank
    decides a collective from. On one process, `values`."""
    if mesh.world == 1:
        return list(values)
    t = torch.tensor(values, dtype=torch.int64, device=mesh.devices[0])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t.tolist()


def replicate(mesh: ShardMesh, t: torch.Tensor) -> list:
    """A copy of `t` for each shard of this process: one a device, shared
    by its shards. On a process mesh rank 0's `t` (1-D) is broadcast
    through the group first."""
    if mesh.world > 1:
        dev = mesh.devices[0]
        size = torch.tensor([t.numel()], dtype=torch.int64, device=dev)
        dist.broadcast(size, 0, group=mesh.group)
        t = (t.reshape(-1).to(dev).contiguous() if mesh.rank == 0
             else t.new_empty(int(size), device=dev))
        dist.broadcast(t, 0, group=mesh.group)
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
    """A (B, L) uint8 read batch (on the host or a device; on a process
    mesh the rank's rows) -> each shard's raw count-1 keys on its device:
    the rows cut into contiguous slices, one a shard (JAX's
    local_count_step gives each device B/n rows), each moved to its shard
    and encoded there. An empty slice gives no keys."""
    out = []
    for part, d in zip(reads.tensor_split(mesh.local), mesh.devices):
        if part.shape[0] == 0:
            out.append(torch.empty(0, dtype=torch.int64, device=d))
        else:
            out.append(count_step(part.to(d, non_blocking=True), k))
    return out


def exchange(mesh: ShardMesh, seg_keys: list, seg_counts: list,
             stats: dict | None = None):
    """(key, count) segments, [shard of this process][owner shard], sent
    to their owners: ``all_to_all`` of the keys and of the counts. Returns
    what each shard of this process received, in source-shard order. With
    `stats`, its "exchanged_keys" gains the pairs that crossed between
    shards."""
    if stats is not None:
        stats["exchanged_keys"] = stats.get("exchanged_keys", 0) + sum(
            seg_keys[s][dst].numel() for s in range(mesh.local)
            for dst in range(mesh.n) if dst != mesh.first + s)
    return all_to_all(mesh, seg_keys), all_to_all(mesh, seg_counts)


def mesh_splitters(mesh: ShardMesh, batches: list) -> np.ndarray:
    """``make_splitters`` of batches buffered on the mesh, each a list of
    raw key tensors, one a shard of this process: each shard's keys are
    sampled with the stride its batch's first shard sets (the mesh's
    longest slice: tensor_split puts the larger slices first), and the
    samples are gathered in batch and shard order, so every rank gets the
    splitters a single-process mesh computes from the same batches."""
    if mesh.world == 1:
        return make_splitters(batches, mesh.n, SPLIT_SAMPLE)
    per = max(1, SPLIT_SAMPLE // max(1, len(batches)))
    pools = []
    for rows in batches:
        (longest,) = all_max(mesh, [max(r.numel() for r in rows)])
        stride = max(1, longest // per)
        pools += all_gather(mesh, [r[::stride] for r in rows])
    return splitters_of_sample(pools, mesh.n, SPLIT_SAMPLE)


class ShardedKmerTable:
    """A sample's count table over a mesh: shard s holds, as a
    DeviceKmerTable on its device, the sorted unique keys it owns and
    their counts: shard s owns [splitters[s-1], splitters[s]), so the
    shards in order are the whole sorted table.

    Batches (one raw key tensor a shard, ``local_count_step``) are
    buffered a shard until a shard's buffer reaches the least of
    `pending_budget` and a quarter of the smallest shard's table, the rule
    of DeviceKmerTable, then flushed: partials, exchange, owners' folds.
    `splitters` is the run's partition; None freezes it at the first
    flush, or after SPLIT_BATCHES batches, from those batches' keys, and
    until then the buffers wait for `pending_budget` alone, so that the
    splitters sample more than one batch. `folds` counts the shards'
    folds, `fold_keys_max` the most keys a shard's buffer took.

    With `budget` (bytes) and `spill` (one process only), each shard's
    DeviceKmerTable guards budget // n, and a flush guards each shard's
    sort of its buffer beside its table the same way; when any shard's
    fold would pass its share, `spill(self)` writes the whole table as
    one sorted run and calls `reset`. `stats` counts flushes, the (key,
    count) pairs this process's shards sent to other shards, and spills.

    On a process mesh every rank builds the table and folds every batch
    (its slice may be empty). The decisions that lead to a collective, a
    flush before a batch that would pass a shard's cap and a flush at the
    budget, are taken from sizes reduced over the ranks; the count of
    buffered batches, which freezes the splitters, is the same on every
    rank, since every rank folds every batch."""

    def __init__(self, mesh: ShardMesh, k: int, splitters=None,
                 pending_budget: int = PENDING_KEYS,
                 budget: int | None = None, spill=None):
        if spill is not None and mesh.world > 1:
            raise NotImplementedError(
                "a spilled run is written from every shard's table, which "
                "a process of a process mesh holds only in part")
        self.mesh = mesh
        self.k = codec.check_k(k)
        self.splitters = (None if splitters is None
                          else np.asarray(splitters, np.int64))
        if self.splitters is not None and len(self.splitters) != mesh.n - 1:
            raise ValueError(f"{len(self.splitters)} splitters for "
                             f"{mesh.n} shards")
        self.spill = spill
        share = None if budget is None else budget // mesh.n
        self.shards = [DeviceKmerTable(k, d, pending_budget, budget=share,
                                       spill=None if spill is None
                                       else self._spill_all)
                       for d in mesh.devices]
        self.pending_cap = self.shards[0].pending_cap
        self.pending_budget = (pending_budget if self.pending_cap is None
                               else min(pending_budget, self.pending_cap))
        self._pending: list = [[] for _ in mesh.devices]
        self._pending_els = [0] * mesh.local
        self.fold_keys_max = 0
        self.stats = {"flushes": 0, "exchanged_keys": 0, "spills": 0}

    @property
    def folds(self) -> int:
        return sum(s.folds for s in self.shards)

    @property
    def n_keys(self) -> int:
        return sum(self.shard_keys())

    def shard_keys(self) -> list:
        """Each shard's unique keys (the partition's balance), every shard
        of the mesh."""
        sizes = [s.n_keys for s in self.shards]
        if self.mesh.world == 1:
            return sizes
        dev = self.mesh.devices[0]
        return [int(t) for t in all_gather(
            self.mesh, [torch.tensor([v], device=dev) for v in sizes])]

    def fold_batch(self, parts: list):
        """Queue one batch of raw count-1 keys, a tensor a shard of this
        process on its device (``local_count_step``). Flushes when a
        shard's buffer reaches the least of the budget and a quarter of
        the smallest shard's table; first, when the batch would pass a
        shard's cap under a device budget, or reaches that alone, what is
        buffered."""
        if len(parts) != self.mesh.local:
            raise ValueError(f"{len(parts)} parts for {self.mesh.local} "
                             "shards")
        sizes = [p.numel() for p in parts]
        largest, pending, least = all_max(self.mesh, [
            max(sizes), max(e + s for e, s in zip(self._pending_els, sizes)),
            -min(s.n_keys for s in self.shards)])
        if self.pending_cap is not None:
            if largest > self.pending_cap:
                raise RuntimeError(
                    f"a batch slice of {largest} keys passes a shard's "
                    f"device budget alone (at most {self.pending_cap} "
                    "pending keys); lower batch_size or raise hbm_budget_gb")
            if pending > self.pending_cap:
                self.flush()
                pending = largest
        # every rank buffers every batch, so all agree whether one is here
        if any(self._pending) and largest >= self._fold_at(-least):
            self.flush()
            pending = largest
        for i, p in enumerate(parts):
            self._pending[i].append(p.reshape(-1))
            self._pending_els[i] += sizes[i]
        if (self.splitters is None
                and len(self._pending[0]) >= SPLIT_BATCHES):
            self._freeze()
        if pending >= self._fold_at(-least):
            self.flush()

    def _fold_at(self, least: int) -> int:
        """Keys in a shard's buffer that start a flush, `least` the
        smallest shard's table: `pending_budget` until the splitters are
        frozen."""
        if self.splitters is None:
            return self.pending_budget
        return min(self.pending_budget, least // 4)

    def _freeze(self):
        """Splitters from the buffered batches, the first SPLIT_BATCHES
        (none has been flushed yet): spaced batches, since one batch of a
        coordinate-sorted BAM is one locality of the genome."""
        batches = [[self._pending[s][i] for s in range(self.mesh.local)]
                   for i in range(min(SPLIT_BATCHES, len(self._pending[0])))]
        self.splitters = mesh_splitters(self.mesh, batches)

    def _spill_all(self, _shard=None):
        self.spill(self)
        self.stats["spills"] += 1

    def flush(self):
        """Fold every buffered batch: each shard's buffer sorted and
        compacted into a partial, the partials cut at the splitters and
        exchanged, each owner folding what it receives (the counted route
        of compact_runs). Each shard's segment bounds are read on the host
        to size the exchange exactly."""
        # every rank buffers every batch, so all agree whether one is here
        if not any(self._pending):
            return
        # a spill is on one process only, so this needs no collective
        if any(s._over_budget(TABLE_BYTES * s.n_keys + PENDING_BYTES * e)
               for s, e in zip(self.shards, self._pending_els)):
            pending, els = self._pending, self._pending_els
            self._pending = [[] for _ in self.mesh.devices]
            self._pending_els = [0] * self.mesh.local
            self._spill_all()
            self._pending, self._pending_els = pending, els
        self.stats["flushes"] += 1
        self.fold_keys_max = max(self.fold_keys_max, *self._pending_els)
        self.fold_received(*exchange(self.mesh, *self.partials(),
                                     self.stats))

    def partials(self):
        """The flush's local work: each shard's buffered raw keys
        sorted and compacted into a sorted unique partial, cut at the
        splitters into one (key, count) segment an owner shard (the
        segment bounds read on the host, which sizes the exchange). Empties
        the buffers; returns the keys' and counts' segments, [shard of this
        process][owner shard]."""
        if self.splitters is None:
            self._freeze()
        mesh = self.mesh
        pending = self._pending
        self._pending = [[] for _ in range(mesh.local)]
        self._pending_els = [0] * mesh.local
        partials, bounds = [], []
        for parts, d in zip(pending, mesh.devices):
            keys = parts[0] if len(parts) == 1 else torch.cat(parts)
            parts.clear()
            if keys.numel():
                pk, pc = count.count_batch(keys)
            else:
                pk, pc = keys, keys.clone()
            del keys
            partials.append((pk, pc))
            bounds.append(segment_bounds(pk, splitters_on(self.splitters, d)))
        # read once every shard's work is queued, so that cards overlap
        lens = [np.diff(b.tolist()).tolist() for b in bounds]
        return ([pk.split(n) for (pk, _), n in zip(partials, lens)],
                [pc.split(n) for (_, pc), n in zip(partials, lens)])

    def fold_received(self, keys_in: list, counts_in: list):
        """Each owner shard folds the (key, count) segments it received
        (the counted route of compact_runs)."""
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
        """Every shard's keys and counts gathered into a host KmerTable
        (uint64 keys): the shards concatenated. On a process mesh every
        rank gets the whole table."""
        self.flush()
        keys = torch.cat([t.cpu() for t in all_gather(
            self.mesh, [s.keys for s in self.shards])])
        counts = torch.cat([t.cpu() for t in all_gather(
            self.mesh, [s.counts for s in self.shards])])
        return count.KmerTable(self.k, codec.keys_i64_to_u64(keys.numpy()),
                               counts.numpy())

    def to_flat(self, path: str, chunk: int = 1 << 25) -> count.KmerTable:
        """The flat layout of the concatenated shards, through chunked
        device-to-host slices and a temporary file; returns the memmapped
        KmerTable. Needs one process."""
        self.flush()
        if self.mesh.world > 1:
            raise NotImplementedError(
                "a process of a process mesh holds only its own shards; "
                "gather the table with to_host")
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
        self._pending_els = [0] * self.mesh.local
        for shard in self.shards:
            shard.release()


def _shared_splitters(tables: list):
    """The splitters the tables share; ValueError if their meshes or
    splitters differ (their shards would not hold the same keys)."""
    first = tables[0]
    for t in tables[1:]:
        if (t.mesh != first.mesh or t.splitters is None
                or first.splitters is None
                or not np.array_equal(t.splitters, first.splitters)):
            raise ValueError("sharded tables of different partitions: every "
                             "table of a run must share its mesh and its "
                             "splitters")
    return first.splitters


# -- the stage steps ----------------------------------------------------------


def sharded_subtract_step(subject: ShardedKmerTable, controls: list,
                          merge_min: int, min_cov: int, max_depth: int):
    """``ops.table.subtract_step`` on each shard's subject and controls
    (SUBJECT keys absent from every control, subject count in
    [max(merge_min, min_cov), max_depth]); the tables share the splitters,
    so no key crosses shards. Returns the sorted mutant keys and their
    subject counts on the first shard's device: the shards' results in
    order, and on a process mesh gathered from every rank, since the
    filter needs the HashList on each."""
    tables = [subject, *controls]
    for t in tables:
        t.flush()
    _shared_splitters(tables)
    mesh = subject.mesh
    dev0 = mesh.devices[0]
    keys, counts = [], []
    for s in range(mesh.local):
        mk, mc = subtract_step(subject.shards[s],
                               [c.shards[s] for c in controls], merge_min,
                               min_cov, max_depth)
        keys.append(mk.to(dev0))
        counts.append(mc.to(dev0))
    keys = torch.cat(all_gather(mesh, keys))
    counts = torch.cat(all_gather(mesh, counts))
    return keys, counts


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
    rows; on a process mesh the rank's rows), `hashlist` is
    ``replicate_hashlist``'s. The rows are cut into contiguous slices, one
    a shard (tensor_split; the JAX driver pads B to a multiple of n
    instead), each filtered on its shard with ``window_hits``; a row is
    kept when a mate has at least `threshold` mutant windows. Returns the
    (B,) bool mask on the host."""
    slices = [[t.tensor_split(mesh.local) for t in mate] for mate in mates]
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
    """Counts of canonical uint64 `kmers_u64` (on a process mesh, the
    rank's own queries) in every table of `tables` (ShardedKmerTables of
    one partition), 0 when absent, as a (len(tables), len(kmers)) int64
    host array: the queries routed from the first shard of this process to
    their owner shards by the splitters, one
    ``torch.searchsorted`` a table there, the answers routed back and put
    in query order. On a process mesh every rank must call it, with or
    without queries."""
    out = np.zeros((len(tables), len(kmers_u64)), np.int64)
    if not tables:
        return out
    mesh = tables[0].mesh
    if mesh.world == 1 and not len(kmers_u64):
        return out
    for t in tables:
        t.flush()
    splitters = _shared_splitters(tables)
    q = torch.from_numpy(codec.keys_u64_to_i64(
        np.asarray(kmers_u64, np.uint64)))
    owner = owners_by_splitters(q, splitters_on(splitters, "cpu"))
    order = torch.argsort(owner, stable=True)
    sizes = torch.bincount(owner, minlength=mesh.n + 1)[:mesh.n].tolist()
    routed = q[order].split(sizes + [len(q) - sum(sizes)])[:mesh.n]
    dev0 = mesh.devices[0]
    empty = torch.empty(0, dtype=torch.int64, device=dev0)
    sent = [[r.to(dev0, non_blocking=True) for r in routed]] + [
        [empty] * mesh.n for _ in range(mesh.local - 1)]
    back = []
    for s, got in enumerate(all_to_all(mesh, sent)):
        qs = torch.cat(got)
        ans = torch.stack([_query.lookup(t.shards[s].keys, t.shards[s].counts,
                                         qs) for t in tables], 1)
        back.append(list(ans.split([g.numel() for g in got])))
    answers = torch.cat(all_to_all(mesh, back)[0]).cpu().numpy()
    out[:, order[:sum(sizes)].numpy()] = answers.T
    return out


def sharded_query_step(table: ShardedKmerTable,
                       kmers_u64: np.ndarray) -> np.ndarray:
    """Counts of `kmers_u64` in one sharded table (the JAX package's
    single-table ``sharded_query_step``): ``sharded_query_multi`` of it."""
    return sharded_query_multi([table], kmers_u64)[0]


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
