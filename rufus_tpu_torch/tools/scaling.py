"""Weak scaling of the sharded count, filter, subtract and pulls, on cards.

    python -m rufus_tpu_torch.tools.scaling [--shards-on cuda:0]
        [--out PATH]

The port of the JAX package's ``tools/scaling.py``, which stays as the
reference (it measured virtual CPU devices). A fixed batch a shard (2,048
reads of 160 bases a shard, two batches, k 25, reads sampled at random
positions of a 1 Mbp random genome, as the JAX tool's) at 1, 2 and 4
shards, and 8 where there are eight cards: perfect weak scaling is a flat
time and reads/s that grow with the shards. The mesh is a shard a visible
card (``make_mesh(n)``), or with --shards-on DEVICE n shards of one card
(``make_mesh(n, DEVICE)``, 1, 2 and 4), which shows the cost of the steps
themselves and not of moves between cards.

The count is the range route's (the local-aggregate count: raw keys
buffered a shard and flushed by the table's rule, each batch at these
sizes; its phases time one flush of both batches). The best of 5 of: the
count of the two batches (reads/s, host clock around a synchronised
run), its phases with CUDA events (the most any card took: encode; the
partial sort and compaction; the exchange; the owners' folds), the
(key, count) pairs that crossed between shards and their bytes a shard
(16 a pair), the subtract of three such tables, the pull of 16,384
queries a shard (canonical k-mers of the first batch) from the three
tables (lookups/s), and the filter (one mate against a 4,096-key
HashList). ``count_scaling_eff`` is reads/s at n over n times reads/s at
1 shard. The mesh's table must equal a one-shard mesh's table of the
same batches.

It needs a card: without one it raises. It prints one JSON line with the
card's name and power limit (nvidia-smi) and the card count, and writes
it to --out (by default ``build/scaling.json`` beside the package).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..ops import _build, codec
from ..parallel import (ShardedKmerTable, exchange, local_count_step,
                        make_mesh, mesh_splitters, replicate_hashlist,
                        sharded_filter_step, sharded_query_multi,
                        sharded_subtract_step)
from .radixbench import card_name_and_power_limit

DEFAULT_OUT = os.path.join(os.path.dirname(_build.BUILD_ROOT),
                           "scaling.json")
GENOME, L, K = 1_000_000, 160, 25
PER_SHARD, ITERS, REPS = 2048, 2, 5
QCAP, HL_KEYS = 1 << 14, 4096
PAIR_BYTES = 16  # an int64 key and an int64 count


def coverage_reads(rng, genome: np.ndarray, n: int) -> np.ndarray:
    """n reads of L bases at random positions of `genome`."""
    starts = rng.integers(0, len(genome) - L, size=n)
    return genome[starts[:, None] + np.arange(L)[None, :]]


def _sync(mesh):
    for d in mesh.cards:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def best_wall_s(mesh, fn, reps: int = REPS) -> float:
    """One warm-up call, then the best of `reps` host-clock times of fn,
    every card synchronised before and after."""
    fn()
    best = float("inf")
    for _ in range(reps):
        _sync(mesh)
        t0 = time.perf_counter()
        fn()
        _sync(mesh)
        best = min(best, time.perf_counter() - t0)
    return best


def phase_ms(mesh, setup, fn, reps: int = REPS) -> float:
    """The best of `reps` times of fn(*setup()), each the most that any
    card's CUDA events saw between fn's start and end (the host clock on
    the CPU); setup runs outside the timed span."""
    best = float("inf")
    for i in range(reps + 1):  # the first is a warm-up
        args = setup()
        _sync(mesh)
        cards = [d for d in mesh.cards if d.type == "cuda"]
        marks = []
        for d in cards:
            with torch.cuda.device(d):
                a = torch.cuda.Event(enable_timing=True)
                a.record()
                marks.append(a)
        t0 = time.perf_counter()
        fn(*args)
        host_ms = (time.perf_counter() - t0) * 1e3
        ends = []
        for d in cards:
            with torch.cuda.device(d):
                b = torch.cuda.Event(enable_timing=True)
                b.record()
                ends.append(b)
        _sync(mesh)
        ms = (max(a.elapsed_time(b) for a, b in zip(marks, ends))
              if cards else host_ms)
        if i:
            best = min(best, ms)
    return best


def bench_mesh(mesh, per_shard: int = PER_SHARD, iters: int = ITERS,
               reps: int = REPS, seed: int = 0) -> dict:
    """The measurements of one mesh (see the module's docstring)."""
    n = mesh.n
    rng = np.random.default_rng(seed)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=GENOME)
    B = per_shard * n
    pin = mesh.devices[0].type == "cuda"
    batches = [torch.from_numpy(coverage_reads(rng, genome, B))
               for _ in range(iters)]
    if pin:
        batches = [b.pin_memory() for b in batches]
    quals = torch.full((B, L), ord("I"), dtype=torch.uint8)
    lens = torch.full((B,), L, dtype=torch.int32)
    hl = torch.sort(torch.from_numpy(np.unique(rng.integers(
        0, 1 << 50, HL_KEYS, dtype=np.int64)))).values
    hashlist = replicate_hashlist(mesh, hl.to(mesh.devices[0]), K)
    splitters = mesh_splitters(mesh, [local_count_step(mesh, batches[0], K)])

    def count_epoch(stream=batches, on=mesh):
        t = ShardedKmerTable(on, K, splitters=splitters if on is mesh
                             else None)
        for b in stream:
            t.fold_batch(local_count_step(on, b, K))
        t.flush()
        return t

    def buffered():
        # the batches buffered for one flush: a table without splitters
        # waits for its splitters' sample, then takes the run's
        t = ShardedKmerTable(mesh, K)
        for b in batches:
            t.fold_batch(local_count_step(mesh, b, K))
        t.splitters = splitters
        return t

    def received():
        return ShardedKmerTable(mesh, K, splitters=splitters), exchange(
            mesh, *buffered().partials())

    filter_s = best_wall_s(mesh, lambda: [sharded_filter_step(
        mesh, [(b, quals, lens)], hashlist, K, 15, 1) for b in batches], reps)
    pool = local_count_step(mesh, batches[0], K)[0].cpu()
    pool = codec.keys_i64_to_u64(pool[pool != codec.SENTINEL].numpy())
    queries = pool[rng.integers(0, len(pool), n * QCAP)]
    count_s = best_wall_s(mesh, count_epoch, reps)
    t = count_epoch()
    host = t.to_host()
    one = count_epoch(on=make_mesh(1, mesh.devices[0])).to_host()
    if not (np.array_equal(host.keys, one.keys)
            and np.array_equal(host.counts, one.counts)):
        raise AssertionError(f"the table of {n} shards differs from the "
                             "one-shard table of the same batches")
    encode = phase_ms(mesh, lambda: (), lambda: local_count_step(
        mesh, batches[0], K), reps)
    local = phase_ms(mesh, lambda: (buffered(),), lambda t_: t_.partials(),
                     reps)
    ex = phase_ms(mesh, lambda: buffered().partials(),
                  lambda k_, c_: exchange(mesh, k_, c_), reps)
    fold_ms = phase_ms(mesh, received, lambda t_, got: t_.fold_received(
        *got), reps)
    trio = [count_epoch([batches[s % iters]]) for s in range(3)]
    sub_s = best_wall_s(mesh, lambda: sharded_subtract_step(
        trio[0], trio[1:], 2, 2, 10 ** 9), reps)
    pull_s = best_wall_s(mesh, lambda: sharded_query_multi(trio, queries),
                         reps)
    pairs = t.stats["exchanged_keys"]
    sizes = t.shard_keys()
    return {"shards": n, "devices": [str(d) for d in mesh.devices],
            "reads": B * iters, "filter_reads_per_s": B * iters / filter_s,
            "count_reads_per_s": B * iters / count_s, "count_s": count_s,
            "phase_ms": {"encode_per_batch": encode,
                         "partial_sort_ms (all batches)": local,
                         "exchange_ms (the flush)": ex,
                         "owners_fold_ms (all batches)": fold_ms},
            "exchanged_pairs": pairs,
            "exchanged_bytes_per_shard": pairs * PAIR_BYTES / n,
            "shard_keys_max": max(sizes), "shard_keys_mean": sum(sizes) / n,
            "subtract_ms": sub_s * 1e3,
            "query_lookups_per_s": len(queries) * 3 / pull_s,
            "unique_keys": len(host)}


def efficiencies(results: list) -> None:
    """Adds count_scaling_eff and filter_scaling_eff: the rate at n over n
    times the rate at one shard."""
    base = results[0]
    for r in results:
        n = r["shards"] / base["shards"]
        for what in ("count", "filter"):
            r[f"{what}_scaling_eff"] = (r[f"{what}_reads_per_s"]
                                        / (base[f"{what}_reads_per_s"] * n))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards-on", default=None,
                    help="shards of this one card (e.g. cuda:0), not a "
                         "shard a card")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the scaling tool measures cards, and no CUDA "
                           "device is available")
    cards = torch.cuda.device_count()
    if args.shards_on:
        meshes = [make_mesh(n, args.shards_on) for n in (1, 2, 4)]
    else:
        meshes = [make_mesh(n) for n in (1, 2, 4, 8) if n <= cards]
    results = [bench_mesh(m) for m in meshes]
    efficiencies(results)
    out = {"mode": "weak scaling, 2048 reads x 160 bp a shard, two batches, "
                   "k 25, 1 Mbp genome",
           "layout": (f"shards of {args.shards_on}" if args.shards_on
                      else "a shard a card"),
           "nvidia_smi": card_name_and_power_limit(), "cards": cards,
           "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "results": results}
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
