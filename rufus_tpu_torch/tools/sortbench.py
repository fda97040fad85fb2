"""What the count engine's reorder primitives cost on the card.

    python -m rufus_tpu_torch.tools.sortbench [--device cuda]
        [--batch-keys 8388608] [--pending-keys 100663296] [--out PATH]

The port of the JAX package's ``tools/sortbench.py``, which stays as the
reference. It asks that tool's four questions of the port's primitives,
on int64 keys (uniform below 2**50, from a CPU ``torch.Generator``
seeded with 0):

1. ``torch.sort`` at the batch size (8 Mi keys, the JAX tool's n) and at
   the fold's pending size (96 Mi keys, ``ops/table.py:PENDING_KEYS``), as
   effective GB/s: 16 bytes a key (each key read and written once) over
   the time;
2. is merging two sorted runs cheaper than sorting? ``torch.sort`` of the
   concatenation of two sorted halves, beside the stable sort the fold
   uses on it (``ops/count.py:merge_sum``) and a sort of the same keys
   unsorted; the three outputs must be equal;
3. compaction by a gather (``keys[sel]``, half the keys kept) against
   ``compact_runs`` of n sorted keys drawn from n/2 values (about 0.43 n
   runs);
4. a sort carrying a payload: the stable sort's indices gathering int64
   counts, as ``merge_sum`` does, beside the sort alone;
5. the fold's merge (``ops/cuda_merge.py:merge_runs``) of a run of half
   a batch of unique keys (4 Mi), a third of them in the table, into a
   table of 10/8 of a batch (10 Mi), as a 4 Mbp sample's table meets a
   batch's unique run:
   its time beside its bytes over 3.35 TB/s (16 bytes a key of each run
   read, 16 a key of the union written), its plain version's and
   ``merge_sum``'s on the same runs; the three outputs must be equal;
6. on the card, the device bytes a key of each step of a fold, by
   ``torch.cuda.max_memory_allocated`` (the budget's constants in
   ``ops/table.py``): a batch of raw keys folded into an empty
   ``DeviceKmerTable`` (bytes a pending key), then an eighth of another
   batch folded into that table (bytes a key of the table and the
   eighth's unique run), and ``merge_sum`` of the same two runs.

The JAX tool's u32 hi/lo planes and its bitonic merge were the TPU's
workarounds (no 64-bit lanes, no scatter); the questions stay, the layout
does not. Times are CUDA events, a warm-up and the best of 3. It runs on
the card unless ``--device cpu`` is given (then the times are the host's),
raises when no card is there, prints one JSON line and writes it to --out
(by default ``build/sortbench.json``).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..ops import _build, count, cuda_fold, cuda_merge
from ..ops.table import PENDING_KEYS, DeviceKmerTable
from ..pipeline.driver import resolve_device
from .radixbench import best_ms, card_name_and_power_limit

DEFAULT_OUT = os.path.join(os.path.dirname(_build.BUILD_ROOT),
                           "sortbench.json")
BATCH_KEYS = 8 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KEY_BITS = 50
SEED = 0


def keys_of(n: int, seed: int, device, high: int = 1 << KEY_BITS):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, high, (n,), generator=g,
                         dtype=torch.int64).to(device)


def gbps(n: int, ms: float, bytes_per_key: int = 16) -> float:
    return bytes_per_key * n / ms / 1e6


def sort_rate(n: int, seed: int, dev) -> dict:
    """Question 1 at n keys."""
    keys = keys_of(n, seed, dev)
    ms = best_ms(lambda: torch.sort(keys), dev)
    return {"n": n, "sort_ms": ms, "eff_gbps": gbps(n, ms)}


def merge_vs_sort(n: int, seed: int, dev) -> dict:
    """Question 2: two sorted halves of n keys."""
    keys = keys_of(n, seed, dev)
    h = n // 2
    runs = torch.cat([torch.sort(keys[:h]).values,
                      torch.sort(keys[h:]).values])
    resort = torch.sort(runs).values
    stable = torch.sort(runs, stable=True).values
    if not (torch.equal(resort, stable)
            and torch.equal(stable, torch.sort(keys).values)):
        raise AssertionError("the sorts of the two runs disagree")
    return {"n": n,
            "resort_runs_ms": best_ms(lambda: torch.sort(runs), dev),
            "stable_sort_runs_ms": best_ms(
                lambda: torch.sort(runs, stable=True), dev),
            "sort_unsorted_ms": best_ms(lambda: torch.sort(keys), dev)}


def gather_vs_compact(n: int, seed: int, dev) -> dict:
    """Question 3: keep half of n keys by a gather, or compact n sorted
    keys drawn from n/2 values (about 0.43 n runs)."""
    keys = keys_of(n, seed, dev)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    sel = torch.sort(torch.randperm(n, generator=g)[: n // 2]).values.to(dev)
    dup = torch.sort(keys_of(n, seed + 2, dev, high=n // 2)).values
    out_keys, _ = cuda_fold.compact_runs(dup)
    gather_ms = best_ms(lambda: keys[sel], dev)
    compact_ms = best_ms(lambda: cuda_fold.compact_runs(dup), dev)
    return {"n": n, "gather_half_ms": gather_ms,
            "gather_eff_gbps": gbps(n // 2, gather_ms, 16),
            "compact_runs_ms": compact_ms, "runs": out_keys.numel(),
            "compact_eff_gbps": (8 * n + 16 * out_keys.numel())
            / compact_ms / 1e6}


def sort_with_payload(n: int, seed: int, dev) -> dict:
    """Question 4: the fold's merge, a stable sort whose indices gather
    the counts."""
    keys = keys_of(n, seed, dev)
    counts = keys_of(n, seed + 3, dev, high=1000)

    def merge():
        s, order = torch.sort(keys, stable=True)
        return s, counts[order]

    return {"n": n, "sort_ms": best_ms(lambda: torch.sort(keys), dev),
            "stable_sort_gather_ms": best_ms(merge, dev)}


def fold_merge(n_table: int, n_run: int, seed: int, dev) -> dict:
    """Question 5."""
    table_k = torch.unique(keys_of(n_table, seed, dev))
    g = torch.Generator(device="cpu").manual_seed(seed + 4)
    pick = torch.randperm(table_k.numel(), generator=g)[: n_run // 3]
    run_k = torch.unique(torch.cat([table_k[pick.to(dev)],
                                    keys_of(n_run - pick.numel(), seed + 5,
                                            dev)]))
    table_c = keys_of(table_k.numel(), seed + 6, dev, high=1000) + 1
    run_c = keys_of(run_k.numel(), seed + 7, dev, high=1000) + 1
    runs = (table_k, table_c, run_k, run_c)
    got = cuda_merge.merge_runs(*runs)
    plain = cuda_merge.merge_runs_torch(*runs)
    old = count.merge_sum([table_k, run_k], [table_c, run_c])
    if not all(torch.equal(a, b) for a, b in zip(got + plain, plain + old)):
        raise AssertionError("merge_runs, its plain version and merge_sum "
                             "disagree")
    nbytes = 16 * (table_k.numel() + run_k.numel() + got[0].numel())
    before = cuda_merge.merge_runs.launches
    ms = best_ms(lambda: cuda_merge.merge_runs(*runs), dev)
    return {"table_keys": table_k.numel(), "run_keys": run_k.numel(),
            "union_keys": got[0].numel(), "merge_runs_ms": ms,
            "launches": cuda_merge.merge_runs.launches - before,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
            "plain_ms": best_ms(
                lambda: cuda_merge.merge_runs_torch(*runs), dev),
            "merge_sum_ms": best_ms(
                lambda: count.merge_sum([table_k, run_k], [table_c, run_c]),
                dev)}


def fold_bytes(n: int, seed: int, dev) -> dict | None:
    """Question 6 (None off the card): a batch of n raw keys, drawn from
    n / 2 values as a read batch's are about half unique; an eighth of
    another batch, drawn from values none of the first holds, so that the
    union is as large as it can be. Each step's inputs are made after the
    reading it is measured from, and nothing but the table holds them."""
    if dev.type != "cuda":
        return None

    def peak_since(base: int) -> int:
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev) - base

    def eighth():
        return keys_of(n // 8, seed + 8, dev) + n

    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = DeviceKmerTable(25, dev)
    t.fold_batch(keys_of(n, seed, dev, high=n // 2))
    pending = peak_since(base) / n
    n_table = t.n_keys
    u = torch.unique(eighth()).numel()
    torch.cuda.reset_peak_memory_stats(dev)
    t.fold_batch(eighth())
    t.flush()
    run_merge = peak_since(base) / (n_table + u)
    folds = t.folds
    # merge_sum of the same two runs, the parts held by its lists alone
    parts_k, parts_c = map(list, zip((t.keys[:n_table].clone(),
                                      t.counts[:n_table].clone()),
                                     count.count_batch(eighth())))
    t.release()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev) - 16 * (n_table + u)
    torch.cuda.reset_peak_memory_stats(dev)
    out = count.merge_sum(parts_k, parts_c)
    merge_sum = peak_since(base) / (n_table + u)
    del out
    return {"pending_keys": n, "table_keys": n_table, "run_keys": u,
            "folds": folds, "pending_bytes_per_key": pending,
            "run_merge_bytes_per_key": run_merge,
            "merge_sum_bytes_per_key": merge_sum}


def run(dev: torch.device, batch_keys: int = BATCH_KEYS,
        pending_keys: int = PENDING_KEYS) -> dict:
    cuda = dev.type == "cuda"
    return {
        "sort": [sort_rate(n, SEED, dev) for n in (batch_keys, pending_keys)],
        "merge": merge_vs_sort(batch_keys, SEED, dev),
        "compaction": gather_vs_compact(batch_keys, SEED, dev),
        "payload": sort_with_payload(batch_keys, SEED, dev),
        "fold_merge": fold_merge(batch_keys * 10 // 8, batch_keys // 2,
                                 SEED, dev),
        "fold_bytes": fold_bytes(batch_keys, SEED, dev),
        "key_bits": KEY_BITS, "seed": SEED,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "nvidia_smi": card_name_and_power_limit() if cuda else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch-keys", type=int, default=BATCH_KEYS)
    ap.add_argument("--pending-keys", type=int, default=PENDING_KEYS)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    out = run(resolve_device(args.device), args.batch_keys,
              args.pending_keys)
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
