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
   counts, as the fold's merge does, beside the sort alone.

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

from ..ops import _build, cuda_fold
from ..ops.table import PENDING_KEYS
from ..pipeline.driver import resolve_device
from .radixbench import best_ms, card_name_and_power_limit

DEFAULT_OUT = os.path.join(os.path.dirname(_build.BUILD_ROOT),
                           "sortbench.json")
BATCH_KEYS = 8 << 20
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


def run(dev: torch.device, batch_keys: int = BATCH_KEYS,
        pending_keys: int = PENDING_KEYS) -> dict:
    cuda = dev.type == "cuda"
    return {
        "sort": [sort_rate(n, SEED, dev) for n in (batch_keys, pending_keys)],
        "merge": merge_vs_sort(batch_keys, SEED, dev),
        "compaction": gather_vs_compact(batch_keys, SEED, dev),
        "payload": sort_with_payload(batch_keys, SEED, dev),
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
