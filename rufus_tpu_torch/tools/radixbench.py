"""MSD radix partition plus bucket sorts against one global sort, on the card.

    python -m rufus_tpu_torch.tools.radixbench [--n 26000000] [--k 25]
        [--seed 0] [--device cuda] [--out PATH]

The port of the JAX package's ``tools/radixbench.py``, which stays as the
reference. It asks whether the fold (``ops/table.py``) should partition its
pending keys into 16 buckets by their first two bases and sort each bucket
on its own, instead of sorting all the keys at once. The buckets' ranges
are disjoint, so the sorted buckets would need no merge afterwards.

The keys are uniform below 2**(2k), drawn from a ``torch.Generator`` seeded
with --seed; n is cut down to a multiple of the 8192-key block. Timed with
CUDA events, a warm-up and then the best of 3:

  C. ``global_sort_ms``: ``torch.sort`` of the n keys, the fold's sort;
  B. ``bucket_sorts_ms``: ``torch.sort(dim=1)`` of the (16, n/16) reshape,
     16 independent sorts of n/16 keys;
  A. ``partition_kernel_ms``: the partition kernel
     (``ops/cuda_partition.py``) with its run metadata computed beforehand;
  ``run_metadata_ms``: the per-(block, bucket) counts and cursors.

``radix_total_ms`` is A + B + the metadata, and ``speedup_vs_global_sort``
is C over it; both formulations still need the same run-length compaction
afterwards, so only the sorts are compared. The JAX tool's
``comparator_pass_model`` field is left out: ``torch.sort`` on the card is
a radix sort, not a comparator network, so counting comparator passes
models nothing here.

It runs on the card unless ``--device cpu`` is passed (then the times are
the host's, and the device field says so), and raises when no card is
there. It prints one JSON line and writes it to --out (by default
``build/radixbench.json`` beside the package).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from ..ops import _build, cuda_partition
from ..pipeline.driver import resolve_device

DEFAULT_OUT = os.path.join(os.path.dirname(_build.BUILD_ROOT),
                           "radixbench.json")


def random_keys(n: int, k: int, seed: int, device) -> torch.Tensor:
    """n int64 keys uniform below 2**(2k), from a CPU generator (so the
    same seed gives the same keys on every device)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, 1 << (2 * k), (n,), generator=g,
                         dtype=torch.int64).to(device)


def best_ms(fn, device: torch.device, reps: int = 3) -> float:
    """One warm-up call, then the best of `reps` timed calls: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best


def card_name_and_power_limit():
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def measure(keys: torch.Tensor, k: int) -> dict:
    """The tool's timings on `keys` (a whole number of 8192-key blocks)."""
    n = keys.numel()
    if n == 0 or n % cuda_partition.BLOCK:
        raise ValueError(f"n={n}: needs a positive multiple of "
                         f"{cuda_partition.BLOCK} keys")
    dev = keys.device
    nb = cuda_partition.BUCKETS
    t_global = best_ms(lambda: torch.sort(keys), dev)
    t_buckets = best_ms(lambda: torch.sort(keys.view(nb, n // nb), dim=1),
                        dev)
    t_meta = best_ms(lambda: cuda_partition.run_metadata(keys, k), dev)
    meta = cuda_partition.run_metadata(keys, k)
    t_part = best_ms(lambda: cuda_partition.partition(keys, k, meta), dev)
    total = t_part + t_meta + t_buckets
    return {"n_keys": n, "buckets": nb, "block": cuda_partition.BLOCK,
            "global_sort_ms": t_global, "bucket_sorts_ms": t_buckets,
            "partition_kernel_ms": t_part, "run_metadata_ms": t_meta,
            "radix_total_ms": total, "speedup_vs_global_sort": t_global / total,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "nvidia_smi": (card_name_and_power_limit() if dev.type == "cuda"
                           else None)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=26_000_000)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n // cuda_partition.BLOCK * cuda_partition.BLOCK
    keys = random_keys(n, args.k, args.seed, dev)
    out = {**measure(keys, args.k), "k": args.k, "seed": args.seed}
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
