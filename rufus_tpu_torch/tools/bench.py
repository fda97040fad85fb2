"""Benchmark: k-mer count + mutant-read filter throughput on one card.

    python -m rufus_tpu_torch.tools.bench [--device cuda] [--batch 65536]
        [--iters 12] [--out PATH]

The port of the JAX package's root ``bench.py``, which stays as the
reference. The same shapes and reads: B 65,536 reads of L 152 bases, k 25,
sampled from a random 4 Mbp genome (1% N bases, 2% low-quality bases), 12
batches, 8 reads a batch carrying a mutant haplotype whose 512 k-mers are
the planted HashList, all from ``numpy.random.default_rng(0)`` in the JAX
tool's order (``make_reads`` is its function). It prints the JAX tool's one
JSON line, with the same field names: ``metric``, ``value`` (fused reads/s,
1 / (1/count + 1/filter)), ``unit``, ``vs_baseline`` (against the reference
toolchain's 16,600 fused reads/s on a CPU host, measured by the JAX
package's authors) and ``detail``. Each stage is measured on the port's
own path:

* count: ``encode_canon`` of each batch into a ``DeviceKmerTable``, which
  folds its pending keys (``torch.sort`` + ``compact_runs``, then
  ``merge_runs`` into the table) as the pipeline's count does; reads
  already on the card;
* filter: ``window_hits`` of each batch against the HashList (with its
  ``hashlist_index``, built once), one copy of the hit counts to the host;
  the kernel is exact, so there is no host verify;
* the ``*_with_h2d_*`` rows: the same, fed from pinned host batches by
  packed transport (``ops/pack.py``: host ``pack_*`` on a feeder thread, the
  planes copied on a side stream one batch ahead, then the ``unpack``
  kernel); the count's table must equal the first one;
* ``h2d_transport``: the pinned copies alone, of the packed planes and of
  the ASCII reads and quals, as MB/s.

Times are the best of 3 epochs (host clock around a synchronised epoch,
after a warm-up epoch). The ``roofline`` block is in the port's terms:
``torch.sort`` of the JAX tool's flush-size int64 buffer (B x (L-k+1) x
iters keys), ``merge_runs`` of the table with one batch's unique run (as
each fold merges), ``compact_runs`` of the sorted flush buffer, each
beside its bytes over 3.35 TB/s (the H100 SXM data sheet's HBM rate), and
the bytes a batch moves. The JAX tool's notes on comparator sorts are a
TPU's and are not carried over.

It runs on the card unless ``--device cpu`` is given (then every time is
the host's and ``device`` says "cpu"), and raises when no card is there.
The line is also written to --out (by default ``build/bench.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..ops import (_build, codec, cuda_count, cuda_filter, cuda_fold,
                   cuda_merge, pack)
from ..ops.table import DeviceKmerTable, count_step
from ..pipeline.driver import RufusPipeline, resolve_device
from .radixbench import best_ms, card_name_and_power_limit

DEFAULT_OUT = os.path.join(os.path.dirname(_build.BUILD_ROOT), "bench.json")
BASELINE_FUSED_READS_S = 16_600.0
B, L, K = 65536, 152, 25
GENOME = 4_000_000
ITERS = 12
HASHLIST = 512  # planted mutant k-mers
MIN_Q = 15
REPS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def make_reads(rng, genome, n, with_noise=True):
    """Coverage-style reads: sampled from a genome, 1% N, quals mixed (the
    JAX tool's function, its rng calls in its order)."""
    starts = rng.integers(0, len(genome) - L, size=n)
    idx = starts[:, None] + np.arange(L)[None, :]
    reads = genome[idx]
    if with_noise:
        nmask = rng.random((n, L)) < 0.01
        reads = np.where(nmask, ord("N"), reads).astype(np.uint8)
    quals = np.full((n, L), ord("I"), np.uint8)
    lowq = rng.random((n, L)) < 0.02
    quals = np.where(lowq, ord("#"), quals).astype(np.uint8)
    return reads, quals


def make_inputs(batch: int, iters: int):
    """The JAX tool's batches and planted HashList (uint64 keys, sorted),
    from default_rng(0)."""
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.choice(bases, size=GENOME)
    batches = [make_reads(rng, genome, batch) for _ in range(iters)]
    mutant = rng.choice(bases, size=HASHLIST + K - 1)
    hl_keys = np.sort(np.unique(np.asarray(
        [codec.str_to_kmer(codec.canonical_str(
            mutant[i : i + K].tobytes().decode())) for i in range(HASHLIST)],
        dtype=np.uint64)))
    m_reads = np.tile(mutant[:L], (8, 1)).astype(np.uint8)
    for r, q in batches:
        r[:8] = m_reads
    return batches, hl_keys


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_s(fn, dev: torch.device, reps: int = REPS):
    """(best seconds of `reps` synchronised calls after a warm-up, the last
    call's result)."""
    out = fn()
    sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def run(dev: torch.device, batch: int = B, iters: int = ITERS) -> dict:
    kernels = {"encode_canon": cuda_count.encode_canon,
               "compact_runs": cuda_fold.compact_runs,
               "merge_runs": cuda_merge.merge_runs,
               "window_hits": cuda_filter.window_hits, "unpack": pack.unpack}
    for fn in kernels.values():
        fn.launches = 0
    batches, hl_keys = make_inputs(batch, iters)
    cuda = dev.type == "cuda"
    host = [(torch.from_numpy(r), torch.from_numpy(q)) for r, q in batches]
    if cuda:
        host = [(r.pin_memory(), q.pin_memory()) for r, q in host]
    dev_batches = [(r.to(dev), q.to(dev)) for r, q in host]
    lens = torch.full((batch,), L, dtype=torch.int32, device=dev)
    hl = torch.from_numpy(codec.keys_u64_to_i64(hl_keys)).to(dev)
    index = cuda_filter.hashlist_index(hl, K)

    def packed(with_quals: bool):
        gen = (pack.pack_batch(r, q, MIN_Q if with_quals else None, pin=cuda)
               for r, q in batches)
        return pack.packed_feed(RufusPipeline._prefetch(gen, depth=2), dev)

    def count_epoch(reads):
        table = DeviceKmerTable(K, dev)
        for r in reads:
            table.fold_batch(count_step(r, K))
        table.flush()
        return table

    def filter_epoch(pairs):
        hs = [cuda_filter.window_hits(r, q, lens, hl, K, MIN_Q, index)
              for r, q in pairs]
        return int((torch.cat(hs).cpu() >= 1).sum())

    count_dt, table = best_s(
        lambda: count_epoch(r for r, _ in dev_batches), dev)
    count_h2d_dt, table_h2d = best_s(
        lambda: count_epoch(r for r, _ in packed(False)), dev)
    if not (torch.equal(table.keys, table_h2d.keys)
            and torch.equal(table.counts, table_h2d.counts)):
        raise AssertionError("the packed feed's count differs from the "
                             "count of the reads on the device")
    filter_dt, kept = best_s(lambda: filter_epoch(dev_batches), dev)
    if kept < 8 * iters:
        raise AssertionError(f"planted mutant reads not kept ({kept})")
    filter_h2d_dt, kept_h2d = best_s(lambda: filter_epoch(packed(True)), dev)
    if kept_h2d != kept:
        raise AssertionError(f"the packed feed kept {kept_h2d} reads, the "
                             f"reads on the device {kept}")

    # the pinned copies alone: one ASCII batch, then every batch's packed
    # planes and every batch's reads and quals
    planes = [pack.pack_batch(r, q, MIN_Q, pin=cuda)[1] for r, q in batches]
    h2d_dt, _ = best_s(lambda: host[0][0].to(dev, non_blocking=True), dev)
    up_dt, _ = best_s(lambda: [t.to(dev, non_blocking=True)
                               for p in planes for t in p], dev)
    ascii_dt, _ = best_s(lambda: [t.to(dev, non_blocking=True)
                                  for p in host for t in p], dev)
    count_bytes = sum(p[0].numel() + p[1].numel() for p in planes)
    filter_bytes = sum(t.numel() for p in planes for t in p)
    ascii_bytes = 2 * batch * L * iters
    transport_mbps = filter_bytes / up_dt / 1e6
    reads_total = batch * iters
    fused_bytes_per_read = (count_bytes + filter_bytes) / reads_total

    # roofline: the fold's sorts and compaction at the flush size
    raw = torch.cat([count_step(r, K) for r, _ in dev_batches])
    pend = raw.numel()
    sort_ms = best_ms(lambda: torch.sort(raw), dev)
    s = torch.sort(raw).values
    del raw
    compact_ms = best_ms(lambda: cuda_fold.compact_runs(s), dev)
    n_unique = table.n_keys
    del s
    first = cuda_fold.compact_runs(torch.sort(
        count_step(dev_batches[0][0], K)).values)
    runs = (table.keys, table.counts, *first)
    union = []
    merge_ms = best_ms(lambda: union.append(
        cuda_merge.merge_runs(*runs)[0].numel()), dev)
    merge_keys = table.n_keys + first[0].numel()
    merge_bytes = 16 * (merge_keys + union[0])
    del runs, first

    count_rps = reads_total / count_dt
    filter_rps = reads_total / filter_dt
    count_h2d_rps = reads_total / count_h2d_dt
    filter_h2d_rps = reads_total / filter_h2d_dt
    fused = 1.0 / (1.0 / count_rps + 1.0 / filter_rps)
    n_keys = batch * (L - K + 1)
    bound = lambda nbytes: nbytes / HBM_BYTES_PER_S * 1e3  # noqa: E731
    return {
        "metric": "kmer count+filter throughput (k=25, 150bp reads)",
        "value": fused,
        "unit": "reads/s/chip",
        "vs_baseline": fused / BASELINE_FUSED_READS_S,
        "detail": {
            "count_reads_per_s": count_rps,
            "filter_reads_per_s": filter_rps,
            "count_ms_per_batch": count_dt / iters * 1e3,
            "filter_ms_per_batch": filter_dt / iters * 1e3,
            "includes": "device fold into the resident table (sort + "
                        "compact_runs of the pending keys, merge_runs "
                        "into the table); "
                        "window_hits is exact (no host verify); coverage "
                        "reads with Ns",
            "h2d_ms_per_batch": h2d_dt * 1e3,
            "fused_with_h2d_reads_per_s": 1.0 / (1.0 / count_h2d_rps
                                                 + 1.0 / filter_h2d_rps),
            "count_with_h2d_reads_per_s": count_h2d_rps,
            "filter_with_h2d_reads_per_s": filter_h2d_rps,
            "h2d_transport": {
                "measured_fresh_content_MBps": transport_mbps,
                "ascii_MBps": ascii_bytes / ascii_dt / 1e6,
                "packed_bytes_per_read_fused": fused_bytes_per_read,
                "ascii_bytes_per_read_fused": 3 * L,
                "transport_bound_fused_ceiling_reads_per_s": 1.0 / (
                    fused_bytes_per_read / (transport_mbps * 1e6)
                    + 1.0 / fused),
                "note": "pinned host memory to the card: the packed "
                        "planes (2-bit codes, N mask and min_q plane) of "
                        "every batch, and the ASCII reads and quals, each "
                        "copied alone; the *_with_h2d_* rows feed the "
                        "stages from host batches packed on a thread and "
                        "copied a batch ahead on a side stream",
            },
            "table_unique_kmers": n_unique,
            "kept_reads": kept,
            "launches": {name: fn.launches for name, fn in kernels.items()},
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "nvidia_smi": card_name_and_power_limit() if cuda else None,
            "shape": {"batch": batch, "read_len": L, "k": K,
                      "iters": iters, "genome_bp": GENOME,
                      "hashlist": len(hl_keys)},
            "roofline": {
                "read_stream_bytes_per_batch": 2 * batch * L,
                "packed_bytes_per_batch": filter_bytes / iters,
                "sort_keys_per_batch": n_keys,
                "flush_keys": pend,
                "measured_sort_ms_at_flush_size": sort_ms,
                "sort_bound_ms": bound(16 * pend),
                "measured_merge_runs_ms": merge_ms,
                "merge_keys": merge_keys,
                "merge_runs_bound_ms": bound(merge_bytes),
                "measured_compact_runs_ms": compact_ms,
                "compact_runs_bound_ms": bound(8 * pend + 16 * n_unique),
                "measured_sort_eff_gbps_vs_hbm_3350": 16 * pend / sort_ms
                / 1e6,
                "note": "bounds are each input read once and each output "
                        "written once (8-byte keys; a sort reads and "
                        "writes its keys) over 3.35 TB/s",
            },
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.batch < 8:
        raise ValueError("--batch must hold the 8 planted reads")
    out = run(resolve_device(args.device), args.batch, args.iters)
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
