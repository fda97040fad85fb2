"""The sharded chain on a process mesh, held to the one-shard host build.

    python -m rufus_tpu_torch.tools.multiproc_smoke [--local-shards 2]
        [--device cuda|cpu]

The port of the JAX package's ``tools/multiproc_smoke.py``, which stays as
the reference. It spawns its ranks (the ``spawn`` start method), each of
which joins a ``torch.distributed`` group through a file store and takes
its mesh from ``parallel.make_process_mesh``: on "cuda" (the default) one
NCCL rank a visible card, on "cpu" SMOKE_PROCS gloo ranks (default 4),
each holding --local-shards shards. Every rank counts a planted trio
(k 13, 16 reads of 48 bases a shard, in four batches) into
range-partitioned tables, then subtracts, filters and pulls; each must
equal the one-shard host build (the tables, the HashList with the planted
k-mers in it, the kept reads, the pulls of present and absent k-mers).
Exit code 0 and "MULTIPROC SMOKE PASS" on success. A missing card, or a
group that does not start, raises: nothing falls back to gloo or the CPU.

``spawn_ranks`` and ``run_chain`` are the library the tests and
``chip_smoke.py`` drive a process mesh with.
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing
import os
import shutil
import tempfile

import numpy as np
import torch

from ..ops import codec, count
from ..ops.filter import filter_single
from ..parallel import (ShardedKmerTable, local_count_step, local_rows,
                        make_process_mesh, replicate_hashlist,
                        sharded_filter_step, sharded_query_multi,
                        sharded_subtract_step)

TIMEOUT_S = 300  # the group's collectives and each rank's join, at most


def _rank_main(rank, world, device, local, init_file, timeout, fn, args,
               out_dir):
    """One rank: join the group, take its mesh, run fn(mesh, *args) and
    save what it returns (a dict of arrays) as rank<r>.npz."""
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(
        "nccl" if torch.device(device).type == "cuda" else "gloo",
        init_method=f"file://{init_file}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = make_process_mesh(local, device)
        out = fn(mesh, *args)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **(out or {}))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, device: str, local: int, args=(),
                timeout: int = TIMEOUT_S) -> list:
    """Runs fn(mesh, *args) on `world` spawned ranks of a process mesh of
    `local` shards a rank on `device` ("cuda": NCCL, a card a rank;
    "cpu": gloo), the group joined through a file store in a fresh
    temporary directory. Returns each rank's dict of arrays, in rank
    order. Raises if a rank fails, or is still running `timeout` seconds
    after the start (it is then killed)."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rufus_mp_")
    try:
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, device, local, os.path.join(tmp, "store"), timeout, fn,
            tuple(args), tmp)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout)
        for p in procs:
            p.join(max(0.0, (deadline - datetime.datetime.now())
                       .total_seconds()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        if hung or codes != [0] * world:
            raise RuntimeError(f"ranks {hung} still running after {timeout} "
                               f"s; exit codes {codes}")
        out = []
        for r in range(world):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                out.append({k: z[k] for k in z.files})
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _batches(reads, b):
    return [reads[i:i + b] for i in range(0, len(reads), b)]


def run_chain(mesh, samples: dict, k: int, batch: int, queries: np.ndarray,
              lower: int, merge_min: int, min_cov: int, max_depth: int,
              min_q: int, threshold: int):
    """The trio chain on `mesh`, each rank's part: `samples` is {"child":
    (reads, quals, lens), "mother": reads, "father": reads} (host arrays,
    the whole batch stream; each rank takes its rows of each batch). Counts
    each sample (floor `lower`; the tables share the child's splitters),
    subtracts, filters the child's reads and pulls `queries` (each rank
    its rows of them). Returns host arrays: each table (table{i}_keys and
    _counts, whole on every rank), every shard's key count (shard_keys),
    the splitters, the HashList (hl_keys, hl_counts), the keep mask of
    this rank's rows of each batch (keep) and the pulls of its queries
    (pulls, tables x queries)."""
    child = samples["child"]
    out = {}
    splitters, tables = None, []
    for reads in (child[0], samples["mother"], samples["father"]):
        t = ShardedKmerTable(mesh, k, splitters=splitters)
        for b in _batches(reads, batch):
            t.fold_batch(local_count_step(
                mesh, local_rows(mesh, torch.from_numpy(b)), k))
        t.flush()
        splitters = t.splitters
        t.apply_lower_count(lower)
        tables.append(t)
    for i, t in enumerate(tables):
        host = t.to_host()
        out[f"table{i}_keys"] = host.keys
        out[f"table{i}_counts"] = host.counts
    out["shard_keys"] = np.array([t.shard_keys() for t in tables], np.int64)
    out["splitters"] = tables[0].splitters
    hk, hc = sharded_subtract_step(tables[0], tables[1:], merge_min,
                                   min_cov, max_depth)
    out["hl_keys"] = codec.keys_i64_to_u64(hk.cpu().numpy())
    out["hl_counts"] = hc.cpu().numpy()
    hl = replicate_hashlist(mesh, hk, k)
    keep = [sharded_filter_step(
        mesh, [[local_rows(mesh, torch.from_numpy(a[i:i + batch]))
                for a in child]], hl, k, min_q, threshold)
        for i in range(0, len(child[0]), batch)]
    out["keep"] = torch.cat(keep).numpy()
    out["pulls"] = sharded_query_multi(tables, local_rows(mesh, queries))
    for t in tables:
        t.release()
    return out


def planted_trio(n_shards: int, k: int = 13, L: int = 48):
    """The JAX tool's planted trio, 16 reads a shard: the parents' reads
    (each a half of random rows repeated 8 times), the child's (half of
    each parent's) ending in 8 copies of a planted read; and the planted
    read's canonical k-mers."""
    B = 16 * n_shards
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(bases, size=(B, L))
    mother = np.repeat(base[: B // 2], 8, axis=0)[:B]
    father = np.repeat(base[B // 2:], 8, axis=0)[:B]
    child = np.concatenate([mother[: B // 2], father[: B // 2]])
    mutant = rng.choice(bases, size=(L,))
    child = np.concatenate([child[:-8], np.tile(mutant, (8, 1))])
    s = mutant.tobytes().decode()
    planted = np.array(sorted({codec.str_to_kmer(codec.canonical_str(
        s[i:i + k])) for i in range(L - k + 1)}), np.uint64)
    return child, mother, father, planted


def smoke_rank(mesh, k: int = 13) -> dict:
    """One rank of the smoke: the chain on the planted trio, held to the
    one-shard host build; returns this rank's counts of what it checked."""
    from ..ops.table import DeviceKmerTable, count_step

    child, mother, father, planted = planted_trio(mesh.n, k)
    B, L = child.shape
    quals = np.full((B, L), ord("I"), np.uint8)
    lens = np.full(B, L, np.int32)
    probe = np.random.default_rng(1).integers(0, 1 << (2 * k), 64,
                                              dtype=np.uint64)
    hosts = []
    for reads in (child, mother, father):
        t = DeviceKmerTable(k, "cpu")
        t.fold_batch(count_step(torch.from_numpy(reads), k))
        t.apply_lower_count(2)
        hosts.append(t.to_host())
    ref = count.subtract_unique(hosts, merge_min=5)
    sc = hosts[0].query(ref)
    ref = ref[(sc >= 5) & (sc <= 10000)]
    queries = np.concatenate([ref, np.sort(probe)])
    got = run_chain(mesh, {"child": (child, quals, lens), "mother": mother,
                           "father": father}, k, B // 4, queries, 2, 5, 5,
                    10000, 15, 1)
    table = torch.from_numpy(codec.keys_u64_to_i64(ref))
    want_keep = filter_single(torch.from_numpy(child), torch.from_numpy(quals),
                              torch.from_numpy(lens), table, k, 15, 1)[0]
    want_keep = np.concatenate([local_rows(mesh, want_keep[i:i + B // 4])
                                .numpy() for i in range(0, B, B // 4)])
    want_pulls = np.stack([h.query(local_rows(mesh, queries))
                           for h in hosts])
    for i, h in enumerate(hosts):
        if not (np.array_equal(got[f"table{i}_keys"], h.keys)
                and np.array_equal(got[f"table{i}_counts"], h.counts)):
            raise AssertionError(f"rank {mesh.rank}: table {i} differs from "
                                 "the host build")
    if not np.array_equal(got["hl_keys"], ref):
        raise AssertionError(f"rank {mesh.rank}: HashList differs from the "
                             "host build")
    if not set(planted.tolist()) <= set(ref.tolist()):
        raise AssertionError("the planted k-mers are not in the HashList")
    if not np.array_equal(got["keep"], want_keep.astype(bool)):
        raise AssertionError(f"rank {mesh.rank}: keep mask differs")
    if not np.array_equal(got["pulls"], want_pulls):
        raise AssertionError(f"rank {mesh.rank}: pulls differ")
    print(f"rank {mesh.rank}: parity ok on {mesh.local} shards of "
          f"{mesh.devices[0]}, {len(ref)} mutant k-mers, "
          f"{len(local_rows(mesh, queries))} routed queries", flush=True)
    return {"mutant": np.array([len(ref)])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--local-shards", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but no CUDA "
                               "device is available")
        world = torch.cuda.device_count()
    else:
        world = int(os.environ.get("SMOKE_PROCS", "4"))
    spawn_ranks(smoke_rank, world, args.device, args.local_shards)
    print("MULTIPROC SMOKE PASS", flush=True)


if __name__ == "__main__":
    main()
