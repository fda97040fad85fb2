"""The port's device table and subtract against the JAX package's
single-device ShardedKmerTable chain, and the convert.py round trip.
Integer outputs: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rufus_tpu.ops import count as jcount
from rufus_tpu.parallel import (ShardedKmerTable, make_mesh,
                                sharded_count_step, sharded_subtract_step)
from merge_cases import CASES, ITEMS, TILE, runs, union_sum
from rufus_tpu_torch import convert
from rufus_tpu_torch.ops import codec, count, cuda_merge, table
from rufus_tpu_torch.ops.cuda_count import encode_canon

BASES = np.frombuffer(b"ACGT", np.uint8)


def _reads(rng, B, L, genome, err=0.01):
    starts = rng.integers(0, len(genome) - L, B)
    r = genome[starts[:, None] + np.arange(L)[None, :]]
    e = rng.random((B, L)) < err
    r = np.where(e, rng.choice(BASES, (B, L)), r)
    r[rng.random((B, L)) < 0.005] = ord("N")
    return r.astype(np.uint8)


def _jax_table(batches, k, lower, counted=None):
    mesh = make_mesh(1)
    t = ShardedKmerTable(mesh, k, 4096)
    if counted is None:
        bcap = batches[0].shape[0] * (batches[0].shape[1] - k + 1)
        step = sharded_count_step(mesh, k, bcap)
        for b in batches:
            bk, bc, _, _ = step(jnp.asarray(b))
            t.fold_batch(bk, bc)
    else:
        for bk, bc in counted:
            t.fold_batch(jnp.asarray(bk)[None], jnp.asarray(bc)[None])
    if lower > 1:
        t.apply_lower_count(lower)
    return t


def _port_table(batches, k, lower, counted=None, budget=3000):
    t = table.DeviceKmerTable(k, "cpu", pending_budget=budget)
    if counted is None:
        for b in batches:
            t.fold_batch(table.count_step(torch.from_numpy(b), k))
    else:
        for bk, bc in counted:
            t.fold_batch(torch.from_numpy(codec.keys_u64_to_i64(bk)),
                         torch.from_numpy(bc))
    t.apply_lower_count(lower)
    return t


@pytest.mark.parametrize("k,lower,reads", [
    (13, 0, (64,) * 5), (25, 2, (64,) * 5), (31, 2, (64,) * 5),
    (25, 2, (6,) * 53), (13, 0, (6,) * 53), (25, 2, (64, 64, 6, 64, 6))],
    ids=["13-0", "25-2", "31-2", "25-2-buffered", "13-0-buffered",
         "25-2-short"])
def test_fold_raw_batches_matches_sharded_table(k, lower, reads):
    """Batches of 64 reads pass a quarter of the table, so each folds as it
    comes; batches of 6 reads buffer until their keys reach a quarter of
    the table; a short batch between full ones (a file's last) folds
    alone before the next full one."""
    rng = np.random.default_rng(k)
    genome = rng.choice(BASES, 3000)
    batches = [_reads(rng, b, 60, genome) for b in reads]
    port = _port_table(batches, k, lower)
    per_batch = max(reads) * (60 - k + 1)
    if max(reads) == 64:
        assert port.folds == len(batches)
        assert port.fold_keys_max == per_batch
    else:
        assert 1 < port.folds < len(batches) // 2
        assert port.fold_keys_max > per_batch
    want = _jax_table(batches, k, lower).to_host()
    keys, counts = convert.table_to_numpy(port)
    np.testing.assert_array_equal(keys, want.keys)
    np.testing.assert_array_equal(counts, want.counts)


def test_fold_counted_batches_matches_sharded_table():
    rng = np.random.default_rng(2)
    k = 21
    pool = np.unique(rng.integers(0, 1 << 42, 3000).astype(np.uint64))
    counted = []
    for _ in range(4):
        bk = rng.choice(pool, 1500)
        counted.append((bk, rng.integers(1, 20, 1500).astype(np.int64)))
    port = _port_table(None, k, 2, counted=counted, budget=2000)
    want = _jax_table(None, k, 2, counted=counted).to_host()
    host = port.to_host()
    np.testing.assert_array_equal(host.keys, want.keys)
    np.testing.assert_array_equal(host.counts, want.counts)


def _kernel_model(a, ca, b, cb):
    """csrc/merge.cu's index arithmetic in Python: the tile boundaries and
    each thread's positions by merge-path co-rank, moved past a shared
    key's second copy, and each thread's merge of its positions."""
    a, ca, b, cb = (x.tolist() for x in (a, ca, b, cb))
    threads = TILE // ITEMS

    def corank(ka, kb, d):
        lo, hi = max(0, d - len(kb)), min(d, len(ka))
        while lo < hi:
            mid = (lo + hi) // 2
            if ka[mid] <= kb[d - mid - 1]:
                lo = mid + 1
            else:
                hi = mid
        j = d - lo
        if lo > 0 and j < len(kb) and ka[lo - 1] == kb[j]:
            j += 1
        return lo, j

    n = len(a) + len(b)
    nt = -(-n // TILE)
    cuts = [corank(a, b, min(t * TILE, n)) for t in range(nt + 1)]
    out_k, out_c = [], []
    for t in range(nt):
        (a0, b0), (a1, b1) = cuts[t], cuts[t + 1]
        sa, sca, sb, scb = a[a0:a1], ca[a0:a1], b[b0:b1], cb[b0:b1]
        size = len(sa) + len(sb)
        assert size <= TILE + 1 and (t == nt - 1 or size >= TILE - 1)
        for r in range(threads):
            d0 = min(r * ITEMS, size)
            d1 = size if r == threads - 1 else min(d0 + ITEMS, size)
            (i, j), (i1, j1) = corank(sa, sb, d0), corank(sa, sb, d1)
            emitted = 0
            while i < i1 or j < j1:
                x = sa[i] if i < i1 else codec.SENTINEL
                y = sb[j] if j < j1 else codec.SENTINEL
                out_k.append(min(x, y))
                out_c.append((sca[i] if x <= y else 0)
                             + (scb[j] if y <= x else 0))
                i, j = i + (x <= y), j + (y <= x)
                emitted += 1
            assert emitted <= ITEMS + 1
    return np.array(out_k, np.int64), np.array(out_c, np.int64)


@pytest.mark.parametrize("case", CASES)
def test_merge_runs_plain_and_kernel_model_match_union(case):
    """merge_runs on CPU tensors (merge_runs_torch) and the model of the
    CUDA kernels' tiling against numpy's union and sum: disjoint,
    interleaved, identical and empty runs, runs whose shared keys straddle
    every thread's and tile's cut at 4095, 4096, 4097 and more than three
    tiles of positions, and counts near 2**31, whose sums stay int64."""
    a, ca, b, cb = runs(case)
    want_k, want_c = union_sum(a, ca, b, cb)
    got_k, got_c = cuda_merge.merge_runs(*map(torch.from_numpy,
                                              (a, ca, b, cb)))
    assert got_k.dtype == got_c.dtype == torch.int64
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    model_k, model_c = _kernel_model(a, ca, b, cb)
    np.testing.assert_array_equal(model_k, want_k)
    np.testing.assert_array_equal(model_c, want_c)
    if case.startswith("straddle_"):
        assert len(want_k) < len(a) + len(b)
    if case == "counts_near_2_31":
        assert want_c.max() > 1 << 31


def _trio(rng, k):
    genome = rng.choice(BASES, 2000)
    child = genome.copy()
    child[[400, 1200]] = [(ord("A") if c != ord("A") else ord("C"))
                          for c in genome[[400, 1200]]]
    samples = []
    for g in (child, genome, genome):
        reads = _reads(rng, 400, 70, g, err=0.002)
        samples.append(_port_table([reads], k, 2))
    return samples


def test_subtract_matches_sharded_subtract_and_host():
    rng = np.random.default_rng(4)
    k = 25
    devs = _trio(rng, k)
    mut, subj = table.subtract_step(devs[0], devs[1:], 5, 4, 10000)
    mut_u = codec.keys_i64_to_u64(mut.numpy())
    assert len(mut_u) > 0

    # the JAX package's device subtract at one device, on the same tables
    mesh = make_mesh(1)
    hosts = [d.to_host() for d in devs]
    sub = sharded_subtract_step(mesh, 3)
    jk, jc = sub([jnp.asarray(h.keys)[None] for h in hosts],
                 [jnp.asarray(h.counts)[None] for h in hosts],
                 jnp.int64(5), jnp.int64(4), jnp.int64(10000))
    jk, jc = np.asarray(jk).ravel(), np.asarray(jc).ravel()
    m = jk != jcount.SENTINEL
    order = np.argsort(jk[m])
    np.testing.assert_array_equal(mut_u, jk[m][order])
    np.testing.assert_array_equal(subj.numpy(), jc[m][order])

    # and the host reference: subtract_unique + subject count range
    jtabs = [jcount.KmerTable(k, h.keys, h.counts) for h in hosts]
    ref = jcount.subtract_unique(jtabs, merge_min=5)
    sc = jtabs[0].query(ref)
    np.testing.assert_array_equal(mut_u, ref[(sc >= 4) & (sc <= 10000)])
    ref_port = count.subtract_unique(hosts, merge_min=5)
    np.testing.assert_array_equal(ref_port, ref)


def test_convert_round_trip():
    rng = np.random.default_rng(6)
    k = 25
    keys = np.unique(rng.integers(0, 1 << 50, 500).astype(np.uint64))
    counts = rng.integers(1, 99, len(keys)).astype(np.int64)
    t = convert.table_from_numpy(keys, counts, "cpu", k=k)
    assert t.keys.dtype == torch.int64 and t.keys.device.type == "cpu"
    back_k, back_c = convert.table_to_numpy(t)
    assert back_k.dtype == np.uint64
    np.testing.assert_array_equal(back_k, keys)
    np.testing.assert_array_equal(back_c, counts)
    hl = convert.hashlist_keys_to_int64(keys, "cpu")
    np.testing.assert_array_equal(convert.hashlist_keys_from_int64(hl), keys)
    # sentinels swap layouts; keys of k > 31 are refused
    both = np.array([5, 0xFFFFFFFFFFFFFFFF], np.uint64)
    i64 = codec.keys_u64_to_i64(both)
    assert i64[1] == codec.SENTINEL
    np.testing.assert_array_equal(codec.keys_i64_to_u64(i64), both)
    with pytest.raises(ValueError):
        codec.keys_u64_to_i64(np.array([1 << 63], np.uint64))


def test_host_table_helpers_match_reference(tmp_path):
    rng = np.random.default_rng(8)
    k = 21
    genome = rng.choice(BASES, 1500)
    reads = _reads(rng, 96, 64, genome)
    keys, counts = count.count_batch(encode_canon(torch.from_numpy(reads), k))
    mine = count.KmerTable.from_rle_chunks(
        k, [(codec.keys_i64_to_u64(keys.numpy()), counts.numpy())],
        lower_count=2)
    jk, jc, _ = jcount.count_reads_batch(jnp.asarray(reads), k)
    want = jcount.KmerTable.from_rle_chunks(
        k, [(np.asarray(jk), np.asarray(jc), 0)], lower_count=2)
    np.testing.assert_array_equal(mine.keys, want.keys)
    np.testing.assert_array_equal(mine.counts, want.counts)
    np.testing.assert_array_equal(mine.histo(), want.histo())
    probe = np.concatenate([want.keys[::7], np.array([1, 2, 3], np.uint64)])
    np.testing.assert_array_equal(mine.query(probe), want.query(probe))
    mine.dump_text(str(tmp_path / "p.txt"))
    want.dump_text(str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    mine.save(str(tmp_path / "t.npz"))
    back = jcount.KmerTable.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(back.keys, want.keys)
    np.testing.assert_array_equal(back.counts, want.counts)
    dev = convert.table_from_numpy(mine.keys, mine.counts, "cpu", k=k)
    dev.release()
    assert dev.keys is None and dev.counts is None
