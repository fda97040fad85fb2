"""The port's radix partition (ops/cuda_partition.py) and its tool
(rufus_tpu_torch.tools.radixbench) against the JAX package's radixbench.

On the CPU the wrapper runs its plain version, which is compared here,
exactly (every output is an integer):
- its per-block sort with pallas_fold._block_bitonic_sort, the sort inside
  the Pallas kernel tools/radixbench.py:partition, in interpret mode;
- its run metadata with radixbench.py's one_hot/cumsum expressions
  (lines 90-94), in JAX, with the port's bucket rule;
- the whole partition with the exact partition built in numpy from those.
The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rufus_tpu.ops import pallas_fold
from rufus_tpu_torch.ops import codec, cuda_partition as cp
from rufus_tpu_torch.tools import radixbench

I64_MAX = np.int64(codec.SENTINEL)
BLOCK, NB = cp.BLOCK, cp.BUCKETS


def _keys(rng, n, k, one_bucket=False):
    """n int64 keys below 2**(2k) with duplicates and ~10% sentinels; with
    one_bucket, all in bucket 5 (no sentinels: they close bucket 15)."""
    if one_bucket:
        lo = 5 << (2 * k - 4)
        return rng.integers(lo, lo + (1 << (2 * k - 4)), n, dtype=np.int64)
    pool = rng.integers(0, 1 << (2 * k), max(1, n // 3), dtype=np.int64)
    keys = pool[rng.integers(0, len(pool), n)]
    keys[rng.random(n) < 0.1] = I64_MAX
    return keys


def _bitonic_block_sort(keys):
    """One 8192-key block through pallas_fold._block_bitonic_sort inside a
    pallas_call in interpret mode, as (64, 128) u32 hi/lo planes; a short
    block is padded with the sentinel, which sorts last."""
    u = np.full(BLOCK, I64_MAX, np.int64)
    u[: len(keys)] = keys
    u = u.view(np.uint64)
    h = (u >> np.uint64(32)).astype(np.uint32).reshape(BLOCK // 128, 128)
    l = u.astype(np.uint32).reshape(BLOCK // 128, 128)

    def kernel(h_ref, l_ref, oh_ref, ol_ref):
        hh, ll, _ = pallas_fold._block_bitonic_sort(
            h_ref[:], l_ref[:], jnp.zeros(h_ref.shape, jnp.int32))
        oh_ref[:] = hh
        ol_ref[:] = ll

    plane = jax.ShapeDtypeStruct(h.shape, jnp.uint32)
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 100000))
    try:
        oh, ol = pl.pallas_call(kernel, out_shape=(plane, plane),
                                interpret=True)(jnp.asarray(h), jnp.asarray(l))
    finally:
        sys.setrecursionlimit(limit)
    out = (np.asarray(oh).astype(np.uint64).reshape(-1) << np.uint64(32)) | \
        np.asarray(ol).astype(np.uint64).reshape(-1)
    return out.view(np.int64)[: len(keys)]


def _jax_run_metadata(keys, k):
    """radixbench.py:90-94 with the port's bucket rule (clamp(key >> (2k-4),
    0, 15) in place of h >> 28), plus the regions' cursors that its kernel
    advanced in SMEM: each bucket's region starts at the keys of the
    buckets before it, and each block's run follows the earlier blocks'."""
    nblocks = len(keys) // BLOCK
    bucket = jnp.clip(jnp.asarray(keys).reshape(nblocks, BLOCK)
                      >> (2 * k - 4), 0, NB - 1).astype(jnp.int32)
    oneh = jax.nn.one_hot(bucket, NB, dtype=jnp.int32)
    runlen = oneh.sum(axis=1)                        # (nblocks, NB)
    runstart = jnp.cumsum(runlen, axis=1) - runlen  # within sorted block
    region = jnp.cumsum(runlen.sum(axis=0)) - runlen.sum(axis=0)
    cursor = jnp.cumsum(runlen, axis=0) - runlen + region[None, :]
    return (np.asarray(runlen), np.asarray(runstart), np.asarray(cursor),
            np.asarray(region))


def _numpy_partition(keys, k):
    """The exact partition: sort each block (np.sort, which (a) holds to the
    bitonic network), then concatenate bucket by bucket the blocks' runs."""
    blocks = [np.sort(keys[i:i + BLOCK]) for i in range(0, len(keys), BLOCK)]
    bucket = [np.clip(b >> (2 * k - 4), 0, NB - 1) for b in blocks]
    out = [b[bb == j] for j in range(NB) for b, bb in zip(blocks, bucket)]
    sizes = [sum(int((bb == j).sum()) for bb in bucket) for j in range(NB)]
    return (np.concatenate(out) if out else np.empty(0, np.int64),
            np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64))


# (a) the per-block sort against the Pallas block sort


@pytest.mark.parametrize("n", [BLOCK, BLOCK - 1000])
def test_block_sort_matches_pallas_bitonic(n):
    rng = np.random.default_rng(n)
    keys = _keys(rng, n, 25)
    keys[:50] = keys[50]  # a long run of one key
    got = cp.block_sort_torch(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, _bitonic_block_sort(keys))
    np.testing.assert_array_equal(got, np.sort(keys))


# (b) the run metadata against radixbench.py's expressions


@pytest.mark.parametrize("n,k,one_bucket", [(BLOCK, 25, False),
                                            (3 * BLOCK, 25, False),
                                            (2 * BLOCK, 31, False),
                                            (2 * BLOCK, 25, True)])
def test_run_metadata_matches_radixbench(n, k, one_bucket):
    keys = _keys(np.random.default_rng(n + k), n, k, one_bucket)
    runlen, cursors, offsets = cp.run_metadata(torch.from_numpy(keys), k)
    want_len, want_start, want_cur, want_region = _jax_run_metadata(keys, k)
    np.testing.assert_array_equal(runlen.numpy(), want_len)
    np.testing.assert_array_equal(cursors.numpy(), want_cur)
    np.testing.assert_array_equal(offsets.numpy()[:-1], want_region)
    assert int(offsets[-1]) == n
    # each run starts where radixbench's runstart puts it in the sorted block
    s = cp.block_sort_torch(torch.from_numpy(keys)).numpy().reshape(-1, BLOCK)
    b = np.clip(s >> (2 * k - 4), 0, NB - 1)
    for j in range(len(s)):
        for bk in np.unique(b[j]):
            assert np.argmax(b[j] == bk) == want_start[j, bk]


# (c) the whole partition against the numpy partition


@pytest.mark.parametrize("n,k,one_bucket", [(0, 25, False), (1, 25, False),
                                            (BLOCK, 25, False),
                                            (3 * BLOCK + 5, 25, False),
                                            (3 * BLOCK + 5, 31, False),
                                            (2 * BLOCK + 7, 25, True)])
def test_partition_matches_numpy(n, k, one_bucket):
    keys = _keys(np.random.default_rng(n + 7), n, k, one_bucket)
    out, offsets = cp.partition_torch(torch.from_numpy(keys), k)
    want, want_off = _numpy_partition(keys, k)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    if one_bucket and n:
        assert int(offsets[5]) == 0 and int(offsets[6]) == n


# (d) the wrapper


def test_partition_routes_cpu_tensors_to_plain_version():
    keys = torch.from_numpy(_keys(np.random.default_rng(3), 3 * BLOCK + 5, 25))
    before = cp.partition.launches
    for a, b in zip(cp.partition(keys, 25), cp.partition_torch(keys, 25)):
        assert torch.equal(a, b)
    assert cp.partition.launches == before


def test_partition_rejects_bad_input():
    with pytest.raises(TypeError):
        cp.partition(torch.zeros(8, dtype=torch.int32), 25)
    with pytest.raises(TypeError):
        cp.partition(torch.zeros((2, 8), dtype=torch.int64), 25)
    with pytest.raises(ValueError):
        cp.partition(torch.zeros(8, dtype=torch.int64, device="meta"), 25)
    for k in (1, 32):
        with pytest.raises(ValueError):
            cp.partition(torch.zeros(8, dtype=torch.int64), k)


def test_run_metadata_routes_cpu_tensors_and_rejects_bad_input():
    keys = torch.from_numpy(_keys(np.random.default_rng(4), 2 * BLOCK + 3, 25))
    before = cp.run_metadata.launches
    for a, b in zip(cp.run_metadata(keys, 25),
                    cp.run_metadata_torch(keys, 25)):
        assert torch.equal(a, b)
    assert cp.run_metadata.launches == before
    with pytest.raises(TypeError):
        cp.run_metadata(keys.to(torch.int32), 25)
    with pytest.raises(ValueError):
        cp.run_metadata(torch.zeros(8, dtype=torch.int64, device="meta"), 25)


# (e) models of the CUDA kernels' index arithmetic (csrc/partition.cu): the
# kernels run only on the card, tests/test_torch_gpu.py holds them to the
# plain version there


THREADS, ITEMS = 512, 16


def _thread_stage(x, S, size):
    """partition.cu's thread_stage<S> with base 0: x[:, j] and x[:, j + S]
    for j with bit S clear, ascending where (j & size) == 0."""
    for j in range(ITEMS):
        if j & S:
            continue
        up = (j & size) == 0
        lo, hi = x[:, j].copy(), x[:, j + S].copy()
        swap = (lo > hi) if up else (lo < hi)
        x[:, j] = np.where(swap, hi, lo)
        x[:, j + S] = np.where(swap, lo, hi)


def _kernel_block_sort(keys):
    """partition_kernel's sort of one block: each thread's 16 keys (x[t])
    through the bitonic network in registers, then 9 levels of merge path,
    thread t making positions 16t .. 16t+15 of its merged pair from the
    diagonal's split and a serial merge, exhausted runs read as INT64_MAX."""
    x = np.full(BLOCK, I64_MAX, np.int64)
    x[: len(keys)] = keys
    x = x.reshape(THREADS, ITEMS).copy()
    for size in (2, 4, 8, 16):
        for S in (8, 4, 2, 1):
            if S < size:
                _thread_stage(x, S, size)
    d0 = ITEMS * np.arange(THREADS)
    run = ITEMS
    while run < BLOCK:
        s = x.reshape(-1).copy()
        a0 = d0 & ~(2 * run - 1)
        b0 = a0 + run
        d = d0 - a0
        lo, hi = np.maximum(0, d - run), np.minimum(d, run)
        while (lo < hi).any():
            act = lo < hi
            mid = (lo + hi) >> 1
            le = s[a0 + np.where(act, mid, 0)] <= \
                s[b0 + np.where(act, d - 1 - mid, 0)]
            lo = np.where(act & le, mid + 1, lo)
            hi = np.where(act & ~le, mid, hi)
        ia, ib = a0 + lo, b0 + d - lo
        ae, be = b0, b0 + run

        def at(i, end):
            return np.where(i < end, s[np.minimum(i, BLOCK - 1)], I64_MAX)

        av, bv = at(ia, ae), at(ib, be)
        for u in range(ITEMS):
            ta = av <= bv
            x[:, u] = np.where(ta, av, bv)
            ia, ib = ia + ta, ib + ~ta
            v = np.where(ta, at(ia, ae), at(ib, be))
            av, bv = np.where(ta, v, av), np.where(ta, bv, v)
        run <<= 1
    return x.reshape(-1)[: len(keys)]


@pytest.mark.parametrize("n,fill", [(BLOCK, "mixed"), (BLOCK - 1000, "mixed"),
                                    (1, "mixed"), (BLOCK, "one_key"),
                                    (BLOCK, "descending")])
def test_kernel_sort_network_model(n, fill):
    rng = np.random.default_rng(n + len(fill))
    keys = _keys(rng, n, 25)
    if fill == "one_key":
        keys[:] = keys[0]
    elif fill == "descending":
        keys = np.sort(keys)[::-1].copy()
    got = _kernel_block_sort(keys)
    np.testing.assert_array_equal(got, np.sort(keys))
    if fill == "mixed" and n == BLOCK:
        np.testing.assert_array_equal(got, _bitonic_block_sort(keys))


def _kernel_run_metadata(keys, k, sms, groups_cap=1024):
    """count_kernel and cursor_kernel's grouping: runs of per_group blocks,
    an exclusive scan inside each run, the runs' totals scanned bucket by
    bucket."""
    n = len(keys)
    nblk = -(-n // BLOCK)
    groups = min(nblk, 2 * sms, groups_cap)
    per = -(-nblk // groups)
    groups = -(-nblk // per)
    bucket = np.clip(keys >> (2 * k - 4), 0, NB - 1)
    runlen = np.zeros((nblk, NB), np.int64)
    np.add.at(runlen, (np.arange(n) // BLOCK, bucket), 1)
    cursors = np.zeros_like(runlen)
    totals = np.zeros((groups, NB), np.int64)
    for g in range(groups):
        rows = runlen[g * per:(g + 1) * per]
        cursors[g * per:(g + 1) * per] = np.cumsum(rows, 0) - rows
        totals[g] = rows.sum(0)
    every = totals.sum(0)
    offsets = np.concatenate([[0], np.cumsum(every)])
    for g in range(groups):
        base = offsets[:-1] + totals[:g].sum(0)
        cursors[g * per:(g + 1) * per] += base
    return runlen, cursors, offsets


@pytest.mark.parametrize("n,sms", [(1, 132), (BLOCK + 1, 132),
                                   (40 * BLOCK + 17, 132), (40 * BLOCK, 3),
                                   (300 * BLOCK + 5, 132), (37 * BLOCK, 7)])
def test_kernel_metadata_model(n, sms):
    keys = _keys(np.random.default_rng(n + sms), n, 25)
    got = _kernel_run_metadata(keys, 25, sms)
    want = cp.run_metadata_torch(torch.from_numpy(keys), 25)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


# (f) the tool


def test_radixbench_on_cpu_returns_every_field(tmp_path):
    out = radixbench.main(["--device", "cpu", "--n", "65536", "--out",
                           str(tmp_path / "r.json")])
    for f in ("n_keys", "buckets", "block", "global_sort_ms",
              "bucket_sorts_ms", "partition_kernel_ms", "run_metadata_ms",
              "radix_total_ms", "speedup_vs_global_sort", "device"):
        assert out[f] is not None, f
    assert (out["n_keys"], out["buckets"], out["block"]) == (65536, NB, BLOCK)
    assert out["device"] == "cpu" and out["nvidia_smi"] is None
    assert out["radix_total_ms"] == pytest.approx(
        out["partition_kernel_ms"] + out["run_metadata_ms"]
        + out["bucket_sorts_ms"])
    assert (tmp_path / "r.json").exists()


def test_radixbench_needs_a_card_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        radixbench.main(["--n", "65536", "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def test_radixbench_cuts_n_to_whole_blocks(tmp_path):
    out = radixbench.main(["--device", "cpu", "--n", str(3 * BLOCK + 100),
                           "--k", "11", "--out", str(tmp_path / "r.json")])
    assert out["n_keys"] == 3 * BLOCK
    keys = radixbench.random_keys(3 * BLOCK, 11, 0, "cpu")
    assert int(keys.min()) >= 0 and int(keys.max()) < 1 << 22
    assert torch.equal(keys, radixbench.random_keys(3 * BLOCK, 11, 0, "cpu"))
