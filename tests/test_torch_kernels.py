"""The port's three kernel modules against the JAX package's Pallas kernels.

Each kernel module of rufus_tpu_torch has a CUDA kernel and a plain
PyTorch version. On the CPU the wrappers run the plain version, which is
compared here, exactly, with the Pallas kernel it replaces in interpret
mode and with the JAX package's XLA path. Every output is an integer, so
the tolerance is exact equality. The CUDA kernels themselves are compared
with their plain versions on the card by tests/test_torch_gpu.py and by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rufus_tpu.ops import filter as jfilter
from rufus_tpu.ops import pallas_count, pallas_filter, pallas_fold
from rufus_tpu.parallel import sharded
from rufus_tpu_torch.ops import codec, cuda_count, cuda_filter, cuda_fold
from rufus_tpu_torch.ops import filter as pfilter

U32_ONES = np.uint32(0xFFFFFFFF)


def _genome(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), n)


def _probe_reads(rng, B, L, k):
    """Reads cut from a random genome, with the verify-skill probes mixed
    in: N bases, lowercase bases, reads shorter than k ('N'-padded rows)."""
    g = _genome(rng, 4 * L + 4096)
    starts = rng.integers(0, len(g) - L, B)
    reads = g[starts[:, None] + np.arange(L)[None, :]]
    nmask = rng.random((B, L)) < 0.02
    reads = np.where(nmask, np.uint8(ord("N")), reads)
    low = rng.random((B, L)) < 0.05
    reads = np.where(low, reads | np.uint8(0x20), reads)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[: B // 8] = rng.integers(0, k, B // 8)  # shorter than k
    pad = np.arange(L)[None, :] >= lens[:, None]
    reads = np.where(pad, np.uint8(ord("N")), reads).astype(np.uint8)
    return reads, lens, g


def _hilo_to_i64(hi, lo):
    u = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)
    return codec.keys_u64_to_i64(u)


# ---------------------------------------------------------------------------
# kernel 1: encode_canon
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [11, 25, 31])
def test_encode_canon_matches_pallas_and_xla(k):
    rng = np.random.default_rng(k)
    reads, _, _ = _probe_reads(rng, 256, 64, k)
    got = cuda_count.encode_canon_torch(torch.from_numpy(reads), k).numpy()
    hi, lo = pallas_count.encode_canon_hilo(jnp.asarray(reads), k,
                                            interpret=True)
    np.testing.assert_array_equal(got, _hilo_to_i64(hi, lo))
    hi, lo = pallas_count.encode_canon_hilo_xla(jnp.asarray(reads), k)
    np.testing.assert_array_equal(got, _hilo_to_i64(hi, lo))
    assert (got != codec.SENTINEL).any() and (got == codec.SENTINEL).any()


def test_encode_canon_rejects_k32_and_short_rows():
    reads = torch.full((4, 40), ord("A"), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_count.encode_canon(reads, 32)
    with pytest.raises(ValueError):
        cuda_count.encode_canon(reads[:, :10], 11)


# ---------------------------------------------------------------------------
# kernel 2: compact_runs
# ---------------------------------------------------------------------------


def _sorted_runs(rng, n, n_unique, counted):
    """n sorted int64 keys: n_unique distinct keys in runs, then sentinels."""
    pool = np.unique(rng.integers(0, 1 << 50, max(4 * n_unique, 64)))
    uniq = np.sort(rng.choice(pool, n_unique, replace=False))
    n_valid = n - rng.integers(0, n // 4 + 1) if n_unique else 0
    n_valid = max(n_valid, n_unique)
    reps = np.ones(n_unique, np.int64)
    if n_unique:
        extra = rng.multinomial(n_valid - n_unique, np.ones(n_unique) / n_unique)
        reps += extra
    keys = np.repeat(uniq, reps).astype(np.int64)
    keys = np.concatenate([keys, np.full(n - len(keys), codec.SENTINEL)])
    counts = rng.integers(1, 100, n).astype(np.int32) if counted else None
    return keys, counts


def _jax_rle_compact(keys, counts, cap, pallas):
    """The JAX package's compaction of the same run: _rle_compact_hilo (the
    XLA sort path) or its hole-punching + pallas_fold.compact_sorted_hilo in
    interpret mode + the prefix-difference run sums."""
    u = codec.keys_i64_to_u64(keys)
    h = jnp.asarray((u >> np.uint64(32)).astype(np.uint32))
    l = jnp.asarray(u.astype(np.uint32))
    c = None if counts is None else jnp.asarray(counts)
    if not pallas:
        oh, ol, sums, nv = sharded._rle_compact_hilo(h, l, c, cap)
        nv = int(nv)
        return _hilo_to_i64(np.asarray(oh)[:nv], np.asarray(ol)[:nv]), \
            np.asarray(sums)[:nv].astype(np.int64)
    hn, ln = np.asarray(h), np.asarray(l)
    head = np.ones(len(hn), bool)
    head[1:] = (hn[1:] != hn[:-1]) | (ln[1:] != ln[:-1])
    sent = (hn == U32_ONES) & (ln == U32_ONES)
    valid = head & ~sent
    cu = np.where(sent, 0, 1 if counts is None else counts).astype(np.int64)
    pref = np.concatenate([[0], np.cumsum(cu)[:-1]])
    total = int(cu.sum())
    uh = np.where(valid, hn, U32_ONES)
    ul = np.where(valid, ln, U32_ONES)
    us = np.where(valid, pref, 0).astype(np.int32)
    oh, ol, oc, slots, _ = pallas_fold.compact_sorted_hilo(
        jnp.asarray(uh), jnp.asarray(ul), jnp.asarray(us), cap,
        interpret=True)
    slots = int(slots)
    starts = np.asarray(oc)[:slots].astype(np.int64)
    sums = np.concatenate([starts[1:], [total]])[:slots] - starts
    return _hilo_to_i64(np.asarray(oh)[:slots], np.asarray(ol)[:slots]), sums


@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("n,n_unique,cap", [
    (8192, 1000, 4096),       # runs cross the 2048-element tiles
    (4096, 4096, 4096),       # all unique, exact fit
    (8192, 0, 4096),          # all sentinel
    (8192, 129, 4096),        # long runs, few heads
    (8192, 4000, 4096),       # short runs
])
def test_compact_runs_matches_pallas_fold(n, n_unique, cap, counted):
    rng = np.random.default_rng(n + n_unique)
    keys, counts = _sorted_runs(rng, n, n_unique, counted)
    got_k, got_s = cuda_fold.compact_runs_torch(
        torch.from_numpy(keys),
        None if counts is None else torch.from_numpy(counts))
    assert got_k.numel() == n_unique
    for pallas in (True, False):
        want_k, want_s = _jax_rle_compact(keys, counts, cap, pallas)
        np.testing.assert_array_equal(got_k.numpy(), want_k)
        np.testing.assert_array_equal(got_s.numpy(), want_s)


# ---------------------------------------------------------------------------
# kernel 3: window_hits
# ---------------------------------------------------------------------------


def _filter_case(rng, k, B, L, T):
    reads, lens, g = _probe_reads(rng, B, L, k)
    quals = np.where(rng.random((B, L)) < 0.03, np.uint8(ord("#")),
                     np.uint8(ord("I")))
    starts = rng.integers(0, len(g) - k, T)
    win = [g[s:s + k].tobytes().decode() for s in starts]
    table = np.unique(codec.strs_to_kmers(
        [codec.canonical_str(w) for w in win], k))
    return reads, quals, lens, table


@pytest.mark.parametrize("k,T", [(11, 64), (25, 300), (31, 300), (25, 3000)])
def test_window_hits_matches_pallas_and_xla(k, T):
    rng = np.random.default_rng(100 + k + T)
    reads, quals, lens, table = _filter_case(rng, k, 256, 80, T)
    got = cuda_filter.window_hits_torch(
        torch.from_numpy(reads), torch.from_numpy(quals),
        torch.from_numpy(lens), torch.from_numpy(codec.keys_u64_to_i64(table)),
        k, 15).numpy()
    assert got.sum() > 0
    want = np.asarray(jfilter.window_hits(
        jnp.asarray(reads), jnp.asarray(quals), jnp.asarray(lens),
        jnp.asarray(table), k, 15))
    np.testing.assert_array_equal(got, want)
    if T <= 1024:  # the Pallas kernel unrolls its loop over the table
        hi, lo = pallas_filter.split_table(table)
        want = np.asarray(pallas_filter.pallas_window_hits(
            jnp.asarray(reads), jnp.asarray(quals), jnp.asarray(lens),
            jnp.asarray(hi), jnp.asarray(lo), k, 15, interpret=True))
        np.testing.assert_array_equal(got, want)


def test_window_hits_large_table_matches_bloom_verify_path():
    """Above SMALL_TABLE_MAX the JAX pipeline uses Bloom candidates plus an
    exact host verify; the port's one exact path gives the same hits."""
    k, T = 25, 2048
    rng = np.random.default_rng(5)
    reads, quals, lens, table = _filter_case(rng, k, 256, 80, T)
    reads = np.where(reads == ord("N"), reads, reads & np.uint8(0xDF))
    got = cuda_filter.window_hits_torch(
        torch.from_numpy(reads), torch.from_numpy(quals),
        torch.from_numpy(lens), torch.from_numpy(codec.keys_u64_to_i64(table)),
        k, 15).numpy()
    for i in range(len(reads)):
        n = int(lens[i])
        seq = reads[i, :n].tobytes().decode()
        qual = quals[i, :n].tobytes().decode()
        want = jfilter.exact_hits_host(seq, qual, table, k, 15)
        assert got[i] == want
        assert pfilter.exact_hits_host(seq, qual, table, k, 15) == want


def test_filter_pairs_and_single_match_reference():
    k = 25
    rng = np.random.default_rng(12)
    r1, q1, l1, table = _filter_case(rng, k, 256, 80, 400)
    r2, q2, l2, _ = _filter_case(rng, k, 256, 80, 10)
    t = torch.from_numpy(codec.keys_u64_to_i64(table))
    mine = pfilter.filter_pairs(*(torch.from_numpy(a) for a in
                                  (r1, q1, l1, r2, q2, l2)), t, k, 15, 2)
    want = jfilter.filter_pairs(*(jnp.asarray(a) for a in
                                  (r1, q1, l1, r2, q2, l2)),
                                jnp.asarray(table), k, 15, 2)
    for a, b in zip(mine, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    keep, h = pfilter.filter_single(torch.from_numpy(r1), torch.from_numpy(q1),
                                    torch.from_numpy(l1), t, k, 15, 2)
    jkeep, jh = jfilter.filter_single(jnp.asarray(r1), jnp.asarray(q1),
                                      jnp.asarray(l1), jnp.asarray(table), k,
                                      15, 2)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert 0 < int(keep.sum()) < len(keep)


def test_window_hits_empty_table():
    reads = torch.full((8, 40), ord("A"), dtype=torch.uint8)
    quals = torch.full((8, 40), ord("I"), dtype=torch.uint8)
    lens = torch.full((8,), 40, dtype=torch.int32)
    got = cuda_filter.window_hits(reads, quals, lens,
                                  torch.empty(0, dtype=torch.int64), 25, 15)
    assert got.dtype == torch.int32 and (got == 0).all()


# ---------------------------------------------------------------------------
# routing: CPU tensors take the plain version; the kernel is not launched
# ---------------------------------------------------------------------------


def test_wrappers_route_cpu_tensors_to_plain_versions():
    rng = np.random.default_rng(9)
    k = 25
    reads, quals, lens, table = _filter_case(rng, k, 32, 80, 200)
    r, q, l = (torch.from_numpy(a) for a in (reads, quals, lens))
    t = torch.from_numpy(codec.keys_u64_to_i64(table))
    before = (cuda_count.encode_canon.launches, cuda_fold.compact_runs.launches,
              cuda_filter.window_hits.launches)
    keys = cuda_count.encode_canon(r, k)
    assert torch.equal(keys, cuda_count.encode_canon_torch(r, k))
    s = torch.sort(keys.reshape(-1)).values
    for a, b in zip(cuda_fold.compact_runs(s), cuda_fold.compact_runs_torch(s)):
        assert torch.equal(a, b)
    assert torch.equal(cuda_filter.window_hits(r, q, l, t, k, 15),
                       cuda_filter.window_hits_torch(r, q, l, t, k, 15))
    after = (cuda_count.encode_canon.launches, cuda_fold.compact_runs.launches,
             cuda_filter.window_hits.launches)
    assert after == before


def test_wrappers_reject_other_devices_and_dtypes():
    meta = torch.empty((4, 40), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        cuda_count.encode_canon(meta, 25)
    with pytest.raises(TypeError):
        cuda_count.encode_canon(torch.zeros((4, 40), dtype=torch.int32), 25)
    with pytest.raises(TypeError):
        cuda_fold.compact_runs(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_fold.compact_runs(torch.zeros(8, dtype=torch.int64, device="meta"))
