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


@pytest.mark.parametrize("k,B,L,fill", [
    pytest.param(11, 256, 64, "mixed", id="11"),
    pytest.param(25, 256, 64, "mixed", id="25"),
    pytest.param(31, 256, 64, "mixed", id="31"),
    (25, 256, 151, "mixed"),   # L not a multiple of 16, odd W
    (24, 1001, 151, "mixed"),  # odd B
    (25, 3, 30, "mixed"),      # fewer reads than a block's rows
    (1, 256, 40, "mixed"),     # the smallest k
    (31, 256, 48, "no_n"),
    (25, 256, 64, "all_n"),
])
def test_encode_canon_matches_pallas_and_xla(k, B, L, fill):
    rng = np.random.default_rng(k)
    reads, _, g = _probe_reads(rng, B, L, k)
    if fill == "all_n":
        reads = np.full((B, L), ord("N"), np.uint8)
    elif fill == "no_n":
        starts = rng.integers(0, len(g) - L, B)
        reads = g[starts[:, None] + np.arange(L)[None, :]]
    got = cuda_count.encode_canon_torch(torch.from_numpy(reads), k).numpy()
    if B % pallas_count.BLK == 0:  # the Pallas kernel takes whole blocks only
        hi, lo = pallas_count.encode_canon_hilo(jnp.asarray(reads), k,
                                                interpret=True)
        np.testing.assert_array_equal(got, _hilo_to_i64(hi, lo))
    hi, lo = pallas_count.encode_canon_hilo_xla(jnp.asarray(reads), k)
    np.testing.assert_array_equal(got, _hilo_to_i64(hi, lo))
    if B >= pallas_count.BLK:  # enough reads to hold both kinds of window
        assert (got != codec.SENTINEL).any() == (fill != "all_n")
        assert (got == codec.SENTINEL).any() == (fill != "no_n")


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


_TILE = cuda_fold._TILE


def _edge_runs(rng, edge, counted):
    """Sorted keys (+ counts) on one named edge of the CUDA kernel's tiles."""
    S = codec.SENTINEL
    if edge == "all_equal":              # one run across every tile
        keys = np.full(2 * _TILE, 12345, np.int64)
    elif edge == "sentinel_at_tile_edge":  # the first sentinel opens a tile
        keys = np.concatenate([np.sort(rng.integers(0, 1 << 40, _TILE)),
                               np.full(_TILE, S)])
    elif edge == "run_ends_at_tile_edge":
        keys = np.repeat(np.arange(4, dtype=np.int64), _TILE // 2)
    elif edge == "tile_minus_1":
        keys = np.sort(rng.integers(0, 300, _TILE - 1))
    elif edge == "tile_plus_1":
        keys = np.sort(rng.integers(0, 300, _TILE + 1))
    elif edge == "odd_slice":            # a view that starts at element 1
        keys = np.sort(rng.integers(0, 500, 2 * _TILE + 1))[1:]
    else:
        raise KeyError(edge)
    keys = keys.astype(np.int64)
    counts = rng.integers(1, 100, len(keys)).astype(np.int32) if counted \
        else None
    return keys, counts


@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("n,n_unique,cap", [
    (8192, 1000, 4096),       # runs cross the kernel's tiles
    (4096, 4096, 4096),       # all unique, exact fit
    (8192, 0, 4096),          # all sentinel
    (8192, 129, 4096),        # long runs, few heads
    (8192, 4000, 4096),       # short runs
    ("all_equal", 1, 4096),
    ("sentinel_at_tile_edge", None, 4096),
    ("run_ends_at_tile_edge", 4, 4096),
    ("tile_minus_1", None, 4096),
    ("tile_plus_1", None, 4096),
    ("odd_slice", None, 4096),
])
def test_compact_runs_matches_pallas_fold(n, n_unique, cap, counted):
    if isinstance(n, str):
        keys, counts = _edge_runs(np.random.default_rng(len(n)), n, counted)
        if n_unique is None:
            n_unique = len(np.unique(keys[keys != codec.SENTINEL]))
    else:
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


def test_compact_runs_int64_sums_pass_2_31():
    """Run sums above 2^31. The JAX package sums counts in int32 (it clamps
    a run at 2^31 - 1), so it cannot take this case: the plain version is
    held to numpy instead."""
    rng = np.random.default_rng(31)
    keys = np.sort(rng.integers(0, 40, 3 * _TILE)).astype(np.int64)
    keys[-100:] = codec.SENTINEL
    counts = rng.integers(1 << 27, 1 << 28, len(keys)).astype(np.int64)
    got_k, got_s = cuda_fold.compact_runs_torch(torch.from_numpy(keys),
                                                torch.from_numpy(counts))
    valid = keys != codec.SENTINEL
    want_k, inv = np.unique(keys[valid], return_inverse=True)
    want_s = np.zeros(len(want_k), np.int64)
    np.add.at(want_s, inv, counts[valid])
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert int(got_s.max()) > 1 << 31


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


def _model_window_hits(reads, quals, lens, table, k, min_q):
    """numpy model of csrc/window_hits.cu's lookup: a read's windows
    w < min(W, len - k) whose k bases are ACGT with good quals, each found
    through hashlist_index's prefix range of the table and a binary search
    inside it. Returns the hits and the longest range searched."""
    B, L = reads.shape
    W = L - k + 1
    key = cuda_count.encode_canon_torch(torch.from_numpy(reads), k).numpy()
    qbad = np.cumsum(quals.astype(np.int32) - 33 < min_q, axis=1)
    qbad = np.pad(qbad, ((0, 0), (1, 0)))
    qok = qbad[:, k:] == qbad[:, :W]
    w = np.arange(W)[None, :]
    scanned = (w < np.minimum(W, lens[:, None] - k)) & qok & \
        (key != codec.SENTINEL)
    t = codec.keys_u64_to_i64(table)
    index = cuda_filter.hashlist_index(torch.from_numpy(t), k)
    off = index.offsets.numpy().astype(np.int64)
    rows, cols = np.nonzero(scanned)
    kk = key[rows, cols]
    p = kk >> (2 * k - index.bits)
    lo, hi = off[p], off[p + 1]
    longest = int((hi - lo).max()) if kk.size else 0
    found = np.zeros(kk.size, bool)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) // 2
        v = t[np.minimum(mid, max(t.size - 1, 0))] if t.size else mid
        found |= act & (v == kk)
        lo = np.where(act & (v < kk), mid + 1, lo)
        hi = np.where(act & (v >= kk), mid, hi)
        hi = np.where(found, lo, hi)
    hits = np.zeros(B, np.int32)
    np.add.at(hits, rows[found], 1)
    return hits, longest


@pytest.mark.parametrize("T", [64, 300, 3000])
def test_window_hits_index_lookup_model_matches_jax(T):
    """The CUDA kernel's lookup (prefix range, then compare), modelled in
    numpy, finds exactly the windows the JAX package counts: its XLA path,
    and its Pallas kernel in interpret mode where it unrolls the table."""
    k = 25
    rng = np.random.default_rng(200 + T)
    reads, quals, lens, table = _filter_case(rng, k, 256, 80, T)
    got, longest = _model_window_hits(reads, quals, lens, table, k, 15)
    assert got.sum() > 0 and longest <= 8
    want = np.asarray(jfilter.window_hits(
        jnp.asarray(reads), jnp.asarray(quals), jnp.asarray(lens),
        jnp.asarray(table), k, 15))
    np.testing.assert_array_equal(got, want)
    if T <= 1024:
        hi, lo = pallas_filter.split_table(table)
        want = np.asarray(pallas_filter.pallas_window_hits(
            jnp.asarray(reads), jnp.asarray(quals), jnp.asarray(lens),
            jnp.asarray(hi), jnp.asarray(lo), k, 15, interpret=True))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T,k", [(0, 25), (1, 25), (4, 1), (64, 11),
                                 (2498, 25), (3000, 31), (4097, 25),
                                 (65536, 25)])
def test_hashlist_index_matches_searchsorted(T, k):
    rng = np.random.default_rng(T + k)
    table = np.unique(rng.integers(0, 1 << (2 * k), 2 * T + 8))
    table = np.sort(rng.permutation(table)[:T])
    index = cuda_filter.hashlist_index(torch.from_numpy(table), k)
    assert index.bits == cuda_filter.index_bits(T, k) <= min(
        cuda_filter.MAX_INDEX_BITS, 2 * k)
    assert (index.k, index.size) == (k, T)
    assert index.offsets.dtype == torch.int32
    edges = np.arange((1 << index.bits) + 1, dtype=np.int64) << (
        2 * k - index.bits)
    np.testing.assert_array_equal(index.offsets.numpy(),
                                  np.searchsorted(table, edges))
    assert int(index.offsets[-1]) == T


def test_hashlist_index_worst_bucket_of_canonical_keys():
    """Canonical keys (the min of two strands) crowd the low prefixes; the
    index's worst bucket stays a few keys, so the search inside it is a
    few steps."""
    k = 25
    rng = np.random.default_rng(3)
    for T, limit in ((2498, 8), (3000, 8), (65536, 16)):
        g = _genome(rng, 4 * T + k)
        win = [g[s:s + k].tobytes().decode()
               for s in rng.integers(0, len(g) - k, 2 * T)]
        table = np.unique(codec.keys_u64_to_i64(codec.strs_to_kmers(
            [codec.canonical_str(w) for w in win], k)))
        table = np.sort(rng.permutation(table)[:T])
        index = cuda_filter.hashlist_index(torch.from_numpy(table), k)
        sizes = np.diff(index.offsets.numpy())
        assert sizes.sum() == T and sizes.mean() <= max(1, T >> 15)
        assert sizes.max() <= limit, (T, sizes.max())


def _lane_bits(x):
    b = x & np.uint32(0x01010101)
    return (b | (b >> 7) | (b >> 14) | (b >> 21)) & np.uint32(0xF)


def _byte_perm(x, sel):
    """__byte_perm(x, 0, sel) for selectors 0-3 in each nibble."""
    out = np.zeros_like(x)
    for n in range(4):
        byte = (sel >> np.uint32(4 * n)) & np.uint32(7)
        pick = np.where(byte < 4, (x >> (np.uint32(8) * byte)) & np.uint32(0xFF),
                        np.uint32(0))
        out |= pick << np.uint32(8 * n)
    return out


def test_window_hits_packing_arithmetic_model():
    """csrc/window_hits.cu:codes4 and qual_bad, modelled
    in numpy over every byte value: codes and bad bits as ops/codec's
    encode_bases, quals bad iff below the threshold, for every threshold
    the kernel takes the fast route for (<= 128)."""
    rng = np.random.default_rng(21)
    lanes = np.concatenate([np.arange(256), rng.integers(0, 256, 4092)])
    words = lanes.reshape(-1, 4).astype(np.uint32)
    x = (words[:, 0] | words[:, 1] << 8 | words[:, 2] << 16
         | words[:, 3] << 24).astype(np.uint32)
    u = x & np.uint32(0xDFDFDFDF)
    c = (u >> np.uint32(1)) & np.uint32(0x03030303)
    c ^= (c >> np.uint32(1)) & np.uint32(0x01010101)
    sel = _byte_perm(c | (c >> np.uint32(4)), np.uint32(0x4420))
    d = u ^ _byte_perm(np.full_like(x, 0x54474341), sel)
    bad7 = ((d & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | d
    bad = _lane_bits(bad7 >> np.uint32(7))
    codes = codec.encode_bases(torch.from_numpy(
        words.astype(np.uint8))).numpy()
    for i in range(4):
        want_bad = codes[:, i] == codec.INVALID
        np.testing.assert_array_equal((bad >> np.uint32(i)) & 1, want_bad)
        got_code = (c >> np.uint32(8 * i)) & np.uint32(3)
        np.testing.assert_array_equal(got_code[~want_bad],
                                      codes[~want_bad, i])
    for thr in (0, 1, 33, 48, 100, 127, 128):
        t4 = np.uint32(min(thr, 255) * 0x01010101)
        ok = (x & np.uint32(0x80808080)) | ((x | np.uint32(0x80808080)) - t4)
        both = _lane_bits((bad7 | ~ok) >> np.uint32(7))  # x as bases, quals
        for i in range(4):
            np.testing.assert_array_equal(
                (both >> np.uint32(i)) & 1,
                (codes[:, i] == codec.INVALID) | (words[:, i] < thr))


def test_revcomp_bit_reversal_model():
    """csrc/window_hits.cu:revcomp, modelled on Python ints: the 2k-bit key's
    reverse complement, as ops/codec's canonical form takes it."""
    rng = np.random.default_rng(22)
    for k in (1, 11, 25, 31):
        strs = ["".join(rng.choice(list("ACGT"), k)) for _ in range(50)]
        keys = codec.strs_to_kmers(strs, k)
        comp = str.maketrans("ACGT", "TGCA")
        rc = codec.strs_to_kmers([s[::-1].translate(comp) for s in strs], k)
        for key, want in zip(keys.tolist(), rc.tolist()):
            x = (key << (64 - 2 * k)) & ((1 << 64) - 1)
            r = int(f"{x:064b}"[::-1], 2)
            r = ((r >> 1) & 0x5555555555555555) | \
                ((r & 0x5555555555555555) << 1)
            assert r ^ ((1 << (2 * k)) - 1) == want


def test_filter_pairs_with_and_without_index():
    k = 25
    rng = np.random.default_rng(13)
    r1, q1, l1, table = _filter_case(rng, k, 256, 80, 400)
    r2, q2, l2, _ = _filter_case(rng, k, 256, 80, 10)
    t = torch.from_numpy(codec.keys_u64_to_i64(table))
    mates = [torch.from_numpy(a) for a in (r1, q1, l1, r2, q2, l2)]
    index = cuda_filter.hashlist_index(t, k)
    without = pfilter.filter_pairs(*mates, t, k, 15, 2)
    with_ix = pfilter.filter_pairs(*mates, t, k, 15, 2, index)
    for a, b in zip(without, with_ix):
        assert torch.equal(a, b)
    assert 0 < int(with_ix[0].sum()) < len(r1)
    keep, h = pfilter.filter_single(mates[0], mates[1], mates[2], t, k, 15,
                                    2, index)
    assert torch.equal(h, without[1])
    with pytest.raises(ValueError):  # an index of another table or k
        pfilter.filter_pairs(*mates, t[1:], k, 15, 2, index)
    with pytest.raises(ValueError):
        pfilter.filter_pairs(*mates, t, 23, 15, 2, index)


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
