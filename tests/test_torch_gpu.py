"""On the card: each CUDA kernel against its plain PyTorch version, and the
slice on the card against the slice on the CPU. Exact equality (integer
outputs). These tests import neither JAX nor rufus_tpu, so they run on a
machine that has only PyTorch:

    python -m pytest -q -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA device they skip.
"""

import os

import numpy as np
import pytest
import torch

from merge_cases import CASES, runs, union_sum
from rufus_tpu_torch import synthetic
from rufus_tpu_torch.ops import (codec, cuda_count, cuda_filter, cuda_fold,
                                 cuda_merge, cuda_partition, cuda_sw)
from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _reads(rng, B, L, k):
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4 * L + 4096)
    starts = rng.integers(0, len(g) - L, B)
    reads = g[starts[:, None] + np.arange(L)[None, :]]
    reads = np.where(rng.random((B, L)) < 0.02, np.uint8(ord("N")), reads)
    reads = np.where(rng.random((B, L)) < 0.05, reads | np.uint8(0x20), reads)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[: B // 8] = rng.integers(0, k, B // 8)
    reads = np.where(np.arange(L)[None, :] >= lens[:, None], np.uint8(ord("N")),
                     reads).astype(np.uint8)
    quals = np.where(rng.random((B, L)) < 0.03, np.uint8(ord("#")),
                     np.uint8(ord("I")))
    return reads, quals, lens, g


@pytest.mark.parametrize("B,L,k,fill", [
    (4096, 160, 25, "mixed"), (1000, 160, 31, "mixed"),
    (777, 1024, 11, "mixed"), (3, 30, 25, "mixed"),
    (1001, 151, 24, "mixed"),   # L not a multiple of 16, odd B
    (1000, 151, 1, "mixed"),    # the smallest k
    (513, 160, 31, "no_n"), (513, 160, 25, "all_n"), (4096, 160, 25, "no_n"),
    (65, 331, 21, "mixed"),     # an odd number of rows a block, odd W
])
def test_encode_canon_kernel(B, L, k, fill):
    dev = _card()
    rng = np.random.default_rng(B)
    reads, _, _, g = _reads(rng, B, L, k)
    if fill == "all_n":
        reads = np.full((B, L), ord("N"), np.uint8)
    elif fill == "no_n":
        starts = rng.integers(0, len(g) - L, B)
        reads = g[starts[:, None] + np.arange(L)[None, :]]
    r = torch.from_numpy(reads).to(dev)
    got = cuda_count.encode_canon(r, k)
    torch.cuda.synchronize()
    want = cuda_count.encode_canon_torch(r, k)
    assert torch.equal(got, want)
    if fill != "mixed":
        assert bool((want == codec.SENTINEL).all()) == (fill == "all_n")
    # a batch that starts at an odd byte: no 16-byte loads
    odd = torch.from_numpy(np.concatenate([[0], reads.reshape(-1)])
                           .astype(np.uint8)).to(dev)[1:].view(B, L)
    assert torch.equal(cuda_count.encode_canon(odd, k), want)


_TILE = cuda_fold._TILE


def _random_sorted(n, g):
    keys = torch.randint(0, max(1, n // 3), (n,), generator=g)
    keys[torch.rand(n, generator=g) < 0.1] = codec.SENTINEL
    return torch.sort(keys).values


def _compact_case(case, g):
    """Sorted keys (sentinels last) of one named edge of the tiled scan."""
    if isinstance(case, int):
        return _random_sorted(case, g)
    n = 5 * _TILE + 17
    if case == "all_equal":     # one run across every tile
        return torch.full((n,), 12345, dtype=torch.int64)
    if case == "long_run":      # its tail is gathered over more than 32 tiles
        return torch.cat([torch.full((40 * _TILE + 3,), 7, dtype=torch.int64),
                          torch.arange(8, 108, dtype=torch.int64)])
    if case == "all_distinct":
        return torch.arange(n, dtype=torch.int64) * 3
    if case == "all_sentinel":
        return torch.full((n,), codec.SENTINEL, dtype=torch.int64)
    if case == "sentinel_at_tile_edge":   # first sentinel opens a tile
        return torch.cat([_random_sorted(2 * _TILE, g).clamp(max=1 << 40),
                          torch.full((_TILE + 5,), codec.SENTINEL)])
    if case == "run_ends_at_tile_edge":
        return torch.repeat_interleave(torch.arange(8, dtype=torch.int64),
                                       _TILE // 2)
    if case == "odd_slice":     # starts at an odd element: not 16-byte aligned
        return _random_sorted(3 * _TILE + 2, g)
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    0, 1, 2, 2047, 2048, 2049, 4095, 4096, 4097, 100_003, 3_000_000,
    30_000_000, "all_equal", "long_run",
    "all_distinct", "all_sentinel", "sentinel_at_tile_edge",
    "run_ends_at_tile_edge", "odd_slice"])
def test_compact_runs_kernel(case):
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(
        case if isinstance(case, int) else len(case))
    s = _compact_case(case, g).to(dev)
    n = s.numel()
    c32 = torch.randint(1, 50, (n,), generator=g, dtype=torch.int32).to(dev)
    # int64 counts whose sum passes 2^31 within one run and in all
    big = c32.to(torch.int64) * (1 << 27)
    if case == "odd_slice":
        s, c32, big = s[1:], c32[1:], big[1:]
        assert s.data_ptr() % 16 == 8
    for c in (None, c32, big):
        want = cuda_fold.compact_runs_torch(s, c)
        for _ in range(2):  # the second call reuses the first's scratch
            got = cuda_fold.compact_runs(s, c)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b)
                assert a.untyped_storage().nbytes() == 8 * a.numel()
        if c is big and want[1].numel() and n > 100:
            assert int(want[1].sum()) > 1 << 31


@pytest.mark.parametrize("T", [0, 1, 100, 5000, 40000])
@pytest.mark.parametrize("L", [160, 1024])
def test_window_hits_kernel(T, L):
    dev = _card()
    k = 25
    rng = np.random.default_rng(T + L)
    reads, quals, lens, g = _reads(rng, 3000, L, k)
    starts = rng.integers(0, len(g) - k, T)
    wins = [g[s:s + k].tobytes().decode() for s in starts]
    pool = rng.integers(0, 1 << 50, T)  # keys absent from the reads
    table = np.unique(np.concatenate([
        codec.keys_u64_to_i64(codec.strs_to_kmers(
            [codec.canonical_str(w) for w in wins], k)) if T else
        np.empty(0, np.int64), pool[: T // 2]]))[:T]
    r, q, l = (torch.from_numpy(a).to(dev) for a in (reads, quals, lens))
    t = torch.from_numpy(table).to(dev)
    got = cuda_filter.window_hits(r, q, l, t, k, 15)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_filter.window_hits_torch(r, q, l, t, k, 15))
    if T >= 100:
        assert int(got.sum()) > 0


def _switch_T(L):
    """The largest table whose keys the kernel stages in shared memory."""
    T = 1
    while cuda_filter.smem_plan(L, T + 1,
                                cuda_filter.index_bits(T + 1, 25))[1]:
        T += 1
    return T


def _edge_table(rng, case, g, k, T):
    """T sorted unique keys: canonical windows of the genome the reads come
    from (so some windows hit) and random keys below 4^k (mostly misses);
    "one_bucket": one window's key and keys of its index bucket only;
    "ends": also 0 and 4^k - 1, the ends of the key range."""
    top = 1 << (2 * k)
    must = np.unique(codec.keys_u64_to_i64(codec.strs_to_kmers(
        [codec.canonical_str(g[s:s + k].tobytes().decode())
         for s in rng.integers(0, len(g) - k, T // 2 + 1)], k)))
    if case == "one_bucket":
        sh = 2 * k - cuda_filter.index_bits(T, k)
        lo = int(must[0]) >> sh << sh
        must = must[:1]
        fill = rng.integers(lo, lo + (1 << sh), 2 * T)
    else:
        fill = rng.integers(0, top, 2 * T)
    if case == "ends":
        must = np.concatenate([[0, top - 1], must])
    must = np.unique(must)[:T]
    fill = rng.permutation(np.setdiff1d(fill, must))[:T - must.size]
    return np.sort(np.concatenate([must, fill]))


# (T, L, k, case): index widths at T = 2^b - 1, 2^b, 2^b + 1; the
# shared-memory switch; one bucket; the key range's ends; k and L edges
_WINDOW_EDGES = [
    (0, 160, 25, "plain"), (1, 160, 25, "plain"), (4095, 160, 25, "plain"),
    (4096, 160, 25, "plain"), (4097, 160, 25, "plain"),
    (16385, 160, 25, "plain"), ("switch", 160, 25, "plain"),
    ("switch+1", 160, 25, "plain"), (65536, 160, 25, "plain"),
    (3000, 160, 25, "one_bucket"), (40000, 160, 25, "one_bucket"),
    (300, 160, 11, "ends"), (3000, 160, 25, "ends"), (3000, 160, 31, "ends"),
    (2498, 1024, 25, "plain"), (2498, 151, 25, "plain"),
    (65536, 1024, 31, "plain"), (300, 151, 11, "plain"),
]


@pytest.mark.parametrize("T,L,k,case", _WINDOW_EDGES)
def test_window_hits_kernel_edges(T, L, k, case):
    dev = _card()
    if T in ("switch", "switch+1"):
        T = _switch_T(L) + (T == "switch+1")
        assert cuda_filter.smem_plan(L, T, cuda_filter.index_bits(T, k))[1] \
            == (T == _switch_T(L))
    rng = np.random.default_rng([T, L, k, len(case)])
    B = 2000
    reads, quals, lens, g = _reads(rng, B, L, k)
    lens[:3] = [0, L, k]
    reads[3, :] = ord("A")  # key 0, forward
    reads[4, :] = ord("t")  # key 0, reverse complement, lowercase
    lens[3:5] = L
    quals[3:5] = ord("I")
    table = _edge_table(rng, case, g, k, T)
    assert table.size == T
    # (B, L) views at byte offset 1 of a flat buffer: contiguous, unaligned
    flat = lambda a: torch.from_numpy(  # noqa: E731
        np.concatenate([[0], a.reshape(-1)]).astype(np.uint8)).to(dev)[1:]
    r, q = flat(reads).view(B, L), flat(quals).view(B, L)
    assert r.data_ptr() % 16 == 1 and r.is_contiguous()
    l = torch.from_numpy(lens).to(dev)
    t = torch.from_numpy(table).to(dev)
    want = cuda_filter.window_hits_torch(r, q, l, t, k, 15)
    index = cuda_filter.hashlist_index(t, k)
    for ix in (None, index):
        got = cuda_filter.window_hits(r, q, l, t, k, 15, ix)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    if case == "ends":
        assert int(want[3]) > 0 and int(want[4]) > 0
    if T >= 100:
        assert int(want.sum()) > 0
    # aligned rows as well
    r, q = (torch.from_numpy(a).to(dev) for a in (reads, quals))
    assert torch.equal(cuda_filter.window_hits(r, q, l, t, k, 15, index), want)


@pytest.mark.parametrize("n,k,one_bucket", [
    (0, 25, False), (1, 25, False), (8191, 25, False), (8192, 25, False),
    (3 * 8192 + 5, 25, False), (3_000_000, 25, False),
    (3_000_000, 25, True), (3 * 8192 + 5, 31, False)])
def test_partition_kernel(n, k, one_bucket):
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(n + k)
    if one_bucket:  # every key in bucket 5
        keys = torch.randint(5 << (2 * k - 4), 6 << (2 * k - 4), (n,),
                             generator=g)
    else:  # duplicates and sentinels
        pool = torch.randint(0, 1 << (2 * k), (max(1, n // 3),), generator=g)
        keys = pool[torch.randint(0, pool.numel(), (n,), generator=g)]
        keys[torch.rand(n, generator=g) < 0.1] = codec.SENTINEL
    keys = keys.to(dev)
    got, got_off = cuda_partition.partition(keys, k)
    want, want_off = cuda_partition.partition_torch(keys, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_off, want_off)
    assert int(got_off[-1]) == n


def _partition_fill(fill, n, k, g):
    top = 1 << (2 * k)
    if fill == "sentinel_block":  # a whole 8192-key block of sentinels
        keys = torch.randint(0, top, (n,), generator=g)
        keys[8192:2 * 8192] = codec.SENTINEL
    elif fill == "bucket15":  # every key in the last bucket, no sentinel
        keys = torch.randint(15 << (2 * k - 4), top, (n,), generator=g)
    elif fill == "all_sentinel":
        keys = torch.full((n,), codec.SENTINEL, dtype=torch.int64)
    elif fill == "negative":  # clamped into bucket 0
        keys = torch.randint(-top, top, (n,), generator=g)
    else:
        pool = torch.randint(0, top, (max(1, n // 3),), generator=g)
        keys = pool[torch.randint(0, pool.numel(), (n,), generator=g)]
        keys[torch.rand(n, generator=g) < 0.1] = codec.SENTINEL
    return keys


@pytest.mark.parametrize("n,k,fill", [
    (3 * 8192 + 5, 25, "sentinel_block"), (3 * 8192 + 5, 25, "bucket15"),
    (3 * 8192, 31, "bucket15"), (8193, 25, "all_sentinel"),
    (8193, 25, "mixed"), (2 * 8192 + 1, 31, "mixed"), (1, 31, "mixed"),
    (100_003, 25, "negative"), (26_000_000, 25, "mixed")])
def test_partition_kernel_fills(n, k, fill):
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(n + k + len(fill))
    keys = _partition_fill(fill, n, k, g).to(dev)
    got, got_off = cuda_partition.partition(keys, k)
    want, want_off = cuda_partition.partition_torch(keys, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_off, want_off)


@pytest.mark.parametrize("n,k,fill", [
    (0, 25, "mixed"), (1, 25, "mixed"), (8191, 25, "mixed"),
    (8193, 25, "mixed"), (3 * 8192 + 5, 31, "bucket15"),
    (3 * 8192 + 5, 25, "sentinel_block"), (3_000_000, 25, "mixed"),
    (106_954_752, 25, "mixed")])
def test_run_metadata_kernel(n, k, fill):
    """The count and scan kernels against run_metadata_torch's bincount."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(n + k)
    keys = _partition_fill(fill, n, k, g)
    want = cuda_partition.run_metadata_torch(keys, k)
    before = cuda_partition.run_metadata.launches
    got = cuda_partition.run_metadata(keys.to(dev), k)
    torch.cuda.synchronize()
    assert cuda_partition.run_metadata.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_slice_on_card_equals_slice_on_cpu(tmp_path):
    _card()
    data = synthetic.write_trio(str(tmp_path / "fastq"), genome_bp=200_000,
                                coverage=30, n_denovo=20, seed=1)
    c, m, f = data["child"], data["mother"], data["father"]
    outs = {}
    for device in ("cuda", "cpu"):
        wd = tmp_path / device
        RufusPipeline(RufusConfig(
            subject=",".join(c), controls=[",".join(m), ",".join(f)], k=25,
            workdir=str(wd), exome=True, min_cov=5, stop_after="filter",
            fastq_a=c[0], fastq_b=c[1], batch_size=8192,
            device=device)).run()
        outs[device] = wd
    names = sorted(n for n in os.listdir(outs["cpu"])
                   if os.path.isfile(outs["cpu"] / n))
    assert any(n.endswith(".HashList") for n in names)
    for n in names:
        a = (outs["cuda"] / n).read_bytes()
        b = (outs["cpu"] / n).read_bytes()
        if n.endswith(".npz"):
            za, zb = np.load(outs["cuda"] / n), np.load(outs["cpu"] / n)
            for key in zb.files:
                np.testing.assert_array_equal(za[key], zb[key])
        else:
            assert a == b, n


@pytest.mark.parametrize("single_end", [False, True])
def test_bam_slice_on_card_equals_slice_on_cpu(tmp_path, single_end):
    """The trio from BAMs through the filter (the stranded pair stream, or
    single-end reads), on the card and on the CPU."""
    _card()
    data = synthetic.write_trio(str(tmp_path / "fastq"), genome_bp=20_000,
                                coverage=30, n_denovo=4, seed=3)
    bams = synthetic.write_trio_bams(data, str(tmp_path / "bam"), seed=3)
    outs = {}
    for device in ("cuda", "cpu"):
        wd = tmp_path / device
        RufusPipeline(RufusConfig(
            subject=bams["child"], controls=[bams["mother"], bams["father"]],
            k=25, workdir=str(wd), exome=True, min_cov=5,
            stop_after="filter", single_end=single_end, batch_size=1024,
            device=device)).run()
        outs[device] = wd
    names = sorted(n for n in os.listdir(outs["cpu"])
                   if os.path.isfile(outs["cpu"] / n))
    assert any(n.endswith(".Mutations.fastq" if single_end
                          else ".Mutations.Mate1.fastq") for n in names)
    assert names == sorted(n for n in os.listdir(outs["cuda"])
                           if os.path.isfile(outs["cuda"] / n))
    for n in names:
        if n.endswith(".npz"):
            za, zb = np.load(outs["cuda"] / n), np.load(outs["cpu"] / n)
            for key in zb.files:
                np.testing.assert_array_equal(za[key], zb[key])
        else:
            assert (outs["cuda"] / n).read_bytes() == \
                (outs["cpu"] / n).read_bytes(), n


def test_native_decoder_builds_and_loads(tmp_path):
    """The host decoders build from the package's sources on the card's
    machine and decode a BAM as the Python reader does."""
    _card()
    from rufus_tpu_torch.io import bam, native
    from rufus_tpu_torch.ops import _build

    so = _build.build_native()
    assert os.path.exists(so) and so.startswith(_build.BUILD_ROOT)
    data = synthetic.write_trio(str(tmp_path / "fastq"), genome_bp=5_000,
                                coverage=10, n_denovo=2, seed=4)
    path = synthetic.write_trio_bams(data, str(tmp_path / "bam"))["father"]
    with native.NativeBam(path) as nb:
        names, s1, q1, l1, s2, q2, l2 = nb.read_pair_batch(10_000, 160)
    want = list(bam.bam_to_paired_fastq(path))
    assert list(names) == [w[0] for w in want]
    assert [s1[i, :l1[i]].tobytes().decode() for i in range(len(names))] == \
        [w[1] for w in want]


_SCORES = {"default": (1, -4, 6, 1), "mob": (1, -4, 6, 0)}


def _sw_inputs(rng, B, n, m, fill):
    """(B, n) queries and (B, m) windows of codes 0-3 / 255: random with 2%
    N, every other window holding its query (so scores are large and
    tie), or all N."""
    q = rng.integers(0, 4, (B, n)).astype(np.uint8)
    r = rng.integers(0, 4, (B, m)).astype(np.uint8)
    q[rng.random((B, n)) < 0.02] = 255
    r[rng.random((B, m)) < 0.02] = 255
    if fill == "copies" and m >= n:
        for b in range(0, B, 2):
            for at in range(0, m - n + 1, max(n, 1) + 7):
                r[b, at:at + n] = q[b]
    if fill == "all_n":
        q[:] = 255
    if fill == "pad":
        q[1::2, n // 2:] = 255
    return q, r


@pytest.mark.parametrize("scoring", ["default", "mob"])
@pytest.mark.parametrize("B,n,m,fill", [
    (256, 160, 288, "random"), (256, 160, 288, "copies"),
    (64, 160, 288, "pad"), (8, 160, 288, "all_n"),
    (33, 64, 1023, "copies"),   # 16 columns a lane, two tiles
    (17, 600, 1100, "copies"),  # three tiles, 35 KB of shared memory
    (5, 900, 4000, "random"),   # eight tiles, 42 KB of shared memory
    (4, 300, 5500, "copies"),   # past 48 KB of shared memory
    (4, 300, 6000, "copies"),
    (3, 40, 20000, "copies"),   # 200 KB of shared memory
    (2, 30, 24000, "copies"),   # rows past shared memory: the workspace
    (2, 0, 40, "random"),       # no query rows: H is row 0
    (1, 1, 1, "random"),
])
def test_sw_batch_kernel(scoring, B, n, m, fill):
    dev = _card()
    rng = np.random.default_rng(B * 1000 + m)
    q, r = _sw_inputs(rng, B, n, m, fill)
    qt, rt = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
    before = cuda_sw.sw_batch.launches
    got = cuda_sw.sw_batch(qt, rt, *_SCORES[scoring])
    torch.cuda.synchronize()
    assert cuda_sw.sw_batch.launches == before + 1
    want = cuda_sw.sw_batch_torch(qt, rt, *_SCORES[scoring])
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    if fill == "all_n":
        assert not bool(got[0].any())
        assert not bool(torch.stack(got[1:]).any())  # (0, 0, 0)


def _ragged_inputs(rng, shapes, fill):
    """A ragged batch: pairs of the given (n, m), codes as _sw_inputs, packed
    as sw_device.sw_align packs them (largest n*m first)."""
    shapes = sorted(shapes, key=lambda s: -s[0] * s[1])
    qs, rs = [], []
    for n, m in shapes:
        q, r = _sw_inputs(rng, 1, n, m, fill)
        qs.append(q[0])
        rs.append(r[0])
    n = np.array([s[0] for s in shapes], np.int64)
    m = np.array([s[1] for s in shapes], np.int64)
    codes = np.concatenate(qs + rs + [np.empty(0, np.uint8)])
    return (codes, cuda_sw.offsets(n), n, int(n.sum()) + cuda_sw.offsets(m),
            m)


_RAGGED = {
    # the read path: 150 bp reads (some shorter) and their windows
    "reads": lambda rng: [(int(L), int(L) + 128) for L in
                          rng.choice([150, 150, 150, 143, 101], 256)],
    "contig_largest": lambda rng: [(864, 992)],
    "wide": lambda rng: [(40, 20000), (30, 19000), (12, 700)],
    "widest": lambda rng: [(20, 24000), (9, 30)],  # the workspace
    "mixed": lambda rng: [(int(a), int(a) + int(b)) for a, b in zip(
        rng.integers(0, 900, 40), rng.integers(1, 300, 40))] + [(1, 1)],
    "tiny": lambda rng: [(0, 5), (3, 1), (2, 2), (31, 120)],
}


@pytest.mark.parametrize("scoring", ["default", "mob"])
@pytest.mark.parametrize("case", list(_RAGGED))
@pytest.mark.parametrize("fill", ["copies", "random"])
def test_sw_ragged_kernel(scoring, case, fill):
    """The fused DP and traceback against its plain version: every result
    field and every op, byte for byte (the zeroed tail included)."""
    dev = _card()
    rng = np.random.default_rng(len(case) * 100 + len(fill))
    codes, qoff, n, roff, m = _ragged_inputs(rng, _RAGGED[case](rng), fill)
    c = torch.from_numpy(codes).to(dev)
    gap_max = 128 if scoring == "default" else 1000
    before = cuda_sw.sw_ragged.launches
    got = cuda_sw.sw_ragged(c, qoff, n, roff, m, *_SCORES[scoring], gap_max)
    torch.cuda.synchronize()
    assert cuda_sw.sw_ragged.launches == before + 1
    want = cuda_sw.sw_ragged_torch(c, qoff, n, roff, m, *_SCORES[scoring],
                                   gap_max)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    res = cuda_sw.unpack(got, len(n))[0]
    if fill == "copies" and case != "tiny":
        assert int(res[:, 6].max()) > 0  # walks were taken


@pytest.mark.parametrize("single_end", [False, True])
def test_contig_slice_on_card_equals_slice_on_cpu(tmp_path, single_end):
    """The trio through contig alignment (paired from FASTQ, single-end
    from the child BAM) on the card and on the CPU: every file and the
    returned SAM lines; the card run's candidate DPs go through the
    kernel."""
    _card()
    data = synthetic.write_trio(str(tmp_path / "fastq"), genome_bp=20_000,
                                coverage=30, n_denovo=4, seed=3)
    ref = tmp_path / "ref.fa"
    ref.write_text(f">{synthetic.REF_NAME}\n"
                   + data["genome"].tobytes().decode() + "\n")
    if single_end:
        bams = synthetic.write_trio_bams(data, str(tmp_path / "bam"), seed=3)
        kw = dict(subject=bams["child"],
                  controls=[bams["mother"], bams["father"]], single_end=True)
    else:
        c, m, f = data["child"], data["mother"], data["father"]
        kw = dict(subject=",".join(c), controls=[",".join(m), ",".join(f)],
                  fastq_a=c[0], fastq_b=c[1])
    outs, lines = {}, {}
    for device in ("cuda", "cpu"):
        wd = tmp_path / device
        before = cuda_sw.sw_ragged.launches
        res = RufusPipeline(RufusConfig(
            k=25, workdir=str(wd), exome=True, min_cov=5, ref=str(ref),
            stop_after="contig_align", batch_size=1024, device=device,
            **kw)).run()
        launches = cuda_sw.sw_ragged.launches - before
        assert (launches > 0) == (device == "cuda")
        outs[device], lines[device] = wd, res["stdin_lines"]
    assert lines["cuda"] == lines["cpu"] and lines["cpu"]
    names = sorted(os.path.relpath(os.path.join(r, n), outs["cpu"])
                   for r, _, ns in os.walk(outs["cpu"]) for n in ns
                   if n != "trace.jsonl")
    assert names == sorted(os.path.relpath(os.path.join(r, n), outs["cuda"])
                           for r, _, ns in os.walk(outs["cuda"]) for n in ns
                           if n != "trace.jsonl")
    for n in names:
        if n.endswith(".npz"):
            za, zb = np.load(outs["cuda"] / n), np.load(outs["cpu"] / n)
            for key in zb.files:
                np.testing.assert_array_equal(za[key], zb[key])
        else:
            assert (outs["cuda"] / n).read_bytes() == \
                (outs["cpu"] / n).read_bytes(), n


@pytest.mark.parametrize("single_end", [False, True])
def test_full_run_on_card_equals_full_run_on_cpu(tmp_path, monkeypatch,
                                                 single_end):
    """The trio to FINAL.vcf, .vcf.gz and .tbi (paired from FASTQ, single-end
    from the child BAM; reference contig "1", mosaic rows kept) on the card
    and on the CPU: every file and the returned path. The VCF header holds
    the workdir's path and the interpret date, so both runs use one
    directory in turn and the date is pinned."""
    import types

    import rufus_tpu_torch.interpret.driver as interpret_driver

    _card()
    monkeypatch.setattr(interpret_driver, "time",
                        types.SimpleNamespace(time=lambda: 1700000000))
    data = synthetic.write_trio(str(tmp_path / "fastq"), genome_bp=20_000,
                                coverage=30, n_denovo=4, seed=3)
    ref = tmp_path / "ref.fa"
    ref.write_text(">1\n" + data["genome"].tobytes().decode() + "\n")
    if single_end:
        bams = synthetic.write_trio_bams(data, str(tmp_path / "bam"), seed=3)
        kw = dict(subject=bams["child"],
                  controls=[bams["mother"], bams["father"]], single_end=True)
    else:
        c, m, f = data["child"], data["mother"], data["father"]
        kw = dict(subject=",".join(c), controls=[",".join(m), ",".join(f)],
                  fastq_a=c[0], fastq_b=c[1])
    work = tmp_path / "work"
    outs, finals = {}, {}
    for device in ("cuda", "cpu"):
        before = cuda_sw.sw_ragged.launches
        finals[device] = RufusPipeline(RufusConfig(
            k=25, workdir=str(work), exome=True, min_cov=5, ref=str(ref),
            mosaic=True, batch_size=1024, device=device, **kw)).run()
        assert (cuda_sw.sw_ragged.launches > before) == (device == "cuda")
        outs[device] = tmp_path / device
        os.rename(work, outs[device])
    assert finals["cuda"] == finals["cpu"]
    names = sorted(os.path.relpath(os.path.join(r, n), outs["cpu"])
                   for r, _, ns in os.walk(outs["cpu"]) for n in ns
                   if n != "trace.jsonl")
    assert names == sorted(os.path.relpath(os.path.join(r, n), outs["cuda"])
                           for r, _, ns in os.walk(outs["cuda"]) for n in ns
                           if n != "trace.jsonl")
    for n in names:
        if n.endswith(".npz"):
            za, zb = np.load(outs["cuda"] / n), np.load(outs["cpu"] / n)
            for key in zb.files:
                np.testing.assert_array_equal(za[key], zb[key])
        else:
            assert (outs["cuda"] / n).read_bytes() == \
                (outs["cpu"] / n).read_bytes(), n
    vcf = outs["cpu"] / os.path.basename(finals["cpu"])[:-len(".FINAL.vcf")]
    with open(str(vcf) + ".vcf") as f:
        assert any(not line.startswith("#") for line in f)
    assert (outs["cpu"] / (os.path.basename(finals["cpu"]) + ".gz.tbi")
            ).exists()


# -- the memory model -----------------------------------------------------------


def _flat_runs(tmp_path, n_runs, n, seed):
    """Overlapping sorted unique flat runs of n random k = 25 keys."""
    from rufus_tpu_torch.ops import count

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_runs):
        keys = np.unique(rng.integers(0, 1 << 50, n).astype(np.uint64))
        paths.append(str(tmp_path / f"run{i}"))
        count.KmerTable(25, keys, rng.integers(1, 9, len(keys))
                        .astype(np.int64)).save_flat(paths[-1])
    return paths


@pytest.mark.parametrize("lower", [0, 2])
def test_merge_chunk_on_card_equals_cpu(tmp_path, lower):
    """merge_flat_runs' merge-sum on the card (stable sort and the counted
    compact_runs) writes the bytes of the plain version, chunks across
    tiles and runs of unequal reach."""
    from rufus_tpu_torch.ops import count

    dev = _card()
    runs = _flat_runs(tmp_path, 4, 3_000_000, 7)
    before = cuda_fold.compact_runs.launches
    for device, name in ((dev, "cuda"), ("cpu", "cpu")):
        count.merge_flat_runs(runs, str(tmp_path / name), lower_count=lower,
                              chunk=1 << 20, device=device)
    assert cuda_fold.compact_runs.launches > before
    assert (tmp_path / "cuda").read_bytes() == (tmp_path / "cpu").read_bytes()


def test_subtract_chunk_on_card_equals_cpu(tmp_path):
    """subtract_unique_stream with each chunk's searches on the card equals
    the plain version, the controls memmapped."""
    from rufus_tpu_torch.ops import count

    dev = _card()
    tables = [count.KmerTable.load_flat(p)
              for p in _flat_runs(tmp_path, 3, 2_000_000, 8)]
    for chunk in (1 << 16, 1 << 24):
        got = count.subtract_unique_stream(tables, 2, 3, 6, chunk=chunk,
                                           device=dev)
        want = count.subtract_unique_stream(tables, 2, 3, 6, chunk=chunk)
        assert len(want[0]) > 0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _large_runs(rng):
    """The fold's merge at the cells' scale: a table of 10 M keys and a
    run of 4 M, a third of them in the table."""
    a = np.unique(rng.integers(0, 1 << 50, 10_000_000))
    b = np.unique(np.concatenate([rng.choice(a, 4_000_000 // 3, replace=False),
                                  rng.integers(0, 1 << 50, 4_000_000
                                               - 4_000_000 // 3)]))
    return (a, rng.integers(1, 1000, len(a)), b,
            rng.integers(1, 1000, len(b)))


@pytest.mark.parametrize("case", CASES + ["large"])
def test_merge_runs_kernel(case):
    """merge_runs on the card equals merge_runs_torch (and numpy's union
    and sum) on the CPU tests' runs, shared keys across every tile's and
    thread's cut among them, and at 10 M + 4 M keys."""
    dev = _card()
    a, ca, b, cb = (_large_runs(np.random.default_rng(19)) if case == "large"
                    else runs(case))
    host = [torch.from_numpy(np.asarray(x, np.int64)) for x in (a, ca, b, cb)]
    before = cuda_merge.merge_runs.launches
    got = cuda_merge.merge_runs(*(t.to(dev) for t in host))
    torch.cuda.synchronize()
    assert cuda_merge.merge_runs.launches == before + 1
    want = cuda_merge.merge_runs_torch(*host)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    if case != "large":
        np.testing.assert_array_equal(got[0].cpu().numpy(),
                                      union_sum(*map(np.asarray, host))[0])


def test_resident_count_peak_is_its_table_and_one_batch(tmp_path):
    """A resident count of a 200 kbp trio on the card folds each batch as it
    comes, through merge_runs: every sample's device peak over its count,
    beside the tables already counted, stays under its table and one
    batch's fold (the larger of the batch's sort and the linear merge of
    the table and the batch), which a pending buffer of many batches
    would pass."""
    from rufus_tpu_torch.ops import table as ptable

    dev = _card()
    data = synthetic.write_trio(str(tmp_path / "fastq"), genome_bp=200_000,
                                coverage=30, n_denovo=20, seed=1)
    c, m, f = data["child"], data["mother"], data["father"]
    batch = 4096  # ten batches a sample
    cfg = RufusConfig(subject=",".join(c), controls=[",".join(m), ",".join(f)],
                      k=25, workdir=str(tmp_path / "wd"), exome=True,
                      min_cov=5, stop_after="filter", fastq_a=c[0],
                      fastq_b=c[1], device="cuda", batch_size=batch)
    pipe = RufusPipeline(cfg)
    one = batch * (cfg.read_pad - cfg.k + 1)
    before = cuda_merge.merge_runs.launches
    samples = [(cfg.subject, cfg.subject_stub)] + [
        (ctl, cfg.control_stub(ctl)) for ctl in cfg.controls]
    for path, stub in samples:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        n = len(pipe.count_sample(path, stub, lower=1))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        bound = ptable.TABLE_BYTES * n + max(
            ptable.PENDING_BYTES * one, ptable.RUN_MERGE_BYTES * (n + one))
        assert peak <= bound, (stub, peak, bound)
        # the table stays under four batches: each batch folds alone
        assert n < 4 * one and pipe._folds[stub] == 10
        assert pipe._fold_keys_max[stub] == one
    assert cuda_merge.merge_runs.launches > before


def test_table_under_a_budget_on_card(tmp_path):
    """A DeviceKmerTable on the card with a budget a quarter of the
    unconstrained table's folds: it spills, the merged runs equal the
    unconstrained table, and max_memory_allocated over the folds stays
    within the budget."""
    from rufus_tpu_torch.ops import count, table as ptable

    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(9)
    batches = [torch.randint(0, 1 << 26, (1 << 21,), generator=g)
               for _ in range(12)]
    plain = ptable.DeviceKmerTable(25, dev)
    for b in batches:
        plain.fold_batch(b.to(dev))
    want = plain.to_host()
    plain.release()
    runs = []

    def spill(t):
        runs.append(str(tmp_path / f"run{len(runs)}"))
        t.to_flat(runs[-1])
        t.reset()

    budget = 8 * ptable.RUN_MERGE_BYTES * (1 << 21)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = ptable.DeviceKmerTable(25, dev, budget=budget, spill=spill)
    for b in batches:
        t.fold_batch(b.to(dev))
    runs.append(str(tmp_path / "last"))
    t.to_flat(runs[-1])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    t.release()
    assert t.spills >= 1
    assert peak <= budget, (peak, budget)
    got = count.merge_flat_runs(runs, str(tmp_path / "merged"), device=dev)
    np.testing.assert_array_equal(np.asarray(got.keys), want.keys)
    np.testing.assert_array_equal(np.asarray(got.counts), want.counts)


@pytest.mark.parametrize("mode", ["lsm", "multipass"])
def test_spilled_slice_on_card_equals_resident_slice_on_cpu(tmp_path, mode):
    """The trio through the filter with spilled tables (LSM runs under a
    small budget, or count_passes 3) on the card: its flat tables hold the
    resident CPU run's tables, and every other file is byte-equal."""
    _card()
    data = synthetic.write_trio(str(tmp_path / "fastq"), genome_bp=200_000,
                                coverage=30, n_denovo=20, seed=1)
    c, m, f = data["child"], data["mother"], data["father"]
    from rufus_tpu_torch.ops import table

    # the least budget that holds a 512-read batch, and 5% more
    budget = 1.05 * 512 * (160 - 25 + 1) * table.CAP_BYTES
    over = {"lsm": dict(spill_tables="on", hbm_budget_gb=budget / 2**30,
                        batch_size=512),
            "multipass": dict(count_passes=3, sharded="off")}[mode]
    outs = {}
    for device, kw in (("cuda", over), ("cpu", {})):
        wd = tmp_path / device
        pipe = RufusPipeline(RufusConfig(
            subject=",".join(c), controls=[",".join(m), ",".join(f)], k=25,
            workdir=str(wd), exome=True, min_cov=5, stop_after="filter",
            fastq_a=c[0], fastq_b=c[1], device=device,
            **{"batch_size": 8192, **kw}))
        pipe.run()
        if device == "cuda" and mode == "lsm":
            assert min(pipe._runs.values()) >= 2
        outs[device] = wd
    from rufus_tpu_torch.ops import count

    names = sorted(n for n in os.listdir(outs["cpu"])
                   if os.path.isfile(outs["cpu"] / n))
    for n in names:
        if n.endswith(".table.npz"):
            t = count.KmerTable.load_flat(
                str(outs["cuda"] / n.replace(".npz", ".flat")))
            z = np.load(outs["cpu"] / n)
            np.testing.assert_array_equal(t.keys, z["keys"])
            np.testing.assert_array_equal(t.counts, z["counts"])
        else:
            assert (outs["cuda"] / n).read_bytes() == \
                (outs["cpu"] / n).read_bytes(), n


# -- the sharded chain -----------------------------------------------------


@pytest.mark.parametrize("layout", ["one_card", "every_card"])
def test_sharded_full_run_on_card_equals_cpu(tmp_path, monkeypatch, layout):
    """The trio to FINAL.vcf on four shards of cuda:0, or on a shard a card
    over every card (two or more), against the 1-shard run on the CPU:
    every file but the trace, byte for byte (one directory in turn, the
    interpret date pinned)."""
    import types

    import rufus_tpu_torch.interpret.driver as interpret_driver
    from rufus_tpu_torch.parallel import make_mesh

    _card()
    if layout == "one_card":
        mesh = make_mesh(4, "cuda:0")
    elif torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    else:
        mesh = make_mesh()
    monkeypatch.setattr(interpret_driver, "time",
                        types.SimpleNamespace(time=lambda: 1700000000))
    data = synthetic.write_trio(str(tmp_path / "fastq"), genome_bp=20_000,
                                coverage=30, n_denovo=4, seed=3)
    ref = tmp_path / "ref.fa"
    ref.write_text(">1\n" + data["genome"].tobytes().decode() + "\n")
    c, m, f = data["child"], data["mother"], data["father"]
    work = tmp_path / "work"
    launches = cuda_filter.window_hits.launches
    for device, mesh_ in (("cuda", mesh), ("cpu", None)):
        pipe = RufusPipeline(RufusConfig(
            subject=",".join(c), controls=[",".join(m), ",".join(f)], k=25,
            workdir=str(work), exome=True, min_cov=5, ref=str(ref),
            fastq_a=c[0], fastq_b=c[1], batch_size=1024, device=device),
            mesh=mesh_)
        pipe.run()
        if device == "cuda":
            count_rec = pipe.trace.stages[0]
        os.rename(work, tmp_path / device)
    assert count_rec["shards"] == mesh.n
    assert all(v > 0 for v in count_rec["exchanged_keys"].values())
    assert cuda_filter.window_hits.launches > launches
    cuda, cpu = tmp_path / "cuda", tmp_path / "cpu"
    names = sorted(os.path.relpath(os.path.join(r, n), cpu)
                   for r, _, ns in os.walk(cpu) for n in ns
                   if n != "trace.jsonl")
    assert names == sorted(os.path.relpath(os.path.join(r, n), cuda)
                           for r, _, ns in os.walk(cuda) for n in ns
                           if n != "trace.jsonl")
    assert any(n.endswith(".FINAL.vcf") for n in names)
    for n in names:
        if n.endswith(".npz"):
            za, zb = np.load(cuda / n), np.load(cpu / n)
            for key in zb.files:
                np.testing.assert_array_equal(za[key], zb[key])
        else:
            assert (cuda / n).read_bytes() == (cpu / n).read_bytes(), n


# -- the process mesh -------------------------------------------------------


def _chain_inputs(seed=10, batches=6, B=96, L=100):
    """run_chain's arguments: reads of a 20 kbp genome (the child's with 8
    SNVs), substitutions, N bases, low qualities, lengths 60-100, as
    tests/test_torch_sharded.py makes them; queries present and absent."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.choice(bases, 20_000)
    child = genome.copy()
    sites = rng.choice(len(genome), 8, replace=False)
    child[sites] = bases[(np.searchsorted(bases, child[sites]) + 1) % 4]

    def reads(g):
        n = batches * B
        r = g[rng.integers(0, len(g) - L, n)[:, None] + np.arange(L)]
        r[rng.random(r.shape) < 0.005] = ord("N")
        q = np.full(r.shape, ord("I"), np.uint8)
        q[rng.random(r.shape) < 0.02] = ord("#")
        lens = rng.integers(60, L + 1, n).astype(np.int32)
        r[np.arange(L)[None, :] >= lens[:, None]] = ord("N")
        return r.astype(np.uint8), q, lens

    samples = {"child": reads(child), "mother": reads(genome)[0],
               "father": reads(genome)[0]}
    win = cuda_count.encode_canon_torch(torch.from_numpy(
        samples["child"][0][:B]), 25).reshape(-1)
    present = codec.keys_i64_to_u64(
        torch.unique(win[win != codec.SENTINEL]).numpy()[::7])
    queries = rng.permutation(np.concatenate([
        present, rng.integers(0, 1 << 50, 100, dtype=np.uint64)]))[:301]
    return (samples, 25, B, queries, 2, 2, 2, 1000, 15, 1)


def _assert_rank_equals(rank_out, single, mesh, n_rows, B):
    """A rank's run_chain arrays against the single-process run's: the
    whole tables and HashLists, and its rows of the keep masks and
    pulls."""
    from rufus_tpu_torch.parallel import local_rows

    for key, want in single.items():
        got = rank_out[key]
        if key == "keep":
            want = np.concatenate([local_rows(mesh, want[i:i + B])
                                   for i in range(0, n_rows, B)])
        elif key == "pulls":
            want = want[:, local_rows(mesh, np.arange(want.shape[1]))]
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("layout", ["one_card", "every_card"])
def test_process_mesh_on_card_equals_cpu(layout):
    """NCCL ranks spawned on the card(s), the group through a file store:
    one rank holding four shards of cuda:0, or a rank a card (two or more)
    holding two shards each. Each rank's tables, splitters, HashList, keep
    masks of its rows and pulls of its queries equal the single-process
    CPU mesh's."""
    from rufus_tpu_torch.parallel import ShardMesh, make_mesh
    from rufus_tpu_torch.tools.multiproc_smoke import run_chain, spawn_ranks

    _card()
    world = 1 if layout == "one_card" else torch.cuda.device_count()
    if layout == "every_card" and world < 2:
        pytest.skip("needs two CUDA devices or more")
    local = 4 if world == 1 else 2
    args = _chain_inputs()
    runs = spawn_ranks(run_chain, world, "cuda", local, args, timeout=600)
    single = run_chain(make_mesh(world * local, "cpu"), *args)
    rows = len(args[0]["child"][0])
    for rank, out in enumerate(runs):
        mesh = ShardMesh((torch.device("cpu"),) * local, rank=rank,
                         world=world)
        _assert_rank_equals(out, single, mesh, rows, args[2])


def _packed_planes(rng, B, L):
    """Reads with N, lowercase and IUPAC bases and quals, packed."""
    from rufus_tpu_torch.ops import pack

    reads = rng.choice(np.frombuffer(b"ACGTNacgtnRYKM", np.uint8),
                       size=(B, L)).astype(np.uint8)
    quals = rng.integers(33, 75, size=(B, L)).astype(np.uint8)
    pk, nm = pack.pack_reads(reads)
    return pk, nm, pack.pack_qual_ok(quals, 15)


@pytest.mark.parametrize("L", [1, 7, 150, 151, 152, 160])
def test_unpack_kernel(L):
    """The unpack kernel equals its plain versions, each plane alone and
    both from one launch, on a batch whose span does not end on a 16-byte
    group (B odd)."""
    from rufus_tpu_torch.ops import cuda_pack

    dev = _card()
    pk, nm, ok = (torch.from_numpy(a).to(dev)
                  for a in _packed_planes(np.random.default_rng(L), 1001, L))
    want_r = cuda_pack.unpack_reads_torch(pk, nm, L)
    want_q = cuda_pack.unpack_qual_torch(ok, L)
    before = cuda_pack.unpack.launches
    r, q = cuda_pack.unpack(pk, nm, ok, L)
    assert cuda_pack.unpack.launches == before + 1
    assert torch.equal(r, want_r) and torch.equal(q, want_q)
    assert torch.equal(cuda_pack.unpack(pk, nm, None, L)[0], want_r)
    assert torch.equal(cuda_pack.unpack(None, None, ok, L)[1], want_q)
    torch.cuda.synchronize()


def test_unpack_kernel_refuses_malformed_planes():
    from rufus_tpu_torch.ops import cuda_pack

    dev = _card()
    pk, nm, ok = (torch.from_numpy(a).to(dev)
                  for a in _packed_planes(np.random.default_rng(0), 64, 150))
    with pytest.raises(ValueError):  # a row too short for L
        cuda_pack.unpack(pk, nm, None, 160)
    with pytest.raises(ValueError):  # rows that disagree
        cuda_pack.unpack(pk, nm[:10], None, 150)
    with pytest.raises(TypeError):
        cuda_pack.unpack(pk.to(torch.int32), nm, None, 150)
    with pytest.raises(ValueError):  # planes on two devices
        cuda_pack.unpack(pk, nm.cpu(), None, 150)
    with pytest.raises(ValueError):  # not contiguous
        wide = torch.zeros((64, 2 * pk.shape[1]), dtype=torch.uint8,
                           device=dev)
        cuda_pack.unpack(wide[:, ::2], nm, None, 150)
