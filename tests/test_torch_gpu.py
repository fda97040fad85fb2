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

from rufus_tpu_torch import synthetic
from rufus_tpu_torch.ops import (codec, cuda_count, cuda_filter, cuda_fold,
                                 cuda_partition)
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


@pytest.mark.parametrize("B,L,k", [(4096, 160, 25), (1000, 160, 31),
                                   (777, 1024, 11), (3, 30, 25)])
def test_encode_canon_kernel(B, L, k):
    dev = _card()
    reads, *_ = _reads(np.random.default_rng(B), B, L, k)
    r = torch.from_numpy(reads).to(dev)
    got = cuda_count.encode_canon(r, k)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_count.encode_canon_torch(r, k))


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 100_003, 3_000_000])
def test_compact_runs_kernel(n):
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(n)
    keys = torch.randint(0, max(1, n // 3), (n,), generator=g)
    keys[torch.rand(n, generator=g) < 0.1] = codec.SENTINEL
    s = torch.sort(keys).values.to(dev)
    c32 = torch.randint(1, 50, (n,), generator=g, dtype=torch.int32).to(dev)
    for c in (None, c32, c32.to(torch.int64)):
        got = cuda_fold.compact_runs(s, c)
        want = cuda_fold.compact_runs_torch(s, c)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


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
