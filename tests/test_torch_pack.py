"""Packed transport (rufus_tpu_torch/ops/pack.py and the unpack kernel's
plain versions) against the JAX package's ops/pack.py on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rufus_tpu.ops import pack as jpack
from rufus_tpu_torch.ops import cuda_pack, pack

LENGTHS = [1, 7, 150, 151, 152, 160]
# N, lowercase and IUPAC codes beside ACGT
ALPHABET = np.frombuffer(b"ACGTNacgtnRYKMSWBDHVX-", np.uint8)


def _reads(L, B=37, seed=0):
    rng = np.random.default_rng(seed + L)
    return rng.choice(ALPHABET, size=(B, L)).astype(np.uint8)


def _quals(L, B=37, seed=0):
    rng = np.random.default_rng(seed + 1000 + L)
    return rng.integers(33, 33 + 45, size=(B, L)).astype(np.uint8)


@pytest.mark.parametrize("L", LENGTHS)
def test_pack_bytes_equal_jax(L):
    reads, quals = _reads(L), _quals(L)
    pk, nm = pack.pack_reads(reads)
    jpk, jnm = jpack.pack_reads(reads)
    assert pk.dtype == jpk.dtype == np.uint8
    np.testing.assert_array_equal(pk, jpk)
    np.testing.assert_array_equal(nm, jnm)
    assert pk.shape == (37, -(-L // 4)) and nm.shape == (37, -(-L // 8))
    for min_q in (0, 15, 30):
        np.testing.assert_array_equal(pack.pack_qual_ok(quals, min_q),
                                      jpack.pack_qual_ok(quals, min_q))


@pytest.mark.parametrize("L", LENGTHS)
def test_unpack_reads_equals_jax(L):
    reads = _reads(L)
    pk, nm = pack.pack_reads(reads)
    want = np.asarray(jax.jit(
        lambda p, m: jpack.unpack_reads_device(p, m, L))(
            jnp.asarray(pk), jnp.asarray(nm)))
    got = cuda_pack.unpack_reads_torch(torch.from_numpy(pk),
                                       torch.from_numpy(nm), L)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        pack.unpack_reads(torch.from_numpy(pk), torch.from_numpy(nm),
                          L).numpy(), want)
    # N, IUPAC and others come back 'N'; lowercase comes back uppercase
    up = reads & 0xDF
    acgt = np.isin(up, np.frombuffer(b"ACGT", np.uint8))
    np.testing.assert_array_equal(want, np.where(acgt, up, ord("N")))


@pytest.mark.parametrize("L", LENGTHS)
def test_unpack_qual_equals_jax(L):
    quals = _quals(L)
    # the two levels ('#' 2, 'I' 40) threshold as the original for
    # 2 < min_q <= 40, the filter's range
    for min_q in (3, 15, 20, 40):
        ok = pack.pack_qual_ok(quals, min_q)
        want = np.asarray(jax.jit(
            lambda m: jpack.unpack_qual_device(m, L))(jnp.asarray(ok)))
        got = pack.unpack_qual(torch.from_numpy(ok), L).numpy()
        np.testing.assert_array_equal(got, want)
        # the rebuilt plane thresholds as the original at min_q
        np.testing.assert_array_equal(got >= 33 + min_q,
                                      quals >= 33 + min_q)


@pytest.mark.parametrize("L", [7, 151])
def test_unpack_gives_both_planes(L):
    reads, quals = _reads(L), _quals(L)
    _, planes = pack.pack_batch(reads, quals, 15)
    r, q = pack.unpack(*planes, L)
    assert torch.equal(r, cuda_pack.unpack_reads_torch(*planes[:2], L))
    assert torch.equal(q, cuda_pack.unpack_qual_torch(planes[2], L))
    assert pack.unpack(*planes[:2], None, L)[1] is None


def test_packed_count_equals_text_count():
    """The count over unpacked reads equals the count over the ASCII batch
    (the port's plain encode_canon and fold), and the JAX package's count
    of the same reads."""
    from rufus_tpu.ops import count as jcount
    from rufus_tpu_torch.ops import codec, count
    from rufus_tpu_torch.ops.table import count_step

    rng = np.random.default_rng(2)
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(64, 80))
    reads[rng.random(reads.shape) < 0.02] = ord("N")
    reads[rng.random(reads.shape) < 0.05] |= 0x20  # lowercase
    reads = reads.astype(np.uint8)
    k = 13
    pk, nm = pack.pack_reads(reads)
    unpacked = pack.unpack_reads(torch.from_numpy(pk), torch.from_numpy(nm),
                                 80)
    a = count.count_batch(count_step(torch.from_numpy(reads), k))
    b = count.count_batch(count_step(unpacked, k))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    jk, jc, _ = (np.asarray(a) for a in
                 jcount.count_reads_batch(jnp.asarray(reads), k))
    heads = jk != codec.SENTINEL_U64  # its output is not compacted
    np.testing.assert_array_equal(codec.keys_i64_to_u64(b[0].numpy()),
                                  jk[heads])
    np.testing.assert_array_equal(b[1].numpy(), jc[heads])


def test_packed_feed_on_the_cpu():
    """packed_feed yields each batch unpacked, in order, with or without
    the qual plane."""
    batches = [(_reads(L, 9, s), _quals(L, 9, s))
               for s, L in ((0, 151), (1, 151), (2, 7))]
    for min_q in (None, 15):
        got = list(pack.packed_feed(
            (pack.pack_batch(r, q, min_q) for r, q in batches), "cpu"))
        assert len(got) == len(batches)
        for (r, q), (gr, gq) in zip(batches, got):
            up = r & 0xDF
            want = np.where(np.isin(up, np.frombuffer(b"ACGT", np.uint8)),
                            up, ord("N"))
            np.testing.assert_array_equal(gr.numpy(), want)
            if min_q is None:
                assert gq is None
            else:
                np.testing.assert_array_equal(
                    gq.numpy() >= 33 + min_q, q >= 33 + min_q)


@pytest.mark.parametrize("bad", ["short_row", "rows", "dtype", "dims",
                                 "alone", "empty", "L0"])
def test_unpack_refuses_malformed_planes(bad):
    pk, nm = (torch.from_numpy(a) for a in pack.pack_reads(_reads(150)))
    ok = torch.from_numpy(pack.pack_qual_ok(_quals(150), 15))
    args = {"short_row": (pk, nm, None, 160), "rows": (pk, nm[:5], None, 150),
            "dtype": (pk.to(torch.int32), nm, None, 150),
            "dims": (pk.reshape(-1), nm, None, 150),
            "alone": (pk, None, ok, 150), "empty": (None, None, None, 150),
            "L0": (pk, nm, None, 0)}[bad]
    with pytest.raises((TypeError, ValueError)):
        cuda_pack.unpack(*args)


def test_unpack_on_another_device_raises():
    """No fallback: planes that are not on the CPU go to the kernel, and a
    device the kernel does not serve raises."""
    pk, nm = (torch.empty((4, w), dtype=torch.uint8, device="meta")
              for w in (38, 19))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_pack.unpack(pk, nm, None, 150)
