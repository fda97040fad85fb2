"""The comparison's own reader of a sample's table: the flat layout of a
spilled table (``compare.read_flat``) and the choice between it and the
``.table.npz`` (``compare.read_table``)."""

import numpy as np
import pytest

from benchmark.reference import compare
from rufus_tpu_torch.ops.count import KmerTable

STUB = "child.R1.fastq.generator"


def _table(n=1000, k=25):
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 1 << (2 * k), 2 * n, dtype=np.uint64))
    keys = np.concatenate([keys[: n - 1], [np.uint64((1 << 2 * k) - 1)]])
    counts = rng.integers(2, 1 << 40, len(keys), dtype=np.int64)
    return KmerTable(k, keys, counts)


def _assert_table(got, keys, counts):
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64
    assert np.array_equal(got[0], keys) and np.array_equal(got[1], counts)


def _assert_empty(got):
    _assert_table(got, np.empty(0, np.uint64), np.empty(0, np.int64))


def test_a_saved_flat_table_reads_back(tmp_path):
    t = _table()
    t.save_flat(str(tmp_path / "t.flat"))
    got = compare.read_flat(str(tmp_path / "t.flat"))
    _assert_table(got, t.keys, t.counts)
    assert not isinstance(got[0], np.memmap)
    t = KmerTable(25, np.empty(0, np.uint64), np.empty(0, np.int64))
    t.save_flat(str(tmp_path / "e.flat"))
    _assert_empty(compare.read_flat(str(tmp_path / "e.flat")))


@pytest.mark.parametrize("cut", ["magic", "no_header", "short_header",
                                 "short_counts", "short_keys"])
def test_a_malformed_flat_table_reads_empty(tmp_path, cut):
    path = str(tmp_path / "t.flat")
    _table().save_flat(path)
    with open(path, "rb") as f:
        buf = f.read()
    n = (len(buf) - compare.FLAT_HEAD) // 16
    buf = {"magic": b"RTK1" + buf[4:],
           "no_header": buf[:3],
           "short_header": buf[:compare.FLAT_HEAD - 1],
           "short_counts": buf[:-1],
           "short_keys": buf[:compare.FLAT_HEAD + 8 * n - 8]}[cut]
    with open(path, "wb") as f:
        f.write(buf)
    _assert_empty(compare.read_flat(path))


def test_a_sample_table_is_its_flat_or_its_npz(tmp_path):
    wd = str(tmp_path)
    flat, npz = _table(500), _table(300)
    _assert_empty(compare.read_table(wd, STUB))  # neither
    npz.save(f"{wd}/{STUB}.table.npz")
    _assert_table(compare.read_table(wd, STUB), npz.keys, npz.counts)
    flat.save_flat(f"{wd}/{STUB}.table.flat")
    _assert_empty(compare.read_table(wd, STUB))  # both: a fault
    (tmp_path / f"{STUB}.table.npz").unlink()
    _assert_table(compare.read_table(wd, STUB), flat.keys, flat.counts)
