"""The native BAM decoder (rufus_tpu_torch/native/bamdecode.cpp) on a BAM
whose names, bases and qualities pass 4 GiB: 14,500,000 unmapped 150-base
records, 309 bytes of them each, 4.48 GB in all (3.93 GB of BAM records
inflated). The decoder streams the file a window of BGZF blocks at a time
and keeps no copy of it, whatever its size; every record is read back in
order and must carry its own name, bases and qualities (a 32-bit offset
anywhere in the path would wrap past 4 GiB and read another record's
bytes). It is slow (about 4 minutes on an 8-core host) and the test's own
arrays take about 3 GB of host memory, so it is marked slow and left out of
the tier-1 run; it imports neither JAX nor rufus_tpu:

    python -m pytest -q -p no:cacheprovider --noconftest -m slow tests/test_torch_bam_arena.py
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from rufus_tpu_torch import synthetic
from rufus_tpu_torch.io import bgzf, native

N_RECORDS, L, CHUNK = 14_500_000, 150, 1 << 20
NAME_W = 9  # "r" and 8 digits
BASES = np.frombuffer(b"ACGT", np.uint8)


def _seq(idx):
    """Record i's bases: its index in base 4 (16 digits), repeated."""
    j = np.arange(L)
    return BASES[(idx[:, None] >> (2 * (j % 16))) & 3]


def _qual(idx):
    return (33 + (idx[:, None] + np.arange(L)) % 41).astype(np.uint8)


def _names(idx):
    return np.frombuffer("".join(f"r{i:08d}" for i in idx).encode(),
                         np.uint8).reshape(len(idx), NAME_W)


def _write_bam(path):
    with open(path, "wb") as f, ThreadPoolExecutor(os.cpu_count()) as pool:
        f.write(bgzf._bgzf_block(b"BAM\x01" + bytes(8)))  # no text, no refs
        for start in range(0, N_RECORDS, CHUNK):
            idx = np.arange(start, min(start + CHUNK, N_RECORDS))
            n = len(idx)
            recs = synthetic._encode(
                np.full(n, -1), np.full(n, -1), np.full(n, 4), _names(idx),
                _seq(idx), _qual(idx), None, None, False).reshape(-1)
            view = memoryview(recs)
            for block in pool.map(bgzf._bgzf_block, [
                    view[i:i + bgzf.MAX_BLOCK]
                    for i in range(0, len(recs), bgzf.MAX_BLOCK)]):
                f.write(block)
        f.write(bgzf.BGZF_EOF)


@pytest.mark.slow
def test_arena_past_4gib_reads_every_record(tmp_path):
    path = str(tmp_path / "big.bam")
    _write_bam(path)
    assert N_RECORDS * (NAME_W + 2 * L) > 1 << 32
    with native.NativeBam(path, threads=os.cpu_count()) as nb:
        assert len(nb) == N_RECORDS
        seen = 0
        while True:
            names, seq, qual, lens = nb.read_se_batch(CHUNK, L)
            if len(names) == 0:
                break
            idx = np.arange(seen, seen + len(names))
            np.testing.assert_array_equal(seq, _seq(idx))
            np.testing.assert_array_equal(qual, _qual(idx))
            assert (lens == L).all()
            assert names[0] == f"r{seen:08d}"
            assert names[len(names) - 1] == f"r{idx[-1]:08d}"
            seen += len(names)
    assert seen == N_RECORDS
