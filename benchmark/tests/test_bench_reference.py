"""The plain reference on a tiny hand-checked trio (k = 3)."""

import numpy as np
import torch

from benchmark.reference import kmers


def _reads(*seqs):
    return torch.tensor([list(s.encode()) for s in seqs], dtype=torch.uint8)


def test_count_table_canonical_with_floor():
    # ACGTT: ACG, CGT (rc ACG), GTT (rc AAC); GGGAA's k-mers are seen once
    keys, counts = kmers.count_table(
        [_reads("ACGTT", "ACGTT"), _reads("GGGAA")], 3, 2)
    assert kmers.key_strings(keys, 3) == ["AAC", "ACG"]
    assert counts.tolist() == [2, 4]
    keys, counts = kmers.count_table([_reads("ACGTT", "GGGAA")], 3, 1)
    assert kmers.key_strings(keys, 3) == ["AAC", "ACG", "CCC", "GAA", "GGA"]
    assert counts.tolist() == [1, 2, 1, 1, 1]


def test_windows_with_n_are_skipped():
    keys, counts = kmers.count_table([_reads("ANGTA")], 3, 1)
    assert kmers.key_strings(keys, 3) == ["GTA"]  # rc TAC


def test_histo_rows():
    h = kmers.histo(torch.tensor([2, 4, 4, 20000]))
    assert len(h) == kmers.HISTO_ROWS
    assert h[2] == 1 and h[4] == 2 and h[-1] == 1 and h.sum() == 4


def test_hashlist_range_and_controls():
    subj = (torch.tensor([1, 6, 9]), torch.tensor([2, 4, 50]))
    ctl = (torch.tensor([6]), torch.tensor([3]))
    k, c = kmers.hashlist(subj, [ctl], 1, 2, 10)
    assert k.tolist() == [1] and c.tolist() == [2]
    k, _ = kmers.hashlist(subj, [ctl], 3, 2, 10)  # merge_min above 2
    assert k.numel() == 0
    k, _ = kmers.hashlist(subj, [ctl], 1, 2, 100)
    assert k.tolist() == [1, 9]


def test_hits_quality_and_last_window():
    hl = torch.tensor([1])  # AAC, GTT's canonical key
    seq = _reads("ACGTTA", "ACGTTA", "ACGGTT")
    qual = _reads("IIIIII", "IIII#I", "IIIIII")
    # row 3: GTT ends at the last base, which the filter never scans
    assert kmers.hits(seq, qual, hl, 3, 15).tolist() == [1, 0, 0]
    keep = kmers.filter_pairs(seq, qual, seq[[2, 2, 0]], qual[[2, 2, 0]],
                              hl, 3, 15, 1)
    assert keep.tolist() == [True, False, True]


def test_identity_merges_keys():
    keys, counts = kmers.count_table([_reads("ACGTT", "ACGTT")], 3, 1,
                                     ident=lambda k: k * 0)
    assert keys.tolist() == [1] and counts.tolist() == [6]


def test_key_strings_and_fingerprint():
    assert kmers.key_strings(torch.tensor([0, 27, (1 << 50) - 1]), 25)[1] \
        == "A" * 22 + "CGT"
    fp = kmers.fingerprint(torch.arange(1 << 20, dtype=torch.int64))
    assert int(fp.min()) >= 0 and int(fp.max()) < (1 << 32)
    assert np.unique(fp.numpy()).size > (1 << 20) - 300
