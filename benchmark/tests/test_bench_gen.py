"""The frozen generator: the same bytes for a seed, other bytes for
another seed."""

import hashlib

from benchmark.gen import trio as gen


def _digests(tmp_path, seed):
    tmp_path.mkdir()
    t = gen.make_trio(20_000, n_denovo=10, seed=seed)
    out = {}
    for s in gen.SAMPLES:
        paths = gen.write_fastq(t.samples[s], str(tmp_path / f"{seed}{s}"))
        paths += (gen.write_bam(t.samples[s], str(tmp_path / f"{seed}{s}.bam"),
                                20_000, seed=[seed, 0]),)
        for p in paths:
            out[p.rsplit(s, 1)[1] + s] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return t, out


def test_same_seed_same_bytes_other_seed_other_bytes(tmp_path):
    a, da = _digests(tmp_path / "a", 7)
    b, db = _digests(tmp_path / "b", 7)
    c, dc = _digests(tmp_path / "c", 8)
    assert da == db
    assert all(da[k] != dc[k] for k in da)
    assert (a.sites == b.sites).all() and (a.alt == b.alt).all()


def test_trio_shape_and_truth():
    t = gen.make_trio(20_000, n_denovo=10, seed=3)
    c = t.samples["child"]
    assert c.pairs == 2000 and c.seq1.shape == (2000, 150)
    assert c.names.shape == (2000, gen.NAME_LEN)
    assert len(t.sites) == 10 and (t.genome[t.sites] != t.alt).all()
    assert set(c.qual1.reshape(-1).tolist()) <= {ord("#"), ord("I")}
    # a pair's name says where it came from: its forward mate reads the
    # parents' genome from `start` (hap 0), up to the errors
    same = []
    for i in range(200):
        _, hap, start, _ = c.names[i].tobytes().decode().split("_")
        if hap == "0":
            fwd = c.seq2[i] if c.mate1_reverse[i] else c.seq1[i]
            same.append((fwd == t.genome[int(start):int(start) + 150]).mean())
    assert len(same) > 50 and sum(same) / len(same) > 0.99
