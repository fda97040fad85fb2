"""The count and codec helpers of the port (ops/codec.kmer_to_str,
KmerTable.query_strs, build_hashlist_4col, population_filter) against the
JAX package's on the same numpy-seeded inputs."""

import numpy as np
import pytest

from rufus_tpu.ops import codec as jcodec, count as jcount
from rufus_tpu_torch.ops import codec, count

K = 15


def _genome(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes().decode()


def _sample(rng, genome, reads, L=60, snv=None):
    """Reads sampled from `genome` (with an SNV at `snv` in every read
    that covers it, when given), some with N bases."""
    out = []
    for _ in range(reads):
        s = int(rng.integers(0, len(genome) - L))
        r = list(genome[s:s + L])
        if snv is not None and s <= snv < s + L:
            r[snv - s] = "ACGT"[("ACGT".index(r[snv - s]) + 1) % 4]
        if rng.random() < 0.1:
            r[int(rng.integers(0, L))] = "N"
        out.append("".join(r))
    return out


def _tables(seed):
    """Canonical count tables of a child, two parents and a population,
    each as a JAX KmerTable and the port's KmerTable of the same arrays."""
    rng = np.random.default_rng(seed)
    genome = _genome(rng, 3000)
    seqs = {"child": _sample(rng, genome, 400, snv=1500),
            "mother": _sample(rng, genome, 300),
            "father": _sample(rng, genome, 300),
            "population": _sample(rng, genome, 900)}
    jax_t = {n: jcount.KmerTable.from_strings(K, s) for n, s in seqs.items()}
    port_t = {n: count.KmerTable(K, t.keys.copy(), t.counts.copy())
              for n, t in jax_t.items()}
    return jax_t, port_t, genome


@pytest.mark.parametrize("k", [1, 5, 25, 31])
def test_kmer_to_str_equals_jax(k):
    rng = np.random.default_rng(k)
    for v in rng.integers(0, 1 << (2 * k), 200, dtype=np.uint64).tolist():
        s = codec.kmer_to_str(int(v), k)
        assert s == jcodec.kmer_to_str(int(v), k)
        assert len(s) == k and codec.str_to_kmer(s) == v


@pytest.mark.parametrize("seed", [0, 1])
def test_query_strs_equals_jax(seed):
    jax_t, port_t, genome = _tables(seed)
    rng = np.random.default_rng(seed + 10)
    starts = rng.integers(0, len(genome) - K, 300)
    seqs = [genome[s:s + K] for s in starts]
    seqs += [codec.revcomp_str(s) for s in seqs[:50]]  # other strand
    seqs += [s.lower() for s in seqs[50:80]]
    seqs += [_genome(rng, K) for _ in range(50)]  # mostly absent
    got = port_t["child"].query_strs(seqs)
    np.testing.assert_array_equal(got, jax_t["child"].query_strs(seqs))
    assert (got[:300] > 0).mean() > 0.9


@pytest.mark.parametrize("min_cov,max_cov_control,max_coverage", [
    (1, 0, 1200), (2, 3, 1200), (3, 100, 20)])
def test_build_hashlist_4col_equals_jax(min_cov, max_cov_control,
                                        max_coverage):
    jax_t, port_t, _ = _tables(2)
    got = count.build_hashlist_4col(
        port_t["child"], [port_t["mother"], port_t["father"]], min_cov,
        max_cov_control, max_coverage)
    want = jcount.build_hashlist_4col(
        jax_t["child"], [jax_t["mother"], jax_t["father"]], min_cov,
        max_cov_control, max_coverage)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 0


@pytest.mark.parametrize("max_pop_depth", [0, 2, 10])
def test_population_filter_equals_jax(max_pop_depth):
    jax_t, port_t, _ = _tables(3)
    got = count.population_filter(port_t["child"], port_t["population"],
                                  max_pop_depth)
    want = jcount.population_filter(jax_t["child"], jax_t["population"],
                                    max_pop_depth)
    assert isinstance(got, count.KmerTable) and got.k == want.k
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert 0 < len(got) <= len(port_t["child"])
