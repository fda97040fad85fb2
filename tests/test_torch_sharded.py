"""The port's sharded chain (rufus_tpu_torch/parallel/sharded.py) against the
JAX package's on the CPU: JAX on the 8 virtual devices of conftest.py, the
port on make_mesh(n, "cpu") with the plain versions of its kernels, at
n in {1, 2, 3, 4, 6, 8} (3 and 6 cut a batch into uneven slices and take
an odd number of splitters). Inputs: reads of a seeded 20 kbp genome (substitution
errors, N bases, low-quality bases), k = 25, 96-read batches. Tolerance:
none, every value is an integer or a byte.
"""

import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rufus_tpu.ops import count as jcount
from rufus_tpu.parallel import ShardedKmerTable as JaxTable
from rufus_tpu.parallel import local_count_step as jax_local_count_step
from rufus_tpu.parallel import make_mesh as jax_make_mesh
from rufus_tpu.parallel import make_splitters as jax_make_splitters
from rufus_tpu.parallel import sharded as jsh
from rufus_tpu.parallel import sharded_filter_step as jax_filter_step
from rufus_tpu.parallel import sharded_query_step as jax_query_step
from rufus_tpu.parallel import sharded_subtract_step as jax_subtract_step
from rufus_tpu.pipeline import RufusConfig as JaxConfig
from rufus_tpu.pipeline import RufusPipeline as JaxPipeline
from rufus_tpu_torch.convert import table_from_numpy
from rufus_tpu_torch.ops import codec, count
from rufus_tpu_torch.ops.filter import filter_pairs
from rufus_tpu_torch.ops.query import query_counts
from rufus_tpu_torch.ops.table import (DeviceKmerTable, count_step,
                                       subtract_step)
from rufus_tpu_torch.parallel import (ShardedKmerTable, local_count_step,
                                      make_mesh, make_splitters,
                                      replicate_hashlist, sharded_filter_step,
                                      sharded_query_multi, sharded_query_step,
                                      sharded_subtract_step)
from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline
from test_torch_pipeline import (  # noqa: F401  (fixtures)
    _assert_same_outputs, _kwargs, jax_run, trio)

K = 25
B, L, BATCHES = 96, 100, 6
SHARDS = [1, 2, 3, 4, 6, 8]
BASES = np.frombuffer(b"ACGT", np.uint8)
MERGE_MIN, MIN_COV, MAX_DEPTH, LOWER = 2, 2, 1000, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain kernels on one torch thread while this module runs:
    the suite runs several workers at once, and torch's intra-op threads
    then wait at each op's barrier for one another's scheduler slices (a
    trio that counts in under a second alone took minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def samples():
    """{sample: (reads, quals, lens)} of BATCHES * B rows each: reads of a
    20 kbp genome (the child's with 8 spiked SNVs) at random positions,
    0.5% substitutions, 0.5% N, 2% of qualities below 15, lengths 60-100."""
    rng = np.random.default_rng(10)
    genome = rng.choice(BASES, 20_000)
    child = genome.copy()
    sites = rng.choice(len(genome), 8, replace=False)
    child[sites] = BASES[(np.searchsorted(BASES, child[sites]) + 1) % 4]

    def reads(g):
        n = BATCHES * B
        pos = rng.integers(0, len(g) - L, n)
        r = g[pos[:, None] + np.arange(L)]
        err = rng.random(r.shape) < 0.005
        r[err] = rng.choice(BASES, int(err.sum()))
        r[rng.random(r.shape) < 0.005] = ord("N")
        q = np.full(r.shape, ord("I"), np.uint8)
        q[rng.random(r.shape) < 0.02] = ord("#")
        lens = rng.integers(60, L + 1, n).astype(np.int32)
        r[np.arange(L)[None, :] >= lens[:, None]] = ord("N")
        return r.astype(np.uint8), q, lens

    return {s: reads(g) for s, g in (("child", child), ("mother", genome),
                                      ("father", genome))}


def _batches(reads, rows=B):
    return [reads[i:i + rows] for i in range(0, len(reads), rows)]


def _jax_keys(n, batch):
    mesh = jax_make_mesh(n)
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("d"))
    return jax_local_count_step(mesh, K)(jax.device_put(jnp.asarray(batch),
                                                        sh))[0]


def _jax_table(n, reads, splitters):
    t = JaxTable(jax_make_mesh(n), K, 1 << 12, splitters=splitters)
    for batch in _batches(reads):
        t.fold_batch(_jax_keys(n, batch))
    t.flush()
    return t


def _jax_shards(t):
    """Each shard's valid prefix: sentinels and zero counts masked."""
    keys, counts = np.asarray(t.keys), np.asarray(t.counts)
    ok = (keys != jcount.SENTINEL) & (counts > 0)
    return [(k[m], c[m]) for k, c, m in zip(keys, counts, ok)]


def _port_table(n, reads, splitters=None, rows=B, **kw):
    mesh = make_mesh(n, "cpu")
    t = ShardedKmerTable(mesh, K, splitters=None if splitters is None
                         else codec.keys_u64_to_i64(splitters), **kw)
    for batch in _batches(reads, rows):
        t.fold_batch(local_count_step(mesh, torch.from_numpy(batch), K))
    t.flush()
    return t


def _port_shards(t):
    return [(codec.keys_i64_to_u64(s.keys.numpy()), s.counts.numpy())
            for s in t.shards]


def _splitters(n, reads):
    """The JAX package's splitters from the first two batches."""
    return jax_make_splitters([_jax_keys(n, b) for b in _batches(reads)[:2]],
                              n)


def _assert_same_shards(got, want):
    assert len(got) == len(want)
    for (gk, gc), (wk, wc) in zip(got, want):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gc, wc)


def _whole(reads):
    """The single-device table of all the reads."""
    t = DeviceKmerTable(K, "cpu")
    for batch in _batches(reads):
        t.fold_batch(count_step(torch.from_numpy(batch), K))
    return t.to_host()


@pytest.mark.parametrize("n", SHARDS)
def test_routing_matches_jax(samples, n):
    """Each shard's keys and counts after a count and flush equal the JAX
    table's shard for the same splitters; a key equal to a splitter opens
    the next shard; the shards concatenate into the single-device table;
    and a stream too short to fill the splitter sample freezes the
    splitters the JAX package makes from what it saw."""
    reads = samples["child"][0]
    spl = _splitters(n, reads)
    parts = [local_count_step(make_mesh(n, "cpu"), torch.from_numpy(b), K)
             for b in _batches(reads)[:2]]
    np.testing.assert_array_equal(make_splitters(parts, n),
                                  codec.keys_u64_to_i64(spl))
    got = _port_shards(_port_table(n, reads, spl))
    _assert_same_shards(got, _jax_shards(_jax_table(n, reads, spl)))
    for i, s in enumerate(spl):
        assert got[i + 1][0][0] == s  # side "right" owner, side "left" cut
        assert s not in got[i][0]
    whole = _whole(reads)
    np.testing.assert_array_equal(np.concatenate([k for k, _ in got]),
                                  whole.keys)
    np.testing.assert_array_equal(np.concatenate([c for _, c in got]),
                                  whole.counts)
    short = _port_table(n, reads[:2 * B])
    np.testing.assert_array_equal(short.splitters,
                                  codec.keys_u64_to_i64(spl))
    assert short.stats["flushes"] == 1
    assert (short.stats["exchanged_keys"] > 0) == (n > 1)


@pytest.mark.parametrize("case", ["every_batch", "buffered",
                                  "splitter_sample"])
@pytest.mark.parametrize("n", SHARDS)
def test_range_flushes_follow_the_table(samples, n, case):
    """A range flush comes once a shard's buffer reaches a quarter of the
    smallest shard's table: full batches each flush as they come, batches
    of 6 reads buffer; without splitters the first flush waits for the
    splitters' sample of SPLIT_BATCHES batches, which the splitters are
    the quantiles of. The shards equal the JAX table's for the same
    splitters, whatever the cadence."""
    from rufus_tpu_torch.parallel.sharded import SPLIT_BATCHES

    reads = samples["child"][0]
    spl = _splitters(n, reads)
    rows = B if case == "every_batch" else 6
    batches = _batches(reads, rows)
    slice_keys = -(-rows // n) * (L - K + 1)
    t = _port_table(n, reads, None if case == "splitter_sample" else spl,
                    rows)
    if case == "every_batch":
        assert t.stats["flushes"] == len(batches)
        assert t.fold_keys_max == slice_keys
    elif case == "buffered":
        assert 1 < t.stats["flushes"] < len(batches) // 2
        assert t.fold_keys_max > slice_keys
    else:
        assert 1 < t.stats["flushes"] < len(batches) // 2
        assert t.fold_keys_max == SPLIT_BATCHES * slice_keys
        mesh = make_mesh(n, "cpu")
        np.testing.assert_array_equal(t.splitters, make_splitters(
            [local_count_step(mesh, torch.from_numpy(b), K)
             for b in batches[:SPLIT_BATCHES]], n))
    jt = _jax_table(n, reads, spl)
    if case == "splitter_sample":
        got, want = t.to_host(), jt.to_host()
        np.testing.assert_array_equal(got.keys, want.keys)
        np.testing.assert_array_equal(got.counts, want.counts)
    else:
        _assert_same_shards(_port_shards(t), _jax_shards(jt))


@pytest.mark.parametrize("n", SHARDS)
def test_lower_count_and_to_host_match_jax(samples, n):
    reads = samples["mother"][0]
    spl = _splitters(n, reads)
    pt, jt = _port_table(n, reads, spl), _jax_table(n, reads, spl)
    pt.apply_lower_count(LOWER)
    jt.apply_lower_count(LOWER)
    _assert_same_shards(_port_shards(pt), _jax_shards(jt))
    got, want = pt.to_host(), jt.to_host()
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert len(got) and got.counts.min() >= LOWER


def _trio_tables(samples, n, make):
    """The three samples' tables, floored, on the child's splitters."""
    spl = _splitters(n, samples["child"][0])
    out = []
    for s in ("child", "mother", "father"):
        t = make(n, samples[s][0], spl)
        t.apply_lower_count(LOWER)
        out.append(t)
    return out


@pytest.mark.parametrize("n", SHARDS)
def test_subtract_matches_jax(samples, n):
    pt = _trio_tables(samples, n, _port_table)
    mk, mc = sharded_subtract_step(pt[0], pt[1:], MERGE_MIN, MIN_COV,
                                   MAX_DEPTH)
    got_k, got_c = codec.keys_i64_to_u64(mk.numpy()), mc.numpy()
    jt = _trio_tables(samples, n, _jax_table)
    step = jax_subtract_step(jt[0].mesh, 3)
    jk, jc = step([t.keys for t in jt], [t.counts for t in jt],
                  jnp.int64(MERGE_MIN), jnp.int64(MIN_COV),
                  jnp.int64(MAX_DEPTH))
    jk, jc = np.asarray(jk).ravel(), np.asarray(jc).ravel()
    ok = jk != jcount.SENTINEL
    order = np.argsort(jk[ok])
    np.testing.assert_array_equal(got_k, jk[ok][order])
    np.testing.assert_array_equal(got_c, jc[ok][order])
    whole = [table_from_numpy(h.keys, h.counts, "cpu", k=K)
             for h in (t.to_host() for t in pt)]
    wk, wc = subtract_step(whole[0], whole[1:], MERGE_MIN, MIN_COV, MAX_DEPTH)
    np.testing.assert_array_equal(mk, wk)
    np.testing.assert_array_equal(mc, wc)
    assert 0 < len(got_k) < len(pt[0].to_host())


def _hashlist(samples):
    pt = _trio_tables(samples, 1, _port_table)
    return sharded_subtract_step(pt[0], pt[1:], MERGE_MIN, MIN_COV,
                                 MAX_DEPTH)[0]


@pytest.mark.parametrize("n", SHARDS)
def test_filter_matches_jax(samples, n):
    """Keep masks of a batch of 93 pairs (a multiple of no n > 1) equal the
    JAX step's on the batch padded to a multiple of n (as its driver pads),
    and the single-device filter_pairs."""
    table = _hashlist(samples)
    r, q, l = (a[:2 * 93] for a in samples["child"])
    mate1, mate2 = (tuple(torch.from_numpy(a[i::2].copy()) for a in (r, q, l))
                    for i in (0, 1))
    mesh = make_mesh(n, "cpu")
    hl = replicate_hashlist(mesh, table, K)
    got = sharded_filter_step(mesh, [mate1, mate2], hl, K, 15, 1)
    single = sharded_filter_step(mesh, [mate1], hl, K, 15, 1)
    want = filter_pairs(*mate1, *mate2, table, K, 15, 1)[0]
    np.testing.assert_array_equal(got, want)

    jmesh = jax_make_mesh(n)
    step = jax_filter_step(jmesh, K, 15, 1)
    sh = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec("d"))
    rep = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec())
    hl_u64 = jax.device_put(jnp.asarray(codec.keys_i64_to_u64(table.numpy())),
                            rep)

    def jax_keep(mate):
        rr, qq, ll = (t.numpy() for t in mate)
        pad = (-len(rr)) % n
        rr = np.concatenate([rr, np.full((pad, L), ord("N"), np.uint8)])
        qq = np.concatenate([qq, np.full((pad, L), ord("!"), np.uint8)])
        ll = np.concatenate([ll, np.zeros(pad, ll.dtype)])
        return np.asarray(step(*(jax.device_put(jnp.asarray(a), sh)
                                 for a in (rr, qq, ll)), hl_u64))[:93]

    k1 = jax_keep(mate1)
    np.testing.assert_array_equal(single, k1)
    np.testing.assert_array_equal(got, k1 | jax_keep(mate2))
    assert 0 < int(got.sum()) < 93


@pytest.mark.parametrize("n", SHARDS)
def test_pulls_match_jax(samples, n):
    """The routed query over three resident tables equals query_counts on
    the whole tables and the JAX pipeline's routed multi-table query, with
    absent k-mers among the queries; an empty query set gives (3, 0)."""
    from rufus_tpu.pipeline.driver import RufusPipeline as JaxDriver

    pt = _trio_tables(samples, n, _port_table)
    hosts = [t.to_host() for t in pt]
    rng = np.random.default_rng(5)
    present = np.concatenate([h.keys[::37] for h in hosts])
    absent = np.setdiff1d(rng.integers(0, 1 << (2 * K), 200,
                                       dtype=np.uint64),
                          np.concatenate([h.keys for h in hosts]))
    q = rng.permutation(np.concatenate([present, absent]))
    got = sharded_query_multi(pt, q)
    whole = [table_from_numpy(h.keys, h.counts, "cpu", k=K) for h in hosts]
    np.testing.assert_array_equal(got, query_counts(whole, q))
    assert (got == 0).any() and (got > 0).any()

    jt = _trio_tables(samples, n, _jax_table)
    probe = types.SimpleNamespace(cfg=types.SimpleNamespace(k=K),
                                  mesh=jt[0].mesh, n_devices=n,
                                  _log=lambda *a, **kw: None)
    want = JaxDriver._routed_query_multi(probe, jt, q)
    np.testing.assert_array_equal(got, want)
    assert sharded_query_multi(pt, q[:0]).shape == (3, 0)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_query_matches_jax(samples, n):
    """The single-table sharded_query_step equals JAX's by-splitters
    sharded_query_step with the table's splitters, and the three-table
    sharded_query_multi equals JAX's by-splitters sharded_query_multi and
    the host query; absent k-mers and a query count that is a multiple of
    no n > 1 included."""
    pt = _trio_tables(samples, n, _port_table)
    jt = _trio_tables(samples, n, _jax_table)
    hosts = [t.to_host() for t in pt]
    rng = np.random.default_rng(5 + n)
    present = np.concatenate([h.keys[::41] for h in hosts])
    absent = np.setdiff1d(rng.integers(0, 1 << (2 * K), 300,
                                       dtype=np.uint64),
                          np.concatenate([h.keys for h in hosts]))
    q = rng.permutation(np.concatenate([present, absent]))
    q = q[:len(q) - len(q) % 8 - 3]
    got = sharded_query_multi(pt, q)
    for t, h in enumerate(hosts):
        np.testing.assert_array_equal(got[t], h.query(q))
    np.testing.assert_array_equal(sharded_query_step(pt[0], q), got[0])
    assert (got == 0).any() and (got > 0).any()

    mesh = jt[0].mesh
    qcap = -(-len(q) // n)
    padded = np.full(n * qcap, jcount.SENTINEL, np.uint64)
    padded[:len(q)] = q
    qd = jax.device_put(jnp.asarray(padded.reshape(n, qcap)),
                        jax.sharding.NamedSharding(
                            mesh, jax.sharding.PartitionSpec("d")))
    spl = jax.device_put(jnp.asarray(jt[0].splitters, jnp.uint64),
                         jax.sharding.NamedSharding(
                             mesh, jax.sharding.PartitionSpec()))
    rcap = jsh.exact_route_cap(padded, n, jt[0].splitters)
    one, dropped = jax_query_step(mesh, K, qcap, rcap, by_splitters=True)(
        qd, jt[0].keys, jt[0].counts, spl)
    assert int(np.asarray(dropped).sum()) == 0
    np.testing.assert_array_equal(np.asarray(one).ravel()[:len(q)], got[0])
    multi, dropped = jsh.sharded_query_multi(mesh, K, qcap, 3, rcap, True)(
        qd, [t.keys for t in jt], [t.counts for t in jt], spl)
    assert int(np.asarray(dropped).sum()) == 0
    np.testing.assert_array_equal(np.asarray(multi).reshape(3, -1)
                                  [:, :len(q)], got)


def test_range_partition_refusals(samples):
    """The subtract and the pulls refuse tables of different meshes or
    splitters; a table refuses splitters that do not fit its mesh, and a
    budget spill on a process mesh."""
    from rufus_tpu_torch.parallel import ShardMesh

    reads = samples["mother"][0]
    two = _port_table(2, reads)
    for other in (_port_table(4, reads),
                  _port_table(2, reads, np.array([1 << 40], np.uint64))):
        for pair in ((two, other), (other, two)):
            with pytest.raises(ValueError, match="different partitions"):
                sharded_subtract_step(pair[0], [pair[1]], MERGE_MIN,
                                      MIN_COV, MAX_DEPTH)
            with pytest.raises(ValueError, match="different partitions"):
                sharded_query_multi(list(pair),
                                    np.arange(5, dtype=np.uint64))
    with pytest.raises(ValueError, match="2 splitters for 2 shards"):
        ShardedKmerTable(make_mesh(2, "cpu"), K, splitters=np.array([5, 9]))
    ranks = ShardMesh((torch.device("cpu"),), rank=0, world=2)
    with pytest.raises(NotImplementedError, match="process mesh"):
        ShardedKmerTable(ranks, K, budget=1 << 30, spill=lambda t: None)


@pytest.mark.parametrize("n", SHARDS)
def test_lsm_spill_matches_resident(samples, n, tmp_path):
    """Under a budget that holds one batch slice (a quarter more, so a
    shard's pending buffer holds one), the table spills whole sorted runs;
    their merge-sum equals the resident table, and the JAX host table."""
    from rufus_tpu_torch.ops.table import CAP_BYTES

    reads = np.concatenate([samples[s][0] for s in samples])
    spl = _splitters(n, reads)
    runs = []

    def spill(t):
        runs.append(str(tmp_path / f"t.flat.run{len(runs)}"))
        t.to_flat(runs[-1], chunk=257)
        t.reset()

    slice_keys = -(-B // n) * (L - K + 1)
    budget = n * int(1.25 * CAP_BYTES * slice_keys)
    t = _port_table(n, reads, spl, budget=budget, spill=spill)
    assert t.stats["spills"] == len(runs) >= 2
    runs.append(str(tmp_path / f"t.flat.run{len(runs)}"))
    t.to_flat(runs[-1])
    merged = count.merge_flat_runs(runs, str(tmp_path / "t.flat"),
                                   lower_count=LOWER, chunk=1000)
    resident = _port_table(n, reads, spl)
    resident.apply_lower_count(LOWER)
    want = resident.to_host()
    np.testing.assert_array_equal(np.asarray(merged.keys), want.keys)
    np.testing.assert_array_equal(np.asarray(merged.counts), want.counts)
    jt = _jax_table(n, reads, spl)
    jt.apply_lower_count(LOWER)
    np.testing.assert_array_equal(want.keys, jt.to_host().keys)


@pytest.fixture(scope="module")
def jax_run_on(trio):
    """The JAX pipeline through the filter on its 8 devices."""
    d, data = trio
    wd = d / "jax_on"
    JaxPipeline(JaxConfig(**_kwargs(data, wd, sharded="on",
                                    table_cap0=1 << 17))).run()
    return wd


@pytest.mark.parametrize("case", ["4_shards", "8_shards", "resumed"])
def test_pipeline_matches_jax(trio, jax_run, jax_run_on, tmp_path, case):
    """RufusPipeline on a mesh of CPU shards through the filter writes
    every file of the JAX run byte for byte: 4 shards against the JAX
    package with sharded "off", 8 against its 8-device run; "resumed"
    starts from the JAX run's subject count, so the splitters come from
    the mother's count and serve the father's."""
    d, data = trio
    n = 8 if case == "8_shards" else 4
    want = jax_run_on if case == "8_shards" else jax_run
    if case == "resumed":
        for n_ in os.listdir(want):
            if n_.startswith("child.R1.fastq.generator.") and n_.endswith(
                    (".table.npz", ".Jhash.histo", ".Jelly.chr")):
                shutil.copy(want / n_, tmp_path / n_)
    pipe = RufusPipeline(RufusConfig(**_kwargs(data, tmp_path, device="cpu")),
                         mesh=make_mesh(n, "cpu"))
    pipe.run()
    _assert_same_outputs(str(tmp_path), str(want))
    count_rec = pipe.trace.stages[0]
    assert count_rec["shards"] == n
    counted = sorted(count_rec["flushes"])
    assert len(counted) == (2 if case == "resumed" else 3)
    assert all(count_rec["exchanged_keys"][s] > 0 for s in counted)
    tables = list(pipe._dev_tables.values())
    assert all(np.array_equal(t.splitters, pipe._splitters) for t in tables)
    hashlist = [s for s in pipe.trace.stages if s["stage"] == "hashlist"][0]
    assert hashlist["path"] == ("host-stream" if case == "resumed"
                                else "sharded")


def test_multipass_on_shards_raises(trio, tmp_path):
    d, data = trio
    cfg = RufusConfig(**_kwargs(data, tmp_path, device="cpu", count_passes=2))
    with pytest.raises(NotImplementedError):
        RufusPipeline(cfg, mesh=make_mesh(2, "cpu")).run()
    assert not os.listdir(tmp_path / "Intermediates")
