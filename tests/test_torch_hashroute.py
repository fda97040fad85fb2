"""The port's hash route (rufus_tpu_torch/parallel/sharded.py: owner_hash,
sharded_count_step, the hash-partitioned ShardedKmerTable, the pulls by
hash owner) against the JAX package's on the CPU: JAX on the 8 virtual
devices of conftest.py, the port on make_mesh(n, "cpu") with the plain
versions of its kernels, at n in {2, 4, 8}. Inputs: the seeded reads of
tests/test_torch_sharded.py (20 kbp genome, k = 25, 96-read batches).
Tolerance: none, every value is an integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rufus_tpu.ops import count as jcount
from rufus_tpu.parallel import ShardedKmerTable as JaxTable
from rufus_tpu.parallel import make_mesh as jax_make_mesh
from rufus_tpu.parallel import sharded_count_step as jax_count_step
from rufus_tpu.parallel import sharded_query_step as jax_query_step
from rufus_tpu.parallel import sharded_subtract_step as jax_subtract_step
from rufus_tpu.parallel import sharded as jsh
from rufus_tpu_torch.ops import codec
from rufus_tpu_torch.ops.table import count_step
from rufus_tpu_torch.parallel import (ShardedKmerTable, exact_route_cap,
                                      host_owners, make_mesh, owner_hash,
                                      route_capacity, sharded_count_step,
                                      sharded_query_multi, sharded_query_step,
                                      sharded_subtract_step)
from test_torch_sharded import (  # noqa: F401  (fixtures)
    B, K, L, LOWER, MAX_DEPTH, MERGE_MIN, MIN_COV, _assert_same_shards,
    _batches, _jax_shards, _jax_table, _port_shards, _port_table, _splitters,
    _whole, one_torch_thread, samples)

SHARDS = [2, 4, 8]


def _sharding(mesh):
    return jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("d"))


def _jax_step(n):
    """JAX's hash-routed count step with bins as wide as a device's
    slice, so that no key is dropped."""
    mesh = jax_make_mesh(n)
    bcap = (B // n) * (L - K + 1)
    return mesh, jax_count_step(mesh, K, bcap, route_cap=bcap)


def _jax_hash_table(n, reads):
    mesh, step = _jax_step(n)
    t = JaxTable(mesh, K, 1 << 12)
    for batch in _batches(reads):
        bk, bc, _, dr = step(jax.device_put(jnp.asarray(batch),
                                            _sharding(mesh)))
        jax.block_until_ready(bk)
        assert int(np.asarray(dr).sum()) == 0
        t.fold_batch(bk, bc)
    t.flush()
    return t


def _port_hash_table(n, reads):
    mesh = make_mesh(n, "cpu")
    t = ShardedKmerTable(mesh, K, partition="hash")
    for batch in _batches(reads):
        keys, counts, got, dropped = sharded_count_step(
            mesh, torch.from_numpy(batch), K, t.stats)
        assert dropped == 0 and len(got) == len(keys)
        t.fold_batch(keys, counts)
    t.flush()
    return t


def _edge_keys(rng):
    """uint64 keys below 2**62 (the port's keys) with the halves' edges:
    lo near 2**32 - 1, hi near 2**30 - 1 and 0, and the sentinel."""
    keys = rng.integers(0, 1 << 62, 6000, dtype=np.uint64)
    lo_top = np.uint64((1 << 32) - 1) - rng.integers(0, 64, 500).astype(
        np.uint64)
    hi = rng.integers(0, 1 << 30, 500).astype(np.uint64)
    hi[:100] = (1 << 30) - 1
    hi[100:200] = 0
    keys[:500] = (hi << np.uint64(32)) | lo_top
    keys[500:520] = np.arange(20, dtype=np.uint64)
    keys[::97] = jcount.SENTINEL
    return keys


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_host_owner_mirror_is_bit_exact(n):
    """owner_hash on int64 keys equals JAX's _owners, sentinels owned by
    n; host_owners equals JAX's by hash and by splitters, over the whole
    uint64 range too; exact_route_cap and route_capacity equal JAX's."""
    rng = np.random.default_rng(41 + n)
    keys = _edge_keys(rng)
    sent = keys == jcount.SENTINEL
    got = owner_hash(torch.from_numpy(codec.keys_u64_to_i64(keys)), n).numpy()
    want = np.asarray(jsh._owners(jnp.asarray(keys), n, K))
    np.testing.assert_array_equal(got[~sent], want[~sent])
    assert (got[sent] == n).all() and got.min() >= 0
    assert len(np.unique(got[~sent])) == n
    wide = rng.integers(0, 2**64 - 1, 3000, dtype=np.uint64)
    spl = np.sort(rng.integers(0, 1 << 62, n - 1, dtype=np.uint64))
    for k in (keys, wide):
        np.testing.assert_array_equal(host_owners(k, n), jsh.host_owners(k, n))
        np.testing.assert_array_equal(host_owners(k, n, spl),
                                      jsh.host_owners(k, n, spl))
    np.testing.assert_array_equal(host_owners(keys, n)[~sent], got[~sent])
    padded = keys[:n * 512]
    for s in (None, spl):
        assert exact_route_cap(padded, n, s) == jsh.exact_route_cap(
            padded, n, s)
    for m in (1, 100, 4096, 256 * 1024):
        assert route_capacity(m, n) == jsh.route_capacity(m, n)
    one = owner_hash(torch.from_numpy(codec.keys_u64_to_i64(keys)), 1)
    assert (one.numpy()[~sent] == 0).all() and (one.numpy()[sent] == 1).all()


@pytest.mark.parametrize("n", SHARDS)
def test_route_capacity_is_o_batch_and_exact(samples, n):
    """JAX bins a batch into per-peer slots of route_capacity, O(batch/n),
    and drops what overflows; the port sizes each segment exactly. One
    batch's routed keys and counts equal JAX's valid bin entries shard by
    shard, in the same order, nothing is dropped, and the counts sum to
    the batch's valid windows."""
    bcap = 256 * 1024
    rcap = route_capacity(bcap, n)
    assert bcap // n <= rcap and n * rcap <= 2 * bcap
    batch = _batches(samples["child"][0])[0]
    mesh, step = _jax_step(n)
    bk, bc, _, dr = step(jax.device_put(jnp.asarray(batch), _sharding(mesh)))
    assert int(np.asarray(dr).sum()) == 0
    bk, bc = np.asarray(bk), np.asarray(bc)
    keys, counts, got, dropped = sharded_count_step(
        make_mesh(n, "cpu"), torch.from_numpy(batch), K)
    assert dropped == 0 and len(keys) == n
    for s in range(n):
        ok = bk[s] != jcount.SENTINEL
        np.testing.assert_array_equal(codec.keys_i64_to_u64(keys[s].numpy()),
                                      bk[s][ok])
        np.testing.assert_array_equal(counts[s].numpy(), bc[s][ok])
        assert (owner_hash(keys[s], n) == s).all()
    valid = int((count_step(torch.from_numpy(batch), K)
                 != codec.SENTINEL).sum())
    assert sum(int(c.sum()) for c in counts) == valid >= sum(got)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_count_fold_matches_jax(samples, n):
    """Each port shard's table after the hash-routed count and fold equals
    the same JAX shard (the same hash gives the same owner); to_host
    equals JAX's and the single-device table, before and after the
    floor."""
    reads = samples["child"][0]
    pt, jt = _port_hash_table(n, reads), _jax_hash_table(n, reads)
    _assert_same_shards(_port_shards(pt), _jax_shards(jt))
    whole = _whole(reads)
    got = pt.to_host()
    np.testing.assert_array_equal(got.keys, jt.to_host().keys)
    np.testing.assert_array_equal(got.keys, whole.keys)
    np.testing.assert_array_equal(got.counts, whole.counts)
    assert pt.stats["exchanged_keys"] > 0 and pt.n_keys == len(whole)
    pt.apply_lower_count(LOWER)
    jt.apply_lower_count(LOWER)
    _assert_same_shards(_port_shards(pt), _jax_shards(jt))
    np.testing.assert_array_equal(pt.to_host().counts, jt.to_host().counts)


@pytest.fixture(scope="module")
def trios(samples):
    """trios(n, partition, package): the three samples' floored tables,
    built once for the module (range tables on the child's splitters)."""
    made = {}

    def get(n, partition, package):
        key = (n, partition, package)
        if key not in made:
            if partition == "hash":
                make = (_port_hash_table if package == "port"
                        else _jax_hash_table)
            else:
                spl = _splitters(n, samples["child"][0])
                build = _port_table if package == "port" else _jax_table
                make = lambda n_, r: build(n_, r, spl)  # noqa: E731
            made[key] = []
            for s in ("child", "mother", "father"):
                t = make(n, samples[s][0])
                t.apply_lower_count(LOWER)
                made[key].append(t)
        return made[key]

    return get


@pytest.mark.parametrize("n", SHARDS)
def test_subtract_matches_jax(trios, n):
    """The HashList of hash-partitioned tables equals JAX's subtract on
    its hash tables, sorted, and the range-partitioned tables' HashList."""
    pt = trios(n, "hash", "port")
    mk, mc = sharded_subtract_step(pt[0], pt[1:], MERGE_MIN, MIN_COV,
                                   MAX_DEPTH)
    jt = trios(n, "hash", "jax")
    jk, jc = jax_subtract_step(jt[0].mesh, 3)(
        [t.keys for t in jt], [t.counts for t in jt], jnp.int64(MERGE_MIN),
        jnp.int64(MIN_COV), jnp.int64(MAX_DEPTH))
    jk, jc = np.asarray(jk).ravel(), np.asarray(jc).ravel()
    ok = jk != jcount.SENTINEL
    order = np.argsort(jk[ok])
    np.testing.assert_array_equal(codec.keys_i64_to_u64(mk.numpy()),
                                  jk[ok][order])
    np.testing.assert_array_equal(mc.numpy(), jc[ok][order])
    rt = trios(n, "range", "port")
    rk, rc = sharded_subtract_step(rt[0], rt[1:], MERGE_MIN, MIN_COV,
                                   MAX_DEPTH)
    np.testing.assert_array_equal(mk, rk)
    np.testing.assert_array_equal(mc, rc)
    assert 0 < len(mk)


def _queries(rng, hosts):
    present = np.concatenate([h.keys[::41] for h in hosts])
    absent = np.setdiff1d(rng.integers(0, 1 << (2 * K), 300,
                                       dtype=np.uint64),
                          np.concatenate([h.keys for h in hosts]))
    return rng.permutation(np.concatenate([present, absent]))


@pytest.mark.parametrize("partition", ["hash", "range"])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_query_matches_jax(trios, n, partition):
    """The single-table sharded_query_step equals JAX's (by hash owner, or
    by splitters with the table's splitters), and the three-table
    sharded_query_multi equals JAX's and the host query; absent k-mers and
    a query count that is a multiple of no n > 1 included."""
    pt, jt = trios(n, partition, "port"), trios(n, partition, "jax")
    hosts = [t.to_host() for t in pt]
    q = _queries(np.random.default_rng(5 + n), hosts)
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
                        _sharding(mesh))
    by_spl = partition == "range"
    extra = ()
    if by_spl:
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        extra = (jax.device_put(jnp.asarray(jt[0].splitters, jnp.uint64),
                                rep),)
    rcap = jsh.exact_route_cap(padded, n, jt[0].splitters if by_spl
                               else None)
    one, dropped = jax_query_step(mesh, K, qcap, rcap, by_splitters=by_spl)(
        qd, jt[0].keys, jt[0].counts, *extra)
    assert int(np.asarray(dropped).sum()) == 0
    np.testing.assert_array_equal(np.asarray(one).ravel()[:len(q)], got[0])
    multi, dropped = jsh.sharded_query_multi(mesh, K, qcap, 3, rcap, by_spl)(
        qd, [t.keys for t in jt], [t.counts for t in jt], *extra)
    assert int(np.asarray(dropped).sum()) == 0
    np.testing.assert_array_equal(np.asarray(multi).reshape(3, -1)
                                  [:, :len(q)], got)


def test_hash_route_on_one_shard_is_count_step(samples, tmp_path):
    """At n = 1 the step is count_step (raw keys, sentinels included, no
    counts) and the hash table is the single-device table."""
    batch = torch.from_numpy(_batches(samples["child"][0])[0])
    keys, counts, got, dropped = sharded_count_step(make_mesh(1, "cpu"),
                                                    batch, K)
    raw = count_step(batch, K)
    assert counts is None and dropped == 0 and len(keys) == 1
    np.testing.assert_array_equal(keys[0], raw)
    assert got == [int((raw != codec.SENTINEL).sum())]
    t = _port_hash_table(1, samples["child"][0])
    whole = _whole(samples["child"][0])
    flat = t.to_flat(str(tmp_path / "t.flat"))
    for got in (t.to_host(), flat):
        np.testing.assert_array_equal(np.asarray(got.keys), whole.keys)
        np.testing.assert_array_equal(np.asarray(got.counts), whole.counts)


def test_hash_partition_refusals(samples, tmp_path):
    """A hash table at n > 1 has no flat layout (JAX's message); the
    subtract and the pulls refuse tables of different partitions or
    meshes; a hash table takes no splitters and no spill."""
    reads = samples["mother"][0]
    ht = _port_hash_table(2, reads)
    with pytest.raises(ValueError, match="flat spill needs a range"):
        ht.to_flat(str(tmp_path / "t.flat"))
    rt = _port_table(2, reads)
    other = _port_hash_table(4, reads)
    for pair in ((ht, rt), (rt, ht), (ht, other)):
        with pytest.raises(ValueError, match="different partitions"):
            sharded_subtract_step(pair[0], [pair[1]], MERGE_MIN, MIN_COV,
                                  MAX_DEPTH)
        with pytest.raises(ValueError, match="different partitions"):
            sharded_query_multi(list(pair), np.arange(5, dtype=np.uint64))
    mesh = make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="no splitters"):
        ShardedKmerTable(mesh, K, splitters=np.array([5]), partition="hash")
    with pytest.raises(ValueError, match="flat spill needs a range"):
        ShardedKmerTable(mesh, K, budget=1 << 30, spill=lambda t: None,
                         partition="hash")
    with pytest.raises(ValueError, match="partition must be"):
        ShardedKmerTable(mesh, K, partition="prefix")


def test_scaling_tool_runs_both_routes():
    """tools/scaling.py's measurements at a tiny size on CPU shards (its
    control flow; its times are measured only on cards): both routes give
    equal tables, the range route's phases time one exchange of its
    buffered partials and the hash route's every batch, and the CLI refuses
    to run without a card."""
    from rufus_tpu_torch.tools import scaling

    results = [scaling.bench_mesh(make_mesh(n, "cpu"), per_shard=16,
                                  iters=2, reps=1) for n in (1, 2)]
    scaling.efficiencies(results)
    one, two = results
    assert one["unique_keys"] > 0 and two["reads"] == 2 * one["reads"]
    for route in ("range", "hash"):
        assert one["routes"][route]["exchanged_pairs"] == 0
        assert two["routes"][route]["exchanged_pairs"] > 0
        assert one["routes"][route]["count_scaling_eff"] == 1.0
        assert len(two["routes"][route]["phase_ms"]) == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scaling.main(["--out", "/dev/null"])
