"""The port's process mesh (rufus_tpu_torch/parallel/process.py and the
steps of parallel/sharded.py between ranks) on the CPU: gloo ranks spawned
through torch.multiprocessing's "spawn" start method, the group joined
through a file store in a temporary directory (so that test workers never
share a port), 2 ranks x 1, 2 and 3 shards. Each run's tables, shard
sizes, splitters, HashList, keep masks and pulls must equal the single-process make_mesh(n, "cpu") run's
and the JAX package's one-shard results. Inputs: the seeded reads of
tests/test_torch_sharded.py (20 kbp genome, k = 25, 96-read batches).
Tolerance: none. Every spawn has a timeout: a rank that hangs fails the
test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rufus_tpu.ops import count as jcount
from rufus_tpu.ops import filter as jfilter
from rufus_tpu.parallel import make_splitters as jax_make_splitters
from rufus_tpu_torch.ops import codec
from rufus_tpu_torch.ops.table import count_step
from rufus_tpu_torch.parallel import (ShardMesh, local_rows, make_mesh,
                                      make_process_mesh)
from rufus_tpu_torch.tools import multiproc_smoke
from test_torch_sharded import (  # noqa: F401  (fixtures)
    B, K, LOWER, MAX_DEPTH, MERGE_MIN, MIN_COV, _batches, _jax_keys,
    one_torch_thread, samples)

CONFIGS = {"2x1": (2, 1), "2x2": (2, 2), "2x3": (2, 3)}
MIN_Q, THRESHOLD = 15, 1
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def queries(samples):
    """Present k-mers of each sample and absent ones, shuffled: 301, a
    multiple of none of 2, 4 and 6."""
    rng = np.random.default_rng(9)
    present = []
    for s in ("child", "mother", "father"):
        keys = torch.unique(count_step(torch.from_numpy(
            _batches(samples[s][0])[0]), K))
        present.append(codec.keys_i64_to_u64(
            keys[keys != codec.SENTINEL].numpy())[::29])
    q = np.concatenate(present + [rng.integers(0, 1 << 50, 60,
                                               dtype=np.uint64)])
    return rng.permutation(q)[:301]


def _args(samples, queries):
    return ({"child": samples["child"], "mother": samples["mother"][0],
             "father": samples["father"][0]}, K, B, queries, LOWER,
            MERGE_MIN, MIN_COV, MAX_DEPTH, MIN_Q, THRESHOLD)


@pytest.fixture(scope="module")
def process_runs(samples, queries):
    """{config: each rank's run_chain arrays} of the spawned gloo runs."""
    return {name: multiproc_smoke.spawn_ranks(
        multiproc_smoke.run_chain, world, "cpu", local,
        _args(samples, queries), timeout=TIMEOUT_S)
        for name, (world, local) in CONFIGS.items()}


@pytest.fixture(scope="module")
def single_runs(samples, queries):
    """{n: run_chain on the single-process make_mesh(n, "cpu")}."""
    return {n: multiproc_smoke.run_chain(make_mesh(n, "cpu"),
                                         *_args(samples, queries))
            for n in {w * loc for w, loc in CONFIGS.values()}}


@pytest.fixture(scope="module")
def jax_one_shard(samples, queries):
    """The JAX package's one-shard results: the floored tables, the
    HashList (subtract_unique + the subject's count range), the keep mask
    of the child's reads and the pulls."""
    tables = []
    for s in ("child", "mother", "father"):
        keys, counts, _ = jcount.count_reads_batch(
            jnp.asarray(samples[s][0]), K)
        tables.append(jcount.KmerTable.from_rle_chunks(
            K, [(np.asarray(keys), np.asarray(counts), 0)],
            lower_count=LOWER))
    hl = jcount.subtract_unique(tables, merge_min=MERGE_MIN)
    sc = tables[0].query(hl)
    ok = (sc >= max(MERGE_MIN, MIN_COV)) & (sc <= MAX_DEPTH)
    r, q, l = samples["child"]
    keep = np.asarray(jfilter.window_hits(
        jnp.asarray(r), jnp.asarray(q), jnp.asarray(l), jnp.asarray(hl[ok]),
        K, MIN_Q)) >= THRESHOLD
    return {"tables": tables, "hl_keys": hl[ok], "hl_counts": sc[ok],
            "keep": keep, "pulls": np.stack([t.query(queries)
                                             for t in tables])}


def _rank_meshes(world, local):
    """Meshes with each rank's place, for local_rows (no group needed)."""
    return [ShardMesh((torch.device("cpu"),) * local, rank=r, world=world)
            for r in range(world)]


def _global_keep(runs, world, local, n_rows):
    """The ranks' keep masks put back in row order: each rank's is its rows
    of each batch in turn."""
    out, at = [], [0] * world
    for i in range(0, n_rows, B):
        for r, mesh in enumerate(_rank_meshes(world, local)):
            m = len(local_rows(mesh, range(i, min(i + B, n_rows))))
            out.append(runs[r]["keep"][at[r]:at[r] + m])
            at[r] += m
    return np.concatenate(out)


@pytest.mark.parametrize("config", CONFIGS)
def test_process_tables_match(process_runs, single_runs, jax_one_shard,
                              config):
    """Every rank's gathered tables, and every shard's size, equal the
    single-process mesh's; the tables equal JAX's one-shard tables."""
    world, local = CONFIGS[config]
    single = single_runs[world * local]
    for run in process_runs[config]:
        for i, jt in enumerate(jax_one_shard["tables"]):
            for plane in ("keys", "counts"):
                got = run[f"table{i}_{plane}"]
                np.testing.assert_array_equal(got,
                                              single[f"table{i}_{plane}"])
                np.testing.assert_array_equal(got, getattr(jt, plane))
        np.testing.assert_array_equal(run["shard_keys"],
                                      single["shard_keys"])
    assert single["shard_keys"].shape == (3, world * local)


@pytest.mark.parametrize("config", CONFIGS)
def test_process_splitters_match(process_runs, single_runs, samples, config):
    """Every rank freezes the splitters that the single-process mesh and
    JAX's make_splitters give for the same batches."""
    world, local = CONFIGS[config]
    n = world * local
    want = jax_make_splitters([_jax_keys(n, b) for b in
                               _batches(samples["child"][0])[:16]], n)
    for run in process_runs[config]:
        np.testing.assert_array_equal(run["splitters"],
                                      single_runs[n]["splitters"])
        np.testing.assert_array_equal(run["splitters"],
                                      codec.keys_u64_to_i64(want))


@pytest.mark.parametrize("config", CONFIGS)
def test_process_hashlist_matches(process_runs, single_runs, jax_one_shard,
                                  config):
    """Every rank gets the whole sorted HashList and its subject counts."""
    world, local = CONFIGS[config]
    for run in process_runs[config]:
        for plane in ("keys", "counts"):
            got = run[f"hl_{plane}"]
            np.testing.assert_array_equal(
                got, single_runs[world * local][f"hl_{plane}"])
            np.testing.assert_array_equal(got, jax_one_shard[f"hl_{plane}"])
    assert len(jax_one_shard["hl_keys"]) > 0


@pytest.mark.parametrize("config", CONFIGS)
def test_process_keep_and_pulls_match(process_runs, single_runs,
                                      jax_one_shard, samples, queries,
                                      config):
    """The ranks' keep masks of their rows, and the pulls of their queries
    (routed to owners on any rank and back), put together equal the
    single-process run's and JAX's."""
    world, local = CONFIGS[config]
    runs = process_runs[config]
    single = single_runs[world * local]
    keep = _global_keep(runs, world, local, len(samples["child"][0]))
    np.testing.assert_array_equal(keep, single["keep"])
    np.testing.assert_array_equal(keep, jax_one_shard["keep"])
    assert 0 < keep.sum() < len(keep)
    pulls = np.concatenate([r["pulls"] for r in runs], axis=1)
    np.testing.assert_array_equal(pulls, single["pulls"])
    np.testing.assert_array_equal(pulls, jax_one_shard["pulls"])
    assert (pulls == 0).any() and (pulls > 0).any()
    sizes = [r["pulls"].shape[1] for r in runs]
    assert sizes == [len(local_rows(m, queries))
                     for m in _rank_meshes(world, local)]


def test_local_rows_cut_as_tensor_split():
    """A rank's rows are its shards' tensor_split slices, for any batch
    size (more shards than rows too)."""
    for world, local in ((2, 1), (2, 2), (3, 2)):
        n = world * local
        for rows in (0, 1, 5, 11, 96, 97):
            t = torch.arange(rows)
            want = t.tensor_split(n)
            for mesh in _rank_meshes(world, local):
                got = local_rows(mesh, t)
                np.testing.assert_array_equal(got, torch.cat(
                    want[mesh.first:mesh.first + local]))
                assert [len(p) for p in got.tensor_split(local)] == [
                    len(p) for p in want[mesh.first:mesh.first + local]]


def test_make_process_mesh_refuses(tmp_path):
    """No group: RuntimeError. In a one-rank gloo group: "cuda" with no
    card raises RuntimeError, and the CPU mesh holds every shard."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_process_mesh(2, "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA"):
                make_process_mesh(1, "cuda")
        with pytest.raises(ValueError):
            make_process_mesh(0, "cpu")
        mesh = make_process_mesh(3, "cpu")
        assert (mesh.n, mesh.local, mesh.rank, mesh.first) == (3, 3, 0, 0)
    finally:
        dist.destroy_process_group()


def test_smoke_tool_on_gloo_ranks(monkeypatch, capsys):
    """python -m rufus_tpu_torch.tools.multiproc_smoke --device cpu on two
    gloo ranks of two shards passes; on "cuda" with no card it raises
    rather than fall back."""
    monkeypatch.setenv("SMOKE_PROCS", "2")
    multiproc_smoke.main(["--device", "cpu", "--local-shards", "2"])
    assert "MULTIPROC SMOKE PASS" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multiproc_smoke.main([])
