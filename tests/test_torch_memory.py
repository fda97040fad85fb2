"""The memory model: flat tables, the streams over them, the count under a
device budget (LSM run spill), multipass counting and spilled tables
through the full run, against the JAX package on the same inputs.
Tolerance: none; files are compared byte for byte.

The port runs on the CPU (the plain versions of compact_runs and the
searches), the JAX package with sharded="off". The JAX count spills LSM
runs by table slots (hbm_budget_gb / 64 B a slot), the port by the bytes
its folds allocate, so the two spill at other points; the merged table
does not depend on where the runs were cut.
"""

import gzip
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

import rufus_tpu.interpret.driver as jax_interpret
from rufus_tpu.io import bgzf as jbgzf
from rufus_tpu.ops import count as jcount
from rufus_tpu.parallel.sharded import make_splitters as jax_splitters
from rufus_tpu.pipeline import RufusConfig as JaxConfig
from rufus_tpu.pipeline import RufusPipeline as JaxPipeline
import rufus_tpu_torch.interpret.driver as port_interpret
from rufus_tpu_torch import synthetic
from rufus_tpu_torch.ops import codec, count as pcount
from rufus_tpu_torch.ops import table as ptable
from rufus_tpu_torch.ops.table import DeviceKmerTable
from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline
from rufus_tpu_torch.utils import trace

K = 25
CHUNKS = [100, 4096, 10**6]
# the JAX count's budget of 32,768 table slots, and the port's least budget
# whose pending cap holds a batch of 120 reads, and 5% more: both spill
# several runs a sample on the 20 kbp trio at batch 120
TRIO_BUDGET_GB = 32768 * 64 / 2**30
PORT_TRIO_BUDGET_GB = 1.05 * 120 * (160 - K + 1) * ptable.CAP_BYTES / 2**30
FINAL = ".overlap.hashcount.fastq.bam.FINAL.vcf"


@pytest.fixture(autouse=True)
def pinned_date(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: 1700000000)
    monkeypatch.setattr(jax_interpret, "time", clock)
    monkeypatch.setattr(port_interpret, "time", clock)


def _runs(tmp_path, n_runs=4, n=5000, seed=0):
    """Overlapping sorted unique flat runs written by the JAX package."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_runs):
        keys = np.unique(rng.integers(0, 1 << 40, n).astype(np.uint64))
        cnts = rng.integers(1, 6, len(keys)).astype(np.int64)
        paths.append(str(tmp_path / f"run{i}.flat"))
        jcount.KmerTable(K, keys, cnts).save_flat(paths[-1])
    return paths


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_flat_files_open_in_both_packages(tmp_path):
    """save_flat in either package writes the same bytes, which the other
    opens; query and the chunked histo work on the memmap."""
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(0, 1 << 50, 3000).astype(np.uint64))
    cnts = rng.integers(1, 20000, len(keys)).astype(np.int64)
    pcount.KmerTable(K, keys, cnts).save_flat(str(tmp_path / "p.flat"))
    jcount.KmerTable(K, keys, cnts).save_flat(str(tmp_path / "j.flat"))
    assert _bytes(tmp_path / "p.flat") == _bytes(tmp_path / "j.flat")
    assert not os.path.exists(tmp_path / "p.flat.tmp")
    mapped = pcount.KmerTable.load_flat(str(tmp_path / "j.flat"))
    in_memory = pcount.KmerTable(K, np.asarray(mapped.keys),
                                 np.asarray(mapped.counts))
    for pt, mmap in ((mapped, True), (in_memory, False)):
        jt = jcount.KmerTable.load_flat(str(tmp_path / "p.flat"), mmap=mmap)
        assert pt.k == jt.k == K and pt.mapped == mmap
        np.testing.assert_array_equal(pt.keys, keys)
        np.testing.assert_array_equal(pt.counts, jt.counts)
        q = np.concatenate([keys[::7], rng.integers(0, 1 << 50, 500)
                            .astype(np.uint64)])
        np.testing.assert_array_equal(pt.query(q), jt.query(q))
        np.testing.assert_array_equal(pt.histo(chunk=1000), jt.histo())
    npz = str(tmp_path / "t.npz")
    pcount.KmerTable(K, keys, cnts).save(npz)
    with pytest.raises(ValueError, match="not a flat"):
        pcount.KmerTable.load_flat(npz)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("lower", [0, 3])
def test_merge_flat_runs_matches_jax(tmp_path, chunk, lower):
    runs = _runs(tmp_path)
    pt = pcount.merge_flat_runs(runs, str(tmp_path / "p"), lower_count=lower,
                                chunk=chunk)
    jcount.merge_flat_runs(runs, str(tmp_path / "j"), lower_count=lower,
                           chunk=chunk)
    assert _bytes(tmp_path / "p") == _bytes(tmp_path / "j")
    assert pt.mapped and len(pt) > 0
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(r) for r in runs] + ["p", "j"])


@pytest.mark.parametrize("chunk", CHUNKS)
def test_concat_flat_matches_jax(tmp_path, chunk):
    """Flat tables of disjoint ascending key ranges, spliced."""
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(0, 1 << 40, 9000).astype(np.uint64))
    cnts = rng.integers(1, 9, len(keys)).astype(np.int64)
    parts = []
    for i, (a, b) in enumerate([(0, 0), (0, 4000), (4000, 4001),
                                (4001, len(keys))]):
        parts.append(str(tmp_path / f"pass{i}"))
        jcount.KmerTable(K, keys[a:b], cnts[a:b]).save_flat(parts[-1])
    pt = pcount.concat_flat(parts, str(tmp_path / "p"), chunk=chunk)
    jcount.concat_flat(parts, str(tmp_path / "j"), chunk=chunk)
    assert _bytes(tmp_path / "p") == _bytes(tmp_path / "j")
    np.testing.assert_array_equal(pt.keys, keys)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_subtract_unique_stream_matches_jax(tmp_path, chunk):
    """The subject streamed against two controls, memmapped or not."""
    runs = _runs(tmp_path, n_runs=3, n=8000, seed=3)
    mapped = [pcount.KmerTable.load_flat(r) for r in runs]
    in_memory = [pcount.KmerTable(K, np.asarray(t.keys), np.asarray(t.counts))
                 for t in mapped]
    for pt, mmap in ((mapped, True), (in_memory, False)):
        jt = [jcount.KmerTable.load_flat(r, mmap=mmap) for r in runs]
        for merge_min, min_cov, max_depth in ((2, 3, 4), (5, 1, 100)):
            got = pcount.subtract_unique_stream(pt, merge_min, min_cov,
                                                max_depth, chunk=chunk)
            want = jcount.subtract_unique_stream(jt, merge_min, min_cov,
                                                 max_depth, chunk=chunk)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert len(got[0]) > 0


def test_merge_flat_runs_is_atomic(tmp_path, monkeypatch):
    """A merge interrupted after its first chunk leaves the previous output
    as it was and no temporary file; an uninterrupted one replaces it."""
    runs = _runs(tmp_path)
    out = tmp_path / "out.flat"
    out.write_bytes(b"previous")
    real = pcount.compact_runs
    calls = []

    def interrupted(*a):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(*a)

    monkeypatch.setattr(pcount, "compact_runs", interrupted)
    with pytest.raises(KeyboardInterrupt):
        pcount.merge_flat_runs(runs, str(out), chunk=1000)
    assert out.read_bytes() == b"previous"
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(r) for r in runs] + ["out.flat"])
    monkeypatch.setattr(pcount, "compact_runs", real)
    pcount.merge_flat_runs(runs, str(out), chunk=1000)
    jcount.merge_flat_runs(runs, str(tmp_path / "j"), chunk=1000)
    assert out.read_bytes() == _bytes(tmp_path / "j")


def _sample_fastq(tmp_path, seed, n=400, dup=150):
    """The JAX package's spill-test sample: random 70-base reads, the first
    `dup` of them twice (counts > 1, split across runs)."""
    rng = np.random.default_rng(seed)
    seqs = ["".join("ACGT"[j] for j in rng.integers(0, 4, 70))
            for _ in range(n)]
    seqs += seqs[:dup]
    fq = str(tmp_path / "s.fastq")
    with open(fq, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    return fq


def _count_kw(fq):
    return dict(subject=fq, controls=[], ref="unused.fa", k=13,
                batch_size=64, read_pad=96)


def test_lsm_spill_count_matches_jax(tmp_path):
    """spill_tables="on" under a budget that spills several runs: the
    merged .table.flat and .Jhash.histo equal the JAX package's spilled
    run (tests/test_pipeline_aux.py's case) byte for byte, and the table
    equals the port's unconstrained count."""
    fq = _sample_fastq(tmp_path, 88)
    JaxPipeline(JaxConfig(workdir=str(tmp_path / "j"), sharded="off",
                          spill_tables="on", table_cap0=1 << 10,
                          hbm_budget_gb=8192 * 64 / 2**30,
                          **_count_kw(fq))).count_sample(fq, "S", lower=2)
    pipe = RufusPipeline(RufusConfig(workdir=str(tmp_path / "p"), device="cpu",
                                     spill_tables="on",
                                     hbm_budget_gb=0.375 / 1024,
                                     **_count_kw(fq)))
    got = pipe.count_sample(fq, "S", lower=2)
    assert pipe._runs["S"] >= 3 and got.mapped
    for name in ("S.table.flat", "S.Jhash.histo"):
        assert _bytes(tmp_path / "p" / name) == _bytes(tmp_path / "j" / name)
    assert not [n for n in os.listdir(tmp_path / "p") if ".run" in n]
    plain = RufusPipeline(RufusConfig(workdir=str(tmp_path / "plain"),
                                      device="cpu", **_count_kw(fq)))
    want = plain.count_sample(fq, "S", lower=2)
    np.testing.assert_array_equal(np.asarray(got.keys), want.keys)
    np.testing.assert_array_equal(np.asarray(got.counts), want.counts)


def test_lsm_spill_at_the_last_fold_is_merged(tmp_path):
    """A budget whose first crossing is the fold after the stream ends
    (the last batch still pending): that spill's run is merged with the
    rest, so the table equals the unconstrained count and no run is left
    on disk. The budget is reckoned from the batches' own unique keys:
    each batch fits the pending cap alone, two do not, the first three
    folds stay within it, and the short last batch, below a quarter of
    the table, waits for the flush after the stream, whose merge passes
    it."""
    rng = np.random.default_rng(9)
    seqs = ["".join("ACGT"[j] for j in rng.integers(0, 4, 96))
            for _ in range(3 * 64 + 6)]
    fq = str(tmp_path / "s.fastq")
    with open(fq, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    kw = _count_kw(fq)
    plain = RufusPipeline(RufusConfig(workdir=str(tmp_path / "plain"),
                                      device="cpu", **kw))
    batches = [ptable.count_step(b, kw["k"])
               for b in plain._batch_stream(fq, None)]
    assert len(batches) == 4
    n, last = batches[0].numel(), batches[3].numel()
    uniq = [pcount.count_batch(b)[0] for b in batches]
    first = [len(torch.unique(torch.cat(uniq[:i]))) for i in (1, 2, 3)]
    merge = ptable.RUN_MERGE_BYTES
    budget = merge * (first[2] + len(uniq[3])) - 1
    cap = budget // ptable.CAP_BYTES
    assert n < cap < 2 * n and 4 * last < first[2]
    for i in (1, 2):
        assert merge * (first[i - 1] + len(uniq[i])) <= budget
        assert (ptable.TABLE_BYTES * first[i - 1] + ptable.PENDING_BYTES * n
                <= budget)
    pipe = RufusPipeline(RufusConfig(workdir=str(tmp_path / "p"), device="cpu",
                                     spill_tables="on",
                                     hbm_budget_gb=budget / 2**30, **kw))
    got = pipe.count_sample(fq, "S", lower=1)
    assert pipe._runs["S"] == 2
    want = plain.count_sample(fq, "S", lower=1)
    np.testing.assert_array_equal(np.asarray(got.keys), want.keys)
    np.testing.assert_array_equal(np.asarray(got.counts), want.counts)
    assert not [n for n in os.listdir(tmp_path / "p") if ".run" in n]


def test_multipass_count_matches_jax(tmp_path):
    """count_passes=3: the same key ranges as the JAX package's (from the
    first batch), and the same .table.flat and .Jhash.histo."""
    fq = _sample_fastq(tmp_path, 77, n=300, dup=80)
    jax_pipe = JaxPipeline(JaxConfig(workdir=str(tmp_path / "j"),
                                     sharded="off", count_passes=3,
                                     table_cap0=1 << 12, **_count_kw(fq)))
    jax_pipe.count_sample(fq, "S", lower=1)
    pipe = RufusPipeline(RufusConfig(workdir=str(tmp_path / "p"),
                                     device="cpu", count_passes=3,
                                     **_count_kw(fq)))
    pipe.count_sample(fq, "S", lower=1)
    assert pipe._pass_bounds[1:-1] == [int(b) for b in
                                       jax_pipe._pass_bounds[1:-1]]
    for name in ("S.table.flat", "S.Jhash.histo"):
        assert _bytes(tmp_path / "p" / name) == _bytes(tmp_path / "j" / name)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j"))


def test_make_splitters_matches_jax():
    """The port's copy of make_splitters on int64 keys (a tensor, a list of
    them) against the JAX one on the same uint64 keys."""
    rng = np.random.default_rng(4)
    for n, parts in ((200_000, 4), (1000, 3), (10, 8)):
        keys = rng.integers(0, 1 << 50, n).astype(np.int64)
        keys[::5] = codec.SENTINEL
        u64 = codec.keys_i64_to_u64(keys)
        np.testing.assert_array_equal(
            ptable.make_splitters(torch.from_numpy(keys), parts),
            jax_splitters(u64, parts).astype(np.int64))
        np.testing.assert_array_equal(
            ptable.make_splitters([torch.from_numpy(keys[: n // 2]),
                                   torch.from_numpy(keys[n // 2:])], parts),
            jax_splitters([u64[: n // 2], u64[n // 2:]], parts)
            .astype(np.int64))


def _batches(seed, n_batches=12, B=64, L=96, k=13):
    rng = np.random.default_rng(seed)
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), 8000)
    out = []
    for _ in range(n_batches):
        starts = rng.integers(0, len(g) - L, B)
        reads = g[starts[:, None] + np.arange(L)[None, :]].copy()
        err = rng.random(reads.shape) < 0.03
        reads[err] = rng.choice(np.frombuffer(b"ACGT", np.uint8), err.sum())
        out.append(ptable.count_step(torch.from_numpy(reads), k))
    return out


@pytest.mark.parametrize("budget_keys", [12288, 16384])
def test_table_under_a_budget_spills_and_keeps_its_counts(tmp_path,
                                                          budget_keys):
    """A DeviceKmerTable whose budget holds a fraction of the table spills
    its committed table (to_flat + reset) before a fold would pass the
    budget; the merge-sum of its runs equals the unconstrained table. A
    batch above the pending cap raises."""
    batches = _batches(5)
    runs = []

    def spill(t):
        runs.append(str(tmp_path / f"run{len(runs)}"))
        t.to_flat(runs[-1])
        t.reset()

    budget = budget_keys * ptable.RUN_MERGE_BYTES
    dev = DeviceKmerTable(13, "cpu", budget=budget, spill=spill)
    plain = DeviceKmerTable(13, "cpu")
    for b in batches:
        dev.fold_batch(b)
        plain.fold_batch(b)
    runs.append(str(tmp_path / "last"))
    dev.to_flat(runs[-1])
    assert dev.spills == len(runs) - 1 >= 2
    assert max(len(pcount.KmerTable.load_flat(r)) for r in runs) \
        <= budget_keys
    got = pcount.merge_flat_runs(runs, str(tmp_path / "merged"), chunk=500)
    want = plain.to_host()
    np.testing.assert_array_equal(np.asarray(got.keys), want.keys)
    np.testing.assert_array_equal(np.asarray(got.counts), want.counts)
    small = DeviceKmerTable(13, "cpu", budget=budget // 4, spill=spill)
    with pytest.raises(RuntimeError, match="passes the device budget"):
        small.fold_batch(batches[0])


def test_memory_attribution_and_malloc_trim():
    got = trace.memory_attribution(torch.device("cpu"), trim=True)
    assert got["rss_mb"] > 0 and "heap_in_use_mb" in got
    assert isinstance(trace.malloc_trim(), bool)


# -- the full run with spilled tables ------------------------------------------


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    d = tmp_path_factory.mktemp("memtrio")
    data = synthetic.write_trio(str(d / "fastq"), genome_bp=20_000,
                                coverage=30, n_denovo=4, seed=3)
    (d / "ref.fa").write_text(">1\n" + data["genome"].tobytes().decode()
                              + "\n")
    return d, data


def _trio_kw(d, data, **over):
    c, m, f = data["child"], data["mother"], data["father"]
    kw = dict(subject=",".join(c), controls=[",".join(m), ",".join(f)],
              fastq_a=c[0], fastq_b=c[1], k=K, exome=True, min_cov=5,
              ref=str(d / "ref.fa"), mosaic=True, batch_size=120)
    kw.update(over)
    return kw


def _files(wd):
    return sorted(os.path.relpath(os.path.join(root, n), wd)
                  for root, _, names in os.walk(wd) for n in names
                  if n != "trace.jsonl")


def _in_turn(base, runs):
    """Each (name, fn) of `runs` called on a workdir at the same path,
    base/work (the interpret VCF holds the workdir's path), moved to
    base/name afterwards. Returns {name: (result, workdir)}."""
    work = base / "work"
    out = {}
    for name, fn, start in runs:
        if start is None:
            work.mkdir()
        else:
            shutil.copytree(start, work)
        out[name] = (fn(str(work)), base / name)
        os.rename(work, base / name)
    return out


def _trace(wd, stage):
    import json

    with open(os.path.join(wd, "Intermediates", "trace.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["stage"] == stage][-1]


@pytest.fixture(scope="module")
def spilled(trio, tmp_path_factory):
    """The trio to FINAL.vcf three times in one directory: the port with
    spilled tables, the JAX package with spilled tables, the port
    resident."""
    d, data = trio
    base = tmp_path_factory.mktemp("spilled")
    spill = dict(spill_tables="on", hbm_budget_gb=PORT_TRIO_BUDGET_GB)
    jax_spill = dict(spill, hbm_budget_gb=TRIO_BUDGET_GB)
    clock = types.SimpleNamespace(time=lambda: 1700000000)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_interpret, "time", clock)
    mp.setattr(port_interpret, "time", clock)
    try:
        return _in_turn(base, [
            ("port", lambda wd: RufusPipeline(RufusConfig(
                workdir=wd, device="cpu", **_trio_kw(d, data, **spill))).run(),
             None),
            ("jax", lambda wd: JaxPipeline(JaxConfig(
                workdir=wd, sharded="off", table_cap0=1 << 10,
                **_trio_kw(d, data, **jax_spill))).run(), None),
            ("resident", lambda wd: RufusPipeline(RufusConfig(
                workdir=wd, device="cpu",
                **_trio_kw(d, data, spill_tables="off"))).run(), None)])
    finally:
        mp.undo()


def test_spilled_trio_matches_jax_and_resident_run(spilled):
    """Every file of the spilled run (flat tables, histograms, HashList,
    kept pairs, SAMs, interpret VCF, FINAL.vcf and its .gz/.tbi) equals
    the JAX package's spilled run byte for byte, and the port's resident
    run but for the tables' format; each sample spilled LSM runs, and the
    subtract took the streamed path."""
    (got, port), (want, jax), (res_final, res) = (
        spilled["port"], spilled["jax"], spilled["resident"])
    assert got == want and got.endswith(FINAL)
    names = _files(port)
    assert names == _files(jax)
    for n in names:
        assert _bytes(port / n) == _bytes(jax / n), n
    flats = [n for n in names if n.endswith(".table.flat")]
    assert len(flats) == 3 and not [n for n in names if n.endswith(".npz")]
    count_rec = _trace(port, "count")
    assert min(count_rec["lsm_runs"].values()) >= 2 and count_rec["flat"]
    assert _trace(port, "hashlist")["path"] == "host-stream"
    assert _trace(res, "hashlist")["path"] == "device"
    res_names = _files(res)
    assert res_names == [n.replace(".table.flat", ".table.npz")
                         for n in names]
    for n in names:
        if n.endswith(".table.flat"):
            t = pcount.KmerTable.load_flat(str(port / n))
            z = np.load(res / n.replace(".table.flat", ".table.npz"))
            np.testing.assert_array_equal(t.keys, z["keys"])
            np.testing.assert_array_equal(t.counts, z["counts"])
        else:
            assert _bytes(port / n) == _bytes(res / n), n
    rows = [line for line in open(port / os.path.basename(got))
            if not line.startswith("#")]
    assert rows


def test_spill_tables_off_spills_nothing(trio, tmp_path):
    """spill_tables="off" turns the LSM guard off too: a budget far below
    the table spills no run and the tables stay resident; "auto" on the
    CPU spills nothing either."""
    d, data = trio
    for mode in ("off", "auto"):
        pipe = RufusPipeline(RufusConfig(
            workdir=str(tmp_path / mode), device="cpu",
            **_trio_kw(d, data, spill_tables=mode, hbm_budget_gb=1e-6,
                       stop_after="hashlist")))
        pipe.run()
        names = os.listdir(tmp_path / mode)
        assert not [n for n in names if ".flat" in n]
        assert len([n for n in names if n.endswith(".table.npz")]) == 3
        assert pipe._runs == {} and len(pipe._dev_tables) == 3
        assert _trace(str(tmp_path / mode), "count")["lsm_runs"] == {}


def test_regenotype_with_flat_tables_matches_jax(trio, spilled, tmp_path):
    """regenotype on a fresh pipeline over the spilled run: the subject
    from its .table.flat (_load_table), the parents opened with
    load_flat; every file equals the JAX package's (its FINAL.vcf.gz and
    .tbi written after its regenotype, as the port's regenotype writes
    them), the .gz inflates to FINAL.vcf, and FINAL.vcf is the run's."""
    _, start = spilled["port"]
    final = _bytes(start / os.path.basename(spilled["port"][0]))
    kw = _trio_kw(*trio)

    def parents(load, wd, cfg):
        return [load(os.path.join(wd, cfg.control_stub(c) + ".table.flat"))
                for c in cfg.controls]

    def port(wd):
        pipe = RufusPipeline(RufusConfig(workdir=wd, device="cpu", **kw))
        tables = parents(pcount.KmerTable.load_flat, wd, pipe.cfg)
        assert pipe._load_table(pipe.cfg.subject_stub).mapped
        return pipe.regenotype(tables)

    def jax(wd):
        pipe = JaxPipeline(JaxConfig(workdir=wd, sharded="off", **kw))
        final = pipe.regenotype(parents(jcount.KmerTable.load_flat, wd,
                                        pipe.cfg))
        # the port's regenotype writes FINAL.vcf.gz and .tbi anew, as run()
        # does; the JAX package leaves run()'s stale ones
        jbgzf.bgzip_tabix_vcf(final, keep_plain=True)
        return final

    out = _in_turn(tmp_path, [("port", port, start), ("jax", jax, start)])
    (got, pwd), (want, jwd) = out["port"], out["jax"]
    assert got == want and got.endswith(FINAL)
    names = _files(pwd)
    assert names == _files(jwd)
    for n in names:
        assert _bytes(pwd / n) == _bytes(jwd / n), n
    with gzip.open(str(pwd / os.path.basename(got)) + ".gz", "rb") as f:
        assert f.read() == _bytes(pwd / os.path.basename(got))
    # the run's own workdir lies elsewhere: the #CHROM line's sample
    # column (the workdir's path) differs
    same = lambda b: [line for line in b.split(b"\n")  # noqa: E731
                      if not line.startswith(b"#CHROM")]
    assert same(_bytes(pwd / os.path.basename(got))) == same(final)


def test_cli_regenotype_refuses_flat_tables(trio, tmp_path, monkeypatch):
    """--regenotype loads .npz tables as the JAX CLI does; a .flat path
    raises a ValueError that says so, before any stage runs."""
    from rufus_tpu_torch.pipeline.__main__ import main

    d, data = trio
    flat = tmp_path / "mother.table.flat"
    pcount.KmerTable(K, np.arange(4, dtype=np.uint64),
                     np.ones(4, np.int64)).save_flat(str(flat))
    monkeypatch.setattr(sys, "argv", [
        "rufus_tpu_torch", "-s", ",".join(data["child"]), "-k", str(K),
        "-r", str(d / "ref.fa"), "--workdir", str(tmp_path / "wd"),
        "--device", "cpu", "--regenotype", str(flat)])
    with pytest.raises(ValueError, match="flat table"):
        main()
    assert not os.path.exists(tmp_path / "wd" / "Intermediates"
                              / "trace.jsonl")
