"""The slice as a whole: the port's trio pipeline through the filter against
the JAX package's, on the same small synthetic trio, byte for byte.

Both run with exome=True and -m 5, which skips the ModelDist fit (minutes
of host time; tests/test_torch_modeldist.py compares its pieces), and the
JAX one with sharded="off": conftest gives JAX 8 virtual devices, and the
single-device path is the one the port carries.
"""

import os
import sys

import numpy as np
import pytest
import torch

from rufus_tpu.pipeline import RufusConfig as JaxConfig
from rufus_tpu.pipeline import RufusPipeline as JaxPipeline
from rufus_tpu_torch import synthetic
from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline

K = 25


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
def trio(tmp_path_factory):
    d = tmp_path_factory.mktemp("trio")
    data = synthetic.write_trio(str(d / "fastq"), genome_bp=20_000,
                                coverage=30, n_denovo=4, seed=3)
    return d, data


def _kwargs(data, workdir, **over):
    c, m, f = data["child"], data["mother"], data["father"]
    kw = dict(subject=",".join(c), controls=[",".join(m), ",".join(f)],
              k=K, workdir=str(workdir), exome=True, min_cov=5,
              stop_after="filter", fastq_a=c[0], fastq_b=c[1])
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def jax_run(trio):
    d, data = trio
    wd = d / "jax"
    JaxPipeline(JaxConfig(**_kwargs(data, wd, sharded="off",
                                    table_cap0=1 << 17))).run()
    return wd


def _outputs(wd):
    """Every output file of the slice, by name (trace and logs aside)."""
    return sorted(n for n in os.listdir(wd)
                  if os.path.isfile(os.path.join(wd, n)))


def _assert_same_outputs(port_wd, jax_wd):
    names = _outputs(port_wd)
    assert names == _outputs(jax_wd)
    stubs = [n[: -len(".table.npz")] for n in names if n.endswith(".table.npz")]
    assert len(stubs) == 3
    for n in names:
        a, b = os.path.join(port_wd, n), os.path.join(jax_wd, n)
        if n.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for key in za.files:
                assert za[key].dtype == zb[key].dtype, (n, key)
                np.testing.assert_array_equal(za[key], zb[key])
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), n


def test_slice_matches_jax_pipeline(trio, jax_run, tmp_path):
    d, data = trio
    m1 = RufusPipeline(RufusConfig(**_kwargs(data, tmp_path,
                                             device="cpu"))).run()
    _assert_same_outputs(str(tmp_path), str(jax_run))
    hl = [n for n in os.listdir(tmp_path) if n.endswith(".HashList")]
    assert len(hl) == 1 and os.path.getsize(tmp_path / hl[0]) > 0
    # behaviour, not only parity: the kept pairs span every spiked site
    spanned = synthetic.sites_spanned(m1, data["sites"])
    np.testing.assert_array_equal(spanned, data["sites"])


def test_slice_is_batch_size_independent(trio, jax_run, tmp_path):
    d, data = trio
    RufusPipeline(RufusConfig(**_kwargs(data, tmp_path, device="cpu",
                                        batch_size=333))).run()
    _assert_same_outputs(str(tmp_path), str(jax_run))


def test_unported_options_raise(trio, tmp_path):
    """Multipass counting on more than one shard raises
    NotImplementedError, as in the JAX package (sharded "on" runs:
    tests/test_torch_sharded.py; the memory model too:
    tests/test_torch_memory.py); a mesh of more cards than exist raises
    ValueError (on the CPU: two cards with no CUDA); an unknown stop stage
    or spill_tables, a filter with neither -q1/-q2 nor a BAM/CRAM subject,
    and alignment (through contig_align or the full run) without a
    reference raise ValueError."""
    from rufus_tpu_torch.parallel import make_mesh

    d, data = trio
    cfg = RufusConfig(**_kwargs(data, tmp_path, device="cpu", count_passes=2,
                                sharded="on"))
    with pytest.raises(NotImplementedError):
        RufusPipeline(cfg, mesh=make_mesh(2, "cpu")).run()
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            make_mesh(2, "cuda")
    with pytest.raises(ValueError):
        make_mesh(torch.cuda.device_count() + 1, "cuda")
    for over in ({"k": 32}, {"fastq_a": ""}, {"stop_after": "contig_align"},
                 {"stop_after": ""}, {"stop_after": "interpret"},
                 {"spill_tables": "sometimes"}):
        with pytest.raises(ValueError):
            RufusPipeline(RufusConfig(**_kwargs(data, tmp_path, device="cpu",
                                                **over))).run()
    # the long-read path with no contigs FASTA filters a BAM/CRAM subject
    cfg = RufusConfig(**_kwargs(data, tmp_path, device="cpu",
                                ref=str(tmp_path / "ref.fa")))
    with pytest.raises(ValueError):
        RufusPipeline(cfg).run_longread()
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".npz")]


def _cli_argv(data, workdir, *extra):
    c, m, f = data["child"], data["mother"], data["father"]
    return ["rufus_tpu_torch", "-s", ",".join(c), "-c", ",".join(m),
            "-c", ",".join(f), "-k", str(K), "-m", "5", "--exome",
            "--workdir", str(workdir), "--device", "cpu", *extra]


def test_cli_runs_through_the_hashlist(trio, jax_run, tmp_path, monkeypatch):
    from rufus_tpu_torch.pipeline.__main__ import main

    d, data = trio
    monkeypatch.setattr(sys, "argv", _cli_argv(data, tmp_path, "--stop-after",
                                               "hashlist"))
    main()
    hl = [n for n in os.listdir(jax_run) if n.endswith(".HashList")][0]
    assert (tmp_path / hl).read_bytes() == (jax_run / hl).read_bytes()


@pytest.mark.parametrize("flag", [["-L", "50"], ["--mosaic"], ["--clean"],
                                  ["--pacbio"], ["--regenotype", "t.npz"]])
def test_cli_refuses_later_stage_flags(trio, tmp_path, monkeypatch, flag):
    """The flags of the later stages, refused while those stages were not
    ported, now reach the configuration and the entry point they name:
    none is ignored."""
    from rufus_tpu_torch.ops import count as pcount
    from rufus_tpu_torch.pipeline import __main__ as cli

    d, data = trio
    calls = []

    class Spy(RufusPipeline):
        def run(self):
            calls.append(("run", self.cfg))

        def run_longread(self, contigs=None):
            calls.append(("run_longread", self.cfg, contigs))

        def regenotype(self, tables):
            calls.append(("regenotype", self.cfg, tables))

    monkeypatch.setattr(cli, "RufusPipeline", Spy)
    monkeypatch.setattr(pcount.KmerTable, "load", classmethod(
        lambda cls, path: path))
    monkeypatch.setattr(sys, "argv", _cli_argv(data, tmp_path, "--stop-after",
                                               "filter", "-q1", data["child"][0],
                                               "-q2", data["child"][1], *flag))
    cli.main()
    (entry, cfg, *args), = calls
    assert entry == {"--pacbio": "run_longread",
                     "--regenotype": "regenotype"}.get(flag[0], "run")
    assert cfg.max_allele_size == (50 if flag[0] == "-L" else 1000)
    assert cfg.mosaic == (flag[0] == "--mosaic")
    assert cfg.clean == (flag[0] == "--clean")
    assert args == {"--pacbio": [None],
                    "--regenotype": [["t.npz"]]}.get(flag[0], [])


def test_cuda_default_raises_without_a_card(trio, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, data = trio
    assert RufusConfig().device == "cuda"
    with pytest.raises(RuntimeError):
        RufusPipeline(RufusConfig(**_kwargs(data, tmp_path)))


def test_fastq_readers_match_reference(trio, tmp_path):
    from rufus_tpu.io import fastq as jfq
    from rufus_tpu_torch.io import fastq as pfq

    d, data = trio
    path = data["child"][1]
    recs = list(pfq.read_fastq(path))
    assert recs == list(jfq.read_fastq(path))
    pfq.write_fastq(str(tmp_path / "p.fq"), recs[:50])
    jfq.write_fastq(str(tmp_path / "j.fq"), recs[:50])
    assert (tmp_path / "p.fq").read_bytes() == (tmp_path / "j.fq").read_bytes()
    seqs = [r[1][: 40 + i % 120] for i, r in enumerate(recs[:300])]
    quals = [r[2][: 40 + i % 120] for i, r in enumerate(recs[:300])]
    for a, b in zip(pfq.batch_reads(seqs, quals, pad_to=160),
                    jfq.batch_reads(seqs, quals, pad_to=160)):
        np.testing.assert_array_equal(a, b)
    # the port's chunked reader: same rows as the per-record reference
    want_r, want_q, want_l = jfq.batch_reads([r[1] for r in recs],
                                             [r[2] for r in recs],
                                             pad_to=160)
    got = list(pfq.fastq_batches(path, 700, 160, text=True, max_width=1024,
                                 chunk_bytes=1 << 16))
    assert [len(b) for b in got[:-1]] == [700] * (len(got) - 1)
    np.testing.assert_array_equal(np.concatenate([b.seq for b in got]), want_r)
    np.testing.assert_array_equal(np.concatenate([b.qual for b in got]),
                                  want_q)
    np.testing.assert_array_equal(np.concatenate([b.lens for b in got]),
                                  want_l)
    names = [b.name(i) for b in got for i in range(len(b))]
    assert names == [r[0].split(" ")[0] for r in recs]


def test_exclude_table_drops_its_kmers(trio, jax_run, tmp_path):
    """-e: k-mers of an exclude table (.npz) leave the HashList."""
    from rufus_tpu_torch.io import hashlist as hio
    from rufus_tpu_torch.ops import count

    d, data = trio
    hl = [n for n in os.listdir(jax_run) if n.endswith(".HashList")][0]
    keys = hio.hashlist_keys(str(jax_run / hl), K)
    ex = count.KmerTable(K, keys[::2], np.ones(len(keys[::2]), np.int64))
    ex.save(str(tmp_path / "exclude.npz"))
    out = RufusPipeline(RufusConfig(**_kwargs(
        data, tmp_path / "run", device="cpu", stop_after="hashlist",
        exclude_hash=str(tmp_path / "exclude.npz")))).run()
    np.testing.assert_array_equal(hio.hashlist_keys(out, K), keys[1::2])


def _tree(wd):
    """{relative path: bytes} of every file under wd, the trace aside."""
    out = {}
    for root, _, names in os.walk(wd):
        for n in names:
            if n != "trace.jsonl":
                p = os.path.join(root, n)
                out[os.path.relpath(p, wd)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("flag", [[], ["--saliva"]])
def test_cli_runs_through_contig_align(trio, tmp_path, monkeypatch, flag):
    """-r and --saliva are read by read alignment: through --stop-after
    contig_align the CLI writes what the API does with the same options
    (tests/test_torch_contig.py holds those to the JAX stages)."""
    from rufus_tpu_torch.pipeline.__main__ import main

    d, data = trio
    ref = tmp_path / "ref.fa"
    ref.write_text(f">{synthetic.REF_NAME}\n"
                   + data["genome"].tobytes().decode() + "\n")
    monkeypatch.setattr(sys, "argv", _cli_argv(
        data, tmp_path / "cli", "--stop-after", "contig_align", "-r",
        str(ref), "-q1", data["child"][0], "-q2", data["child"][1], *flag))
    main()
    want = RufusPipeline(RufusConfig(**_kwargs(
        data, tmp_path / "api", device="cpu", stop_after="contig_align",
        ref=str(ref), saliva=bool(flag)))).run()
    got, api = _tree(tmp_path / "cli"), _tree(tmp_path / "api")
    assert got == api
    assert os.path.relpath(want["mob_sam"], tmp_path / "api") in got
    full = [n for n in got if n.endswith(".FULL.sam")]
    assert len(full) == (1 if flag else 0)
