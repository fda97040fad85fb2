"""The full run: the port's pipeline to FINAL.vcf, .vcf.gz and .tbi against
the JAX package's, on the 20 kbp synthetic trio of
tests/test_torch_contig.py with its reference contig named "1" (polish
keeps only rows on contigs named (chr)?[1-9XY]). Tolerance: none; every
file in the workdir (the trace aside) is compared byte for byte, and so
is the returned path.

The interpret VCF's ##fileDate is the wall clock in both packages; the
tests pin it in both interpret drivers. The sample column of the VCF
header holds the workdir's path, so the two packages run one after the
other in the same directory, each on its own copy of the starting
workdir, which is then moved aside. Every case but the first starts from
a copy of one port run through contig_align (paired from FASTQ, or
single-end from the child BAM), so only contig alignment, interpret and
polish run twice; the first runs the port from the FASTQ files. The port
runs on the CPU, the JAX package with sharded="off", both with
exome=True and -m 5.
"""

import gzip
import os
import runpy
import shutil
import sys
import types

import numpy as np
import pytest

import rufus_tpu.interpret.driver as jax_interpret
from rufus_tpu.io import bgzf as jbgzf
from rufus_tpu.ops import count as jcount
from rufus_tpu.pipeline import RufusConfig as JaxConfig
from rufus_tpu.pipeline import RufusPipeline as JaxPipeline
import rufus_tpu_torch.interpret.driver as port_interpret
import rufus_tpu_torch.pipeline.driver as port_driver
from rufus_tpu_torch import synthetic
from rufus_tpu_torch.io import bgzf
from rufus_tpu_torch.ops import count as pcount
from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline

K = 25
NS = "child.R1.fastq.generator.V2"
FINAL = ".overlap.hashcount.fastq.bam.FINAL.vcf"


@pytest.fixture(autouse=True)
def pinned_date(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: 1700000000)
    monkeypatch.setattr(jax_interpret, "time", clock)
    monkeypatch.setattr(port_interpret, "time", clock)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """The trio's FASTQ and BAM files and its reference FASTA (contig
    "1")."""
    d = tmp_path_factory.mktemp("vcftrio")
    data = synthetic.write_trio(str(d / "fastq"), genome_bp=20_000,
                                coverage=30, n_denovo=4, seed=3)
    bams = synthetic.write_trio_bams(data, str(d / "bam"), seed=3)
    (d / "ref.fa").write_text(">1\n" + data["genome"].tobytes().decode()
                              + "\n")
    return d, data, bams


def _kwargs(d, data, bams, single_end=False, **over):
    if single_end:
        kw = dict(subject=bams["child"],
                  controls=[bams["mother"], bams["father"]],
                  single_end=True)
    else:
        c, m, f = data["child"], data["mother"], data["father"]
        kw = dict(subject=",".join(c), controls=[",".join(m), ",".join(f)],
                  fastq_a=c[0], fastq_b=c[1])
    kw.update(k=K, exome=True, min_cov=5, ref=str(d / "ref.fa"))
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def aligned(trio):
    """The port's run through contig_align, paired and single-end: the
    workdirs the resumed cases copy."""
    d, data, bams = trio
    out = {}
    for key, se in (("paired", False), ("single_end", True)):
        wd = d / f"aligned_{key}"
        RufusPipeline(RufusConfig(**_kwargs(d, data, bams, se,
                                            workdir=str(wd), device="cpu",
                                            stop_after="contig_align"))).run()
        out[key] = wd
    return out


def _files(wd):
    """Every file under a workdir, by relative path, the trace aside."""
    return sorted(os.path.relpath(os.path.join(root, n), wd)
                  for root, _, names in os.walk(wd) for n in names
                  if n != "trace.jsonl")


def _assert_same_files(port_wd, jax_wd):
    names = _files(port_wd)
    assert names == _files(jax_wd)
    for n in names:
        a, b = os.path.join(port_wd, n), os.path.join(jax_wd, n)
        if n.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for key in za.files:
                np.testing.assert_array_equal(za[key], zb[key])
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), n


def _rows(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def run_both(tmp_path, base, port_fn, jax_fn, drop=(), port_base=True):
    """port_fn and jax_fn, each given the path of one workdir, "work",
    that holds a copy of `base` less the files `drop` (for the port, an
    empty one unless port_base); asserts equal returns and files. Returns
    the port's result and workdir (moved to "port")."""
    work = tmp_path / "work"
    got = {}
    for name, fn in (("port", port_fn), ("jax", jax_fn)):
        if name == "port" and not port_base:
            work.mkdir()
        else:
            shutil.copytree(base, work)
        for rel in drop:
            os.remove(work / rel)
        got[name] = fn(str(work))
        os.rename(work, tmp_path / name)
    assert got["port"] == got["jax"]
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    return got["port"], tmp_path / "port"


def _port_run(kw):
    return lambda wd: RufusPipeline(RufusConfig(workdir=wd, device="cpu",
                                                **kw)).run()


def _jax_run(kw):
    return lambda wd: JaxPipeline(JaxConfig(workdir=wd, sharded="off",
                                            **kw)).run()


def _parent_tables(load, wd, cfg):
    return [load(os.path.join(wd, cfg.control_stub(c) + ".table.npz"))
            for c in cfg.controls]


def _check_final(final, port_wd, want_rows):
    """The FINAL.vcf of a full run: its .gz and .tbi exist, the tabix
    query over the whole contig returns its rows, and the interpret VCF has
    rows; `want_rows` asks for FINAL.vcf rows too."""
    assert final.endswith(FINAL)
    final = str(port_wd / os.path.basename(final))
    assert _rows(final[: -len(".FINAL.vcf")] + ".vcf")
    rows = _rows(final)
    assert rows or not want_rows
    got = bgzf.tabix_query(final + ".gz", "1", 0, 20_000)
    assert got == sorted({r.rstrip("\n") for r in rows})


@pytest.mark.parametrize("case", ["paired", "mosaic", "single_end", "clean",
                                  "max_allele"])
def test_full_run_matches_jax(trio, aligned, tmp_path, monkeypatch, case):
    """run() to FINAL.vcf: from the FASTQ files (the port from nothing, the
    JAX package resumed from the port's contig_align workdir), with
    mosaic, single-end from the child BAM, with clean (the same files are
    left), and with -L 37 (which reaches interpret)."""
    d, data, bams = trio
    se = case == "single_end"
    over = {"mosaic": dict(mosaic=True), "clean": dict(clean=True),
            "max_allele": dict(max_allele_size=37)}.get(case, {})
    kw = _kwargs(d, data, bams, se, **over)
    seen = []
    if case == "max_allele":
        real = port_driver.run_interpret

        def spy(*a, **k):
            seen.append(k["max_variant_size"])
            return real(*a, **k)

        monkeypatch.setattr(port_driver, "run_interpret", spy)
    got, port_wd = run_both(tmp_path, aligned["single_end" if se else
                                              "paired"],
                            _port_run(kw), _jax_run(kw),
                            port_base=case != "paired")
    if case == "max_allele":
        assert seen == [37]
    if case == "clean":
        names = os.listdir(port_wd)
        assert not any(n.endswith((".table.npz", ".HashList", ".Jhash.histo",
                                   ".hashcount.fastq", ".bam.vcf"))
                       for n in names)
        assert any(n.endswith(FINAL) for n in names)
        return
    _check_final(got, port_wd, want_rows=case == "mosaic")


@pytest.mark.parametrize("case", ["contigs_fasta", "bam_reads"])
def test_longread_matches_jax(trio, aligned, tmp_path, case):
    """run_longread with an assembler's multi-line FASTA (the port's
    contigs, 60 bases a line, `>NODE len= reads=` headers) on the paired
    workdir, and with none on the single-end one (the filtered BAM reads
    are the contigs); each starts without the annotated contigs, so the
    long-read assembly writes them."""
    d, data, bams = trio
    se = case == "bam_reads"
    base = aligned["single_end" if se else "paired"]
    contigs = None
    if not se:
        contigs = str(tmp_path / "asm.fasta")
        with open(contigs, "w") as f:
            with open(base / (NS + ".overlap.fastq")) as fq:
                recs = fq.read().splitlines()
            for i in range(0, len(recs), 4):
                seq = recs[i + 1]
                f.write(f">tig{i // 4} len={len(seq)} reads={i // 4 + 3}\n")
                f.writelines(seq[j:j + 60] + "\n"
                             for j in range(0, len(seq), 60))
    kw = _kwargs(d, data, bams, se, mosaic=True)
    ns = RufusConfig(**kw).name_stub
    got, port_wd = run_both(
        tmp_path, base,
        lambda wd: RufusPipeline(RufusConfig(workdir=wd, device="cpu",
                                             **kw)).run_longread(contigs),
        lambda wd: JaxPipeline(JaxConfig(workdir=wd, sharded="off",
                                         **kw)).run_longread(contigs),
        drop=[ns + ".overlap.hashcount.fastq"])
    assert got.endswith(ns + FINAL)
    assert _rows(str(port_wd / ns) + ".overlap.hashcount.fastq.bam.vcf")
    with open(port_wd / (ns + ".overlap.hashcount.fastq")) as f:
        names = f.read().split("\n")[::4]
    assert all(n.startswith("@tig") for n in names if n) != se


def test_regenotype_on_a_fresh_pipeline(trio, aligned, tmp_path):
    """regenotype with the parents' saved tables, on a fresh pipeline (as
    the CLI runs it: no table is resident on the device). The port also
    writes FINAL.vcf.gz and its .tbi, as run() does, where the JAX package
    leaves none (or run()'s stale ones): the JAX side is completed with
    its own bgzip_tabix_vcf, so those files are compared too, and the .gz
    must inflate to FINAL.vcf."""
    d, data, bams = trio
    kw = _kwargs(d, data, bams, mosaic=True)

    def port(wd):
        pipe = RufusPipeline(RufusConfig(workdir=wd, device="cpu", **kw))
        return pipe.regenotype(_parent_tables(pcount.KmerTable.load, wd,
                                              pipe.cfg))

    def jax(wd):
        pipe = JaxPipeline(JaxConfig(workdir=wd, sharded="off", **kw))
        final = pipe.regenotype(_parent_tables(jcount.KmerTable.load, wd,
                                               pipe.cfg))
        jbgzf.bgzip_tabix_vcf(final, keep_plain=True)
        return final

    got, port_wd = run_both(tmp_path, aligned["paired"], port, jax)
    final = port_wd / (NS + FINAL)
    assert got.endswith(NS + FINAL) and _rows(final)
    with gzip.open(str(final) + ".gz", "rb") as f:
        assert f.read() == final.read_bytes()
    _check_final(got, port_wd, want_rows=True)


def test_cli_mosaic_matches_jax(trio, aligned, tmp_path, monkeypatch, capsys):
    """python -m rufus_tpu_torch.pipeline ... --mosaic --device cpu (run
    in this process, so the pinned date holds) against the JAX run."""
    d, data, bams = trio
    c, m, f = data["child"], data["mother"], data["father"]

    def port(wd):
        monkeypatch.setattr(sys, "argv", [
            "rufus_tpu_torch", "-s", ",".join(c), "-c", ",".join(m),
            "-c", ",".join(f), "-q1", c[0], "-q2", c[1], "-k", str(K),
            "-m", "5", "--exome", "--mosaic", "-r", str(d / "ref.fa"),
            "--workdir", wd, "--device", "cpu"])
        capsys.readouterr()
        runpy.run_module("rufus_tpu_torch.pipeline", run_name="__main__")
        return capsys.readouterr().out.strip().splitlines()[-1]

    kw = _kwargs(d, data, bams, mosaic=True)
    got, port_wd = run_both(tmp_path, aligned["paired"], port, _jax_run(kw))
    _check_final(got, port_wd, want_rows=True)


def test_flat_tables_name_the_memory_model(trio, aligned, tmp_path,
                                           monkeypatch):
    """With the memory model ported: --regenotype takes .npz tables, as the
    JAX CLI does, and refuses a .table.flat with a ValueError that names
    the flat table; regenotype on a workdir whose subject table is a
    .table.flat opens it (_load_table), and a file there that is not a
    flat table raises ValueError (tests/test_torch_memory.py runs the
    regenotype on real flat tables)."""
    from rufus_tpu_torch.pipeline.__main__ import main

    d, data, bams = trio
    wd = tmp_path / "work"
    shutil.copytree(aligned["paired"], wd)
    flat = tmp_path / "mother.table.flat"
    flat.write_bytes(b"")
    c = data["child"]
    monkeypatch.setattr(sys, "argv", [
        "rufus_tpu_torch", "-s", ",".join(c), "-k", str(K),
        "-r", str(d / "ref.fa"), "--workdir", str(wd), "--device", "cpu",
        "--regenotype", str(flat)])
    with pytest.raises(ValueError, match="flat table"):
        main()
    cfg = RufusConfig(workdir=str(wd), device="cpu",
                      **_kwargs(d, data, bams))
    (wd / (cfg.subject_stub + ".table.flat")).write_bytes(b"")
    with pytest.raises(ValueError, match="not a flat k-mer table"):
        RufusPipeline(cfg).regenotype([])
