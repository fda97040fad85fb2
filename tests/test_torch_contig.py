"""The slice through contig alignment: the port's read alignment, assembly
and contig alignment against the JAX package's stages 5-7
(stage_align_reads, stage_assemble, stage_contig_align) run on the same
workdir inputs, on the 20 kbp synthetic trio. Tolerance: none; every file
the stages write is compared byte for byte (the trace aside), and the
returned SAM lines and paths of interpret's inputs must be equal.

The port runs on the CPU (the plain PyTorch versions of its kernels), the
JAX package with sharded="off" and exome=True, -m 5 on both, as in
tests/test_torch_pipeline.py. Each case but the first starts from a copy
of one port run through the filter, so both packages read the same kept
reads and tables and only stages 5-7 run; the first runs the port from
the FASTQ files.
"""

import os
import shutil

import numpy as np
import pytest

from rufus_tpu.ops import count as jcount
from rufus_tpu.pipeline import RufusConfig as JaxConfig
from rufus_tpu.pipeline import RufusPipeline as JaxPipeline
from rufus_tpu_torch import synthetic
from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline

K = 25


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """The trio's FASTQ and BAM files, its reference FASTA, a MOB FASTA
    holding a piece of the genome around the first spiked site (so contigs
    there align to it) and a random one, and a repeat hash (.npz) of the
    canonical k-mers around the second site. data["clean"] is the same
    trio without low-quality bases, which veryfast assembly needs."""
    d = tmp_path_factory.mktemp("contigtrio")
    data = synthetic.write_trio(str(d / "fastq"), genome_bp=20_000,
                                coverage=30, n_denovo=4, seed=3)
    data["clean"] = synthetic.write_trio(str(d / "clean"), genome_bp=20_000,
                                         coverage=30, n_denovo=4, seed=3,
                                         lowq_rate=0.0)
    bams = synthetic.write_trio_bams(data, str(d / "bam"), seed=3)
    genome = data["genome"].tobytes().decode()
    ref = d / "ref.fa"
    ref.write_text(f">{synthetic.REF_NAME}\n{genome}\n")
    s0, s1 = (int(x) for x in data["sites"][:2])
    rng = np.random.default_rng(3)
    junk = rng.choice(list("ACGT"), 400).tolist()
    (d / "mob.fa").write_text(f">ME1\n{genome[s0 - 250:s0 + 250]}\n"
                              f">ME2\n{''.join(junk)}\n")
    rep = jcount.KmerTable.from_strings(K, [genome[s1 - 150:s1 + 150]])
    rep.save(str(d / "rephash.npz"))
    return d, data, bams


def _kwargs(d, data, bams, single_end=False, clean=False, **over):
    if clean:
        data = data["clean"]
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
def filtered(trio):
    """The port's run through the filter, paired and single-end: the
    workdirs every resumed case copies."""
    d, data, bams = trio
    out = {}
    for key, se, clean in (("paired", False, False), ("single_end", True,
                                                      False),
                           ("clean", False, True)):
        wd = d / f"filtered_{key}"
        RufusPipeline(RufusConfig(**_kwargs(d, data, bams, se, clean,
                                            workdir=str(wd), device="cpu",
                                            stop_after="filter"))).run()
        out[key] = wd
    return out


def _files(wd):
    """Every file under a workdir, by relative path, the trace aside."""
    out = []
    for root, _, names in os.walk(wd):
        for n in names:
            rel = os.path.relpath(os.path.join(root, n), wd)
            if rel != os.path.join("Intermediates", "trace.jsonl"):
                out.append(rel)
    return sorted(out)


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


def jax_stages(wd, **kw):
    """The JAX package's stages 5-7 on a workdir that holds the filter's
    outputs and the count tables; returns stage_contig_align's dict."""
    kw = {k: v for k, v in kw.items() if k not in ("device", "workdir")}
    pipe = JaxPipeline(JaxConfig(workdir=str(wd), sharded="off", **kw))
    cfg = pipe.cfg
    stub = cfg.subject_stub
    if cfg.single_end:
        m1, m2 = cfg.wpath(stub + ".Mutations.fastq"), None
    else:
        m1 = cfg.wpath(stub + ".Mutations.Mate1.fastq")
        m2 = cfg.wpath(stub + ".Mutations.Mate2.fastq")
    sam = pipe.stage_align_reads(m1, m2)
    hl = [n for n in os.listdir(wd) if n.endswith(".HashList")]
    contigs = pipe.stage_assemble(sam, cfg.wpath(hl[0]))
    load = lambda s: jcount.KmerTable.load(cfg.wpath(s + ".table.npz"))  # noqa
    tables = {"subject": load(stub),
              "controls": [load(cfg.control_stub(c)) for c in cfg.controls]}
    return pipe.stage_contig_align(contigs, tables)


def run_both(tmp_path, base, **kw):
    """The port through contig_align and the JAX stages 5-7, each in a copy
    of the workdir `base`; asserts equal files and results and returns the
    port's result."""
    port_wd, jax_wd = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(base, jax_wd)
    shutil.copytree(base, port_wd)
    kw = dict(kw, workdir=str(port_wd))
    got = RufusPipeline(RufusConfig(device="cpu", stop_after="contig_align",
                                    **kw)).run()
    kw["workdir"] = str(jax_wd)
    if kw.get("flat_index"):
        kw["flat_index"] = str(jax_wd / "ref.flatidx")
    want = jax_stages(jax_wd, **kw)
    assert got["stdin_lines"] == want["stdin_lines"]
    rel = lambda p: os.path.relpath(p, kw["workdir"])  # noqa: E731
    for key in want:
        if key == "stdin_lines":
            continue
        g, w = got[key], want[key]
        if isinstance(w, list):
            assert [os.path.relpath(p, port_wd) for p in g] == \
                [rel(p) for p in w], key
        else:
            assert os.path.relpath(g, port_wd) == rel(w), key
    _assert_same_files(str(port_wd), str(jax_wd))
    return got


def test_paired_from_fastq_matches_jax_stages(trio, filtered, tmp_path):
    """The whole slice from FASTQ on the port; the JAX stages on the
    port's filter outputs (which tests/test_torch_pipeline.py holds to the
    JAX filter)."""
    d, data, bams = trio
    port_wd, jax_wd = tmp_path / "port", tmp_path / "jax"
    got = RufusPipeline(RufusConfig(**_kwargs(
        d, data, bams, workdir=str(port_wd), device="cpu",
        stop_after="contig_align"))).run()
    shutil.copytree(filtered["paired"], jax_wd)
    want = jax_stages(jax_wd, **_kwargs(d, data, bams))
    assert got["stdin_lines"] == want["stdin_lines"]
    assert len(got["stdin_lines"]) > 0
    _assert_same_files(str(port_wd), str(jax_wd))
    # behaviour, not only parity: reads mapped, contigs aligned and pulled
    ns = "child.R1.fastq.generator.V2"
    sam = (port_wd / "child.R1.fastq.generator.Mutations.fastq.sam")
    recs = [l.split("\t") for l in sam.read_text().splitlines()
            if not l.startswith("@")]
    assert recs and all(int(r[1]) & 0x4 == 0 for r in recs)
    assert (port_wd / (ns + ".overlap.hashcount.fastq.bam.bai")).exists()
    pulled = (port_wd / "Intermediates" /
              (ns + ".overlap.asembly.hash.fastq.sample")).read_text()
    assert pulled.strip()


@pytest.mark.parametrize("case", ["single_end", "saliva", "veryfast",
                                  "veryfast_single_end", "veryfast_lowq",
                                  "flat_index", "mob", "refhash", "threads"])
def test_options_match_jax_stages(trio, filtered, tmp_path, case):
    """Stages 5-7 resumed from the filter's outputs, one option a case:
    single-end reads from the child BAM, --saliva, --speed veryfast (on the
    trio without low-quality bases, on single-end reads, and on the trio
    with them, where no contig passes), --flat-index (built in the
    workdir, so its bytes are compared too), --mob, --refhash, and
    threads 3 (assembly's buffer)."""
    d, data, bams = trio
    se = case.endswith("single_end")
    clean = case == "veryfast"
    over = {"saliva": dict(saliva=True),
            "veryfast": dict(assembly_speed="veryfast"),
            "veryfast_single_end": dict(assembly_speed="veryfast"),
            "veryfast_lowq": dict(assembly_speed="veryfast"),
            "flat_index": dict(flat_index=str(tmp_path / "port" /
                                              "ref.flatidx")),
            "mob": dict(mob_fasta=str(d / "mob.fa")),
            "refhash": dict(ref_hash=str(d / "rephash.npz")),
            "threads": dict(threads=3)}.get(case, {})
    kw = _kwargs(d, data, bams, se, clean, **over)
    base = filtered["clean" if clean else "single_end" if se else "paired"]
    if case == "veryfast_lowq":
        # at 0.99 identity and depth 5 the paired trio assembles no contig
        # (2% of its bases are low quality, so masked): both packages stop
        # there alike; tests/test_torch_assembly.py holds veryfast to the
        # reference tools' contigs
        for wd, run in ((tmp_path / "port", lambda w: RufusPipeline(
                RufusConfig(device="cpu", stop_after="contig_align",
                            workdir=str(w), **kw)).run()),
                        (tmp_path / "jax", lambda w: jax_stages(w, **kw))):
            shutil.copytree(base, wd)
            with pytest.raises(RuntimeError, match="no contigs"):
                run(wd)
        _assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
        return
    got = run_both(tmp_path, base, **kw)
    assert got["stdin_lines"]
    inter = tmp_path / "port" / "Intermediates"
    ns = os.path.basename(got["subj_alt"]).split(".overlap")[0]
    if case == "saliva":
        assert (tmp_path / "port" / (
            ns[:-3] + ".Mutations.fastq.FULL.sam")).exists()
    if case == "mob":
        mob = (inter / (ns + ".overlap.hashcount.fastq.MOB.sam")).read_text()
        assert "@SQ\tSN:ME1" in mob and any(
            l.split("\t")[2] == "ME1" for l in mob.splitlines()
            if not l.startswith("@"))
    if case == "refhash":
        assert (inter / (ns + ".ref.RepRefHash")).read_text().strip()
