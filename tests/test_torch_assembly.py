"""Assembly: the port's OverlapSam -> Overlap x3 -> OverlapRegion ->
ReplaceQwithD -> ConvertFASTqD -> AnnotateOverlap chain against the
compiled reference tools' outputs in tests/golden/assembly/ (the fixtures
tests/test_assembly_differential.py holds the JAX package to), round by
round and for veryfast; the pipeline's stage_assemble against the JAX
package's on the same SAM and HashList; the FASTQD helpers and
KmerTable.from_strings against the JAX package's. Tolerance: none (byte
for byte).
"""

import os

import pytest

from rufus_tpu.io import fastq as jfq
from rufus_tpu.ops import count as jcount
from rufus_tpu.pipeline import RufusConfig as JaxConfig
from rufus_tpu.pipeline import RufusPipeline as JaxPipeline
from rufus_tpu_torch.assembly import annotate
from rufus_tpu_torch.assembly.overlap_rounds import (overlap_region,
                                                     overlap_round)
from rufus_tpu_torch.assembly.overlap_sam import overlap_sam
from rufus_tpu_torch.io import fastq as pfq
from rufus_tpu_torch.io import hashlist as hio
from rufus_tpu_torch.ops import count as pcount
from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline
from rufus_tpu_torch.pipeline.driver import SamLikeRec

GOLD = os.path.join(os.path.dirname(__file__), "golden", "assembly")
NS = "Child.bam.generator.V2"
HASHLIST = os.path.join(GOLD, "Child.bam.generator.k25_c4.HashList")


def _read(path):
    with open(path) as f:
        return f.read()


def _fastqd_text(records):
    return "".join(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n{r.strands}\n"
                   + " ".join(str(d) for d in r.depths) + "\n"
                   for r in records)


def _fastq_text(records):
    return "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in records)


def _records(min_tlen=None):
    out = []
    for line in open(os.path.join(GOLD, "input.sam")):
        f = line.rstrip("\n").split("\t")
        if min_tlen is None or abs(int(f[8])) > min_tlen:
            out.append(SamLikeRec(int(f[1]), f[9], f[10], int(f[8])))
    return out


@pytest.fixture(scope="module")
def chain():
    strs, cnts = hio.read_hashlist(HASHLIST)
    out = {}
    r0, _ = overlap_sam(_records(), strs, NS, 0.95, 20, 1, 25)
    out["sam"] = r0
    out["1"], _ = overlap_round(r0, "20", 0.98, 100, 1, 20, 1, 0,
                                buffer_size=200)
    out["2"], _ = overlap_round(out["1"], "20", 0.98, 75, 2, 20, 1, 1,
                                buffer_size=200)
    out["3"], _ = overlap_round(out["2"], "20", 0.98, 50, 2, 20, 1, 1,
                                buffer_size=200)
    out["4"], _ = overlap_region(out["3"], NS, 0.98, 50, 5, 1)
    rq = annotate.replace_qual_with_depth(out["4"])
    out["overlap.fastqd"] = rq
    out["overlap.fastq"] = annotate.fastqd_to_fastq(rq)
    out["ann"], out["side"] = annotate.annotate_overlap(
        list(zip(strs, cnts)), out["overlap.fastq"], 25)
    return out


@pytest.mark.parametrize("stage", ["sam", "1", "2", "3", "4",
                                   "overlap"])
def test_round_matches_reference_tools(chain, stage):
    got = _fastqd_text(chain["overlap.fastqd" if stage == "overlap"
                             else stage])
    name = f"{NS}.overlap.fastqd" if stage == "overlap" \
        else f"{NS}.{stage}.fastqd"
    assert got == _read(os.path.join(GOLD, name))


def test_annotations_match_reference_tools(chain):
    assert _fastq_text(chain["overlap.fastq"]) == \
        _read(os.path.join(GOLD, f"{NS}.overlap.fastq"))
    assert _fastq_text(chain["ann"]) == \
        _read(os.path.join(GOLD, f"{NS}.overlap.hashcount.fastq"))
    assert "".join(l + "\n" for l in chain["side"]) == \
        _read(os.path.join(GOLD, f"{NS}.overlap.asembly.hash.fastq"))


def test_veryfast_matches_reference_tools():
    strs, cnts = hio.read_hashlist(HASHLIST)
    r0, _ = overlap_sam(_records(150), strs, NS, 0.99, 25, 3, 25)
    assert _fastqd_text(r0) == _read(os.path.join(GOLD,
                                                  f"vf.{NS}.sam.fastqd"))
    rf, _ = overlap_round(r0, NS, 0.99, 75, 5, 15, 1, 1, buffer_size=200)
    assert _fastqd_text(rf) == _read(os.path.join(GOLD,
                                                  f"vf.{NS}.final.fastqd"))
    fq = annotate.fastqd_to_fastq(annotate.replace_qual_with_depth(rf))
    ann, _ = annotate.annotate_overlap(list(zip(strs, cnts)), fq, 25)
    assert _fastq_text(ann) == _read(
        os.path.join(GOLD, f"vf.{NS}.overlap.hashcount.fastq"))


@pytest.mark.parametrize("speed,threads", [("full", 2), ("veryfast", 2),
                                           ("full", 3), ("full", 1)])
def test_stage_assemble_matches_jax(tmp_path, speed, threads):
    """stage_assemble of both pipelines on the golden SAM and HashList:
    every file it writes, byte for byte; threads sets the rounds' buffer
    (100 * threads reads) and with it the contigs. The golden SAM's TLENs
    are all 0, so veryfast keeps no pair and both stop alike (the
    reference tools' veryfast fixtures are empty too)."""
    sam = tmp_path / "in.sam"
    sam.write_text("@HD\tVN:1.6\tSO:coordinate\n" +
                   _read(os.path.join(GOLD, "input.sam")))
    outs = {}
    for name, cfg_cls, pipe_cls, extra in (
            ("port", RufusConfig, RufusPipeline, {"device": "cpu"}),
            ("jax", JaxConfig, JaxPipeline, {"sharded": "off"})):
        wd = tmp_path / name
        cfg = cfg_cls(subject="Child.bam", k=25, workdir=str(wd),
                      assembly_speed=speed, threads=threads, **extra)
        outs[name] = wd
        if speed == "veryfast":
            with pytest.raises(RuntimeError, match="no contigs"):
                pipe_cls(cfg).stage_assemble(str(sam), HASHLIST)
            continue
        out = pipe_cls(cfg).stage_assemble(str(sam), HASHLIST)
        assert os.path.basename(out) == f"{NS}.overlap.hashcount.fastq"
    files = {}
    for name, wd in outs.items():
        files[name] = sorted(os.path.relpath(os.path.join(r, n), wd)
                             for r, _, ns in os.walk(wd) for n in ns
                             if n != "trace.jsonl")
    assert files["port"] == files["jax"]
    assert len(files["port"]) == (0 if speed == "veryfast" else 4)
    for rel in files["port"]:
        assert (outs["port"] / rel).read_bytes() == \
            (outs["jax"] / rel).read_bytes(), rel
    if (speed, threads) == ("full", 2):
        assert (outs["port"] / f"{NS}.overlap.fastqd").read_text() == \
            _read(os.path.join(GOLD, f"{NS}.overlap.fastqd"))


def test_fastqd_helpers_match_jax(tmp_path):
    recs = list(pfq.read_fastqd(os.path.join(GOLD, f"{NS}.1.fastqd")))
    want = list(jfq.read_fastqd(os.path.join(GOLD, f"{NS}.1.fastqd")))
    assert [vars(r) for r in recs] == [vars(r) for r in want]
    recs.append(pfq.FastqdRecord("empty", "ACGT", "IIII", "+", []))
    pfq.write_fastqd(str(tmp_path / "p.fastqd"), recs)
    jfq.write_fastqd(str(tmp_path / "j.fastqd"),
                     [jfq.FastqdRecord(**vars(r)) for r in recs])
    assert (tmp_path / "p.fastqd").read_bytes() == \
        (tmp_path / "j.fastqd").read_bytes()
    assert [vars(r) for r in pfq.read_fastqd(str(tmp_path / "p.fastqd"))] \
        == [vars(r) for r in recs]


@pytest.mark.parametrize("k", [25, 31])
def test_from_strings_matches_jax(k):
    """The non-canonical count of contig alignment's tabs."""
    seqs = [r[1] for r in pfq.read_fastq(
        os.path.join(GOLD, f"{NS}.overlap.fastq"))]
    seqs = seqs + [s[100:400] for s in seqs] + ["acgtNacgtacgtACGT" * 3]
    got = pcount.KmerTable.from_strings(k, seqs)
    want = jcount.KmerTable.from_strings(k, seqs, canonical=False)
    assert got.keys.dtype == want.keys.dtype
    assert got.keys.tolist() == want.keys.tolist()
    assert got.counts.tolist() == want.counts.tolist()
    assert len(got) > 0
