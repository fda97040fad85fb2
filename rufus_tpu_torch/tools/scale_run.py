"""The trio at scale, end to end, with a realistic call volume.

    python -m rufus_tpu_torch.tools.scale_run [tag] [--device cuda]
        [--out PATH]

The port of the JAX package's ``tools/scale_run.py``, which stays as the
reference; the same knobs and the same truth generator, so a seed gives
the JAX tool's genome, variants and reads byte for byte. By default a
500 Mbp genome and a 30x trio of 150 bp pairs (insert 400, 0.1%
substitutions), with about 600 spiked variants: SNVs (de novo at VAF 0.5,
mosaic at VAF 0.25), 1-10 bp indels and SVs (50-300 bp DEL, 50-150 bp INS,
tandem DUP, INV) on a 2.5 kb grid, drawn from alternate haplotypes (the
child's reads come from the reference, the de novo and the de novo +
mosaic haplotype at 50/25/25%, so every read is consistent with one).

The run: ``RufusPipeline.run`` from the gzipped FASTQ files to FINAL.vcf
with mosaic rows kept, a memmapped flat seed index for the aligners,
count tables spilled to host ``.table.flat`` memmaps
(``spill_tables="on"``) and SCALE_PASSES count passes, on --device (the
card unless ``--device cpu``). A ``MemSampler`` records memory every 10 s
tagged with the live stage: RSS and its heap owners and the card's
allocated and reserved MB. Then each spiked variant is matched to the
FINAL.vcf rows (recall by kind), and for each mosaic site the tool lists
its alt k-mers' depths in the run's own subject table beside the run's
own ModelDist cutoff: the arithmetic of whether the site could be pulled.

Env knobs (the JAX tool's): SCALE_GENOME (bp), SCALE_COV (x), SCALE_WORK
(the working directory, by default ``build/scale_run`` beside the
package), SCALE_NVAR, SCALE_PASSES (2 above 150 Mbp, else 1),
SCALE_MIN_COV, SCALE_GEN_ONLY (write the data and stop). The JAX tool's
SCALE_TABLE_CAP0 has no counterpart: the port's tables are sized exactly.
The samples and the genome are reused from SCALE_WORK when there.

It writes the whole result (per-stage trace, memory peaks, each variant's
recovery, the mosaic evidence) to --out (by default
``SCALE_WORK/SCALE_<tag>.json``) and prints a summary as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
import zlib

import numpy as np

from ..ops import _build

GENOME = int(os.environ.get("SCALE_GENOME", 500_000_000))
COV = float(os.environ.get("SCALE_COV", 30))
L = 150
INSERT = 400
ERR = 0.001
NVAR = int(os.environ.get("SCALE_NVAR", 600))
SEED = 4242
PASSES = int(os.environ.get("SCALE_PASSES", 2 if GENOME > 150_000_000 else 1))
PAIRS = int(GENOME * COV / (2 * L))
WORK = os.environ.get("SCALE_WORK", os.path.join(
    os.path.dirname(_build.BUILD_ROOT), "scale_run"))

_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b
BASES = np.frombuffer(b"ACGT", np.uint8)


# ---------------------------------------------------------------------------
# variant set + haplotypes
# ---------------------------------------------------------------------------


def build_variants(genome, rng):
    """~NVAR variants, >=2 kb apart: SNV denovo/mosaic, small indels,
    SVs. Returns (truth list, edits)."""
    n_snv = int(NVAR * 0.80)
    n_mosaic = max(4, int(NVAR * 0.033))
    n_ins = n_del = int(NVAR * 0.05)
    n_svdel = n_svins = max(4, int(NVAR * 0.025))
    n_dup = n_inv = max(2, int(NVAR * 0.008))
    total = n_snv + n_mosaic + n_ins + n_del + n_svdel + n_svins + n_dup + n_inv
    # positions on a 2.5 kb grid => no overlap, no interference
    grid = np.arange(2000, GENOME - 3000, 2500, dtype=np.int64)
    pos = np.sort(rng.choice(grid, size=total, replace=False))
    rng.shuffle(pos)
    truth, edits = [], []
    cursor = 0

    def take(n):
        nonlocal cursor
        p = pos[cursor:cursor + n]
        cursor += n
        return p

    def snv_at(p):
        ref_b = genome[p]
        alt = BASES[(int(np.nonzero(BASES == ref_b)[0][0]) + 1) % 4]
        return bytes([alt])

    for p in take(n_snv):
        a = snv_at(p)
        truth.append({"pos": int(p), "kind": "snv", "alt": a.decode(),
                      "vaf": 0.5})
        edits.append((int(p), 1, a, "denovo"))
    for p in take(n_mosaic):
        a = snv_at(p)
        truth.append({"pos": int(p), "kind": "mosaic", "alt": a.decode(),
                      "vaf": 0.25})
        edits.append((int(p), 1, a, "mosaic"))
    for p in take(n_ins):
        ln = int(rng.integers(1, 11))
        a = rng.choice(BASES, size=ln).tobytes()
        truth.append({"pos": int(p), "kind": "ins", "len": ln, "vaf": 0.5})
        edits.append((int(p), 0, a, "denovo"))
    for p in take(n_del):
        ln = int(rng.integers(1, 11))
        truth.append({"pos": int(p), "kind": "del", "len": ln, "vaf": 0.5})
        edits.append((int(p), ln, b"", "denovo"))
    for p in take(n_svdel):
        ln = int(rng.integers(50, 301))
        truth.append({"pos": int(p), "kind": "sv_del", "len": ln,
                      "vaf": 0.5})
        edits.append((int(p), ln, b"", "denovo"))
    for p in take(n_svins):
        ln = int(rng.integers(50, 151))
        a = rng.choice(BASES, size=ln).tobytes()
        truth.append({"pos": int(p), "kind": "sv_ins", "len": ln,
                      "vaf": 0.5})
        edits.append((int(p), 0, a, "denovo"))
    for p in take(n_dup):
        ln = int(rng.integers(60, 201))
        seg = genome[p:p + ln].tobytes()
        truth.append({"pos": int(p), "kind": "dup", "len": ln, "vaf": 0.5})
        edits.append((int(p + ln), 0, seg, "denovo"))  # tandem copy
    for p in take(n_inv):
        ln = int(rng.integers(100, 301))
        seg = _COMP[genome[p:p + ln]][::-1].tobytes()
        truth.append({"pos": int(p), "kind": "inv", "len": ln, "vaf": 0.5})
        edits.append((int(p), ln, seg, "denovo"))
    return truth, edits


def apply_edits(genome, edits):
    """Splice (pos, ref_len, alt_bytes) edits (non-overlapping) into a
    new haplotype array."""
    parts = []
    prev = 0
    for p, rl, alt, _tag in sorted(edits, key=lambda e: e[0]):
        parts.append(genome[prev:p])
        if alt:
            parts.append(np.frombuffer(alt, np.uint8))
        prev = p + rl
    parts.append(genome[prev:])
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# vectorized paired-fastq generation (gzip level 1)
# ---------------------------------------------------------------------------

REC = 2 + 9 + 1 + L + 3 + L + 1  # @pNNNNNNNNN\n seq \n+\n qual \n


def _records_block(names9, seqs, quals):
    """(m,) int names + (m, L) seq/qual u8 -> contiguous fastq bytes."""
    m = len(names9)
    out = np.empty((m, REC), np.uint8)
    out[:, 0] = ord("@")
    out[:, 1] = ord("p")
    digits = names9[:, None] // (10 ** np.arange(8, -1, -1))[None, :] % 10
    out[:, 2:11] = digits + ord("0")
    out[:, 11] = 10
    out[:, 12:12 + L] = seqs
    out[:, 12 + L] = 10
    out[:, 13 + L] = ord("+")
    out[:, 14 + L] = 10
    out[:, 15 + L:15 + 2 * L] = quals
    out[:, 15 + 2 * L] = 10
    return out.reshape(-1).tobytes()


class GzWriter:
    def __init__(self, path, level=1):
        self.f = open(path, "wb")
        self.c = zlib.compressobj(level, zlib.DEFLATED, 31)

    def write(self, data: bytes):
        self.f.write(self.c.compress(data))

    def close(self):
        self.f.write(self.c.flush())
        self.f.close()


def gen_sample(sample, haps, hap_p, rng):
    """Write {sample}.R1/.R2.fastq.gz: PAIRS coverage pairs drawn from
    `haps` (list of haplotype arrays) with probabilities `hap_p`."""
    r1p = os.path.join(WORK, f"{sample}.R1.fastq.gz")
    r2p = os.path.join(WORK, f"{sample}.R2.fastq.gz")
    if os.path.exists(r2p):
        return r1p, r2p
    t0 = time.time()
    qual = np.full(L, ord("I"), np.uint8)
    w1, w2 = GzWriter(r1p + ".tmp"), GzWriter(r2p + ".tmp")
    chunk = 1 << 19
    done = 0
    while done < PAIRS:
        m = min(chunk, PAIRS - done)
        hsel = rng.choice(len(haps), size=m, p=hap_p)
        a1 = np.empty((m, L), np.uint8)
        a2 = np.empty((m, L), np.uint8)
        for hi, hap in enumerate(haps):
            rows = np.nonzero(hsel == hi)[0]
            if not len(rows):
                continue
            starts = rng.integers(0, len(hap) - INSERT, size=len(rows))
            a1[rows] = hap[starts[:, None] + np.arange(L)[None, :]]
            a2[rows] = hap[(starts + INSERT - L)[:, None]
                           + np.arange(L)[None, :]]
        for a in (a1, a2):
            em = rng.random(a.shape) < ERR
            a[em] = BASES[rng.integers(0, 4, size=int(em.sum()))]
        a2 = _COMP[a2][:, ::-1]
        names = np.arange(done, done + m, dtype=np.int64)
        q = np.broadcast_to(qual, (m, L))
        w1.write(_records_block(names, a1, q))
        w2.write(_records_block(names, a2, q))
        done += m
    w1.close()
    w2.close()
    os.rename(r1p + ".tmp", r1p)
    os.rename(r2p + ".tmp", r2p)
    print(f"  {sample}: {PAIRS} pairs in {time.time()-t0:.0f}s", flush=True)
    return r1p, r2p


# ---------------------------------------------------------------------------
# recovery + mosaic arithmetic
# ---------------------------------------------------------------------------


def match_truth(truth, rows):
    called = []
    for l in rows:  # noqa: E741
        f = l.split("\t")
        called.append((int(f[1]), f[3], f[4]))
    out = []
    for t in truth:
        p0 = t["pos"] + 1  # VCF 1-based
        if t["kind"] in ("snv", "mosaic"):
            hit = any(abs(p - p0) <= 2 and t["alt"] in a
                      for p, r, a in called)
        elif t["kind"] in ("ins", "del"):
            hit = any(abs(p - p0) <= 15 and len(r) != len(a)
                      for p, r, a in called)
        else:
            ln = t.get("len", 0)
            hit = any(abs(p - p0) <= 150 or abs(p - (p0 + ln)) <= 150
                      for p, r, a in called)
        out.append({**t, "recovered": bool(hit)})
    return out


def mosaic_arithmetic(truth, genome_path, workdir, k, subject_stub):
    """For each mosaic site: its alt k-mers' depths in the run's own
    subject table against the run's own model cutoff (the derivation of
    runRufus.sh:862-868)."""
    from ..ops import codec, count

    model_path = os.path.join(
        workdir, subject_stub + ".Jhash.histo.7.7.model")
    with open(model_path) as f:
        cutoff = int(f.read().split("\n")[1])
    flat = os.path.join(workdir, subject_stub + ".table.flat")
    npz = os.path.join(workdir, subject_stub + ".table.npz")
    table = (count.KmerTable.load_flat(flat) if os.path.exists(flat)
             else count.KmerTable.load(npz))
    genome = np.load(genome_path, mmap_mode="r")
    out = []
    for t in truth:
        if t["kind"] != "mosaic":
            continue
        p = t["pos"]
        win = genome[p - k + 1: p + k].tobytes().decode()
        alt_win = win[:k - 1] + t["alt"] + win[k:]
        kmers = [codec.str_to_kmer(codec.canonical_str(alt_win[i:i + k]))
                 for i in range(k)]
        depths = table.query(np.array(kmers, np.uint64)).tolist()
        out.append({
            "pos": p, "alt": t["alt"], "recovered": t.get("recovered"),
            "model_cutoff": cutoff,
            "alt_kmer_depths": depths,
            "depths_below_cutoff": int(sum(d < cutoff for d in depths)),
            "note": "a site is only pullable when its alt k-mers clear "
                    "the subject count cutoff (merge >=5 fused with the "
                    "model cutoff, merge_files.cc:147-153 + "
                    "runRufus.sh:862-868)",
        })
    return out


# ---------------------------------------------------------------------------


def make_data(tag: str):
    """The genome, its FASTA, the truth and the three samples' FASTQ under
    WORK (each reused when there); returns (truth, paths)."""
    os.makedirs(WORK, exist_ok=True)
    rng = np.random.default_rng(SEED)
    ref_fa = os.path.join(WORK, "ref.fa")
    gpath = os.path.join(WORK, "genome.npy")
    if not os.path.exists(gpath):
        print("generating genome...", flush=True)
        genome = rng.choice(BASES, size=GENOME)
        np.save(gpath, genome)
        with open(ref_fa, "w") as f:
            f.write(">21\n")
            g = genome.tobytes().decode()
            for i in range(0, len(g), 10000):
                f.write(g[i:i + 10000] + "\n")
    else:
        genome = np.load(gpath)

    truth_path = os.path.join(WORK, "truth.json")
    if os.path.exists(truth_path):
        with open(truth_path) as f:
            truth = json.load(f)
    else:
        truth, edits = build_variants(genome, np.random.default_rng(SEED + 1))
        with open(truth_path, "w") as f:
            json.dump(truth, f, indent=1)
        np.save(os.path.join(WORK, "edits.npy"),
                np.array([(p, rl, a.decode(), tag_) for p, rl, a, tag_
                          in edits], dtype=object), allow_pickle=True)
    edits_raw = np.load(os.path.join(WORK, "edits.npy"), allow_pickle=True)
    edits = [(int(p), int(rl), a.encode(), tg) for p, rl, a, tg in edits_raw]

    print("building haplotypes...", flush=True)
    hap_dn = apply_edits(genome, [e for e in edits if e[3] == "denovo"])
    hap_all = apply_edits(genome, edits)

    print(f"generating samples ({PAIRS} pairs x3, {COV}x)...", flush=True)
    paths = {
        "child": gen_sample("child", [genome, hap_dn, hap_all],
                            [0.5, 0.25, 0.25],
                            np.random.default_rng(SEED + 11)),
        "mother": gen_sample("mother", [genome], [1.0],
                             np.random.default_rng(SEED + 12)),
        "father": gen_sample("father", [genome], [1.0],
                             np.random.default_rng(SEED + 13)),
        "ref": ref_fa, "genome": gpath}
    return truth, paths


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tag", nargs="?", default="r05")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from ..pipeline import RufusConfig, RufusPipeline
    from ..pipeline.driver import resolve_device
    from ..utils.trace import MemSampler
    from .radixbench import card_name_and_power_limit

    dev = resolve_device(args.device)
    t_all = time.time()
    truth, paths = make_data(args.tag)
    if os.environ.get("SCALE_GEN_ONLY"):
        print("generation done (SCALE_GEN_ONLY)", flush=True)
        return None

    (c1, c2), (m1, m2), (f1, f2) = (paths[s] for s in
                                    ("child", "mother", "father"))
    workdir = os.path.join(WORK, "run")
    cfg = RufusConfig(
        subject=f"{c1},{c2}", fastq_a=c1, fastq_b=c2,
        controls=[f"{m1},{m2}", f"{f1},{f2}"],
        ref=paths["ref"], k=25, workdir=workdir,
        flat_index=os.path.join(WORK, "ref.flat"),
        batch_size=65536, mosaic=True, count_passes=PASSES,
        spill_tables="on",
        min_cov=int(os.environ.get("SCALE_MIN_COV", "0")) or None,
        device=str(dev))
    t0 = time.time()
    pipe = RufusPipeline(cfg)
    sampler = MemSampler(pipe.trace,
                         path=os.path.join(WORK, "mem_samples.jsonl"),
                         interval=10.0).start()
    try:
        final = pipe.run()
    finally:
        sampler.stop()
    wall = time.time() - t0
    peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024

    with open(final) as f:
        rows = [line for line in f if not line.startswith("#")]
    recovered = match_truth(truth, rows)
    mosaic_ev = mosaic_arithmetic(recovered, paths["genome"], workdir, cfg.k,
                                  cfg.subject_stub)

    stages = pipe.trace.stages
    by_kind: dict = {}
    for r in recovered:
        d = by_kind.setdefault(r["kind"], [0, 0])
        d[1] += 1
        d[0] += int(r["recovered"])
    interp = next((s for s in stages if s["stage"] == "interpret"), {})
    cuda = dev.type == "cuda"
    out = {
        "genome_bp": GENOME,
        "pairs_per_sample": PAIRS,
        "samples": 3,
        "coverage_x": 2 * PAIRS * L / GENOME,
        "spiked_total": len(truth),
        "recovered_by_kind": {k: f"{a}/{b}" for k, (a, b)
                              in sorted(by_kind.items())},
        "recovered_total": sum(int(r["recovered"]) for r in recovered),
        "vcf_rows": len(rows),
        "interpret_wall_s": interp.get("wall_s"),
        "interpret_ms_per_vcf_row": (
            1e3 * interp["wall_s"] / max(1, len(rows)) if interp else None),
        "pipeline_wall_s": wall,
        "total_wall_s": time.time() - t_all,
        "peak_rss_mb": peak_rss_mb,
        "count_passes": PASSES,
        "stage_wall_s": {s["stage"]: s["wall_s"] for s in stages},
        "stage_device_peak_bytes": {s["stage"]: s.get("device_peak_bytes")
                                    for s in stages},
        "stages": stages,
        "mem_stage_peaks": sampler.per_stage_peaks(),
        "mosaic_evidence": mosaic_ev,
        "recovered": recovered,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "nvidia_smi": card_name_and_power_limit() if cuda else None,
    }
    out_path = args.out or os.path.join(WORK, f"SCALE_{args.tag}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("recovered", "stages", "mosaic_evidence",
                                   "mem_stage_peaks")}), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
