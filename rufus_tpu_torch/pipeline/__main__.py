"""CLI: python -m rufus_tpu_torch.pipeline -s child.bam -c mom.bam
-c dad.bam -r ref.fa --stop-after contig_align

The JAX package's flag surface (runRufus.sh:74-131), plus --device. This
slice runs through --stop-after contig_align on BAM, CRAM or FASTQ input
(FASTQ pairs comma-separated, with -q1/-q2 for the filter). The flags that
only interpret, polish and the CLI's other paths read are accepted by the
parser and refused when set, since nothing here would honour them.
"""

import argparse

from .config import RufusConfig
from .driver import STOP_STAGES, RufusPipeline, _not_ported

# flags read only by stages this slice does not run -> ROADMAP.md entry
LATER_FLAGS = {
    "maxAllele": "interpret, polish",
    "mosaic": "interpret, polish",
    "clean": "interpret, polish",
    "pacbio": "interpret, polish",
    "regenotype": "interpret, polish",
}


def main():
    p = argparse.ArgumentParser(
        prog="rufus_tpu_torch",
        description="reference-free variant caller on a CUDA device")
    p.add_argument("-s", "--subject", required=True,
                   help="subject BAM/CRAM/FASTQ(s), comma-separated")
    p.add_argument("-c", "--controls", action="append", default=[],
                   help="control BAM/CRAM/FASTQ(s) (repeatable)")
    p.add_argument("-r", "--ref", default="",
                   help="reference fasta (or BWA index prefix)")
    p.add_argument("-k", type=int, default=25, help="k-mer size (<=31)")
    p.add_argument("-t", "--threads", type=int, default=2,
                   help="BAM inflate threads; assembly buffers 100 per thread")
    p.add_argument("-m", "--min", type=int, default=None,
                   help="fixed MutantMinCov override")
    p.add_argument("-fq", "--filterMinQ", type=int, default=15)
    p.add_argument("-fK", "--filterK", type=int, default=1)
    p.add_argument("-L", "--maxAllele", type=int, default=1000)
    p.add_argument("-pl", "--parLowK", type=int, default=2)
    p.add_argument("-e", "--exclude", default="", help="exclude table (.npz)")
    p.add_argument("-q1", "--fastqA", default="")
    p.add_argument("-q2", "--fastqB", default="")
    p.add_argument("--mob", default="", help="mobile element fasta")
    p.add_argument("--refhash", default="", help="repeat reference table (.npz)")
    p.add_argument("--exome", action="store_true")
    p.add_argument("--mosaic", action="store_true")
    p.add_argument("--single-end", action="store_true", dest="single_end")
    p.add_argument("--tumor", action="store_true",
                   help="tumor-normal preset: fixed MutantMinCov=5 "
                        "(scripts/RunRUFUS.Tumor.sh)")
    p.add_argument("--speed", default="full", choices=["full", "veryfast"])
    p.add_argument("--workdir", default=".")
    p.add_argument("--stop-after", default="",
                   choices=["", *STOP_STAGES])
    p.add_argument("--haploid", action="store_true",
                   help="ModelDist.haploid depth-model fit")
    p.add_argument("--saliva", action="store_true",
                   help="aligned-only mutant reads (runRufus.sh:1062-1076)")
    p.add_argument("--clean", action="store_true",
                   help="-CLEAN: purge intermediates after the run")
    p.add_argument("--sharded", default="auto", choices=["auto", "on", "off"],
                   help="multi-device pipeline (not ported: one device)")
    p.add_argument("--flat-index", default="",
                   help="memmapped seed index for the aligner")
    p.add_argument("--pacbio", nargs="?", const="", default=None,
                   metavar="CONTIGS_FASTA", help="long-read path")
    p.add_argument("--regenotype", nargs="+", default=None,
                   metavar="CONTROL_TABLE",
                   help="re-genotype existing contigs against new tables")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain PyTorch versions)")
    a = p.parse_args()
    for dest, entry in LATER_FLAGS.items():
        if getattr(a, dest) != p.get_default(dest):
            _not_ported(f"--{dest}", entry)
    min_cov = a.min
    if a.tumor and min_cov is None:
        min_cov = 5  # RunRUFUS.Tumor.sh fixed cutoff
    cfg = RufusConfig(
        subject=a.subject, controls=a.controls, ref=a.ref, k=a.k,
        threads=a.threads, workdir=a.workdir,
        min_cov=min_cov, filter_min_q=a.filterMinQ,
        filter_k_threshold=a.filterK, par_low_k=a.parLowK,
        exclude_hash=a.exclude, fastq_a=a.fastqA, fastq_b=a.fastqB,
        mob_fasta=a.mob, ref_hash=a.refhash, exome=a.exome,
        single_end=a.single_end, assembly_speed=a.speed,
        stop_after=a.stop_after, haploid=a.haploid, saliva=a.saliva,
        sharded=a.sharded, flat_index=a.flat_index, device=a.device,
    )
    out = RufusPipeline(cfg).run()
    if isinstance(out, dict):  # contig_align: interpret's inputs
        out = {k: (len(v) if k == "stdin_lines" else v)
               for k, v in out.items()}
    print(out)


if __name__ == "__main__":
    main()
