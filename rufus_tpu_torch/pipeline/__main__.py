"""CLI: python -m rufus_tpu_torch.pipeline -s child.bam -c mom.bam
-c dad.bam --stop-after filter

The JAX package's flag surface (runRufus.sh:74-131), plus --device. This
slice runs through --stop-after filter on BAM, CRAM or FASTQ input (FASTQ
pairs comma-separated, with -q1/-q2 for the filter). The flags that only
the stages after the filter read are accepted by the parser and refused
when set, since nothing here would honour them; -r is read only to decode
CRAM, and refused when no input is a CRAM.
"""

import argparse

from .config import RufusConfig
from .driver import RufusPipeline, _not_ported, input_kind

# flags read only by stages this slice does not run -> ROADMAP.md entry
# (-r is also read to decode CRAM inputs)
LATER_FLAGS = {
    "ref": "align, assemble, interpret, polish",
    "maxAllele": "align, assemble, interpret, polish",
    "mob": "align, assemble, interpret, polish",
    "refhash": "align, assemble, interpret, polish",
    "mosaic": "align, assemble, interpret, polish",
    "speed": "align, assemble, interpret, polish",
    "saliva": "align, assemble, interpret, polish",
    "clean": "align, assemble, interpret, polish",
    "flat_index": "align, assemble, interpret, polish",
    "pacbio": "align, assemble, interpret, polish",
    "regenotype": "align, assemble, interpret, polish",
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
                   help="BAM inflate threads")
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
                   choices=["", "jhash", "hashlist", "filter"])
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
    crams = any(input_kind(part) == "cram" for path in [a.subject] + a.controls
                for part in path.split(","))
    for dest, entry in LATER_FLAGS.items():
        if dest == "ref" and crams:
            continue
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
        exome=a.exome, single_end=a.single_end, stop_after=a.stop_after,
        haploid=a.haploid, sharded=a.sharded, device=a.device,
    )
    print(RufusPipeline(cfg).run())


if __name__ == "__main__":
    main()
