"""Typed pipeline configuration (replaces runRufus.sh's argbash parser,
reference: runRufus.sh:135-366 with defaults at 27, 61-69, 424-435).

The fields are those of the JAX package that the pipeline reads, plus
`device`."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class RufusConfig:
    subject: str = ""  # subject BAM/CRAM/FASTQ(s), comma-separated
    controls: list = field(default_factory=list)
    ref: str = ""  # reference FASTA (or BWA index prefix): CRAM decoding,
    # read and contig alignment
    k: int = 25
    threads: int = 2  # native BAM inflate threads (the pair and single-end
    # streams use at least 2); assembly rounds buffer 100 * threads reads
    workdir: str = "."
    min_cov: int | None = None  # -m fixed MutantMinCov override
    filter_min_q: int = 15  # -fq
    filter_k_threshold: int = 1  # -fK
    max_allele_size: int = 1000  # -L: interpret's largest variant
    par_low_k: int = 2  # -pl parent jellyfish -L
    subject_low_k: int = 2
    max_hash_depth_seed: int = 1200  # runRufus.sh:27
    exome: bool = False
    mosaic: bool = False  # keep the Mosaic rows in FINAL.vcf
    single_end: bool = False  # filter single reads of a BAM/CRAM subject
    fastq_a: str = ""
    fastq_b: str = ""
    exclude_hash: str = ""  # -e exclude Jhash table
    ref_hash: str = ""  # repeat reference hash (.npz) for -e RepRefHash
    mob_fasta: str = ""  # mobile-element fasta (MOB pass)
    batch_size: int = 2048
    read_pad: int = 160
    merge_min: int = 5  # modified-merge count floor (merge_files.cc:149)
    genotype_max_cov: int = 100000  # Overlap.shorter.sh:20
    assembly_speed: str = "full"  # or "veryfast"
    stop_after: str = ""  # "jhash" | "hashlist" | "filter" (StJ/StH/StF)
    # | "contig_align" (interpret's inputs) | "" (the full run, to FINAL.vcf)
    sharded: str = "auto"  # "auto" or "on": the count, subtract, filter
    # and pulls on a mesh of every visible card (device "cuda"; one shard
    # on "cuda:i" or "cpu"); "off": one shard. RufusPipeline(cfg, mesh)
    # takes any other mesh, such as several shards on one card.
    clean: bool = False  # -CLEAN: remove intermediates after the run
    # (runRufus.sh:351-356)
    flat_index: str = ""  # path to a build_flat_index seed index: built
    # on first use and memmapped thereafter (align/aligner.py)
    saliva: bool = False  # aligned-only mutant reads for saliva samples
    # (runRufus.sh:1062-1076)
    haploid: bool = False  # ModelDist.haploid fit (ModelDist.haploid.cpp:29)
    count_passes: int = 1  # > 1: multipass counting, pass p folding only
    # the keys of the p-th of count_passes ascending key ranges (bounds
    # from the first batch) and spilling a flat run; the table is their
    # concatenation (driver.py:480-551 of the JAX package). A pass holds
    # about 1/count_passes of the table, and its pending buffer is cut to
    # 1/count_passes of the keys; no budget guards it.
    spill_tables: str = "auto"  # "auto" | "on" | "off". "on": each
    # finished table goes to a host flat memmap (.table.flat) and leaves
    # the device, and the count's LSM guard spills sorted runs before a
    # fold passes hbm_budget_gb (jellyfish --disk, count_main.cc:245-246).
    # "auto": the guard on cuda, and flat tables there once the first
    # table x the number of samples passes the budget; never on the CPU.
    # "off": neither.
    hbm_budget_gb: float = 64.0  # device memory (GiB) the count stage's
    # tables and folds may take. The JAX package's 12 was for a 16 GB TPU;
    # 64 leaves 16 of an H100's 80 GB for the CUDA context, the caching
    # allocator's free blocks and the filter's and aligners' buffers.
    device: str = "cuda"  # torch device of every stage; "cpu" runs the
    # kernels' plain PyTorch versions (tests)

    @property
    def subject_stub(self) -> str:
        # comma-separated multi-file inputs stub from the first file
        return os.path.basename(self.subject.split(",")[0]) + ".generator"

    @property
    def name_stub(self) -> str:
        return self.subject_stub + ".V2"

    def control_stub(self, path: str) -> str:
        return os.path.basename(path.split(",")[0]) + ".generator"

    def wpath(self, *parts) -> str:
        return os.path.join(self.workdir, *parts)
