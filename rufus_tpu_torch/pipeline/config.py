"""Typed pipeline configuration (replaces runRufus.sh's argbash parser,
reference: runRufus.sh:135-366 with defaults at 27, 61-69, 424-435).

The fields are those of the JAX package that the stages through the filter
read, plus `device`. `count_passes`, `spill_tables`, `sharded` and
`single_end` stay so a JAX configuration's values can be passed on; the
driver refuses any value of theirs that it cannot honour."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class RufusConfig:
    subject: str = ""  # subject FASTQ(s), comma-separated
    controls: list = field(default_factory=list)
    k: int = 25
    workdir: str = "."
    min_cov: int | None = None  # -m fixed MutantMinCov override
    filter_min_q: int = 15  # -fq
    filter_k_threshold: int = 1  # -fK
    par_low_k: int = 2  # -pl parent jellyfish -L
    subject_low_k: int = 2
    max_hash_depth_seed: int = 1200  # runRufus.sh:27
    exome: bool = False
    single_end: bool = False  # refused: BAM/BGZF/CRAM input
    fastq_a: str = ""
    fastq_b: str = ""
    exclude_hash: str = ""  # -e exclude Jhash table
    batch_size: int = 2048
    read_pad: int = 160
    merge_min: int = 5  # modified-merge count floor (merge_files.cc:149)
    stop_after: str = ""  # "jhash" | "hashlist" | "filter" (StJ/StH/StF)
    sharded: str = "auto"  # "on" is refused: one device
    haploid: bool = False  # ModelDist.haploid fit (ModelDist.haploid.cpp:29)
    count_passes: int = 1  # > 1 is refused: memory model
    spill_tables: str = "auto"  # "on" is refused: memory model
    device: str = "cuda"  # torch device of every stage; "cpu" runs the
    # kernels' plain PyTorch versions (tests)

    @property
    def subject_stub(self) -> str:
        # comma-separated multi-file inputs stub from the first file
        return os.path.basename(self.subject.split(",")[0]) + ".generator"

    def control_stub(self, path: str) -> str:
        return os.path.basename(path.split(",")[0]) + ".generator"

    def wpath(self, *parts) -> str:
        return os.path.join(self.workdir, *parts)
