"""Read and contig alignment: the seed-and-extend local aligner (BWA-mem's
role), its batched device DP, and SAM/BAM output."""

from .aligner import Aligner, Alignment, RefIndex  # noqa: F401
