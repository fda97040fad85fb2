"""The contig stage's seconds a job in fastq.full."""

from benchmark.lib.readers import contig_align_s as read  # noqa: F401
