"""The read alignment stage's seconds a job in fastq.full."""

from benchmark.lib.readers import align_reads_s as read  # noqa: F401
