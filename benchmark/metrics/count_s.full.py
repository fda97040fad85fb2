"""The count stage's seconds a job in fastq.full."""

from benchmark.lib.readers import count_s as read  # noqa: F401
