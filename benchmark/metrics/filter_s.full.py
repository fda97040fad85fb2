"""The filter stage's seconds a job in fastq.full."""

from benchmark.lib.readers import filter_s as read  # noqa: F401
