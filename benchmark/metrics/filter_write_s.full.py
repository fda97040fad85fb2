"""The filter's kept-pair writes, seconds a job in fastq.full."""

from benchmark.lib.spans import filter_write_s as read  # noqa: F401
