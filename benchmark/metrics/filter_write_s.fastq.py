"""The filter's kept-pair writes, seconds a job in fastq.front."""

from benchmark.lib.spans import filter_write_s as read  # noqa: F401
