"""The filter stage's device peak over fastq.full's window."""

from benchmark.lib.readers import filter_peak_bytes as read  # noqa: F401
