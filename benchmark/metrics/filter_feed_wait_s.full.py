"""The filter's wait for decoded pairs, seconds a job in fastq.full."""

from benchmark.lib.spans import filter_feed_wait_s as read  # noqa: F401
