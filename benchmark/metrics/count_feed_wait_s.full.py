"""The count's wait for decoded batches, seconds a job in fastq.full."""

from benchmark.lib.spans import count_feed_wait_s as read  # noqa: F401
