"""The count's wait for decoded batches, seconds a job in bam.front."""

from benchmark.lib.spans import count_feed_wait_s as read  # noqa: F401
