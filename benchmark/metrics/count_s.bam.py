"""The count stage's seconds a job in bam.front."""

from benchmark.lib.readers import count_s as read  # noqa: F401
