"""The count's table copy, save and histogram, seconds a job in bam.front."""

from benchmark.lib.spans import count_table_out_s as read  # noqa: F401
