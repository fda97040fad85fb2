"""The count's table copy, save and histogram, seconds a job in fastq.front."""

from benchmark.lib.spans import count_table_out_s as read  # noqa: F401
