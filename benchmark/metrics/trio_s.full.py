"""The wall of a whole trio job in fastq.full, seconds."""

from benchmark.lib.readers import trio_s as read  # noqa: F401
