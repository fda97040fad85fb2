"""The front end's reads/s in fastq.front's traced window."""

from benchmark.lib.readers import reads_per_s as read  # noqa: F401
