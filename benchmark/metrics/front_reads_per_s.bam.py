"""The front end's reads/s in bam.front's traced window."""

from benchmark.lib.readers import reads_per_s as read  # noqa: F401
