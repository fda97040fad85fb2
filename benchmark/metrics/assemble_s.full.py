"""The assembly stage's seconds a job in fastq.full."""

from benchmark.lib.readers import assemble_s as read  # noqa: F401
