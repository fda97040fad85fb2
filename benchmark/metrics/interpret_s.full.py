"""Interpret's and polish's seconds a job in fastq.full."""

from benchmark.lib.readers import interpret_s as read  # noqa: F401
