"""The pipeline's own time outside its stages, seconds a job in fastq.full."""

from benchmark.lib.spans import run_outside_stages_s as read  # noqa: F401
