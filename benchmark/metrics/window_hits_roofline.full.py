"""window_hits' share of its roofline in fastq.full, in %."""

from benchmark.lib.readers import window_hits_roofline as read  # noqa: F401
