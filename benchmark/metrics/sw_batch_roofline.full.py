"""sw_batch's share of its roofline in fastq.full, in %."""

from benchmark.lib.readers import sw_batch_roofline as read  # noqa: F401
