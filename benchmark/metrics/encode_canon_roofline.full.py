"""encode_canon's share of its roofline in fastq.full, in %."""

from benchmark.lib.readers import encode_canon_roofline as read  # noqa: F401
