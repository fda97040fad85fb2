"""encode_canon's share of its roofline in fastq.front, in %."""

from benchmark.lib.readers import encode_canon_roofline as read  # noqa: F401
