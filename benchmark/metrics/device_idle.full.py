"""The card's idle share of fastq.full's traced window, in %."""

from benchmark.lib.readers import device_idle as read  # noqa: F401
