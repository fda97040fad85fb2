"""The card's idle share of bam.front's traced window, in %."""

from benchmark.lib.readers import device_idle as read  # noqa: F401
