"""The count stage's device peak over the window's jobs."""

from benchmark.lib.readers import count_peak_bytes as read  # noqa: F401
