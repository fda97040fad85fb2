"""What the per-layer metrics read, once for every cell. Each metric's
file under ``benchmark/metrics/`` binds one of these as its ``read(ctx)``;
a quantity that moves different end-to-end metrics in different cells has
a file a name, so its reading lives here once.

``ctx`` is the traced run's record: ``jobs`` (each job's stage records),
``trace`` (the profiler's reading, None without a card), ``window_s`` (the
jobs' summed wall time), ``work`` (the window's reads, pairs and shapes),
``roofline`` (the yardstick's bounds) and ``stage_mean``. A reader that
finds nothing to read returns None."""


def count_s(ctx):
    """Seconds of the count stage a job (the host feed decoding each
    sample's reads, the count kernels and the table), the mean over the
    window's jobs, from the program's stage records."""
    return ctx.stage_mean("count")


def filter_s(ctx):
    """Seconds of the filter stage a job (the subject's pair stream and the
    window_hits kernel), the mean over the window's jobs."""
    return ctx.stage_mean("filter")


def _stage_peak(ctx, stage):
    peaks = [r[stage]["device_peak_bytes"] for r in ctx.jobs
             if "device_peak_bytes" in r.get(stage, {})]
    return max(peaks) if peaks else None


def count_peak_bytes(ctx):
    """The count stage's device peak over the window's jobs: the largest
    `device_peak_bytes` of its stage records (StageTimer resets the
    card's peak counter at each stage's start)."""
    return _stage_peak(ctx, "count")


def filter_peak_bytes(ctx):
    """The filter stage's device peak over the window's jobs."""
    return _stage_peak(ctx, "filter")


def reads_per_s(ctx):
    """All reads of the three samples that the traced window's jobs took
    through count, subtract and filter, over the jobs' summed wall time:
    the end-to-end rate's arithmetic, read under the profiler."""
    return ctx.work["reads"] / ctx.window_s if ctx.window_s > 0 else None


def device_idle(ctx):
    """Share of the traced window in which no kernel or copy ran on the
    card: one minus the union of the device's intervals, in %."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def _share(ctx, kernel, nbytes):
    if ctx.trace is None:
        return None
    dev = ctx.trace.kernel_seconds(kernel)
    if not dev:
        return None
    return 100.0 * ctx.roofline.bytes_seconds(nbytes) / dev


def encode_canon_roofline(ctx):
    """encode_canon's share of its roofline, in %: the least time the
    window's count batches need (each read's read_pad bytes read, an int64
    key written a window, over the card's HBM bandwidth) over the device
    time the profiler gives the kernel in the window."""
    w, r = ctx.work, ctx.roofline
    return _share(ctx, "encode_canon_kernel",
                  r.encode_canon_bytes(w["reads"], w["read_pad"], w["k"]))


def window_hits_roofline(ctx):
    """window_hits' share of its roofline, in %: the least time the
    window's filter batches need (each mate's bases, qualities and length
    read, the HashList read once a call, a count written a read) over the
    device time the profiler gives the kernel."""
    w, r = ctx.work, ctx.roofline
    return _share(ctx, "window_hits_kernel", r.window_hits_bytes(
        2 * w["pairs"], w["read_pad"], w["hashlist_keys"],
        w["filter_calls"]))
