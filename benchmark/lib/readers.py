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


def trio_s(ctx):
    """Seconds a whole trio job takes, from FASTQ to FINAL.vcf.gz: the
    window's summed job walls over its jobs, on the host clock."""
    return ctx.window_s / len(ctx.jobs) if ctx.jobs else None


def align_reads_s(ctx):
    """Seconds of the read alignment stage a job: the kept pairs' seeding
    and candidate DPs (sw_batch), pairing, duplicate marking, the SAM and
    BAM writes."""
    return ctx.stage_mean("align_reads")


def assemble_s(ctx):
    """Seconds of the assembly stage a job: the overlap rounds and the
    annotations, host code."""
    return ctx.stage_mean("assemble")


def contig_align_s(ctx):
    """Seconds of the contig stage a job: the contigs' alignment with
    splits (sw_batch), the reference context, the k-mer tabs and the
    genotype pulls from the three sample tables on the card."""
    return ctx.stage_mean("contig_align")


def interpret_s(ctx):
    """Seconds a job of interpret (the depth model's load, the calls and
    the genotyper) and polish (the sort, the filter and FINAL.vcf.gz with
    its index), summed."""
    a, b = ctx.stage_mean("interpret"), ctx.stage_mean("polish")
    return None if a is None or b is None else a + b


def sw_batch_roofline(ctx):
    """sw_batch's share of its roofline, in %: the least time the window's
    DP cells need (each cell's integer operations over the card's INT32
    peak), the cells from the align_reads and contig_align records' ``dp``
    summaries, over the device time the profiler gives the kernel."""
    if ctx.trace is None:
        return None
    dev = ctx.trace.kernel_seconds("sw_ragged_kernel")
    cells = sum(r[s]["dp"]["cells"] for r in ctx.jobs
                for s in ("align_reads", "contig_align")
                if "dp" in r.get(s, {}))
    if not dev or not cells:
        return None
    return 100.0 * ctx.roofline.ops_seconds(
        ctx.roofline.sw_batch_ops(cells)) / dev
