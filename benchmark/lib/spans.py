"""What the per-layer metrics read from the program's spans: each job's
stage records carry, per stage, the seconds and calls of the named blocks
inside it (``spans``) and, for the whole run, a ``run`` record. Each reading
is the mean over the window's jobs of seconds a job; a reader returns None
where a job's records lack what it reads (a program without the spans)."""

import statistics


def _mean(ctx, value):
    vals = [value(r) for r in ctx.jobs]
    if not vals or None in vals:
        return None
    return statistics.fmean(vals)


def _span_s(ctx, stage, span):
    return _mean(ctx, lambda r: r.get(stage, {}).get("spans", {})
                 .get(span, {}).get("s"))


def count_feed_wait_s(ctx):
    """Seconds a job the count's fold loop waited on an empty queue for a
    decoded batch (the count record's ``feed_wait`` span): the decoders
    set the count's pace for that long."""
    return _span_s(ctx, "count", "feed_wait")


def count_table_out_s(ctx):
    """Seconds a job from the last fold to each sample's saved table and
    histogram (the ``table_out`` span: the flush, the floor, the table's
    copy to the host, its ``.table.npz`` save and the histogram)."""
    return _span_s(ctx, "count", "table_out")


def filter_feed_wait_s(ctx):
    """Seconds a job the filter waited for a decoded batch of pairs (the
    filter record's ``feed_wait`` span)."""
    return _span_s(ctx, "filter", "feed_wait")


def filter_write_s(ctx):
    """Seconds a job the filter spent writing the kept pairs' FASTQ (the
    ``write`` span)."""
    return _span_s(ctx, "filter", "write")


def run_outside_stages_s(ctx):
    """Seconds a job of the pipeline's own outside its stages: building
    the ``RufusPipeline`` (``init_s``) and ``run()``'s wall outside its
    stages (``outside_stages_s``), from the ``run`` record."""
    def one(r):
        run = r.get("run", {})
        if "init_s" not in run or "outside_stages_s" not in run:
            return None
        return run["init_s"] + run["outside_stages_s"]

    return _mean(ctx, one)
