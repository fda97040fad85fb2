"""The per-layer readers on a hand-made record of a traced window."""

from types import SimpleNamespace

from benchmark.lib import readers
from benchmark.lib.registry import Registry
from benchmark.roofline import kernels


def _ctx(trace=None):
    jobs = [{"count": {"wall_s": 1.0, "device_peak_bytes": 700},
             "filter": {"wall_s": 0.5, "device_peak_bytes": 90}},
            {"count": {"wall_s": 3.0, "device_peak_bytes": 900},
             "filter": {"wall_s": 0.7}}]
    return SimpleNamespace(
        jobs=jobs, trace=trace, roofline=kernels, window_s=4.0,
        stage_mean=lambda s: sum(j[s]["wall_s"] for j in jobs) / len(jobs),
        work={"reads": 10_000_000, "pairs": 2_000_000, "filter_calls": 62,
              "read_pad": 160, "k": 25, "hashlist_keys": 2_498})


def test_stage_readers():
    ctx = _ctx()
    assert readers.count_s(ctx) == 2.0 and readers.filter_s(ctx) == 0.6
    assert readers.count_peak_bytes(ctx) == 900
    assert readers.filter_peak_bytes(ctx) == 90
    assert readers.reads_per_s(ctx) == 2_500_000


def test_device_readers_need_a_trace():
    ctx = _ctx()
    for read in (readers.device_idle, readers.encode_canon_roofline,
                 readers.window_hits_roofline):
        assert read(ctx) is None
    trace = SimpleNamespace(busy_s=1.0, window_s=4.0,
                            kernel_seconds=lambda name: 0.5)
    ctx = _ctx(trace)
    assert readers.device_idle(ctx) == 75.0
    least = kernels.bytes_seconds(kernels.encode_canon_bytes(
        10_000_000, 160, 25))
    assert readers.encode_canon_roofline(ctx) == 100.0 * least / 0.5


def test_each_cell_reads_one_of_each_quantity():
    reg = Registry()
    for cell in ("fastq.front", "bam.front"):
        got = [reg.reader(m["name"]) for m in reg.cell(cell)["per_layer"]]
        assert len(set(got)) == len(got), cell
