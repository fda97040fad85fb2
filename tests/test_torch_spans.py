"""The port's spans (utils/trace.py StageTimer.span and the run record) and
where the pipeline opens them: aggregation by name and thread, the
profiler ranges they open while a profiler records (and only then), and the
records of a small trio run through the filter from FASTQ and from BAM."""

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rufus_tpu_torch import synthetic
from rufus_tpu_torch.pipeline import RufusConfig, RufusPipeline
from rufus_tpu_torch.utils import trace

K = 25
# every span of the count and filter records, and the thread each runs on
COUNT_SPANS = {"feed_wait": None, "step": None, "table_out": None,
               "decode": "reader", "put_wait": "reader"}
FILTER_SPANS = {"feed_wait": None, "keep": None, "write": None,
                "decode": "reader", "put_wait": "reader"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while the module runs, as in
    tests/test_torch_pipeline.py: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_spans_aggregate_by_name_and_thread(tmp_path):
    t = trace.StageTimer(log_path=str(tmp_path / "trace.jsonl"))
    with t.span("outside"):  # no live stage: recorded nowhere
        pass
    with t.stage("count") as rec:
        for _ in range(3):
            with t.span("step"):
                pass
        with t.span("feed_wait"):
            pass

        def reader():
            for _ in range(2):
                with t.span("decode"):
                    threading.Event().wait(0.05)

        th = threading.Thread(target=reader)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    spans = rec["spans"]
    assert set(spans) == {"step", "feed_wait", "decode"}
    assert spans["step"]["n"] == 3 and spans["feed_wait"]["n"] == 1
    assert spans["decode"] == {"s": spans["decode"]["s"], "n": 2,
                               "thread": "reader"}
    assert "thread" not in spans["step"]
    # the reader's 0.1 s ran beside the stage's thread, which waited in
    # join outside any span: self_s keeps it
    own = spans["step"]["s"] + spans["feed_wait"]["s"]
    assert spans["decode"]["s"] >= 0.1
    assert rec["self_s"] >= 0.1
    assert abs(rec["self_s"] + own - rec["wall_s"]) < 2e-3
    assert _records(tmp_path / "trace.jsonl") == [rec]


def test_spans_from_many_threads_lose_no_call():
    t = trace.StageTimer()
    with t.stage("count") as rec:
        def reader():
            for _ in range(500):
                with t.span("decode"):
                    pass

        ths = [threading.Thread(target=reader) for _ in range(8)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in ths)
    assert rec["spans"]["decode"]["n"] == 4000


def test_run_record_only_when_the_block_returns(tmp_path):
    log = str(tmp_path / "trace.jsonl")
    t = trace.StageTimer(log_path=log)
    with pytest.raises(RuntimeError):
        with t.run(init_s=0.5):
            with t.stage("count"):
                pass
            raise RuntimeError("stage failed")
    assert [r["stage"] for r in _records(log)] == ["count"]
    with t.run(init_s=0.25) as rec:
        with t.stage("filter"):
            threading.Event().wait(0.02)
        threading.Event().wait(0.05)
    recs = _records(log)
    assert [r["stage"] for r in recs] == ["count", "filter", "run"]
    assert recs[-1] == rec and rec["init_s"] == 0.25
    assert set(rec) == {"stage", "init_s", "wall_s", "cpu_s",
                        "outside_stages_s", "rss_mb"}
    assert rec["outside_stages_s"] >= 0.04
    assert abs(rec["wall_s"] - recs[1]["wall_s"]
               - rec["outside_stages_s"]) < 2e-3
    assert [r["stage"] for r in t.stages] == ["count", "filter"]


def test_no_range_and_no_sync_without_a_profiler(monkeypatch):
    import torch.autograd.profiler as prof

    opened, synced = [], []
    real = prof.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(prof, "record_function", counting)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: synced.append(1))
    t = trace.StageTimer()
    with t.stage("count"):
        for name in ("feed_wait", "step", "table_out"):
            with t.span(name):
                pass
    assert opened == [] and synced == []
    with profile(activities=[ProfilerActivity.CPU]):
        with t.stage("filter"):
            with t.span("keep"):
                pass
    assert opened == ["stage:filter", "stage:filter/keep"]
    assert synced == []


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    d = tmp_path_factory.mktemp("spantrio")
    data = synthetic.write_trio(str(d / "fastq"), genome_bp=20_000,
                                coverage=30, n_denovo=4, seed=3)
    bams = synthetic.write_trio_bams(data, str(d / "bam"), seed=3)
    return data, bams


def _config(trio, source, workdir, **over):
    data, bams = trio
    kw = dict(k=K, workdir=str(workdir), exome=True, min_cov=5,
              stop_after="filter", device="cpu", batch_size=1000)
    if source == "fastq":
        c = data["child"]
        kw.update(subject=",".join(c), fastq_a=c[0], fastq_b=c[1],
                  controls=[",".join(data[s]) for s in ("mother", "father")])
    else:
        kw.update(subject=bams["child"],
                  controls=[bams["mother"], bams["father"]])
    kw.update(over)
    return RufusConfig(**kw)


@pytest.mark.parametrize("source", ["fastq", "bam"])
def test_front_end_records_every_span(trio, source, tmp_path, capsys):
    cfg = _config(trio, source, tmp_path)
    RufusPipeline(cfg).run()
    recs = _records(cfg.wpath("Intermediates", "trace.jsonl"))
    assert [r["stage"] for r in recs] == ["count", "model", "hashlist",
                                         "filter", "run"]
    by = {r["stage"]: r for r in recs}
    for stage, want in (("count", COUNT_SPANS), ("filter", FILTER_SPANS)):
        rec = by[stage]
        spans = rec["spans"]
        assert set(spans) == set(want), stage
        for name, thread in want.items():
            assert spans[name].get("thread") == thread, (stage, name)
            assert spans[name]["n"] >= 1 and spans[name]["s"] >= 0
        own = sum(s["s"] for s in spans.values() if "thread" not in s)
        assert own <= rec["wall_s"] + 1e-3, stage
        assert abs(rec["self_s"] + own - rec["wall_s"]) < 2e-3, stage
    # 4,000 reads a sample in batches of 1,000: four steps and one table
    # out a sample, and a feed wait for each batch and each stream's end
    assert by["count"]["spans"]["step"]["n"] == 12
    assert by["count"]["spans"]["table_out"]["n"] == 3
    assert by["count"]["spans"]["feed_wait"]["n"] == 15
    assert by["filter"]["spans"]["keep"]["n"] == 2
    run = recs[-1]
    assert set(run) == {"stage", "init_s", "wall_s", "cpu_s",
                        "outside_stages_s", "rss_mb"}
    walls = sum(r["wall_s"] for r in recs[:-1])
    assert abs(run["wall_s"] - walls - run["outside_stages_s"]) < 2e-3
    assert run["init_s"] >= 0 and run["outside_stages_s"] >= -5e-3
    out = capsys.readouterr().out
    for stub in (cfg.subject_stub, *map(cfg.control_stub, cfg.controls)):
        line = next(x for x in out.splitlines()
                    if x.startswith(f"count[{stub}]: "))
        assert line.endswith(" reads/s") and "unique kmers, " in line
        assert float(line.split(", ")[-1].split()[0]) > 0


def test_profiled_run_opens_only_stage_ranges(trio, tmp_path):
    """Under torch.profiler every range the program opens is named
    `stage:...`, and each span's range starts inside its stage's range."""
    cfg = _config(trio, "fastq", tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        RufusPipeline(cfg).run()
    ranges = [(e.time_range.start, e.time_range.end, e.name)
              for e in prof.events() if e.is_user_annotation]
    assert ranges and all(n.startswith("stage:") for _, _, n in ranges)
    stages = {n[len("stage:"):]: (a, b) for a, b, n in ranges
              if "/" not in n}
    assert set(stages) == {"count", "model", "hashlist", "filter"}
    spans = [(a, b, n[len("stage:"):].split("/")) for a, b, n in ranges
             if "/" in n]
    # the stage thread's spans only: a reader thread's never reach the
    # profiler's timeline
    assert {s for _, _, (_, s) in spans} == {"feed_wait", "step",
                                             "table_out", "keep", "write"}
    for a, b, (stage, _) in spans:
        s0, s1 = stages[stage]
        assert s0 < a and b <= s1


def test_prefetch_without_a_timer():
    """With no timer the prefetch records nothing, passes every item on
    and re-raises the reader's error in the consumer."""
    assert list(RufusPipeline._prefetch(iter(range(5)), depth=2)) == \
        [0, 1, 2, 3, 4]

    def failing():
        yield 1
        raise ValueError("decoder failed")

    stream = RufusPipeline._prefetch(failing())
    assert next(stream) == 1
    with pytest.raises(ValueError, match="decoder failed"):
        next(stream)
