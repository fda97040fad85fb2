"""One run of one cell: set-up, the measured window, the reading of the
trace, and the comparison that decides `correct`.

Set-up makes the trio from the seed (on the run's device), writes it as the
configuration's input files, on the WGS route finds the child's depth model
of the traffic's numbers (``depthmodel.py``; written into the checkout at
first use, like the program's kernels and decoders), loads the kernels and
decoders and runs one untimed warm-up job. The window is closed-loop: one
user runs trio after trio, each job one call of ``RufusPipeline.run()`` in a
fresh workdir on the same input files, and the window holds the whole jobs
that started before the jobs' summed wall time reached ``seconds``. Before
each job, off the clock, the model files are linked into its workdir.
Between jobs, off the clock, the harness reads the job's outputs and its
stage records, keeps one copy of each distinct set of outputs, deletes the
workdir and times a fixed loop on the host (the host witness, on stderr
beside each job's wall time). Once the window has closed and the device peak
is read, the plain reference works the expected outputs out from the
generator's reads and each distinct set is compared with them.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import torch

from ..gen import trio as gen
from ..reference import compare
from ..roofline import kernels as roofline
from . import depthmodel
from .devtrace import STAGE_TAG, WINDOW_TAG, DeviceTrace
from .registry import BENCH_DIR, CHECKOUT, Registry

BANNED = ("jax", "jaxlib", "flax", "rufus_tpu")  # whole top-level names
WORK_ROOT = os.path.join(CHECKOUT, "build", "benchmark")
MODEL_ROOT = os.path.join(CHECKOUT, "build", "benchmark_models")
FIXED_CUTOFF_MAX_DEPTH = 100_000_000  # the exome route (runRufus.sh:878-893)
WITNESS_LOOPS = 500_000


def banned_modules() -> list:
    """Loaded modules whose top-level name is a banned one."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def make_trio(cell: dict, seed: int, device: str,
              genome_bp: int | None = None):
    """The cell's trio of `seed`, drawn on `device`."""
    cfg, tr = cell["config"], cell["traffic"]
    return gen.make_trio(genome_bp or tr["genome_bp"],
                         n_denovo=tr["denovo_sites"], seed=seed,
                         device=device, **cfg["sample"], **tr["rates"])


def make_inputs(cell: dict, seed: int, device: str, data_dir: str,
                genome_bp: int | None = None):
    """The trio of `seed`, its input files and the reference FASTA. The
    three BAMs are written at once, one thread each (numpy and zlib let go
    of the GIL)."""
    trio = make_trio(cell, seed, device, genome_bp)
    G = len(trio.genome)

    def write(i: int, s: str) -> tuple:
        prefix = os.path.join(data_dir, s)
        if cell["config"]["input"] == "fastq":
            return gen.write_fastq(trio.samples[s], prefix)
        return (gen.write_bam(trio.samples[s], prefix + ".bam", G,
                              seed=[seed, i]),)

    with ThreadPoolExecutor(len(gen.SAMPLES)) as pool:
        inputs = dict(zip(gen.SAMPLES, pool.map(write, range(3),
                                                gen.SAMPLES)))
    ref = gen.write_fasta(trio.genome, os.path.join(data_dir, "ref.fa"))
    return trio, inputs, ref


def wgs(cell: dict) -> bool:
    """Whether the traffic states a depth model (the WGS route) rather
    than a fixed cutoff alone (the exome route)."""
    return "cutoff" in cell["traffic"]["model"]


def route(cell: dict) -> dict:
    """The HashList's count range: on the WGS route, the stated model's
    cutoff and 5 x its raw peak (driver.py stage_model); on the exome
    route, the traffic's fixed cutoff and the route's depth limit."""
    m = cell["traffic"]["model"]
    if wgs(cell):
        return {"min_cov": m["cutoff"], "max_hash_depth": 5 * m["raw_peak"]}
    return {"min_cov": m["min_cov"], "max_hash_depth": FIXED_CUTOFF_MAX_DEPTH}


def job_config(cell: dict, inputs: dict, ref: str, workdir: str,
               device: str):
    """The RufusConfig of one job: the configuration's settings, the
    traffic's stop stage and route, and the inputs. On the WGS route the
    job finds the model files in its workdir and fits none."""
    from rufus_tpu_torch.pipeline import RufusConfig

    cfg, tr = cell["config"], cell["traffic"]
    exome = not wgs(cell)
    kw = dict(cfg["rufus"], workdir=workdir, device=device, ref=ref,
              exome=exome, min_cov=route(cell)["min_cov"] if exome else 0,
              stop_after=tr["stop_after"])
    if cfg["input"] == "fastq":
        c = inputs["child"]
        kw.update(subject=",".join(c), fastq_a=c[0], fastq_b=c[1],
                  controls=[",".join(inputs[s]) for s in ("mother", "father")])
    else:
        kw.update(subject=inputs["child"][0],
                  controls=[inputs["mother"][0], inputs["father"][0]])
    return RufusConfig(**kw)


def run_job(cfg, traced: bool):
    """One trio through RufusPipeline.run(); with `traced`, each stage is
    marked in the profiler's trace. The program's log goes to stderr."""
    from rufus_tpu_torch.pipeline import RufusPipeline

    with contextlib.redirect_stdout(sys.stderr):
        pipe = RufusPipeline(cfg)
        if traced:
            plain = pipe.trace.stage

            @contextlib.contextmanager
            def stage(name, **meta):
                with torch.profiler.record_function(STAGE_TAG + name), \
                        plain(name, **meta) as rec:
                    yield rec

            pipe.trace.stage = stage
        try:
            pipe.run()
            if cfg.device == "cuda":
                torch.cuda.synchronize()
        finally:
            del pipe
            gc.collect()


def host_witness() -> float:
    """Seconds of a fixed pure-Python loop: how fast the host runs now."""
    t = time.perf_counter()
    x = 0
    for i in range(WITNESS_LOOPS):
        x += i * i % 7
    return time.perf_counter() - t


def _stage_records(workdir: str) -> dict:
    path = os.path.join(workdir, "Intermediates", "trace.jsonl")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {r["stage"]: r for r in map(json.loads, f)}


def _card() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "nvidia_smi": smi[0] if smi else "not read"}


def measure(cell: dict, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, genome_bp: int | None = None) -> dict:
    """One run of `cell`; returns the result line's object. `t_start` is
    the process's start on the host clock (perf_counter)."""
    from rufus_tpu_torch.ops import _build

    cuda = device == "cuda"
    rufus, tr = cell["config"]["rufus"], cell["traffic"]
    rt = route(cell)
    run_dir = os.path.join(WORK_ROOT, cell["name"])
    data_dir = os.path.join(run_dir, "data")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(data_dir)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    if cuda:
        _build.build_all()
    _build.build_native()
    marks.append(("build", time.perf_counter()))
    trio, inputs, ref = make_inputs(cell, seed, device, data_dir, genome_bp)
    marks.append(("data", time.perf_counter()))
    histo = compare.stubs(inputs)["child"] + ".Jhash.histo"
    models = ()
    if wgs(cell):
        models = depthmodel.cached(tr["model"], MODEL_ROOT, histo)
        marks.append(("model", time.perf_counter()))
    if cuda:
        torch.cuda.empty_cache()
    cfg_of = lambda wd: job_config(cell, inputs, ref, wd, device)  # noqa: E731
    groups = []  # each distinct set of outputs the jobs wrote, once
    jobs = []  # per job: its name, wall s, group, stage records, failed

    def job(name: str, traced: bool) -> dict:
        wd = os.path.join(run_dir, name)
        if models:
            os.makedirs(wd)
            depthmodel.place(models, os.path.join(wd, histo))
        t0 = time.perf_counter()
        failed = False
        with torch.profiler.record_function(WINDOW_TAG):
            try:
                run_job(cfg_of(wd), traced)
            except Exception:
                traceback.print_exc()
                failed = True
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else None
        # off the clock: the outputs, kept once a distinct set
        got = compare.read_outputs(wd, inputs, rufus["k"], rt["min_cov"])
        recs = _stage_records(wd)
        shutil.rmtree(wd, ignore_errors=True)
        group = next((i for i, g in enumerate(groups)
                      if compare.same(got, g)), len(groups))
        if group == len(groups):
            groups.append(got)
        peaks = [r["device_peak_bytes"] for r in recs.values()
                 if "device_peak_bytes" in r] + [peak]
        return {"name": name, "wall": wall, "group": group, "stages": recs,
                "failed": failed,
                "peak": max(peaks) if cuda else None}

    warmup = job("warmup", False)
    prof = contextlib.nullcontext()
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts):  # the tracer's one-time start
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        prof = profile(activities=acts)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    marks.append(("warmup", t_start + setup_s))
    print("setup phases (s): " + ", ".join(
        f"{n} {b - a:.3f}" for (_, a), (n, b) in zip(marks, marks[1:])),
        file=sys.stderr)
    print(f"host witness before the window: {host_witness() * 1e3:.3f} ms",
          file=sys.stderr)

    window_s = 0.0
    with prof:
        while window_s < seconds:  # the whole jobs that start within it
            jobs.append(job(f"job{len(jobs) + 1}", trace))
            window_s += jobs[-1]["wall"]
            print(f"job {len(jobs)}: {jobs[-1]['wall']:.3f} s, window "
                  f"{window_s:.3f} s, host witness "
                  f"{host_witness() * 1e3:.3f} ms", file=sys.stderr)
    peak = max(j["peak"] for j in jobs) if cuda else None
    dtrace = DeviceTrace(prof) if trace and cuda else None
    del prof
    shutil.rmtree(run_dir, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the peak is read
    exp = compare.Expected(trio, rufus, rt, device)
    fastq = cell["config"]["input"] == "fastq"
    limits = tr["limits"]
    nums = [{n: v for n, v in compare.numbers(g, exp, fastq).items()
             if n in limits} for g in groups]
    worst = {name: 0 for name in limits}
    n_failed = 0
    for j in [warmup] + jobs:
        bad = j["failed"]
        for name, v in nums[j["group"]].items():
            worst[name] = max(worst[name], v)
            bad |= v > limits[name]
        n_failed += bad and j is not warmup
        if bad:
            print(f"{j['name']} not correct: {nums[j['group']]}",
                  file=sys.stderr)
    correct = not n_failed and not (warmup["failed"] or any(
        nums[warmup["group"]][n] > lim for n, lim in limits.items()))

    per_job_reads = sum(2 * s.pairs for s in trio.samples.values())
    reads_per_s = per_job_reads * len(jobs) / window_s
    print(f"front reads/s over the window: {reads_per_s}", file=sys.stderr)
    e2e = {"setup_s": (setup_s, "s"),
           "front_reads_per_s": (reads_per_s, "reads/s"),
           "device_peak_bytes": (peak, "bytes")}
    metrics = {}
    if not trace:
        for m in cell["end_to_end"]:
            value, unit = e2e[m["name"]]
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": unit}
    else:
        child = trio.samples["child"]
        recs = [j["stages"] for j in jobs]
        ctx = SimpleNamespace(
            jobs=recs, trace=dtrace, roofline=roofline, window_s=window_s,
            stage_mean=lambda name: statistics.fmean(
                r[name]["wall_s"] for r in recs) if all(
                    name in r for r in recs) else None,
            work={"reads": per_job_reads * len(jobs),
                  "pairs": child.pairs * len(jobs),
                  "filter_calls": 2 * -(-child.pairs // rufus["batch_size"])
                  * len(jobs),
                  "read_pad": rufus["read_pad"], "k": rufus["k"],
                  "hashlist_keys": exp.hashlist_keys})
        reg = Registry()
        for m in cell["per_layer"]:
            value = reg.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if cuda:
        dev = {**_card(), "count": cell["chips"], "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": None}
    if dtrace is not None:
        dev.update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
    out = {"correct": correct, "attempted": len(jobs), "failed": n_failed,
           "metrics": metrics, "device": dev}
    if dtrace is not None:
        out["breakdown"] = dtrace.breakdown()
    out["checks"] = {name: {"value": worst[name], "limit": lim}
                     for name, lim in limits.items()}
    return out


def emit(result: dict):
    """Each compared number beside its limit as the last lines of stderr,
    then the result as the last line of stdout."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
