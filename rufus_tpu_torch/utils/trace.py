"""Stage timers and spans (the structured form of the reference's wall
timers and reads/sec prints, RUFUS.Filter.cpp:178-183).

A pipeline run appends one JSON object per stage to its trace file: wall
and CPU seconds, resident set size, the number of shards and, on CUDA
devices, the peak of device memory allocated by PyTorch during the stage
(the largest of its cards', and each card's when there are several). Each
stage record also holds its spans (named blocks inside the stage, seconds
and calls by name), its `self_s`, the wall its own thread spent outside
them, and the lists its threads `note` (a BAM stream's counters); a whole
run adds a `run` record. While `torch.profiler` records, a
stage and each span on its thread also open a profiler range, named
`stage:<stage>` and `stage:<stage>/<span>`: a trace reader tells the
program's ranges from device work by that prefix, since the profiler puts
a copy of each range on the device's timeline too.
`MemSampler` samples `memory_attribution` in a thread, tagged with the
live stage, for the peaks inside each stage. `vm_mb`, `malloc_trim`,
`memory_attribution` and `MemSampler` are the JAX package's (its
utils/trace.py), with the card's allocator in place of JAX's buffers.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from contextlib import contextmanager

STAGE_TAG = "stage:"  # the prefix of every profiler range the program opens


def rss_mb() -> float:
    """Current resident set size in MB."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def vm_mb() -> float:
    """Current virtual memory size in MB (the reference's vm_usage)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmSize:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def malloc_trim() -> bool:
    """Return freed glibc arena pages to the OS (host stages that churn
    many small objects leave them resident, which reads as a leak in RSS).
    False where there is no glibc."""
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        return bool(libc.malloc_trim(0))
    except OSError:
        return False


def _mallinfo_mb():
    """(in use, freed but retained) MB of the glibc heap (mallinfo2)."""
    try:
        import ctypes

        class _MI2(ctypes.Structure):
            _fields_ = [(n, ctypes.c_size_t) for n in
                        ("arena", "ordblks", "smblks", "hblks", "hblkhd",
                         "usmblks", "fsmblks", "uordblks", "fordblks",
                         "keepcost")]

        libc = ctypes.CDLL("libc.so.6")
        libc.mallinfo2.restype = _MI2
        mi = libc.mallinfo2()
        return (round((mi.uordblks + mi.hblkhd) / 1e6, 1),
                round(mi.fordblks / 1e6, 1))
    except (OSError, AttributeError):
        return (0.0, 0.0)


def memory_attribution(device=None, trim: bool = False) -> dict:
    """RSS by owner: the glibc heap in use and freed but retained
    (`trim` returns the latter to the OS), and, on a CUDA `device`, the
    bytes PyTorch has allocated there and the allocator holds
    (the JAX package's jax_live_mb); rss_mb is the total."""
    out = {"rss_mb": round(rss_mb(), 1)}
    if device is not None and device.type == "cuda":
        import torch

        out["cuda_allocated_mb"] = round(
            torch.cuda.memory_allocated(device) / 1e6, 1)
        out["cuda_reserved_mb"] = round(
            torch.cuda.memory_reserved(device) / 1e6, 1)
    out["heap_in_use_mb"], out["heap_retained_mb"] = _mallinfo_mb()
    if trim:
        out["trimmed"] = malloc_trim()
        out["rss_after_trim_mb"] = round(rss_mb(), 1)
    return out


def banner(msg: str, stream=None):
    """Stage banner line (runRufus.sh echoes one per stage)."""
    print(f"~~~ {msg} ~~~", file=stream or sys.stderr, flush=True)


def _profiler_range(name: str):
    """A `torch.profiler` range named `name` while a profiler records, else
    a no-op."""
    import torch.autograd.profiler as prof

    if prof._is_profiler_enabled:
        return prof.record_function(name)
    return contextlib.nullcontext()


class StageTimer:
    """Per-stage wall/CPU seconds, memory and spans; `devices` are the
    torch devices (the mesh's distinct cards) whose peak allocation each
    stage records (CUDA only; the peak counters are reset at each stage's
    start), `shards` the mesh's shards."""

    def __init__(self, log_path: str | None = None, devices=(),
                 shards: int = 1):
        self.stages: list[dict] = []
        self.log_path = log_path
        self.cards = [d for d in devices if d.type == "cuda"]
        self.shards = shards
        self.current: str = ""  # the live stage's name, for samplers
        self._lock = threading.Lock()  # reader threads record spans too
        # the live stage's spans, name -> [ns, calls, on the stage's
        # thread], that thread and its record; None between stages
        self._spans: dict | None = None
        self._thread: int | None = None
        self._rec: dict | None = None

    def _write(self, rec: dict):
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    @contextmanager
    def stage(self, name: str, **meta):
        import torch

        banner(name)
        self.current = name
        with _profiler_range(STAGE_TAG + name):
            for d in self.cards:
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
            w0, c0 = time.perf_counter(), time.process_time()
            rec = {"stage": name, "shards": self.shards, **meta}
            spans = self._spans = {}
            self._thread = threading.get_ident()
            self._rec = rec
            try:
                yield rec
            finally:
                for d in self.cards:
                    torch.cuda.synchronize(d)
                peaks = [torch.cuda.max_memory_allocated(d)
                         for d in self.cards]
                if peaks:
                    rec["device_peak_bytes"] = max(peaks)
                if len(peaks) > 1:
                    rec["device_peak_bytes_by_card"] = peaks
                wall = time.perf_counter() - w0
                rec["wall_s"] = round(wall, 3)
                rec["cpu_s"] = round(time.process_time() - c0, 3)
                rec["rss_mb"] = round(rss_mb(), 1)
                with self._lock:
                    self._spans = self._thread = self._rec = None
                    rec["spans"] = {
                        n: {"s": round(ns / 1e9, 6), "n": calls,
                            **({} if own else {"thread": "reader"})}
                        for n, (ns, calls, own) in spans.items()}
                    own_ns = sum(ns for ns, _, own in spans.values() if own)
                rec["self_s"] = round(wall - own_ns / 1e9, 6)
                self.stages.append(rec)
                self._write(rec)

    @contextmanager
    def span(self, name: str):
        """Time the block into the live stage's span `name` (nothing
        outside a stage). From the stage's own thread the block also opens
        the profiler range `stage:<stage>/<name>` while a profiler records;
        a span from another thread (a reader) is kept as such and left out
        of the stage's `self_s`. Touches no device."""
        spans = self._spans
        if spans is None:
            yield
            return
        own = threading.get_ident() == self._thread
        rng = (_profiler_range(f"{STAGE_TAG}{self.current}/{name}") if own
               else contextlib.nullcontext())
        t0 = time.perf_counter_ns()
        try:
            with rng:
                yield
        finally:
            dt = time.perf_counter_ns() - t0
            with self._lock:
                e = spans.setdefault(name, [0, 0, own])
                e[0] += dt
                e[1] += 1

    def note(self, key: str, value):
        """Append `value` to the live stage record's list `key` (nothing
        outside a stage); from any thread, as a reader's counters."""
        with self._lock:
            if self._rec is not None:
                self._rec.setdefault(key, []).append(value)

    @contextmanager
    def run(self, **meta):
        """The `run` record of a whole run: its wall and CPU seconds, the
        wall outside the stages that ran inside it (`outside_stages_s`)
        and the resident set size, with `meta`; written when the block
        returns, never when it raises. It opens no profiler range."""
        w0, c0, first = time.perf_counter(), time.process_time(), \
            len(self.stages)
        rec = {"stage": "run", **meta}
        yield rec
        wall = time.perf_counter() - w0
        rec["wall_s"] = round(wall, 3)
        rec["cpu_s"] = round(time.process_time() - c0, 3)
        rec["outside_stages_s"] = round(
            wall - sum(s["wall_s"] for s in self.stages[first:]), 3)
        rec["rss_mb"] = round(rss_mb(), 1)
        self._write(rec)

    def summary(self) -> str:
        return "\n".join(
            f"{s['stage']:<24} wall={s['wall_s']:>8.2f}s "
            f"cpu={s['cpu_s']:>8.2f}s rss={s['rss_mb']:>7.1f}MB"
            for s in self.stages)


class MemSampler:
    """A thread that records `memory_attribution` every `interval` seconds,
    tagged with the StageTimer's live stage: the peaks inside a stage,
    which its end-of-stage RSS misses, with named owners, and the
    allocator's figures on the timer's first card (none on the CPU). Each
    sample is also appended to `path` as a JSON line when given."""

    def __init__(self, timer: StageTimer, path: str | None = None,
                 interval: float = 10.0):
        self.timer = timer
        self.path = path
        self.interval = interval
        self.device = timer.cards[0] if timer.cards else None
        self.samples: list[dict] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            rec = {"t": round(time.time(), 1), "stage": self.timer.current,
                   **memory_attribution(self.device)}
            self.samples.append(rec)
            if self.path:
                try:
                    with open(self.path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                except OSError:
                    pass

    def start(self):
        self._t.start()
        return self

    def stop(self):
        self._stop.set()
        self._t.join(timeout=2 * self.interval)

    def per_stage_peaks(self) -> dict:
        """stage -> the sample with the highest RSS seen in that stage
        ("(pre)" before the first stage)."""
        peaks: dict[str, dict] = {}
        for s in self.samples:
            st = s.get("stage") or "(pre)"
            if st not in peaks or s["rss_mb"] > peaks[st]["rss_mb"]:
                peaks[st] = s
        return peaks
