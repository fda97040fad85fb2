"""Stage timers and throughput meters (the structured form of the
reference's wall timers and reads/sec prints, RUFUS.Filter.cpp:178-183).

A pipeline run appends one JSON object per stage to its trace file: wall
and CPU seconds, resident set size, the number of shards and, on CUDA
devices, the peak of device memory allocated by PyTorch during the stage
(the largest of its cards', and each card's when there are several).
`MemSampler` samples `memory_attribution` in a thread, tagged with the
live stage, for the peaks inside each stage. `vm_mb`, `malloc_trim`,
`memory_attribution` and `MemSampler` are the JAX package's (its
utils/trace.py), with the card's allocator in place of JAX's buffers.
"""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


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


@dataclass
class Throughput:
    """Items/second meter with periodic reporting."""

    name: str = "items"
    report_every: int = 1_000_000
    stream: object = None
    t0: float = field(default_factory=time.perf_counter)
    n: int = 0
    _next: int = 0

    def __post_init__(self):
        self._next = self.report_every

    def add(self, n: int):
        self.n += n
        if self.n >= self._next:
            self._next += self.report_every
            self.report()

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.n / dt if dt > 0 else 0.0

    def report(self):
        print(f"{self.name}: {self.n} so far, {self.rate():.0f}/s, "
              f"rss={rss_mb():.0f}MB", file=self.stream or sys.stderr,
              flush=True)


class StageTimer:
    """Per-stage wall/CPU seconds and memory; `devices` are the torch
    devices (the mesh's distinct cards) whose peak allocation each stage
    records (CUDA only; the peak counters are reset at each stage's
    start), `shards` the mesh's shards."""

    def __init__(self, log_path: str | None = None, devices=(),
                 shards: int = 1):
        self.stages: list[dict] = []
        self.log_path = log_path
        self.cards = [d for d in devices if d.type == "cuda"]
        self.shards = shards
        self.current: str = ""  # the live stage's name, for samplers

    @contextmanager
    def stage(self, name: str, **meta):
        import torch

        banner(name)
        self.current = name
        for d in self.cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        w0, c0 = time.perf_counter(), time.process_time()
        rec = {"stage": name, "shards": self.shards, **meta}
        try:
            yield rec
        finally:
            for d in self.cards:
                torch.cuda.synchronize(d)
            peaks = [torch.cuda.max_memory_allocated(d) for d in self.cards]
            if peaks:
                rec["device_peak_bytes"] = max(peaks)
            if len(peaks) > 1:
                rec["device_peak_bytes_by_card"] = peaks
            rec["wall_s"] = round(time.perf_counter() - w0, 3)
            rec["cpu_s"] = round(time.process_time() - c0, 3)
            rec["rss_mb"] = round(rss_mb(), 1)
            self.stages.append(rec)
            if self.log_path:
                with open(self.log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")

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
        import threading

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
