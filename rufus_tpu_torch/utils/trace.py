"""Stage timers and throughput meters (the structured form of the
reference's wall timers and reads/sec prints, RUFUS.Filter.cpp:178-183).

A pipeline run appends one JSON object per stage to its trace file: wall
and CPU seconds, resident set size and, on a CUDA device, the peak of
device memory allocated by PyTorch during the stage.
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
    """Per-stage wall/CPU seconds and memory; `device` is the torch device
    whose peak allocation each stage records (CUDA only; the peak counter
    is reset at each stage's start)."""

    def __init__(self, log_path: str | None = None, device=None):
        self.stages: list[dict] = []
        self.log_path = log_path
        self.device = device

    @contextmanager
    def stage(self, name: str, **meta):
        import torch

        banner(name)
        cuda = self.device is not None and self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        w0, c0 = time.perf_counter(), time.process_time()
        rec = {"stage": name, **meta}
        try:
            yield rec
        finally:
            if cuda:
                torch.cuda.synchronize(self.device)
                rec["device_peak_bytes"] = torch.cuda.max_memory_allocated(
                    self.device)
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
