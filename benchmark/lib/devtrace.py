"""Reads a torch.profiler trace of the measured window: the device's busy
time (the union of kernel and copy intervals), its idle gaps labelled with
the pipeline stage that was running, and each kernel's device time. The
window is the union of the timed jobs' spans (each marked WINDOW_TAG): the
harness's checks between jobs are not in it."""

from __future__ import annotations

import collections

STAGE_TAG = "stage:"  # record_function names the harness puts round stages
WINDOW_TAG = "bench:job"  # ... and round each timed job


def _intervals(prof):
    """(device intervals [(start, end, name)], stage spans [(start, end,
    name)], job spans [(start, end)]), times in microseconds of the
    profiler's clock."""
    from torch.autograd import DeviceType

    dev, stages, windows = [], [], []
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        tagged = e.name.startswith(STAGE_TAG) or e.name == WINDOW_TAG
        if e.device_type == DeviceType.CUDA:
            # the harness's own marks also appear on the device's timeline
            if t1 > t0 and not tagged:
                dev.append((t0, t1, e.name))
        elif e.name.startswith(STAGE_TAG):
            stages.append((t0, t1, e.name[len(STAGE_TAG):]))
        elif e.name == WINDOW_TAG:
            windows.append((t0, t1))
    return dev, stages, windows


def _union(dev):
    merged = []
    for t0, t1, _ in sorted(dev):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


class DeviceTrace:
    """What the window's trace says, in seconds."""

    def __init__(self, prof):
        dev, stages, windows = _intervals(prof)
        stages.sort()
        self.window_s = self.busy_s = 0.0
        self.by_name = collections.Counter()
        self.idle_by_stage = collections.Counter()
        for lo, hi in sorted(windows):
            cut = [(max(a, lo), min(b, hi), n) for a, b, n in dev
                   if b > lo and a < hi]
            busy = _union(cut)
            self.window_s += (hi - lo) / 1e6
            self.busy_s += sum(b - a for a, b in busy) / 1e6
            for a, b, n in cut:
                self.by_name[n] += (b - a) / 1e6
            at = lo
            for a, b in busy + [[hi, hi]]:
                if a > at:
                    mid = (at + a) / 2
                    label = next((n for s0, s1, n in stages
                                  if s0 <= mid < s1), "between stages")
                    self.idle_by_stage[label] += (a - at) / 1e6
                at = max(at, b)

    def kernel_seconds(self, symbol: str):
        """Device seconds of the kernels whose name holds `symbol`; None if
        none ran."""
        hits = [s for n, s in self.by_name.items() if symbol in n]
        return sum(hits) if hits else None

    def breakdown(self) -> dict:
        return {"device_ops": [[n[:120], s] for n, s in
                               self.by_name.most_common(10)],
                "idle_gaps": [[n, s] for n, s in
                              self.idle_by_stage.most_common(10)]}
