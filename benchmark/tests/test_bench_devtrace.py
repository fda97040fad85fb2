"""The trace reader: busy and idle time within the timed jobs' spans only,
idle gaps labelled with the stage that ran, and kernels by name."""

from types import SimpleNamespace

import numpy as np
from torch.autograd import DeviceType

from benchmark.lib.devtrace import STAGE_TAG, WINDOW_TAG, DeviceTrace
from benchmark.reference import compare


def _ev(name, t0, t1, cuda=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=t0, end=t1), device_type=DeviceType.CUDA if cuda
        else DeviceType.CPU)


def test_window_is_the_jobs_spans():
    events = [
        _ev(WINDOW_TAG, 0, 1_000_000), _ev(WINDOW_TAG, 3_000_000, 4_000_000),
        _ev(STAGE_TAG + "count", 0, 600_000),
        _ev(STAGE_TAG + "filter", 3_000_000, 4_000_000),
        _ev("encode_canon_kernel", 100_000, 300_000, cuda=True),
        _ev("encode_canon_kernel", 200_000, 400_000, cuda=True),
        # between the jobs, where the harness checks: not in the window
        _ev("Memcpy DtoH", 1_500_000, 2_500_000, cuda=True),
        _ev("window_hits_kernel", 3_900_000, 4_100_000, cuda=True),
    ]
    t = DeviceTrace(SimpleNamespace(events=lambda: events))
    assert t.window_s == 2.0
    assert abs(t.busy_s - 0.4) < 1e-12  # 0.1-0.4 s, and 3.9-4.0 s
    assert t.kernel_seconds("encode_canon") == 0.4
    assert abs(t.kernel_seconds("window_hits") - 0.1) < 1e-12
    assert t.kernel_seconds("Memcpy") is None
    idle = dict(t.breakdown()["idle_gaps"])
    # gaps go to the stage at their middle: 0-0.1 s to the count,
    # 0.4-1.0 s to none, 3.0-3.9 s to the filter
    assert abs(idle["count"] - 0.1) < 1e-12
    assert abs(idle["between stages"] - 0.6) < 1e-12
    assert abs(idle["filter"] - 0.9) < 1e-12


def test_same_outputs():
    a = {"tables": {"child": (np.arange(3, dtype=np.uint64),
                              np.ones(3, np.int64))},
         "hashlist": ["AAA 5"], "pairs": [("p", "AC", "II", "GT", "II")]}
    b = {"tables": {"child": (np.arange(3, dtype=np.uint64),
                              np.ones(3, np.int64))},
         "hashlist": ["AAA 5"], "pairs": [("p", "AC", "II", "GT", "II")]}
    assert compare.same(a, b)
    b["tables"]["child"][1][2] = 2
    assert not compare.same(a, b)
    b["tables"]["child"][1][2] = 1
    b["pairs"] = [("p", "AC", "II", "GT", "I#")]
    assert not compare.same(a, b)
