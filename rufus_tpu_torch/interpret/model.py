"""Depth-model loading + Bayesian genotyper (interpret's model half).

Re-derivation of RUFUS.interpret.cpp ProcessDist (5117-5179),
ProcessHighAndLowDist/GetHighAndLowForDist (5181-5233), BayseanGenotyper
(1662-1772), PickDepthSomatic (1587-1617), PickDepthAverage (1618-1642),
GetModes3 (1809-1864) and ParseGenotype (1773-1808).

Quirks preserved:

* the .dist parse offsets: the first data row lands in DistGlobal[i] but
  subsequent rows land in DistGlobal[i-1], so DistGlobal[0] (error dist)
  is shifted one relative to the others, and the trailing tab-led line
  appends the k=0 row values once more (5143-5160);
* GetHighAndLowForDist reads one past the vector end in its third loop —
  we clamp instead (only affects `cumulative` after the bound check);
* the .dist's numeric rows and GetHighAndLowForDist run in the port's
  native host library (``native/interpret.cpp``): strtod rounds as
  float() does, and each column's total is Python's own sum(), whose
  compensated float sum a plain C loop would not reproduce;
* BayseanGenotyper's `else int C = PickDepthAverage(...)` SHADOWS the
  outer C (1738), leaving the reported depth uninitialized in fresh
  builds; the published testRun golden shows the intended value, so we
  resolve the UB to the intended assignment;
* PickDepthAverage with no counts inside the dist limits divides 0/0 —
  x86 double->int of NaN yields INT_MIN, reproduced.
"""

from __future__ import annotations

import ctypes
from array import array

import numpy as np

from ..ops import _build

INT_MIN = -2147483648

_P, _I64 = ctypes.c_void_p, ctypes.c_longlong


class DepthModel:
    def __init__(self):
        self.dist: list[list[float]] = []  # DistGlobal
        self.prior: list[float] = []  # GenPrior
        self.limits: list[tuple[int, int]] = []  # DistLimitsGlobal
        self.dist1x_cutoff = -1
        self.sc_global = -1
        self.is_exome = False

    @classmethod
    def load(cls, path: str):
        m = cls()
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            # ProcessDist tolerates a missing model file (5117-5126): the
            # exome path never produces a .dist, leaving DistGlobal empty
            return m
        lines = text.split("\n", 7)
        if lines[0] == "exome":
            m.is_exome = True
            return m
        # line idx: 0='3', 1=lower, 2=histosum, 3=rawSC, 4=RC line, 5=SC
        m.sc_global = int(float(lines[3]))
        # first data row (line idx 6): DistGlobal[i] <- temp[i] for i=1..T-2
        # (the i==T-1 write is one-past-end UB in C++ and is lost);
        # subsequent rows: DistGlobal[i-1] <- temp[i]. This leaves
        # DistGlobal[0] = ErrorDist shifted by one, DistGlobal[1] = zeros,
        # DistGlobal[j>=2][k] = dist[k][j-1 column], with a misaligned
        # depth-0 entry and the trailing tab-led line appending the k=0 row
        # once more — all exactly as ProcessDist builds it (5139-5160).
        first = lines[6].split("\t")
        m.dist = _dist_columns(len(first) - 1,
                               [float(v) for v in first[1:-1]],
                               lines[7] if len(lines) > 7 else "")
        m.prior = [0.5, 0.5] + [1.0 / i for i in range(2, len(m.dist))]
        return m

    def process_high_low(self):
        self.limits = _high_low(self.dist, 0.997)
        if len(self.limits) > 3:
            self.dist1x_cutoff = self.limits[2][1]
        else:
            self.dist1x_cutoff = 100000


def _dist_columns(ncols: int, head: list, text: str) -> list[list[float]]:
    """DistGlobal's `ncols` columns (T - 1, T the first data row's fields)
    from that row's values `head` (its fields 1..T-2) and the rows after
    it, `text`: column 0, then column c >= 1 led by head[c - 1]; field
    i >= 1 of each later non-empty row, when not empty and i - 1 < ncols,
    appended to column i - 1 as float() reads it (native `dist_columns`)."""
    fn = _build.host_function("dist_columns", ctypes.c_int,
                              (_P, _I64, _I64, _P, _P, _P))
    raw = text.encode()
    counts = np.zeros(ncols, np.int64)
    err = np.zeros(2, np.int64)
    fn(raw, len(raw), ncols, counts.ctypes.data, None, err.ctypes.data)
    counts[1:] += 1
    ends = np.cumsum(counts)
    starts = ends - counts
    out = np.empty(int(ends[-1]) if ncols else 0, np.float64)
    out[starts[1:]] = head
    cursor = starts.copy()
    cursor[1:] += 1
    if fn(raw, len(raw), ncols, cursor.ctypes.data, out.ctypes.data,
          err.ctypes.data):
        bad = raw[err[0]:err[1]].decode()
        raise ValueError(f"could not convert string to float: {bad!r}")
    return [out[s:e].tolist() for s, e in zip(starts.tolist(), ends.tolist())]


def _high_low(dist, percent: float) -> list[tuple[int, int]]:
    """GetHighAndLowForDist of each column (5181-5233, native `high_low`):
    from the column's first maximum, widen both ways, then down, then up,
    until the mass covered reaches `percent` of the column's sum."""
    fn = _build.host_function("high_low", ctypes.c_int,
                              (_P, _P, _P, _I64, ctypes.c_double, _P))
    starts = np.zeros(len(dist) + 1, np.int64)
    np.cumsum(np.array([len(d) for d in dist], np.int64), out=starts[1:])
    flat = array("d")
    for d in dist:
        flat.fromlist(d)
    sums = np.array([sum(d) for d in dist], np.float64)
    out = np.empty((len(dist), 2), np.int64)
    fn(flat.buffer_info()[0], starts.ctypes.data, sums.ctypes.data,
       len(dist), percent, out.ctypes.data)
    return [(lo, hi) for lo, hi in out.tolist()]


def pick_depth_somatic(model: DepthModel, counts) -> int:
    total = 0.0
    s = 0.0
    for c in counts:
        if c < model.dist1x_cutoff:
            total += 1
            s += c
    if total == 0:
        for c in counts:
            total += 1
            s += c
    if total == 0:
        return INT_MIN
    return int(s / total + 0.5)


def pick_depth_average(model: DepthModel, counts, max_i: int) -> int:
    s = 0.0
    total = 0.0
    lim = model.limits[max_i]
    for c in counts:
        depth = c
        if depth > len(model.dist[max_i]):
            depth = len(model.dist[max_i])
        if lim[0] < depth < lim[1]:
            s += depth
            total += 1
    if total == 0:
        return INT_MIN  # 0/0 -> NaN -> x86 int cast
    return int(s / total + 0.5)


def baysean_genotyper(model: DepthModel, counts, var_num: str):
    """Returns (genotype_string, count). Reference 1662-1772 with the
    shadowed-C UB resolved to the intended depth assignment."""
    if len(counts) == 0:
        return "", 0
    if len(model.dist) == 0:  # exome / no model: maxI stays -1
        return "", pick_depth_somatic(model, counts)
    sums = []
    pb = 0.0
    for copy in range(len(model.dist)):
        s = 0.0
        for c in counts:
            depth = c
            if depth > len(model.dist[copy]):
                depth = len(model.dist[copy])
            # depth == len reads one past end in C++ (heap slack ~ 0);
            # clamp to last index reproduces "value present" only when
            # depth < len; use 0.0 at the boundary.
            s += model.dist[copy][depth] if depth < len(model.dist[copy]) else 0.0
        sums.append(s)
        pb += s
    pab = [(sums[i] * model.prior[i]) / pb if pb else float("nan")
           for i in range(len(sums))]
    max_v = -1.0
    max_i = -1
    for i, v in enumerate(pab):
        if v > max_v:
            max_v = v
            max_i = i
    if max_i <= 2:
        c = pick_depth_somatic(model, counts)
    else:
        c = pick_depth_average(model, counts, max_i)
    if max_i <= 0:
        g = ""
    elif max_i == 1:
        g = ""
    elif max_i == 2:
        g = var_num
    else:
        g = var_num * (max_i - 2 + 1)
    return g, c


def parse_genotype(alt: str, ref: str) -> str:
    new_g = ""
    if ref:
        new_g += ref[0]
        for _ in range(1, len(ref)):
            new_g += "/0"
    if alt:
        if new_g:
            new_g += "/"
        new_g += alt[0]
        for i in range(1, len(alt)):
            new_g += "/" + alt[i]
    return new_g if new_g else "."
