"""K-mer depth mixture model — faithful re-derivation of ModelDist.

Fits a skewed-normal copy-number mixture plus a power-law error model to a
sample's k-mer depth histogram, producing the count cutoff (MutantMinCov),
the raw peak (rawSC, MaxHashDepth = 5*rawSC) and the per-copy-number depth
distributions consumed by the Bayesian genotyper.

This is a semantics-exact reimplementation of reference src/ModelDist.cpp
(main: 375-973) with its quirks preserved because they are output-visible
(SURVEY.md section 7.3):

* histogram rows with a zero in either column are burned from the front, so
  with `-L 2` counting the vector indices are shifted by one relative to
  true depth (ModelDist.cpp:430-449);
* `histo[SC]` with double SC truncates (float-as-index, 778-787);
* the skew line-search loop never executes (its `and SKhigh < 1e-50`
  condition is false on entry, 639) — skew stays 0;
* FitErrorModel's p-grid accumulates in float32 (`p += -.001f`, 341);
* error-subtracted histo2 entries truncate toward zero (vector<long>, 514);
* in the *final* tables `prob` rows are shifted by one relative to counts
  (prob.push_back placeholder at 723 then rows from i=0) while inside
  testModel they are not — both reproduced;
* column-normalization and marginal sums run over j=1..C-1, skipping the
  last column (749, 764);
* the fitted-vs-final dist differ in row offset (placeholder at row 0 in
  testModel only).

The (count x copy) grids vectorize in numpy float64 (== C++ double); the
reference's `#pragma omp parallel for num_threads(11)` 11-point sweep
becomes a vectorized bracket step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def _norm(x, mu, sigma, skew, p):
    """Skewed normal (ModelDist.cpp:31-37); x may be an array.

    skew == 0 (always, in practice — the skew search never runs) makes the
    pow term identically 0 for p > 0; short-circuit it, the general power
    dominates the fit runtime otherwise."""
    x = np.asarray(x, dtype=np.float64)
    if np.isscalar(skew) and skew == 0.0 and p > 0:
        sig = np.broadcast_to(np.asarray(sigma, dtype=np.float64),
                              np.broadcast_shapes(np.shape(x), np.shape(sigma)))
    else:
        sig = np.where(x < mu, sigma + np.power((mu - x) * skew, p), sigma)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        return (1.0 / np.sqrt(2 * PI * sig**2)) * np.exp(-((x - mu) ** 2) / (2 * sig**2))


PI = 3.14159  # the reference's pi (ModelDist.cpp:28), not math.pi


def read_histo(path: str):
    """Parse a (tab-separated) jellyfish histo file with the burn rule.

    Returns (histo, inflection, raw_sc, sc_value, histo_sum, total, n_lines,
    total_kmers) exactly as ModelDist.cpp:428-481 computes them. `histo` is
    int64 with histo[0] == 0 and histo[1] == first row whose both columns
    are nonzero.
    """
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split("\t") if "\t" in line else line.split()
            if len(parts) < 2:
                continue
            rows.append((int(parts[0]), int(float(parts[1]))))
    # burn while either column is zero (max 10 extra burns then error)
    idx = 0
    burn = 0
    while idx < len(rows) and (rows[idx][0] == 0 or rows[idx][1] == 0):
        idx += 1
        burn += 1
        if burn > 11:
            raise ValueError("no kmers in histo")
    if idx >= len(rows):
        raise ValueError("no kmers in histo")
    histo = [0, rows[idx][1]]
    last = rows[idx][1]
    inflection = -1
    past = False
    sc, sc_value = 1, -1.0
    total = 0
    total_kmers = 0
    histo_sum = 0.0
    i = 1
    for count_col, value in rows[idx + 1 :]:
        i += 1
        histo.append(value)
        total += value
        total_kmers += value * count_col
        histo_sum += value
        if value - last > 0 and not past:
            inflection = i - 1
            past = True
        if past and sc_value < value:
            sc_value = value
            sc = i
        last = histo[i]
    return (np.array(histo, dtype=np.int64), inflection, sc, sc_value,
            histo_sum, total, i, total_kmers)


def fit_error_model(error: np.ndarray, max_i: int):
    """FitErrorModel (ModelDist.cpp:333-359): fit Error[i]=Error[1]/i^p.

    p-grid walks 7 -> .1 in float32 steps of -.001 (the float accumulation
    is reproduced); returns (fitted error array, total, best_p).
    """
    error = error.astype(np.float64).copy()
    n = len(error)
    idx = np.arange(1, max_i, dtype=np.float64)
    with np.errstate(divide="ignore"):
        log_e = np.log(error[1:max_i])
    log_e1 = np.log(error[1]) if error[1] > 0 else -np.inf

    # p grid generated with float32 accumulation
    ps = []
    p = np.float32(7.0)
    while p > np.float32(0.1):
        ps.append(float(p))
        p = np.float32(p + np.float32(-0.001))
    ps = np.array(ps, dtype=np.float64)

    # LastSSQ at p=100
    with np.errstate(over="ignore"):
        last_ssq = float(np.sum((log_e - (log_e1 - 100.0 * np.log(idx))) ** 2)) if max_i > 1 else 0.0
    best_p = 0.0
    if max_i > 1:
        ssqs = np.sum((log_e[None, :] - (log_e1 - ps[:, None] * np.log(idx[None, :]))) ** 2, axis=1)
        # first strict improvement wins ties like the serial loop
        cur = last_ssq
        for pv, sv in zip(ps, ssqs):
            if sv < cur:
                cur = sv
                best_p = pv
    out = error.copy()
    ii = np.arange(1, n, dtype=np.float64)
    out[1:] = (1.0 / np.power(ii, best_p)) * error[1]
    total = float(np.sum(out[1:]))
    return out, total, best_p


def _build_dist_cols(i_vals, size, SC, stdev, factor, skew, power, diploid=True):
    """dist columns for given row indices: col 1 = het, cols 2..C = SC*j.

    C_loop = number of j values with j < size/SC (j starts at 1).
    Returns array (len(i_vals), C_loop+2) with col 0 == 0.
    """
    n_j = int(np.ceil(size / SC - 1)) if size / SC > 1 else 0
    # j = 1 .. n_j  (j < size/SC)
    j = np.arange(1, n_j + 1, dtype=np.float64)
    x = np.asarray(i_vals, dtype=np.float64)[:, None]
    cols = [np.zeros((len(i_vals), 1))]
    if diploid:
        het_sig = stdev * (1 - ((1 - (stdev / (stdev + factor))) / 2))
        cols.append(_norm(x, SC / 2, het_sig, skew, power).reshape(-1, 1))
    main = _norm(x, SC * j[None, :], stdev + (j[None, :] - 1) * factor, skew, power)
    cols.append(main)
    return np.concatenate(cols, axis=1), n_j


def _test_model(SC, stdev, factor, skew, power, histo2, inflection, max_copy,
                ybar, log_mode: bool, diploid: bool = True):
    """testModel / testModelLog (ModelDist.cpp:71-304; haploid variant
    ModelDist.haploid.cpp:72-188 drops the het column — `if (Diploid)`
    guards at 86, 128, 145, 151). Returns SSres(/Log)."""
    size = len(histo2)
    if size / SC <= 1:
        return np.inf
    rows = np.arange(1, size)
    dist, n_j = _build_dist_cols(rows, size, SC, stdev, factor, skew, power,
                                 diploid=diploid)
    ncols = dist.shape[1]
    with np.errstate(invalid="ignore", divide="ignore"):
        # dist[i][col] (diploid): col1=het, col2..=SC*j. Normalization over
        # j=1..C_loop-1 where C_loop counts the loop "j=1; j<size/SC": it
        # runs j=1..n_j, i.e. columns 1..n_j — in diploid that SKIPS the
        # last (main) column n_j+1; in haploid the built columns are exactly
        # 1..n_j so every column is normalized (ModelDist.haploid.cpp:97-107)
        col_sums = dist[:, 1 : n_j + 1].sum(axis=0)
        dist[:, 1 : n_j + 1] = dist[:, 1 : n_j + 1] / col_sums[None, :]
        # prob[i][j] = dist[i][j] / sum(dist[i][1..n_j])
        tot = dist[:, 1 : n_j + 1].sum(axis=1)
        prob = np.zeros_like(dist)
        prob[:, 1:ncols] = dist[:, 1:ncols] / tot[:, None]

    def D(i, c):  # dist row for count i (rows start at count 1)
        return dist[int(i) - 1, c]

    H = histo2.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        if diploid:
            tSC = H[int(SC)] / D(SC, 2)
            het = (H[int(SC / 2)] - D(SC / 2, 2) * tSC) / D(SC / 2, 1)
            # a = 2 .. while a < size/SC (same count as the n_j loop minus 1)
            n_a = n_j - 1
            a_vals = np.arange(2, 2 + max(0, n_a))
            rows_a = (SC * a_vals).astype(np.int64)  # float->int truncation
            RC = np.zeros(3 + max(0, n_a))
            RC[1] = het if het > 0 else 0.0
            RC[2] = H[int(SC)] / D(SC, 2)
            if n_a > 0:
                RC[3:] = (H[rows_a] / dist[rows_a - 1, a_vals + 1]
                          * prob[rows_a - 1, a_vals + 1])
        else:
            # haploid (ModelDist.haploid.cpp:145-158): RC[1] = 1x copy at
            # column 1 (no het), higher copies at column a (not a+1)
            n_a = n_j - 1
            a_vals = np.arange(2, 2 + max(0, n_a))
            rows_a = (SC * a_vals).astype(np.int64)
            RC = np.zeros(2 + max(0, n_a))
            RC[1] = H[int(SC)] / D(SC, 1)
            if n_a > 0:
                RC[2:] = (H[rows_a] / dist[rows_a - 1, a_vals]
                          * prob[rows_a - 1, a_vals])
    # ModelSums[i] = sum_{j=1..n_j} dist[i][j] * RC[j]
    n_use = min(n_j + 1, len(RC))
    with np.errstate(invalid="ignore"):
        model_sums = dist[:, 1:n_use] @ RC[1:n_use]
    # index: model_sums[i-1] corresponds to count i
    lo, hi = inflection, SC * max_copy
    i_range = np.arange(lo, int(np.ceil(hi)))
    i_range = i_range[i_range < hi]
    i_range = i_range[(i_range >= 1) & (i_range < size)]
    h = H[i_range]
    m = model_sums[i_range - 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        if log_mode:
            val = np.sum((np.log(h) - np.log(m)) ** 2)
        else:
            val = np.sum((h - m) ** 2)
    return float(val) if not np.isnan(val) else np.inf


def _bracket_search(f, low, high, low_floor, stop_ratio, high_floor):
    """The reference's 10-interval bracketed descent (e.g. 536-565).

    Update order is reproduced: low is updated first, then high uses the
    NEW low with the OLD span, and best uses both new values.
    """
    best = None
    guard = 0
    while low / high < stop_ratio and high > high_floor:
        guard += 1
        xs = [low + ((high - low) / 10) * x for x in range(11)]
        values = [f(x) for x in xs]
        lowest_x = int(np.argmin(values))  # first min wins ties, like the loop
        # reproduce "first strictly lower" semantics
        lo_v, lo_i = values[0], 0
        for x in range(1, 11):
            if values[x] < lo_v:
                lo_v, lo_i = values[x], x
        lowest_x = lo_i
        cand = low + ((high - low) / 10) * (lowest_x - 1)
        if cand >= low_floor:
            new_low = cand
        else:
            new_low = low_floor
        high = new_low + ((high - new_low) / 10) * (lowest_x + 1)
        low = new_low
        best = low + ((high - low) / 10) * lowest_x
        if guard > 500:
            break
    return best, low, high


@dataclass
class ModelFit:
    kcutoff: int
    raw_sc: int
    histo_sum: float
    sc: float
    stdev: float
    factor: float
    skew: float
    power: float
    error_total: float  # "burner"
    error_model: np.ndarray
    error_dist: np.ndarray
    rc: np.ndarray
    dist_final: np.ndarray  # rows = counts 0..size-1; cols 0..C (col1 = het)
    prob_final: np.ndarray  # rows shifted: prob[count+1]
    model_final: np.ndarray
    model_sums: np.ndarray
    n_j: int = 0
    genome_size: float = 0.0
    raw_histo: np.ndarray | None = None


def fit_model(histo_path: str, hash_size: int, read_length: int = 150,
              haploid: bool = False) -> ModelFit:
    """Full ModelDist main flow (ModelDist.cpp:375-973).

    haploid=True follows ModelDist.haploid.cpp instead (Diploid=false,
    DiploidSimpel=true at :29-30): the single-copy peak and stdev are
    HALVED before fitting (:527-531), the het column is dropped everywhere,
    the final normalization covers every built column, and the kcutoff rule
    becomes `> 0.9` with `kcutoff = k - 1` (:876-877)."""
    (histo, inflection, SC, sc_value, histo_sum, total, n_lines,
     total_kmers) = read_histo(histo_path)
    size = len(histo)
    ybar = total / n_lines
    raw_sc = int(SC)

    # stdev estimate (488-498)
    stdvalue = sc_value * math.exp(-0.5)
    i = SC
    while i < size:
        if histo[i] - stdvalue < 0:
            break
        i += 1
    stdev = float(i - SC)

    error_model, burner, _p = fit_error_model(histo.astype(np.float64), inflection)
    error_dist = error_model / burner
    # histo2: error-subtracted, truncated toward zero (vector<long>)
    diff = histo.astype(np.float64) - error_model
    histo2 = np.where(diff > 0, diff, 0.0).astype(np.int64)

    SC0 = float(SC)
    if haploid:
        # DiploidSimpel: the observed peak is the 1x peak now, so halve it
        # (SC is a double — no truncation; ModelDist.haploid.cpp:527-531)
        SC0 = SC0 / 2
        stdev = stdev * 0.5
    diploid = not haploid

    factor, skew, power = 1.0, 0.0, 1.0
    bestS, bestF, bestSC, bestSK, bestP = stdev, factor, SC0, skew, power
    SC_cur, stdev_cur = SC0, stdev  # bracket centers, updated per pass

    for _pass in range(3):
        f = lambda x: _test_model(bestSC, bestS, x, bestSK, bestP, histo2,
                                  inflection, 5, ybar, log_mode=True,
                                  diploid=diploid)
        b, *_ = _bracket_search(f, 1.0, 20.0, 0.0, 0.999, 1e-10)
        if b is not None:
            bestF = b
        f = lambda x: _test_model(x, bestS, bestF, bestSK, bestP, histo2,
                                  inflection, 5, ybar, log_mode=False,
                                  diploid=diploid)
        b, *_ = _bracket_search(f, SC_cur * 0.9, SC_cur * 1.1, 0.0, 0.999, 1e-50)
        if b is not None:
            bestSC = b
        f = lambda x: _test_model(bestSC, x, bestF, bestSK, bestP, histo2,
                                  inflection, 5, ybar, log_mode=False,
                                  diploid=diploid)
        b, *_ = _bracket_search(f, stdev_cur * 0.9, stdev_cur * 1.1, 0.0, 0.99, 1e-50)
        if b is not None:
            bestS = b
        # skew loop never runs (condition `and SKhigh < 1e-50` false, :639)
        f = lambda x: _test_model(bestSC, bestS, bestF, bestSK, x, histo2,
                                  inflection, 5, ybar, log_mode=True,
                                  diploid=diploid)
        b, *_ = _bracket_search(f, 1.0, 2.0, 1.0, 0.999, 1e-50)
        if b is not None:
            bestP = b
        # loop tail assignments (711-716): next pass brackets re-center
        SC_cur, stdev_cur = bestSC, bestS

    SCf, stdevf, factorf, skewf, powerf = bestSC, bestS, bestF, bestSK, bestP

    # ---- final tables (733-825): rows now from count 0, no placeholder ----
    rows = np.arange(0, size)
    dist, n_j = _build_dist_cols(rows, size, SCf, stdevf, factorf, skewf,
                                 powerf, diploid=diploid)
    with np.errstate(invalid="ignore", divide="ignore"):
        for c in range(1, n_j + 1):  # diploid: last column skipped (749);
            s = dist[:, c].sum()     # haploid: 1..n_j IS every column
            dist[:, c] = dist[:, c] / s
        tot = dist[:, 1 : n_j + 1].sum(axis=1)
        # prob rows are SHIFTED: prob[count+1][j], j = 1..n_j (759-772)
        prob = np.zeros((size + 1, n_j + 1))
        prob[1:, 1 : n_j + 1] = dist[:, 1 : n_j + 1] / tot[:, None]

    H = histo.astype(np.float64)
    RC = [0.0]
    with np.errstate(invalid="ignore", divide="ignore"):
        if diploid:
            tSC = H[int(SCf)] / dist[int(SCf), 2]
            het = (H[int(SCf / 2)] - dist[int(SCf / 2), 2] * tSC) / dist[int(SCf / 2), 1]
            RC.append(het if het > 0 else 0.0)
            RC.append(H[int(SCf)] / dist[int(SCf), 2])
            a = 2
            while a < size / SCf:
                # prob row SC*a is count SC*a - 1 (the off-by-one, :803)
                RC.append(H[int(SCf * a)] / dist[int(SCf * a), a + 1]
                          * prob[int(SCf * a), a + 1] if a + 1 <= n_j else 0.0)
                a += 1
        else:
            # haploid (ModelDist.haploid.cpp:800-824): copy c at column c
            RC.append(H[int(SCf)] / dist[int(SCf), 1])
            a = 2
            while a < size / SCf:
                RC.append(H[int(SCf * a)] / dist[int(SCf * a), a]
                          * prob[int(SCf * a), a] if a <= n_j else 0.0)
                a += 1
    RC = np.array(RC)
    n_use = min(n_j + 1, len(RC))
    with np.errstate(invalid="ignore"):
        model = dist[:, 1:n_use] * RC[1:n_use][None, :]
        model_sums = model.sum(axis=1)
    genome_size = float(np.sum(RC[1:] * np.arange(1, len(RC))))

    # kcutoff (852-868): first k with num/(num+ErrorDist[k]) > .5 (diploid)
    # or > .9 with kcutoff = k-1 (haploid, ModelDist.haploid.cpp:864-880);
    # num = sum over ALL columns c=1..ncols-1 of dist[k][c], accumulated in
    # a C `float` (float32)
    kcutoff = -1
    thresh = 0.5 if diploid else 0.9
    for kk in range(1, size):
        num = np.float32(0.0)
        for v in dist[kk, 1:]:
            # C++ `num += d` with float num, double d: add in double,
            # truncate the result to float
            num = np.float32(np.float64(num) + v)
        num = float(num)
        denom = num + error_dist[kk]
        if denom > 0 and num / denom > thresh:
            kcutoff = kk if diploid else kk - 1
            break

    return ModelFit(
        kcutoff=kcutoff, raw_sc=raw_sc, histo_sum=histo_sum, sc=SCf,
        stdev=stdevf, factor=factorf, skew=skewf, power=powerf,
        error_total=burner, error_model=error_model, error_dist=error_dist,
        rc=RC, dist_final=dist, prob_final=prob, model_final=model,
        model_sums=model_sums, n_j=n_j, genome_size=genome_size,
        raw_histo=histo,
    )


def _g(x) -> str:
    """C++ `ostream <<` default double formatting (6 significant digits)."""
    if isinstance(x, (int, np.integer)):
        return str(int(x))
    x = float(x)
    if x != x:
        return "-nan" if math.copysign(1, x) < 0 else "nan"
    if x == float("inf"):
        return "inf"
    if x == float("-inf"):
        return "-inf"
    return f"{x:.6g}"


def write_outputs(fit: ModelFit, histo_path: str, haploid: bool = False):
    """Write .7.7.model / .7.7.dist / .7.7.prob (ModelDist.cpp:870-966).

    haploid=True reproduces ModelDist.haploid.cpp:882-948 instead: the
    4-line header goes to the .model only, the .dist header is just
    HistoSum, the prob file is named `.7.7boom.prob` and is opened but
    never written (:388-391, :944), and there is no trailing dist[0] row.
    """
    if haploid:
        return _write_outputs_haploid(fit, histo_path)
    size = len(fit.error_dist)
    dist, prob = fit.dist_final, fit.prob_final
    n_cols = dist.shape[1]  # = n_j + (1 het) + (1 zero col)
    with open(histo_path + ".7.7.model", "w") as mf, \
         open(histo_path + ".7.7.dist", "w") as df, \
         open(histo_path + ".7.7.prob", "w") as pf:
        for f in (mf, df, pf):
            f.write("3\n%d\n" % fit.kcutoff)
            f.write(_g(fit.histo_sum) + "\n")
            f.write("%d\n" % fit.raw_sc)
        # model first data line: per-copy sums / HistoSum (893-901);
        # LocalSum is a long accumulating doubles -> truncation per addition
        vals = []
        for c in range(fit.model_final.shape[1]):  # copy numbers 1..n_j
            ls = 0
            for kk in range(1, size):
                ls = int(ls + fit.model_final[kk, c])
            vals.append(ls / fit.histo_sum)
        mf.write("\t".join(_g(v) for v in vals) + "\t\n")
        df.write(_g(fit.error_total) + "\t0\t" +
                 "\t".join(_g(v) for v in fit.rc[1:]) + "\t\n")
        mf.write("K\tRawCount\tErrorModel\tContSubtract\tModelSum\t1x\t2x\t3x\t4x\t5x\t6x\t7x\t8x\t9x\n")
        # model table (912-930): row 0 then rows 1..<SC*5, copy cols 1..9
        def model_cell(kk, copy):
            return fit.model_final[kk, copy - 1] if copy - 1 < fit.model_final.shape[1] else 0.0
        mf.write("0\t0\t0\t0\t0")
        for copy in range(1, 10):
            mf.write("\t" + _g(model_cell(0, copy)))
        mf.write("\n")
        kk = 1
        while kk < fit.sc * 5 and kk < size:
            msum = fit.model_sums[kk]
            mf.write("%d\t%d\t%s\t0\t%s" % (kk, fit.raw_histo[kk] if fit.raw_histo is not None else 0,
                                            _g(fit.error_model[kk]), _g(msum)))
            for copy in range(1, 10):
                mf.write("\t" + _g(model_cell(kk, copy)))
            mf.write("\n")
            kk += 1
        df.write(_g(fit.sc) + "\n")
        # dist rows (933-948): row k=0 special then k=1..size-1, cols c=1..n_cols-1
        df.write("0\t0\t0")
        for c in range(1, n_cols):
            df.write("\t" + _g(dist[0, c]))
        df.write("\n")
        for kk in range(1, size):
            df.write("%d\t%s\t0" % (kk, _g(fit.error_dist[kk])))
            for c in range(1, n_cols):
                df.write("\t" + _g(dist[kk, c]))
            df.write("\n")
        for c in range(1, n_cols):
            df.write("\t" + _g(dist[0, c]))
        # prob file (956-964)
        pf.write("\n\n")
        for kk in range(1, size + 1):
            pf.write("%d\t%s\t0" % (kk, _g(fit.error_dist[kk] if kk < size else 0.0)))
            for c in range(1, prob.shape[1]):
                pf.write("\t" + _g(prob[kk, c] if kk < prob.shape[0] else 0.0))
            pf.write("\n")


def _write_outputs_haploid(fit: ModelFit, histo_path: str):
    """ModelDist.haploid.cpp output layout (:882-948).

    .model: 3/kcutoff/HistoSum/rawSC header, per-copy sums line, table
    header, rows 1..<SC*5 (K, raw histo, error model, 0, model sum,
    model[K][1..9]).
    .dist: HistoSum line, `burner 0 RC[1..]` line, SC line, dist rows
    0..size-1 with columns 1..n_j (no het) — and no trailing repeat row.
    .7.7boom.prob: created empty.
    """
    size = len(fit.error_dist)
    dist = fit.dist_final
    n_cols = dist.shape[1]  # = n_j + 1 zero col (no het)
    with open(histo_path + ".7.7.model", "w") as mf, \
         open(histo_path + ".7.7.dist", "w") as df, \
         open(histo_path + ".7.7boom.prob", "w"):
        mf.write("3\n%d\n" % fit.kcutoff)
        mf.write(_g(fit.histo_sum) + "\n")
        mf.write("%d\n" % fit.raw_sc)
        df.write(_g(fit.histo_sum) + "\n")
        # per-copy sums: LocalSum is a long accumulating doubles ->
        # truncation per addition (same quirk as diploid, :887-895)
        vals = []
        for c in range(fit.model_final.shape[1]):
            ls = 0
            for kk in range(1, size):
                ls = int(ls + fit.model_final[kk, c])
            vals.append(ls / fit.histo_sum)
        mf.write("\t".join(_g(v) for v in vals) + "\t\n")
        df.write(_g(fit.error_total) + "\t0\t" +
                 "\t".join(_g(v) for v in fit.rc[1:]) + "\t\n")
        mf.write("K\tRawCount\tErrorModel\tContSubtract\tModelSum\t1x\t2x\t3x\t4x\t5x\t6x\t7x\t8x\t9x\n")

        def model_cell(kk, copy):
            return (fit.model_final[kk, copy - 1]
                    if copy - 1 < fit.model_final.shape[1] else 0.0)

        mf.write("0\t0\t0\t0\t0")
        for copy in range(1, 10):
            mf.write("\t" + _g(model_cell(0, copy)))
        mf.write("\n")
        kk = 1
        # the C++ loop bound is KmerCount < SC*5 alone (:907) — the `< size`
        # guard prevents out-of-bounds reads the C++ would UB on
        while kk < fit.sc * 5 and kk < size:
            mf.write("%d\t%d\t%s\t0\t%s" % (
                kk, fit.raw_histo[kk] if fit.raw_histo is not None else 0,
                _g(fit.error_model[kk]), _g(fit.model_sums[kk])))
            for copy in range(1, 10):
                mf.write("\t" + _g(model_cell(kk, copy)))
            mf.write("\n")
            kk += 1
        df.write(_g(fit.sc) + "\n")
        df.write("0\t0\t0")
        for c in range(1, n_cols):
            df.write("\t" + _g(dist[0, c]))
        df.write("\n")
        for kk in range(1, size):
            df.write("%d\t%s\t0" % (kk, _g(fit.error_dist[kk])))
            for c in range(1, n_cols):
                df.write("\t" + _g(dist[kk, c]))
            df.write("\n")


def write_histo(path: str, histo_counts: np.ndarray):
    """Write a jellyfish-histo-equivalent file: rows 0..10001 tab-separated,
    counts above the ceiling accumulated in the last row (histo_main.cc:34-42,
    nb_buckets = high + 2 with default low=1/high=10000/inc=1).
    `histo_counts` is indexable by depth (bincount output)."""
    nb = 10002
    out = np.zeros(nb, dtype=np.int64)
    n = len(histo_counts)
    upto = min(n, nb)
    out[:upto] = histo_counts[:upto]
    if n > nb:
        out[nb - 1] += histo_counts[nb:].sum()
    with open(path, "w") as f:
        for i in range(nb):
            f.write(f"{i}\t{out[i]}\n")


def prob_not_error(dist_path: str, max_rows: int = 13):
    """P(not error) per depth from a `.dist` file — one value per line.

    GenerateProbNotError companion tool (scripts/GenerateProbNotError.cpp:
    175-194, used only by the Genotype.sh regenotyping path): skip the 6
    header lines of the .dist table, then for each of the first `max_rows`
    data rows compute sum(copy-number columns 3..) / (that sum + the error
    column 1).  Returns the list of floats; `prob_not_error_text` renders
    them with C++ cout formatting for byte parity.
    """
    vals = []
    with open(dist_path) as f:
        lines = f.read().split("\n")
    for line in lines[6:6 + max_rows]:
        if not line:
            break
        cols = line.split("\t")
        num = sum(float(c) for c in cols[3:] if c != "")
        vals.append(num / (num + float(cols[1])))
    return vals


def prob_not_error_text(dist_path: str, max_rows: int = 13) -> str:
    return "".join(_g(v) + "\n" for v in prob_not_error(dist_path, max_rows))
