"""The child's depth model on the WGS route, written from the numbers a
traffic file states, so that no job fits one and the check rests on no
output of the program.

RUFUS's ModelDist writes three files beside the child's k-mer histogram;
the pipeline reads two of them. ``<histo>.7.7.model``'s header gives the
lower cutoff (line 2) and the raw k-mer peak (line 4), from which the
HashList's count range is [cutoff, 5 x raw peak]. ``<histo>.7.7.dist`` is
the genotyper's table: a 6-line header, then one row a depth 0..size-1
(the depth, the error model's share, 0, then one column a copy number),
then a tab-led copy of row 0's columns.

This module builds that table as ModelDist builds its final one
(ModelDist.cpp:733-966, whose format ``models/modeldist.py:455-500``
reproduces) from the stated fit: for a diploid histogram of `size` rows
with peak `sc`, column 1 is the heterozygous normal at sc/2 and column
1 + j the normal at sc x j with sd ``stdev + (j - 1) x factor``, for
j = 1 .. ceil(size / sc - 1); columns 1 .. n_j are normalised to sum 1
(ModelDist skips the last); the error column is ``first / i^exponent``
over its sum. The normal is ModelDist's, with its pi of 3.14159.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil

import numpy as np

PI = 3.14159  # ModelDist.cpp:28


def _normal(x, mu, sd):
    return (1.0 / np.sqrt(2 * PI * sd ** 2)) * np.exp(-((x - mu) ** 2)
                                                      / (2 * sd ** 2))


def tables(m: dict):
    """(error model (size,), copy columns (size, n_j + 2)) of the stated
    model `m` (a traffic file's ``model`` block). The .dist's error column
    is the error model over its sum, the error total."""
    size, sc = m["size"], m["peak"]
    stdev, factor = m["stdev"], m["factor"]
    n_j = math.ceil(size / sc - 1)
    x = np.arange(size, dtype=np.float64)[:, None]
    j = np.arange(1, n_j + 1, dtype=np.float64)[None, :]
    het_sd = stdev * (1 - (1 - stdev / (stdev + factor)) / 2)
    dist = np.concatenate([np.zeros((size, 1)), _normal(x, sc / 2, het_sd),
                           _normal(x, sc * j, stdev + (j - 1) * factor)],
                          axis=1)
    for c in range(1, n_j + 1):
        dist[:, c] = dist[:, c] / dist[:, c].sum()
    err = np.zeros(size)
    err[1:] = (1.0 / np.power(np.arange(1, size, dtype=np.float64),
                              m["error_exponent"])) * m["error_first"]
    return err, dist


def _g(x: float) -> str:
    """C++ ``ostream <<`` of a double: 6 significant digits."""
    return f"{x:.6g}"


def write(m: dict, histo_path: str):
    """``<histo_path>.7.7.model`` (its header: what the pipeline reads) and
    ``<histo_path>.7.7.dist`` of the stated model `m`. The .dist's fifth
    line is the error total, 0 and the stated copy-number weights, padded
    with zeros to one a column (no reader of the file uses them)."""
    err, dist = tables(m)
    weights = list(m["weights"]) + [0] * (dist.shape[1] - 1
                                         - len(m["weights"]))
    head = f"3\n{m['cutoff']}\n{_g(m['histo_sum'])}\n{m['raw_peak']}\n"
    with open(histo_path + ".7.7.model", "w") as f:
        f.write(head)
    total = float(err[1:].sum())
    rows = np.concatenate([np.arange(m["size"])[:, None],
                           err[:, None] / total, dist], axis=1)
    with open(histo_path + ".7.7.dist", "w") as f:
        f.write(head + f"{_g(total)}\t0\t"
                + "".join(_g(w) + "\t" for w in weights)
                + f"\n{_g(m['peak'])}\n")
        np.savetxt(f, rows, fmt=["%d"] + ["%.6g"] * (rows.shape[1] - 1),
                   delimiter="\t")
        f.write("".join("\t" + _g(v) for v in dist[0, 1:]))
    return histo_path + ".7.7.model", histo_path + ".7.7.dist"


def cached(m: dict, root: str, name: str):
    """The model files of `m` for a child histogram named `name`, under
    `root`: written at the first use of these numbers and read again
    after, in a directory named by a digest of them."""
    digest = hashlib.sha256(json.dumps(m, sort_keys=True).encode())
    d = os.path.join(root, digest.hexdigest()[:16])
    paths = tuple(os.path.join(d, name + ext)
                  for ext in (".7.7.model", ".7.7.dist"))
    if not all(map(os.path.exists, paths)):
        part = os.path.join(d, "partial")
        shutil.rmtree(part, ignore_errors=True)
        os.makedirs(part)
        for src, dst in zip(write(m, os.path.join(part, name)), paths):
            os.replace(src, dst)
    return paths


def place(paths, histo_path: str):
    """Hard-links the written model files beside `histo_path`, a job's
    child histogram, before the job starts."""
    for src in paths:
        os.link(src, histo_path + src[src.index(".7.7."):])
