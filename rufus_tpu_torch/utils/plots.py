"""Model-fit plot — matplotlib port of scripts/RufusCreateModelPlot.R.

Reads a `.7.7.model` file (4 header scalar lines + first-data line +
column header + table, written by models/modeldist.write_outputs) and
renders RawCount vs ModelSum vs ErrorModel vs per-copy-number curves on a
log-y axis with the cutoff / haploid / diploid verticals, exactly the
quantities the R script plots (RufusCreateModelPlot.R:10-41).

A copy of the JAX package's utils/plots.py. matplotlib is imported inside
``plot_model`` only, so the module imports where matplotlib is absent.
"""

from __future__ import annotations

import numpy as np


def read_model_table(model_path: str):
    """Parse the .model file -> (meta dict, column dict of np arrays)."""
    with open(model_path) as f:
        lines = f.read().splitlines()
    meta = {
        "min": float(lines[0]),
        "cutoff": float(lines[1]),
        "genomesize": float(lines[2]),
        "diploid": float(lines[3]),
    }
    # lines[4] = per-copy sums; lines[5] = column header; data after
    header = lines[5].split("\t")
    rows = [l.split("\t") for l in lines[6:] if l.strip()]
    cols = {}
    for j, name in enumerate(header):
        vals = []
        for r in rows:
            try:
                vals.append(float(r[j]) if j < len(r) else 0.0)
            except ValueError:
                vals.append(0.0)
        cols[name] = np.array(vals)
    return meta, cols


def plot_model(model_path: str, out_path: str | None = None):
    """Render the model plot; returns the output path (pdf like the R
    script unless out_path overrides)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    meta, cols = read_model_table(model_path)
    out_path = out_path or (model_path + ".pdf")
    k = cols["K"]
    fig, ax = plt.subplots(figsize=(6, 2))
    alpha = 0.8

    def line(name, color, lw=1.0):
        if name in cols:
            y = np.where(cols[name] > 0, cols[name], np.nan)
            ax.plot(k, y, color=color, alpha=alpha, linewidth=lw)

    line("RawCount", "black", 1.5)
    line("ModelSum", "red", 1.5)
    line("ErrorModel", "gold")
    line("1x", "green")
    for name, c in (("2x", "#00008B"), ("3x", "#0000CD"),
                    ("4x", "#0000FF"), ("5x", "#4169E1")):
        line(name, c)
    ax.set_yscale("log")
    if "RawCount" in cols and np.any(cols["RawCount"] > 0):
        ax.set_ylim(1, float(np.max(cols["RawCount"])))
    ax.set_xlim(2, float(np.max(k)) if len(k) else 10)
    ax.axvline(meta["cutoff"], color="red", alpha=0.5)
    ax.axvline(meta["diploid"] / 2, color="green", alpha=0.5)
    ax.axvline(meta["diploid"], color="blue", alpha=0.5)
    ax.set_xlabel("Kmer depth")
    ax.set_ylabel("Frequency")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
