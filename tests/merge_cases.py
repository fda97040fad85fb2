"""Runs for the tests of merge_runs (ops/cuda_merge.py), on the CPU and on
the card: pairs of sorted unique int64 key runs with int64 counts, and the
numpy union-and-sum they are held to. Imports neither JAX nor torch."""

import numpy as np

TILE, ITEMS = 4096, 16  # csrc/merge.cu's tile and a thread's positions

CASES = ["disjoint", "interleaved", "identical", "a_empty", "b_empty",
         "both_empty", "straddle_4095", "straddle_4096", "straddle_4097",
         "straddle_tiles", "counts_near_2_31"]


def _straddle(rng, total):
    """Runs whose merged sequence (both copies of a shared key counted) has
    `total` positions and a shared key's two copies at d - 1 and d for
    every d that is a multiple of ITEMS below `total`: every cut of a
    thread's positions, and so of a tile, falls inside a shared key."""
    a, b = [], []
    key, p = 0, 0
    while p < total:
        key += int(rng.integers(1, 1000))
        boundary = (p + 1) % ITEMS == 0
        pair = p + 2 <= total and (boundary or (
            (p + 2) % ITEMS != 0 and rng.random() < 0.2))
        if pair:
            a.append(key)
            b.append(key)
            p += 2
        else:
            (a if rng.random() < 0.5 else b).append(key)
            p += 1
    return np.array(a, np.int64), np.array(b, np.int64)


def _split(rng, n, share_a, share_b):
    """n sorted unique keys, each in a alone, b alone or both."""
    pool = np.unique(rng.integers(0, 1 << 50, int(n * 1.1)))[:n]
    side = rng.random(len(pool))
    in_a = side < share_a + (1 - share_a - share_b)
    in_b = side >= share_a
    return pool[in_a], pool[in_b]


def runs(case: str, rng=None, n: int = 6000):
    """(a_keys, a_counts, b_keys, b_counts) of a named case, int64."""
    rng = rng or np.random.default_rng(sum(map(ord, case)))
    if case == "disjoint":
        a = np.arange(n, dtype=np.int64) * 3
        b = (1 << 40) + np.arange(n // 2, dtype=np.int64) * 5
    elif case == "interleaved":
        a, b = _split(rng, n, 0.4, 0.4)
    elif case == "identical":
        a = np.unique(rng.integers(0, 1 << 62, n))
        b = a.copy()
    elif case in ("a_empty", "b_empty", "both_empty"):
        full = np.unique(rng.integers(0, 1 << 40, n))
        empty = np.empty(0, np.int64)
        a, b = {"a_empty": (empty, full), "b_empty": (full, empty),
                "both_empty": (empty, empty)}[case]
    elif case.startswith("straddle_"):
        size = case.split("_")[1]
        total = 3 * TILE + 37 if size == "tiles" else int(size)
        a, b = _straddle(rng, total)
    elif case == "counts_near_2_31":
        a, b = _split(rng, n, 0.2, 0.2)
    else:
        raise KeyError(case)
    if case == "counts_near_2_31":
        ca = (1 << 31) - rng.integers(1, 100, len(a))
        cb = (1 << 31) - rng.integers(1, 100, len(b))
    else:
        ca = rng.integers(1, 1000, len(a))
        cb = rng.integers(1, 1000, len(b))
    return (a.astype(np.int64), ca.astype(np.int64), b.astype(np.int64),
            cb.astype(np.int64))


def union_sum(a, ca, b, cb):
    """The union of the keys, sorted, each with its counts summed."""
    keys, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, np.concatenate([ca, cb]))
    return keys.astype(np.int64), sums
