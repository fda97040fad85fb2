"""Read and contig alignment: the port's modules against the JAX package's
on the same numpy-seeded inputs. Tolerance: none (integer DP, exact
alignments, byte-equal files).

- ``sw_batch``: the plain PyTorch version against JAX ``sw_device.sw_batch``
  and the host ``sw_kernel``, for both scorings (mirrors
  tests/test_sw_device.py); the plain traceback against JAX
  ``aligner._traceback``; the plain ragged call against per-shape calls
  and JAX; and a numpy model of the CUDA kernel's warp geometry, scan,
  tiles and walk against the plain versions (the kernel itself runs only
  on the card: tests/test_torch_gpu.py);
- ``Aligner.align_seqs`` / ``align_seq`` field by field, reads and chimeric
  contigs, and the flat index against the in-memory one (mirrors
  tests/test_aligner_batched.py and tests/test_aligner_oracle.py's cases);
- ``align_pairs``, ``mark_duplicates``, ``write_sam`` and ``write_bam``.
"""

import numpy as np
import pytest
import torch

from rufus_tpu.align import aligner as jal
from rufus_tpu.align import sam as jsam
from rufus_tpu.align import sw_device as jsw
from rufus_tpu_torch.align import aligner as pal
from rufus_tpu_torch.align import sam as psam
from rufus_tpu_torch.align import sw_device as psw
from rufus_tpu_torch.ops import cuda_sw

BASES = np.frombuffer(b"ACGT", np.uint8)
SCORINGS = {"default": (pal.DEFAULT_SCORING, jal.DEFAULT_SCORING),
            "mob": (pal.MOB_SCORING, jal.MOB_SCORING)}


def _dp(q, r, sc=pal.DEFAULT_SCORING):
    """The plain DP on numpy codes: (H, score, bi, bj) as numpy arrays."""
    return tuple(t.numpy() for t in cuda_sw.sw_batch(
        torch.from_numpy(q), torch.from_numpy(r), sc.match, sc.mismatch,
        sc.gap_open, sc.gap_ext))


def _codes(rng, n, n_frac=0.02):
    s = rng.choice(BASES, size=n)
    s = np.where(rng.random(n) < n_frac, ord("N"), s).astype(np.uint8)
    return pal.encode(s)


def _batch(rng, B, n, m, n_frac=0.02):
    """Random (query, window) code pairs: every third window holds a copy
    of its query with an SNV, some queries end in 255 padding."""
    qs, rs = [], []
    for b in range(B):
        q = _codes(rng, n, n_frac)
        r = _codes(rng, m, n_frac)
        if b % 3 == 0 and m > n:
            at = int(rng.integers(0, m - n))
            r[at : at + n] = q
            r[at + n // 2] = (r[at + n // 2] + 1) % 4
        if b % 4 == 1:
            q[n - int(rng.integers(1, max(2, n // 3))):] = 255
        qs.append(q)
        rs.append(r)
    return np.stack(qs), np.stack(rs)


@pytest.mark.parametrize("scoring", ["default", "mob"])
@pytest.mark.parametrize("B,n,m", [(9, 61, 120), (5, 32, 32), (4, 96, 40)])
def test_sw_batch_matches_jax(scoring, B, n, m):
    ps, js = SCORINGS[scoring]
    rng = np.random.default_rng(20260821 + n)
    q, r = _batch(rng, B, n, m)
    got = _dp(q, r, ps)
    want = jsw.sw_batch(q, r, js)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    for b in range(B):  # and the host DP, cell for cell
        (score, bi, bj), H = pal.sw_kernel(q[b], r[b], ps)
        assert (got[1][b], got[2][b], got[3][b]) == (score, bi, bj)
        np.testing.assert_array_equal(got[0][b], H)


def test_sw_batch_padded_query_equals_short_query():
    rng = np.random.default_rng(5)
    q = _codes(rng, 40, 0)
    r = _codes(rng, 100, 0)
    qp = np.concatenate([q, np.full(21, 255, np.uint8)])
    H1, s1, bi1, bj1 = _dp(q[None], r[None])
    H2, s2, bi2, bj2 = _dp(qp[None], r[None])
    assert (s1[0], bi1[0], bj1[0]) == (s2[0], bi2[0], bj2[0])
    np.testing.assert_array_equal(H1[0], H2[0][:41])


def test_sw_batch_zero_and_ties():
    """An all-N pair gives an all-zero H and (0, 0, 0); a query found twice
    in its window reports the first (row-major) best cell."""
    rng = np.random.default_rng(9)
    q = _codes(rng, 30, 0)
    r = np.concatenate([_codes(rng, 10, 0), q, _codes(rng, 7, 0), q,
                        _codes(rng, 5, 0)])
    qb = np.stack([np.full(30, 255, np.uint8), q])
    rb = np.stack([np.full(len(r), 255, np.uint8), r])
    for sc in SCORINGS:
        H, s, bi, bj = _dp(qb, rb, SCORINGS[sc][0])
        assert not H[0].any() and (s[0], bi[0], bj[0]) == (0, 0, 0)
        assert (s[1], bi[1], bj[1]) == (30, 30, 40)
        want = jsw.sw_batch(qb, rb, SCORINGS[sc][1])
        for g, w in zip((H, s, bi, bj), want):
            np.testing.assert_array_equal(g, w)


MINUS_INF = -(2 ** 31) // 2
LANES = np.arange(32)


def _shfl_up(v, d):
    """__shfl_up_sync: lane l reads lane l-d; lanes below d keep their own."""
    return np.concatenate([v[:d], v[:-d]])


def _warp_dp(q, r, C, match, mismatch, gap_open, gap_ext):
    """One warp's DP in csrc/sw_batch.cu: lane chunks of C columns, tiles
    of 32*C with the scan prefix and lane 0's diagonal carried, the
    previous row and F kept per column (shared memory or the workspace)
    when there is more than one tile, the 5-step shuffle scan, each lane's
    first best and the xor-butterfly reduction. Returns H (n+1, S) with
    its padding columns, and (score, bi, bj)."""
    n, m = len(q), len(r)
    M = m + 1
    S = (M + 3) // 4 * 4
    W = 32 * C
    tiles = -(-M // W)
    multi = tiles > 1
    oe = gap_open + gap_ext
    # window codes a column, 256 for N, column 0 and the padding; a query
    # N is 257: neither matches anything
    rpad = np.concatenate([[255], r, np.full(tiles * W, 255)]).astype(np.int64)
    rpad[rpad == 255] = 256
    H = np.zeros((n + 1, S), np.int64)
    st = np.zeros(S, np.int64), np.full(S, cuda_sw.NEG, np.int64)
    cols = LANES[:, None] * C + np.arange(C)[None]
    prev = np.zeros((32, C), np.int64)
    Fr = np.full((32, C), cuda_sw.NEG, np.int64)
    rc = rpad[cols]
    bs, bi, bj = (np.zeros(32, np.int64) for _ in range(3))
    for i in range(1, n + 1):
        qi = 257 if q[i - 1] == 255 else int(q[i - 1])
        carry, dcarry = MINUS_INF, 0
        for t in range(tiles):
            j = t * W + cols
            inside = j < S
            if multi:
                prev = np.where(inside, st[0][np.minimum(j, S - 1)], 0)
                Fr = np.where(inside, st[1][np.minimum(j, S - 1)],
                              cuda_sw.NEG)
                rc = rpad[j]
            dg = _shfl_up(prev[:, C - 1], 1)
            dg[0] = dcarry
            dcarry = prev[31, C - 1]
            d = np.concatenate([dg[:, None], prev[:, :-1]], 1)
            f = np.maximum(Fr - gap_ext, prev - oe)
            Fr = f
            sub = np.where(qi == rc, match, mismatch)
            cand = np.maximum(np.maximum(d + sub, f), 0)
            cand[:, 0] = np.where(j[:, 0] == 0, 0, cand[:, 0])  # column 0
            incl = (cand + gap_ext * j).max(1)
            for dd in (1, 2, 4, 8, 16):
                incl = np.where(LANES >= dd,
                                np.maximum(incl, _shfl_up(incl, dd)), incl)
            e = np.where(LANES == 0, carry,
                         np.maximum(_shfl_up(incl, 1), carry))
            carry = max(carry, int(incl[31]))
            # each column's max of cand[t] + ext*t over the lane's earlier
            # columns, then the gap term with no chain through the columns
            s = cand + gap_ext * j
            pre = np.concatenate([np.full((32, 1), MINUS_INF),
                                  np.maximum.accumulate(s, 1)[:, :-1]], 1)
            cur = np.maximum(cand, np.maximum(e[:, None], pre)
                             - (oe - gap_ext) - gap_ext * j)
            # each lane's first maximum; padding columns are not excluded
            rmax = cur.max(1)
            up = rmax > bs
            first = j[LANES, np.argmax(cur == rmax[:, None], 1)]
            bs, bi, bj = (np.where(up, a, b)
                          for a, b in ((rmax, bs), (i, bi), (first, bj)))
            H[i, j[inside]] = cur[inside]
            if multi:
                st[0][j[inside]] = cur[inside]
                st[1][j[inside]] = Fr[inside]
            else:
                prev = cur
    for dd in (16, 8, 4, 2, 1):
        o = LANES ^ dd
        os, oi, oj = bs[o], bi[o], bj[o]
        take = (os > bs) | ((os == bs)
                            & ((oi < bi) | ((oi == bi) & (oj < bj))))
        bs, bi, bj = (np.where(take, a, b)
                      for a, b in ((os, bs), (oi, bi), (oj, bj)))
    assert (bs == bs[0]).all() and (bi == bi[0]).all()
    return H, (int(bs[0]), int(bi[0]), int(bj[0]))


def _warp_walk(q, r, H, bi, bj, match, mismatch, gap_open, gap_ext,
               gap_max):
    """The kernel's traceback: rounds of 32 diagonal steps (lane l tests the
    cell l steps down; the run ends at the first lane that fails), then the
    gap searches 32 lengths a round, the lowest hit lane. Returns (qi, rj,
    nm, ops in walk order)."""
    def sub(a, b):
        return match if (a == b and a != 255 and b != 255) else mismatch

    i, j, nm, ops = bi, bj, 0, []
    while True:
        ok = np.zeros(32, bool)
        mm = np.zeros(32, bool)
        for l in LANES:
            ii, jj = i - l, j - l
            if ii > 0 and jj > 0 and H[ii, jj] > 0:
                s = sub(q[ii - 1], r[jj - 1])
                ok[l] = H[ii, jj] == H[ii - 1, jj - 1] + s
                mm[l] = s == mismatch
        steps = 32 if ok.all() else int(np.argmin(ok))
        ops += [cuda_sw.OP_M] * steps
        nm += int(mm[:steps].sum())
        i, j = i - steps, j - steps
        if steps == 32:
            continue
        if i <= 0 or j <= 0 or H[i, j] <= 0:
            break
        h = H[i, j]
        g = 0
        for op, lim, cell in ((cuda_sw.OP_D, min(j, gap_max),
                               lambda gg: H[i, j - gg]),
                              (cuda_sw.OP_I, min(i, gap_max),
                               lambda gg: H[i - gg, j])):
            for g0 in range(1, lim + 1, 32):
                gg = g0 + LANES
                hit = (gg <= lim) & (h == cell(np.minimum(gg, lim))
                                     - gap_open - gap_ext * gg)
                if hit.any():
                    g = g0 + int(np.argmax(hit))
                    break
            if g:
                break
        if not g:
            break
        ops += [op] * g
        nm += g
        if op == cuda_sw.OP_D:
            j -= g
        else:
            i -= g
    return i, j, nm, ops


def kernel_model(pairs, match, mismatch, gap_open, gap_ext, gap_max,
                 chunk=None):
    """numpy model of one launch of csrc/sw_batch.cu over ragged pairs:
    the launch's chunk (cuda_sw.launch_chunk of the widest window unless
    given), each pair's warp DP and walk. Returns sw_ragged's output
    buffer and each pair's H (true region)."""
    C = chunk or cuda_sw.launch_chunk(max(len(r) for _, r in pairs))
    B = len(pairs)
    n = np.array([len(q) for q, _ in pairs])
    m = np.array([len(r) for _, r in pairs])
    out = np.zeros(28 * B + int((n + m).sum()), np.uint8)
    res, ops_out = cuda_sw.unpack(out, B)
    Hs = []
    for p, ((q, r), o) in enumerate(zip(pairs, cuda_sw.ops_offsets(n, m))):
        H, (score, bi, bj) = _warp_dp(q, r, C, match, mismatch, gap_open,
                                      gap_ext)
        qi, rj, nm, ops = _warp_walk(q, r, H, bi, bj, match, mismatch,
                                     gap_open, gap_ext, gap_max)
        res[p] = score, bi, bj, qi, rj, nm, len(ops)
        ops_out[o : o + len(ops)] = ops
        Hs.append(H[:, : len(r) + 1])
    return out, Hs


def _pairs(rng, shapes, n_frac=0.02):
    """(query, window) code pairs of the given (n, m): each window holds
    its query with an SNV and, in every other pair, a 9-base deletion."""
    out = []
    for p, (n, m) in enumerate(shapes):
        q, r = _codes(rng, n, n_frac), _codes(rng, m, n_frac)
        if m > n + 12 and n > 20:
            at = int(rng.integers(0, m - n - 10))
            body = q if p % 2 else np.concatenate(
                [q[: n // 2], _codes(rng, 9, 0), q[n // 2:]])
            r[at : at + len(body)] = body
            r[at + n // 3] = (int(r[at + n // 3]) + 1) % 4
        out.append((q, r))
    return out


def _plain_ragged(pairs, sc, gap_max=None):
    n = np.array([len(q) for q, _ in pairs])
    m = np.array([len(r) for _, r in pairs])
    codes = np.concatenate([q for q, _ in pairs] + [r for _, r in pairs])
    out = cuda_sw.sw_ragged(
        torch.from_numpy(codes), cuda_sw.offsets(n), n,
        int(n.sum()) + cuda_sw.offsets(m), m, sc.match, sc.mismatch,
        sc.gap_open, sc.gap_ext,
        max(128, 2 * sc.pad) if gap_max is None else gap_max)
    return out.numpy()


_MODEL_CASES = {
    "one_tile": ([(7, 40), (12, 33), (0, 9)], None),   # C = 4
    "chunk12": ([(30, 300), (25, 290)], None),          # C = 12, one tile
    "tiles": ([(9, 300), (14, 131)], 4),                # 3 and 2 tiles
    "ragged": ([(5, 1100), (40, 100), (1, 1), (22, 530)], None),
}


@pytest.mark.parametrize("scoring", ["default", "mob"])
@pytest.mark.parametrize("case", list(_MODEL_CASES))
def test_kernel_model_matches_plain(scoring, case):
    """The kernel's arithmetic: lane chunks, the shuffle scan, tiles and
    their carries (forced by a small chunk in "tiles", and by m + 1 > 512
    in "ragged"), the reduction and the warp's walk, against the plain
    ragged version and the plain DP's H."""
    sc = SCORINGS[scoring][0]
    shapes, chunk = _MODEL_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + len(shapes))
    pairs = _pairs(rng, shapes)
    if len(pairs) > 1:
        pairs[1] = (np.full(len(pairs[1][0]), 255, np.uint8), pairs[1][1])
    args = (sc.match, sc.mismatch, sc.gap_open, sc.gap_ext)
    got, Hs = kernel_model(pairs, *args, max(128, 2 * sc.pad), chunk)
    np.testing.assert_array_equal(got, _plain_ragged(pairs, sc))
    for (q, r), H in zip(pairs, Hs):
        want = cuda_sw.sw_batch_torch(torch.from_numpy(q[None]),
                                      torch.from_numpy(r[None]), *args)[0]
        np.testing.assert_array_equal(H, want[0].numpy())


def _jax_walk(q, r, sc, js):
    """JAX sw_batch's H and best cell, and JAX _traceback's walk."""
    H, s, bi, bj = jsw.sw_batch(q[None], r[None], js)
    qi, rj, ops, nm = jal._traceback(q, r, H[0], int(bi[0]), int(bj[0]), js)
    return H[0], (int(s[0]), int(bi[0]), int(bj[0])), (qi, rj, nm, ops)


def _walk_ties(q, r, H, walk_from, sc):
    """Cells of the host walk where the diagonal was taken and a gap rule
    held too; and whether the walk stopped on a positive cell."""
    i, j = walk_from
    ties = 0
    gap_max = max(128, 2 * sc.pad)
    while i > 0 and j > 0 and H[i][j] > 0:
        h = H[i][j]
        s = sc.match if (q[i - 1] == r[j - 1] and q[i - 1] != 255
                         and r[j - 1] != 255) else sc.mismatch
        gap = any(h == H[i][j - g] - sc.gap_open - sc.gap_ext * g
                  for g in range(1, min(j, gap_max) + 1)) or any(
            h == H[i - g][j] - sc.gap_open - sc.gap_ext * g
            for g in range(1, min(i, gap_max) + 1))
        if h == H[i - 1][j - 1] + s:
            ties += gap
            i, j = i - 1, j - 1
            continue
        for g in range(1, min(j, gap_max) + 1):
            if h == H[i][j - g] - sc.gap_open - sc.gap_ext * g:
                i, j = i, j - g
                break
        else:
            for g in range(1, min(i, gap_max) + 1):
                if h == H[i - g][j] - sc.gap_open - sc.gap_ext * g:
                    i, j = i - g, j
                    break
            else:
                return ties, True
    return ties, False


def _gapped(rng, sc, g, vertical, flank):
    """A query and window around a gap of g bases, flanks long enough that
    the gap pays: a deletion from the window (D) or an insertion (I)."""
    a, b, x = (_codes(rng, k, 0) for k in (flank, flank, g))
    pad = _codes(rng, 20, 0)
    if vertical:
        return np.concatenate([a, x, b]), np.concatenate([pad, a, b, pad])
    return np.concatenate([a, b]), np.concatenate([pad, a, x, b, pad])


def _traceback_cases(case, scoring, rng):
    sc = SCORINGS[scoring][0]
    gmax = max(128, 2 * sc.pad)
    flank = 160 if scoring == "default" else 40
    if case in ("gap_inside", "gap_past"):
        g = gmax + (case == "gap_past")
        return [_gapped(rng, sc, g, False, flank),
                _gapped(rng, sc, g if scoring == "default" else 64, True,
                        flank)]
    if case == "all_zero":
        return [(np.full(30, 255, np.uint8), _codes(rng, 80)),
                (_codes(rng, 20), np.full(50, 255, np.uint8))]
    if case == "n_codes":
        return _pairs(rng, [(60, 190), (80, 200)], n_frac=0.15)
    if case == "padded":
        qs = _pairs(rng, [(70, 200), (50, 180)], n_frac=0)
        return [(np.concatenate([q, np.full(13, 255, np.uint8)]), r)
                for q, r in qs]
    # "tie": homopolymer runs around indels, where a diagonal step and a
    # gap often score alike
    out = []
    for n_a in (9, 14):
        a = np.concatenate([_codes(rng, 40, 0), np.zeros(n_a, np.uint8),
                            _codes(rng, 40, 0)])
        w = np.concatenate([_codes(rng, 10, 0), a[:40],
                            np.zeros(n_a + 3, np.uint8), a[40 + n_a:],
                            _codes(rng, 10, 0)])
        out.append((a, w))
        out.append((w[5:-5], a))
    return out


@pytest.mark.parametrize("scoring", ["default", "mob"])
@pytest.mark.parametrize("case", ["gap_inside", "gap_past", "all_zero",
                                  "n_codes", "padded", "tie"])
def test_plain_traceback_matches_jax(scoring, case):
    """traceback_torch on JAX _sw_batch's H against JAX _traceback: gaps of
    exactly gap_max (128; 1,000 for MOB) and one past it, where the walk
    stops; all-zero H; N codes; padded queries; diagonal-gap ties."""
    ps, js = SCORINGS[scoring]
    gmax = max(128, 2 * ps.pad)
    rng = np.random.default_rng(
        [len(scoring), ["gap_inside", "gap_past", "all_zero", "n_codes",
                        "padded", "tie"].index(case)])
    pairs = _traceback_cases(case, scoring, rng)
    stops, ties, longest = 0, 0, 0
    for q, r in pairs:
        H, best, (qi, rj, nm, ops) = _jax_walk(q, r, ps, js)
        t = torch.from_numpy
        got = cuda_sw.traceback_torch(
            t(q[None]), t(r[None]), t(np.array(H[None])),
            t(np.array([best[1]])), t(np.array([best[2]])), ps.match,
            ps.mismatch, ps.gap_open, ps.gap_ext, gmax)
        k = int(got[3][0])
        walk = "".join("MDI"[c] for c in got[4][0, :k].tolist())[::-1]
        assert (int(got[0][0]), int(got[1][0]), int(got[2][0]), walk) == \
            (qi, rj, nm, "".join(ops))
        n_t, stopped = _walk_ties(q, r, H, best[1:], ps)
        ties += n_t
        stops += stopped
        runs = [len(x) for x in "".join(ops).replace("M", " ").split()]
        longest = max([longest] + runs)
        if case == "all_zero":
            assert best == (0, 0, 0) and k == 0
    if case == "gap_inside":
        assert longest == gmax  # a gap of exactly gap_max is found
    if case == "gap_past":
        assert stops >= 1 and longest < gmax + 1
    if case == "tie":
        assert ties > 0


@pytest.mark.parametrize("scoring", ["default", "mob"])
def test_traceback_takes_the_smallest_gap(scoring):
    """On small random H, where several gap lengths often satisfy a rule at
    once (a DP's H seldom does), the plain traceback and the model of the
    kernel's walk both take JAX _traceback's smallest g, from every cell."""
    ps, js = SCORINGS[scoring]
    gmax = max(128, 2 * ps.pad)
    rng = np.random.default_rng(len(scoring))
    B, n, m = 48, 30, 45
    # a slope of -ext a column with random dips of gap_open: from a dip,
    # every undipped cell to its left satisfies the horizontal rule
    i_, j_ = np.mgrid[: n + 1, : m + 1]
    H = (40 + i_ - ps.gap_ext * j_)[None] \
        - ps.gap_open * (rng.random((B, n + 1, m + 1)) < 0.3) \
        + (rng.random((B, n + 1, m + 1)) < 0.1) * rng.integers(-3, 4, (
            B, n + 1, m + 1))
    H = np.clip(H, 0, None).astype(np.int32)
    H[:, 0], H[:, :, 0] = 0, 0
    q, r = _codes(rng, B * n).reshape(B, n), _codes(rng, B * m).reshape(B, m)
    bi, bj = rng.integers(1, n + 1, B), rng.integers(1, m + 1, B)
    args = (ps.match, ps.mismatch, ps.gap_open, ps.gap_ext)
    t = torch.from_numpy
    got = cuda_sw.traceback_torch(t(q), t(r), t(H), t(bi), t(bj), *args, gmax)
    multi = 0
    for b in range(B):
        qi, rj, ops, nm = jal._traceback(q[b], r[b], H[b], int(bi[b]),
                                         int(bj[b]), js)
        k = int(got[3][b])
        walk = "".join("MDI"[c] for c in got[4][b, :k].tolist())[::-1]
        assert (int(got[0][b]), int(got[1][b]), int(got[2][b]), walk) == \
            (qi, rj, nm, "".join(ops))
        mi, mj, mnm, mops = _warp_walk(q[b], r[b], H[b], int(bi[b]),
                                       int(bj[b]), *args, gmax)
        assert (mi, mj, mnm, "".join("MDI"[c] for c in mops)[::-1]) == \
            (qi, rj, nm, "".join(ops))
        i, j = int(bi[b]), int(bj[b])
        for op in "".join(ops)[::-1]:  # the cells the walk searched from
            h = H[b, i, j]
            if op == "D":
                multi += sum(h == H[b, i, j - g] - ps.gap_open
                             - ps.gap_ext * g for g in range(1, j + 1)) > 1
            i, j = i - (op != "D"), j - (op != "I")
    assert multi > 0


def test_ragged_plain_matches_per_shape_and_jax():
    """sw_ragged's plain version over mixed shapes (several 32-rounded
    buckets, pairs of one shape apart in the batch) against per-shape
    sw_batch_torch + traceback_torch calls, and sw_device.sw_align against
    JAX sw_batch + _traceback pair by pair, for both scorings."""
    rng = np.random.default_rng(42)
    shapes = [(150, 278), (33, 70), (150, 278), (1, 5), (97, 400),
              (150, 271), (64, 64), (0, 12), (12, 1)]
    pairs = _pairs(rng, shapes)
    for name, (ps, js) in SCORINGS.items():
        gmax = max(128, 2 * ps.pad)
        args = (ps.match, ps.mismatch, ps.gap_open, ps.gap_ext)
        out = _plain_ragged(pairs, ps)
        res, ops = cuda_sw.unpack(out, len(pairs))
        offs = cuda_sw.ops_offsets(*zip(*shapes))
        for shape in set(shapes):
            idx = [p for p, s in enumerate(shapes) if s == shape]
            q = torch.from_numpy(np.stack([pairs[p][0] for p in idx]))
            r = torch.from_numpy(np.stack([pairs[p][1] for p in idx]))
            H, s, bi, bj = cuda_sw.sw_batch_torch(q, r, *args)
            qi, rj, nm, k, o = cuda_sw.traceback_torch(q, r, H, bi, bj,
                                                       *args, gmax)
            want = torch.stack([s, bi, bj, qi, rj, nm, k], 1).numpy()
            np.testing.assert_array_equal(res[idx], want)
            for row, p in enumerate(idx):
                np.testing.assert_array_equal(
                    ops[offs[p] : offs[p] + k[row]], o[row, : k[row]].numpy())
        got = psw.sw_align(pairs, ps, device="cpu")
        for (q, r), g in zip(pairs, got):
            if len(q) == 0:
                assert g[:3] == (0, 0, 0) and g[6] == []
                continue
            _, best, (qi, rj, nm, wops) = _jax_walk(q, r, ps, js)
            assert g == (*best, qi, rj, nm, wops), name


def test_wrapper_checks_its_inputs():
    q = torch.zeros((2, 5), dtype=torch.uint8)
    with pytest.raises(TypeError):
        cuda_sw.sw_batch(q.to(torch.int32), q, 1, -4, 6, 1)
    with pytest.raises(ValueError):
        cuda_sw.sw_batch(q, q[:1], 1, -4, 6, 1)


# -- the aligner ------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx():
    rng = np.random.default_rng(7)
    genome = rng.choice(BASES, size=60_000).astype(np.uint8)
    contigs = {"c1": genome[:40_000], "c2": genome[40_000:]}
    return contigs, genome, rng


def _mutate(read: str, kind: str, rng) -> str:
    i = int(rng.integers(30, len(read) - 30))
    b = "ACGT"[(("ACGT".index(read[i])) + 1) % 4]
    if kind == "snv":
        return read[:i] + b + read[i + 1:]
    if kind == "ins":
        return read[:i] + "ACGTA" + read[i:]
    if kind == "del":
        return read[:i] + read[i + 8:]
    return read


def _aln_tuple(a):
    return (a.qname, a.flag, a.ref_name, a.ref_id, a.pos, a.mapq,
            a.cigar_string(), a.seq, a.qual, a.score, a.nm,
            a.is_supplementary)


def _items(genome, rng):
    items = []
    for t in range(24):
        start = int(rng.integers(0, len(genome) - 200))
        read = genome[start : start + 150].tobytes().decode()
        read = _mutate(read, ["clean", "snv", "ins", "del"][t % 4], rng)
        if t % 5 == 0:  # reverse-strand reads
            read = read.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        items.append((f"r{t}", read, "I" * len(read)))
    a = genome[1_000:1_080].tobytes().decode()
    b = genome[45_000:45_080].tobytes().decode()
    items.append(("chim", a + b, "I" * 160))
    c = genome[3_000:3_300].tobytes().decode()
    e = genome[9_000:9_300].tobytes().decode()
    items.append(("junction", c + e, "I" * 600))
    items.append(("random", "".join(rng.choice(list("ACGTN"), 150)),
                  "I" * 150))
    return items


@pytest.mark.parametrize("splits", [False, True])
def test_aligner_matches_jax(ctx, splits):
    contigs, genome, rng = ctx
    items = _items(genome, np.random.default_rng(int(splits)))
    pa = pal.Aligner(pal.RefIndex(contigs), device="cpu")
    ja = jal.Aligner(jal.RefIndex(contigs))
    want = ja.align_seqs(items, splits=splits, batch=7)
    pa.sw_group_budget = 400_000  # groups of a few items, launches of many
    got = pa.align_seqs(items, splits=splits)
    assert len(pa.dp_batches) > 3
    seq = [pa.align_seq(n, s, q, splits=splits) for n, s, q in items]
    for g, w, s in zip(got, want, seq):
        assert [_aln_tuple(x) for x in g] == [_aln_tuple(x) for x in w]
        assert [_aln_tuple(x) for x in s] == [_aln_tuple(x) for x in w]
    if splits:
        assert len(got[-2]) >= 2  # the junction contig splits


def test_repeat_and_mob_scoring_match_jax():
    """An exact repeat (MAPQ 0) and the MOB profile's host path."""
    rng = np.random.default_rng(3)
    seg = rng.choice(BASES, size=400)
    spacer = rng.choice(BASES, size=1000)
    ref = np.concatenate([spacer, seg, spacer[::-1], seg, spacer])
    genome = ref.tobytes().decode()
    reads = [("rep", genome[1100:1250], "I" * 150),
             ("gap", genome[200:300] + "ACGTACGTAC" + genome[300:400],
              "I" * 210)]
    for ps, js in SCORINGS.values():
        pa = pal.Aligner(pal.RefIndex({"chr": ref}), scoring=ps, device="cpu")
        ja = jal.Aligner(jal.RefIndex({"chr": ref}), scoring=js)
        for n, s, q in reads:
            got = pa.align_seq(n, s, q, splits=True)
            assert [_aln_tuple(x) for x in got] == \
                [_aln_tuple(x) for x in ja.align_seq(n, s, q, splits=True)]
    assert pal.Aligner(pal.RefIndex({"chr": ref})).align_seq(
        *reads[0])[0].mapq == 0


def test_flat_index_matches_jax_and_ram(ctx, tmp_path):
    contigs, genome, rng = ctx
    p_path, j_path = str(tmp_path / "p.idx"), str(tmp_path / "j.idx")
    pal.build_flat_index(contigs, p_path, bucket_bits=4)
    jal.build_flat_index(contigs, j_path, bucket_bits=4)
    assert open(p_path, "rb").read() == open(j_path, "rb").read()
    flat, ram = pal.open_flat_index(p_path), pal.RefIndex(contigs)
    for attr in ("genome", "seed_keys", "seed_pos"):
        np.testing.assert_array_equal(np.asarray(getattr(flat, attr)),
                                      np.asarray(getattr(ram, attr)))
    assert flat.names == ram.names and flat.starts == ram.starts
    items = _items(genome, rng)[:8]
    got = pal.Aligner(flat, device="cpu").align_seqs(items)
    want = pal.Aligner(ram, device="cpu").align_seqs(items)
    assert [[_aln_tuple(x) for x in g] for g in got] == \
        [[_aln_tuple(x) for x in w] for w in want]


def test_pairs_duplicates_and_files_match_jax(ctx, tmp_path):
    """align_pairs, mark_duplicates and sort on pairs with duplicates, an
    unmapped mate and reverse mates; the SAM and the indexed BAM byte for
    byte."""
    contigs, genome, _ = ctx
    rng = np.random.default_rng(11)
    comp = str.maketrans("ACGT", "TGCA")
    pairs = []
    for t in range(20):
        start = int(rng.integers(0, len(genome) - 600))
        frag = int(rng.integers(250, 450))
        m1 = genome[start : start + 150].tobytes().decode()
        m2 = genome[start + frag - 150 : start + frag].tobytes().decode()
        m1 = _mutate(m1, ["clean", "snv", "ins", "del"][t % 4], rng)
        m2 = m2.translate(comp)[::-1]
        if t == 7:
            m2 = "".join(rng.choice(list("ACGT"), 150))  # unmapped mate
        pairs.append((f"p{t}", m1, "I" * len(m1), m2, "5" * len(m2)))
    pairs += [(f"dup{i}",) + pairs[i][1:] for i in (0, 3, 7)]
    pa = pal.Aligner(pal.RefIndex(contigs), device="cpu")
    ja = jal.Aligner(jal.RefIndex(contigs))
    got, n_got = psam.mark_duplicates(psam.align_pairs(pa, pairs))
    want, n_want = jsam.mark_duplicates(jsam.align_pairs(ja, pairs))
    assert n_got == n_want == 3
    got, want = psam.sort_alignments(got), jsam.sort_alignments(want)
    assert [_aln_tuple(a) for a in got] == [_aln_tuple(a) for a in want]
    for ext in ("sam", "bam"):
        p, j = tmp_path / f"p.{ext}", tmp_path / f"j.{ext}"
        getattr(psam, f"write_{ext}")(str(p), got, pa.ref)
        getattr(jsam, f"write_{ext}")(str(j), want, ja.ref)
        assert p.read_bytes() == j.read_bytes()
    assert (tmp_path / "p.bam.bai").read_bytes() == \
        (tmp_path / "j.bam.bai").read_bytes()
    line = psam.to_sam_line(got[0], tags="AS:i:1")
    assert line == jsam.to_sam_line(want[0], tags="AS:i:1")
