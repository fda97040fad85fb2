"""Read and contig alignment: the port's modules against the JAX package's
on the same numpy-seeded inputs. Tolerance: none (integer DP, exact
alignments, byte-equal files).

- ``sw_batch``: the plain PyTorch version against JAX ``sw_device.sw_batch``
  and the host ``sw_kernel``, for both scorings (mirrors
  tests/test_sw_device.py), and a numpy model of the CUDA kernel's
  launch geometry and block scan against the plain version (the kernel
  itself runs only on the card: tests/test_torch_gpu.py);
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
    got = psw.sw_batch(q, r, ps, device="cpu")
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
    H1, s1, bi1, bj1 = psw.sw_batch(q[None], r[None], device="cpu")
    H2, s2, bi2, bj2 = psw.sw_batch(qp[None], r[None], device="cpu")
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
        H, s, bi, bj = psw.sw_batch(qb, rb, SCORINGS[sc][0], device="cpu")
        assert not H[0].any() and (s[0], bi[0], bj[0]) == (0, 0, 0)
        assert (s[1], bi[1], bj[1]) == (30, 30, 40)
        want = jsw.sw_batch(qb, rb, SCORINGS[sc][1])
        for g, w in zip((H, s, bi, bj), want):
            np.testing.assert_array_equal(g, w)


def kernel_model(q, r, match, mismatch, gap_open, gap_ext):
    """numpy model of csrc/sw_batch.cu: threads over contiguous column
    chunks (launch_shape), pass 1 over the chunk, the warp shuffle scan
    and the warps' totals for the exclusive max, pass 2, each thread's
    first best and the block's reduction."""
    B, n = q.shape
    m = r.shape[1]
    M = m + 1
    T, chunk = cuda_sw.launch_shape(m)
    assert T % 32 == 0 and T <= 1024 and T * chunk >= M
    minus_inf = -(2 ** 31) // 2
    oe = gap_open + gap_ext
    H = np.zeros((B, n + 1, M), np.int64)
    out = np.zeros((3, B), np.int64)
    j0 = np.minimum(np.arange(T) * chunk, M)
    j1 = np.minimum(j0 + chunk, M)
    for b in range(B):
        prev = np.zeros(M, np.int64)
        F = np.full(M, cuda_sw.NEG, np.int64)
        bs = np.zeros(T, np.int64)
        bflat = np.zeros(T, np.int64)
        for i in range(1, n + 1):
            qi = int(q[b, i - 1])
            cur = np.zeros(M, np.int64)
            run = np.full(T, minus_inf, np.int64)
            for t in range(T):
                for j in range(j0[t], j1[t]):
                    cand = 0
                    if j > 0:
                        F[j] = max(F[j] - gap_ext, prev[j] - oe)
                        rc = int(r[b, j - 1])
                        sub = match if (qi == rc and qi != 255
                                        and rc != 255) else mismatch
                        cand = max(prev[j - 1] + sub, F[j], 0)
                    cur[j] = cand
                    run[t] = max(run[t], cand + gap_ext * j)
            incl = run.copy()
            lane = np.arange(T) % 32
            d = 1
            while d < 32:
                shifted = np.concatenate([incl[:d], incl[:-d]])
                incl = np.where(lane >= d, np.maximum(incl, shifted), incl)
                d *= 2
            totals = incl[31::32]
            excl = np.where(lane == 0, minus_inf,
                            np.concatenate([[minus_inf], incl[:-1]]))
            for t in range(T):
                e = max([excl[t]] + list(totals[: t // 32]))
                for j in range(j0[t], j1[t]):
                    cand = cur[j]
                    v = max(cand, e - oe - gap_ext * (j - 1)) if j else 0
                    cur[j] = v
                    if v > bs[t]:
                        bs[t], bflat[t] = v, i * M + j
                    e = max(e, cand + gap_ext * j)
            H[b, i] = cur
            prev = cur
        top = bs.max()
        flat = bflat[bs == top].min()
        out[:, b] = top, flat // M, flat % M
    return H, out


@pytest.mark.parametrize("scoring", ["default", "mob"])
@pytest.mark.parametrize("n,m", [(7, 40), (5, 1100)])
def test_kernel_model_matches_plain(scoring, n, m):
    """The kernel's arithmetic at one column a thread and at two (m + 1 >
    1024, where the chunks and idle threads appear)."""
    sc = SCORINGS[scoring][0]
    rng = np.random.default_rng(m)
    q, r = _batch(rng, 3, n, m)
    q[1] = 255  # an all-N query
    r[2, 600:] = np.resize(q[2], m - 600) if m > 600 else r[2, 600:]
    args = (sc.match, sc.mismatch, sc.gap_open, sc.gap_ext)
    H, s, bi, bj = cuda_sw.sw_batch(torch.from_numpy(q), torch.from_numpy(r),
                                    *args)
    mH, mout = kernel_model(q, r, *args)
    np.testing.assert_array_equal(mH, H.numpy())
    np.testing.assert_array_equal(mout, torch.stack([s, bi, bj]).numpy())


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
    got = pa.align_seqs(items, splits=splits, batch=7)
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
