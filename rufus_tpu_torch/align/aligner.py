"""Seed-and-extend local aligner with BWA-mem-like scoring.

Replaces `bwa mem` for (a) mutant-read alignment feeding assembly
(runRufus.sh:1000-1001), (b) contig alignment feeding interpret
(Overlap.shorter.sh:209), (c) MOB-element alignment (:225).

Pipeline: sorted-array seed index over the reference (the same
sorted-table idiom as the k-mer engine) -> diagonal voting -> banded
Smith-Waterman with affine gaps (match 1, mismatch -4, open 6, extend 1,
clip 5 — bwa-mem defaults) -> CIGAR via traceback, soft clips, split
(supplementary) alignments for contig SV evidence, bwa-like MAPQ.

The port of ``rufus_tpu/align/aligner.py``: host code stays numpy, as
there, so that float and tie behaviour are the same (``np.median`` of a
cluster, the stable seed sort). ``Aligner.align_seqs`` runs every
candidate's DP and traceback in one launch a group on the aligner's device
(``sw_device.sw_align``: the CUDA kernel on a card, H never leaving it);
``align_seq`` without precomputed DPs runs the host ``sw_kernel`` and
``_traceback``, as the MOB pass does in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import sw_device
from ..ops import codec

MATCH, MISMATCH = 1, -4
GAP_OPEN, GAP_EXT = 6, 1
CLIP_PEN = 5


@dataclass(frozen=True)
class Scoring:
    """Affine-gap scoring profile (bwa-mem parameter set)."""

    match: int = MATCH
    mismatch: int = MISMATCH
    gap_open: int = GAP_OPEN
    gap_ext: int = GAP_EXT
    clip_pen: int = CLIP_PEN
    pad: int = 64  # ref-window pad around the candidate diagonal (bwa -w/-d)


DEFAULT_SCORING = Scoring()

# The reference aligns contigs against the mobile-element library with a
# near-glocal profile — `bwa mem -Y -E 0,0 -O 6,6 -d 500 -w 500 -L 0,0`
# (the reference's scripts/Overlap.shorter.sh:225): FREE gap extension,
# FREE clipping, and a wide band, which changes which MOB alignment wins
# and therefore the <INS:ME:MOB> evidence (checkMob gates on MOB alignment
# quality, RUFUS.interpret.cpp:5442-5479).
MOB_SCORING = Scoring(gap_ext=0, clip_pen=0, pad=500)

_LUT = np.full(256, 255, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    _LUT[_b] = _c
    _LUT[_b + 32] = _c


def encode(seq_bytes: np.ndarray) -> np.ndarray:
    return _LUT[seq_bytes]


@dataclass
class Alignment:
    qname: str
    flag: int
    ref_name: str
    pos: int  # 0-based leftmost ref position
    mapq: int
    cigar: list[tuple[int, str]]
    seq: str
    qual: str
    score: int = 0
    ref_id: int = -1
    nm: int = 0
    # split-read bookkeeping
    is_supplementary: bool = False

    def cigar_string(self) -> str:
        if not self.cigar:
            return "*"
        return "".join(f"{n}{op}" for n, op in self.cigar)

    @property
    def is_unmapped(self):
        return bool(self.flag & 0x4)

    @property
    def is_reverse(self):
        return bool(self.flag & 0x10)

    def ref_span(self) -> int:
        return sum(n for n, op in self.cigar if op in "MDN=X")

    def query_start(self) -> int:
        """Length of leading soft/hard clip."""
        if self.cigar and self.cigar[0][1] in "SH":
            return self.cigar[0][0]
        return 0

    def query_aligned_len(self) -> int:
        return sum(n for n, op in self.cigar if op in "MI=X")


class RefIndex:
    """Sorted seed index: (packed seed, position) arrays over all contigs."""

    def __init__(self, contigs: dict[str, np.ndarray], seed_len: int = 19,
                 max_occ: int = 64):
        self.seed_len = seed_len
        self.max_occ = max_occ
        self.names = list(contigs)
        self.starts = {}
        self.lengths = {n: len(a) for n, a in contigs.items()}
        self.contigs = contigs
        parts = []
        off = 0
        for n in self.names:
            self.starts[n] = off
            parts.append(contigs[n])
            off += len(contigs[n])
            # separator run of N so windows never span contigs
            parts.append(np.full(seed_len, ord("N"), np.uint8))
            off += seed_len
        self.genome = np.concatenate(parts) if parts else np.empty(0, np.uint8)
        self.total = off
        codes = encode(self.genome)
        n_win = len(codes) - seed_len + 1
        if n_win <= 0:
            self.seed_keys = np.empty(0, np.uint64)
            self.seed_pos = np.empty(0, np.uint32)
            return
        kmers, valid = _pack_host(codes, seed_len)
        pos = np.nonzero(valid)[0]
        keys = kmers[pos]
        order = np.argsort(keys, kind="stable")
        self.seed_keys = keys[order]
        self.seed_pos = pos[order].astype(np.uint32)

    def locate(self, name: str, gpos: int) -> tuple[str, int] | None:
        """Global position -> (contig, local pos)."""
        for n in self.names:
            s = self.starts[n]
            if s <= gpos < s + self.lengths[n]:
                return n, gpos - s
        return None

    def lookup(self, kmers: np.ndarray):
        lo = np.searchsorted(self.seed_keys, kmers, side="left")
        hi = np.searchsorted(self.seed_keys, kmers, side="right")
        return lo, hi


FLAT_MAGIC = b"RTA1"


def build_flat_index(contigs: dict[str, np.ndarray], path: str,
                     seed_len: int = 19, max_occ: int = 64,
                     bucket_bits: int = 8):
    """Build a RefIndex as a FLAT FILE with bounded host memory.

    An in-RAM RefIndex holds every (seed, position) pair (~12 bytes per
    genome base: ~36 GB for human+decoys), which whole genomes cannot
    afford. This function needs only O(genome/2^bucket_bits)
    RAM: pass 1 scans the genome once, appending each seed to one of
    2^bucket_bits spill files by its TOP BITS (so bucket order == key
    order); pass 2 sorts each bucket in RAM and appends it to the final
    file. Layout: magic, header json (names/lengths/starts/seed_len/n),
    genome u8, keys u64, positions u32 — all memmappable.
    """
    import json
    import os
    import tempfile

    names = list(contigs)
    starts, parts, off = {}, [], 0
    for n in names:
        starts[n] = off
        parts.append(contigs[n])
        off += len(contigs[n])
        parts.append(np.full(seed_len, ord("N"), np.uint8))
        off += seed_len
    genome = np.concatenate(parts) if parts else np.empty(0, np.uint8)
    total = off
    nb = 1 << bucket_bits
    shift = np.uint64(2 * seed_len - bucket_bits)

    tmpdir = tempfile.mkdtemp(prefix="flatidx.", dir=os.path.dirname(path) or ".")
    bucket_files = [open(os.path.join(tmpdir, f"b{i:03d}"), "wb")
                    for i in range(nb)]
    try:
        chunk = 8 << 20
        n_seeds = 0
        for c0 in range(0, len(genome), chunk):
            seg = genome[max(0, c0): c0 + chunk + seed_len - 1]
            codes = encode(seg)
            if len(codes) < seed_len:
                continue
            kmers, valid = _pack_host(codes, seed_len)
            pos = np.nonzero(valid)[0]
            keys = kmers[pos]
            gpos = (pos + c0).astype(np.uint32)
            b = (keys >> shift).astype(np.int32)
            order = np.argsort(b, kind="stable")
            keys, gpos, b = keys[order], gpos[order], b[order]
            bounds = np.searchsorted(b, np.arange(nb + 1))
            for i in range(nb):
                lo, hi = bounds[i], bounds[i + 1]
                if hi > lo:
                    rec = np.empty(hi - lo, dtype=[("k", "<u8"), ("p", "<u4")])
                    rec["k"], rec["p"] = keys[lo:hi], gpos[lo:hi]
                    rec.tofile(bucket_files[i])
                    n_seeds += hi - lo
        for f in bucket_files:
            f.close()
        header = json.dumps({
            "names": names, "lengths": {n: len(contigs[n]) for n in names},
            "starts": starts, "seed_len": seed_len, "max_occ": max_occ,
            "total": total, "genome_len": len(genome), "n_seeds": int(n_seeds),
        }).encode()
        # pad so the u64 keys plane lands 8-byte aligned: a misaligned
        # memmap sends np.searchsorted down a ~1000x slower unaligned
        # path (measured 160 ms per lookup batch)
        pre = 4 + 8 + len(header)
        pad_bytes = (-(pre + len(genome))) % 8
        with open(path, "wb") as out:
            out.write(FLAT_MAGIC)
            out.write(np.array([len(header)], dtype="<u8").tobytes())
            out.write(header)
            genome.tofile(out)
            out.write(b"\0" * pad_bytes)
            for i in range(nb):  # keys plane: sort each bucket ONCE and
                # write the sorted records back to the spill file so the
                # positions plane below just streams them
                fp = os.path.join(tmpdir, f"b{i:03d}")
                rec = np.fromfile(fp, dtype=[("k", "<u8"), ("p", "<u4")])
                rec = rec[np.argsort(rec["k"], kind="stable")]
                rec["k"].tofile(out)
                rec.tofile(fp)
            for i in range(nb):  # positions plane, already sorted
                rec = np.fromfile(os.path.join(tmpdir, f"b{i:03d}"),
                                  dtype=[("k", "<u8"), ("p", "<u4")])
                rec["p"].tofile(out)
    finally:
        for i in range(nb):
            p = os.path.join(tmpdir, f"b{i:03d}")
            if os.path.exists(p):
                os.unlink(p)
        os.rmdir(tmpdir)
    return path


def open_flat_index(path: str) -> "RefIndex":
    """Open a build_flat_index file as a RefIndex whose genome/seed
    arrays are memmapped (demand-paged): host RAM stays O(pages touched),
    the RUFUS.search.1kg.cpp mmap+binary-search idiom applied to the
    aligner (checkPage:135/search:214)."""
    import json

    with open(path, "rb") as f:
        if f.read(4) != FLAT_MAGIC:
            raise ValueError(f"{path}: not a flat ref index")
        (hlen,) = np.frombuffer(f.read(8), dtype="<u8")
        header = json.loads(f.read(int(hlen)).decode())
    off = 4 + 8 + int(hlen)
    g_len = header["genome_len"]
    n = header["n_seeds"]
    idx = RefIndex.__new__(RefIndex)
    idx.seed_len = header["seed_len"]
    idx.max_occ = header["max_occ"]
    idx.names = header["names"]
    idx.starts = {k: int(v) for k, v in header["starts"].items()}
    idx.lengths = {k: int(v) for k, v in header["lengths"].items()}
    idx.total = header["total"]
    idx.contigs = None  # not materialized; genome below is the source
    idx.genome = np.memmap(path, dtype=np.uint8, mode="r", offset=off,
                           shape=(g_len,))
    koff = off + g_len + ((-(off + g_len)) % 8)  # 8-aligned keys plane
    idx.seed_keys = np.memmap(path, dtype="<u8", mode="r",
                              offset=koff, shape=(n,))
    idx.seed_pos = np.memmap(path, dtype="<u4", mode="r",
                             offset=koff + 8 * n, shape=(n,))
    return idx


def _pack_host(codes: np.ndarray, k: int):
    """Host windowed packing (numpy mirror of ops.codec.pack_kmers)."""
    L = len(codes)
    W = L - k + 1
    acc = np.zeros(W, dtype=np.uint64)
    bad = np.zeros(W, dtype=bool)
    for j in range(k):
        c = codes[j : j + W]
        bad |= c == 255
        acc = (acc << np.uint64(2)) | np.where(c == 255, 0, c).astype(np.uint64)
    return acc, ~bad


def sw_kernel(q: np.ndarray, r: np.ndarray, sc: Scoring = DEFAULT_SCORING):
    """Local affine-gap DP: best local score + full H matrix for traceback.

    q, r: 2-bit codes (255 = N, never matches). One numpy-vectorized row per
    query base; the horizontal-gap scan uses the closed form
    E[j] = max_{j'<j}(H[j'] + ext*j') - open - ext*j (chaining horizontal
    gaps is never better than one longer gap — with ext=0 it ties, and one
    gap still wins — so sources need not include E-derived cells). This is
    the host mirror of the batched device kernel.
    """
    n, m = len(q), len(r)
    H = np.zeros((n + 1, m + 1), dtype=np.int32)
    best = (0, 0, 0)
    match_all = np.where(
        (q[:, None] == r[None, :]) & (q[:, None] != 255) & (r[None, :] != 255),
        sc.match, sc.mismatch).astype(np.int32)
    NEG = -(10 ** 6)
    F = np.full(m + 1, NEG, dtype=np.int32)
    j_idx = np.arange(m + 1, dtype=np.int32) * sc.gap_ext
    for i in range(1, n + 1):
        prev = H[i - 1]
        F = np.maximum(F - sc.gap_ext, prev - sc.gap_open - sc.gap_ext)
        row = np.zeros(m + 1, dtype=np.int32)
        cand = np.maximum(np.maximum(prev[:-1] + match_all[i - 1], F[1:]), 0)
        row[1:] = cand
        # E via prefix max of (row[j'] + ext*j') over j' < j
        s = row + j_idx
        pref = np.maximum.accumulate(s[:-1])
        E = pref - sc.gap_open - sc.gap_ext - j_idx[:-1]
        row[1:] = np.maximum(row[1:], E)
        H[i] = row
        j_best = int(np.argmax(row))
        if row[j_best] > best[0]:
            best = (int(row[j_best]), i, j_best)
    return best, H


def _traceback(q, r, H, bi, bj, sc: Scoring = DEFAULT_SCORING):
    """Recover CIGAR from H by local re-derivation (scores re-computed)."""
    i, j = bi, bj
    ops = []
    nm = 0
    while i > 0 and j > 0 and H[i][j] > 0:
        h = H[i][j]
        sub = sc.match if (q[i - 1] == r[j - 1] and q[i - 1] != 255
                           and r[j - 1] != 255) else sc.mismatch
        if h == H[i - 1][j - 1] + sub:
            ops.append("M")
            if sub == sc.mismatch:
                nm += 1
            i -= 1
            j -= 1
            continue
        # horizontal run (D: consume ref); bounded gap search — the bound
        # tracks the scoring window so wide-band profiles (MOB glocal,
        # pad 500) can recover gaps the band admits
        gap_max = max(128, 2 * sc.pad)
        found = False
        for g in range(1, min(j, gap_max) + 1):
            if h == H[i][j - g] - sc.gap_open - sc.gap_ext * g:
                ops.extend("D" * g)
                nm += g
                j -= g
                found = True
                break
        if found:
            continue
        for g in range(1, min(i, gap_max) + 1):
            if h == H[i - g][j] - sc.gap_open - sc.gap_ext * g:
                ops.extend("I" * g)
                nm += g
                i -= g
                found = True
                break
        if not found:
            break
    ops.reverse()
    return i, j, ops, nm


def _compress(ops: list[str]) -> list[tuple[int, str]]:
    out = []
    for op in ops:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + 1, op)
        else:
            out.append((1, op))
    return out


# candidate seed clusters tried a strand, and the least score an alignment
# keeps (bwa mem's -T 30)
MAX_CANDS, MIN_SCORE = 4, 30


class Aligner:
    def __init__(self, ref: RefIndex, scoring: Scoring = DEFAULT_SCORING,
                 device="cuda"):
        self.ref = ref
        self.sc = scoring
        self.device = torch.device(device)  # where align_seqs' DPs run
        self.dp_batches: list = []  # every launch's [(n, m)] of pairs

    def _candidates(self, codes: np.ndarray):
        """Seed -> diagonal clusters -> candidate (gstart, count) windows."""
        k = self.ref.seed_len
        if len(codes) < k:
            return []
        kmers, valid = _pack_host(codes, k)
        qpos = np.nonzero(valid)[0]
        kmers = kmers[qpos]
        if len(kmers) == 0:
            return []
        lo, hi = self.ref.lookup(kmers)
        occ = hi - lo
        use = occ <= self.ref.max_occ
        diags = []
        for ql, l, h, u in zip(qpos, lo, hi, use):
            if not u or h <= l:
                continue
            diags.append(self.ref.seed_pos[l:h].astype(np.int64) - int(ql))
        if not diags:
            return []
        d = np.sort(np.concatenate(diags))
        # cluster diagonals within +/-16
        clusters = []
        start = 0
        for i in range(1, len(d) + 1):
            if i == len(d) or d[i] - d[i - 1] > 16:
                clusters.append((int(np.median(d[start:i])), i - start))
                start = i
        clusters.sort(key=lambda c: -c[1])
        return clusters[:MAX_CANDS]

    def _window(self, seq: str, diag: int, pad: int | None = None):
        """(codes, ref window codes, window global start) for a candidate
        diagonal; None when the window is empty."""
        if pad is None:
            pad = self.sc.pad
        codes = encode(np.frombuffer(seq.encode(), np.uint8))
        L = len(codes)
        g0 = max(0, diag - pad)
        g1 = min(self.ref.total, diag + L + pad)
        if g1 <= g0:
            return None
        window = encode(np.asarray(self.ref.genome[g0:g1]))
        return codes, window, g0

    def _extend(self, seq: str, diag: int, pad: int | None = None, dp=None):
        """Align one candidate. `dp` carries a precomputed (score, bi, bj,
        qi, rj, nm, ops) from the batched device DP and traceback
        (sw_device.sw_align, bit-identical to sw_kernel and _traceback);
        without it the host DP and traceback run here."""
        win = self._window(seq, diag, pad)
        if win is None:
            return None
        codes, window, g0 = win
        L = len(codes)
        if dp is None:
            (score, bi, bj), H = sw_kernel(codes, window, self.sc)
            if score <= 0:
                return None
            qi, rj, ops, nm = _traceback(codes, window, H, bi, bj, self.sc)
        else:
            score, bi, bj, qi, rj, nm, ops = dp
            if score <= 0:
                return None
        # bwa-mem clip preference: extend (ungapped) to each read end unless
        # the extension scores worse than -CLIP_PEN (bwa-mem zdrop/pen_clip5)
        head_ops, head_nm, d = self._clip_extend(codes, window, qi, rj, -1)
        qi -= d
        rj -= d
        ops = head_ops + ops
        nm += head_nm
        tail_ops, tail_nm, d2 = self._clip_extend(codes, window, bi, bj, +1)
        ops = ops + tail_ops
        nm += tail_nm
        bi += d2
        bj += d2
        cigar = []
        if qi > 0:
            cigar.append((qi, "S"))
        cigar.extend(_compress(ops))
        tail = L - bi
        if tail > 0:
            cigar.append((tail, "S"))
        gstart = g0 + rj
        n_ext = len(head_ops) + len(tail_ops)
        n_mm = head_nm + tail_nm
        score += (n_ext - n_mm) * self.sc.match + n_mm * self.sc.mismatch
        return score, gstart, cigar, nm, qi, bi

    def _clip_extend(self, codes, window, q_edge, r_edge, direction):
        """Ungapped extension from an alignment edge to the read end.

        direction -1 extends leftward from (q_edge, r_edge) exclusive;
        +1 extends rightward from (q_edge, r_edge) inclusive-onward.
        Returns (ops, n_mismatch, n_extended); empty if the full extension
        scores below -CLIP_PEN or runs out of reference window.
        """
        L, M = len(codes), len(window)
        if direction < 0:
            n = q_edge
            if n == 0 or r_edge - n < 0:
                return [], 0, 0
            qs = codes[q_edge - n : q_edge]
            rs = window[r_edge - n : r_edge]
        else:
            n = L - q_edge
            if n == 0 or r_edge + n > M:
                return [], 0, 0
            qs = codes[q_edge : q_edge + n]
            rs = window[r_edge : r_edge + n]
        mm = int(np.sum((qs != rs) | (qs == 255) | (rs == 255)))
        delta = (n - mm) * self.sc.match + mm * self.sc.mismatch
        if delta <= -self.sc.clip_pen:
            return [], 0, 0
        return ["M"] * n, mm, n

    def align_seq(self, name: str, seq: str, qual: str, splits: bool = False,
                  _dp_map=None):
        """Best local alignment of seq (both strands) -> list[Alignment].

        With splits=True, re-aligns long unaligned tails as supplementary
        records (bwa mem -Y behavior needed by interpret's SV passes).
        _dp_map: {(strand, diag): (score, bi, bj, qi, rj, nm, ops)}
        precomputed by the batched device path (align_seqs); absent entries
        fall back to the host DP and traceback.
        """
        fwd = seq.upper()
        rev = codec.revcomp_str(fwd)
        results = []
        for strand, s in ((0, fwd), (1, rev)):
            if _dp_map is not None and ("cands", strand) in _dp_map:
                diags = _dp_map[("cands", strand)]  # phase-1 seed lookup
            else:
                codes = encode(np.frombuffer(s.encode(), np.uint8))
                diags = [d for d, _ in self._candidates(codes)]
            for diag in diags:
                dp = None if _dp_map is None else _dp_map.get((strand, diag))
                ext = self._extend(s, diag, dp=dp)
                if ext is None:
                    continue
                score, gstart, cigar, nm, qs, qe = ext
                results.append((score, strand, gstart, cigar, nm, qs, qe, s))
        results = [r for r in results if r[0] >= MIN_SCORE]
        # dedupe: several seed clusters can extend to the same placement,
        # which must not count as its own MAPQ rival
        seen = set()
        uniq = []
        for r in results:
            key = (r[1], r[2])
            if key not in seen:
                seen.add(key)
                uniq.append(r)
        results = uniq
        if not results:
            return [Alignment(name, 0x4, "*", -1, 0, [], fwd, qual)]
        results.sort(key=lambda x: (-x[0], x[2]))
        best = results[0]
        # MAPQ from competitors covering the SAME query region (bwa treats
        # chimeric halves independently — the other half is not a rival)
        second = self._second_best(best, results)
        mapq = self._mapq(best[0], second, len(seq))
        out = [self._to_alignment(name, qual, best, mapq, False)]
        if splits:
            out.extend(self._find_splits(name, qual, best, results))
        return out

    # bound on the device bytes of the H workspace of one launch (H of a
    # candidate is (n+1) rows of m+1 int32, rounded up to 4 columns, and
    # stays on the device); a group of items is cut where it would pass it
    sw_group_budget = 1 << 30

    def align_seqs(self, items, splits: bool = False):
        """Batched alignment: the candidate DPs and tracebacks of MANY
        sequences run as one device launch a group (sw_device.sw_align on
        self.device), then each sequence's selection proceeds exactly as
        align_seq: bit-identical output (the device DP and traceback equal
        the host ones; everything downstream is shared code).

        items: iterable of (name, seq, qual). Items are processed in groups
        whose candidates' H workspace stays under sw_group_budget."""
        out = []
        group, cands, est = [], [], 0
        for item in items:
            mine = self._item_candidates(item[1])
            nbytes = sum(4 * (len(q) + 1) * ((len(w) + 4) // 4 * 4)
                         for _, _, q, w in mine)
            if group and est + nbytes > self.sw_group_budget:
                out.extend(self._align_group(group, cands, splits))
                group, cands, est = [], [], 0
            group.append(item)
            cands.append(mine)
            est += nbytes
        if group:
            out.extend(self._align_group(group, cands, splits))
        return out

    def _item_candidates(self, seq):
        """Every candidate window of a sequence on both strands (host seed
        lookup, done ONCE: selection reuses the diagonal lists instead of
        re-seeding): [(strand, diag, codes, window)]."""
        fwd = seq.upper()
        rev = codec.revcomp_str(fwd)
        out = []
        for strand, s in ((0, fwd), (1, rev)):
            codes = encode(np.frombuffer(s.encode(), np.uint8))
            for diag, _cnt in self._candidates(codes):
                win = self._window(s, diag)
                if win is not None:
                    out.append((strand, diag, win[0], win[1]))
        return out

    def _align_group(self, items, cands, splits):
        flat = [(idx, c) for idx, mine in enumerate(cands) for c in mine]
        dp_maps = [{("cands", 0): [], ("cands", 1): []} for _ in items]
        for idx, (strand, diag, _, _) in flat:
            dp_maps[idx][("cands", strand)].append(diag)
        if flat:
            pairs = [(q, w) for _, (_, _, q, w) in flat]
            res = sw_device.sw_align(pairs, self.sc, device=self.device)
            self.dp_batches.append([(len(q), len(w)) for q, w in pairs])
            for (idx, (strand, diag, _, _)), dp in zip(flat, res):
                dp_maps[idx][(strand, diag)] = dp
        # per-sequence selection, unchanged host logic
        return [self.align_seq(name, seq, qual, splits, _dp_map=dp_maps[idx])
                for idx, (name, seq, qual) in enumerate(items)]

    @staticmethod
    def _q_interval(res, L):
        """Query interval of a result on the FORWARD read orientation."""
        score, strand, gstart, cigar, nm, qs, qe, s = res
        return (L - qe, L - qs) if strand else (qs, qe)

    def _second_best(self, target, results):
        L = len(target[7])
        a0, b0 = self._q_interval(target, L)
        second = 0
        for r in results:
            if r is target:
                continue
            a, b = self._q_interval(r, L)
            ov = max(0, min(b0, b) - max(a0, a))
            if ov >= 0.5 * max(1, min(b0 - a0, b - a)):
                second = max(second, r[0])
        return second

    def _mapq(self, best: int, second: int, qlen: int) -> int:
        if best <= second:
            return 0
        # bwa-like: scaled difference
        frac = (best - second) / max(best, 1)
        q = int(40.0 * frac + 0.499) + 20 if second > 0 else 60
        return max(0, min(60, q))

    def _to_alignment(self, name, qual, res, mapq, suppl):
        score, strand, gstart, cigar, nm, qs, qe, s = res
        loc = self.ref.locate_global(gstart)
        flag = (0x10 if strand else 0) | (0x800 if suppl else 0)
        q = qual if strand == 0 else qual[::-1]
        contig, pos = loc
        rid = self.ref.names.index(contig)
        return Alignment(name, flag, contig, pos, mapq, cigar, s, q,
                         score=score, ref_id=rid, nm=nm, is_supplementary=suppl)

    def _find_splits(self, name, qual, best, results):
        """Supplementary alignments covering query tails the primary missed.

        Each new split must be mostly novel w.r.t. the primary AND every
        already-accepted split (best-score-first keeps the strongest hit
        per query region)."""
        L = len(best[7])
        covered = [self._q_interval(best, L)]
        out = []
        for res in results[1:]:
            if res[0] < MIN_SCORE:
                continue
            a, b = self._q_interval(res, L)
            ov = max(max(0, min(cb, b) - max(ca, a)) for ca, cb in covered)
            if ov < 0.5 * (b - a):
                mapq = self._mapq(res[0], self._second_best(res, results), L)
                out.append(self._to_alignment(name, qual, res, mapq, True))
                covered.append((a, b))
                if len(out) >= 2:
                    break
        return out


def _locate_global(self, gpos: int):
    lo = 0
    for n in self.names:
        s = self.starts[n]
        if s <= gpos < s + self.lengths[n]:
            return n, gpos - s
    # position falls in separator; clamp to nearest preceding contig end
    prev = self.names[0]
    for n in self.names:
        if self.starts[n] > gpos:
            break
        prev = n
    return prev, max(0, min(gpos - self.starts[prev], self.lengths[prev] - 1))


RefIndex.locate_global = _locate_global
