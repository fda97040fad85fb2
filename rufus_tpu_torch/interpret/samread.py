"""SamRead: contig-alignment record and per-base variant evidence.

Re-derivation of RUFUS.interpret.cpp SamRead (parse 3271-3358,
processCigar 2954-2980, getRefSeq 3016-3166, LookUpKmers 3168-3270,
BuildUpHashCountTable 1425-1565, createPeakMap 2461-2492 with the
last/next helpers 2440-2460, CheckPhase 2261-2345, ClipPattern 713-770,
CountAlignmentSegments* 2061-2098, CheckBasesAligned/CheckEndsAlign
4419-4470, AlignmentAllA 4805-4855, GetSupportingHashCount 1566-1587,
parseMutations 2582-2953).

The expanded per-column representation: seq/RefSeq/qual/cigarString
aligned strings where cigar chars are M/X/I/D/S/H ('M' match, 'X'
mismatch, 'I' insertion — ref '-', 'D' deletion — seq '-', clips kept).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..ops import codec
from .model import (DepthModel, baysean_genotyper, parse_genotype)


class PullTable:
    """Sorted-array point-lookup table (packed kmer int -> count).

    The batched replacement for the reference's per-position
    `unordered_map` probes in LookUpKmers (RUFUS.interpret.cpp:3168-3270):
    one vectorized searchsorted per contig instead of O(len) Python dict
    hits. Scales to pull tables of any size (memory O(n), lookup O(log n)
    per key, fully vectorized) — the SURVEY §7.1.9 device-gather design,
    host-side numpy here because contig batches are small."""

    def __init__(self, d: dict):
        if d:
            keys = np.fromiter(d.keys(), dtype=np.uint64, count=len(d))
            vals = np.fromiter(d.values(), dtype=np.int64, count=len(d))
            order = np.argsort(keys)
            self.keys = keys[order]
            self.vals = vals[order]
        else:
            self.keys = np.empty(0, np.uint64)
            self.vals = np.empty(0, np.int64)

    def get_many(self, q: np.ndarray):
        """-> (counts int64, found bool) for an array of packed keys."""
        if len(self.keys) == 0:
            return (np.zeros(len(q), np.int64), np.zeros(len(q), bool))
        idx = np.searchsorted(self.keys, q)
        idx_c = np.minimum(idx, len(self.keys) - 1)
        found = self.keys[idx_c] == q
        return np.where(found, self.vals[idx_c], 0), found


_CODE_LUT = np.full(256, -1, np.int8)
for _i, _c in enumerate(b"ACGT"):
    _CODE_LUT[_c] = _i


def hash_columns(seq: str, k: int):
    """Vectorized getHash over every column: returns (strs, keys, valid).

    strs[j] == get_hash(seq, j, k) exactly (k bases starting at column j,
    skipping non-base columns, possibly shorter at the tail); keys[j] is
    its LSB-first 2-bit packing (== Context.h2l of the string); valid[j]
    is False where the column itself is not a base ('' hash)."""
    arr = np.frombuffer(seq.encode("latin1"), np.uint8)
    code = _CODE_LUT[arr]
    is_base = code >= 0
    ranks = np.cumsum(is_base) - 1
    cb_codes = code[is_base].astype(np.uint64)
    M = len(cb_codes)
    packed = np.zeros(M, np.uint64)
    for i in range(k):
        if i >= M:
            break
        packed[: M - i] += cb_codes[i:] << np.uint64(2 * i)
    cb_str = arr[is_base].tobytes().decode("latin1")
    strs = [cb_str[r : r + k] if v else ""
            for r, v in zip(ranks.tolist(), is_base.tolist())]
    keys = np.zeros(len(arr), np.uint64)
    if M:
        keys[is_base] = packed[ranks[is_base]]
    return strs, keys, is_base


def get_hash(seq: str, j: int, k: int) -> str:
    """getHash (379-400): k ACGT bases starting at column j, skipping
    non-base columns; '' if column j itself is not a base."""
    if j >= len(seq) or seq[j] not in "ACGT":
        return ""
    out = []
    bases = 0
    while bases < k and j < len(seq):
        c = seq[j]
        if c in "ACGT":
            out.append(c)
            bases += 1
        j += 1
    return "".join(out)


def entropy_multi(s: str, size: int) -> float:
    events: dict[str, int] = {}
    count = 0
    for i in range(0, len(s) + 1 - size, size):
        count += 1
        w = s[i : i + size]
        events[w] = events.get(w, 0) + 1
    if count == 0:
        return float("nan")
    log = -math.log2(events[s[0:size]] / count)
    for i in range(size, len(s) + 1 - size, size):
        log += -math.log2(events[s[i : i + size]] / count)
    return log / count


def compress_var(line: str, start: int):
    """compressVar (2345-2439) -> (CV string, StructCall string)."""
    struct_call = ""
    if not line:
        return "", struct_call
    current = line[0]
    count = 1
    cv = ""

    def emit(cur, cnt, tandem):
        nonlocal cv, struct_call
        if cnt > 2:
            cv += f"{cnt}{cur}"
            if cur == "Y":
                kind = "SVTYPE=DUP:TANDEM;END=" if tandem else "SVTYPE=DUP;END="
                struct_call = f"{kind}{cnt + start};SVLEN={cnt};"
        elif cnt == 2:
            cv += cur + cur
        elif cnt == 1:
            cv += cur

    for ch in line[1:]:
        if ch == current:
            count += 1
        else:
            emit(current, count, False)
            current = ch
            count = 1
    emit(current, count, True)
    return cv, struct_call


def _next(qual: str, i: int) -> str:
    for j in range(i + 1, len(qual)):
        if qual[j] != qual[i] or qual[j] == "!":
            return qual[j]
    return qual[i]


def _last(qual: str, i: int) -> str:
    for j in range(i - 1, -1, -1):
        if qual[j] != qual[i] or qual[j] == "!":
            return qual[j]
    return qual[i]


@dataclass
class MobRead:
    name: str = ""
    chr: str = "*"
    flag: int = 0
    AS: int = 0
    seq: str = ""
    cigar: str = ""
    cigar_string: str = ""  # per-base expansion (MobRead::processCigar,
    # RUFUS.interpret.cpp:520-536) — consumed by MobAligneBases; without it
    # the orphan-MOB pass can never distinguish the element-aligned half

    def process_cigar(self):
        out = []
        num = ""
        for ch in self.cigar:
            if ch.isdigit():
                num += ch
            else:
                out.append(ch * int(num or 0))
                num = ""
        self.cigar_string = "".join(out)
        return self


class Context:
    """Shared interpret state (the reference's globals)."""

    def __init__(self, ref, model: DepthModel, hashlist, parent_hashes,
                 mutant_hashes, exclude_hashes, par_names, k: int,
                 min_map_qual: int = 10, max_variant_size: int = 1000):
        self.ref = ref  # FastaReference
        self.model = model
        self.hash = hashlist  # dict str->int (HashList, fwd-mostly)
        self.parent_hashes = parent_hashes  # list[dict int->int]
        self.mutant_hashes = mutant_hashes  # dict int->int
        self.exclude_hashes = exclude_hashes  # dict int->int
        self.par_names = par_names
        self.k = k
        self.min_map_qual = min_map_qual
        self.max_variant_size = max_variant_size
        self.par_low_cov_threshold = 7
        self.seg_threshold = 10
        self.seg_threshold_cigar = 10

    def pull_tables(self):
        """Cached sorted-array views of the subject/parent pull dicts for
        batched lookups; built on first contig, invalidated never (the
        dicts are load-once)."""
        if not hasattr(self, "_pull_tables"):
            self._pull_tables = (PullTable(self.mutant_hashes),
                                 [PullTable(p) for p in self.parent_hashes])
        return self._pull_tables

    def h2l(self, s: str) -> int:
        """String key for packed lookups; non-ACGT treated as A (the C++
        HashToLong skips invalid chars leaving 0 bits)."""
        v = 0
        for i, ch in enumerate(s):
            c = "ACGT".find(ch)
            if c >= 0:
                # reference packs LSB-first; only self-consistency matters
                v |= c << (2 * i)
        return v


class SamRead:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.name = ""
        self.flag = 0
        self.chr = "*"
        self.pos = 0
        self.map_qual = 0
        self.cigar = ""
        self.seq = ""
        self.qual = ""
        self.strands = ""
        self.forward = -1
        self.reverse = -1
        self.strand_bias = -1.0
        self.align_score = 0
        self.flag_bits = [False] * 16
        self.cigar_string = ""
        self.ref_seq = ""
        self.original_seq = ""
        self.original_qual = ""
        self.positions: list[int] = []
        self.chr_positions: list[str] = []
        self.peak_map: list[int] = []
        self.alignments: list[int] = []
        self.first = True
        self.parsed = False
        self.combined = False
        self.phase = "none"
        self.clip_pattern = ""
        self.mob_aligned = False
        self.mob_contig = ""
        self.mob_as = 0
        self.all_a = False
        self.sv_event_id = 0
        self.is_split_read = 0
        self.bnd_id = 0
        self.alignment_segments = 0
        self.alignment_segments_cigar = 0
        # per-column k-mer vectors
        self.hashes: list[str] = []
        self.hashes_ref: list[str] = []
        self.var_hash: list[bool] = []
        self.parent_counts: list[list[int]] = []
        self.parent_counts_ref: list[list[int]] = []
        self.mut_counts: list[int] = []
        self.mut_counts_ref: list[int] = []
        self.par_alt_counts: list[list[int]] = []
        self.par_ref_counts: list[list[int]] = []
        self.mut_hash_list_counts: list[int] = []
        self.mut_contig_counts: list[int] = []
        self.mut_alt_counts: list[int] = []
        self.mut_ref_counts: list[int] = []
        self.ref_kmers: list[str] = []
        self.alt_kmers: list[str] = []

    # -- parsing ------------------------------------------------------------

    def parse(self, line: str):
        t = line.rstrip("\n").split("\t")
        self.name = t[0]
        self.flag = int(t[1])
        self.chr = t[2]
        self.pos = int(t[3])
        self.map_qual = int(t[4])
        self.cigar = t[5]
        self.seq = t[9].upper()
        qual = t[10]
        if qual == "*":
            qual = "5" * len(self.seq)
        self.qual = qual
        self.process_cigar()
        t2 = self.name.split(":")
        if len(t2) >= 2:
            self.strands = t2[1]
            self.forward = int(t2[1]) if t2[1].lstrip("-").isdigit() else 0
            self.reverse = int(t2[2]) if len(t2) > 2 and t2[2].lstrip("-").isdigit() else 0
            if self.forward + self.reverse == 0:
                self.strand_bias = 1.0
            else:
                self.strand_bias = float(self.forward) / (self.forward + self.reverse)
        else:
            self.strands = ""
            self.strand_bias = -1.0
        self.align_score = 0
        for f in t[11:]:
            parts = f.split(":")
            if parts[0] == "AS":
                self.align_score = int(parts[2])
        for j in range(16):
            self.flag_bits[j] = bool(self.flag & (1 << j))

    def process_cigar(self):
        num = ""
        out = []
        for ch in self.cigar:
            if ch.isdigit():
                num += ch
            else:
                out.append(ch * int(num or 0))
                num = ""
        self.cigar_string = "".join(out)
        self.is_split_read = sum(1 for c in self.cigar_string if c in "HS")

    # -- reference expansion ------------------------------------------------

    def get_ref_seq(self):
        ctx = self.ctx
        self.original_seq = self.seq
        self.original_qual = self.qual
        if self.chr not in ctx.ref.seqs:
            return
        cs = self.cigar_string
        for i, ch in enumerate(cs):
            if ch != "H":
                self.pos -= i
                break
        for i, ch in enumerate(cs):
            if ch != "S":
                self.pos -= i
                break
        contig = ctx.ref.contig_array(self.chr)
        clen = len(contig)

        def ref_base(idx0):
            if 0 <= idx0 < clen:
                return chr(contig[idx0]).upper()
            return ""

        new_seq, new_qual, new_cigar, ref_seq = [], [], [], []
        new_pos, new_chr = [], []
        r_off = 0
        c_off = 0
        ins_off = 0
        for i, ch in enumerate(cs):
            if ch == "M":
                rb = ref_base(i + self.pos - 1 + r_off)
                ref_seq.append(rb)
                sb = self.seq[i - c_off]
                new_seq.append(sb)
                new_qual.append(self.qual[i - c_off])
                new_pos.append(self.pos + i - ins_off)
                new_chr.append(self.chr)
                new_cigar.append("M" if rb == sb else "X")
            elif ch == "I":
                ref_seq.append("-")
                r_off -= 1
                new_seq.append(self.seq[i - c_off])
                new_qual.append(self.qual[i - c_off])
                new_cigar.append("I")
                ins_off += 1
                new_pos.append(self.pos + i - ins_off)
                new_chr.append(self.chr)
            elif ch == "D":
                new_seq.append("-")
                new_qual.append(" ")
                c_off += 1
                ref_seq.append(ref_base(i + self.pos - 1 + r_off))
                new_cigar.append("D")
                new_pos.append(self.pos + i - ins_off)
                new_chr.append(self.chr)
            elif ch == "H":
                ref_seq.append("H")
                new_seq.append("H")
                new_qual.append(" ")
                c_off += 1
                new_cigar.append("H")
                new_pos.append(-1)
                new_chr.append("nope")
            elif ch == "S":
                ref_seq.append("-")
                new_seq.append(self.seq[i - c_off])
                new_qual.append(self.qual[i - c_off])
                new_cigar.append("S")
                new_pos.append(self.pos + i - ins_off)
                new_chr.append(self.chr)
        self.seq = "".join(new_seq)
        self.cigar_string = "".join(new_cigar)
        self.ref_seq = "".join(ref_seq)
        q = []
        last_q = " "
        for i, ch in enumerate(new_qual):
            if ch == " ":
                q.append(last_q if self.cigar_string[i] == "D" else "!")
            else:
                q.append(ch)
                last_q = ch
        self.qual = "".join(q)
        self.positions = new_pos
        self.chr_positions = new_chr
        self.look_up_kmers()
        self.count_alignment_segments()
        self.count_alignment_segments_cigar()

    # -- k-mer vectors ------------------------------------------------------

    def look_up_kmers(self):
        """Per-base alt/ref k-mer counts vs subject+parent tables
        (LookUpKmers, 3168-3270) — BATCHED: one vectorized hash_columns
        pass per contig + one searchsorted per (table, strand) instead of
        per-position dict probes. Output lists are element-identical to
        the scalar formulation (tested)."""
        ctx = self.ctx
        k = ctx.k
        mut_t, par_ts = ctx.pull_tables()
        alt_strs, alt_keys, alt_ok = hash_columns(self.seq, k)
        ref_strs, ref_keys, ref_ok = hash_columns(self.ref_seq, k)
        n = len(self.seq)
        self.alt_kmers = alt_strs
        self.ref_kmers = ref_strs
        same = np.fromiter((a == b for a, b in zip(alt_strs, ref_strs)),
                           bool, n)

        mh_c, mh_f = mut_t.get_many(alt_keys)
        contig = np.where(mh_f, mh_c * np.where(same, -1, 1), 0)
        self.mut_contig_counts = np.where(alt_ok, contig, -3).tolist()
        alt_c = np.where(mh_f, mh_c, -1)
        self.mut_alt_counts = np.where(
            alt_ok, np.where(same, 0, alt_c), -3).tolist()
        self.par_alt_counts = []
        for pt in par_ts:
            pc, pf = pt.get_many(alt_keys)
            pa = np.where(pf, pc, -1)
            self.par_alt_counts.append(np.where(
                alt_ok, np.where(same, 0, pa), -3).tolist())
        hl = ctx.hash
        self.mut_hash_list_counts = [
            (hl.get(h, -1) if ok else -3)
            for h, ok in zip(alt_strs, alt_ok.tolist())]

        rh_c, rh_f = mut_t.get_many(ref_keys)
        self.mut_ref_counts = np.where(
            ref_ok, np.where(rh_f, rh_c, -1), -3).tolist()
        self.par_ref_counts = []
        for pt in par_ts:
            pc, pf = pt.get_many(ref_keys)
            self.par_ref_counts.append(np.where(
                ref_ok, np.where(pf, pc, -1), -3).tolist())

    def build_up_hash_count_table(self):
        """BuildUpHashCountTable (1425-1565): k-mers built by skipping D/R/H
        columns (both seq and ref walk the same columns)."""
        ctx = self.ctx
        k = ctx.k
        self.hashes = []
        self.hashes_ref = []
        self.var_hash = []
        self.parent_counts = [[] for _ in ctx.parent_hashes]
        self.parent_counts_ref = [[] for _ in ctx.parent_hashes]
        self.mut_counts = []
        self.mut_counts_ref = []
        n = len(self.seq)
        cs = self.cigar_string
        for i in range(0, n - k):
            nh = [self.seq[i]]
            nr = [self.ref_seq[i]]
            if cs[i] not in "DRH":
                count = 0
                j = 1
                while j < n - i and count < k - 1:
                    if cs[i + j] not in "DRH":
                        nh.append(self.seq[i + j])
                        nr.append(self.ref_seq[i + j])
                        count += 1
                    j += 1
            h = "".join(nh)
            r = "".join(nr)
            self.hashes.append(h)
            self.hashes_ref.append(r)
            self.var_hash.append(h in ctx.hash or codec.revcomp_str(h) in ctx.hash)
        for pi, ph in enumerate(ctx.parent_hashes):
            for i in range(len(self.hashes)):
                h, r = self.hashes[i], self.hashes_ref[i]
                if all(c in "ACGT" for c in h[:k]) and len(h) >= k:
                    self.parent_counts[pi].append(ph.get(ctx.h2l(h), 0))
                    self.parent_counts_ref[pi].append(ph.get(ctx.h2l(r), 0))
                else:
                    self.parent_counts[pi].append(-1)
                    self.parent_counts_ref[pi].append(-1)
        mh = ctx.mutant_hashes
        for i in range(len(self.hashes)):
            h, r = self.hashes[i], self.hashes_ref[i]
            if all(c in "ACGT" for c in h[:k]) and len(h) >= k:
                self.mut_counts.append(mh.get(ctx.h2l(h), 0))
                self.mut_counts_ref.append(mh.get(ctx.h2l(r), 0))
            else:
                self.mut_counts.append(-1)
                self.mut_counts_ref.append(-1)

    # -- peak map / stats ---------------------------------------------------

    def create_peak_map(self):
        q = self.qual
        pm = []
        for i in range(len(q) - 1):
            if q[i] <= "!":
                pm.append(0)
            else:
                pm.append(1 if q[i] >= _last(q, i) and q[i] >= _next(q, i) else 0)
        pm.append(0)
        self.peak_map = pm

    def count_alignment_segments(self):
        self.alignment_segments = 0
        cs = self.cigar_string
        if not cs:
            return
        last = cs[0]
        for ch in cs[1:]:
            if ch == "M":
                pass
            elif last == "M":
                self.alignment_segments += 1
            last = ch
        if last == "M":
            self.alignment_segments += 1

    def count_alignment_segments_cigar(self):
        self.alignment_segments_cigar = 0
        cg = self.cigar
        if not cg:
            return
        last = cg[0]
        ops = "MSHDI"
        for ch in cg[1:]:
            if ch in ops:
                pass
            elif last in ops:
                self.alignment_segments_cigar += 1
            last = ch
        if last in ops:
            self.alignment_segments_cigar += 1

    def check_bases_aligned(self):
        longest = count = 0
        for ch in self.cigar_string:
            if ch not in "HS":
                count += 1
            else:
                longest = max(longest, count)
                count = 0
        return max(longest, count)

    def check_ends_align(self):
        cs = self.cigar_string
        start_align = 0
        for j in range(10, len(cs)):
            if cs[j] not in "HS":
                start_align += 1
            else:
                break
        end_align = 0
        for i in range(len(cs) - 10, -1, -1):
            if i < 0:
                break
            if cs[i] not in "HS":
                end_align += 1
            else:
                break
        return start_align > 20 or end_align > 20

    def check_mob(self, mobs: dict):
        if self.name in mobs:
            self.mob_aligned = True
            self.mob_contig = mobs[self.name].chr
            self.mob_as = mobs[self.name].AS

    def clip_pattern_str(self):
        cs = self.cigar_string
        if not cs:
            return ""
        pattern = []
        last = "c" if cs[0] in "HS" else "m"
        count = 1
        for ch in cs[1:]:
            cur = "c" if ch in "HS" else "m"
            if cur == last:
                count += 1
            else:
                if count > 10:
                    pattern.append(last)
                last = cur
                count = 1
        if count > 10:
            pattern.append(last)
        return "".join(pattern)

    def check_phase(self):
        ctx = self.ctx
        if len(self.par_alt_counts) < 2:
            return
        phased = [0, 0]
        pa0, pa1 = self.par_alt_counts[0], self.par_alt_counts[1]
        pr0, pr1 = self.par_ref_counts[0], self.par_ref_counts[1]
        mc = self.mut_contig_counts
        for i in range(len(self.seq)):
            ok = pa0[i] >= 0 and pa1[i] >= 0 and pr0[i] >= 0 and pr1[i] >= 0
            if pa0[i] == 0 and pa1[i] > 3 and mc[i] > 2 and ok:
                phased[1] += 1
            elif pa0[i] > 3 and pa1[i] == 0 and mc[i] > 2 and ok:
                phased[0] += 1
            elif pr0[i] == 0 and pr1[i] > 3 and mc[i] < -2 and ok:
                phased[1] += 1
            elif pr0[i] > 3 and pr1[i] == 0 and mc[i] < -2 and ok:
                phased[0] += 1
        if phased[0] > 0 and phased[1] == 0:
            self.phase = f"PHASED-{phased[0]}-{ctx.par_names[0]}"
        elif phased[0] == 0 and phased[1] > 0:
            self.phase = f"PHASED-{phased[1]}-{ctx.par_names[1]}"
        elif phased[0] > 0 and phased[1] > 0:
            self.phase = f"ConflictingPHASED-{phased[1]}-{phased[0]}"

    def get_supporting_hash_count(self, pos: int, alt: str, reff: str) -> int:
        ctx = self.ctx
        count = 0
        lower = max(0, pos - ctx.k)
        upper = min(pos + len(alt) + len(reff), len(self.mut_ref_counts))
        for j in range(lower, upper):
            ak = self.alt_kmers[j]
            if ctx.hash.get(ak, 0) > 0:
                count += 1
            elif ctx.hash.get(codec.revcomp_str(ak), 0) > 0:
                count += 1
        return count

    def get_modes_exome(self, pos, alt, reff):
        """GetModes (1916-2060): min/median-based modes, exome path.

        Returns (mut_ref_mode, mut_alt_mode, par_ref_modes, par_alt_modes,
        hash_counts, hash_counts_og, possible)."""
        ctx = self.ctx
        k = ctx.k
        lower = max(0, pos - k + 1)
        upper = min(pos + len(alt) + len(reff) - 1, len(self.mut_ref_counts))
        n_par = len(ctx.parent_hashes)
        var_mut_ref, var_mut_alt = [], []
        var_par_ref = [[] for _ in range(n_par)]
        var_par_alt = [[] for _ in range(n_par)]
        hash_counts, hash_counts_og = [], []
        possible = 0
        last_alt = "boomba"
        ex = ctx.exclude_hashes
        for j in range(lower, upper):
            ak, rk = self.alt_kmers[j], self.ref_kmers[j]
            ak_rc = codec.revcomp_str(ak)
            differ = ak != rk
            not_excluded = (ex.get(ctx.h2l(ak), 0) < 1
                            and ex.get(ctx.h2l(ak_rc), 0) < 1)
            if differ and not_excluded and ak != last_alt:
                possible += 1
            last_alt = ak
            if 0 < self.mut_ref_counts[j] < 400 and differ:
                var_mut_ref.append(self.mut_ref_counts[j])
            if (0 < self.mut_alt_counts[j] < 400 and differ
                    and (ak in ctx.hash or ak_rc in ctx.hash) and not_excluded):
                var_mut_alt.append(self.mut_alt_counts[j])
            rk_rc = codec.revcomp_str(rk)
            ref_not_excluded = (ex.get(ctx.h2l(rk), 0) < 1
                                and ex.get(ctx.h2l(rk_rc), 0) < 1)
            for pi in range(n_par):
                if 0 < self.par_ref_counts[pi][j] < 400 and differ:
                    var_par_ref[pi].append(self.par_ref_counts[pi][j])
                if (0 < self.par_alt_counts[pi][j] < 400 and differ
                        and (ak in ctx.hash or ak_rc in ctx.hash)
                        and ref_not_excluded):
                    var_par_alt[pi].append(self.par_alt_counts[pi][j])
            if ctx.hash.get(ak, 0) > 0 and differ:
                hash_counts_og.append(ctx.hash[ak])
            elif ctx.hash.get(ak_rc, 0) and differ:
                hash_counts_og.append(ctx.hash[ak_rc])
            if ctx.hash.get(ak, 0) > 0 and differ:
                hash_counts.append(ctx.hash[ak])
            elif ctx.hash.get(ak_rc, 0) > 0 and differ:
                hash_counts.append(ctx.hash[ak_rc])
            else:
                hash_counts.append(-1)
        var_mut_ref.sort()
        var_mut_alt.sort()
        for v in var_par_ref:
            v.sort()
        for v in var_par_alt:
            v.sort()

        def mode_of(v, alt_style=False):
            if len(v) > 1:
                return v[(len(v) - 2) // 2] if alt_style else v[len(v) // 2]
            if len(v) == 1:
                return v[0]
            return 0

        mut_ref_mode = mode_of(var_mut_ref)
        mut_alt_mode = mode_of(var_mut_alt, alt_style=True)
        par_ref_modes = [mode_of(v) for v in var_par_ref]
        par_alt_modes = [mode_of(v) for v in var_par_alt]
        return (mut_ref_mode, mut_alt_mode, par_ref_modes, par_alt_modes,
                hash_counts, hash_counts_og, possible)

    def get_modes3(self, pos, alt, reff, ref_counts, alt_counts):
        """GetModes3 (1809-1864) -> (hash_counts, possible_var_kmer,
        genotype, ref_count, alt_count)."""
        ctx = self.ctx
        k = ctx.k
        lower = max(0, pos - k + 1)
        upper = pos + len(alt) + len(reff) - 1
        if upper > len(ref_counts):
            upper = len(ref_counts)
        var_ref = []
        var_alt = []
        hash_counts = []
        possible = 0
        last_alt = "boomba"
        ex = ctx.exclude_hashes
        for j in range(lower, upper):
            ak, rk = self.alt_kmers[j], self.ref_kmers[j]
            if (ak != rk and ex.get(ctx.h2l(ak), 0) < 1
                    and ex.get(ctx.h2l(codec.revcomp_str(ak)), 0) < 1
                    and ak != last_alt):
                possible += 1
            last_alt = ak
            if ref_counts[j] > 0 and ak != rk:
                var_ref.append(ref_counts[j])
            if (alt_counts[j] > 0 and ak != rk
                    and (ak in ctx.hash or codec.revcomp_str(ak) in ctx.hash)
                    and ex.get(ctx.h2l(ak), 0) < 1
                    and ex.get(ctx.h2l(codec.revcomp_str(ak)), 0) < 1):
                var_alt.append(alt_counts[j])
            if ctx.hash.get(ak, 0) > 0 and ak != rk:
                hash_counts.append(ctx.hash.get(ak))
            elif ctx.hash.get(codec.revcomp_str(ak), 0) > 0 and ak != rk:
                hash_counts.append(ctx.hash.get(codec.revcomp_str(ak)))
            else:
                hash_counts.append(-1)
        var_ref.sort()
        var_alt.sort()
        alt_g, alt_count = baysean_genotyper(ctx.model, var_alt, "1")
        ref_g, ref_count = baysean_genotyper(ctx.model, var_ref, "0")
        genotype = parse_genotype(alt_g, ref_g)
        return hash_counts, possible, genotype, ref_count, alt_count
