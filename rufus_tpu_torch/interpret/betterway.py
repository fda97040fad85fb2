"""BetterWay: merge a split-aligned contig pair into one call-ready read.

Re-derivation of RUFUS.interpret.cpp BetterWay (3404-4418), findBreak
(3358-3404) and flipRead (2178-2244). Two alignments of the same contig
are column-aligned (inserting 'R' gap columns where only one has a
deletion), then walked to synthesize one read whose gap between the two
alignments becomes D (deletion) or Y (tandem-dup/insertion) columns; the
result feeds parseMutations like any single alignment. Literal quirks
kept:

* the first D-check tests B's cigar at index ACOUNT (3450);
* the A-branch deletion fill reads the reference at column index i, not
  the genome position j (3707) — the filled NewRef bases are wrong there
  in the reference too;
* `reads[A].phase == reads[B].phase` is a comparison, not an assignment
  (4404) — phase is NOT propagated;
* opposite-strand pairs mark inversion breakpoints with 'U' columns and
  return an uncombined read.
"""

from __future__ import annotations

from .samread import SamRead


def find_break(read: SamRead) -> int:
    cs = read.cigar_string
    if not cs:
        return -1
    if cs[0] in "HS":
        for i in range(len(read.seq)):
            if cs[i] not in "HS":
                return i
    else:
        for i in range(len(read.seq) - 1, -1, -1):
            if cs[i] not in "HS":
                return i
    return -1


def flip_read(read: SamRead):
    n = len(read.seq)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N", "-": "-",
            "H": "H"}
    read.qual = read.qual[::-1]
    read.cigar_string = read.cigar_string[::-1]
    read.strands = "-" * n
    read.positions = read.positions[::-1]
    read.chr_positions = read.chr_positions[::-1]
    read.peak_map = read.peak_map[::-1]
    read.seq = "".join(comp.get(c, "N") for c in reversed(read.seq))
    read.ref_seq = "".join(comp.get(c, "N") for c in reversed(read.ref_seq))
    read.clip_pattern = read.clip_pattern[::-1]


class AuxOutputs:
    """File sinks for the SV side outputs (BEDBigStuff, Translocations...)."""

    def __init__(self, big=None, not_handled=None, inversions=None,
                 translocations=None, translocations_bed=None, unaligned=None):
        import io as _io

        def f(x):
            return x if x is not None else _io.StringIO()

        self.big = f(big)
        self.not_handled = f(not_handled)
        self.inversions = f(inversions)
        self.translocations = f(translocations)
        self.translocations_bed = f(translocations_bed)
        self.unaligned = f(unaligned)


def _write_read(read: SamRead, out):
    out.write(f"{read.name}\n{read.chr}\t{read.pos}\t{read.map_qual}\t"
              f"{read.cigar}\n{read.seq}\n{read.qual}\n")


def _orientation(flag: int) -> bool:
    return bool(flag & 0x10)


def better_way(pair, aux: AuxOutputs, max_variant_size: int = 1000) -> SamRead:
    A, B = 0, 1
    reads = pair  # list of two SamRead (copies managed by caller)
    ctx = reads[A].ctx
    ref = ctx.ref

    if _orientation(reads[A].flag) != _orientation(reads[B].flag):
        flip_read(reads[B])

    new_seqs = ["", ""]
    new_quals = ["", ""]
    new_refs = ["", ""]
    new_cigars = ["", ""]
    align_pos: list[list[int]] = []
    align_chr: list[list[str]] = []
    a_last_ref, a_last_chr = -1, "nope"
    b_last_ref, b_last_chr = -1, "nope"
    ns = [list(), list()]
    nq = [list(), list()]
    nr = [list(), list()]
    nc = [list(), list()]
    ac = bc = 0
    csA, csB = reads[A].cigar_string, reads[B].cigar_string
    while ac < len(csA) and bc < len(csB):
        cur_pos: list[int] = []
        cur_chr: list[str] = []
        # NOTE: B's char tested at index ac (reference quirk, 3450)
        b_at_ac = csB[ac] if ac < len(csB) else "?"
        if csA[ac] == "D" and b_at_ac != "D":
            cur_pos += [reads[A].positions[ac], -1]
            cur_chr += [reads[A].chr_positions[ac], "nope"]
            a_last_ref = reads[A].positions[ac]
            a_last_chr = reads[A].chr_positions[ac]
            ns[A].append(reads[A].seq[ac]); nq[A].append(reads[A].qual[ac])
            nr[A].append(reads[A].ref_seq[ac]); nc[A].append(csA[ac])
            ac += 1
            ns[B].append("-"); nq[B].append("!")
            nr[B].append("-"); nc[B].append("R")
        elif csA[ac] != "D" and csB[bc] == "D":
            cur_pos += [-1, reads[B].positions[bc]]
            cur_chr += ["nope", reads[B].chr_positions[bc]]
            b_last_ref = reads[B].positions[bc]
            b_last_chr = reads[B].chr_positions[bc]
            ns[B].append(reads[B].seq[bc]); nq[B].append(reads[B].qual[bc])
            nr[B].append(reads[B].ref_seq[bc]); nc[B].append(csB[bc])
            bc += 1
            ns[A].append("-"); nq[A].append("!")
            nr[A].append("-"); nc[A].append("R")
        else:
            if csA[ac] in "HS":
                cur_pos.append(-1); cur_chr.append("nope")
                ns[A].append(reads[A].seq[ac]); nq[A].append(reads[A].qual[ac])
                nr[A].append(reads[A].ref_seq[ac]); nc[A].append(csA[ac])
                ac += 1
            elif csA[ac] in "MXD":
                cur_pos.append(reads[A].positions[ac])
                cur_chr.append(reads[A].chr_positions[ac])
                a_last_ref = reads[A].positions[ac]
                a_last_chr = reads[A].chr_positions[ac]
                ns[A].append(reads[A].seq[ac]); nq[A].append(reads[A].qual[ac])
                nr[A].append(reads[A].ref_seq[ac]); nc[A].append(csA[ac])
                ac += 1
            elif csA[ac] == "I":
                cur_pos.append(a_last_ref); cur_chr.append(a_last_chr)
                ns[A].append(reads[A].seq[ac]); nq[A].append(reads[A].qual[ac])
                nr[A].append(reads[A].ref_seq[ac]); nc[A].append(csA[ac])
                ac += 1
            if csB[bc] in "HS":
                cur_pos.append(-1); cur_chr.append("nope")
                ns[B].append(reads[B].seq[bc]); nq[B].append(reads[B].qual[bc])
                nr[B].append(reads[B].ref_seq[bc]); nc[B].append(csB[bc])
                bc += 1
            elif csB[bc] in "MXD":
                cur_pos.append(reads[B].positions[bc])
                cur_chr.append(reads[B].chr_positions[bc])
                b_last_ref = reads[B].positions[bc]
                b_last_chr = reads[B].chr_positions[bc]
                ns[B].append(reads[B].seq[bc]); nq[B].append(reads[B].qual[bc])
                nr[B].append(reads[B].ref_seq[bc]); nc[B].append(csB[bc])
                bc += 1
            elif csB[bc] == "I":
                cur_pos.append(b_last_ref); cur_chr.append(b_last_chr)
                ns[B].append(reads[B].seq[bc]); nq[B].append(reads[B].qual[bc])
                nr[B].append(reads[B].ref_seq[bc]); nc[B].append(csB[bc])
                bc += 1
        align_pos.append(cur_pos)
        align_chr.append(cur_chr)

    for i in (A, B):
        reads[i].seq = "".join(ns[i])
        reads[i].qual = "".join(nq[i])
        reads[i].ref_seq = "".join(nr[i])
        reads[i].cigar_string = "".join(nc[i])
        reads[i].positions = [row[i] if i < len(row) else -1 for row in align_pos]
        reads[i].chr_positions = [row[i] if i < len(row) else "nope" for row in align_chr]

    # find first aligned base
    base = 0
    last_pos, last_chr = -1, "nope"
    found = False
    while not found and base < len(align_pos):
        for i in (A, B):
            if i < len(align_pos[base]) and align_pos[base][i] > -1:
                last_pos = align_pos[base][i]
                last_chr = align_chr[base][i]
                found = True
                break
        if not found:
            base += 1

    new_cigar, new_seq, new_qual, new_ref = [], [], [], []
    new_pos, new_chr = [], []
    for i in range(base):
        new_cigar.append(reads[A].cigar_string[i])
        new_seq.append(reads[A].seq[i])
        new_qual.append(reads[A].qual[i])
        new_ref.append(reads[A].ref_seq[i])
        new_pos.append(reads[A].positions[i])
        new_chr.append(reads[A].chr_positions[i])

    # unify quals: pick the qual of the last read with no H in RefSeq
    best_qual = reads[0].qual
    for i in (A, B):
        if "H" not in reads[i].ref_seq:
            best_qual = reads[i].qual
    for i in (A, B):
        reads[i].qual = best_qual
        reads[i].create_peak_map()

    last_q = " "

    def ref_base(chrom, idx0):
        try:
            arr = ref.contig_array(chrom)
        except KeyError:
            return "N"
        if 0 <= idx0 < len(arr):
            return chr(arr[idx0]).upper()
        return "N"

    def peaks_ok():
        ab = find_break(reads[A])
        bb = find_break(reads[B])
        return (ab > 0 and bb > 0
                and (reads[A].peak_map[ab] == 1 or reads[A].peak_map[ab - 1] == 1)
                and (reads[B].peak_map[bb] == 1 or reads[B].peak_map[bb - 1] == 1)), ab, bb

    def write_transloc(tag, dist):
        ok, ab, bb = peaks_ok()
        if ok:
            aux.translocations.write(f"{tag} {dist}\n")
            _write_read(reads[A], aux.translocations)
            _write_read(reads[B], aux.translocations)
            aux.translocations.write("\n\n")
            aux.translocations_bed.write(
                f"{reads[A].chr}\t{reads[A].positions[ab] - 200}\t"
                f"{reads[A].positions[ab] + 200}\n{reads[B].chr}\t"
                f"{reads[B].positions[bb] - 200}\t{reads[B].positions[bb] + 200}\n")

    same_strand = _orientation(reads[A].flag) == _orientation(reads[B].flag)
    if same_strand:
        i = base
        n = len(reads[A].seq)
        while i < n:
            if reads[A].positions[i] > -1:
                delta = reads[A].positions[i] - last_pos
                if delta > 1:
                    if (reads[A].chr == reads[B].chr
                            and abs(delta) <= max_variant_size + 1000):
                        aux.big.write(f"{reads[A].chr}\t{last_pos}\t"
                                      f"{reads[A].positions[i]}\tDeletion\n")
                        for j in range(last_pos, reads[A].positions[i] - 1):
                            new_cigar.append("D")
                            new_seq.append("-")
                            new_qual.append(last_q)
                            # reference quirk: reads ref at column index i
                            new_ref.append(ref_base(reads[A].chr, i))
                            new_pos.append(j)
                            new_chr.append(reads[A].chr_positions[i])
                    elif (reads[A].chr == reads[B].chr
                          and abs(delta) >= max_variant_size + 1000):
                        write_transloc("Too Big, Same strand and chr", abs(delta))
                    elif ((reads[A].chr == "hs37d5") != (reads[B].chr == "hs37d5")):
                        write_transloc("Possible mob event", abs(delta))
                    else:
                        write_transloc("Translocataion, same strand", abs(delta))
                elif delta < 0 and abs(delta) <= max_variant_size + 1000:
                    if reads[A].chr == reads[B].chr:
                        aux.big.write(f"{reads[A].chr}\t{reads[A].positions[i]}\t"
                                      f"{last_pos}\tTandemDup\n")
                        j = i
                        while j < len(reads[A].seq) and reads[A].positions[j] < last_pos:
                            new_cigar.append("Y")
                            new_seq.append(reads[A].seq[j])
                            new_qual.append(reads[A].qual[j])
                            new_ref.append("-")
                            new_pos.append(reads[A].positions[i])
                            new_chr.append(reads[A].chr_positions[i])
                            j += 1
                        i = j
                        k = len(reads[A].positions) - 1
                        while k >= 0 and reads[A].positions[k] + 1 <= 1:
                            k -= 1
                        for j in range(reads[A].positions[k] + 1, last_pos):
                            new_cigar.append("Y")
                            new_seq.append(ref_base(reads[A].chr, j))
                            new_qual.append("!")
                            new_ref.append("-")
                            new_pos.append(j)
                            new_chr.append(reads[A].chr)
                    elif ((reads[A].chr == "hs37d5") != (reads[B].chr == "hs37d5")):
                        write_transloc("Possible mob event", abs(delta))
                        write_transloc("Translocation, same strand", abs(delta))
                    else:
                        write_transloc("Translocation, same strand", abs(delta))
                elif delta < 0 and abs(delta) >= max_variant_size + 1000:
                    tag = ("TOO BIG 3" if reads[A].chr == reads[B].chr
                           else "Translocation 3")
                    write_transloc(tag, abs(delta))
                if i < len(reads[A].cigar_string):
                    new_cigar.append(reads[A].cigar_string[i])
                    new_seq.append(reads[A].seq[i])
                    new_qual.append(reads[A].qual[i])
                    new_ref.append(reads[A].ref_seq[i])
                    new_pos.append(reads[A].positions[i])
                    new_chr.append(reads[A].chr_positions[i])
                    last_q = reads[A].qual[i]
                    last_pos = reads[A].positions[i]
                    last_chr = reads[A].chr_positions[i]
            elif reads[B].positions[i] > -1:
                delta = reads[B].positions[i] - last_pos
                if delta > 1:
                    if (reads[B].chr == reads[A].chr
                            and abs(delta) <= max_variant_size + 1000):
                        aux.big.write(f"{reads[B].chr}\t{last_pos}\t"
                                      f"{reads[B].positions[i]}\tDeletion\n")
                        for j in range(last_pos, reads[B].positions[i] - 1):
                            new_cigar.append("D")
                            new_seq.append("-")
                            new_qual.append(last_q)
                            new_ref.append(ref_base(reads[B].chr, j))
                            new_pos.append(j)
                            new_chr.append(reads[B].chr_positions[i])
                    elif (reads[A].chr == reads[B].chr
                          and abs(delta) >= max_variant_size + 1000):
                        write_transloc("TOO BIG 2", abs(delta))
                    elif ((reads[A].chr == "hs37d5") != (reads[B].chr == "hs37d5")):
                        write_transloc("Possible mob event", abs(delta))
                    else:
                        write_transloc("Translocation 2", abs(delta))
                elif delta < 0 and abs(delta) < max_variant_size + 1000:
                    if reads[B].chr == reads[A].chr:
                        aux.big.write(f"{reads[B].chr}\t{reads[B].positions[i]}\t"
                                      f"{last_pos}\tTandemDup\n")
                        j = i
                        while j < len(reads[B].seq) and reads[B].positions[j] <= last_pos:
                            new_cigar.append("Y")
                            new_seq.append(reads[B].seq[j])
                            new_qual.append(reads[B].qual[j])
                            new_ref.append("-")
                            new_pos.append(reads[B].positions[i])
                            new_chr.append(reads[B].chr_positions[i])
                            j += 1
                        i = j
                        k = len(reads[B].positions) - 1
                        while k >= 0 and reads[B].positions[k] + 1 <= 1:
                            k -= 1
                        for j in range(reads[B].positions[k] + 1, last_pos):
                            new_cigar.append("Y")
                            new_seq.append(ref_base(reads[B].chr, j))
                            new_qual.append("!")
                            new_ref.append("-")
                            new_pos.append(j)
                            new_chr.append(reads[B].chr)
                elif delta < 0 and abs(delta) >= max_variant_size + 1000:
                    write_transloc("TOO BIG 1", abs(delta))
                if i < len(reads[B].cigar_string):
                    new_cigar.append("M")
                    new_seq.append(reads[B].seq[i])
                    new_qual.append(reads[B].qual[i])
                    new_ref.append(reads[B].ref_seq[i])
                    new_pos.append(reads[B].positions[i])
                    new_chr.append(reads[B].chr_positions[i])
                    last_q = reads[B].qual[i]
                    last_pos = reads[B].positions[i]
                    last_chr = reads[B].chr_positions[i]
            else:
                if reads[A].cigar_string[i] == "S":
                    src = reads[A]
                elif reads[B].cigar_string[i] == "S":
                    src = reads[B]
                else:
                    src = None
                if src is not None:
                    new_cigar.append(src.cigar_string[i])
                    new_seq.append(src.seq[i])
                    new_qual.append(src.qual[i])
                    new_ref.append(src.ref_seq[i])
                    new_pos.append(src.positions[i])
                    new_chr.append(src.chr_positions[i])
            i += 1

        # fix internal S bases -> I
        cig = "".join(new_cigar)
        first = next((i for i, c in enumerate(cig) if c not in "SH"), -1)
        last = next((i for i in range(len(cig) - 1, -1, -1) if cig[i] not in "SH"), -1)
        nn = []
        for i, c in enumerate(cig):
            if first < i < last and c in "SH":
                nn.append("I")
            else:
                nn.append(c)
        cig = "".join(nn)
        unaligned = sum(1 for c in cig if c in "HS")
        if unaligned < 150:
            reads[A].first = True
            reads[A].cigar_string = cig
            reads[A].seq = "".join(new_seq)
            reads[A].qual = "".join(new_qual)
            reads[A].ref_seq = "".join(new_ref)
            reads[A].positions = list(new_pos)
            reads[A].chr_positions = list(new_chr)
            reads[A].combined = True
            reads[B].combined = True
    else:
        if reads[A].chr == reads[B].chr:
            ok, ab, bb = peaks_ok()
            if ok:
                aux.translocations.write("INVERSION\n")
                _write_read(reads[A], aux.translocations)
                _write_read(reads[B], aux.translocations)
                aux.translocations.write("\n\n")
                aux.translocations_bed.write(
                    f"{reads[A].chr}\t{reads[A].positions[ab] - 200}\t"
                    f"{reads[A].positions[ab] + 200}\n{reads[B].chr}\t"
                    f"{reads[B].positions[bb] - 200}\t{reads[B].positions[bb] + 200}\n")
            a_cig, b_cig = [], []
            for i in range(len(reads[A].seq)):
                ab_c = reads[A].cigar_string[i]
                bb_c = reads[B].cigar_string[i] if i < len(reads[B].cigar_string) else "?"
                if ab_c in "MX" and bb_c in "SH":
                    bb_c = "U"
                if (bb_c in "MX") and ab_c in "SH":
                    ab_c = "U"
                a_cig.append(ab_c)
                b_cig.append(bb_c)
            reads[A].cigar_string = "".join(a_cig)
            reads[B].cigar_string = "".join(b_cig)
        elif (reads[A].chr == "hs37d5") != (reads[B].chr == "hs37d5"):
            ok, ab, bb = peaks_ok()
            if ok:
                aux.translocations.write("mobil elemnt inverted\n")
                _write_read(reads[A], aux.translocations)
                _write_read(reads[B], aux.translocations)
                aux.translocations.write("\n\n")
                aux.translocations_bed.write(
                    f"{reads[A].chr}\t{reads[A].positions[ab] - 200}\t"
                    f"{reads[A].positions[ab] + 200}\n{reads[B].chr}\t"
                    f"{reads[B].positions[bb] - 200}\t{reads[B].positions[bb] + 200}\n")
        else:
            ok, ab, bb = peaks_ok()
            if ok:
                aux.translocations.write("we got a translocation and invertion\n")
                _write_read(reads[A], aux.translocations)
                _write_read(reads[B], aux.translocations)
                aux.translocations.write("\n\n")
                aux.translocations_bed.write(
                    f"{reads[A].chr}\t{reads[A].positions[ab] - 200}\t"
                    f"{reads[A].positions[ab] + 200}\n{reads[B].chr}\t"
                    f"{reads[B].positions[bb] - 200}\t{reads[B].positions[bb] + 200}\n")
        aux.not_handled.write("Different strands\n")
        aux.not_handled.write(f"{reads[A].chr}\t{reads[A].pos}\t"
                              f"{reads[A].pos + len(reads[A].seq)}\t"
                              f"{reads[A].name}\t{reads[A].cigar}\n")
        _write_read(reads[A], aux.not_handled)
        aux.not_handled.write(f"{reads[B].chr}\t{reads[B].pos}\t"
                              f"{reads[B].pos + len(reads[B].seq)}\t"
                              f"{reads[B].name}\t{reads[B].cigar}\n")
        _write_read(reads[B], aux.not_handled)
        aux.not_handled.write("\n\n")
        aux.inversions.write(f"{reads[A].chr}\t{reads[A].pos}\t{reads[B].pos}\t"
                             f"{reads[B].pos - reads[A].pos}\n")

    # phase propagation is a no-op in the reference (== instead of =)
    reads[A].look_up_kmers()
    return reads[A]
