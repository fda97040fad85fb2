"""Reconstruct a reference FASTA from a BWA index (.pac/.ann/.amb).

The repo's test reference ships only as a BWA index (the .fa itself is
fetched at install time in the reference pipeline); since this framework
implements its own aligner, we reconstruct the sequence from the 2-bit
.pac: base l lives at bits ((3 - l%4)*2) of byte l>>2 with codes
A=0,C=1,G=2,T=3, and .amb holes restore the N runs (BWA bntseq.c layout).
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)


def load_pac_reference(prefix: str) -> dict[str, np.ndarray]:
    """prefix = path of the original .fa; returns {contig: uint8 ASCII}."""
    with open(prefix + ".ann") as f:
        l_pac, n_seqs, _n_holes = (int(x) for x in f.readline().split())
        seqs = []
        for _ in range(n_seqs):
            f.readline()  # gi name comment
            off, length, _namb = (int(x) for x in f.readline().split())
            seqs.append((off, length))
        names = []
    with open(prefix + ".ann") as f:
        f.readline()
        for _ in range(n_seqs):
            names.append(f.readline().split()[1])
            f.readline()

    pac = np.fromfile(prefix + ".pac", dtype=np.uint8)
    # last byte holds l_pac % 4; drop it (and a possibly pad byte)
    bases_per_file = (l_pac + 3) // 4
    pac = pac[:bases_per_file]
    codes = np.zeros(bases_per_file * 4, dtype=np.uint8)
    for j in range(4):
        codes[j::4] = (pac >> (2 * (3 - j))) & 3
    codes = codes[:l_pac]
    ascii_all = _BASES[codes]

    with open(prefix + ".amb") as f:
        _, _, n_holes = (int(x) for x in f.readline().split())
        for _ in range(n_holes):
            parts = f.readline().split()
            off, length = int(parts[0]), int(parts[1])
            ch = parts[2] if len(parts) > 2 else "N"
            ascii_all[off : off + length] = ord(ch)

    out = {}
    for name, (off, length) in zip(names, seqs):
        out[name] = ascii_all[off : off + length].copy()
    return out


def write_fasta(path: str, contigs: dict[str, np.ndarray], width: int = 60):
    with open(path, "w") as f:
        for name, arr in contigs.items():
            f.write(f">{name}\n")
            s = arr.tobytes().decode()
            for i in range(0, len(s), width):
                f.write(s[i : i + width] + "\n")
