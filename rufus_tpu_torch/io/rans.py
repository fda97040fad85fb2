"""rANS 4x8 codec (CRAM 3.0 section 13 / htslib rANS_static) — the
default block compression htslib writes in CRAM 3.0 files.

Stream layout: 1 byte order (0|1), u32le compressed size, u32le raw
size, then the frequency table(s) and the interleaved 4-state rANS
payload. Frequencies are normalized to total 4096 (12-bit); states
renormalize bytewise against RANS_BYTE_L = 1<<23.

Order-0: one table; the 4 states round-robin output positions.
Order-1: a context table per preceding symbol; each state decodes one
contiguous quarter of the output (the last state also handles the
remainder), seeded from context 0.

The decoder makes htslib-written CRAM readable; the encoder exists for
round-trip tests (this environment has no CRAM tooling — PARITY.md).
Pure Python: correctness-grade for input modality support, not a hot
path (the pipeline's own writer uses gzip blocks).
"""

from __future__ import annotations

import struct

RANS_BYTE_L = 1 << 23
TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT


# ---------------------------------------------------------------------------
# frequency tables
# ---------------------------------------------------------------------------


def _write_freq_val(out: bytearray, f: int):
    if f >= 128:
        out.append(0x80 | (f >> 8))
        out.append(f & 0xFF)
    else:
        out.append(f)


def _write_freqs(out: bytearray, freqs: dict[int, int]):
    """htslib rans_compress_O0 table layout: symbols ascending; on the
    SECOND of a run of consecutive symbol values, an RLE byte (how many
    MORE follow implicitly) is written immediately after that symbol
    byte and BEFORE its frequency; freq < 128 in one byte, else two
    bytes big-endian with the top bit set; 0 next-symbol terminator."""
    syms = sorted(freqs)
    rle = 0
    for idx, s in enumerate(syms):
        if rle:
            rle -= 1
        else:
            out.append(s)
            if idx and syms[idx - 1] == s - 1:
                while (idx + rle + 1 < len(syms)
                       and syms[idx + rle + 1] == syms[idx + rle] + 1):
                    rle += 1
                out.append(rle)
        _write_freq_val(out, freqs[s])
    out.append(0)  # terminator


def _read_freq_val(data: bytes, pos: int):
    f = data[pos]
    pos += 1
    if f & 0x80:
        f = ((f & 0x7F) << 8) | data[pos]
        pos += 1
    return f, pos


def _read_freqs(data: bytes, pos: int):
    """-> (freqs dict, new pos). Mirror of htslib rans_uncompress_O0's
    table parse: read symbol, freq; if the NEXT byte is symbol+1 (run
    start) consume that symbol byte plus an RLE byte giving how many
    more consecutive symbols follow implicitly, whose freqs then stream
    back-to-back. A zero next-symbol byte is the terminator
    (unambiguous: symbols ascend, so 0 can only open the table)."""
    freqs: dict[int, int] = {}
    rle = 0
    sym = data[pos]
    pos += 1
    while True:
        f, pos = _read_freq_val(data, pos)
        freqs[sym] = f
        if rle:
            rle -= 1
            sym += 1
        elif data[pos] == sym + 1:
            sym = data[pos]
            pos += 1
            rle = data[pos]
            pos += 1
        else:
            sym = data[pos]
            pos += 1
            if sym == 0:
                break
    return freqs, pos


def _normalize(counts: dict[int, int]) -> dict[int, int]:
    total = sum(counts.values())
    if total == 0:
        return {}
    freqs = {}
    acc = 0
    items = sorted(counts.items())
    for i, (s, c) in enumerate(items):
        f = max(1, (c * TOTFREQ) // total)
        freqs[s] = f
        acc += f
    # fix the total to exactly TOTFREQ on the most frequent symbol
    top = max(freqs, key=lambda s: freqs[s])
    freqs[top] += TOTFREQ - acc
    if freqs[top] <= 0:
        raise ValueError("degenerate frequency normalization")
    return freqs


def _cum(freqs: dict[int, int]):
    cum = {}
    acc = 0
    for s in sorted(freqs):
        cum[s] = acc
        acc += freqs[s]
    return cum


def _lookup(freqs: dict[int, int]):
    """12-bit slot -> (symbol, freq, cum) arrays."""
    sym = bytearray(TOTFREQ)
    cum = _cum(freqs)
    for s in sorted(freqs):
        start = cum[s]
        for i in range(start, start + freqs[s]):
            sym[i] = s
    return sym, freqs, cum


# ---------------------------------------------------------------------------
# order-0
# ---------------------------------------------------------------------------


def _enc_renorm(x: int, freq: int, out: bytearray) -> int:
    x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * freq
    while x >= x_max:
        out.append(x & 0xFF)
        x >>= 8
    return x


def _enc_put(x: int, freq: int, cumf: int) -> int:
    return ((x // freq) << TF_SHIFT) + (x % freq) + cumf


def compress_o0(data: bytes) -> bytes:
    counts: dict[int, int] = {}
    for b in data:
        counts[b] = counts.get(b, 0) + 1
    freqs = _normalize(counts)
    cum = _cum(freqs)
    table = bytearray()
    _write_freqs(table, freqs)
    states = [RANS_BYTE_L] * 4
    body = bytearray()
    # encode in reverse; state j owns positions i with i % 4 == j
    for i in range(len(data) - 1, -1, -1):
        j = i & 3
        s = data[i]
        states[j] = _enc_renorm(states[j], freqs[s], body)
        states[j] = _enc_put(states[j], freqs[s], cum[s])
    # states flush to the FRONT (the decoder reads them before any
    # renormalization byte); renorm bytes reverse to decode order
    head = b"".join(struct.pack("<I", states[j]) for j in range(4))
    payload = bytes(table) + head + bytes(reversed(body))
    return (bytes([0]) + struct.pack("<I", len(payload))
            + struct.pack("<I", len(data)) + payload)


def _dec_init(data: bytes, pos: int):
    states = []
    for _ in range(4):
        (x,) = struct.unpack_from("<I", data, pos)
        states.append(x)
        pos += 4
    return states, pos


def uncompress(data: bytes) -> bytes:
    """Decode an rANS 4x8 stream (order 0 or 1)."""
    order = data[0]
    (raw_size,) = struct.unpack_from("<I", data, 5)
    pos = 9
    if order == 0:
        freqs, pos = _read_freqs(data, pos)
        sym, fr, cum = _lookup(freqs)
        states, pos = _dec_init(data, pos)
        out = bytearray(raw_size)
        for i in range(raw_size):
            j = i & 3
            x = states[j]
            slot = x & (TOTFREQ - 1)
            s = sym[slot]
            out[i] = s
            x = fr[s] * (x >> TF_SHIFT) + slot - cum[s]
            while x < RANS_BYTE_L and pos < len(data):
                x = (x << 8) | data[pos]
                pos += 1
            states[j] = x
        return bytes(out)
    if order != 1:
        raise NotImplementedError(f"rANS order {order}")
    # order-1: context tables, one per preceding symbol; the context ids
    # use the same RLE scheme as symbols inside a table — the run-length
    # byte follows the second consecutive context byte, BEFORE its inner
    # table (htslib rans_uncompress_O1)
    tables = {}
    rle = 0
    ctx = data[pos]
    pos += 1
    while True:
        freqs, pos = _read_freqs(data, pos)
        tables[ctx] = _lookup(freqs)
        if rle:
            rle -= 1
            ctx += 1
        elif data[pos] == ctx + 1:
            ctx = data[pos]
            pos += 1
            rle = data[pos]
            pos += 1
        else:
            ctx = data[pos]
            pos += 1
            if ctx == 0:
                break
    states, pos = _dec_init(data, pos)
    out = bytearray(raw_size)
    q = raw_size >> 2
    starts = [0, q, 2 * q, 3 * q]
    lasts = [0, 0, 0, 0]
    idx = list(starts)
    ends = [q, 2 * q, 3 * q, raw_size]
    # interleaved: each step advances every state within its quarter
    for step in range(q):
        for j in range(4):
            i = starts[j] + step
            if i >= ends[j]:
                continue
            x = states[j]
            sym, fr, cum = tables[lasts[j]]
            slot = x & (TOTFREQ - 1)
            s = sym[slot]
            out[i] = s
            x = fr[s] * (x >> TF_SHIFT) + slot - cum[s]
            while x < RANS_BYTE_L and pos < len(data):
                x = (x << 8) | data[pos]
                pos += 1
            states[j] = x
            lasts[j] = s
    # remainder (raw_size % 4) decoded by the LAST state
    for i in range(starts[3] + q, raw_size):
        x = states[3]
        sym, fr, cum = tables[lasts[3]]
        slot = x & (TOTFREQ - 1)
        s = sym[slot]
        out[i] = s
        x = fr[s] * (x >> TF_SHIFT) + slot - cum[s]
        while x < RANS_BYTE_L and pos < len(data):
            x = (x << 8) | data[pos]
            pos += 1
        states[3] = x
        lasts[3] = s
    return bytes(out)


def compress_o1(data: bytes) -> bytes:
    """Order-1 encoder (for round-trip tests)."""
    if len(data) < 4:
        return compress_o0(data)
    q = len(data) >> 2
    starts = [0, q, 2 * q, 3 * q]
    ends = [q, 2 * q, 3 * q, len(data)]
    counts: dict[int, dict[int, int]] = {}
    for j in range(4):
        last = 0
        for i in range(starts[j], ends[j]):
            s = data[i]
            counts.setdefault(last, {})
            counts[last][s] = counts[last].get(s, 0) + 1
            last = s
    tables = {c: _normalize(f) for c, f in counts.items()}
    cums = {c: _cum(f) for c, f in tables.items()}

    table_bytes = bytearray()
    ctxs = sorted(tables)
    rle_i = 0
    for idx, c in enumerate(ctxs):
        if rle_i:
            rle_i -= 1
        else:
            table_bytes.append(c)
            if idx and ctxs[idx - 1] == c - 1:
                while (idx + rle_i + 1 < len(ctxs)
                       and ctxs[idx + rle_i + 1] == ctxs[idx + rle_i] + 1):
                    rle_i += 1
                table_bytes.append(rle_i)
        _write_freqs(table_bytes, tables[c])
    table_bytes.append(0)

    states = [RANS_BYTE_L] * 4
    body = bytearray()
    # encode each quarter in reverse with its state
    chains = []
    for j in range(4):
        seq = []
        last = 0
        for i in range(starts[j], ends[j]):
            seq.append((last, data[i]))
            last = data[i]
        chains.append(seq)
    # interleave the renormalized bytes exactly inverse to the decoder:
    # the decoder consumes bytes state-by-state in step order, so encode
    # steps in reverse, states in reverse order within a step
    max_len = max(len(c) for c in chains)
    for step in range(max_len - 1, -1, -1):
        for j in (3, 2, 1, 0):
            if step >= len(chains[j]):
                continue
            ctx, s = chains[j][step]
            f = tables[ctx][s]
            states[j] = _enc_renorm(states[j], f, body)
            states[j] = _enc_put(states[j], f, cums[ctx][s])
    head = b"".join(struct.pack("<I", states[j]) for j in range(4))
    payload = bytes(table_bytes) + head + bytes(reversed(body))
    return (bytes([1]) + struct.pack("<I", len(payload))
            + struct.pack("<I", len(data)) + payload)
