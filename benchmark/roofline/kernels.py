"""The least work each kernel must do, from the shapes of the work alone,
and the peaks it is held to. Bytes count each input read once and each
output written once, whatever a kernel reads again; the DP counts its
integer operations. The same work gives the same bound whatever
implements it."""

from __future__ import annotations

# One NVIDIA H100 SXM (data sheet): HBM3 bandwidth, and INT32 issue as the
# Hopper white paper gives it: 64 lanes an SM x 132 SMs x 1,980 MHz boost.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
SW_OPS_PER_CELL = 15  # the Smith-Waterman recurrence, counted in sw_batch.cu


def encode_canon_bytes(reads: int, read_pad: int, k: int) -> int:
    """Reads a (reads, read_pad) uint8 batch, writes one int64 key a
    window."""
    return reads * read_pad + 8 * reads * (read_pad - k + 1)


def window_hits_bytes(rows: int, read_pad: int, table_keys: int,
                      calls: int) -> int:
    """Each call reads its rows' bases, qualities and int32 lengths and the
    int64 HashList, and writes an int32 count a row."""
    return rows * (2 * read_pad + 4 + 4) + 8 * table_keys * calls


def sw_batch_ops(cells: int) -> int:
    return SW_OPS_PER_CELL * cells


def bytes_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def ops_seconds(ops: float) -> float:
    return ops / INT32_OPS_PER_S
