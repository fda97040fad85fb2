"""ctypes bindings for the native C++ decoders (``native/bamdecode.cpp``,
``native/fastqdecode.cpp``).

`NativeBam` decodes BGZF blocks with a thread pool and parses records in
C++; `NativeFastq` and `NativeFastqPairs` scan plain or gzip FASTQ in
chunks. They keep the card fed where the pure-Python readers
(``io/bam.py``, ``io/fastq.py``) are the plain versions the tests hold
them to. The library is built from the package's sources at first use
(``ops/_build.py:build_native``); a failed build or load raises, and no
caller falls back to the Python readers.

Every batch call writes into arrays the caller may pass (``out``), so the
pipeline decodes straight into pinned host memory.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops import _build

DEFAULT_EXCLUDE = 0xD00  # samtools view -F 3328: secondary|dup|supplementary

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.build_native())
    sig = {
        "bam_open": (_P, [ctypes.c_char_p, _I]),
        "bam_num_records": (_L, [_P]),
        "bam_read_batch": (_L, [_P, _I, _P, _P, _P, _L, _L]),
        "bam_read_pair_batch": (_L, [_P, _I, _P, _P, _P, _P, _P, _P, _P, _L,
                                     _P, _L, _L]),
        "bam_read_se_batch": (_L, [_P, _I, _P, _P, _P, _P, _L, _P, _L, _L]),
        "bam_num_refs": (_L, [_P]),
        "bam_ref_name": (_L, [_P, _L, ctypes.c_char_p, _L]),
        "bam_ref_ids": (None, [_P, _P]),
        "bam_max_seq_len": (_L, [_P, _I]),
        "bam_reset": (None, [_P]),
        "bam_close": (None, [_P]),
        "fastq_open": (_P, [ctypes.c_char_p]),
        "fastq_read_batch": (_L, [_P, _L, _L, _P, _P]),
        "fastq_close": (None, [_P]),
        "fastq_pair_open": (_P, [ctypes.c_char_p, ctypes.c_char_p]),
        "fastq_pair_read_batch": (_L, [_P, _L, _L, _P, _P, _P, _P, _P, _P,
                                       _P, _L, _P]),
        "fastq_pair_close": (None, [_P]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


_LENS = object()  # a layout entry: a (capacity,) int32 array of lengths


def _out(out, capacity: int, pad_len: int, layout):
    """The batch arrays, `out` checked or new ones. Each `layout` entry is
    the pad byte of a (capacity, pad_len) uint8 array (None: the decoder
    pads it itself) or _LENS."""
    if out is None:
        return [np.zeros(capacity, np.int32) if f is _LENS
                else np.empty((capacity, pad_len), np.uint8) if f is None
                else np.full((capacity, pad_len), f, np.uint8)
                for f in layout]
    out = list(out)
    if len(out) != len(layout):
        raise ValueError(f"out must hold {len(layout)} arrays")
    for a, f in zip(out, layout):
        want = ((np.int32, (capacity,)) if f is _LENS
                else (np.uint8, (capacity, pad_len)))
        if a.dtype != want[0] or a.shape != want[1] \
                or not a.flags.c_contiguous:
            raise ValueError(f"out arrays must be C-contiguous {want}")
        if f is not None and f is not _LENS:
            a.fill(f)
    return out


class Names:
    """The names of a batch as one byte buffer and offsets; a name is
    decoded to a str only when it is read (a kept read's)."""

    def __init__(self, buf: np.ndarray, starts: np.ndarray, ends: np.ndarray):
        self.buf, self.starts, self.ends = buf, starts, ends

    def __len__(self):
        return len(self.starts)

    def __getitem__(self, i: int) -> str:
        return self.buf[self.starts[i]:self.ends[i]].tobytes().decode()

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def _names_from_lens(buf: np.ndarray, lens: np.ndarray) -> Names:
    ends = np.cumsum(lens, dtype=np.int64)
    return Names(buf, ends - lens, ends)


class _Handle:
    """A native handle closed by `close`, on `with` exit or on collection."""

    _close_fn = ""

    def __init__(self, h):
        self._lib = _lib()
        self._h = h

    def close(self):
        if getattr(self, "_h", None):
            getattr(self._lib, self._close_fn)(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class NativeBam(_Handle):
    """Batch reader over a BAM file. The whole file is inflated and indexed
    when it is opened (`threads` inflate BGZF blocks in parallel)."""

    _close_fn = "bam_close"

    def __init__(self, path: str, threads: int = 2):
        h = _lib().bam_open(path.encode(), threads)
        if not h:
            raise IOError(f"failed to open {path} as a BAM file")
        super().__init__(h)

    def __len__(self):
        return int(self._lib.bam_num_records(self._h))

    def refs(self) -> list[tuple[str, int]]:
        """The header's references as (name, 0), the shape
        ``progress.progress_records`` takes."""
        out = []
        buf = ctypes.create_string_buffer(1 << 16)
        for i in range(int(self._lib.bam_num_refs(self._h))):
            n = self._lib.bam_ref_name(self._h, i, buf, len(buf))
            if n < 0:
                raise IOError("BAM reference name longer than 64 KiB")
            out.append((buf.raw[:n].decode(), 0))
        return out

    def ref_ids(self) -> np.ndarray:
        """Every record's ref_id, in file order."""
        out = np.empty(len(self), np.int32)
        self._lib.bam_ref_ids(self._h, _ptr(out))
        return out

    def max_read_len(self, exclude_flags: int = DEFAULT_EXCLUDE) -> int:
        return int(self._lib.bam_max_seq_len(self._h, exclude_flags))

    def read_batch(self, capacity: int, pad_len: int,
                   exclude_flags: int = DEFAULT_EXCLUDE, out=None):
        """Records as stored, cut at pad_len -> (seq (n, pad) uint8 'N'
        padded, qual (n, pad) uint8 '!' padded, lens (n,) int32)."""
        seq, qual, lens = _out(out, capacity, pad_len,
                               (ord("N"), ord("!"), _LENS))
        n = self._lib.bam_read_batch(self._h, exclude_flags, _ptr(seq),
                                     _ptr(qual), _ptr(lens), capacity, pad_len)
        return seq[:n], qual[:n], lens[:n]

    def read_se_batch(self, capacity: int, pad_len: int,
                      exclude_flags: int = DEFAULT_EXCLUDE, out=None):
        """Single-end stranded batch (``bam.bam_to_single_fastq``'s
        semantics; shares read_batch's cursor) -> (Names, seq, qual,
        lens)."""
        seq, qual, lens = _out(out, capacity, pad_len,
                               (ord("N"), ord("!"), _LENS))
        name_cap = capacity * 256  # a BAM name is at most 254 bytes
        names = np.empty(name_cap, np.uint8)
        name_lens = np.zeros(capacity, np.int32)
        n = self._lib.bam_read_se_batch(
            self._h, exclude_flags, _ptr(seq), _ptr(qual), _ptr(lens),
            _ptr(names), name_cap, _ptr(name_lens), capacity, pad_len)
        return (_names_from_lens(names, name_lens[:n]), seq[:n], qual[:n],
                lens[:n])

    def read_pair_batch(self, capacity: int, pad_len: int,
                        exclude_flags: int = DEFAULT_EXCLUDE, out=None):
        """Paired stranded batch (``bam.bam_to_paired_fastq``'s semantics:
        pairs by name, the second record seen is mate1, flag-0x10 records
        reverse-complemented) -> (Names, s1, q1, l1, s2, q2, l2)."""
        s1, q1, l1, s2, q2, l2 = _out(
            out, capacity, pad_len,
            (ord("N"), ord("!"), _LENS, ord("N"), ord("!"), _LENS))
        name_cap = capacity * 256
        names = np.empty(name_cap, np.uint8)
        name_lens = np.zeros(capacity, np.int32)
        n = self._lib.bam_read_pair_batch(
            self._h, exclude_flags, _ptr(s1), _ptr(q1), _ptr(l1), _ptr(s2),
            _ptr(q2), _ptr(l2), _ptr(names), name_cap, _ptr(name_lens),
            capacity, pad_len)
        return (_names_from_lens(names, name_lens[:n]), s1[:n], q1[:n],
                l1[:n], s2[:n], q2[:n], l2[:n])

    def reset(self):
        self._lib.bam_reset(self._h)


class NativeFastq(_Handle):
    """Batch reader over a plain or gzip FASTQ."""

    _close_fn = "fastq_close"

    def __init__(self, path: str):
        h = _lib().fastq_open(path.encode())
        if not h:
            raise IOError(f"failed to open {path}")
        super().__init__(h)

    def read_batch(self, capacity: int, pad_len: int, out=None):
        """-> (seq (n, pad) uint8 'N' padded, lens (n,) int32), reads cut
        at pad_len."""
        seq, lens = _out(out, capacity, pad_len, (None, _LENS))
        n = self._lib.fastq_read_batch(self._h, capacity, pad_len, _ptr(seq),
                                       _ptr(lens))
        if n < 0:
            raise IOError("malformed FASTQ record")
        return seq[:n], lens[:n]


class NativeFastqPairs(_Handle):
    """Lockstep paired-FASTQ batch reader (R1 + R2), the filter stage's
    route for -q1/-q2 inputs (runRufus.sh:971-983 role)."""

    _close_fn = "fastq_pair_close"

    def __init__(self, path1: str, path2: str):
        h = _lib().fastq_pair_open(path1.encode(), path2.encode())
        if not h:
            raise IOError(f"failed to open {path1}/{path2}")
        super().__init__(h)
        self._name_cap = 1 << 20

    def read_pair_batch(self, capacity: int, pad_len: int, out=None):
        """-> (Names, s1, q1, l1, s2, q2, l2); names are R1's, cut at the
        first space; rows are 'N' padded (quals too), reads cut at pad_len.
        A batch whose names overflow the name buffer comes back short; the
        record that did not fit is kept for the next call."""
        s1, q1, l1, s2, q2, l2 = _out(out, capacity, pad_len,
                                      (None, None, _LENS) * 2)
        # room for 64-byte names: a full batch of Illumina-style names
        self._name_cap = max(self._name_cap, 64 * capacity)
        while True:
            names = np.empty(self._name_cap, np.uint8)
            name_off = np.zeros(capacity + 1, np.int32)
            n = self._lib.fastq_pair_read_batch(
                self._h, capacity, pad_len, _ptr(s1), _ptr(q1), _ptr(l1),
                _ptr(s2), _ptr(q2), _ptr(l2), _ptr(names), self._name_cap,
                _ptr(name_off))
            if n == -2:  # not even the first name fits
                self._name_cap *= 2
                continue
            if n < 0:
                raise IOError("malformed FASTQ pair stream")
            break
        # names are '\0'-terminated: name i is [off[i], off[i + 1] - 1)
        return (Names(names, name_off[:n], name_off[1:n + 1] - 1), s1[:n],
                q1[:n], l1[:n], s2[:n], q2[:n], l2[:n])
