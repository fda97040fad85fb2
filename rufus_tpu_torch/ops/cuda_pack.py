"""Kernel 6, unpack: packed transport planes -> the ASCII read batch.

Replaces the jit program ``rufus_tpu/ops/pack.py:66-91``
(``unpack_reads_device``, ``unpack_qual_device``), which is not a Pallas
kernel: the 2-bit base codes plus the N mask, and the 1-bit "qual passes
min_q" plane, that ``ops/pack.py`` packs on the host, unpacked on the
device into (B, L) uint8 reads ('N' at invalid bases) and quals ('I'
where the threshold passed, '#' where it failed).

On the H100 the work is bound by bytes: 3L/8 bytes in and L out a read (5L/8
in and 2L out with quals). The CUDA kernel (``csrc/unpack.cu``) gives each
thread 16 bytes of the contiguous output span, whatever L is, and writes
them with one 16-byte store; one launch writes both planes.
"""

from __future__ import annotations

import torch

from . import _build

N_BASE = ord("N")
PASS_Q = ord("I")  # reconstructed passing qual (phred 40)
FAIL_Q = ord("#")  # reconstructed failing qual (phred 2)
_DEC = (ord("A"), ord("C"), ord("G"), ord("T"))


def _bits(planes: torch.Tensor, per_byte: int, L: int) -> torch.Tensor:
    """(B, P) uint8 -> (B, L) uint8 fields of 8/per_byte bits, the first
    field in the low bits of each byte."""
    width = 8 // per_byte
    shifts = torch.arange(per_byte, dtype=torch.uint8,
                          device=planes.device) * width
    fields = (planes[:, :, None] >> shifts) & ((1 << width) - 1)
    return fields.reshape(planes.shape[0], -1)[:, :L]


def unpack_reads_torch(packed: torch.Tensor, nmask: torch.Tensor,
                       L: int) -> torch.Tensor:
    """Plain PyTorch version of the read plane: (B, ceil(L/4)) codes and
    (B, ceil(L/8)) N mask -> (B, L) uint8 ASCII."""
    codes = _bits(packed, 4, L).to(torch.int64)  # an index, not a mask
    bad = _bits(nmask, 8, L) == 1
    dec = torch.tensor(_DEC, dtype=torch.uint8, device=packed.device)
    return torch.where(bad, torch.full_like(bad, N_BASE, dtype=torch.uint8),
                       dec[codes])


def unpack_qual_torch(okmask: torch.Tensor, L: int) -> torch.Tensor:
    """Plain PyTorch version of the qual plane: (B, ceil(L/8)) ok bits ->
    (B, L) uint8, 'I' where set, '#' where not."""
    ok = _bits(okmask, 8, L) == 1
    return torch.where(ok, torch.full_like(ok, PASS_Q, dtype=torch.uint8),
                       torch.full_like(ok, FAIL_Q, dtype=torch.uint8))


@_build.on_card
def _unpack_cuda(ref: torch.Tensor, packed, nmask, okmask, L: int):
    B = ref.shape[0]
    reads = quals = None
    if packed is not None:
        reads = torch.empty((B, L), dtype=torch.uint8, device=ref.device)
    if okmask is not None:
        quals = torch.empty((B, L), dtype=torch.uint8, device=ref.device)
    opt = lambda t: _build.ptr(t) if t is not None else None  # noqa: E731
    P, I64, I32 = _build.P, _build.I64, _build.I32
    fn = _build.function("unpack", "rt_unpack",
                         [P, P, P, I64, I32, P, P, P])
    _build.check(fn(opt(packed), opt(nmask), opt(okmask), B, L, opt(reads),
                    opt(quals), _build.stream_ptr(ref.device)), "unpack")
    unpack.launches += 1
    return reads, quals


def _check_plane(t: torch.Tensor, name: str, B, width: int, device):
    if not isinstance(t, torch.Tensor) or t.dim() != 2 \
            or t.dtype != torch.uint8:
        raise TypeError(f"{name} must be a 2-D uint8 tensor")
    if B is not None and t.shape[0] != B:
        raise ValueError(f"{name} has {t.shape[0]} rows, the others {B}")
    if t.shape[1] != width:
        raise ValueError(f"{name} has {t.shape[1]} bytes a row, L needs "
                         f"{width}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, the others on {device}")


def unpack(packed: torch.Tensor | None, nmask: torch.Tensor | None,
           okmask: torch.Tensor | None, L: int):
    """Packed planes -> (reads, quals), each (B, L) uint8 or None where its
    planes are None: `packed` (B, ceil(L/4)) with `nmask` (B, ceil(L/8))
    give the reads, `okmask` (B, ceil(L/8)) the quals. One launch writes
    both.

    CUDA tensors go through the CUDA kernel; CPU tensors through
    ``unpack_reads_torch`` and ``unpack_qual_torch``."""
    if L < 1:
        raise ValueError(f"L must be at least 1, got {L}")
    if (packed is None) != (nmask is None):
        raise ValueError("packed and nmask come together")
    planes = [(packed, "packed", -(-L // 4)), (nmask, "nmask", -(-L // 8)),
              (okmask, "okmask", -(-L // 8))]
    planes = [p for p in planes if p[0] is not None]
    if not planes:
        raise ValueError("nothing to unpack")
    B = device = None
    for t, name, width in planes:
        _check_plane(t, name, B, width, device)
        B, device = t.shape[0], t.device
    if device.type == "cpu":
        return (unpack_reads_torch(packed, nmask, L)
                if packed is not None else None,
                unpack_qual_torch(okmask, L) if okmask is not None else None)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not all(t.is_contiguous() for t, _, _ in planes):
        raise ValueError("the packed planes must be contiguous")
    return _unpack_cuda(planes[0][0], packed, nmask, okmask, L)


unpack.launches = 0
