"""Carry tables and key sets between the reference's host layout and the
port's device layout.

The reference (and every file format) keeps k-mer keys as uint64 with the
all-ones sentinel; the port keeps them on the device as int64 with the
INT64_MAX sentinel. For k <= 31 a valid key is below 2**62 in both, so the
translation only re-types the array and swaps the sentinel. With these,
tests can hand each stage the JAX package's own inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import codec
from .ops.table import DeviceKmerTable


def table_from_numpy(keys_u64: np.ndarray, counts_i64: np.ndarray, device,
                     *, k: int) -> DeviceKmerTable:
    """A sorted unique host table (a KmerTable's arrays) -> device table."""
    t = DeviceKmerTable(k, device)
    t.keys = torch.from_numpy(codec.keys_u64_to_i64(keys_u64)).to(t.device)
    t.counts = torch.from_numpy(
        np.asarray(counts_i64, dtype=np.int64).copy()).to(t.device)
    return t


def table_to_numpy(table: DeviceKmerTable):
    """Device table -> (keys uint64, counts int64) host arrays."""
    host = table.to_host()
    return host.keys, host.counts


def hashlist_keys_to_int64(keys_u64: np.ndarray, device) -> torch.Tensor:
    """Sorted canonical HashList keys (uint64) -> int64 tensor on device."""
    return torch.from_numpy(codec.keys_u64_to_i64(keys_u64)).to(device)


def hashlist_keys_from_int64(keys: torch.Tensor) -> np.ndarray:
    """int64 key tensor -> uint64 host array."""
    return codec.keys_i64_to_u64(keys.cpu().numpy())
