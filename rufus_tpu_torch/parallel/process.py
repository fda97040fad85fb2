"""The process mesh: the shards of ``sharded.py`` over the processes of a
``torch.distributed`` group, one process a card.

The counterpart of the JAX package's multi-process mesh
(``jax.distributed.initialize`` in ``tools/multiproc_smoke.py`` and
``process_allgather`` in ``rufus_tpu/parallel/sharded.py``'s
``make_splitters``). The caller starts the group
(``torch.distributed.init_process_group``: NCCL on cards, gloo on the
CPU), then asks each rank for its mesh. Rank r of world w holds shards
[r*local, (r+1)*local) of w*local, all on its own device: the card
``LOCAL_RANK`` names (default: the rank), or the CPU. NCCL refuses two
ranks on one card, so several ranks need several cards; one card runs one
rank holding several shards.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .sharded import ShardMesh

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_process_mesh(local_shards: int = 1, device="cuda") -> ShardMesh:
    """This rank's mesh of `local_shards` shards on `device` ("cuda": the
    card of LOCAL_RANK, made current; "cuda:i"; or "cpu"), after
    ``init_process_group``. Raises RuntimeError with no group, or "cuda"
    with no CUDA device, and ValueError for a device the group's backend
    does not serve (NCCL serves cards, gloo the CPU) or a card that is not
    visible: nothing falls back to the CPU."""
    if local_shards < 1:
        raise ValueError(f"a rank needs at least one shard, not "
                         f"{local_shards}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_process_mesh runs after "
                           "torch.distributed.init_process_group")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    if dev.type not in _BACKEND:
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but no CUDA "
                               "device is available")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                          rank)))
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} wants {dev} but "
                             f"{torch.cuda.device_count()} CUDA devices are "
                             "visible")
        torch.cuda.set_device(dev)
    backend = dist.get_backend()
    if backend != _BACKEND[dev.type]:
        raise ValueError(f"a {dev.type} mesh needs the "
                         f"{_BACKEND[dev.type]} backend, not {backend}")
    return ShardMesh((dev,) * local_shards, rank=rank, world=world,
                     group=dist.group.WORLD)
