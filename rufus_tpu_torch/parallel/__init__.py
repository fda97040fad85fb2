"""The sharded chain over a mesh of shards (``sharded.py``), on one process
or over the processes of a torch.distributed group (``process.py``)."""

from ..ops.table import make_splitters
from .process import make_process_mesh
from .sharded import (ShardMesh, ShardedKmerTable, all_gather, all_max,
                      all_to_all, exact_route_cap, exchange, hash_segments,
                      host_owners,
                      local_count_step, local_rows, make_mesh,
                      mesh_splitters, owner_hash, owners_by_splitters,
                      query_counts, replicate, replicate_hashlist,
                      route_capacity, segment_bounds, sharded_count_step,
                      sharded_filter_step, sharded_query_multi,
                      sharded_query_step, sharded_subtract_step)

__all__ = ["ShardMesh", "ShardedKmerTable", "all_gather", "all_max",
           "all_to_all", "exact_route_cap", "exchange", "hash_segments",
           "host_owners",
           "local_count_step", "local_rows", "make_mesh",
           "make_process_mesh", "make_splitters", "mesh_splitters",
           "owner_hash", "owners_by_splitters", "query_counts", "replicate",
           "replicate_hashlist", "route_capacity", "segment_bounds",
           "sharded_count_step", "sharded_filter_step",
           "sharded_query_multi", "sharded_query_step",
           "sharded_subtract_step"]
